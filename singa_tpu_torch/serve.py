"""Continuous micro-batching over one model's eval forward. Counterpart of
the forward-serving core of `singa_tpu.serve.ServingEngine`.

  admission  -- `submit()` puts a request (numpy arrays batched along dim
      0) into a bounded queue and returns a `ServeReply` future; a full
      queue refuses the request loudly (`ServeQueueFullError`).
  coalescing -- one dispatcher thread drains what is waiting, up to
      `max_batch` rows or `max_wait_ms` from the first queued request.
      Requests with different per-sample signatures dispatch separately.
  buckets    -- the batch is padded to the next power of two by repeating
      the final sample (`export_cache.pad_batch_to_bucket`); a request
      above the top bucket fails at submit (`BucketOverflowError`).
  dispatch   -- the padded batch runs the model's forward on its device
      under `torch.inference_mode()` (set inside the dispatcher thread:
      inference mode is thread-local).
  scatter    -- the output comes to the host, pad rows are cut off, and each
      request gets its own rows as numpy arrays.

Later slices add what the JAX engine has beyond this: deadlines, retries,
poison bisection, load shedding, supervision, health and chaos injection,
tracer spans and metrics, SLO hooks, tuned-config loading and the decode
tier. Until then a dispatch that raises fails the futures of its group with
that error.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import export_cache

__all__ = ["ServingEngine", "ServeReply", "ServeQueueFullError",
           "ServeClosedError", "configure", "get_config"]


class ServeQueueFullError(RuntimeError):
    """The admission queue is at `max_queue`: the request is dropped
    (counted `dropped`), loudly, at submit time."""


class ServeClosedError(RuntimeError):
    """The engine is stopped (or stopping): no new requests are admitted,
    and requests still queued at `stop(drain=False)` fail with this."""


# Process defaults; `ServingEngine(...)` arguments override them.
_CONFIG: Dict = {
    # Max rows per fused dispatch (the coalescing ceiling).
    "max_batch": 64,
    # How long the dispatcher waits, from the first queued request, for
    # more requests before dispatching a partial batch.
    "max_wait_ms": 2.0,
    # Admission-queue bound (requests, not rows). Full => loud drop.
    "max_queue": 4096,
}


def configure(**kw) -> Dict:
    """Update serving defaults (`max_batch`, `max_wait_ms`, `max_queue`)."""
    for k, v in kw.items():
        if k not in _CONFIG:
            raise KeyError(f"unknown serving config key {k!r}; known: "
                           f"{sorted(_CONFIG)}")
        if k == "max_wait_ms":
            v = float(v)
            if v < 0:
                raise ValueError("max_wait_ms must be >= 0")
        else:
            v = int(v)
            if v < 1:
                raise ValueError(f"{k} must be >= 1")
        _CONFIG[k] = v
    return dict(_CONFIG)


def get_config() -> Dict:
    return dict(_CONFIG)


class _ServeStats:
    """One engine's counters. Every submitted request ends in exactly one
    of `replies`, `dropped`, `overflowed` or `failed`, so at quiescence
    requests == replies + dropped + overflowed + failed."""

    def __init__(self):
        self.requests = 0
        self.replies = 0
        self.dropped = 0
        self.overflowed = 0
        self.failed = 0
        self.dispatches = 0
        self.coalesced_requests = 0
        self.coalesced_rows = 0
        self.pad_rows = 0
        self.max_coalesce = 0
        self.queue_depth = 0
        self.max_queue_depth = 0
        self.buckets: Dict[int, int] = {}

    def note_dispatch(self, n_requests: int, n_rows: int,
                      n_bucket: int) -> None:
        self.dispatches += 1
        self.coalesced_requests += n_requests
        self.coalesced_rows += n_rows
        self.pad_rows += n_bucket - n_rows
        self.max_coalesce = max(self.max_coalesce, n_requests)
        self.buckets[n_bucket] = self.buckets.get(n_bucket, 0) + 1

    def snapshot(self) -> Dict:
        d = max(self.dispatches, 1)
        return {
            "requests": self.requests,
            "replies": self.replies,
            "dropped": self.dropped,
            "overflowed": self.overflowed,
            "failed": self.failed,
            "dispatches": self.dispatches,
            "coalesce_mean": round(self.coalesced_requests / d, 3),
            "max_coalesce": self.max_coalesce,
            "rows": self.coalesced_rows,
            "pad_rows": self.pad_rows,
            "occupancy": round(
                self.coalesced_rows
                / max(self.coalesced_rows + self.pad_rows, 1), 4),
            "queue_depth": self.queue_depth,
            "max_queue_depth": self.max_queue_depth,
            "buckets": {str(k): v for k, v in sorted(self.buckets.items())},
        }


class ServeReply:
    """Future for one request. `result(timeout)` blocks for the reply (host
    numpy array with the request's real row count) and re-raises the
    request's error if it failed. `state`: queued -> dispatching ->
    done / failed."""

    __slots__ = ("_ev", "_wlock", "_value", "_error", "n", "t_submit",
                 "t_reply", "state")

    def __init__(self, n: int):
        self._ev = threading.Event()
        self._wlock = threading.Lock()
        self._value = None
        self._error: Optional[BaseException] = None
        self.n = n
        self.state = "queued"
        self.t_submit = time.perf_counter()
        self.t_reply: Optional[float] = None

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._ev.wait(timeout):
            raise TimeoutError(f"serve reply not ready (state: {self.state})")
        if self._error is not None:
            raise self._error
        return self._value

    @property
    def latency_s(self) -> Optional[float]:
        return None if self.t_reply is None else self.t_reply - self.t_submit

    def _deliver(self, value) -> bool:
        """First write wins; returns whether this write won."""
        with self._wlock:
            if self._ev.is_set():
                return False
            self.t_reply = time.perf_counter()
            self._value = value
            self.state = "done"
            self._ev.set()
        return True

    def _fail(self, err: BaseException) -> bool:
        with self._wlock:
            if self._ev.is_set():
                return False
            self.t_reply = time.perf_counter()
            self._error = err
            self.state = "failed"
            self._ev.set()
        return True


class _Request:
    __slots__ = ("arrays", "n", "sig", "reply", "t_enqueue")

    def __init__(self, arrays: List[np.ndarray], n: int, sig, reply):
        self.arrays = arrays
        self.n = n
        self.sig = sig
        self.reply = reply
        self.t_enqueue = time.perf_counter()


def _pow2_ceil(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return b


class ServingEngine:
    """Continuous micro-batching over `model`'s eval forward.

    All dispatching happens on one daemon thread; `submit()` is safe from
    any number of caller threads. The engine puts the model in eval mode at
    `start()` and runs it on the device its parameters live on."""

    def __init__(self, model: torch.nn.Module,
                 max_batch: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 max_queue: Optional[int] = None,
                 bucket_policy: Optional[export_cache.BucketPolicy] = None,
                 latency_window: int = 2048):
        cfg = get_config()
        self.model = model
        self.max_batch = int(max_batch if max_batch is not None
                             else cfg["max_batch"])
        self.max_wait_s = float(max_wait_ms if max_wait_ms is not None
                                else cfg["max_wait_ms"]) / 1e3
        self.max_queue = int(max_queue if max_queue is not None
                             else cfg["max_queue"])
        if self.max_batch < 1 or self.max_queue < 1:
            raise ValueError("max_batch and max_queue must be >= 1")
        # An explicit policy wins, else a pow2 ladder capped at max_batch:
        # the engine always dispatches bucketed shapes.
        self.policy = bucket_policy or export_cache.BucketPolicy(
            max_batch=_pow2_ceil(self.max_batch))
        if self.max_batch > self.policy.max_batch:
            raise ValueError(
                f"max_batch {self.max_batch} exceeds the bucket ceiling "
                f"{self.policy.max_batch}; a dispatch the policy cannot "
                "bucket would be a guaranteed overflow")
        self.stats = _ServeStats()
        self._latencies: deque = deque(maxlen=int(latency_window))
        self._queue: deque = deque()
        self._lock = threading.Lock()
        self._have_work = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._running = False

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "ServingEngine":
        if self._running:
            return self
        self.model.eval()
        self._running = True
        self._thread = threading.Thread(target=self._run,
                                        name="singa_tpu_torch-serve",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True,
             timeout_s: Optional[float] = None) -> None:
        """Stop the dispatcher. `drain=True` serves what is already queued
        first; `drain=False` fails queued requests with `ServeClosedError`.
        `timeout_s` bounds the wait for the dispatcher thread."""
        if not self._running:
            return
        if not drain:
            self._fail_queued(ServeClosedError("engine stopped"))
        with self._lock:  # atomic against submit()'s admission check
            self._running = False
        self._have_work.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout_s)
        # a request that slipped in while the dispatcher was exiting
        self._fail_queued(ServeClosedError("engine stopped"))

    def _fail_queued(self, err: BaseException) -> None:
        with self._lock:
            victims = list(self._queue)
            self._queue.clear()
            self.stats.queue_depth = 0
        for req in victims:
            self._fail_request(req, err)

    def __enter__(self) -> "ServingEngine":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    def _device(self) -> torch.device:
        return next(self.model.parameters()).device

    def warmup(self, *arrays) -> int:
        """Run the forward once per dispatchable bucket, padding `arrays`
        (one example request) up the pow2 ladder, so the first live
        requests do not pay for library initialisation and algorithm
        selection. Dispatches directly, bypassing the queue. Returns the
        number of buckets warmed."""
        batch = [a[:1] for a in self._as_batch(arrays)]
        was_training = self.model.training
        self.model.eval()
        dev = self._device()
        warmed, b = 0, 1
        try:
            with torch.inference_mode():
                while b <= self.policy.bucket_batch(self.max_batch):
                    padded = export_cache.pad_batch(batch, b)
                    self.model(*[torch.from_numpy(np.ascontiguousarray(a))
                                 .to(dev) for a in padded])
                    warmed += 1
                    b <<= 1
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
        finally:
            self.model.train(was_training)
        return warmed

    # -- admission --------------------------------------------------------
    @staticmethod
    def _as_batch(arrays: Sequence) -> List[np.ndarray]:
        out = []
        for a in arrays:
            a = np.asarray(a)
            if a.ndim == 0:
                raise ValueError(
                    "serve requests are batched along dim 0; got a 0-d "
                    "input -- wrap single samples as shape (1, ...)")
            out.append(a)
        return out

    def submit(self, *arrays) -> ServeReply:
        """Enqueue one request (numpy arrays sharing their dim 0) and
        return its `ServeReply`. Raises `ServeClosedError`,
        `BucketOverflowError` or `ServeQueueFullError` at admission."""
        if not self._running:
            raise ServeClosedError("engine not running: call start()")
        batch = self._as_batch(arrays)
        if not batch:
            raise ValueError("serve request needs at least one input")
        n = int(batch[0].shape[0])
        if any(int(a.shape[0]) != n for a in batch):
            raise ValueError(
                "serve request inputs disagree on the batch dim: "
                f"{[int(x.shape[0]) for x in batch]}")
        with self._lock:
            self.stats.requests += 1
        if n > self.policy.max_batch or n > self.max_batch:
            with self._lock:
                self.stats.overflowed += 1
            raise export_cache.BucketOverflowError(
                f"request batch {n} exceeds the serving ceiling (max_batch "
                f"{self.max_batch}, top bucket {self.policy.max_batch}); "
                "split the request or raise the ceiling")
        if self.policy.seq_dim is not None:
            d = self.policy.seq_dim
            for a in batch:
                if a.ndim > d and int(a.shape[d]) > self.policy.max_seq:
                    with self._lock:
                        self.stats.overflowed += 1
                    raise export_cache.BucketOverflowError(
                        f"request seq length {int(a.shape[d])} (dim {d}) "
                        f"exceeds the bucket ladder's max_seq "
                        f"{self.policy.max_seq}")
        sig = tuple((tuple(int(d) for d in a.shape[1:]), str(a.dtype))
                    for a in batch)
        req = _Request(batch, n, sig, ServeReply(n))
        with self._lock:
            # re-checked under the lock stop() takes: past this point the
            # dispatcher drains the queue once more before exiting
            if not self._running:
                self.stats.failed += 1
                raise ServeClosedError("engine stopped")
            if len(self._queue) >= self.max_queue:
                self.stats.dropped += 1
                raise ServeQueueFullError(
                    f"admission queue full ({self.max_queue} requests); "
                    "the request was dropped")
            self._queue.append(req)
            self.stats.queue_depth = len(self._queue)
            self.stats.max_queue_depth = max(self.stats.max_queue_depth,
                                             self.stats.queue_depth)
        self._have_work.set()
        return req.reply

    def infer(self, *arrays, timeout: Optional[float] = None):
        """Synchronous submit + wait: one request's reply."""
        return self.submit(*arrays).result(timeout)

    # -- dispatcher -------------------------------------------------------
    def _fail_request(self, req: _Request, err: BaseException) -> None:
        if req.reply._fail(err):
            with self._lock:
                self.stats.failed += 1

    def _pop(self) -> Optional[_Request]:
        with self._lock:
            if not self._queue:
                self._have_work.clear()
                return None
            req = self._queue.popleft()
            self.stats.queue_depth = len(self._queue)
            return req

    def _run(self) -> None:
        with torch.inference_mode():
            self._loop()

    def _loop(self) -> None:
        while True:
            req = self._pop()
            if req is None:
                if not self._running:
                    return
                self._have_work.wait(0.05)
                continue
            # Coalesce from the first request's arrival for up to the
            # window, stopping early when the batch is full. A request
            # that does not fit (other signature, or over max_batch) goes
            # back to the FRONT of the queue, in order.
            group = [req]
            req.reply.state = "dispatching"
            rows = req.n
            deadline = req.t_enqueue + self.max_wait_s
            pending: List[_Request] = []
            while rows < self.max_batch:
                nxt = self._pop()
                if nxt is None:
                    now = time.perf_counter()
                    if now >= deadline or not self._running:
                        break
                    self._have_work.wait(min(deadline - now, 0.005))
                    continue
                if nxt.sig != req.sig or rows + nxt.n > self.max_batch:
                    pending.append(nxt)
                    if (rows + nxt.n > self.max_batch
                            or len(pending) >= self.max_batch):
                        break
                    continue
                group.append(nxt)
                nxt.reply.state = "dispatching"
                rows += nxt.n
            if pending:
                with self._lock:
                    self._queue.extendleft(reversed(pending))
                    self.stats.queue_depth = len(self._queue)
                self._have_work.set()
            self._dispatch(group, rows)

    def _dispatch(self, group: List[_Request], rows: int) -> None:
        try:
            self._dispatch_once(group, rows)
        except Exception as e:  # noqa: BLE001 -- the dispatcher must live
            for r in group:
                self._fail_request(r, e)

    def _dispatch_once(self, group: List[_Request], rows: int) -> None:
        """Assemble, execute, scatter one coalesced group."""
        if len(group) == 1:
            batch = list(group[0].arrays)
        else:
            batch = [np.concatenate([g.arrays[i] for g in group])
                     for i in range(len(group[0].arrays))]
        padded, info = export_cache.pad_batch_to_bucket(batch, self.policy)
        dev = self._device()
        tensors = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                   for a in padded]
        out = self.model(*tensors)
        host = export_cache.slice_bucket_out(
            export_cache.tree_map(lambda t: t.cpu().numpy(), out), info)
        delivered = self._scatter(group, host, rows)
        with self._lock:
            self.stats.note_dispatch(len(group), rows, info["n_bucket"])
            self.stats.replies += delivered
            for r in group:
                self._latencies.append(r.reply.latency_s)

    @staticmethod
    def _scatter(group: List[_Request], host, rows: int) -> int:
        """Deliver each request its own rows; returns how many futures
        this dispatch resolved."""
        delivered = 0
        off = 0
        for r in group:
            lo, hi = off, off + r.n
            off = hi

            def cut(a, lo=lo, hi=hi):
                if getattr(a, "ndim", 0) >= 1 and a.shape[0] == rows:
                    return a[lo:hi]
                return a  # non-batch leaf: shared across requests

            if r.reply._deliver(export_cache.tree_map(cut, host)):
                delivered += 1
        return delivered

    # -- SLO percentiles --------------------------------------------------
    def percentiles(self) -> Dict[str, Optional[float]]:
        """Rolling request-latency percentiles (ms) over the last
        `latency_window` replies."""
        with self._lock:
            lat = [l for l in self._latencies if l is not None]
        if not lat:
            return {"p50_ms": None, "p95_ms": None, "p99_ms": None}
        arr = np.asarray(lat) * 1e3
        return {"p50_ms": round(float(np.percentile(arr, 50)), 3),
                "p95_ms": round(float(np.percentile(arr, 95)), 3),
                "p99_ms": round(float(np.percentile(arr, 99)), 3)}
