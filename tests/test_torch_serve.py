"""The port's serving core (`singa_tpu_torch.serve`, `.export_cache`)
against the JAX package's.

Bucket policy and pad/slice helpers must give the JAX results and errors.
The engine must coalesce concurrent requests, keep pad rows out of replies,
refuse loudly what it cannot serve, and reply what the unbatched forward
gives (the port's own, exactly on the CPU; and the JAX ServingEngine's for
the same carried weights, within rtol 1e-4, atol 1e-4)."""
import threading

import numpy as np
import pytest
import torch

from singa_tpu import device as jdevice
from singa_tpu import export_cache as jcache
from singa_tpu import serve as jserve
from singa_tpu import tensor
from singa_tpu.models.transformer import TransformerLM as JaxLM
from singa_tpu_torch import convert, export_cache, serve
from singa_tpu_torch.models.transformer import TransformerLM

V, S = 61, 16
CFG = dict(d_model=16, num_heads=2, num_layers=2, max_len=32)


@pytest.fixture(scope="module")
def lm():
    return TransformerLM(V, device="cpu", seed=0, **CFG).eval()


def _ids(n_rows, seed):
    return np.random.RandomState(seed).randint(
        0, V, (n_rows, S)).astype(np.int32)


def _forward(model, ids):
    with torch.inference_mode():
        return model(torch.from_numpy(ids)).numpy()


# ---------------------------------------------------------------------------
# Bucket policy and helpers: same answers and errors as the JAX module
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [dict(max_batch=1), dict(max_batch=4),
                                dict(max_batch=64),
                                dict(max_batch=8, seq_dim=1, max_seq=16)])
def test_bucket_policy_matches_jax(kw):
    mine, ref = export_cache.BucketPolicy(**kw), jcache.BucketPolicy(**kw)
    assert mine.describe() == ref.describe()
    assert mine.n_buckets() == ref.n_buckets()
    for n in range(0, kw["max_batch"] + 3):
        try:
            want = ref.bucket_batch(n)
        except (jcache.BucketOverflowError, ValueError) as e:
            err = (export_cache.BucketOverflowError
                   if isinstance(e, jcache.BucketOverflowError)
                   else ValueError)
            with pytest.raises(err):
                mine.bucket_batch(n)
            continue
        assert mine.bucket_batch(n) == want
    if "max_seq" in kw:
        assert [mine.bucket_seq(s) for s in range(1, 17)] == \
            [ref.bucket_seq(s) for s in range(1, 17)]
        with pytest.raises(export_cache.BucketOverflowError):
            mine.bucket_seq(17)


@pytest.mark.parametrize("kw", [dict(max_batch=6), dict(max_batch=0),
                                dict(seq_dim=1), dict(max_seq=8),
                                dict(seq_dim=1, max_seq=12)])
def test_bucket_policy_rejects_what_jax_rejects(kw):
    with pytest.raises(ValueError):
        jcache.BucketPolicy(**kw)
    with pytest.raises(ValueError):
        export_cache.BucketPolicy(**kw)


@pytest.mark.parametrize("kw", [dict(max_batch=8),
                                dict(max_batch=8, seq_dim=1, max_seq=8)])
def test_pad_and_slice_match_jax(kw):
    rs = np.random.RandomState(0)
    arrays = [rs.randn(3, 5, 2).astype(np.float32),
              rs.randint(0, 9, (3, 5)).astype(np.int32),
              rs.randn(7).astype(np.float32)]  # not batch-led: untouched
    want, winfo = jcache.pad_batch_to_bucket(arrays,
                                             jcache.BucketPolicy(**kw))
    got, info = export_cache.pad_batch_to_bucket(
        arrays, export_cache.BucketPolicy(**kw))
    assert info == winfo
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    out = (got[0] * 2, {"ids": got[1]})
    cut = export_cache.slice_bucket_out(out, info)
    wcut = jcache.slice_bucket_out(out, winfo)
    np.testing.assert_array_equal(cut[0], np.asarray(wcut[0]))
    np.testing.assert_array_equal(cut[1]["ids"], np.asarray(wcut[1]["ids"]))
    np.testing.assert_array_equal(export_cache.batch_mask(3, 8),
                                  jcache.batch_mask(3, 8))
    np.testing.assert_array_equal(export_cache.pad_batch(arrays, 5)[0],
                                  np.asarray(jcache.pad_batch(arrays, 5)[0]))


def test_configure_validates_like_jax():
    saved = serve.get_config()
    try:
        assert serve.configure(max_batch=8)["max_batch"] == 8
        for bad in (dict(max_wait_ms=-1), dict(max_queue=0)):
            with pytest.raises(ValueError):
                serve.configure(**bad)
            with pytest.raises(ValueError):
                jserve.configure(**bad)
        with pytest.raises(KeyError):
            serve.configure(deadline_ms=5)
    finally:
        serve.configure(**saved)
    assert serve.get_config() == saved


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------
def test_concurrent_submits_coalesce_into_one_dispatch(lm):
    n = 6
    reqs = [_ids(1, seed=i) for i in range(n)]
    eng = serve.ServingEngine(lm, max_batch=n, max_wait_ms=2000).start()
    barrier = threading.Barrier(n)
    futs = [None] * n

    def client(i):
        barrier.wait(10)
        futs[i] = eng.submit(reqs[i])

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
        assert not any(t.is_alive() for t in threads)
        replies = [f.result(30) for f in futs]
    finally:
        eng.stop()
    snap = eng.stats.snapshot()
    assert snap["dispatches"] == 1 and snap["max_coalesce"] == n
    assert snap["buckets"] == {"8": 1} and snap["pad_rows"] == 2
    for ids, rep in zip(reqs, replies):
        assert rep.shape == (1, S, V)
        np.testing.assert_allclose(rep, _forward(lm, ids), rtol=1e-5,
                                   atol=1e-5)
    assert snap["requests"] == snap["replies"] == n


def test_pad_rows_never_reach_a_reply(lm):
    reqs = [_ids(3, seed=10), _ids(1, seed=11), _ids(2, seed=12)]
    with serve.ServingEngine(lm, max_batch=8, max_wait_ms=300) as eng:
        futs = [eng.submit(r) for r in reqs]
        replies = [f.result(30) for f in futs]
        alone = eng.infer(_ids(3, seed=13), timeout=30)
    for ids, rep in zip(reqs, replies):
        assert rep.shape == (ids.shape[0], S, V)
        np.testing.assert_allclose(rep, _forward(lm, ids), rtol=1e-5,
                                   atol=1e-5)
    assert alone.shape == (3, S, V)  # bucket 4, one pad row cut
    snap = eng.stats.snapshot()
    assert snap["pad_rows"] >= 1 and snap["failed"] == 0
    assert snap["requests"] == snap["replies"] == 4
    assert eng.percentiles()["p50_ms"] is not None


def test_other_signatures_dispatch_separately(lm):
    short = np.random.RandomState(0).randint(0, V, (1, 8)).astype(np.int32)
    with serve.ServingEngine(lm, max_batch=4, max_wait_ms=200) as eng:
        f1, f2 = eng.submit(_ids(1, seed=1)), eng.submit(short)
        r1, r2 = f1.result(30), f2.result(30)
    assert r1.shape == (1, S, V) and r2.shape == (1, 8, V)
    np.testing.assert_allclose(r2, _forward(lm, short), rtol=1e-5,
                               atol=1e-5)
    assert eng.stats.snapshot()["dispatches"] == 2


def test_overflow_is_loud(lm):
    pol = export_cache.BucketPolicy(max_batch=4, seq_dim=1, max_seq=16)
    with serve.ServingEngine(lm, max_batch=4, bucket_policy=pol) as eng:
        with pytest.raises(export_cache.BucketOverflowError):
            eng.submit(_ids(5, seed=0))
        with pytest.raises(export_cache.BucketOverflowError,
                           match="max_seq"):
            eng.submit(np.zeros((1, 17), np.int32))
        assert eng.infer(_ids(2, seed=1), timeout=30).shape == (2, S, V)
    snap = eng.stats.snapshot()
    assert snap["overflowed"] == 2 and snap["replies"] == 1
    with pytest.raises(ValueError, match="bucket ceiling"):
        serve.ServingEngine(lm, max_batch=8, bucket_policy=pol)


class _Gate(torch.nn.Module):
    """A model whose forward waits for `release` (or raises `error`)."""

    def __init__(self, error=None):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(()))
        self.release = threading.Event()
        self.entered = threading.Event()
        self.error = error

    def forward(self, x):
        self.entered.set()
        self.release.wait(30)
        if self.error is not None:
            raise self.error
        return x.float() * self.w


def test_full_queue_drops_loudly():
    gate = _Gate()
    eng = serve.ServingEngine(gate, max_batch=1, max_queue=2,
                              max_wait_ms=0).start()
    try:
        first = eng.submit(np.ones((1, 3), np.float32))
        assert gate.entered.wait(10)  # the dispatcher holds request 1
        queued = [eng.submit(np.ones((1, 3), np.float32)) for _ in range(2)]
        with pytest.raises(serve.ServeQueueFullError):
            eng.submit(np.ones((1, 3), np.float32))
        gate.release.set()
        for f in [first] + queued:
            np.testing.assert_array_equal(f.result(10), np.ones((1, 3)))
    finally:
        gate.release.set()
        eng.stop()
    snap = eng.stats.snapshot()
    assert snap["dropped"] == 1 and snap["replies"] == 3
    assert snap["requests"] == snap["replies"] + snap["dropped"]


def test_closed_engine_refuses_and_fails_queued():
    gate = _Gate()
    eng = serve.ServingEngine(gate, max_batch=1, max_wait_ms=0)
    with pytest.raises(serve.ServeClosedError, match="start"):
        eng.submit(np.ones((1, 2), np.float32))
    eng.start()
    first = eng.submit(np.ones((1, 2), np.float32))
    assert gate.entered.wait(10)
    waiting = eng.submit(np.ones((1, 2), np.float32))
    stopper = threading.Thread(target=eng.stop, kwargs={"drain": False})
    stopper.start()
    with pytest.raises(serve.ServeClosedError):
        waiting.result(10)
    gate.release.set()
    stopper.join(10)
    assert not stopper.is_alive()
    assert first.result(10).shape == (1, 2)
    with pytest.raises(serve.ServeClosedError):
        eng.submit(np.ones((1, 2), np.float32))
    snap = eng.stats.snapshot()
    assert snap["failed"] == 1 and snap["replies"] == 1


def test_dispatch_error_fails_the_group_and_engine_lives_on():
    gate = _Gate(error=RuntimeError("device fault"))
    gate.release.set()
    with serve.ServingEngine(gate, max_batch=2, max_wait_ms=0) as eng:
        fut = eng.submit(np.ones((1, 2), np.float32))
        with pytest.raises(RuntimeError, match="device fault"):
            fut.result(10)
        gate.error = None
        assert eng.infer(np.ones((1, 2), np.float32), timeout=10).shape \
            == (1, 2)
    assert eng.stats.snapshot()["failed"] == 1


def test_warmup_runs_every_bucket(lm):
    eng = serve.ServingEngine(lm, max_batch=4)
    assert eng.warmup(_ids(1, seed=0)) == 3  # buckets 1, 2, 4
    with pytest.raises(ValueError, match="0-d"):
        eng.warmup(np.int32(3))


def test_replies_match_jax_serving_engine():
    """Same carried weights, same requests: the port's replies equal the
    JAX ServingEngine's within rtol 1e-4, atol 1e-4."""
    jdevice.get_default_device().SetRandSeed(4)
    jm = JaxLM(V, **CFG)
    jm.compile([tensor.from_numpy(np.zeros((1, S), np.int32))],
               is_train=False, use_graph=False)
    pm = TransformerLM(V, device="cpu", **CFG)
    convert.load_singa_params(
        pm, {n: p.to_numpy() for n, p in jm.get_params().items()})
    reqs = [_ids(1, seed=20), _ids(2, seed=21), _ids(1, seed=22)]
    with jserve.ServingEngine(jm, max_batch=4, max_wait_ms=300) as jeng:
        want = [f.result(120) for f in [jeng.submit(r) for r in reqs]]
    with serve.ServingEngine(pm, max_batch=4, max_wait_ms=300) as eng:
        got = [f.result(60) for f in [eng.submit(r) for r in reqs]]
    for g, w, r in zip(got, want, reqs):
        assert g.shape == np.asarray(w).shape == (r.shape[0], S, V)
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-4)
