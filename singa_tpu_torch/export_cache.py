"""Shape buckets for serving dispatches. Counterpart of the bucketing half
of `singa_tpu.export_cache`: `BucketOverflowError`, `BucketPolicy`,
`pad_batch`, `batch_mask`, `pad_batch_to_bucket`, `slice_bucket_out`.

The JAX module also keeps an on-disk store of `jax.export` artifacts so a
worker never re-traces. The port runs eagerly and traces nothing, so that
store has no counterpart here. Buckets still matter: they bound the number
of distinct shapes the card sees (for cuBLAS algorithm choice now, and for
CUDA-graph capture later).

Padding repeats the final sample (real values, no NaN or denormal hazards),
and a shape above the top bucket is a loud error, never a silent new shape.
Requests arrive as numpy arrays, so the helpers pad on the host.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class BucketOverflowError(ValueError):
    """A dispatched shape exceeds the largest configured bucket: the
    caller must raise the ceiling or reject the request."""


class BucketPolicy:
    """Powers-of-two shape buckets with explicit ceilings.

    `max_batch` bounds the batch (dim 0) ladder; `seq_dim`/`max_seq`
    optionally bucket a sequence dimension too (right-pad semantics, safe
    for causal attention only). Ceilings must be powers of two."""

    def __init__(self, max_batch: int = 4096,
                 seq_dim: Optional[int] = None,
                 max_seq: Optional[int] = None):
        self.max_batch = int(max_batch)
        self.seq_dim = None if seq_dim is None else int(seq_dim)
        self.max_seq = None if max_seq is None else int(max_seq)
        for name, v in (("max_batch", self.max_batch),
                        ("max_seq", self.max_seq)):
            if v is not None and (v < 1 or v & (v - 1)):
                raise ValueError(
                    f"BucketPolicy {name} must be a power of two >= 1, "
                    f"got {v}")
        if self.seq_dim is not None and self.max_seq is None:
            raise ValueError("seq_dim set but max_seq missing")
        if self.max_seq is not None and self.seq_dim is None:
            raise ValueError("max_seq set but seq_dim missing")

    @staticmethod
    def _bucket(n: int, ceiling: int, what: str) -> int:
        if n < 1:
            raise ValueError(f"cannot bucket empty {what} dim ({n})")
        if n > ceiling:
            raise BucketOverflowError(
                f"{what} size {n} exceeds the largest configured "
                f"bucket ({ceiling}); raise the ceiling or reject the "
                "request")
        b = 1
        while b < n:
            b <<= 1
        return b

    def bucket_batch(self, n: int) -> int:
        return self._bucket(int(n), self.max_batch, "batch")

    def bucket_seq(self, n: int) -> int:
        return self._bucket(int(n), self.max_seq, "sequence")

    def n_buckets(self) -> int:
        """Upper bound on distinct bucketed shapes per dimension set."""
        out = self.max_batch.bit_length()
        if self.max_seq is not None:
            out *= self.max_seq.bit_length()
        return out

    def describe(self) -> Dict:
        return {"max_batch": self.max_batch, "seq_dim": self.seq_dim,
                "max_seq": self.max_seq}


def _batch_leader(arrays) -> Optional[int]:
    """dim 0 of the first array that has one."""
    for a in arrays:
        if getattr(a, "ndim", 0) >= 1:
            return int(a.shape[0])
    return None


def _repeat_last(a: np.ndarray, dim: int, n_extra: int) -> np.ndarray:
    """Append `n_extra` copies of the last slice of `a` along `dim`."""
    tail = np.take(a, [a.shape[dim] - 1], axis=dim)
    reps = [1] * a.ndim
    reps[dim] = n_extra
    return np.concatenate([a, np.tile(tail, reps)], axis=dim)


def pad_batch(arrays, n_target: int):
    """Right-pad dim 0 of every array sharing the leading batch dim up to
    `n_target` by repeating the final sample; other arrays pass through."""
    n = _batch_leader(arrays)
    if n is None or n == n_target:
        return list(arrays)
    return [_repeat_last(a, 0, n_target - n)
            if getattr(a, "ndim", 0) >= 1 and int(a.shape[0]) == n else a
            for a in arrays]


def batch_mask(n_real: int, n_target: int, dtype="float32") -> np.ndarray:
    """[n_target] mask: 1 for real rows, exact 0 for pad rows."""
    m = np.zeros((n_target,), dtype=dtype)
    m[:n_real] = 1
    return m


def pad_batch_to_bucket(arrays, policy: BucketPolicy):
    """Bucket-pad a dispatch batch. Returns (padded_arrays, info) with
    info = {n_real, n_bucket, seq_real, seq_bucket, seq_dim}, the recipe
    `slice_bucket_out` uses to cut the reply back. Raises
    `BucketOverflowError` above the top bucket."""
    n = _batch_leader(arrays)
    info = {"n_real": n, "n_bucket": n, "seq_real": None,
            "seq_bucket": None, "seq_dim": policy.seq_dim}
    if n is None:
        return list(arrays), info
    target = policy.bucket_batch(n)
    info["n_bucket"] = target
    out = pad_batch(arrays, target)
    if policy.seq_dim is not None:
        d = policy.seq_dim
        seq_out = []
        for a in out:
            if getattr(a, "ndim", 0) > d:
                s = int(a.shape[d])
                st = policy.bucket_seq(s)
                if info["seq_real"] is None:
                    info["seq_real"], info["seq_bucket"] = s, st
                if st != s:
                    a = _repeat_last(a, d, st - s)
            seq_out.append(a)
        out = seq_out
    return out, info


def slice_bucket_out(out_tree, info):
    """Undo bucket padding on a reply (an array, or a tuple/list/dict of
    them): leaves carrying the bucketed batch dim are cut to `n_real`, and
    leaves carrying the bucketed seq dim to `seq_real`. Batch-ness is
    inferred by shape, so keep bucket ceilings apart from unrelated output
    dims."""
    n_real, n_bucket = info["n_real"], info["n_bucket"]
    s_real, s_bucket = info["seq_real"], info["seq_bucket"]
    d = info["seq_dim"]

    def leaf(a):
        if (n_bucket != n_real and getattr(a, "ndim", 0) >= 1
                and a.shape[0] == n_bucket):
            a = a[:n_real]
        if (s_bucket is not None and s_bucket != s_real
                and getattr(a, "ndim", 0) > d and a.shape[d] == s_bucket):
            idx = [slice(None)] * a.ndim
            idx[d] = slice(0, s_real)
            a = a[tuple(idx)]
        return a

    return tree_map(leaf, out_tree)


def tree_map(fn, tree):
    """Apply `fn` to every array leaf of nested tuples, lists and dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)
