"""Flash attention, forward and backward: the port of
`singa_tpu.ops.pallas_kernels` `_flash_fwd` (pallas_call at
pallas_kernels.py:494) and `_flash_bwd` (its dq pallas_call at :525 and its
dk/dv pallas_call at :539).

`flash_attention(q, k, v, causal, scale)` returns `(o, lse)` for
self-attention over [B, H, S, D]: o in q's dtype, lse = m + log(l) per query
row as (B, H, S) float32. The serving path reads only `o`.
`flash_attention_bwd(q, k, v, o, lse, do, causal, scale)` returns
`(dq, dk, dv)` from the forward's o and lse, recomputing the softmax.

On a CUDA tensor each wrapper launches its hand-written Hopper kernels
(`csrc/flash_attn_fwd.cu`, online softmax over K/V tiles;
`csrc/flash_attn_bwd.cu`, a dq kernel and a dk/dv kernel) or raises. On a
CPU tensor it takes the plain PyTorch version (`flash_attention_reference`,
`flash_attention_bwd_reference`, itself the dq and dk/dv kernels' plain
versions in turn). There is no fallback between the two.
`flash_attention.launches`, `flash_attention_bwd.dq_launches` and
`flash_attention_bwd.dkv_launches` count kernel launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build
from .attention import attention_scores

HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BH = 65535  # grid.y limit of the launch


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4:
        raise ValueError(f"flash_attention takes [B, H, S, D], got "
                         f"{tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            "flash_attention is self-attention: q, k, v must share "
            f"[B, H, S, D], got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash_attention head width D={q.shape[-1]} is not "
                         f"one of {HEAD_DIMS}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v on different devices")


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: `plain_attention`'s score and softmax
    steps in float32 (the kernel's accumulation type) plus the row
    logsumexp. Returns (o in q's dtype, lse float32 [B, H, S])."""
    _check(q, k, v)
    s = attention_scores(q.float(), k.float(), causal=causal, scale=scale)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o.to(q.dtype), lse


def _scale(d: int, scale: Optional[float]) -> float:
    return float(scale) if scale is not None else 1.0 / math.sqrt(d)


def _launch_args(q: torch.Tensor, *others: torch.Tensor):
    """Check a CUDA launch's operands; return (B*H, S, D)."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if not all(t.is_contiguous() for t in (q,) + others):
        raise ValueError("flash_attention's kernels take contiguous "
                         "operands")
    b, h, s, d = q.shape
    if b * h > _MAX_BH:
        raise ValueError(f"flash_attention: B*H={b * h} above {_MAX_BH}")
    return b * h, s, d


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attn_fwd")
    fn = lib.singa_flash_attn_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused attention over contiguous [B, H, S, D]; returns (o, lse)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, scale)
    bh, s, d = _launch_args(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.singa_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bh, s, d, _DTYPE_CODES[q.dtype], int(causal),
            _scale(d, scale), stream)
    _build.check(lib, err, "flash_attn_fwd launch")
    flash_attention.launches += 1
    return o, lse


flash_attention.launches = 0


def _check_bwd(q, k, v, do, rows, o=None) -> None:
    """q, k, v as the forward takes them; do (and o) of q's shape and
    dtype; `rows` (lse, delta) float32 [B, H, S]; one device for all."""
    _check(q, k, v)
    for t in (do,) if o is None else (do, o):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"flash_attention_bwd: o and do must be "
                             f"{q.dtype} {tuple(q.shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    for r in rows:
        if r.shape != q.shape[:3] or r.dtype != torch.float32:
            raise ValueError(f"flash_attention_bwd: lse and delta must be "
                             f"float32 {tuple(q.shape[:3])}, got {r.dtype} "
                             f"{tuple(r.shape)}")
    if any(t.device != q.device for t in (do,) + tuple(rows)
           + ((o,) if o is not None else ())):
        raise ValueError("flash_attention_bwd: operands on different "
                         "devices")


def _probs(q, k, lse, causal, sc):
    """P = exp(s - lse) in float32 from the forward's row logsumexp."""
    s = attention_scores(q.float(), k.float(), causal=causal, scale=sc)
    return torch.exp(s - lse[..., None])


def flash_attention_dq_reference(q, k, v, o, lse, do, causal=True,
                                 scale=None):
    """The plain PyTorch version of the dq kernel, in float32: returns
    (dq in q's dtype, delta = rowsum(dO * O) as (B, H, S) float32)."""
    _check_bwd(q, k, v, do, (lse,), o)
    sc = _scale(q.shape[-1], scale)
    p = _probs(q, k, lse, causal, sc)
    delta = torch.sum(do.float() * o.float(), dim=-1)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * sc
    return dq.to(q.dtype), delta


def flash_attention_dkv_reference(q, k, v, lse, delta, do, causal=True,
                                  scale=None):
    """The plain PyTorch version of the dk/dv kernel, in float32: returns
    (dk, dv) in k's and v's dtype."""
    _check_bwd(q, k, v, do, (lse, delta))
    sc = _scale(q.shape[-1], scale)
    p = _probs(q, k, lse, causal, sc)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float())
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    ds = p * (dp - delta[..., None])
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * sc
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, o: torch.Tensor,
                                  lse: torch.Tensor, do: torch.Tensor,
                                  causal: bool = True,
                                  scale: Optional[float] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """The plain PyTorch version of the backward: the dq kernel's and the
    dk/dv kernel's plain versions in turn. Returns (dq, dk, dv) in q's,
    k's and v's dtype."""
    dq, delta = flash_attention_dq_reference(q, k, v, o, lse, do, causal,
                                             scale)
    dk, dv = flash_attention_dkv_reference(q, k, v, lse, delta, do, causal,
                                           scale)
    return dq, dk, dv


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attn_bwd")
    if lib.singa_flash_attn_bwd_dq.argtypes is None:
        lib.singa_flash_attn_bwd_dq.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_void_p])
        lib.singa_flash_attn_bwd_dq.restype = ctypes.c_int
        lib.singa_flash_attn_bwd_dkv.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_void_p])
        lib.singa_flash_attn_bwd_dkv.restype = ctypes.c_int
    return lib


def flash_attention_dq(q, k, v, o, lse, do, causal=True, scale=None):
    """The dq kernel: returns (dq, delta), delta = rowsum(dO * O) as
    (B, H, S) float32 for the dk/dv kernel."""
    _check_bwd(q, k, v, do, (lse,), o)
    if q.device.type == "cpu":
        return flash_attention_dq_reference(q, k, v, o, lse, do, causal,
                                            scale)
    bh, s, d = _launch_args(q, k, v, o, lse, do)
    dq = torch.empty_like(q)
    delta = torch.empty_like(lse)
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.singa_flash_attn_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            bh, s, d, _DTYPE_CODES[q.dtype], int(causal), _scale(d, scale),
            stream)
    _build.check(lib, err, "flash_attn_bwd dq launch")
    flash_attention_bwd.dq_launches += 1
    return dq, delta


def flash_attention_dkv(q, k, v, lse, delta, do, causal=True, scale=None):
    """The dk/dv kernel: returns (dk, dv)."""
    _check_bwd(q, k, v, do, (lse, delta))
    if q.device.type == "cpu":
        return flash_attention_dkv_reference(q, k, v, lse, delta, do,
                                             causal, scale)
    bh, s, d = _launch_args(q, k, v, lse, delta, do)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.singa_flash_attn_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            bh, s, d, _DTYPE_CODES[q.dtype], int(causal), _scale(d, scale),
            stream)
    _build.check(lib, err, "flash_attn_bwd dk/dv launch")
    flash_attention_bwd.dkv_launches += 1
    return dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        causal: bool = True, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of self-attention over contiguous
    [B, H, S, D], given the forward's o and lse and the output gradient
    do: the dq kernel, then the dk/dv kernel, on the current stream."""
    dq, delta = flash_attention_dq(q, k, v, o, lse, do, causal, scale)
    dk, dv = flash_attention_dkv(q, k, v, lse, delta, do, causal, scale)
    return dq, dk, dv


flash_attention_bwd.dq_launches = 0
flash_attention_bwd.dkv_launches = 0
