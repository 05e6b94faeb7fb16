"""Flash-attention forward: the port of `singa_tpu.ops.pallas_kernels`
`_flash_fwd` (pallas_call at pallas_kernels.py:494).

`flash_attention(q, k, v, causal, scale)` returns `(o, lse)` for
self-attention over [B, H, S, D]: o in q's dtype, lse = m + log(l) per query
row as (B, H, S) float32. The serving path reads only `o`; `lse` is what the
backward kernels of the training slice will consume.

On a CUDA tensor the wrapper launches the hand-written Hopper kernel
(`csrc/flash_attn_fwd.cu`, online softmax over K/V tiles) or raises. On a
CPU tensor it takes the plain PyTorch version, `flash_attention_reference`.
There is no fallback between the two. `flash_attention.launches` counts
kernel launches.
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
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention's kernel takes contiguous q, k, v")
    b, h, s, d = q.shape
    if b * h > _MAX_BH:
        raise ValueError(f"flash_attention: B*H={b * h} above {_MAX_BH}")
    sc = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.singa_flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b * h, s, d, _DTYPE_CODES[q.dtype], int(causal),
            sc, stream)
    _build.check(lib, err, "flash_attn_fwd launch")
    flash_attention.launches += 1
    return o, lse


flash_attention.launches = 0
