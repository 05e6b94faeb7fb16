"""Fused softmax cross-entropy: the port of `singa_tpu.ops.pallas_kernels`
`_softmax_xent_fwd` (pallas_call at pallas_kernels.py:171) and
`_softmax_xent_bwd` (pallas_call at :193).

`softmax_xent(x, labels)` returns the per-row loss `logsumexp(x) - x[label]`
as (B,) float32; `softmax_xent_bwd(x, labels, g)` returns
`dx = (softmax(x) - onehot(label)) * g` in x's dtype. A label < 0 or >= C
gives zero loss and a zero gradient row (the JAX kernels' padding rule).
Logits are float32 or bfloat16; the math is float32 either way.

On a CUDA tensor each wrapper launches its hand-written Hopper kernel
(`csrc/softmax_xent.cu`, one block per row, an online max/sum pass) or
raises. On a CPU tensor it takes the plain PyTorch version
(`softmax_xent_reference`, `softmax_xent_bwd_reference`). There is no
fallback between the two. `softmax_xent.launches` and
`softmax_xent_bwd.launches` count kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check(x: torch.Tensor, labels: torch.Tensor) -> None:
    if x.dim() != 2:
        raise ValueError(f"softmax_xent takes (B, C) logits, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"softmax_xent takes float32 or bfloat16 logits, "
                        f"got {x.dtype}")
    if labels.shape != (x.shape[0],):
        raise ValueError(f"softmax_xent labels must be ({x.shape[0]},), got "
                         f"{tuple(labels.shape)}")
    if labels.is_floating_point() or labels.is_complex():
        raise TypeError(f"softmax_xent takes integer labels, got "
                        f"{labels.dtype}")
    if labels.device != x.device:
        raise ValueError("softmax_xent: logits and labels on different "
                         "devices")


def _valid(x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (labels >= 0) & (labels < x.shape[1])


def softmax_xent_reference(x: torch.Tensor, labels: torch.Tensor
                           ) -> torch.Tensor:
    """The plain PyTorch version of the forward: (B,) float32."""
    _check(x, labels)
    xf = x.float()
    valid = _valid(x, labels)
    picked = xf.gather(1, torch.where(valid, labels, 0).long()[:, None])
    loss = torch.logsumexp(xf, dim=1) - picked[:, 0]
    return torch.where(valid, loss, torch.zeros_like(loss))


def softmax_xent_bwd_reference(x: torch.Tensor, labels: torch.Tensor,
                               g: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the backward: dx in x's dtype."""
    _check(x, labels)
    valid = _valid(x, labels)
    p = torch.softmax(x.float(), dim=1)
    onehot = torch.zeros_like(p)
    onehot.scatter_(1, torch.where(valid, labels, 0).long()[:, None], 1.0)
    dx = (p - onehot) * g.float()[:, None]
    return torch.where(valid[:, None], dx, torch.zeros_like(dx)).to(x.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("softmax_xent")
    if lib.singa_softmax_xent_fwd.argtypes is None:
        lib.singa_softmax_xent_fwd.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.singa_softmax_xent_fwd.restype = ctypes.c_int
        lib.singa_softmax_xent_bwd.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.singa_softmax_xent_bwd.restype = ctypes.c_int
    return lib


def _cuda_labels(x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Check a CUDA launch's logits; return the labels as the kernels read
    them, int32. Clamping first keeps an out-of-range int64 label out of
    range (and so invalid) after the narrowing."""
    if x.device.type != "cuda":
        raise ValueError(f"softmax_xent runs on cuda or cpu, not {x.device}")
    if not x.is_contiguous():
        raise ValueError("softmax_xent's kernel takes contiguous logits")
    return labels.clamp(-1, x.shape[1]).to(torch.int32).contiguous()


def softmax_xent(x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row cross-entropy of (B, C) logits and (B,) int labels:
    (B,) float32."""
    _check(x, labels)
    if x.device.type == "cpu":
        return softmax_xent_reference(x, labels)
    lab = _cuda_labels(x, labels)
    loss = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.singa_softmax_xent_fwd(
            x.data_ptr(), lab.data_ptr(), loss.data_ptr(), x.shape[0],
            x.shape[1], _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "softmax_xent_fwd launch")
    softmax_xent.launches += 1
    return loss


def softmax_xent_bwd(x: torch.Tensor, labels: torch.Tensor,
                     g: torch.Tensor) -> torch.Tensor:
    """dx = (softmax(x) - onehot(labels)) * g[:, None] in x's dtype; g is
    the (B,) upstream gradient of the per-row losses."""
    _check(x, labels)
    if g.shape != (x.shape[0],) or g.device != x.device:
        raise ValueError(f"softmax_xent_bwd: g must be ({x.shape[0]},) on "
                         f"{x.device}, got {tuple(g.shape)} on {g.device}")
    if x.device.type == "cpu":
        return softmax_xent_bwd_reference(x, labels, g)
    lab = _cuda_labels(x, labels)
    gf = g.to(torch.float32).contiguous()
    dx = torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.singa_softmax_xent_bwd(
            x.data_ptr(), lab.data_ptr(), gf.data_ptr(), dx.data_ptr(),
            x.shape[0], x.shape[1], _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "softmax_xent_bwd launch")
    softmax_xent_bwd.launches += 1
    return dx


softmax_xent.launches = 0
softmax_xent_bwd.launches = 0
