"""Forward-only functions for the ops on the serving path. Counterpart of
the `singa_tpu.autograd` operators `Embedding`, `Add`, `AddBias`, `Mult`,
`Gelu`, `LayerNorm`, `Reshape`, `Transpose` and `Attention`; their
backward passes arrive with the training slice.

Attention routing: for a CUDA tensor with Sq == Sk, `attention` launches
the flash-attention kernel (`ops.flash_attention`), for every sequence
length; otherwise it takes `plain_attention`. The JAX package gates its
Pallas kernel behind `SINGA_TPU_PALLAS` and a sequence-length crossover
(`_ATTN_MIN_SEQ`) that were measured on a TPU v5e; those numbers say
nothing about the card, so the port has no such switch. Measuring the
crossover on the card is later work.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from . import tensor as tensor_mod
from .ops.attention import plain_attention
from .ops.flash_attention import flash_attention


def embedding(w: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Rows of `w` selected by int indices (any shape)."""
    return w[indices.long()]


def add(a: torch.Tensor, b) -> torch.Tensor:
    return a + b


def add_bias(x: torch.Tensor, b: torch.Tensor, axis: int = 0
             ) -> torch.Tensor:
    """axis 0: per-column bias added to every row; axis 1: per-row."""
    b = b.to(x.dtype)
    return x + b if axis == 0 else x + b[:, None]


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = tensor_mod.amp_cast(a, b)
    return torch.matmul(a, b)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) gelu, as `jax.nn.gelu(approximate=False)`."""
    return F.gelu(x, approximate="none")


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """(x - mean) / sqrt(biased var + eps) * gamma + beta over the last
    dim."""
    return F.layer_norm(x, (x.shape[-1],), gamma, beta, eps)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """x / sqrt(mean(x*x) + eps) * gamma over the last dim."""
    ms = torch.mean(x * x, dim=-1, keepdim=True)
    return x / torch.sqrt(ms + eps) * gamma


def reshape(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    return x.reshape(tuple(int(s) for s in shape))


def transpose(x: torch.Tensor, axes: Sequence[int]) -> torch.Tensor:
    return x.permute(*axes)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, scale: Optional[float] = None
              ) -> torch.Tensor:
    """Scaled-dot-product attention over [B, H, S, D]."""
    if q.is_cuda and q.shape[2] == k.shape[2]:
        o, _ = flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal, scale)
        return o
    return plain_attention(q, k, v, causal=causal, scale=scale)
