"""Plain attention over [B, H, S, D]: the port of
`singa_tpu.parallel.ring_attention.plain_attention` (single-device
semantics). Ring attention, which shards the sequence over devices, arrives
with the parallel slice."""
from __future__ import annotations

import math
from typing import Optional

import torch


def _neg_big(dtype: torch.dtype) -> float:
    # A finite "minus infinity": keeps fully-masked rows NaN-free.
    return torch.finfo(dtype).min / 2


def attention_scores(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q k^T * scale with the causal mask applied as `finfo.min / 2`."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        mask = (torch.arange(sq, device=s.device)[:, None]
                >= torch.arange(sk, device=s.device)[None, :])
        s = s.masked_fill(~mask, _neg_big(s.dtype))
    return s


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale, causal mask) v. q, k, v: [B, H, S, D]."""
    p = torch.softmax(attention_scores(q, k, causal=causal, scale=scale), -1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)
