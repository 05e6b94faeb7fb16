"""Differentiable functions of the port. Counterpart of the
`singa_tpu.autograd` operators `Embedding`, `Add`, `AddBias`, `Mult`, `Gelu`,
`LayerNorm`, `Reshape`, `Transpose`, `Attention`, `Dropout`,
`SoftMaxCrossEntropy` and `MeanSquareError`, and of `backward`/`gradients`.

Gradients come from PyTorch's autograd, not from a copy of the JAX
package's engine (`Operator` and its dependency-counting walk). Plain ops
get their backward from PyTorch; each op whose JAX version has a Pallas
backward is a `torch.autograd.Function` whose backward is a kernel too:
`FlashAttention` (the flash-attention dq and dk/dv kernels) and
`SoftMaxCrossEntropy` (the fused softmax cross-entropy backward). On CPU
tensors both directions take the kernels' plain versions.

Attention routing: for a CUDA tensor with Sq == Sk, `attention` goes
through `FlashAttention`, for every sequence length; otherwise it takes
`plain_attention`. The JAX package gates its Pallas kernels behind
`SINGA_TPU_PALLAS` and a sequence-length crossover (`_ATTN_MIN_SEQ`) that
were measured on a TPU v5e; those numbers say nothing about the card, so
the port has no such switch. Measuring the crossover on the card is later
work.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import tensor as tensor_mod
from .ops.attention import plain_attention
from .ops.flash_attention import flash_attention, flash_attention_bwd
from .ops.softmax_xent import softmax_xent, softmax_xent_bwd


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


class FlashAttention(torch.autograd.Function):
    """Self-attention over [B, H, S, D] through the flash kernels: the
    forward kernel saves (q, k, v, o, lse); the backward runs the dq and
    dk/dv kernels. Counterpart of the JAX `custom_vjp` around
    `pallas_kernels.flash_attention`."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: Optional[float]):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_attention(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # dO arrives strided from the transpose/reshape after attention.
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, scale: Optional[float] = None
              ) -> torch.Tensor:
    """Scaled-dot-product attention over [B, H, S, D]."""
    if q.is_cuda and q.shape[2] == k.shape[2]:
        return FlashAttention.apply(q, k, v, causal, scale)
    return plain_attention(q, k, v, causal=causal, scale=scale)


def dropout(x: torch.Tensor, ratio: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Train-mode dropout: x * mask, mask in {0, 1/keep} drawn by
    `torch.bernoulli` from `generator` (the JAX default path's
    `jax.random.bernoulli`); its backward is dy * mask. The mask is drawn on
    x's device, so `generator` must live there: a generator on another
    device raises rather than drawing the mask there and copying it over.
    Dropout's TPU kernel (`pallas_kernels.dropout`) is not ported yet."""
    if ratio == 0.0:
        return x
    if generator is not None and generator.device != x.device:
        raise ValueError(f"dropout: the generator is on {generator.device}, "
                         f"x on {x.device}; give a generator on x's device")
    keep = 1.0 - ratio
    draw = torch.full(x.shape, keep, dtype=torch.float32, device=x.device)
    mask = torch.bernoulli(draw, generator=generator).to(x.dtype)
    return x * (mask / keep)


# ---- losses -----------------------------------------------------------------
class SoftMaxCrossEntropy(torch.autograd.Function):
    """Softmax + cross-entropy, summed over rows and divided by `n`.

    Integer labels: the fused kernels (`ops.softmax_xent`), loss math in
    float32, labels < 0 or >= C giving zero loss and zero gradient; the
    backward feeds `g = dy / n` to every row and returns dx in the logits'
    dtype. Probability (or one-hot) targets: plain ops, `dx = dy (p - t) / n`
    as the JAX op's hand-written backward, with no validity mask."""

    @staticmethod
    def forward(ctx, x, t, n: int):
        ctx.n = n
        ctx.soft = t.is_floating_point()
        if not ctx.soft:
            ctx.save_for_backward(x, t)
            return softmax_xent(x, t).sum() / n
        logp = torch.log_softmax(x.float(), dim=-1)
        ctx.save_for_backward(x, t, torch.exp(logp))
        return -torch.sum(t * logp) / n

    @staticmethod
    def backward(ctx, dy):
        if ctx.soft:
            x, t, p = ctx.saved_tensors
            return (dy.float() * (p - t) / ctx.n).to(x.dtype), None, None
        x, t = ctx.saved_tensors
        g = (dy.float() / ctx.n).expand(x.shape[0]).contiguous()
        return softmax_xent_bwd(x, t, g), None, None


def softmax_cross_entropy(x: torch.Tensor, t) -> torch.Tensor:
    """Mean cross-entropy over the batch (the sum over rows divided by
    `x.shape[0]`, so rows with an invalid label count in the mean), as
    `singa_tpu.autograd.softmax_cross_entropy`. `t` holds class ids of
    shape x.shape[:-1] (or with a trailing 1), or per-class targets of x's
    shape."""
    t = torch.as_tensor(t, device=x.device)
    n = x.shape[0] if x.dim() > 1 else 1
    int_labels = t.dim() == x.dim() - 1 or (t.dim() == x.dim()
                                            and t.shape[-1] == 1)
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.float()
    if int_labels:
        # Class ids, also when given as floats (the JAX op casts to int32).
        labels = t.reshape(-1)
        if labels.is_floating_point():
            labels = labels.long()
        return SoftMaxCrossEntropy.apply(x.reshape(-1, x.shape[-1]), labels,
                                         n)
    return SoftMaxCrossEntropy.apply(x, t.to(torch.float32), n)


def mse_loss(x: torch.Tensor, t) -> torch.Tensor:
    """sum((x - t)^2) / (2 n), n = x.shape[0]: gradient (x - t) / n, as
    `singa_tpu.autograd.MeanSquareError`."""
    t = torch.as_tensor(t, device=x.device, dtype=x.dtype)
    n = x.shape[0] if x.dim() > 0 else 1
    return torch.sum(torch.square(x - t)) / (2.0 * n)


# ---- backward ---------------------------------------------------------------
def _reached_leaves(y: torch.Tensor) -> List[torch.Tensor]:
    """The leaf tensors that require grad and that `y` depends on, in the
    order a depth-first walk of its graph from `y` first meets them."""
    if y.grad_fn is None:
        return [y] if y.requires_grad else []
    leaves, seen, stack = [], set(), [y.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        var = getattr(fn, "variable", None)  # AccumulateGrad of a leaf
        if var is not None:
            leaves.append(var)
            continue
        stack.extend(nxt for nxt, _ in reversed(fn.next_functions))
    return leaves


def backward(y: torch.Tensor, dy=None
             ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The (param, grad) pairs of `y` for every leaf that requires grad and
    that `y` reaches, in a fixed order. `dy` seeds the output gradient
    (ones by default). Assigns nothing: the optimizer applies the pairs.
    Counterpart of `singa_tpu.autograd.backward`, built on
    `torch.autograd.grad`."""
    params = _reached_leaves(y)
    if not params:
        return []
    if dy is None:
        dy = torch.ones_like(y)
    else:
        dy = torch.as_tensor(dy, device=y.device, dtype=y.dtype)
    grads = torch.autograd.grad(y, params, grad_outputs=dy,
                                allow_unused=True)
    return [(p, g) for p, g in zip(params, grads) if g is not None]


def gradients(y: torch.Tensor, dy=None) -> Dict[torch.Tensor, torch.Tensor]:
    """param -> grad for `backward(y, dy)`'s pairs."""
    return dict(backward(y, dy))
