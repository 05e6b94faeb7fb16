"""Layers as `nn.Module`s. Counterpart of `singa_tpu.layer`: `Linear`,
`Embedding`, `LayerNorm`, `RMSNorm`, `Gelu`, `Dropout`,
`MultiHeadAttention` and `Sequential`.

The JAX layers size their parameters lazily from the first input; a module
here takes its input width at construction. Attribute names follow the JAX
layers, so `get_params()` gives the same hierarchical names (for example
`TransformerLM.blocks.l0.attn.q_proj.W`) and `convert.load_singa_params`
copies arrays across without renaming. `Linear` keeps the JAX layout:
W is (in, out) and y = x @ W + b.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional

import torch
from torch import nn

from . import autograd, initializer


class Layer(nn.Module):
    """Base of the port's layers: a `name` (the class name by default, as
    in the JAX package) and `get_params`/`param_tensors`."""

    def __init__(self, name: Optional[str] = None):
        super().__init__()
        self.name = name or type(self).__name__

    def get_params(self) -> "OrderedDict[str, nn.Parameter]":
        """name -> parameter, named `<self.name>.<attribute path>`."""
        return OrderedDict((f"{self.name}.{n}", p)
                           for n, p in self.named_parameters())

    def param_tensors(self) -> List[nn.Parameter]:
        return list(self.parameters())


def _param(shape, init, generator=None, **kw) -> nn.Parameter:
    t = torch.empty(shape, dtype=torch.float32)
    if generator is not None:
        kw["generator"] = generator
    init(t, **kw)
    return nn.Parameter(t)


class Linear(Layer):
    """y = x W + b with W (in, out), He-uniform W and zero b."""

    def __init__(self, in_features: int, num_output: int, bias: bool = True,
                 generator: Optional[torch.Generator] = None, name=None):
        super().__init__(name)
        self.W = _param((in_features, num_output), initializer.he_uniform,
                        generator)
        self.b = (_param((num_output,), initializer.constant, value=0.0)
                  if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = autograd.matmul(x, self.W)
        if self.b is not None:
            y = autograd.add_bias(y, self.b, axis=0)
        return y


class Embedding(Layer):
    """Lookup table (input_dim, output_dim), N(0, 0.05) init."""

    def __init__(self, input_dim: int, output_dim: int,
                 generator: Optional[torch.Generator] = None, name=None):
        super().__init__(name)
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.W = _param((input_dim, output_dim), initializer.gaussian,
                        generator, mean=0.0, std=0.05)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return autograd.embedding(self.W, x)


class LayerNorm(Layer):
    """LayerNorm over the trailing dim; params gamma/beta."""

    def __init__(self, d: int, eps: float = 1e-5, name=None):
        super().__init__(name)
        self.eps = eps
        self.gamma = _param((d,), initializer.constant, value=1.0)
        self.beta = _param((d,), initializer.constant, value=0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return autograd.layer_norm(x, self.gamma, self.beta, self.eps)


class RMSNorm(Layer):
    """Root-mean-square norm over the trailing dim; param gamma."""

    def __init__(self, d: int, eps: float = 1e-6, name=None):
        super().__init__(name)
        self.eps = eps
        self.gamma = _param((d,), initializer.constant, value=1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return autograd.rms_norm(x, self.gamma, self.eps)


class Gelu(Layer):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return autograd.gelu(x)


class Dropout(Layer):
    """Identity in eval mode, as `singa_tpu.autograd.Dropout`; in train mode
    `autograd.dropout` with a mask in {0, 1/keep} drawn from `generator`
    (the default torch stream of the input's device when None)."""

    def __init__(self, ratio: float = 0.5,
                 generator: Optional[torch.Generator] = None, name=None):
        super().__init__(name)
        self.ratio = ratio
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.ratio > 0.0:
            return autograd.dropout(x, self.ratio, self.generator)
        return x


class MultiHeadAttention(Layer):
    """Multi-head self-attention: q/k/v/o projections (d_model, d_model)
    around `autograd.attention` over [B, H, S, D]."""

    def __init__(self, d_model: int, num_heads: int, causal: bool = True,
                 dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None, name=None):
        super().__init__(name)
        if d_model % num_heads:
            raise ValueError(
                f"d_model {d_model} not divisible by heads {num_heads}")
        self.num_heads = num_heads
        self.causal = causal
        self.q_proj = Linear(d_model, d_model, generator=generator)
        self.k_proj = Linear(d_model, d_model, generator=generator)
        self.v_proj = Linear(d_model, d_model, generator=generator)
        self.o_proj = Linear(d_model, d_model, generator=generator)
        self.drop = Dropout(dropout) if dropout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, S, E = x.shape
        H = self.num_heads
        D = E // H

        def split(t):  # [B,S,E] -> [B,H,S,D]
            return autograd.transpose(autograd.reshape(t, (B, S, H, D)),
                                      (0, 2, 1, 3))

        q = split(self.q_proj(x))
        k = split(self.k_proj(x))
        v = split(self.v_proj(x))
        o = autograd.attention(q, k, v, causal=self.causal)
        o = autograd.reshape(autograd.transpose(o, (0, 2, 1, 3)), (B, S, E))
        o = self.o_proj(o)
        return self.drop(o) if self.drop is not None else o


class Sequential(Layer):
    """Children named l0, l1, ... as in the JAX container."""

    def __init__(self, *layers: nn.Module, name=None):
        super().__init__(name)
        for i, l in enumerate(layers):
            self.add_module(f"l{i}", l)

    def forward(self, x):
        for l in self.children():
            x = l(x)
        return x
