"""Decoder-only transformer LM. Counterpart of
`singa_tpu.models.transformer` (`TransformerBlock`, `TransformerLM.forward`,
`train_one_batch`, `create_model`): pre-norm blocks, learned position
embeddings, optional tied embeddings, `layer` or `rms` norm.

The KV-cached decode methods (`generate`, the slab ladder) and the mesh
options (ring attention, tensor parallelism) arrive with later slices.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import autograd, layer, model
from ..device import DeviceLike, generator, get_device

_NORM_CLS = {"layer": layer.LayerNorm, "rms": layer.RMSNorm}


def _norm_cls(norm: str):
    try:
        return _NORM_CLS[norm]
    except KeyError:
        raise ValueError(
            f"norm must be one of {sorted(_NORM_CLS)}, got {norm!r}"
        ) from None


class TransformerBlock(layer.Layer):
    """Pre-norm block: x + MHA(LN(x)); x + MLP(LN(x))."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int,
                 causal: bool = True, dropout: float = 0.0,
                 norm: str = "layer",
                 generator: Optional[torch.Generator] = None, name=None):
        super().__init__(name)
        norm_cls = _norm_cls(norm)
        self.ln1 = norm_cls(d_model)
        self.attn = layer.MultiHeadAttention(d_model, num_heads,
                                             causal=causal, dropout=dropout,
                                             generator=generator)
        self.ln2 = norm_cls(d_model)
        self.fc1 = layer.Linear(d_model, d_ff, generator=generator)
        self.act = layer.Gelu()
        self.fc2 = layer.Linear(d_ff, d_model, generator=generator)
        self.drop = layer.Dropout(dropout) if dropout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = autograd.add(x, self.attn(self.ln1(x)))
        h = self.fc2(self.act(self.fc1(self.ln2(x))))
        if self.drop is not None:
            h = self.drop(h)
        return autograd.add(x, h)


class TransformerLM(model.Model):
    """Causal LM over int token ids [B, S] -> float32 logits [B, S, V].

    Built on `device` (default `cuda`; `get_device` raises without one),
    with parameters drawn from a CPU generator seeded by `seed`."""

    def __init__(self, vocab_size: int, d_model: int = 256,
                 num_heads: int = 8, num_layers: int = 4,
                 d_ff: Optional[int] = None, max_len: int = 1024,
                 dropout: float = 0.0, tie_embeddings: bool = False,
                 norm: str = "layer", device: DeviceLike = None,
                 seed: int = 0):
        super().__init__()
        dev = get_device(device)
        norm_cls = _norm_cls(norm)
        d_ff = d_ff or 4 * d_model
        g = generator(seed)
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.tie_embeddings = tie_embeddings
        self.norm = norm
        self.embed = layer.Embedding(vocab_size, d_model, generator=g)
        self.pos_embed = layer.Embedding(max_len, d_model, generator=g)
        self.blocks = layer.Sequential(*[
            TransformerBlock(d_model, num_heads, d_ff, causal=True,
                             dropout=dropout, norm=norm, generator=g)
            for _ in range(num_layers)
        ])
        self.ln_f = norm_cls(d_model)
        # tied: logits = h @ W_embed^T; untied: separate projection
        self.head = (None if tie_embeddings
                     else layer.Linear(d_model, vocab_size, bias=False,
                                       generator=g))
        self.to(dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, S = x.shape
        if S > self.max_len:
            raise ValueError(f"sequence length {S} exceeds max_len "
                             f"{self.max_len}")
        pos = torch.arange(S, device=x.device)
        h = autograd.add(self.embed(x), self.pos_embed(pos))
        h = self.blocks(h)
        h = self.ln_f(h)
        if self.tie_embeddings:
            return autograd.matmul(h, autograd.transpose(self.embed.W,
                                                         (1, 0)))
        return self.head(h)

    def train_one_batch(self, x: torch.Tensor, y: torch.Tensor):
        """One step: logits [B, S, V], the mean cross-entropy over the
        B*S positions (labels < 0 are padding), backward and the
        optimizer's update. Returns (logits, loss)."""
        self._require_optimizer()
        out = self.forward(x)
        logits = autograd.reshape(out, (-1, self.vocab_size))
        labels = autograd.reshape(y, (-1,))
        loss = autograd.softmax_cross_entropy(logits, labels)
        self._optimizer.backward_and_update(loss)
        return out, loss


def create_model(vocab_size: int = 256, **kwargs) -> TransformerLM:
    return TransformerLM(vocab_size, **kwargs)
