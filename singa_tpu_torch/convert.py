"""Carry weights from the JAX package into the port.

Input is what the JAX model gives as
`{name: p.to_numpy() for name, p in m.get_params().items()}`: hierarchical
names such as `TransformerLM.blocks.l0.attn.q_proj.W` with numpy arrays. The
port's layers keep the JAX names and layouts (`Linear.W` is (in, out)), so
arrays are copied without renaming or transposing. Unknown or missing names
and mismatched shapes raise.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .layer import Layer


def params_from_singa(named_arrays: Mapping[str, np.ndarray]
                      ) -> Dict[str, torch.Tensor]:
    """name -> CPU float tensor, one per JAX parameter (copies)."""
    return {name: torch.from_numpy(np.array(a, dtype=np.float32))
            for name, a in named_arrays.items()}


@torch.no_grad()
def load_singa_params(model: Layer,
                      named_arrays: Mapping[str, np.ndarray]) -> None:
    """Fill every parameter of `model` from the JAX package's arrays."""
    state = params_from_singa(named_arrays)
    own = model.get_params()
    unknown = sorted(set(state) - set(own))
    missing = sorted(set(own) - set(state))
    if unknown or missing:
        raise KeyError(f"JAX parameters do not match {model.name}: "
                       f"unknown {unknown}, missing {missing}")
    for name, p in own.items():
        src = state[name]
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{name}: JAX shape {tuple(src.shape)} vs "
                             f"port shape {tuple(p.shape)}")
        p.copy_(src.to(device=p.device, dtype=p.dtype))
