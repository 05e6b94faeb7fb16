"""Parameter initializers. Counterpart of `singa_tpu.initializer`: each
fills an existing tensor in place from an explicit `torch.Generator`.

torch and JAX draw different numbers from one seed, so the tests carry the
JAX package's weights across with `convert.load_singa_params` instead of
matching draws."""
from __future__ import annotations

import math
from typing import Optional

import torch


@torch.no_grad()
def gaussian(t: torch.Tensor, mean: float = 0.0, std: float = 0.01,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    return t.normal_(mean, std, generator=generator)


@torch.no_grad()
def uniform(t: torch.Tensor, low: float = 0.0, high: float = 1.0,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    return t.uniform_(low, high, generator=generator)


@torch.no_grad()
def constant(t: torch.Tensor, value: float = 0.0) -> torch.Tensor:
    return t.fill_(value)


def he_uniform(t: torch.Tensor, mode: str = "fan_in",
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """U(-limit, limit), limit = sqrt(6 / fan), for an (in, out) weight."""
    fan_in, fan_out = t.shape
    fan = fan_in if mode == "fan_in" else fan_out
    limit = math.sqrt(6.0 / max(fan, 1))
    return uniform(t, -limit, limit, generator=generator)
