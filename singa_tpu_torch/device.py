"""Devices and seeding for the port. Counterpart of `singa_tpu.device`
(`Device.SetRandSeed`, `next_key`, `get_default_device`).

Every entry point of the port runs on CUDA unless the caller asks for the
CPU (`device="cpu"`, as the tests do). `get_device()` raises when no CUDA
device exists and the CPU was not asked for: the port never carries on on
the CPU without being told to.

Random streams are explicit `torch.Generator`s. Parameters are drawn on a
CPU generator and then moved, so one seed gives the same weights on either
device.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def get_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: `device` when given, else
    `cuda`. Raises `RuntimeError` for a CUDA device when CUDA is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "singa_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run on the CPU explicitly")
    return dev


def generator(seed: int, device: DeviceLike = "cpu") -> torch.Generator:
    """A seeded random stream (counterpart of `Device.SetRandSeed`): the
    port threads generators explicitly where the JAX package split keys."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed))
    return g
