"""`Model`: the root module of a network. Counterpart of
`singa_tpu.model.Model` for the forward path.

The JAX `Model` compiles its eval forward into one XLA program
(`_JitForward`, model.py:809). The port has no compile step: its
counterpart is the eager forward under `torch.inference_mode()`, which the
serving engine sets on its dispatcher thread. `train()`/`eval()` are
`nn.Module`'s; training (`train_one_batch`, optimizers) arrives with the
training slice.
"""
from __future__ import annotations

import torch

from .layer import Layer


class Model(Layer):
    @property
    def device(self) -> torch.device:
        """The device of the model's parameters."""
        return next(self.parameters()).device
