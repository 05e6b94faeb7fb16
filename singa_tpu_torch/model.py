"""`Model`: the root module of a network. Counterpart of
`singa_tpu.model.Model` for eager training and serving.

`set_optimizer`, `compile`, the `loss` and `optim` hooks, `train_one_batch`
and the `__call__` routing follow the JAX `Model`: in train mode, with an
optimizer set or with more than one argument, a call runs
`train_one_batch`; otherwise it is `nn.Module`'s call of `forward`. The port
sizes its parameters at construction, so `compile` only sets the mode. The
JAX `Model` can also compile a whole step into one XLA program
(`use_graph`), shard it over a mesh (`mesh`, `plan`) and accumulate
gradients (`grad_accum`); the port raises for those until its slices arrive
(graph mode as CUDA-graph capture, the parallel slice). Serving runs the
eager forward under `torch.inference_mode()`.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import autograd
from .layer import Layer


class Model(Layer):
    _optimizer = None

    @property
    def device(self) -> torch.device:
        """The device of the model's parameters."""
        return next(self.parameters()).device

    def set_optimizer(self, optimizer) -> None:
        self._optimizer = optimizer

    @property
    def optimizer(self):
        return self._optimizer

    def compile(self, inputs: Sequence[torch.Tensor], is_train: bool = True,
                use_graph: bool = False, sequential: bool = False,
                mesh=None, rules=None, batch_specs=None,
                grad_accum: Optional[int] = None, plan=None) -> None:
        """Set train or eval mode. `inputs` and `sequential` are accepted
        for the JAX signature; parameters already exist. Graph mode, mesh
        mode and gradient accumulation raise `NotImplementedError`."""
        if use_graph:
            raise NotImplementedError(
                "compile(use_graph=True): graph mode (CUDA-graph capture of "
                "the step) arrives with a later slice of the port")
        if any(a is not None for a in (mesh, rules, batch_specs, plan)):
            raise NotImplementedError(
                "compile(mesh=/rules=/batch_specs=/plan=): sharded training "
                "arrives with the port's parallel slice")
        if grad_accum is not None:
            if int(grad_accum) < 1:
                raise ValueError(f"grad_accum must be >= 1, got "
                                 f"{grad_accum}")
            if int(grad_accum) > 1:
                raise NotImplementedError(
                    "compile(grad_accum>1): gradient accumulation arrives "
                    "with a later slice of the port")
        self.train(is_train)

    # -- user-overridable ------------------------------------------------
    def loss(self, out: torch.Tensor, ty) -> torch.Tensor:
        return autograd.softmax_cross_entropy(out, ty)

    def optim(self, loss: torch.Tensor) -> torch.Tensor:
        return self._optimizer.backward_and_update(loss)

    def _require_optimizer(self) -> None:
        if self._optimizer is None:
            raise RuntimeError(
                "train_one_batch requires an optimizer: call "
                "model.set_optimizer(...) before training")

    def train_one_batch(self, x: torch.Tensor, y):
        """forward, loss, then backward and one optimizer step; returns
        (out, loss)."""
        self._require_optimizer()
        out = self.forward(x)
        l = self.loss(out, y)
        self.optim(l)
        return out, l

    def __call__(self, *args, **kwargs):
        if self.training and (self._optimizer is not None or len(args) > 1):
            return self.train_one_batch(*args, **kwargs)
        return super().__call__(*args, **kwargs)
