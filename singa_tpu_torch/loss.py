"""Loss classes. Counterpart of `singa_tpu.loss`: `Loss` with
`forward`/`backward`/`evaluate`, `SoftmaxCrossEntropy`, and
`SquaredError` (alias `MeanSquareError`), thin stateful wrappers over the
differentiable functions of `autograd`."""
from __future__ import annotations

import torch

from . import autograd


class Loss:
    """`forward(x, t)` returns the loss and remembers `(x, loss)`;
    `backward()` returns the gradient of that loss with respect to `x`."""

    def forward(self, x: torch.Tensor, t) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, x: torch.Tensor, t) -> torch.Tensor:
        return self.forward(x, t)

    def _remember(self, x: torch.Tensor, fn, t) -> torch.Tensor:
        # A tensor outside any graph is tracked from here on, as the JAX
        # class sets `requires_grad` on its input.
        if not x.requires_grad:
            x = x.detach().requires_grad_(True)
        l = fn(x, t)
        self._last = (x, l)
        return l

    def backward(self) -> torch.Tensor:
        """Gradient of the last forward()'s loss w.r.t. its input. The
        graph is kept, so a caller may still run the model's backward."""
        if getattr(self, "_last", None) is None:
            raise RuntimeError("call forward() before backward()")
        x, l = self._last
        (g,) = torch.autograd.grad(l, [x], retain_graph=True)
        return g

    def evaluate(self, flag, x: torch.Tensor, t) -> float:
        """The loss value as a host float (the train/eval flag is kept for
        the reference signature; losses do not depend on it)."""
        with torch.no_grad():
            return float(self.forward(x, t))


class SoftmaxCrossEntropy(Loss):
    """Fused softmax + cross-entropy over int labels or one-hot /
    probability targets (`autograd.softmax_cross_entropy`)."""

    def forward(self, x: torch.Tensor, t) -> torch.Tensor:
        return self._remember(x, autograd.softmax_cross_entropy, t)


class SquaredError(Loss):
    """Batch mean of 0.5 * ||x - t||^2 (`autograd.mse_loss`, whose
    sum((x - t)^2) / (2 n) carries the 0.5)."""

    def forward(self, x: torch.Tensor, t) -> torch.Tensor:
        return self._remember(x, autograd.mse_loss, t)


MeanSquareError = SquaredError
