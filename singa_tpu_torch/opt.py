"""Optimizers and learning-rate schedules. Counterpart of `singa_tpu.opt`:
the schedulers `Constant`, `ExponentialDecay`, `CosineDecay` and
`WarmupWrapper`; `Optimizer` with its step counter, per-parameter `states`
and global-norm clipping; `SGD`, `RMSProp`, `AdaGrad`, `Adam` and `AdamW`.

Updates run eagerly and IN PLACE, under `torch.no_grad()`, on the parameter
tensors themselves: a step writes into the very tensors the model holds, so
anything else holding them (the serving engine, `convert`) sees the new
values. The JAX package rebinds `param.data` instead; its fused jitted
update, gradient accumulation, step guard and loss scaler, low-precision
slots (`set_slot_dtype`) and `DistOpt` are not ported yet.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from . import autograd

Pair = Tuple[torch.Tensor, torch.Tensor]


class DecayScheduler:
    """Maps the step counter to a learning rate."""

    def __init__(self, init_value: float):
        self.init_value = init_value

    def __call__(self, step: int) -> float:
        raise NotImplementedError


class Constant(DecayScheduler):
    def __call__(self, step: int) -> float:
        return self.init_value


class ExponentialDecay(DecayScheduler):
    """init * rate ** (step / decay_steps), the exponent floored when
    `staircase`."""

    def __init__(self, init_value, decay_steps, decay_rate, staircase=False):
        super().__init__(init_value)
        self.decay_steps = decay_steps
        self.decay_rate = decay_rate
        self.staircase = staircase

    def __call__(self, step: int) -> float:
        p = step / self.decay_steps
        if self.staircase:
            p = math.floor(p)
        return self.init_value * (self.decay_rate ** p)


class CosineDecay(DecayScheduler):
    """Cosine annealing from `init_value` to `final_value` over
    `decay_steps`, flat afterwards."""

    def __init__(self, init_value, decay_steps, final_value=0.0):
        super().__init__(init_value)
        self.decay_steps = decay_steps
        self.final_value = final_value

    def __call__(self, step: int) -> float:
        p = min(max(step / self.decay_steps, 0.0), 1.0)
        cos = 0.5 * (1.0 + math.cos(math.pi * p))
        return self.final_value + (self.init_value - self.final_value) * cos


class WarmupWrapper(DecayScheduler):
    """Linear warmup from 0 to the inner scheduler's initial value over
    `warmup_steps`, then `inner(step - warmup_steps)`."""

    def __init__(self, inner: DecayScheduler, warmup_steps: int):
        super().__init__(inner.init_value)
        self.inner = inner
        self.warmup_steps = warmup_steps

    def __call__(self, step: int) -> float:
        w = self.warmup_steps
        if step < w:
            return self.init_value * (step + 1) / max(1, w)
        return self.inner(max(0, step - w))


def _global_clip_scale(clip_norm: float, grads: Iterable[torch.Tensor]
                       ) -> torch.Tensor:
    """min(1, clip / (||g|| + 1e-12)) over all grads, the norm in float32.
    A device scalar: clipping costs no host synchronisation."""
    sq = sum(torch.sum(torch.square(g.float())) for g in grads)
    return torch.clamp(clip_norm / (torch.sqrt(sq) + 1e-12), max=1.0)


class Optimizer:
    """Step counter, learning-rate schedule and per-parameter state
    (`states[id(param)]` is a dict of slot tensors). Subclasses define
    `apply(param, value, grad) -> new value`."""

    def __init__(self, lr):
        self.lr = lr if isinstance(lr, DecayScheduler) else Constant(lr)
        self.step_counter = 0
        self.states: Dict[int, Dict[str, torch.Tensor]] = {}
        self.clip_norm: Optional[float] = None

    def set_clip_norm(self, value: Optional[float]) -> "Optimizer":
        """Clip gradients to `value` by global L2 norm (None = off), in
        `backward_and_update` and `apply_gradients`. Chainable."""
        self.clip_norm = value
        return self

    @property
    def lr_value(self) -> float:
        return self.lr(self.step_counter)

    def apply(self, param: torch.Tensor, value: torch.Tensor,
              grad: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    @torch.no_grad()
    def update(self, param: torch.Tensor, grad: torch.Tensor) -> None:
        """Apply one update to `param` in place (no clipping: a single
        pair has no global norm). Does not advance the step counter."""
        if grad.dtype != param.dtype:
            grad = grad.to(param.dtype)
        param.copy_(self.apply(param, param, grad))

    def step(self) -> None:
        """Advance the step counter (and so the learning-rate schedule)."""
        self.step_counter += 1

    def __call__(self, loss: torch.Tensor) -> torch.Tensor:
        return self.backward_and_update(loss)

    def backward_and_update(self, loss: torch.Tensor) -> torch.Tensor:
        """Gradients of `loss` for every parameter it reaches
        (`autograd.backward`), then one step."""
        return self.apply_gradients(loss, autograd.backward(loss))

    @torch.no_grad()
    def apply_gradients(self, loss: torch.Tensor,
                        pairs: List[Pair]) -> torch.Tensor:
        """One step over explicit (param, grad) pairs: global-norm clip when
        set, an update per pair, then the step counter advances once."""
        if self.clip_norm is not None and pairs:
            scale = _global_clip_scale(self.clip_norm, [g for _, g in pairs])
            pairs = [(p, (g.float() * scale).to(g.dtype)) for p, g in pairs]
        for p, g in pairs:
            self.update(p, g)
        self.step()
        return loss

    def _slots(self, param: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.states.setdefault(id(param), {})


def _slot(st: Dict[str, torch.Tensor], name: str,
          value: torch.Tensor) -> torch.Tensor:
    """Slot `name` of one parameter's state; zeros like it on first use."""
    s = st.get(name)
    return torch.zeros_like(value) if s is None else s


class SGD(Optimizer):
    """g += wd * p; buf = m * buf + (1 - dampening) * g (buf = g on the
    first step); g = g + m * buf (nesterov) or buf; p -= lr * g."""

    def __init__(self, lr=0.1, momentum=0.0, dampening=0.0, weight_decay=0.0,
                 nesterov=False):
        super().__init__(lr)
        if nesterov and (momentum <= 0 or dampening != 0):
            raise ValueError(
                "nesterov momentum requires momentum>0, dampening=0")
        self.momentum = momentum
        self.dampening = dampening
        self.weight_decay = weight_decay
        self.nesterov = nesterov

    def apply(self, param, value, grad):
        if self.weight_decay:
            grad = grad + self.weight_decay * value
        if self.momentum:
            st = self._slots(param)
            buf = st.get("momentum_buf")
            if buf is None:
                buf = grad.clone()
            else:
                buf = self.momentum * buf + (1.0 - self.dampening) * grad
            st["momentum_buf"] = buf
            grad = grad + self.momentum * buf if self.nesterov else buf
        return value - self.lr_value * grad


class RMSProp(Optimizer):
    def __init__(self, lr=0.1, rho=0.9, epsilon=1e-8, weight_decay=0.0):
        super().__init__(lr)
        self.rho = rho
        self.epsilon = epsilon
        self.weight_decay = weight_decay

    def apply(self, param, value, grad):
        if self.weight_decay:
            grad = grad + self.weight_decay * value
        st = self._slots(param)
        r = _slot(st, "running_avg", value)
        r = self.rho * r + (1.0 - self.rho) * torch.square(grad)
        st["running_avg"] = r
        return value - self.lr_value * grad / torch.sqrt(r + self.epsilon)


class AdaGrad(Optimizer):
    def __init__(self, lr=0.1, epsilon=1e-8, weight_decay=0.0):
        super().__init__(lr)
        self.epsilon = epsilon
        self.weight_decay = weight_decay

    def apply(self, param, value, grad):
        if self.weight_decay:
            grad = grad + self.weight_decay * value
        st = self._slots(param)
        h = _slot(st, "history", value) + torch.square(grad)
        st["history"] = h
        return value - self.lr_value * grad / torch.sqrt(h + self.epsilon)


class Adam(Optimizer):
    """Adam with bias correction at t = step_counter + 1; weight decay is
    folded into the gradient (see `AdamW` for the decoupled form)."""

    def __init__(self, lr=0.001, beta_1=0.9, beta_2=0.999, epsilon=1e-8,
                 weight_decay=0.0):
        super().__init__(lr)
        self.beta_1 = beta_1
        self.beta_2 = beta_2
        self.epsilon = epsilon
        self.weight_decay = weight_decay

    def _adam(self, param, value, grad):
        st = self._slots(param)
        m, v = _slot(st, "m", value), _slot(st, "v", value)
        m = self.beta_1 * m + (1.0 - self.beta_1) * grad
        v = self.beta_2 * v + (1.0 - self.beta_2) * torch.square(grad)
        st["m"], st["v"] = m, v
        # The bias corrections in the parameter's dtype, as the JAX update
        # computes them: 1 - beta_2**t in float32 keeps ~4 digits at t=1.
        t = self.step_counter + 1
        b1, b2 = (torch.tensor(b, dtype=value.dtype)
                  for b in (self.beta_1, self.beta_2))
        mhat = m / (1.0 - b1 ** t)
        vhat = v / (1.0 - b2 ** t)
        return value - self.lr_value * mhat / (torch.sqrt(vhat)
                                               + self.epsilon)

    def apply(self, param, value, grad):
        if self.weight_decay:
            grad = grad + self.weight_decay * value
        return self._adam(param, value, grad)


class AdamW(Adam):
    """Adam with decoupled weight decay: p -= lr * wd * p beside the Adam
    step, the decay kept out of the moments."""

    def apply(self, param, value, grad):
        new = self._adam(param, value, grad)
        if self.weight_decay:
            new = new - self.lr_value * self.weight_decay * value
        return new
