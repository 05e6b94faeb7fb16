"""The port's optimizers and schedules (`singa_tpu_torch.opt`) against
`singa_tpu.opt`: the same parameters and the same numpy gradients for a few
steps through each optimizer, with and without global-norm clipping.
Tolerance: rtol 1e-6, atol 1e-7 (float32 update math; schedules computed
in float64 on the port's side and in float32 inside the JAX update)."""
import numpy as np
import pytest
import torch

from singa_tpu import opt as jopt
from singa_tpu import tensor
from singa_tpu_torch import opt

RTOL, ATOL = 1e-6, 1e-7
STEPS = 4
SHAPES = [(3, 4), (5,)]

OPTIMIZERS = {
    "sgd": lambda m: m.SGD(lr=0.1),
    "sgd_momentum": lambda m: m.SGD(lr=0.1, momentum=0.9),
    "sgd_dampening": lambda m: m.SGD(lr=0.05, momentum=0.8, dampening=0.3),
    "sgd_weight_decay": lambda m: m.SGD(lr=0.1, momentum=0.9,
                                        weight_decay=0.01),
    "sgd_nesterov": lambda m: m.SGD(lr=0.1, momentum=0.9, nesterov=True),
    "adam": lambda m: m.Adam(lr=0.01),
    "adam_weight_decay": lambda m: m.Adam(lr=0.01, weight_decay=0.1),
    "adamw": lambda m: m.AdamW(lr=0.01, weight_decay=0.1),
    "rmsprop": lambda m: m.RMSProp(lr=0.01, weight_decay=0.01),
    "adagrad": lambda m: m.AdaGrad(lr=0.1, weight_decay=0.01),
    "sgd_cosine": lambda m: m.SGD(lr=m.CosineDecay(0.1, 3, 0.01),
                                  momentum=0.9),
    "adam_warmup_staircase": lambda m: m.Adam(lr=m.WarmupWrapper(
        m.ExponentialDecay(0.01, 2, 0.5, staircase=True), 2)),
}


def _data(seed=0):
    rs = np.random.RandomState(seed)
    params = [rs.randn(*s).astype(np.float32) for s in SHAPES]
    grads = [[rs.randn(*s).astype(np.float32) for s in SHAPES]
             for _ in range(STEPS)]
    return params, grads


def _jparam(a):
    t = tensor.from_numpy(a.copy())
    t.requires_grad = True
    t.stores_grad = True
    return t


@pytest.mark.parametrize("clip", [None, 0.5], ids=["noclip", "clip"])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_steps_match_jax(name, clip):
    params, grads = _data()
    jo, po = OPTIMIZERS[name](jopt), OPTIMIZERS[name](opt)
    jo.set_clip_norm(clip)
    assert po.set_clip_norm(clip) is po
    jp = [_jparam(a) for a in params]
    pp = [torch.from_numpy(a.copy()).requires_grad_(True) for a in params]
    loss = torch.zeros(())
    for step in range(STEPS):
        jo.apply_gradients(tensor.from_numpy(np.zeros((), np.float32)),
                           [(p, tensor.from_numpy(g))
                            for p, g in zip(jp, grads[step])])
        assert po.apply_gradients(
            loss, [(p, torch.from_numpy(g))
                   for p, g in zip(pp, grads[step])]) is loss
        assert po.step_counter == jo.step_counter == step + 1
        for a, b in zip(pp, jp):
            np.testing.assert_allclose(a.detach().numpy(), b.to_numpy(),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {step}")
    for a, b in zip(pp, jp):
        assert set(po.states.get(id(a), {})) == set(jo.states.get(id(b), {}))
        assert a.requires_grad  # updated in place, still the model's leaf


def test_single_update_matches_jax_and_runs_in_place():
    params, grads = _data(1)
    jo, po = jopt.SGD(lr=0.1, momentum=0.9), opt.SGD(lr=0.1, momentum=0.9)
    jp = _jparam(params[0])
    pp = torch.from_numpy(params[0].copy())
    ptr = pp.data_ptr()
    for step in range(STEPS):
        jo.update(jp, tensor.from_numpy(grads[step][0]))
        po.update(pp, torch.from_numpy(grads[step][0]))
        np.testing.assert_allclose(pp.numpy(), jp.to_numpy(), rtol=RTOL,
                                   atol=ATOL)
    assert pp.data_ptr() == ptr
    assert po.step_counter == 0  # update() does not advance the schedule


def test_momentum_first_step_takes_the_gradient():
    p = torch.tensor([1.0])
    sgd = opt.SGD(lr=0.1, momentum=0.9)
    sgd.update(p, torch.tensor([1.0]))  # buf = g = 1
    torch.testing.assert_close(p, torch.tensor([0.9]))
    sgd.update(p, torch.tensor([1.0]))  # buf = 0.9 + 1
    torch.testing.assert_close(p, torch.tensor([0.71]))


SCHEDULES = {
    "constant": lambda m: m.Constant(0.3),
    "exponential": lambda m: m.ExponentialDecay(0.1, 4, 0.5),
    "staircase": lambda m: m.ExponentialDecay(0.1, 4, 0.5, staircase=True),
    "cosine": lambda m: m.CosineDecay(0.1, 8, final_value=0.01),
    "warmup_cosine": lambda m: m.WarmupWrapper(m.CosineDecay(0.1, 6), 3),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_jax(name):
    js, ps = SCHEDULES[name](jopt), SCHEDULES[name](opt)
    for step in range(14):
        np.testing.assert_allclose(ps(step), float(js(step)), rtol=RTOL,
                                   err_msg=f"step {step}")


def test_lr_value_follows_the_step_counter():
    o = opt.SGD(lr=opt.ExponentialDecay(0.1, 1, 0.5))
    assert o.lr_value == pytest.approx(0.1)
    o.step()
    o.step()
    assert o.lr_value == pytest.approx(0.025)


def test_backward_and_update_steps_every_reached_parameter():
    w = torch.tensor([[1.0, -2.0]], requires_grad=True)
    b = torch.tensor([0.5], requires_grad=True)
    unused = torch.tensor([3.0], requires_grad=True)
    x = torch.tensor([[2.0], [1.0]])
    loss = torch.sum(x @ w) + 2 * b.sum()
    o = opt.SGD(lr=0.1)
    o(loss)
    torch.testing.assert_close(w.detach(), torch.tensor([[0.7, -2.3]]))
    torch.testing.assert_close(b.detach(), torch.tensor([0.3]))
    torch.testing.assert_close(unused.detach(), torch.tensor([3.0]))
    assert o.step_counter == 1


def test_nesterov_needs_momentum():
    with pytest.raises(ValueError, match="nesterov"):
        opt.SGD(lr=0.1, nesterov=True)
