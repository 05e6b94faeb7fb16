"""Training TransformerLM in the port (`Model.__call__` -> `train_one_batch`
-> softmax cross-entropy -> `torch.autograd` -> SGD with momentum) against
the JAX package's eager training of the same model, with the JAX weights
carried across by `convert.load_singa_params`.

V=97, d=32, h=4, l=2, seq 64, untied and tied embeddings; labels include
-1 (padding) rows. The JAX run is taken with its Pallas tier off and on (the
sequence gate dropped, so the loss and every layer's attention go through
the Pallas kernels in interpret mode, forward and backward). Per step the
loss and every parameter are compared. Tolerance: rtol 1e-4, atol 1e-5 in
float32 over three SGD steps."""
import numpy as np
import pytest
import torch

from singa_tpu import device as jdevice
from singa_tpu import opt as jopt
from singa_tpu import tensor
from singa_tpu.models.transformer import TransformerLM as JaxLM
from singa_tpu.ops import pallas_kernels as pk
from singa_tpu_torch import autograd, convert, layer, model, opt
from singa_tpu_torch import tensor as ptensor
from singa_tpu_torch.models.transformer import TransformerLM

RTOL, ATOL = 1e-4, 1e-5
# bf16 AMP: the two frameworks round matmul operands and outputs to bf16
# at different places, so the loss agrees to ~1.4e-3 relative and each
# parameter's change over the steps, p - p0, to ~4e-2 of that change's L2
# norm (3.2e-2 for the embeddings after three steps). The change is what is
# held, not p itself: an update left out, or one twice too large, is a
# relative error of 1 and fails. The floor covers attention's k bias, whose
# gradient is zero up to rounding (softmax ignores a shift shared by a row).
BF16_LOSS_RTOL, BF16_STEP_RTOL, BF16_STEP_FLOOR = 5e-3, 0.1, 1e-3
CFG = dict(d_model=32, num_heads=4, num_layers=2, max_len=64)
V, STEPS = 97, 3


def _models(tie=False, seed=0):
    jdevice.get_default_device().SetRandSeed(seed)
    jm = JaxLM(V, tie_embeddings=tie, **CFG)
    jm.compile([tensor.from_numpy(np.zeros((1, 8), np.int32))],
               is_train=True, use_graph=False)
    jm.set_optimizer(jopt.SGD(lr=0.1, momentum=0.9))
    pm = TransformerLM(V, tie_embeddings=tie, device="cpu", **CFG)
    convert.load_singa_params(
        pm, {n: p.to_numpy() for n, p in jm.get_params().items()})
    pm.set_optimizer(opt.SGD(lr=0.1, momentum=0.9))
    pm.compile([], is_train=True, use_graph=False)
    return jm, pm


def _batch(seed=1):
    rs = np.random.RandomState(seed)
    x = rs.randint(0, V, (2, 64)).astype(np.int32)
    y = rs.randint(0, V, (2, 64)).astype(np.int32)
    y[0, :5] = -1
    y[1, 40:] = -1
    return x, y


def _train_both(jm, pm, pallas, check):
    x, y = _batch()
    saved = pk._ATTN_MIN_SEQ, pk._flash_fwd
    calls = []

    def counted_fwd(*a):
        calls.append(1)
        return saved[1](*a)

    pk.enable(pallas)
    pk._ATTN_MIN_SEQ, pk._flash_fwd = 0, counted_fwd
    try:
        for step in range(STEPS):
            del calls[:]
            _, jl = jm(tensor.from_numpy(x), tensor.from_numpy(y))
            if pallas:  # the JAX step went through the Pallas kernels
                # one call per layer, and as many more in a step that
                # traces the JAX recorded backward
                assert len(calls) in (CFG["num_layers"],
                                      2 * CFG["num_layers"])
                assert jl.creator._pallas_res is not None
            out, pl = pm(torch.from_numpy(x), torch.from_numpy(y))
            assert out.shape == (2, 64, V)
            check(step, float(jl.to_numpy()), pl.item(),
                  {n: p.to_numpy() for n, p in jm.get_params().items()},
                  pm.get_params())
    finally:
        pk._ATTN_MIN_SEQ, pk._flash_fwd = saved
        pk.enable(False)


@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_three_steps_match_jax(tie, pallas):
    jm, pm = _models(tie)
    losses = []

    def check(step, jl, pl, jparams, pparams):
        losses.append(pl)
        np.testing.assert_allclose(pl, jl, rtol=RTOL, err_msg=f"step {step}")
        assert set(pparams) == set(jparams)
        for n, p in pparams.items():
            np.testing.assert_allclose(p.detach().numpy(), jparams[n],
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{n} after step {step}")

    _train_both(jm, pm, pallas, check)
    assert losses[-1] < losses[0]


def _step_error(p, p0, j, j0):
    """L2 distance of the port's change p - p0 from the JAX change j - j0,
    less the tolerance the bf16 test allows it; > 0 fails."""
    want = j - j0
    return (np.linalg.norm((p - p0) - want)
            - BF16_STEP_RTOL * np.linalg.norm(want) - BF16_STEP_FLOOR)


def _params(pm):
    return {n: p.detach().numpy().copy() for n, p in pm.get_params().items()}


def test_bf16_amp_steps_match_jax():
    """Three bf16-AMP steps: the loss per step and every parameter's change
    per step against the JAX package under the same policy. Controls: the
    check refuses a step left out and a step of twice the size, and the
    port's own float32 run moves the parameters differently, so the AMP
    casts were on the path."""
    jm, pm = _models()
    j0 = {n: p.to_numpy().copy() for n, p in jm.get_params().items()}
    p0 = _params(pm)
    changes = []
    tensor.set_compute_dtype("bfloat16")
    ptensor.set_compute_dtype("bfloat16")

    def check(step, jl, pl, jparams, pparams):
        np.testing.assert_allclose(pl, jl, rtol=BF16_LOSS_RTOL,
                                   err_msg=f"step {step}")
        for n, p in pparams.items():
            assert p.dtype == torch.float32  # the master weights
            p = p.detach().numpy()
            assert _step_error(p, p0[n], jparams[n], j0[n]) <= 0, \
                f"{n} after step {step}"
            # controls: no update, and an update twice the size
            assert _step_error(p0[n], p0[n], jparams[n], j0[n]) > 0 \
                or n.endswith("k_proj.b"), f"{n}: no-update control passed"
            assert _step_error(2 * p - p0[n], p0[n], jparams[n], j0[n]) > 0 \
                or n.endswith("k_proj.b"), f"{n}: 2x-step control passed"
        changes.append({n: p.detach().numpy() - p0[n]
                        for n, p in pparams.items()})

    try:
        _train_both(jm, pm, True, check)
    finally:
        tensor.set_compute_dtype(None)
        ptensor.set_compute_dtype(None)
    _, f32 = _models()
    x, y = (torch.from_numpy(a) for a in _batch())
    for _ in range(STEPS):
        f32(x, y)
    moved = {n: np.linalg.norm(changes[-1][n] - (p - p0[n]))
             / np.linalg.norm(p - p0[n]) for n, p in _params(f32).items()}
    assert min(moved["TransformerLM.embed.W"], moved["TransformerLM.head.W"]) \
        > 5e-3, moved


def test_call_routing():
    """Train mode with an optimizer, or with two arguments, runs
    train_one_batch; anything else is the forward."""
    pm = TransformerLM(V, device="cpu", **CFG)
    x, y = (torch.from_numpy(a) for a in _batch())
    assert pm.optimizer is None
    assert pm(x).shape == (2, 64, V)  # train mode, one argument
    with pytest.raises(RuntimeError, match="set_optimizer"):
        pm(x, y)  # two arguments: train_one_batch, which needs one
    pm.set_optimizer(opt.SGD(lr=0.1))
    w0 = pm.embed.W.detach().clone()
    out, loss = pm(x, y)
    assert loss.dim() == 0 and not torch.equal(pm.embed.W, w0)
    pm.eval()
    assert pm(x).shape == (2, 64, V)
    assert pm.optimizer.step_counter == 1


def test_train_one_batch_without_optimizer_raises():
    pm = TransformerLM(V, device="cpu", **CFG)
    x, y = (torch.from_numpy(a) for a in _batch())
    with pytest.raises(RuntimeError, match="set_optimizer"):
        pm.train_one_batch(x, y)
    with pytest.raises(RuntimeError, match="set_optimizer"):
        model.Model.train_one_batch(pm, x, y)


@pytest.mark.parametrize("kwargs,exc", [
    (dict(use_graph=True), NotImplementedError),
    (dict(mesh=object()), NotImplementedError),
    (dict(plan=object()), NotImplementedError),
    (dict(grad_accum=2), NotImplementedError),
    (dict(grad_accum=0), ValueError),
])
def test_compile_refuses_what_the_port_lacks(kwargs, exc):
    pm = TransformerLM(V, device="cpu", **CFG)
    with pytest.raises(exc):
        pm.compile([], **kwargs)


def test_compile_sets_the_mode():
    pm = TransformerLM(V, device="cpu", **CFG)
    pm.compile([], is_train=False, grad_accum=1)
    assert not pm.training and not pm.blocks.l0.attn.training
    pm.compile([], is_train=True)
    assert pm.training


def test_generic_model_hooks():
    """`Model.train_one_batch` = forward, the `loss` hook, the `optim`
    hook, as in the JAX Model."""

    class Net(model.Model):
        def __init__(self):
            super().__init__()
            self.fc = layer.Linear(4, 3)

        def forward(self, x):
            return self.fc(x)

    net = Net()
    net.set_optimizer(opt.SGD(lr=0.5))
    rs = np.random.RandomState(2)
    x = torch.from_numpy(rs.randn(6, 4).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 3, 6))
    w0 = net.fc.W.detach().clone()
    out, loss = net(x, y)
    want = autograd.softmax_cross_entropy(x @ w0, y)
    torch.testing.assert_close(loss.detach(), want.detach())
    assert not torch.equal(net.fc.W, w0)


class TestDropoutTrainBranch:
    """Train-mode dropout: random bits are not compared across frameworks
    (torch and JAX draw differently), only the distribution and the
    gradient."""

    def test_keep_fraction_and_scale(self):
        x = torch.ones(256, 256)
        y = autograd.dropout(x, 0.3, torch.Generator().manual_seed(0))
        kept = y != 0
        assert abs(kept.float().mean().item() - 0.7) < 0.01
        torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.7))

    def test_seeded_generator_is_deterministic(self):
        x = torch.randn(64, 64)
        a = autograd.dropout(x, 0.5, torch.Generator().manual_seed(5))
        b = autograd.dropout(x, 0.5, torch.Generator().manual_seed(5))
        c = autograd.dropout(x, 0.5, torch.Generator().manual_seed(6))
        assert torch.equal(a, b) and not torch.equal(a, c)

    def test_backward_is_dy_times_mask(self):
        x = torch.randn(32, 32, requires_grad=True)
        y = autograd.dropout(x, 0.25, torch.Generator().manual_seed(1))
        dy = torch.randn(32, 32)
        (dx,) = torch.autograd.grad(y, [x], dy)
        mask = y.detach() / x.detach()
        torch.testing.assert_close(dx, dy * mask)

    def test_generator_on_another_device_raises(self):
        """The mask is drawn where x lives; a generator elsewhere raises
        instead of drawing on the host and copying to the card."""
        x = torch.ones(4, 4, device="meta")
        with pytest.raises(ValueError, match="generator is on cpu"):
            autograd.dropout(x, 0.5, torch.Generator().manual_seed(0))
        assert autograd.dropout(x, 0.0, torch.Generator()) is x

    def test_layer_in_a_model_trains(self):
        lm = TransformerLM(V, dropout=0.1, device="cpu", **CFG)
        lm.set_optimizer(opt.SGD(lr=0.1))
        x, y = (torch.from_numpy(a) for a in _batch())
        _, loss = lm(x, y)
        assert torch.isfinite(loss)
        lm.eval()
        with torch.no_grad():
            torch.testing.assert_close(lm(x), lm(x))  # eval: no mask
