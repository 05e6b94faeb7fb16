"""The port's fused softmax cross-entropy (`ops.softmax_xent`, and
`autograd.softmax_cross_entropy` over it) against the JAX package's Pallas
kernels `pk.softmax_xent` / `pk._softmax_xent_bwd` (interpret mode on the
CPU) and its `autograd.softmax_cross_entropy` op.

On the CPU the wrappers take their plain PyTorch versions, so these tests
hold the plain versions (the CUDA kernels' specification) and the
Function's wiring; `chip_smoke.py` holds the kernels against the plain
versions on the card. Tolerance: rtol 1e-5, atol 1e-6 in float32 (one
logsumexp of at most 2048 terms)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from singa_tpu import autograd as jautograd
from singa_tpu import tensor
from singa_tpu.ops import pallas_kernels as pk
from singa_tpu_torch import autograd
from singa_tpu_torch.ops.softmax_xent import (
    softmax_xent, softmax_xent_bwd, softmax_xent_bwd_reference,
    softmax_xent_reference)

RTOL, ATOL = 1e-5, 1e-6


def _case(b, c, seed, labels=None):
    rs = np.random.RandomState(seed)
    x = (rs.randn(b, c) * 3).astype(np.float32)
    if labels is None:
        labels = rs.randint(0, c, b)
        labels[::5] = -1  # padding rows
        labels[1::7] = c  # out of range: also zero loss and grad
    g = rs.randn(b).astype(np.float32)
    return x, np.asarray(labels, np.int32), g


CASES = [
    pytest.param((33, 17, 0, None), id="33x17"),
    # multi-tile on the JAX side: _row_tile(300, 2048) is 256 rows
    pytest.param((300, 2048, 1, None), id="300x2048"),
    pytest.param((7, 4, 2, [0, -1, 2, 3, -1, 1, 4]), id="padding-labels"),
]


@pytest.mark.parametrize("case", CASES)
def test_forward_and_backward_match_the_pallas_kernels(case):
    x, labels, g = _case(*case)
    want = np.asarray(pk.softmax_xent(jnp.asarray(x), jnp.asarray(labels)))
    want_dx, _ = pk._softmax_xent_bwd((jnp.asarray(x), jnp.asarray(labels)),
                                      jnp.asarray(g))
    tx, tl, tg = (torch.from_numpy(a) for a in (x, labels, g))
    got = softmax_xent(tx, tl)
    dx = softmax_xent_bwd(tx, tl, tg)
    assert got.dtype == torch.float32 and dx.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), rtol=RTOL,
                               atol=ATOL)
    invalid = (labels < 0) | (labels >= x.shape[1])
    assert invalid.any()
    assert (got.numpy()[invalid] == 0).all()
    assert (dx.numpy()[invalid] == 0).all()


def test_int64_labels_and_the_references_agree():
    x, labels, g = _case(33, 17, 3)
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    l32, l64 = torch.from_numpy(labels), torch.from_numpy(labels).long()
    torch.testing.assert_close(softmax_xent(tx, l64),
                               softmax_xent_reference(tx, l32))
    torch.testing.assert_close(softmax_xent_bwd(tx, l64, tg),
                               softmax_xent_bwd_reference(tx, l32, tg))


def _jax_loss_and_grad(x, t):
    xt = tensor.from_numpy(x)
    xt.requires_grad = True
    xt.stores_grad = True
    loss = jautograd.softmax_cross_entropy(xt, tensor.from_numpy(t))
    grads = {id(p): g for p, g in jautograd.backward(loss)}
    return float(loss.to_numpy()), grads[id(xt)].to_numpy()


@pytest.mark.parametrize("pallas", [False, True], ids=["jnp", "pallas"])
def test_autograd_op_matches_jax_op(pallas):
    """Loss and input gradient of the mean cross-entropy, with invalid rows
    counted in the mean's n, against the JAX op on either of its paths."""
    x, labels, _ = _case(33, 17, 4)
    pk.enable(pallas)
    try:
        want_loss, want_dx = _jax_loss_and_grad(x, labels)
    finally:
        pk.enable(False)
    tx = torch.from_numpy(x).requires_grad_(True)
    loss = autograd.softmax_cross_entropy(tx, torch.from_numpy(labels))
    (dx,) = torch.autograd.grad(loss, [tx])
    valid = (labels >= 0) & (labels < 17)
    rows = softmax_xent_reference(tx.detach(), torch.from_numpy(labels))
    assert loss.item() == pytest.approx(rows.sum().item() / 33, rel=1e-6)
    assert valid.sum() < 33  # n counts the invalid rows too
    np.testing.assert_allclose(loss.item(), want_loss, rtol=RTOL)
    np.testing.assert_allclose(dx.numpy(), want_dx, rtol=RTOL, atol=ATOL)


def test_one_hot_and_probability_targets_match_jax():
    rs = np.random.RandomState(5)
    x = rs.randn(6, 5).astype(np.float32)
    t = rs.rand(6, 5).astype(np.float32)
    t /= t.sum(1, keepdims=True)
    t[0] = np.eye(5, dtype=np.float32)[2]
    want_loss, want_dx = _jax_loss_and_grad(x, t)
    tx = torch.from_numpy(x).requires_grad_(True)
    loss = autograd.softmax_cross_entropy(tx, torch.from_numpy(t))
    (dx,) = torch.autograd.grad(loss, [tx])
    np.testing.assert_allclose(loss.item(), want_loss, rtol=RTOL)
    np.testing.assert_allclose(dx.numpy(), want_dx, rtol=RTOL, atol=ATOL)


def test_three_d_logits_and_trailing_one_labels():
    """[B, S, C] logits with [B, S] labels: rows flattened, n = B."""
    rs = np.random.RandomState(6)
    x = rs.randn(2, 3, 7).astype(np.float32)
    labels = rs.randint(0, 7, (2, 3))
    got = autograd.softmax_cross_entropy(torch.from_numpy(x),
                                         torch.from_numpy(labels))
    rows = softmax_xent_reference(torch.from_numpy(x.reshape(6, 7)),
                                  torch.from_numpy(labels.reshape(6)))
    torch.testing.assert_close(got, rows.sum() / 2)
    flat = autograd.softmax_cross_entropy(
        torch.from_numpy(x[0]), torch.from_numpy(labels[0][:, None]))
    torch.testing.assert_close(flat, rows[:3].sum() / 3)


def test_bf16_logits_give_bf16_grad():
    x, labels, _ = _case(33, 17, 7)
    xb = torch.from_numpy(x).bfloat16().requires_grad_(True)
    loss = autograd.softmax_cross_entropy(xb, torch.from_numpy(labels))
    assert loss.dtype == torch.float32
    (dx,) = torch.autograd.grad(loss, [xb])
    assert dx.dtype == torch.bfloat16
    # the f32 math on the exactly upcast logits, rounded once to bf16
    want = softmax_xent_bwd_reference(
        xb.detach().float(), torch.from_numpy(labels),
        torch.full((33,), 1 / 33)).bfloat16()
    torch.testing.assert_close(dx, want, rtol=0, atol=0)


def test_cpu_path_leaves_launch_counters_alone():
    x, labels, g = _case(33, 17, 8)
    before = (softmax_xent.launches, softmax_xent_bwd.launches)
    tx = torch.from_numpy(x).requires_grad_(True)
    loss = autograd.softmax_cross_entropy(tx, torch.from_numpy(labels))
    torch.autograd.grad(loss, [tx])
    assert (softmax_xent.launches, softmax_xent_bwd.launches) == before


def test_unsupported_inputs_raise():
    x = torch.zeros(4, 5)
    lab = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match=r"\(B, C\)"):
        softmax_xent(x[0], lab[0])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        softmax_xent(x.double(), lab)
    with pytest.raises(TypeError, match="integer labels"):
        softmax_xent(x, lab.float())
    with pytest.raises(ValueError, match="labels must be"):
        softmax_xent(x, lab[:3])
    with pytest.raises(ValueError, match="g must be"):
        softmax_xent_bwd(x, lab, torch.zeros(3))
    m = torch.zeros(4, 5, device="meta")
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        softmax_xent(m, torch.zeros(4, dtype=torch.int64, device="meta"))
