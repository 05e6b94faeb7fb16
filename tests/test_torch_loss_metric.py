"""The port's loss classes (`singa_tpu_torch.loss`), `autograd.mse_loss`
and metrics (`singa_tpu_torch.metric`) against `singa_tpu.loss`,
`singa_tpu.autograd.mse_loss` and `singa_tpu.metric` on the same numpy
inputs. Tolerance: rtol 1e-5, atol 1e-6 in float32; metrics are exact."""
import numpy as np
import pytest
import torch

from singa_tpu import autograd as jautograd
from singa_tpu import loss as jloss
from singa_tpu import metric as jmetric
from singa_tpu import tensor
from singa_tpu_torch import autograd, loss, metric

RTOL, ATOL = 1e-5, 1e-6


def _inputs(kind, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(8, 6).astype(np.float32)
    if kind == "labels":
        t = rs.randint(0, 6, 8).astype(np.int32)
        t[2] = -1
    elif kind == "probs":
        t = rs.rand(8, 6).astype(np.float32)
        t /= t.sum(1, keepdims=True)
    else:  # regression targets
        t = rs.randn(8, 6).astype(np.float32)
    return x, t


@pytest.mark.parametrize("cls,kind", [
    ("SoftmaxCrossEntropy", "labels"), ("SoftmaxCrossEntropy", "probs"),
    ("SquaredError", "targets"), ("MeanSquareError", "targets")])
def test_loss_forward_backward_evaluate_match_jax(cls, kind):
    x, t = _inputs(kind)
    jl = getattr(jloss, cls)()
    want = float(jl.forward(tensor.from_numpy(x),
                            tensor.from_numpy(t)).to_numpy())
    want_dx = jl.backward().to_numpy()
    pl = getattr(loss, cls)()
    got = pl(torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(got.item(), want, rtol=RTOL)
    np.testing.assert_allclose(pl.backward().numpy(), want_dx, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(
        pl.evaluate(True, torch.from_numpy(x), torch.from_numpy(t)),
        jl.evaluate(True, tensor.from_numpy(x), tensor.from_numpy(t)),
        rtol=RTOL)


def test_loss_backward_keeps_the_model_graph():
    """backward() gives d loss / d x for a model output x, and the model's
    own backward can still run afterwards."""
    w = torch.randn(6, 6, requires_grad=True)
    x, t = _inputs("labels", 1)
    out = torch.from_numpy(x) @ w
    l = loss.SoftmaxCrossEntropy()
    value = l(out, torch.from_numpy(t))
    dout = l.backward()
    assert dout.shape == out.shape
    (dw,) = torch.autograd.grad(value, [w])
    torch.testing.assert_close(dw, torch.from_numpy(x).T @ dout)


def test_loss_backward_before_forward_raises():
    with pytest.raises(RuntimeError, match="forward"):
        loss.SquaredError().backward()


def test_mse_loss_matches_jax():
    x, t = _inputs("targets", 2)
    xt = tensor.from_numpy(x)
    xt.requires_grad = True
    xt.stores_grad = True
    jl = jautograd.mse_loss(xt, tensor.from_numpy(t))
    want_dx = {id(p): g for p, g in jautograd.backward(jl)}[id(xt)]
    px = torch.from_numpy(x).requires_grad_(True)
    pl = autograd.mse_loss(px, torch.from_numpy(t))
    (dx,) = torch.autograd.grad(pl, [px])
    np.testing.assert_allclose(pl.item(), float(jl.to_numpy()), rtol=RTOL)
    np.testing.assert_allclose(dx.numpy(), want_dx.to_numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("top_k", [1, 3])
@pytest.mark.parametrize("one_hot", [False, True], ids=["ids", "onehot"])
def test_accuracy_matches_jax(top_k, one_hot):
    rs = np.random.RandomState(3)
    x = rs.randn(32, 10).astype(np.float32)
    y = rs.randint(0, 10, 32).astype(np.int32)
    if one_hot:
        y = np.eye(10, dtype=np.float32)[y]
    jm, pm = jmetric.Accuracy(top_k), metric.Accuracy(top_k)
    want = np.asarray(jm.forward(tensor.from_numpy(x), tensor.from_numpy(y)))
    got = pm.forward(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_array_equal(got.numpy(), want)
    assert pm(x, y) == pytest.approx(jm(tensor.from_numpy(x),
                                        tensor.from_numpy(y)), abs=1e-7)
    assert 0 < pm(x, y) < 1


@pytest.mark.parametrize("cls", ["Precision", "Recall"])
def test_precision_recall_match_jax(cls):
    rs = np.random.RandomState(4)
    x = rs.rand(50).astype(np.float32)
    y = (rs.rand(50) > 0.6).astype(np.float32)
    jm, pm = getattr(jmetric, cls)(0.4), getattr(metric, cls)(0.4)
    want = jm.evaluate(tensor.from_numpy(x), tensor.from_numpy(y))
    assert pm.evaluate(torch.from_numpy(x), torch.from_numpy(y)) == want
    assert pm(x, y) == want  # numpy inputs too
    assert getattr(metric, cls)().evaluate(np.zeros(4), np.zeros(4)) == 0.0
