"""The port's layers (`singa_tpu_torch.layer`) against the JAX layers.

Each JAX layer is built lazily on a seeded numpy input; its parameters are
then set to seeded random values (so norms are not at their trivial 1/0
init) and carried into the port with `convert.load_singa_params`. The same
input goes through both. Tolerance: rtol 1e-5, atol 1e-5 (float32 sums in
another order)."""
import numpy as np
import pytest
import torch

from singa_tpu import layer as jlayer
from singa_tpu import tensor
from singa_tpu_torch import convert, layer

RTOL, ATOL = 1e-5, 1e-5


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _carry(jl, pl, seed=1):
    """Seeded random values into the JAX layer's params, then the same
    arrays into the port's layer; returns the arrays."""
    rs = np.random.RandomState(seed)
    arrays = {n: rs.randn(*p.shape).astype(np.float32) * 0.5
              for n, p in jl.get_params().items()}
    jl.set_params(arrays)
    convert.load_singa_params(pl, arrays)
    return arrays


# (name, JAX layer factory, port layer factory, input shape)
CASES = [
    ("linear", lambda: jlayer.Linear(6), lambda: layer.Linear(5, 6),
     (4, 5)),
    ("linear_3d_no_bias", lambda: jlayer.Linear(7, bias=False),
     lambda: layer.Linear(5, 7, bias=False), (2, 3, 5)),
    ("layer_norm", lambda: jlayer.LayerNorm(),
     lambda: layer.LayerNorm(8), (2, 3, 8)),
    ("rms_norm", lambda: jlayer.RMSNorm(), lambda: layer.RMSNorm(8),
     (2, 3, 8)),
    ("gelu", lambda: jlayer.Gelu(), lambda: layer.Gelu(), (3, 9)),
    ("mha_causal", lambda: jlayer.MultiHeadAttention(4, causal=True),
     lambda: layer.MultiHeadAttention(16, 4, causal=True), (2, 12, 16)),
    ("mha_bidirectional", lambda: jlayer.MultiHeadAttention(2, causal=False),
     lambda: layer.MultiHeadAttention(16, 2, causal=False), (2, 9, 16)),
]


@pytest.mark.parametrize("name,mk_jax,mk_port,shape", CASES,
                         ids=[c[0] for c in CASES])
def test_layer_matches_jax(name, mk_jax, mk_port, shape):
    x = _x(shape)
    jl = mk_jax()
    jl(tensor.from_numpy(x))  # lazy init
    pl = mk_port().eval()
    arrays = _carry(jl, pl)
    assert set(arrays) == set(pl.get_params())
    want = jl(tensor.from_numpy(x)).to_numpy()
    with torch.inference_mode():
        got = pl(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_embedding_matches_jax():
    ids = np.random.RandomState(0).randint(0, 11, (3, 5)).astype(np.int32)
    jl = jlayer.Embedding(11, 6)
    jl(tensor.from_numpy(ids))
    pl = layer.Embedding(11, 6)
    _carry(jl, pl)
    want = jl(tensor.from_numpy(ids)).to_numpy()
    got = pl(torch.from_numpy(ids)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=0)


def test_param_names_follow_jax_hierarchy():
    x = _x((1, 4, 8))
    jl = jlayer.MultiHeadAttention(2)
    jl(tensor.from_numpy(x))
    pl = layer.MultiHeadAttention(8, 2)
    assert set(jl.get_params()) == set(pl.get_params())
    assert "MultiHeadAttention.q_proj.W" in pl.get_params()
    shapes = {n: tuple(p.shape) for n, p in jl.get_params().items()}
    assert shapes == {n: tuple(p.shape)
                      for n, p in pl.get_params().items()}


def test_sequential_names_children_like_jax():
    s = layer.Sequential(layer.Linear(3, 4), layer.Gelu(),
                         layer.Linear(4, 2))
    assert set(s.get_params()) == {"Sequential.l0.W", "Sequential.l0.b",
                                   "Sequential.l2.W", "Sequential.l2.b"}
    assert s(torch.zeros(5, 3)).shape == (5, 2)


def test_dropout_identity_in_eval_and_loud_in_train():
    """Eval mode is the identity; train mode masks: every output is 0 or
    x / keep (the train branch's statistics are in test_torch_train.py)."""
    d = layer.Dropout(0.3, generator=torch.Generator().manual_seed(0))
    x = torch.randn(64, 64)
    assert d.eval()(x) is x
    y = d.train()(x)
    kept = y != 0
    assert 0 < int(kept.sum()) < x.numel()
    torch.testing.assert_close(y[kept], x[kept] / 0.7, rtol=1e-6, atol=0)
    assert layer.Dropout(0.0).train()(x) is x


def test_initializers_are_seeded_and_shaped():
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    a = layer.Linear(16, 8, generator=g1)
    b = layer.Linear(16, 8, generator=g2)
    assert torch.equal(a.W, b.W)
    limit = (6.0 / 16) ** 0.5
    assert float(a.W.detach().abs().max()) <= limit
    assert torch.all(a.b == 0)
    e = layer.Embedding(500, 40, generator=torch.Generator().manual_seed(0))
    assert abs(float(e.W.detach().std()) - 0.05) < 5e-3


def test_convert_rejects_unknown_missing_and_misshaped():
    pl = layer.Linear(3, 2)
    good = {"Linear.W": np.zeros((3, 2), np.float32),
            "Linear.b": np.zeros((2,), np.float32)}
    with pytest.raises(KeyError, match="missing"):
        convert.load_singa_params(pl, {"Linear.W": good["Linear.W"]})
    with pytest.raises(KeyError, match="unknown"):
        convert.load_singa_params(pl, {**good, "Linear.extra": good["Linear.b"]})
    with pytest.raises(ValueError, match="shape"):
        convert.load_singa_params(pl, {**good,
                                       "Linear.W": np.zeros((2, 3),
                                                            np.float32)})
    convert.load_singa_params(pl, good)
    assert float(pl.W.detach().abs().sum()) == 0.0
