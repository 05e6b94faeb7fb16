"""The port's TransformerLM (`singa_tpu_torch.models.transformer`) against
the JAX TransformerLM, with the JAX model's weights carried across by
`convert.load_singa_params`.

V=97, d=32, h=4, l=2, max_len=64; untied and tied embeddings, `layer` and
`rms` norms. The JAX logits are taken twice: with the Pallas tier off (XLA
attention) and with it on and the sequence gate dropped, so that every
layer's attention runs the Pallas flash kernel in interpret mode.
Tolerance: rtol 1e-4, atol 1e-4 (float32 through two blocks)."""
import numpy as np
import pytest
import torch

from singa_tpu import device as jdevice
from singa_tpu import tensor
from singa_tpu.models.transformer import TransformerLM as JaxLM
from singa_tpu.ops import pallas_kernels as pk
from singa_tpu_torch import convert
from singa_tpu_torch.models.transformer import TransformerLM, create_model

RTOL, ATOL = 1e-4, 1e-4
CFG = dict(d_model=32, num_heads=4, num_layers=2, max_len=64)
V = 97


def _jax_model(tie, norm, seed=0):
    jdevice.get_default_device().SetRandSeed(seed)
    m = JaxLM(V, tie_embeddings=tie, norm=norm, **CFG)
    m.compile([tensor.from_numpy(np.zeros((1, 8), np.int32))],
              is_train=False, use_graph=False)
    m.eval()
    return m


def _jax_logits(m, ids, pallas):
    if not pallas:
        return m.forward(tensor.from_numpy(ids)).to_numpy()
    pk.enable(True)
    saved_min, saved_fwd = pk._ATTN_MIN_SEQ, pk._flash_fwd
    pk._ATTN_MIN_SEQ = 0
    calls = []

    def counted_fwd(*a):
        calls.append(1)
        return saved_fwd(*a)

    pk._flash_fwd = counted_fwd
    try:
        out = m.forward(tensor.from_numpy(ids)).to_numpy()
    finally:
        pk._ATTN_MIN_SEQ, pk._flash_fwd = saved_min, saved_fwd
        pk.enable(False)
    assert len(calls) == CFG["num_layers"], "JAX forward missed the kernel"
    return out


@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("norm", ["layer", "rms"])
@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_logits_match_jax(tie, norm, pallas):
    jm = _jax_model(tie, norm)
    pm = TransformerLM(V, tie_embeddings=tie, norm=norm, device="cpu",
                       **CFG).eval()
    convert.load_singa_params(
        pm, {n: p.to_numpy() for n, p in jm.get_params().items()})
    ids = np.random.RandomState(1).randint(0, V, (2, 64)).astype(np.int32)
    want = _jax_logits(jm, ids, pallas)
    with torch.inference_mode():
        got = pm(torch.from_numpy(ids))
    assert got.shape == (2, 64, V) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_shorter_sequence_and_single_row_match_jax():
    jm = _jax_model(False, "layer", seed=2)
    pm = TransformerLM(V, device="cpu", **CFG).eval()
    convert.load_singa_params(
        pm, {n: p.to_numpy() for n, p in jm.get_params().items()})
    ids = np.random.RandomState(3).randint(0, V, (1, 13)).astype(np.int32)
    with torch.inference_mode():
        got = pm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, _jax_logits(jm, ids, False), rtol=RTOL,
                               atol=ATOL)


def test_param_inventory_matches_jax():
    for tie in (False, True):
        jm = _jax_model(tie, "layer")
        pm = create_model(V, tie_embeddings=tie, device="cpu", **CFG)
        want = {n: p.shape for n, p in jm.get_params().items()}
        got = {n: tuple(p.shape) for n, p in pm.get_params().items()}
        assert got == want
        assert ("TransformerLM.head.W" in got) is (not tie)


def test_seeded_construction_is_deterministic():
    a = TransformerLM(V, device="cpu", seed=5, **CFG)
    b = TransformerLM(V, device="cpu", seed=5, **CFG)
    c = TransformerLM(V, device="cpu", seed=6, **CFG)
    for (n, pa), pb, pc in zip(a.get_params().items(), b.parameters(),
                               c.parameters()):
        assert torch.equal(pa, pb), n
    assert not torch.equal(a.embed.W, c.embed.W)


def test_forward_rejects_sequences_above_max_len():
    pm = TransformerLM(V, device="cpu", **CFG).eval()
    with pytest.raises(ValueError, match="max_len"):
        pm(torch.zeros((1, 65), dtype=torch.int64))


def test_unknown_norm_raises():
    with pytest.raises(ValueError, match="norm must be one of"):
        TransformerLM(V, norm="batch", device="cpu", **CFG)
