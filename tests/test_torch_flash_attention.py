"""The port's flash-attention forward (`singa_tpu_torch.ops.flash_attention`)
against the JAX package's Pallas kernel.

On the CPU the port's wrapper takes its plain PyTorch version; the JAX side
runs the Pallas kernel in interpret mode, as tests/test_pallas.py does. The
same numpy inputs, made from a seed, go to both. Tolerance for o and lse:
rtol 1e-4, atol 1e-5 (float32; the two differ only in summation order)."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.ops import pallas_kernels as pk
from singa_tpu.parallel.ring_attention import plain_attention as jax_plain
from singa_tpu_torch import autograd
from singa_tpu_torch.ops import _build
from singa_tpu_torch.ops.attention import plain_attention
from singa_tpu_torch.ops.flash_attention import (
    HEAD_DIMS, flash_attention, flash_attention_reference)

RTOL, ATOL = 1e-4, 1e-5
CASES = [((2, 2, 64, 32), True),
         ((1, 3, 100, 16), False),   # S not a multiple of any tile
         ((2, 1, 192, 64), True)]


def _qkv(shape, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape,causal", CASES)
def test_o_and_lse_match_pallas_kernel(shape, causal):
    q, k, v = _qkv(shape)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want_o = np.asarray(pk.flash_attention(jq, jk, jv, causal))
    _, (_, _, _, _, lse) = pk._flash_fwd(jq, jk, jv, causal, None)
    b, h, s, _ = shape
    want_lse = np.asarray(lse).reshape(b, h, -1)[:, :, :s]

    o, got_lse = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 causal)
    assert o.dtype == torch.float32 and o.shape == shape
    assert got_lse.dtype == torch.float32 and got_lse.shape == (b, h, s)
    np.testing.assert_allclose(o.numpy(), want_o, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_attention_matches_jax(causal):
    q, k, v = _qkv((2, 3, 40, 16), seed=1)
    want = np.asarray(jax_plain(*(jnp.asarray(a) for a in (q, k, v)),
                                causal=causal))
    got = plain_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_explicit_scale_matches_pallas_kernel():
    q, k, v = _qkv((1, 2, 64, 32), seed=2)
    want = np.asarray(pk.flash_attention(
        *(jnp.asarray(a) for a in (q, k, v)), True, 0.3))
    o, _ = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                           True, 0.3)
    np.testing.assert_allclose(o.numpy(), want, rtol=RTOL, atol=ATOL)


def test_cpu_call_leaves_launch_counter_unchanged():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 2, 64, 32)))
    before = flash_attention.launches
    flash_attention(q, k, v, True)
    autograd.attention(q, k, v, causal=True)
    assert flash_attention.launches == before


def test_bf16_keeps_dtype_and_float32_lse():
    """bf16 inputs: o in bf16, lse float32. o is the float32 computation on
    the same rounded inputs, rounded once to bf16: within one bf16 ulp
    (under 2^-7 |o|, so rtol 8e-3, atol 1e-3 near 0)."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv((1, 2, 64, 32), seed=3))
    o, lse = flash_attention(q, k, v, True)
    ro, rlse = flash_attention(q.float(), k.float(), v.float(), True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(o.float().numpy(), ro.numpy(), atol=1e-3,
                               rtol=8e-3)
    np.testing.assert_allclose(lse.numpy(), rlse.numpy(), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("d", [8, 48, 256])
def test_unsupported_head_width_raises(d):
    assert d not in HEAD_DIMS
    q, k, v = (torch.zeros(1, 1, 8, d) for _ in range(3))
    with pytest.raises(ValueError, match="head width"):
        flash_attention(q, k, v)
    with pytest.raises(ValueError, match="head width"):
        flash_attention_reference(q, k, v)


def test_unsupported_inputs_raise():
    q = torch.zeros(1, 2, 16, 32)
    with pytest.raises(ValueError, match="self-attention"):
        flash_attention(q, torch.zeros(1, 2, 8, 32), torch.zeros(1, 2, 8, 32))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match=r"\[B, H, S, D\]"):
        flash_attention(q[0], q[0], q[0])
    m = torch.zeros(1, 2, 16, 32, device="meta")
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        flash_attention(m, m, m)


def test_cross_attention_takes_plain_path():
    q = torch.from_numpy(_qkv((1, 2, 8, 16))[0])
    k, v = (torch.from_numpy(a) for a in _qkv((1, 2, 24, 16), seed=4)[:2])
    got = autograd.attention(q, k, v, causal=False)
    want = np.asarray(jax_plain(jnp.asarray(q.numpy()),
                                jnp.asarray(k.numpy()),
                                jnp.asarray(v.numpy()), causal=False))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_c_interface_matches_wrapper_argtypes():
    """The ctypes argtypes set in the wrapper follow the C signature of
    the kernel source: 5 pointers, 5 ints, a float scale, the stream."""
    src = (_build.CSRC / "flash_attn_fwd.cu").read_text()
    sig = re.search(r"int singa_flash_attn_fwd\(([^)]*)\)", src).group(1)
    kinds = [p.split()[-2] if "*" not in p else "ptr"
             for p in (" ".join(x.split()) for x in sig.split(","))]
    assert kinds == ["ptr"] * 5 + ["int"] * 5 + ["float", "ptr"]
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)


def test_library_name_follows_source_hash(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text("// one\n")
    first = _build.library_path("k")
    (tmp_path / "k.cu").write_text("// two\n")
    assert _build.library_path("k") != first
    assert first.parent == _build.BUILD_DIR
    assert Path(first).name.startswith("libk-")


def test_build_dir_outside_a_checkout(tmp_path, monkeypatch):
    """A source checkout builds under its own `build/`; an installed copy
    of the package builds into the user's cache, not beside site-packages."""
    mod = tmp_path / "site-packages" / "singa_tpu_torch" / "ops" / "_build.py"
    mod.parent.mkdir(parents=True)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert _build._build_dir(str(mod)) == tmp_path / "cache" / "singa_tpu_torch"
    (tmp_path / "site-packages" / "pyproject.toml").write_text("")
    assert _build._build_dir(str(mod)) == (
        tmp_path / "site-packages" / "build" / "singa_tpu_torch")
    assert _build.BUILD_DIR == (
        Path(_build.__file__).resolve().parents[2] / "build" / "singa_tpu_torch")


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
