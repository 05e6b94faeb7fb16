"""The port's flash-attention backward (`ops.flash_attention`
`flash_attention_bwd`, and `autograd.FlashAttention` over the forward and
backward) against the JAX package's Pallas `_flash_bwd` (dq and dk/dv
kernels, interpret mode on the CPU) and `jax.grad` through
`pk.flash_attention`.

On the CPU the wrappers take their plain PyTorch versions, so these tests
hold the plain versions (the CUDA kernels' specification) and the
Function's wiring; `chip_smoke.py` holds the kernels against the plain
versions on the card. Tolerance: rtol 1e-4, atol 1e-5 in float32, as the
JAX package's own flash-attention gradient test."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu.ops import pallas_kernels as pk
from singa_tpu_torch import autograd
from singa_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_bwd, flash_attention_bwd_reference,
    flash_attention_dkv, flash_attention_reference)

RTOL, ATOL = 1e-4, 1e-5
# The shapes of the JAX package's own flash-attention gradient test.
SHAPES = [((2, 2, 64, 32), True), ((1, 3, 100, 16), False),
          ((2, 1, 192, 64), True)]


def _arrays(shape, seed=0, n=4):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for _ in range(n)]


def _counters():
    return (flash_attention.launches, flash_attention_bwd.dq_launches,
            flash_attention_bwd.dkv_launches)


@pytest.mark.parametrize("shape,causal", SHAPES)
def test_reference_matches_pallas_flash_bwd(shape, causal):
    """The same q, k, v, o, lse and dO through `pk._flash_bwd` and the
    port's backward."""
    q, k, v, do = _arrays(shape)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    o, res = pk._flash_fwd(jq, jk, jv, causal, None)
    want = pk._flash_bwd(causal, None, res, jdo)
    b, h, s, _ = shape
    lse = np.asarray(res[4]).reshape(b, h, -1)[:, :, :s]
    got = flash_attention_bwd(*(torch.from_numpy(np.array(a)) for a in
                                (q, k, v, o, lse, do)), causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("shape,causal", SHAPES)
def test_function_grads_match_jax_grad(shape, causal):
    """Gradients of sum(sin(o)) through `FlashAttention` against jax.grad
    through `pk.flash_attention`. The output is transposed before the loss,
    so dO reaches the backward strided, as it does after attention in the
    model."""
    q, k, v, _ = _arrays(shape, seed=1)

    def jloss(q, k, v):
        o = pk.flash_attention(q, k, v, causal)
        return jnp.sum(jnp.sin(jnp.swapaxes(o, 1, 2)))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    before = _counters()
    o = autograd.FlashAttention.apply(tq, tk, tv, causal, None)
    torch.sum(torch.sin(o.transpose(1, 2))).backward()
    assert _counters() == before  # the CPU path launches nothing
    for name, t, w in zip("qkv", (tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=f"d{name}")


def test_explicit_scale_reaches_both_directions():
    q, k, v, do = _arrays((1, 2, 40, 16), seed=2)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    o, res = pk._flash_fwd(jq, jk, jv, True, 0.3)
    want = pk._flash_bwd(True, 0.3, res, jdo)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    to = autograd.FlashAttention.apply(tq, tk, tv, True, 0.3)
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(o),
                               rtol=RTOL, atol=ATOL)
    to.backward(torch.from_numpy(do))
    for t, w in zip((tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


def test_bf16_backward_returns_bf16_grads():
    q, k, v, do = (torch.from_numpy(a).bfloat16()
                   for a in _arrays((1, 2, 70, 32), seed=3))
    o, lse = flash_attention_reference(q, k, v, True)
    dq, dk, dv = flash_attention_bwd_reference(q, k, v, o, lse, do, True)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    f32 = flash_attention_bwd_reference(q.float(), k.float(), v.float(),
                                        o.float(), lse, do.float(), True)
    for g, w in zip((dq, dk, dv), f32):
        torch.testing.assert_close(g, w.bfloat16(), rtol=0, atol=0)


def test_function_runs_under_inference_mode():
    q, k, v = (torch.from_numpy(a) for a in _arrays((1, 2, 16, 16), n=3))
    with torch.inference_mode():
        o = autograd.FlashAttention.apply(q, k, v, True, None)
    torch.testing.assert_close(o, flash_attention_reference(q, k, v)[0])


def test_unsupported_backward_inputs_raise():
    q = torch.zeros(1, 2, 16, 32)
    lse = torch.zeros(1, 2, 16)
    with pytest.raises(ValueError, match="o and do must be"):
        flash_attention_bwd(q, q, q, q[:, :, :8], lse, q)
    with pytest.raises(ValueError, match="o and do must be"):
        flash_attention_bwd(q, q, q, q.bfloat16(), lse, q)
    with pytest.raises(ValueError, match="lse and delta must be float32"):
        flash_attention_bwd(q, q, q, q, lse[:, :, :8], q)
    with pytest.raises(ValueError, match="lse and delta must be float32"):
        flash_attention_dkv(q, q, q, lse, lse.double(), q)
    m = torch.zeros(1, 2, 16, 32, device="meta")
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        flash_attention_bwd(m, m, m, m, torch.zeros(1, 2, 16, device="meta"),
                            m)
