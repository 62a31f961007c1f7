"""The attention backward at the head dims of the forward past `HEAD_DIMS`
(96, 192, 384, 576, 960: the ADM ImageNet-64/-128 heads and cin256's
single heads), against the JAX package's Pallas backward in interpret mode.

- `attention_backward_plain` (the kernels' plain twin, which `attention_dq`
  and `attention_dkv` take on a CPU tensor) against `_mha_backward`, fed the
  same q, k, v, o, lse and cotangent, at ragged T and S, in fp32 (within
  2e-5) and bf16 (within 0.05): tests/test_torch_attention_bwd.py's bounds.
- S = 1 (cin256's cross-attention to its class token): ds is 0 up to
  rounding on both sides, so dq and dk are rounding noise; they are held to
  an absolute bound of 2^-12 * max|dO| * max|v|, dv (= p^T dO with p = 1)
  to the relative one.
- `token_attention` autograd against `jax.grad` of the Pallas
  `flash_attention` at dh 960.
- `attention_bwd_plan` takes every head dim of the forward in both dtypes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpm_solver_tpu.ops.attention import _lse, _mha_backward, attention_xla, flash_attention
from dpm_solver_tpu_torch.ops.attention import (FWD_HEAD_DIMS, attention_backward_plain,
                                                attention_bwd_plan, attention_lse_plain,
                                                token_attention)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's CPU work: these small shapes gain
    nothing from more, and the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 2e-5
TOL_BF16 = 0.05
S1_BOUND = 2.0 ** -12
WIDE = (96, 192, 384, 576, 960)


def _bh(u, heads):
    b, t, inner = u.shape
    return u.reshape(b, t, heads, inner // heads).transpose(0, 2, 1, 3).reshape(b * heads, t, -1)


def _unbh(u, b, heads):
    bh, t, dh = u.shape
    return u.reshape(b, heads, t, dh).transpose(0, 2, 1, 3).reshape(b, t, heads * dh)


def _case(b, t, s, heads, dh, seed, bf16):
    """The plain twin's (dq, dk, dv) and `_mha_backward`'s, as fp32 numpy,
    and (max|dO|, max|v|)."""
    rng = np.random.default_rng(seed)
    q, g = (rng.standard_normal((b, t, heads * dh)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, s, heads * dh)).astype(np.float32) for _ in range(2))
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    scale = dh ** -0.5
    qh, kh, vh, gh = (jnp.asarray(_bh(u, heads), jdt) for u in (q, k, v, g))
    o = attention_xla(qh, kh, vh, scale=scale)
    lse = _lse(qh, kh, scale, 128, True)
    want = _mha_backward(qh, kh, vh, o, lse, gh, scale, 128, 128, True)

    tdt = torch.bfloat16 if bf16 else torch.float32
    tt = lambda u: torch.tensor(np.asarray(u, np.float32)).to(tdt)
    tq, tk, tv, tg = (tt(np.asarray(jnp.asarray(u, jdt), np.float32)) for u in (q, k, v, g))
    got_lse = attention_lse_plain(tq, tk, num_heads=heads, scale=scale)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse),
                               rtol=TOL_BF16 if bf16 else 0, atol=TOL_BF16 if bf16 else TOL)
    got = attention_backward_plain(tq, tk, tv, tt(_unbh(np.asarray(o, np.float32), b, heads)),
                                   got_lse, tg, heads, scale)
    for gg in got:
        assert gg.dtype == tdt
    return ([gg.float().numpy() for gg in got],
            [_unbh(np.asarray(w, np.float32), b, heads) for w in want],
            (float(np.abs(tg.float().numpy()).max()), float(np.abs(tv.float().numpy()).max())))


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,t,s,heads,dh", [
    (2, 33, 50, 2, 96), (1, 37, 20, 2, 192), (1, 40, 24, 1, 384), (1, 24, 40, 1, 576),
    (1, 20, 18, 1, 960)], ids=lambda v: str(v))
def test_plain_matches_pallas_backward_at_wide_head_dims(b, t, s, heads, dh, bf16):
    got, want, _ = _case(b, t, s, heads, dh, seed=dh, bf16=bf16)
    tol = TOL_BF16 if bf16 else TOL
    for name, gg, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(gg, w, rtol=tol if bf16 else 0, atol=tol, err_msg=name)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("dh", [384, 576, 960])
def test_plain_matches_pallas_backward_with_one_key(dh, bf16):
    """cin256's cross-attention: one key. dq and dk are rounding noise on
    both sides, within 2^-12 * max|dO| * max|v| of each other (and of 0);
    dv is dO summed over the queries, within the relative bound."""
    got, want, (g_max, v_max) = _case(2, 20, 1, 1, dh, seed=dh + 1, bf16=bf16)
    bound = S1_BOUND * g_max * v_max
    for name, gg, w in zip(("dq", "dk"), got[:2], want[:2]):
        assert np.abs(gg - w).max() <= bound, name
        assert np.abs(gg).max() <= bound, name
    tol = TOL_BF16 if bf16 else TOL
    np.testing.assert_allclose(got[2], want[2], rtol=tol if bf16 else 0, atol=tol)


def test_autograd_matches_jax_grad_at_dh_960():
    """token_attention's autograd Function (the plain twins on the CPU)
    against jax.grad of the Pallas flash attention at cin256's 8x8 head."""
    b, t, s, heads, dh = 1, 30, 30, 1, 960
    rng = np.random.default_rng(7)
    q, k, v, g = (rng.standard_normal((b, n, dh)).astype(np.float32) for n in (t, s, s, t))
    scale = dh ** -0.5

    def loss(qq, kk, vv):
        out = flash_attention(_bh(qq, heads), _bh(kk, heads), _bh(vv, heads), scale, 128, 128,
                              True)
        return jnp.sum(_unbh(out, b, heads) * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(u) for u in (q, k, v)))
    tq, tk, tv = (torch.tensor(u, requires_grad=True) for u in (q, k, v))
    out = token_attention(tq, tk, tv, num_heads=heads, scale=scale)
    got = torch.autograd.grad((out * torch.tensor(g)).sum(), (tq, tk, tv))
    for name, w, gg in zip(("dq", "dk", "dv"), want, got):
        np.testing.assert_allclose(gg.numpy(), np.asarray(w), rtol=0, atol=TOL, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_backward_plan_takes_every_forward_head_dim(dtype):
    for dh in FWD_HEAD_DIMS:
        tile = attention_bwd_plan(dh, dtype)
        assert tile.dq.dh == tile.dkv.dh == dh
    assert set(WIDE) <= set(FWD_HEAD_DIMS)
