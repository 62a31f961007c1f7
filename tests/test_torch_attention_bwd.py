"""Port attention backward (dpm_solver_tpu_torch/ops/attention.py) against the
JAX package's Pallas backward, run in interpret mode.

- `attention_lse_plain` against `_lse`, and `attention_backward_plain`
  against `_mha_backward` (both of its kernel pairs: the normal and the
  transposed-output form), fed the same q, k, v, o, lse and cotangent, at
  tests/test_attention_bwd.py's shapes plus T = S = 65 (the classifier's
  attention pool at 8x8), and at every other head dim the forward takes
  (32, 40, 80, 128, 160, 256, 512: the dq and dk/dv kernels take them all).
  fp32 within 2e-5 and bf16 within 0.05, that file's tolerances.
- `token_attention` autograd (the port's torch.autograd.Function, whose
  backward takes the plain twins on the CPU) against `jax.grad` of the Pallas
  `fused_attention`, `fused_attention_t` and `flash_attention`, in interpret
  mode, on the head-major (B, T, H*dh) layout, at dh 64 and at the dh 256
  of the DDPM / NCSN++ single head that bits/dim differentiates; and on q,
  k, v that are
  strided column slices of one qkv projection, as the attention pool passes
  them.
- bf16 at dh 512 (the VAE's single head, which the dq and dk/dv kernels
  take in both dtypes): the plain twin against `_mha_backward`, and
  `token_attention` autograd on strided qkv slices against `jax.grad` of
  the Pallas `flash_attention`, within the bf16 bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpm_solver_tpu.ops.attention import (_lse, _mha_backward, attention_xla, flash_attention,
                                          fused_attention, fused_attention_t)
from dpm_solver_tpu_torch.ops.attention import (attention_backward_plain, attention_lse_plain,
                                                token_attention)

TOL = 2e-5
TOL_BF16 = 0.05


def _bh(u, heads):
    """(B, T, H*dh) head-major -> the Pallas kernels' (B*H, T, dh)."""
    b, t, inner = u.shape
    return u.reshape(b, t, heads, inner // heads).transpose(0, 2, 1, 3).reshape(b * heads, t, -1)


def _unbh(u, b, heads):
    bh, t, dh = u.shape
    return u.reshape(b, heads, t, dh).transpose(0, 2, 1, 3).reshape(b, t, heads * dh)


def _inputs(b, t, s, heads, dh, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q, g = (rng.standard_normal((b, t, heads * dh)).astype(dtype) for _ in range(2))
    k, v = (rng.standard_normal((b, s, heads * dh)).astype(dtype) for _ in range(2))
    return q, k, v, g


@pytest.mark.parametrize("b,t,s,heads,dh", [
    (2, 200, 200, 1, 64),   # ragged query/key tails against 128-blocks
    (2, 300, 77, 1, 32),    # cross-attention, short keys
    (1, 65, 65, 2, 64),     # the attention pool: HW + 1 tokens
], ids=["ragged", "cross-s77", "pool-t65"])
@pytest.mark.parametrize("t_out", [False, True], ids=["normal", "transposed"])
def test_plain_matches_pallas_lse_and_backward(b, t, s, heads, dh, t_out):
    q, k, v, g = _inputs(b, t, s, heads, dh, seed=0)
    scale = dh ** -0.5
    qh, kh, vh, gh = (jnp.asarray(_bh(u, heads)) for u in (q, k, v, g))
    o = attention_xla(qh, kh, vh, scale=scale)
    lse = _lse(qh, kh, scale, 128, True)
    want = _mha_backward(qh, kh, vh, o, lse, gh, scale, 128, 128, True, t_out=t_out)

    tq, tk, tv, tg = (torch.tensor(u) for u in (q, k, v, g))
    got_lse = attention_lse_plain(tq, tk, num_heads=heads, scale=scale)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse), rtol=0, atol=TOL)
    to = torch.tensor(_unbh(np.asarray(o), b, heads))
    got = attention_backward_plain(tq, tk, tv, to, got_lse, tg, heads, scale)
    for name, w, gg in zip(("dq", "dk", "dv"), want, got):
        np.testing.assert_allclose(gg.numpy(), _unbh(np.asarray(w), b, heads), rtol=0,
                                   atol=TOL, err_msg=name)


# one shape per head dim: T and S off the Pallas blocks of 128, S >= 2 (with
# one key ds is 0: ROADMAP's S = 1 note); SD-1's 40/80/160 with 8 heads
@pytest.mark.parametrize("b,t,s,heads,dh", [
    (1, 70, 50, 2, 32), (2, 77, 40, 8, 40), (1, 64, 77, 8, 80), (1, 33, 129, 2, 128),
    (1, 65, 65, 2, 160), (2, 64, 64, 1, 256), (1, 40, 24, 1, 512),
], ids=lambda v: str(v))
def test_plain_matches_pallas_backward_at_each_head_dim(b, t, s, heads, dh):
    q, k, v, g = _inputs(b, t, s, heads, dh, seed=dh)
    scale = dh ** -0.5
    qh, kh, vh, gh = (jnp.asarray(_bh(u, heads)) for u in (q, k, v, g))
    o = attention_xla(qh, kh, vh, scale=scale)
    lse = _lse(qh, kh, scale, 128, True)
    want = _mha_backward(qh, kh, vh, o, lse, gh, scale, 128, 128, True)

    tq, tk, tv, tg = (torch.tensor(u) for u in (q, k, v, g))
    got_lse = attention_lse_plain(tq, tk, num_heads=heads, scale=scale)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse), rtol=0, atol=TOL)
    to = torch.tensor(_unbh(np.asarray(o), b, heads))
    got = attention_backward_plain(tq, tk, tv, to, got_lse, tg, heads, scale)
    for name, w, gg in zip(("dq", "dk", "dv"), want, got):
        np.testing.assert_allclose(gg.numpy(), _unbh(np.asarray(w), b, heads), rtol=0,
                                   atol=TOL, err_msg=name)


def test_plain_matches_pallas_backward_bf16():
    b, t, s, heads, dh = 2, 256, 256, 1, 64
    q, k, v, g = (u.astype(jnp.bfloat16) for u in _inputs(b, t, s, heads, dh, seed=1))
    scale = dh ** -0.5
    qh, kh, vh, gh = (jnp.asarray(_bh(np.asarray(u), heads)) for u in (q, k, v, g))
    o = attention_xla(qh, kh, vh, scale=scale)
    lse = _lse(qh, kh, scale, 128, True)
    want = _mha_backward(qh, kh, vh, o, lse, gh, scale, 128, 128, True)

    tt = lambda u: torch.tensor(np.asarray(u, np.float32)).bfloat16()
    tq, tk, tv, tg = (tt(u) for u in (q, k, v, g))
    got_lse = attention_lse_plain(tq, tk, num_heads=heads, scale=scale)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse), rtol=TOL_BF16, atol=TOL_BF16)
    got = attention_backward_plain(tq, tk, tv, tt(_unbh(np.asarray(o, np.float32), b, heads)),
                                   got_lse, tg, heads, scale)
    for name, w, gg in zip(("dq", "dk", "dv"), want, got):
        assert gg.dtype == torch.bfloat16
        np.testing.assert_allclose(gg.float().numpy(),
                                   _unbh(np.asarray(w, np.float32), b, heads),
                                   rtol=TOL_BF16, atol=TOL_BF16, err_msg=name)


def test_plain_matches_pallas_backward_bf16_at_dh_512():
    """The VAE mid-block's single 512-wide head in bf16, at a small ragged
    shape: the plain twin against `_mha_backward` in interpret mode."""
    b, t, s, heads, dh = 1, 40, 24, 1, 512
    q, k, v, g = (u.astype(jnp.bfloat16) for u in _inputs(b, t, s, heads, dh, seed=6))
    scale = dh ** -0.5
    qh, kh, vh, gh = (jnp.asarray(_bh(np.asarray(u), heads)) for u in (q, k, v, g))
    o = attention_xla(qh, kh, vh, scale=scale)
    lse = _lse(qh, kh, scale, 128, True)
    want = _mha_backward(qh, kh, vh, o, lse, gh, scale, 128, 128, True)

    tt = lambda u: torch.tensor(np.asarray(u, np.float32)).bfloat16()
    tq, tk, tv, tg = (tt(u) for u in (q, k, v, g))
    got_lse = attention_lse_plain(tq, tk, num_heads=heads, scale=scale)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse), rtol=TOL_BF16, atol=TOL_BF16)
    got = attention_backward_plain(tq, tk, tv, tt(_unbh(np.asarray(o, np.float32), b, heads)),
                                   got_lse, tg, heads, scale)
    for name, w, gg in zip(("dq", "dk", "dv"), want, got):
        assert gg.dtype == torch.bfloat16
        np.testing.assert_allclose(gg.float().numpy(),
                                   _unbh(np.asarray(w, np.float32), b, heads),
                                   rtol=TOL_BF16, atol=TOL_BF16, err_msg=name)


_PALLAS = {
    "panel": lambda q, k, v, s: fused_attention(q, k, v, s, 128, True),
    "panel_t": lambda q, k, v, s: fused_attention_t(q, k, v, s, 128, True),
    "flash": lambda q, k, v, s: flash_attention(q, k, v, s, 128, 128, True),
}


@pytest.mark.parametrize("kernel,b,t,s,heads,dh", [
    ("panel", 2, 64, 64, 2, 64),      # the classifier's 8x8 attention blocks, 2 heads
    ("panel_t", 1, 128, 128, 2, 64),  # the JAX dispatch at dh 64, T == S
    ("flash", 1, 100, 77, 2, 64),     # ragged, T != S
    ("panel", 1, 65, 65, 4, 64),      # the attention pool
    ("panel", 2, 64, 64, 1, 256),     # NCSN++ / DDPM's single head at 8x8
], ids=["panel-t64", "panel_t-t128", "flash-ragged", "panel-pool-t65", "panel-dh256"])
def test_autograd_matches_jax_grad(kernel, b, t, s, heads, dh):
    q, k, v, g = _inputs(b, t, s, heads, dh, seed=2)
    scale = dh ** -0.5

    def loss(qq, kk, vv):
        out = _PALLAS[kernel](_bh(qq, heads), _bh(kk, heads), _bh(vv, heads), scale)
        return jnp.sum(_unbh(out, b, heads) * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(u) for u in (q, k, v)))
    tq, tk, tv = (torch.tensor(u, requires_grad=True) for u in (q, k, v))
    out = token_attention(tq, tk, tv, num_heads=heads, scale=scale)
    got = torch.autograd.grad((out * torch.tensor(g)).sum(), (tq, tk, tv))
    for name, w, gg in zip(("dq", "dk", "dv"), want, got):
        np.testing.assert_allclose(gg.numpy(), np.asarray(w), rtol=0, atol=TOL, err_msg=name)


def test_autograd_through_strided_qkv_slices():
    """q, k, v as column slices of one (B, T, 3C) tensor give the gradient of
    the contiguous copies, in the qkv tensor's shape."""
    rng = np.random.default_rng(3)
    qkv = torch.tensor(rng.standard_normal((2, 65, 3 * 128)).astype(np.float32),
                       requires_grad=True)
    g = torch.tensor(rng.standard_normal((2, 65, 128)).astype(np.float32))
    q, k, v = qkv.split(128, dim=-1)
    assert q.stride() == (65 * 384, 384, 1)
    got, = torch.autograd.grad((token_attention(q, k, v, num_heads=2) * g).sum(), qkv)
    flat = qkv.detach().clone().requires_grad_(True)
    parts = [u.contiguous() for u in flat.split(128, dim=-1)]
    want, = torch.autograd.grad((token_attention(*parts, num_heads=2) * g).sum(), flat)
    assert got.shape == qkv.shape
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_no_grad_and_frozen_inputs_take_the_plain_forward():
    """Without grad the forward saves nothing; with grad it matches the
    forward's value exactly."""
    q, k, v, _ = (torch.tensor(u) for u in _inputs(1, 16, 16, 2, 64, seed=4))
    with torch.no_grad():
        want = token_attention(q, k, v, num_heads=2)
    got = token_attention(q.requires_grad_(), k, v, num_heads=2)
    assert got.grad_fn is not None and want.grad_fn is None
    torch.testing.assert_close(got.detach(), want, rtol=0, atol=0)


@pytest.mark.parametrize("which", [0, 1, 2], ids=["q", "k", "v"])
def test_autograd_with_one_input_requiring_grad(which):
    """The backward asked for one input's gradient gives that input the same
    gradient as when all three require it."""
    q, k, v, g = (torch.tensor(u) for u in _inputs(1, 20, 24, 2, 64, seed=5))
    full = [u.clone().requires_grad_(True) for u in (q, k, v)]
    want = torch.autograd.grad((token_attention(*full, num_heads=2) * g).sum(), full)[which]
    one = [u.clone().requires_grad_(i == which) for i, u in enumerate((q, k, v))]
    got, = torch.autograd.grad((token_attention(*one, num_heads=2) * g).sum(), one[which])
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_autograd_bf16_dh_512_through_strided_qkv_slices():
    """bf16 at dh 512 on q, k, v that are column slices of one (B, T, 3C)
    projection, as the VAE's attention passes them: `token_attention`
    autograd against `jax.grad` of the Pallas `flash_attention` in
    interpret mode, the gradient in the qkv tensor's shape."""
    b, t, heads, dh = 1, 40, 1, 512
    rng = np.random.default_rng(7)
    qkv = rng.standard_normal((b, t, 3 * dh)).astype(np.float32)
    g = rng.standard_normal((b, t, dh)).astype(np.float32)
    scale = dh ** -0.5

    def loss(x):
        qq, kk, vv = (_bh(x[..., i * dh:(i + 1) * dh], heads) for i in range(3))
        out = flash_attention(qq, kk, vv, scale, 128, 128, True)
        return jnp.sum(_unbh(out, b, heads).astype(jnp.float32) * g)

    want = jax.grad(loss)(jnp.asarray(qkv, jnp.bfloat16))
    tqkv = torch.tensor(qkv).bfloat16().requires_grad_(True)
    q, k, v = tqkv.split(dh, dim=-1)
    assert q.stride() == (t * 3 * dh, 3 * dh, 1)
    out = token_attention(q, k, v, num_heads=heads, scale=scale)
    got, = torch.autograd.grad((out.float() * torch.tensor(g)).sum(), tqkv)
    assert got.shape == tqkv.shape and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=TOL_BF16, atol=TOL_BF16)
