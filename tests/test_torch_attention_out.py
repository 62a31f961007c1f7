"""Port attention -> out-projection -> residual (`ops.attention_out_fused`)
against `dpm_solver_tpu/ops/attention.py`.

`attention_out_plain` (the CPU twin of csrc/attention_out.cu) and the port's
`attention_out_fused` on the CPU against the JAX composition
`attention_out_ref` and the Pallas kernel in interpret mode (both epilogue
variants), at the shapes of tests/test_attention_kernel.py:137-160 (even
blocks, padded query and key tails with C = 320, dh = 40) plus
cross-attention with S != T, with and without bias, and the shapes the
kernel takes since it was widened: dh 32, 80 and 160 at H*dh = 1280 with a
few tokens, single heads of dh 256 and 512, and ragged S; the gradient of
every input against `jax.grad` through the Pallas custom VJP (dh 32 and 80).
fp32 within 1e-5 of max. The kernels themselves run on the card only
(chip_smoke.py); `_check_out` holds the shapes they take.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpm_solver_tpu.ops.attention import attention_out_fused as jax_attention_out_fused
from dpm_solver_tpu.ops.attention import attention_out_ref
from dpm_solver_tpu_torch import ops
from dpm_solver_tpu_torch.ops import attention

TOL = 1e-5
# (B, T, S, H, dh, C)
SHAPES = [(2, 256, 256, 4, 64, 256), (1, 300, 300, 5, 64, 320), (2, 130, 130, 2, 40, 96),
          (2, 100, 77, 2, 64, 96)]
# the widened kernel's shapes: H*dh = 1280 at dh 32, 80 (ragged S) and 160,
# single heads of dh 256 and 512 (ragged S), cross-attention at dh 40
WIDE = [(1, 12, 12, 40, 32, 96), (1, 10, 19, 16, 80, 96), (2, 9, 9, 8, 160, 64),
        (1, 20, 20, 1, 256, 256), (1, 8, 13, 1, 512, 64), (2, 33, 77, 8, 40, 96)]


def _data(shape, seed=0, bias=True):
    b, t, s, h, dh, c = shape
    rng = np.random.RandomState(seed)
    q = rng.randn(b, t, h * dh).astype(np.float32)
    k, v = (rng.randn(b, s, h * dh).astype(np.float32) for _ in range(2))
    w = (rng.randn(h * dh, c) * 0.1).astype(np.float32)
    bb = rng.randn(c).astype(np.float32) if bias else None
    res = rng.randn(b, t, c).astype(np.float32)
    return q, k, v, w, bb, res


def _jax(a):
    return None if a is None else jnp.asarray(a)


def _torch(a, grad=False):
    return None if a is None else torch.tensor(a, requires_grad=grad)


def close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("shape", SHAPES + WIDE)
@pytest.mark.parametrize("bias", [True, False])
def test_plain_matches_jax_composition(shape, bias):
    q, k, v, w, bb, res = _data(shape, bias=bias)
    h = shape[3]
    want = attention_out_ref(*map(_jax, (q, k, v, w, bb, res)), num_heads=h)
    got = ops.attention_out_plain(*map(_torch, (q, k, v, w, bb, res)), num_heads=h)
    assert got.dtype == torch.float32 and got.shape == res.shape
    close(got.numpy(), want)


@pytest.mark.parametrize("shape", SHAPES[:3] + WIDE)
@pytest.mark.parametrize("concat", [True, False])
def test_fused_entry_matches_pallas_interpret(shape, concat):
    q, k, v, w, bb, res = _data(shape, seed=1)
    h = shape[3]
    want = jax_attention_out_fused(*map(_jax, (q, k, v, w, bb, res)), h, None, True, concat)
    got = ops.attention_out_fused(*map(_torch, (q, k, v, w, bb, res)), h)
    close(got.numpy(), want)


@pytest.mark.parametrize("bias", [True, False])
def test_gradients_match_pallas_custom_vjp(bias):
    _hold_gradients((1, 128, 128, 2, 32, 64), bias)


def test_gradients_at_head_dim_80_match_pallas_custom_vjp():
    """A head dim the kernel took only once widened (SD-1's 32x32 level),
    ragged S, against jax.grad through the Pallas kernel's custom VJP."""
    _hold_gradients((1, 40, 50, 2, 80, 64), True)


def _hold_gradients(shape, bias):
    arrays = _data(shape, seed=5, bias=bias)
    h = shape[3]
    argnums = tuple(i for i, a in enumerate(arrays) if a is not None)

    def loss(*a):
        full = list(arrays)
        for i, u in zip(argnums, a):
            full[i] = u
        return (jax_attention_out_fused(*full, h, None, True) ** 2).sum()

    want = jax.grad(loss, argnums=tuple(range(len(argnums))))(
        *(jnp.asarray(arrays[i]) for i in argnums))
    ts = [_torch(a, grad=True) for a in arrays]
    (ops.attention_out_fused(*ts, h) ** 2).sum().backward()
    for i, g in zip(argnums, want):
        close(ts[i].grad.numpy(), g)


def test_custom_scale_matches_jax():
    q, k, v, w, bb, res = _data((1, 64, 50, 2, 64, 64), seed=2)
    want = attention_out_ref(*map(_jax, (q, k, v, w, bb, res)), num_heads=2, scale=0.3)
    close(ops.attention_out_fused(*map(_torch, (q, k, v, w, bb, res)), 2, 0.3).numpy(), want)


def test_checks_refuse_what_the_kernel_does_not_take():
    """The kernel takes every head dim of HEAD_DIMS with H*dh <= 1280 and
    C % 8 == 0 up to 1280, fp32 and bf16; `_check_out` refuses the rest."""
    q, r = torch.zeros(2, 16, 128), torch.zeros(2, 16, 96)
    w, b = torch.zeros(128, 96), torch.zeros(96)
    attention._check_out(q, q, q, w, b, r, 2)                            # dh = 64
    attention._check_out(q, q, q, w, None, r, 2)                         # bias is optional
    attention._check_out(q, q, q, w, b, r, 4)                            # dh = 32
    for dh in attention.HEAD_DIMS:                                        # H*dh = 1280 or less
        heads = attention.OUT_MAX_INNER // dh
        qw = torch.zeros(1, 4, heads * dh, dtype=torch.bfloat16)
        attention._check_out(qw, qw, qw, torch.zeros(heads * dh, 1280, dtype=torch.bfloat16),
                             None, torch.zeros(1, 4, 1280, dtype=torch.bfloat16), heads)
    with pytest.raises(ValueError, match="head dims"):
        attention._check_out(q, q, q, w, b, r, 8)                        # dh = 16
    odd = torch.zeros(2, 16, 96)
    with pytest.raises(ValueError, match="head dims"):
        attention._check_out(odd, odd, odd, torch.zeros(96, 96), b, r, 2)  # dh = 48
    wide = torch.zeros(1, 4, 1344)
    with pytest.raises(ValueError, match="H\\*dh"):
        attention._check_out(wide, wide, wide, torch.zeros(1344, 8), None,
                             torch.zeros(1, 4, 8), 21)                    # 21 heads of 64
    with pytest.raises(ValueError, match="H\\*dh"):
        attention._check_out(wide, wide, wide, torch.zeros(1344, 8), None,
                             torch.zeros(1, 4, 8), 42)                    # 42 heads of 32
    with pytest.raises(ValueError, match="residual"):
        attention._check_out(q, q, q, w, b, r.bfloat16(), 2)
    with pytest.raises(ValueError, match="w_out"):
        attention._check_out(q, q, q, torch.zeros(96, 128).t(), b, r, 2)  # not contiguous
    with pytest.raises(ValueError, match="bias"):
        attention._check_out(q, q, q, w, b.bfloat16(), r, 2)
    for dt in (torch.float32, torch.bfloat16):
        qd = q.to(dt)
        with pytest.raises(ValueError, match="C % 8"):
            attention._check_out(qd, qd, qd, torch.zeros(128, 90, dtype=dt), None,
                                 torch.zeros(2, 16, 90, dtype=dt), 2)
        with pytest.raises(ValueError, match="C <= 1280"):
            attention._check_out(qd, qd, qd, torch.zeros(128, 1288, dtype=dt), None,
                                 torch.zeros(2, 16, 1288, dtype=dt), 2)
    meta = torch.zeros(2, 16, 128, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.attention_out_fused(meta, meta, meta, w.to("meta"), None, r.to("meta"), 2)


def test_fused_wins_table_is_measured_only():
    """`attn_out_fused_wins` (the JAX dispatch's port): True only at the
    self-attention sites of `_ATTN_OUT_WINS`, each one the kernel takes."""
    for t, heads, dh, c in attention._ATTN_OUT_WINS:
        attention.attention_out_plan(dh, heads * dh, c)
        assert attention.attn_out_fused_wins(t, t, heads, dh, c)
        assert not attention.attn_out_fused_wins(t, 77, heads, dh, c)   # cross-attention
    assert not attention.attn_out_fused_wins(2304, 2304, 10, 64, 640)   # measured a loss
    assert not attention.attn_out_fused_wins(64, 64, 21, 64, 320)       # H*dh > 1280
