"""Port conv3x3 (dpm_solver_tpu_torch/ops/conv3x3.py) against the JAX Pallas
slab kernel, run in interpret mode, and the `Conv3x3` module against a Flax
`nn.Conv` whose parameters are carried across.

fp32 within 1e-4, the JAX package's own bound for this kernel
(tests/test_conv3x3.py:41). On the CPU the wrapper takes its plain version.
The autograd (dx through `conv3x3_dx`, dw, db) is held to `jax.grad` of the
Pallas kernel's custom VJP within atol 2e-3, rtol 1e-3
(tests/test_conv3x3.py:61).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpm_solver_tpu.ops.conv3x3 import conv3x3 as jax_conv3x3
from dpm_solver_tpu_torch.ops.conv3x3 import Conv3x3, conv3x3, conv3x3_dx

TOL = 1e-4


def _inputs(b, h, w, c, co, seed=0):
    rs = np.random.default_rng(seed)
    x = rs.standard_normal((b, h, w, c)).astype(np.float32)
    wt = (rs.standard_normal((3, 3, c, co)) * 0.1).astype(np.float32)
    bias = (rs.standard_normal((co,)) * 0.1).astype(np.float32)
    return x, wt, bias


def test_plain_matches_pallas_interpret():
    x, wt, bias = _inputs(2, 8, 8, 128, 128)
    want = np.asarray(jax_conv3x3(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias),
                                  True, True))  # force Pallas, interpret
    got = conv3x3(torch.tensor(x), torch.tensor(wt), torch.tensor(bias)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape", [(2, 8, 8, 32, 64), (1, 5, 7, 20, 9), (2, 4, 4, 64, 32)],
                         ids=["tiny", "ragged", "narrow-out"])
def test_plain_matches_xla_conv(shape):
    """Widths the Pallas kernel does not take (C, CO not multiples of 128)."""
    x, wt, bias = _inputs(*shape, seed=1)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(wt), (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"))) + bias
    got = conv3x3(torch.tensor(x), torch.tensor(wt), torch.tensor(bias)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_module_matches_flax_conv_with_params_carried():
    x, _, _ = _inputs(2, 8, 8, 32, 64, seed=2)
    flax_conv = nn.Conv(64, (3, 3), padding=1)
    params = flax_conv.init(jax.random.key(0), jnp.asarray(x))
    want = np.asarray(flax_conv.apply(params, jnp.asarray(x)))
    m = Conv3x3(32, 64)
    m.load_state_dict({
        "weight": torch.tensor(np.asarray(params["params"]["kernel"]).transpose(3, 2, 0, 1)),
        "bias": torch.tensor(np.asarray(params["params"]["bias"]))})
    with torch.no_grad():
        got = m(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape", [(1, 8, 16, 128, 128), (2, 8, 8, 128, 256)],
                         ids=["square", "widening"])
def test_autograd_matches_jax_grad_of_pallas(shape):
    x, wt, bias = _inputs(*shape, seed=3)
    cot = np.random.default_rng(4).standard_normal(x.shape[:3] + (shape[-1],)).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(jax_conv3x3(*a, True, True) * cot), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias))
    args = [torch.tensor(u, requires_grad=True) for u in (x, wt, bias)]
    got = torch.autograd.grad((conv3x3(*args) * torch.tensor(cot)).sum(), args)
    for name, w, g in zip(("dx", "dw", "db"), want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-3, rtol=1e-3, err_msg=name)


def test_frozen_weights_give_dx_only():
    """With the weight and bias frozen (the guided path's classifier) only dx
    is computed, and it is `conv3x3_dx` of the cotangent."""
    x, wt, bias = _inputs(2, 6, 5, 20, 9, seed=5)
    cot = torch.tensor(np.random.default_rng(6).standard_normal((2, 6, 5, 9)).astype(np.float32))
    xt, w, b = torch.tensor(x, requires_grad=True), torch.tensor(wt), torch.tensor(bias)
    (conv3x3(xt, w, b) * cot).sum().backward()
    torch.testing.assert_close(xt.grad, conv3x3_dx(cot, w), rtol=0, atol=0)
    want = torch.nn.grad.conv2d_input(xt.shape[:1] + (20, 6, 5), w.permute(3, 2, 0, 1),
                                      cot.permute(0, 3, 1, 2), padding=1).permute(0, 2, 3, 1)
    torch.testing.assert_close(xt.grad, want, rtol=1e-5, atol=1e-5)


def _split_order_conv(x, wt, bias, dx=False):
    """The "f32" kernel's split reduction emulated in fp32 on the CPU: the
    partial conv of each of the plan's ranges of (tap, 16-channel chunk)
    steps, added in range order from 0, then the bias (csrc/conv3x3.cu's
    `conv3x3_f32_sum`). dx: the input gradient of the (3,3,C,CO) weight at
    cotangent x, as the kernel's dx mode reads it (flipped taps, channels
    swapped)."""
    import torch.nn.functional as F

    from dpm_solver_tpu_torch.ops.conv3x3 import F32_BLOCK_K, conv3x3_plan, flip_weight

    w = flip_weight(wt) if dx else wt            # (3, 3, Cin, Cout) of the conv computed
    cin, cout = w.shape[2], w.shape[3]
    plan = conv3x3_plan(tuple(x.shape), cout, torch.float32, dx=dx)
    nch = -(-cin // F32_BLOCK_K)
    out = torch.zeros(x.shape[:3] + (cout,), dtype=torch.float32)
    for first, last in plan.ranges(cin):
        mask = torch.zeros(9, cin, 1)
        for step in range(first, last):
            c0 = step % nch * F32_BLOCK_K
            mask[step // nch, c0:c0 + F32_BLOCK_K] = 1.0
        wz = (w.reshape(9, cin, cout) * mask).reshape(3, 3, cin, cout)
        out = out + F.conv2d(x.permute(0, 3, 1, 2), wz.permute(3, 2, 0, 1),
                             padding=1).permute(0, 2, 3, 1)
    return out if bias is None else out + bias, plan


# path E's channel counts on its 4x4 and 8x8 maps (DDPM++ deep, the mid and
# last down blocks), at b1, where the split is deepest
SPLIT_SITES = [(1, 4, 4, 256, 256), (1, 4, 4, 512, 256), (1, 8, 8, 256, 256),
               (1, 8, 8, 512, 256)]


@pytest.mark.parametrize("shape", SPLIT_SITES, ids=str)
def test_split_reduction_order_stays_in_the_fp32_bound(shape):
    """The split kernel's summation order (per-range partial sums added in
    range order) agrees with the JAX conv3x3 within 1e-5 of max|out|: the
    new order moves the result only within fp32 rounding."""
    x, wt, bias = _inputs(*shape, seed=7)
    want = np.asarray(jax_conv3x3(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias)))
    got, plan = _split_order_conv(torch.tensor(x), torch.tensor(wt), torch.tensor(bias))
    assert plan.route == "f32" and plan.split > 1
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("shape", SPLIT_SITES[::2], ids=str)
def test_split_reduction_order_of_dx_stays_in_the_fp32_bound(shape):
    """The same for the input gradient, the kernel's dx mode, against the
    JAX conv3x3's custom VJP."""
    x, wt, bias = _inputs(*shape, seed=8)
    cot = np.random.default_rng(9).standard_normal(x.shape[:3] + (shape[-1],)).astype(np.float32)
    _, vjp = jax.vjp(lambda u: jax_conv3x3(u, jnp.asarray(wt), jnp.asarray(bias)), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(cot))[0])
    got, plan = _split_order_conv(torch.tensor(cot), torch.tensor(wt), None, dx=True)
    assert plan.dx and plan.split > 1
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def _narrow_conv(x, wt, bias=None, dx=False):
    """The "narrow" kernel's arithmetic emulated on the CPU: bf16 x with the
    one-pixel halo (SAME padding) and its channels zero-padded to the
    weight's rows, each tap the product of the patch shifted by the tap with
    that tap's [output][input] rows of `narrow_weight` (the layout the kernel
    copies; dx: the flipped weight), summed in fp32, the CO tail dropped,
    the bias added, one rounding to bf16."""
    import torch.nn.functional as F

    from dpm_solver_tpu_torch.ops.conv3x3 import conv3x3_plan, narrow_weight

    b, h, w, cin = x.shape
    cout = wt.shape[2] if dx else wt.shape[3]
    plan = conv3x3_plan(tuple(x.shape), cout, torch.bfloat16, dx=dx)
    wp = narrow_weight(wt, plan.tile, dx).float()
    xp = F.pad(x.float(), (0, wp.shape[2] - cin, 1, 1, 1, 1))
    acc = torch.zeros(b, h, w, wp.shape[1])
    for tap in range(9):
        dy, dxx = divmod(tap, 3)
        acc += xp[:, dy:dy + h, dxx:dxx + w] @ wp[tap].T
    out = acc[..., :cout] + (0.0 if bias is None else bias)
    return out.to(torch.bfloat16), plan


# the SD VAE's ends cut to small maps (conv_in 4 -> 512, conv_out 128 -> 3),
# and ragged C x CO on an odd map
NARROW_SHAPES = [(1, 12, 20, 4, 512), (1, 16, 24, 128, 3), (2, 7, 9, 1, 20),
                 (2, 7, 9, 3, 4), (2, 7, 9, 5, 6), (2, 7, 9, 12, 3)]


@pytest.mark.parametrize("dx", [False, True], ids=["forward", "dx"])
@pytest.mark.parametrize("shape", NARROW_SHAPES, ids=str)
def test_narrow_route_layout_matches_jax_conv(shape, dx):
    """The "narrow" route's decomposition on bf16 inputs (its weight layout,
    the halo patch read at each tap's offset, fp32 sums, one rounding)
    against the JAX conv in fp32 on the same values, then its VJP for dx:
    within one bf16 rounding of the result (2^-8 of max|out|) plus the
    fp32 bound."""
    b, h, w, c, co = shape
    x, wt, bias = _inputs(*shape, seed=10)
    bf = lambda u: torch.tensor(u).to(torch.bfloat16)
    xb, wb = bf(x), bf(wt)
    f32 = lambda u: jnp.asarray(u.float().numpy())
    conv = lambda u: jax.lax.conv_general_dilated(u, f32(wb), (1, 1), ((1, 1), (1, 1)),
                                                  dimension_numbers=("NHWC", "HWIO", "NHWC"))
    if dx:
        g = bf(np.random.default_rng(11).standard_normal((b, h, w, co)).astype(np.float32))
        want = np.asarray(jax.vjp(conv, f32(xb))[1](f32(g))[0])
        got, plan = _narrow_conv(g, wb, dx=True)
    else:
        want = np.asarray(conv(f32(xb))) + bias
        got, plan = _narrow_conv(xb, wb, torch.tensor(bias))
    assert plan.route == "narrow" and plan.dx == dx
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert np.abs(got.float().numpy() - want).max() <= (2.0 ** -8 + TOL) * scale
