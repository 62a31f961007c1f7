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
