"""Port fused bias + scaled LeakyReLU (dpm_solver_tpu_torch/ops/fused_act.py)
against `dpm_solver_tpu/ops/fused_act.py`.

`bias_act_plain` (the CPU twin of the Triton kernels) against the XLA
composition `bias_act_xla` and the Pallas kernel in interpret mode, at any
rank, with ragged row counts and a non-default slope and scale; the port's
autograd (forward saves only the output, dx from its sign, db a row sum)
against `jax.grad` through the Pallas custom VJP. fp32 within 1e-6. The
Triton kernels themselves run on the card only (chip_smoke.py phase 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpm_solver_tpu.ops.fused_act import bias_act_xla
from dpm_solver_tpu.ops.fused_act import fused_bias_act as jax_fused_bias_act
from dpm_solver_tpu_torch import ops
from dpm_solver_tpu_torch.ops import fused_act

TOL = 1e-6
SHAPES = [(2, 9, 9, 64), (300, 3), (3, 5, 7, 20)]
SCALARS = [(0.2, 2 ** 0.5), (0.1, 1.7)]


def _data(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape[-1]).astype(np.float32))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("slope,scale", SCALARS)
def test_plain_matches_xla_and_pallas_interpret(shape, slope, scale):
    x, b = _data(shape)
    want = np.asarray(bias_act_xla(jnp.asarray(x), jnp.asarray(b), negative_slope=slope,
                                   scale=scale))
    pallas = np.asarray(jax_fused_bias_act(jnp.asarray(x), jnp.asarray(b), slope, scale, True))
    got = ops.bias_act_plain(torch.tensor(x), torch.tensor(b), slope, scale).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=TOL)
    wrapped = ops.fused_bias_act(torch.tensor(x), torch.tensor(b), slope, scale).numpy()
    np.testing.assert_array_equal(wrapped, got)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("slope,scale", SCALARS)
def test_gradients_match_pallas_custom_vjp(shape, slope, scale):
    x, b = _data(shape, seed=1)
    loss = lambda x_, b_: (jax_fused_bias_act(x_, b_, slope, scale, True) ** 2).sum()
    dx, db = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(b))
    xt, bt = torch.tensor(x, requires_grad=True), torch.tensor(b, requires_grad=True)
    (ops.fused_bias_act(xt, bt, slope, scale) ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx), rtol=0,
                               atol=TOL * np.abs(dx).max())
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(db), rtol=0,
                               atol=TOL * np.abs(db).max())


def test_backward_rebuilds_the_mask_from_the_output():
    x, b = _data((4, 16))
    out = ops.bias_act_plain(torch.tensor(x), torch.tensor(b), 0.1, 1.7)
    g = torch.ones_like(out)
    want = torch.where(torch.tensor(x + b) >= 0, 1.7, 0.17)
    torch.testing.assert_close(ops.fused_bias_act_bwd(g, out, 0.1, 1.7), want)


def test_bf16_plain_matches_xla():
    x, b = _data((8, 33), seed=2)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(bias_act_xla(xb, jnp.asarray(b)).astype(jnp.float32))
    got = ops.bias_act_plain(torch.tensor(x).bfloat16(), torch.tensor(b))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2, atol=1e-2)


def test_checks_refuse_what_the_kernels_do_not_take():
    x, b = torch.zeros(4, 8), torch.zeros(8)
    fused_act._check(x, b, "fused_bias_act")
    with pytest.raises(TypeError):
        fused_act._check(x.half(), b, "fused_bias_act")
    with pytest.raises(ValueError):
        fused_act._check(x.t(), b, "fused_bias_act")                     # not contiguous
    with pytest.raises(ValueError):
        fused_act._check(torch.zeros(4, 0), b, "fused_bias_act")         # no channels
    meta = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.fused_bias_act(meta, torch.zeros(8, device="meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.fused_bias_act_bwd(meta, meta)
