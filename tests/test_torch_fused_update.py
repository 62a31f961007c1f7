"""Port fused update (dpm_solver_tpu_torch/ops/fused_update.py) against the JAX
Pallas kernel `fused_solver_update`, run in interpret mode.

On the CPU the port's wrapper takes its plain version; both compute
a*x + b0*h0 + b1*h1 + b2*h2 (+ s*z) in fp32, within 1e-6; on bf16 tensors the
port rounds that fp32 sum once. The coefficients come from a row of a device
table, as the executor passes them. The launch grid (`fused_update_grid`)
stays within one wave at the paths' sizes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpm_solver_tpu.ops.fused_update import fused_solver_update
from dpm_solver_tpu_torch.ops.fused_update import (NUM_WARPS, WAVE, fused_update,
                                                   fused_update_grid, fused_update_plain)

TOL = 1e-6


@pytest.mark.parametrize("shape", [(2, 8, 8, 3), (1000,), (3, 5, 7)],
                         ids=["image", "ragged-1000", "ragged-105"])
@pytest.mark.parametrize("with_z", [False, True], ids=["ode", "sde"])
def test_plain_matches_pallas_interpret(shape, with_z):
    rng = np.random.default_rng(0)
    x, h0, h1, h2, z = (rng.standard_normal(shape).astype(np.float32) for _ in range(5))
    table = rng.standard_normal((4, 8)).astype(np.float32)
    row = 2
    a, b, s = table[row, 0], table[row, 1:4], table[row, 4]
    want = np.asarray(fused_solver_update(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(s), jnp.asarray(x),
        jnp.asarray(np.stack([h0, h1, h2])), jnp.asarray(z) if with_z else None,
        interpret=True))
    t = lambda u: torch.tensor(u)
    zt = t(z) if with_z else None
    got = fused_update(t(table), row, t(x), t(h0), t(h1), t(h2), zt).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    plain = fused_update_plain(t(table), row, t(x), t(h0), t(h1), t(h2), zt).numpy()
    np.testing.assert_array_equal(got, plain)


@pytest.mark.parametrize("shape", [(2, 8, 8, 3), (1000,), (3, 5, 7)],
                         ids=["image", "ragged-1000", "ragged-105"])
@pytest.mark.parametrize("with_z", [False, True], ids=["ode", "sde"])
def test_bf16_is_one_rounding_of_the_fp32_sum(shape, with_z):
    """bf16 tensors: the arithmetic in fp32 and one rounding of the result.
    The Pallas kernel run in fp32 (interpret mode) on the same bf16 values
    gives the sum; the port's bf16 result lies within half a bf16 unit in
    the last place of it (2^-8 relative, plus the fp32 bound), which a
    second rounding (bf16 products or partial sums) would exceed."""
    rng = np.random.default_rng(1)
    vals = [torch.tensor(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)
            for _ in range(5)]
    x, h0, h1, h2, z = vals
    table = rng.standard_normal((4, 8)).astype(np.float32)
    row = 1
    a, b, s = table[row, 0], table[row, 1:4], table[row, 4]
    f32 = lambda u: jnp.asarray(u.float().numpy())
    want = np.asarray(fused_solver_update(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(s), f32(x),
        jnp.stack([f32(h0), f32(h1), f32(h2)]), f32(z) if with_z else None, interpret=True))
    got = fused_update(torch.tensor(table), row, x, h0, h1, h2, z if with_z else None)
    assert got.dtype == torch.bfloat16 and got.shape == shape
    err = np.abs(got.float().numpy() - want)
    assert (err <= 2.0 ** -8 * np.abs(want) + TOL).all()


def test_grid_stays_within_one_wave_at_the_paths_sizes():
    """`fused_update_grid` at the paths' tensors (A: CIFAR b64; B: SD-2.1
    latents b4 at 96x96; C: guided b8 at 256x256; D: DDPM++ b256), fp32 and
    bf16: at most one wave of programs, the blocks covering the tensor with
    no program past it, and the fewest blocks a program that does."""
    for n in (64 * 32 * 32 * 3, 4 * 96 * 96 * 4, 8 * 256 * 256 * 3, 256 * 32 * 32 * 3):
        for itemsize in (4, 2):
            programs, iters, block = fused_update_grid(n, itemsize)
            assert block == 16 // itemsize * 32 * NUM_WARPS
            assert programs <= WAVE
            assert programs * iters * block >= n > (programs - 1) * iters * block
            assert iters == 1 or -(-n // (block * (iters - 1))) > WAVE
