"""Port fused update (dpm_solver_tpu_torch/ops/fused_update.py) against the JAX
Pallas kernel `fused_solver_update`, run in interpret mode.

On the CPU the port's wrapper takes its plain version; both compute
a*x + b0*h0 + b1*h1 + b2*h2 (+ s*z) in fp32, within 1e-6. The coefficients
come from a row of a device table, as the executor passes them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpm_solver_tpu.ops.fused_update import fused_solver_update
from dpm_solver_tpu_torch.ops.fused_update import fused_update, fused_update_plain

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
