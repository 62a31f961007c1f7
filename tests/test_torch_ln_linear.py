"""Port LayerNorm -> Linear (dpm_solver_tpu_torch/ops/ln_linear.py) against the JAX
`ln_linear`: its Pallas kernel `_fused_call` in interpret mode with explicit
blocks, and its XLA composition `ln_linear_reference`.

The port takes w in torch's Linear layout (n, d), the JAX function its
transpose (d, n). On the CPU the wrapper takes its plain version. fp32
within 1e-5; bf16 inputs within 2e-2, the JAX package's own kernel bound
(tests/test_ln_linear.py:32), since one bf16 rounding of the normalised rows
may fall on either side.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpm_solver_tpu.ops.ln_linear import layer_norm_fp32 as jax_layer_norm_fp32
from dpm_solver_tpu.ops.ln_linear import ln_linear as jax_ln_linear
from dpm_solver_tpu.ops.ln_linear import ln_linear_reference
from dpm_solver_tpu_torch.ops.ln_linear import layer_norm_fp32, ln_linear, ln_linear_plain

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _data(m, d, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (m, d)).astype(np.float32),
            rng.normal(1, 0.2, (d,)).astype(np.float32),
            rng.normal(0, 0.2, (d,)).astype(np.float32),
            rng.normal(0, d ** -0.5, (d, n)).astype(np.float32),
            rng.normal(0, 0.1, (n,)).astype(np.float32))


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret(dtype, bias):
    x, g, b, w, c = _data(128, 32, 96)
    c = c if bias else None
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_ln_linear(jnp.asarray(x, jdt), jnp.asarray(g), jnp.asarray(b),
                         jnp.asarray(w, jdt), None if c is None else jnp.asarray(c),
                         1e-5, 64, 32, True)  # block_m, block_n, interpret
    got = ln_linear(torch.tensor(x).to(tdt), torch.tensor(g), torch.tensor(b),
                    torch.tensor(w.T).to(tdt), None if c is None else torch.tensor(c))
    assert got.dtype == tdt and got.shape == (128, 96)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("shape", [(2, 37, 40, 70), (3, 5, 320, 960)],
                         ids=["ragged", "sd-qkv-width"])
def test_plain_matches_xla_reference(shape):
    *lead, d, n = shape
    x, g, b, w, c = _data(int(np.prod(lead)), d, n, seed=1)
    x = x.reshape(*lead, d)
    want = ln_linear_reference(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                               jnp.asarray(w), jnp.asarray(c))
    got = ln_linear_plain(*(torch.tensor(a) for a in (x, g, b, w.T, c)))
    assert got.shape == (*lead, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL["float32"])


def test_layer_norm_matches_jax_and_torch():
    x, g, b, _, _ = _data(16, 48, 8, seed=2)
    x = x * 3 + 5  # an offset mean: the two-pass variance matters
    got = layer_norm_fp32(torch.tensor(x), torch.tensor(g), torch.tensor(b))
    want = np.asarray(jax_layer_norm_fp32(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    ref = torch.nn.functional.layer_norm(torch.tensor(x), (48,), torch.tensor(g),
                                         torch.tensor(b), eps=1e-5)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)
