"""Port GEGLU feed-forward (dpm_solver_tpu_torch/ops/geglu.py) against the JAX
`geglu_ff`: its Pallas kernel `_geglu_pallas` forced on in interpret mode,
and its XLA composition `_ref_impl`.

The port takes w1 and w2 in torch's Linear layout, the JAX function their
transposes. On the CPU the wrapper takes its plain version. fp32 within
1e-4, the JAX package's own kernel bound (tests/test_geglu.py:38-39); bf16
within 2e-2 (a bf16 rounding of the gated tile and of the output may fall on
either side).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpm_solver_tpu.ops.geglu import _gelu_exact, _ref_impl
from dpm_solver_tpu.ops.geglu import geglu_ff as jax_geglu_ff
from dpm_solver_tpu_torch.ops.geglu import geglu_ff, geglu_plain, gelu_exact

TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _make(m, d, inner, seed=0):
    rs = np.random.default_rng(seed)
    return (rs.standard_normal((m, d)).astype(np.float32),
            (rs.standard_normal((d, 2 * inner)) * 0.05).astype(np.float32),
            (rs.standard_normal((2 * inner,)) * 0.1).astype(np.float32),
            (rs.standard_normal((inner, d)) * 0.05).astype(np.float32),
            (rs.standard_normal((d,)) * 0.1).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(128, 32, 128), (128, 64, 256)], ids=["one-tile", "two-tiles"])
def test_plain_matches_pallas_interpret(shape, dtype):
    x, w1, b1, w2, b2 = _make(*shape)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_geglu_ff(jnp.asarray(x, jdt), jnp.asarray(w1), jnp.asarray(b1),
                        jnp.asarray(w2), jnp.asarray(b2), True, True)  # force, interpret
    got = geglu_ff(torch.tensor(x).to(tdt), torch.tensor(w1.T).to(tdt), torch.tensor(b1),
                   torch.tensor(w2.T).to(tdt), torch.tensor(b2))
    assert got.dtype == tdt and got.shape == x.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=TOL[dtype])


def test_plain_matches_xla_reference_leading_dims():
    x, w1, b1, w2, b2 = _make(2 * 45, 40, 100, seed=1)  # ragged rows and widths
    xb = x.reshape(2, 45, 40)
    want = _ref_impl(*(jnp.asarray(a) for a in (xb, w1, b1, w2, b2)))
    got = geglu_plain(*(torch.tensor(a) for a in (xb, w1.T, b1, w2.T, b2)))
    assert got.shape == xb.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL["float32"])


def test_gelu_is_the_exact_one():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    got = gelu_exact(torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(_gelu_exact(jnp.asarray(x))),
                               rtol=0, atol=1e-6)
    torch.testing.assert_close(got, torch.nn.functional.gelu(torch.tensor(x)), rtol=0, atol=1e-6)
