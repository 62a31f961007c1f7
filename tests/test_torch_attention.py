"""Port attention forward (dpm_solver_tpu_torch/ops/attention.py) against the JAX
`token_attention` with its Pallas path in interpret mode.

fp32 within 3e-6, the JAX package's own bound (tests/test_attention_kernel.py:26).
On the CPU the wrapper takes its plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpm_solver_tpu.ops.attention import token_attention as jax_token_attention
from dpm_solver_tpu_torch.ops.attention import attention_plain, token_attention

TOL = 3e-6


@pytest.mark.parametrize("b,t,s,heads,dh", [
    (2, 64, 64, 1, 32),     # tiny DDPM AttnBlock at 8x8
    (2, 16, 16, 1, 256),    # CIFAR mid AttnBlock at 4x4
    (2, 50, 77, 4, 32),     # multi-head, ragged cross-attention length
], ids=["tiny", "cifar-mid", "multihead-ragged"])
def test_plain_matches_pallas_interpret(b, t, s, heads, dh):
    rng = np.random.default_rng(0)
    q = rng.standard_normal((b, t, heads * dh)).astype(np.float32)
    k = rng.standard_normal((b, s, heads * dh)).astype(np.float32)
    v = rng.standard_normal((b, s, heads * dh)).astype(np.float32)
    scale = dh ** -0.5
    want = np.asarray(jax_token_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          num_heads=heads, scale=scale, interpret=True))
    got = token_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                          num_heads=heads, scale=scale).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_default_scale_and_dtype():
    rng = np.random.default_rng(1)
    q = torch.tensor(rng.standard_normal((1, 8, 64)).astype(np.float32))
    want = attention_plain(q, q, q, num_heads=2, scale=32 ** -0.5)
    torch.testing.assert_close(attention_plain(q, q, q, num_heads=2), want, rtol=0, atol=0)
    out = attention_plain(q.bfloat16(), q.bfloat16(), q.bfloat16(), num_heads=2)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
