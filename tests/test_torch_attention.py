"""Port attention forward (dpm_solver_tpu_torch/ops/attention.py) against the JAX
`token_attention` with its Pallas path in interpret mode, and against each
streamed Pallas forward the port's one kernel stands in for
(`flash_attention` -> `_flash_forward`, `flash_attention_t` ->
`_flash_forward_T`, `fused_attention_t` -> `_panel_forward_T`), called
directly in interpret mode with small blocks.

fp32 within 3e-6, the JAX package's own bound (tests/test_attention_kernel.py:26).
On the CPU the wrapper takes its plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpm_solver_tpu.ops.attention import flash_attention, flash_attention_t, fused_attention_t
from dpm_solver_tpu.ops.attention import token_attention as jax_token_attention
from dpm_solver_tpu_torch.ops.attention import attention_plain, token_attention

TOL = 3e-6


@pytest.mark.parametrize("b,t,s,heads,dh", [
    (2, 64, 64, 1, 32),     # tiny DDPM AttnBlock at 8x8
    (2, 16, 16, 1, 256),    # CIFAR mid AttnBlock at 4x4
    (2, 50, 77, 4, 32),     # multi-head, ragged cross-attention length
    (2, 64, 64, 2, 40),     # SD-1's head dims: self-attention at dh 40,
    (2, 40, 77, 2, 80),     # cross-attention to 77 tokens at dh 80,
    (1, 33, 33, 2, 160),    # and a ragged length at dh 160
], ids=["tiny", "cifar-mid", "multihead-ragged", "sd1-dh40", "sd1-cross-dh80", "sd1-dh160"])
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


def _bh(u, heads):
    """(B, T, H*dh) head-major -> the Pallas kernels' (B*H, T, dh)."""
    b, t, inner = u.shape
    return u.reshape(b, t, heads, inner // heads).transpose(0, 2, 1, 3).reshape(b * heads, t, -1)


_STREAMED = {
    "flash": lambda q, k, v, s: flash_attention(q, k, v, s, 16, 32, True),
    "flash_t": lambda q, k, v, s: flash_attention_t(q, k, v, s, 32, 32, True),
    "panel_t": lambda q, k, v, s: fused_attention_t(q, k, v, s, 32, True),
}


@pytest.mark.parametrize("kernel,b,t,s,heads,dh", [
    ("flash", 2, 50, 77, 2, 64),     # SD cross-attention: 77 context tokens
    ("flash", 1, 40, 40, 1, 512),    # the VAE's single 512-wide head
    ("flash_t", 1, 96, 96, 2, 64),   # SD self-attention, dh = 64
    ("panel_t", 1, 96, 96, 2, 64),
    ("flash", 2, 50, 77, 2, 40),     # SD-1: cross-attention at dh 40,
    ("flash_t", 1, 96, 96, 2, 80),   # self-attention at dh 80 and 160
    ("panel_t", 1, 64, 64, 2, 160),
], ids=["flash-cross-s77", "flash-vae-dh512", "flash_t-self-dh64", "panel_t-self-dh64",
        "flash-cross-dh40", "flash_t-self-dh80", "panel_t-self-dh160"])
def test_plain_matches_streamed_pallas_interpret(kernel, b, t, s, heads, dh):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((b, t, heads * dh)).astype(np.float32)
    k = rng.standard_normal((b, s, heads * dh)).astype(np.float32)
    v = rng.standard_normal((b, s, heads * dh)).astype(np.float32)
    scale = dh ** -0.5
    out = _STREAMED[kernel](*(jnp.asarray(_bh(u, heads)) for u in (q, k, v)), scale)
    want = np.asarray(out).reshape(b, heads, t, dh).transpose(0, 2, 1, 3).reshape(b, t, -1)
    got = token_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                          num_heads=heads, scale=scale).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_fused_qkv_column_slices():
    """q, k, v as column slices of one (B, T, 3C) tensor (row stride 3C), as
    the VAE and the self-attention pass them, give the contiguous result."""
    qkv = torch.tensor(np.random.default_rng(3).standard_normal((2, 24, 3 * 128)),
                       dtype=torch.float32)
    q, k, v = qkv.split(128, dim=-1)
    assert q.stride() == (24 * 384, 384, 1)
    want = token_attention(q.contiguous(), k.contiguous(), v.contiguous(), num_heads=2)
    torch.testing.assert_close(token_attention(q, k, v, num_heads=2), want, rtol=0, atol=0)
