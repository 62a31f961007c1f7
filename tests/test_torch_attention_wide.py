"""Port attention forward and its lse (dpm_solver_tpu_torch/ops/attention.py) at
the head dims the wide presets produce, against the JAX `token_attention`.

The class-conditional LDM (`ADMConfig.cin256()`: one head at every
transformer) attends with dh 384, 576 and 960, and its cross-attention to
the one class token has S = 1; the ADM ImageNet-64 and -128 presets give dh
96 and 192. On the CPU the wrapper takes its plain version: here it is held
to the JAX XLA composition at each such site (and S = 1), and to the Pallas
path in interpret mode at one small shape of each wide head, within 3e-6
(the JAX package's fp32 bound, tests/test_attention_kernel.py:26); the lse
to the Pallas `_lse` within the same bound. The kernels' tiles at these head
dims are tests/test_torch_kernel_plans.py's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpm_solver_tpu.ops.attention import _lse
from dpm_solver_tpu.ops.attention import token_attention as jax_token_attention
from dpm_solver_tpu_torch.models import ADMConfig, layout
from dpm_solver_tpu_torch.ops.attention import (FWD_HEAD_DIMS, attention_lse,
                                                attention_lse_plain, token_attention)

TOL = 3e-6
# (b, t, s, heads, dh): cin256's self- and cross-attention at CFG b2, cut to
# small T (the 32x32, 16x16 and 8x8 levels' head dims), ragged lengths, and
# the ADM ImageNet presets' dh 96 and 192
SITES = [(2, 64, 64, 1, 384), (2, 64, 1, 1, 384), (2, 16, 16, 1, 576), (2, 16, 1, 1, 576),
         (2, 8, 8, 1, 960), (2, 8, 1, 1, 960), (1, 13, 37, 1, 960), (1, 33, 7, 1, 576),
         (2, 40, 40, 4, 96), (2, 24, 77, 4, 192)]
INTERPRET = [(1, 16, 16, 1, 384), (1, 8, 1, 1, 576), (1, 8, 8, 1, 960)]


def _inputs(b, t, s, heads, dh, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, t, heads * dh), (b, s, heads * dh), (b, s, heads * dh)))


@pytest.mark.parametrize("b,t,s,heads,dh", SITES, ids=str)
def test_forward_matches_jax_xla(b, t, s, heads, dh):
    q, k, v = _inputs(b, t, s, heads, dh)
    want = np.asarray(jax_token_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          num_heads=heads, use_pallas=False))
    got = token_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), num_heads=heads)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    if s == 1:  # one key: every query takes v itself
        np.testing.assert_allclose(got.numpy(), np.broadcast_to(v, got.shape), rtol=0, atol=TOL)


@pytest.mark.parametrize("b,t,s,heads,dh", INTERPRET, ids=str)
def test_forward_matches_pallas_interpret(b, t, s, heads, dh):
    q, k, v = _inputs(b, t, s, heads, dh, seed=1)
    want = np.asarray(jax_token_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          num_heads=heads, interpret=True))
    got = token_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), num_heads=heads)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("b,t,s,heads,dh", SITES[:6], ids=str)
def test_lse_matches_pallas_lse(b, t, s, heads, dh):
    q, k, v = _inputs(b, t, s, heads, dh, seed=2)
    scale = dh ** -0.5
    qh, kh = (jnp.asarray(u).reshape(b, -1, heads, dh).transpose(0, 2, 1, 3)
              .reshape(b * heads, -1, dh) for u in (q, k))
    want = np.asarray(_lse(qh, kh, scale, 8, True))
    got = attention_lse_plain(torch.tensor(q), torch.tensor(k), num_heads=heads)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    o, lse = attention_lse(torch.tensor(q), torch.tensor(k), torch.tensor(v), num_heads=heads)
    torch.testing.assert_close(lse, got, rtol=0, atol=0)
    torch.testing.assert_close(o, token_attention(torch.tensor(q), torch.tensor(k),
                                                  torch.tensor(v), num_heads=heads),
                               rtol=0, atol=0)


def test_every_preset_head_dim_is_a_forward_head_dim():
    """Every attention of the ADM presets (cin256's 384/576/960 included) has
    a head dim the forward kernel takes."""
    dims = set()
    for name in ("imagenet256_guided", "sd_v1", "sd_v2_1", "cin256", "rdm_768",
                 "imagenet64_iddpm", "imagenet128_guided", "imagenet512_guided",
                 "lsun_bedroom_guided"):
        cfg = getattr(ADMConfig, name)()
        plan, ch = layout(cfg), None
        for spec in [s for blocks in plan["input_blocks"] + [plan["middle"]]
                     + plan["output_blocks"] for s in blocks]:
            ch = spec.get("out_ch", ch)  # an attention block keeps its input's channels
            if spec["kind"] == "xattn":
                dims.add(spec["dim_head"])
            elif spec["kind"] == "attn":
                dims.add(ch // spec["heads"])
    assert {384, 576, 960, 96, 192} <= dims <= set(FWD_HEAD_DIMS)
