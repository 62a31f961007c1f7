"""Port SpatialTransformer stack (dpm_solver_tpu_torch/models/transformer.py)
against the JAX module in fp32.

JAX-initialised parameters are carried into the port through
`spatial_transformer_state_dict_from_flax`. On the same x and context the two
agree within 2e-5, the JAX package's UNet bound (tests/test_models.py:64).
On the CPU the fused sites (ln_linear, geglu_ff, token_attention) take
their plain versions, which compute the JAX package's unfused composition.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpm_solver_tpu.models.transformer import SpatialTransformer as JaxSpatialTransformer
from dpm_solver_tpu_torch.models import SpatialTransformer
from dpm_solver_tpu_torch.utils.convert import spatial_transformer_state_dict_from_flax

TOL = 2e-5
C, HEADS, DIM_HEAD, CTX = 32, 2, 16, 24


@pytest.mark.parametrize("linear,depth,with_context", [
    (False, 1, True),    # SD-1: 1x1 conv projections, cross-attention on a context
    (True, 2, True),     # SD-2.x: linear projections, two blocks
    (True, 1, False),    # no context: attn2 attends to the tokens themselves
], ids=["conv-context", "linear-depth2", "linear-self"])
def test_forward_matches_jax(linear, depth, with_context):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 4, C)).astype(np.float32)
    ctx = rng.standard_normal((2, 7, CTX)).astype(np.float32) if with_context else None
    jmod = JaxSpatialTransformer(HEADS, DIM_HEAD, depth=depth, linear_proj=linear)
    jctx = None if ctx is None else jnp.asarray(ctx)
    params = jmod.init(jax.random.key(1), jnp.asarray(x), jctx)
    # the zero-initialised proj_out would hide the whole block: give it weights
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (jax.random.normal(jax.random.key(2), a.shape) * 0.2
                         if "proj_out" in jax.tree_util.keystr(path) else a), params)
    want = np.asarray(jmod.apply(params, jnp.asarray(x), jctx))
    port = SpatialTransformer(C, HEADS, DIM_HEAD, depth, CTX if with_context else None,
                              linear, device="cpu")
    port.load_state_dict(spatial_transformer_state_dict_from_flax(
        jax.tree.map(np.asarray, params)), strict=True)
    with torch.no_grad():
        got = port(torch.tensor(x), None if ctx is None else torch.tensor(ctx))
    assert got.shape == x.shape and got.dtype == torch.float32
    assert np.abs(want - x).max() > 0.1  # the blocks really contribute
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_reference_key_names():
    port = SpatialTransformer(C, HEADS, DIM_HEAD, 1, CTX, True, device="cpu")
    sd = port.state_dict()
    assert sd["transformer_blocks.0.attn2.to_k.weight"].shape == (HEADS * DIM_HEAD, CTX)
    assert sd["transformer_blocks.0.ff.net.0.proj.weight"].shape == (2 * 4 * C, C)
    assert sd["transformer_blocks.0.attn1.to_out.0.bias"].shape == (C,)
    assert "transformer_blocks.0.attn1.to_q.bias" not in sd  # bias-free q/k/v
    assert sd["proj_in.weight"].shape == (C, C)  # linear: rank 2
    conv = SpatialTransformer(C, HEADS, DIM_HEAD, 1, CTX, False, device="cpu")
    assert conv.state_dict()["proj_in.weight"].shape == (C, C, 1, 1)
