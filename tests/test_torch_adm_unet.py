"""Port ADM / Stable Diffusion UNet (dpm_solver_tpu_torch/models/adm_unet.py)
against the JAX model in fp32.

JAX-initialised parameters (every leaf perturbed, so no zero-initialised
layer hides a block) are carried into the port through
`adm_unet_state_dict_from_flax`; on the same x, fractional t, labels and
context the two forwards agree within 2e-5, the JAX package's UNet bound
(tests/test_models.py:64). The state-dict round trip through the JAX
package's `convert_adm_unet` and back is exact, and both packages plan the
same layout (the reference's mutable-num_heads quirk included) for every
preset.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpm_solver_tpu.models.adm_unet import ADMConfig as JaxConfig
from dpm_solver_tpu.models.adm_unet import ADMUNet as JaxADMUNet
from dpm_solver_tpu.models.adm_unet import layout as jax_layout
from dpm_solver_tpu.utils.convert import convert_adm_unet
from dpm_solver_tpu_torch.models import ADMConfig, ADMUNet, init_random_, layout
from dpm_solver_tpu_torch.utils.convert import adm_unet_state_dict_from_flax

TOL = 2e-5
CONFIGS = {
    # the tiny SD UNet of tests/test_sd_pipeline.py: legacy heads, conv projections
    "sd-tiny": dict(image_size=8, in_channels=4, model_channels=32, out_channels=4,
                    num_res_blocks=1, attention_resolutions=(1, 2), channel_mult=(1, 2),
                    num_heads=2, use_spatial_transformer=True, transformer_depth=1,
                    context_dim=24),
    # SD-2.x shape: heads by channel count, linear projections, legacy=False
    "sd2-tiny": dict(image_size=8, in_channels=4, model_channels=32, out_channels=4,
                     num_res_blocks=1, attention_resolutions=(1, 2), channel_mult=(1, 2),
                     num_heads=-1, num_head_channels=16, use_spatial_transformer=True,
                     transformer_depth=1, context_dim=24, use_linear_in_transformer=True,
                     legacy=False),
    # guided-diffusion ADM: scale-shift norm, resblock up/down, class labels
    "adm-updown": dict(image_size=8, model_channels=32, num_res_blocks=1,
                       attention_resolutions=(2,), channel_mult=(1, 2), num_heads=2,
                       use_scale_shift_norm=True, resblock_updown=True, num_classes=5),
    # qkv-major attention, heads by channel count, conv-free resampling
    "adm-new-order": dict(image_size=8, model_channels=32, num_res_blocks=1,
                          attention_resolutions=(1, 2), channel_mult=(1, 2),
                          num_head_channels=16, use_new_attention_order=True,
                          conv_resample=False),
}


def _randomize(params, seed):
    leaves, tree = jax.tree.flatten(params)
    rng = np.random.default_rng(seed)
    out = []
    for a in leaves:
        a = np.asarray(a)
        fan_in = int(np.prod(a.shape[:-1])) if a.ndim > 1 else 1
        scale = 0.5 / np.sqrt(fan_in) if a.ndim > 1 else 0.05
        out.append((a + scale * rng.standard_normal(a.shape)).astype(np.float32))
    return jax.tree.unflatten(tree, out)


def _inputs(kw, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, kw["image_size"], kw["image_size"],
                             kw.get("in_channels", 3))).astype(np.float32)
    t = np.asarray([17.0, 431.5], dtype=np.float32)
    y = np.asarray([1, 3], dtype=np.int32) if kw.get("num_classes") else None
    ctx = (rng.standard_normal((2, 7, kw["context_dim"])).astype(np.float32)
           if kw.get("context_dim") else None)
    return x, t, y, ctx


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_jax(name):
    kw = CONFIGS[name]
    x, t, y, ctx = _inputs(kw)
    jmodel = JaxADMUNet(JaxConfig(**kw))
    j = lambda a: None if a is None else jnp.asarray(a)
    params = _randomize(jmodel.init(jax.random.key(0), j(x), j(t), j(y), j(ctx)), 1)
    want = np.asarray(jmodel.apply(params, j(x), j(t), j(y), j(ctx)))
    port = ADMUNet(ADMConfig(**kw), device="cpu")
    port.load_state_dict(adm_unet_state_dict_from_flax(params, ADMConfig(**kw)), strict=True)
    tt = lambda a: None if a is None else torch.tensor(a)
    with torch.no_grad():
        got = port(tt(x), tt(t), None if y is None else tt(y).long(), tt(ctx))
    assert got.dtype == torch.float32 and got.shape == x.shape[:3] + (port.config.out_channels,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("name", ["sd2-tiny", "adm-updown"])
def test_round_trip_through_jax_converter_is_exact(name):
    cfg = ADMConfig(**CONFIGS[name])
    sd = init_random_(ADMUNet(cfg, device="cpu"), torch.Generator().manual_seed(3)).state_dict()
    flax_params = convert_adm_unet({k: v.numpy() for k, v in sd.items()},
                                   JaxConfig(**CONFIGS[name]))
    back = adm_unet_state_dict_from_flax(flax_params, cfg)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


PRESETS = ["sd_v1", "sd_v2_1", "cin256", "rdm_768", "imagenet64_iddpm", "imagenet128_guided",
           "imagenet256_guided", "imagenet512_guided", "lsun_bedroom_guided"]


@pytest.mark.parametrize("preset", PRESETS)
def test_presets_and_layout_match_jax(preset):
    ours, theirs = getattr(ADMConfig, preset)(), getattr(JaxConfig, preset)()
    assert dataclasses.asdict(ours) == {f: getattr(theirs, f) for f in dataclasses.asdict(ours)}
    # the JAX-only fields (training remat, int8 quant, classifier pooling) stay at
    # their defaults in every preset, so the port's config loses nothing
    assert (theirs.remat, theirs.quant, theirs.pool) == (False, None, "adaptive")
    assert layout(ours) == jax_layout(theirs)


def test_sd_v2_1_parameter_count():
    net = ADMUNet(ADMConfig.sd_v2_1(), device="meta")
    n = sum(p.numel() for p in net.parameters())
    assert n == 865_910_724  # the SD-2.1 UNet
    spec = layout(ADMConfig.sd_v2_1())["middle"][1]
    assert spec == dict(kind="xattn", heads=20, dim_head=64, depth=1, linear=True)
