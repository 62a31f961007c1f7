"""Port DDPM UNet (dpm_solver_tpu_torch/models/ddpm_unet.py) against the JAX model.

JAX-initialised parameters are carried into the port through
`ddpm_unet_state_dict_from_flax`; on the same x and fractional t the two fp32
forwards agree within 2e-5, the JAX package's own bound against the reference
torch model (tests/test_models.py:64). The state-dict round trip through the
JAX package's `convert_ddpm_unet` and back is exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpm_solver_tpu.models import DDPMUNet as JaxDDPMUNet
from dpm_solver_tpu.models import DDPMUNetConfig as JaxConfig
from dpm_solver_tpu.utils.convert import convert_ddpm_unet
from dpm_solver_tpu_torch.models import DDPMUNet, DDPMUNetConfig, init_random_
from dpm_solver_tpu_torch.utils.convert import ddpm_unet_state_dict_from_flax

TOL = 2e-5


@pytest.fixture(scope="module")
def jax_tiny():
    """The tiny JAX model, its params (eager init: no whole-UNet compile) and one input."""
    cfg = JaxConfig.tiny(resolution=16)
    model = JaxDDPMUNet(cfg)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    t = np.asarray([17.0, 431.5], dtype=np.float32)  # incl. a fractional label
    params = model.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(t))
    return model, jax.tree.map(np.asarray, params), x, t


def test_forward_matches_jax(jax_tiny):
    model, params, x, t = jax_tiny
    want = np.asarray(jax.jit(model.apply)(params, jnp.asarray(x), jnp.asarray(t)))
    port = DDPMUNet(DDPMUNetConfig.tiny(resolution=16), device="cpu")
    port.load_state_dict(ddpm_unet_state_dict_from_flax(params), strict=True)
    with torch.no_grad():
        got = port(torch.tensor(x), torch.tensor(t))
    assert got.dtype == torch.float32 and got.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_state_dict_names_and_shapes_match_jax_params(jax_tiny):
    _, params, _, _ = jax_tiny
    port = DDPMUNet(DDPMUNetConfig.tiny(resolution=16), device="cpu")
    carried = ddpm_unet_state_dict_from_flax(params)
    ours = port.state_dict()
    assert set(carried) == set(ours)
    assert all(carried[k].shape == ours[k].shape for k in ours)
    assert "temb.dense.0.weight" in ours and "mid.attn_1.q.weight" in ours
    assert ours["down.0.block.0.conv1.weight"].shape == (32, 32, 3, 3)  # OIHW


def test_round_trip_through_jax_converter_is_exact():
    port = init_random_(DDPMUNet(DDPMUNetConfig.tiny(), device="cpu"),
                        torch.Generator().manual_seed(3))
    sd = port.state_dict()
    flax_params = convert_ddpm_unet({k: v.numpy() for k, v in sd.items()})
    back = ddpm_unet_state_dict_from_flax(flax_params)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_unconditional_avgpool_variant_matches_jax():
    """`conditional=False` (no time embedding) and `resamp_with_conv=False`
    (average-pool down, bare nearest up): weights from one torch init carried
    into the JAX model by its own converter; JAX runs un-jitted (no compile)."""
    kw = dict(conditional=False, resamp_with_conv=False)
    cfg = dataclasses.replace(DDPMUNetConfig.tiny(8), **kw)
    port = init_random_(DDPMUNet(cfg, device="cpu"), torch.Generator().manual_seed(1)).eval()
    params = convert_ddpm_unet({k: v.numpy() for k, v in port.state_dict().items()})
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    t = np.asarray([3.0, 500.0], dtype=np.float32)
    want = np.asarray(JaxDDPMUNet(dataclasses.replace(JaxConfig.tiny(8), **kw)).apply(
        params, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = port(torch.tensor(x), torch.tensor(t)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_cifar10_config_matches_jax():
    ours, theirs = DDPMUNetConfig.cifar10(), JaxConfig.cifar10()
    for f in ("ch", "out_ch", "ch_mult", "num_res_blocks", "attn_resolutions",
              "in_channels", "resolution", "resamp_with_conv", "conditional"):
        assert getattr(ours, f) == getattr(theirs, f), f
    n = sum(p.numel() for p in DDPMUNet(ours, device="cpu").parameters())
    assert 35_600_000 < n < 35_800_000  # the CIFAR-10 DDPM's 35.7M parameters


PRESETS = ("cifar10", "celeba", "lsun256")


@pytest.mark.parametrize("preset", PRESETS)
def test_preset_fields_match_jax(preset):
    ours, theirs = getattr(DDPMUNetConfig, preset)(), getattr(JaxConfig, preset)()
    assert [f.name for f in dataclasses.fields(ours)] == \
        [f.name for f in dataclasses.fields(theirs)]
    for f in dataclasses.fields(theirs):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name


@pytest.mark.parametrize("preset", ("celeba", "lsun256"))
def test_preset_forward_matches_jax(preset):
    """One forward of each preset at its own ch_mult and resolution, cut to
    32 channels a unit and one ResnetBlock a level: weights from one torch
    init carried into the JAX model by its own converter (jitted: the
    compile takes less than the op-by-op run)."""
    cut = dict(ch=32, num_res_blocks=1, dropout=0.0)
    cfg = dataclasses.replace(getattr(DDPMUNetConfig, preset)(), **cut)
    port = init_random_(DDPMUNet(cfg, device="cpu"), torch.Generator().manual_seed(4)).eval()
    params = convert_ddpm_unet({k: v.numpy() for k, v in port.state_dict().items()})
    rng = np.random.default_rng(4)
    res = cfg.resolution
    x = rng.standard_normal((1, res, res, 3)).astype(np.float32)
    t = np.asarray([271.5], dtype=np.float32)
    model = JaxDDPMUNet(dataclasses.replace(getattr(JaxConfig, preset)(), **cut))
    want = np.asarray(jax.jit(model.apply)(params, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = port(torch.tensor(x), torch.tensor(t)).numpy()
    assert got.shape == (1, res, res, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
