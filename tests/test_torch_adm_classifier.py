"""Port ADM classifier (dpm_solver_tpu_torch/models/adm_unet.py::ADMClassifier,
AttentionPool2d, super_res_inputs) against the JAX models in fp32.

JAX-initialised parameters (every leaf perturbed) are carried into the port
through `adm_classifier_state_dict_from_flax`; for each of the four pooling
heads the two forwards agree within 2e-5 (the UNet bound,
tests/test_models.py:64), and the state-dict round trip through the JAX
package's `convert_adm_unet(..., classifier=True)` and back is exact. The
classifier's input gradient, the quantity classifier guidance uses, is held
to `jax.grad` of the JAX classifier within 2e-5 of its largest entry.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dpm_solver_tpu.models.adm_unet import ADMClassifier as JaxADMClassifier
from dpm_solver_tpu.models.adm_unet import ADMConfig as JaxConfig
from dpm_solver_tpu.models.adm_unet import super_res_inputs as jax_super_res_inputs
from dpm_solver_tpu.utils.convert import convert_adm_unet
from dpm_solver_tpu_torch.models import (ADMClassifier, ADMConfig, init_random_, layout,
                                         super_res_inputs)
from dpm_solver_tpu_torch.utils.convert import adm_classifier_state_dict_from_flax

TOL = 2e-5
# the guided classifier's flags at a tiny width: scale-shift norm, resblock
# up/down, heads by channel count, legacy attention order
BASE = dict(image_size=16, model_channels=32, out_channels=10, num_res_blocks=1,
            attention_resolutions=(2, 4), channel_mult=(1, 2, 2), num_head_channels=16,
            use_scale_shift_norm=True, resblock_updown=True)
POOLS = ("adaptive", "attention", "spatial", "spatial_v2")


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


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    return x, np.asarray([17.0, 431.5], dtype=np.float32)


def _carried(pool):
    """A JAX classifier with perturbed params and the port carrying them."""
    kw = dict(BASE, pool=pool)
    x, t = _inputs()
    jmodel = JaxADMClassifier(JaxConfig(**kw))
    params = _randomize(jmodel.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(t)), 1)
    port = ADMClassifier(ADMConfig(**kw), device="cpu")
    port.load_state_dict(adm_classifier_state_dict_from_flax(params, ADMConfig(**kw)),
                         strict=True)
    return jmodel, params, port.eval()


@pytest.mark.parametrize("pool", POOLS)
def test_forward_matches_jax(pool):
    jmodel, params, port = _carried(pool)
    x, t = _inputs()
    want = np.asarray(jmodel.apply(params, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = port(torch.tensor(x), torch.tensor(t))
    assert got.dtype == torch.float32 and got.shape == (2, BASE["out_channels"])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("pool", POOLS)
def test_round_trip_through_jax_converter_is_exact(pool):
    cfg = ADMConfig(**BASE, pool=pool)
    sd = init_random_(ADMClassifier(cfg, device="cpu"),
                      torch.Generator().manual_seed(3)).state_dict()
    flax_params = convert_adm_unet({k: v.numpy() for k, v in sd.items()},
                                   JaxConfig(**BASE, pool=pool), classifier=True)
    back = adm_classifier_state_dict_from_flax(flax_params, cfg)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("pool", ["attention", "adaptive"])
def test_input_gradient_matches_jax_grad(pool):
    """grad_x sum(log_softmax(logits)[y]), with the port's parameters frozen."""
    jmodel, params, port = _carried(pool)
    x, t = _inputs(seed=2)
    y = np.asarray([3, 7])

    def log_prob_sum(xx):
        logits = jmodel.apply(params, xx, jnp.asarray(t))
        return jnp.sum(jax.nn.log_softmax(logits, axis=-1)[jnp.arange(2), y])

    want = np.asarray(jax.jit(jax.grad(log_prob_sum))(jnp.asarray(x)))
    port.requires_grad_(False)
    xt = torch.tensor(x, requires_grad=True)
    logp = F.log_softmax(port(xt, torch.tensor(t)), dim=-1)[torch.arange(2), torch.tensor(y)]
    got, = torch.autograd.grad(logp.sum(), xt)
    assert all(p.grad is None for p in port.parameters())
    np.testing.assert_allclose(got.numpy() / np.abs(want).max(), want / np.abs(want).max(),
                               rtol=0, atol=TOL)


def test_guided_classifier_shapes_and_parameter_count():
    """The ImageNet-256 guided classifier of `configs.py` (imagenet256_guided):
    a 54.1M-parameter encoder with an attention pool over the 8x8 map."""
    cfg = dataclasses.replace(ADMConfig.imagenet256_guided(), model_channels=128,
                              num_res_blocks=2, out_channels=1000, pool="attention",
                              num_classes=None, resblock_updown=True,
                              use_scale_shift_norm=True)
    net = ADMClassifier(cfg, device="meta")
    assert sum(p.numel() for p in net.parameters()) == 54_096_360
    assert net.out[2].positional_embedding.shape == (512, 65)
    assert net.out[2].num_heads == 8
    jcfg = dataclasses.replace(JaxConfig.imagenet256_guided(), model_channels=128,
                               num_res_blocks=2, out_channels=1000, pool="attention",
                               num_classes=None)
    from dpm_solver_tpu.models.adm_unet import layout as jax_layout
    assert layout(cfg, encoder_only=True) == jax_layout(jcfg, encoder_only=True)


def test_super_res_inputs_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    low = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    want = np.asarray(jax_super_res_inputs(jnp.asarray(x), jnp.asarray(low)))
    got = super_res_inputs(torch.tensor(x), torch.tensor(low)).numpy()
    assert got.shape == (2, 16, 16, 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
