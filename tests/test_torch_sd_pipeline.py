"""Port Stable Diffusion txt2img (dpm_solver_tpu_torch/pipelines) against the JAX
pipeline, on the tiny UNet and VAE of tests/test_sd_pipeline.py.

JAX-initialised weights (every leaf perturbed, so no zero-initialised layer
hides a block) go into the port through its converters; the same x_T and the
same hermetic prompt contexts go through both packages: CFG at scale 7.5,
DPM-Solver++ 2M multistep on the time-uniform grid, then the VAE decode. The
images agree within 1e-4 of max|x|, the repo's trajectory bound
(tests/test_solver_parity.py:70-75).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpm_solver_tpu.models.adm_unet import ADMConfig as JaxADMConfig
from dpm_solver_tpu.models.adm_unet import ADMUNet as JaxADMUNet
from dpm_solver_tpu.models.text_encoder import constant_context_encoder as jax_encoder
from dpm_solver_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from dpm_solver_tpu.models.vae import VAEConfig as JaxVAEConfig
from dpm_solver_tpu.pipelines import LatentDiffusion as JaxLatentDiffusion
from dpm_solver_tpu.pipelines import StableDiffusionPipeline as JaxPipeline
from dpm_solver_tpu_torch.models import (ADMConfig, ADMUNet, AutoencoderKL, VAEConfig,
                                         constant_context_encoder)
from dpm_solver_tpu_torch.pipelines import (LatentDiffusion, StableDiffusionPipeline,
                                            make_ldm_betas)
from dpm_solver_tpu_torch.utils.convert import (adm_unet_state_dict_from_flax,
                                                autoencoder_kl_state_dict_from_flax)

TRAJ_BOUND = 1e-4
CTX = 24
UNET = dict(image_size=8, in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1,
            attention_resolutions=(1, 2), channel_mult=(1, 2), num_heads=2,
            use_spatial_transformer=True, transformer_depth=1, context_dim=CTX)
VAE = dict(resolution=16, attn_resolutions=())
PROMPTS = ["a tiny astronaut", "a teapot"]


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


@pytest.fixture(scope="module")
def weights():
    unet, vae = JaxADMUNet(JaxADMConfig(**UNET)), JaxAutoencoderKL(config=JaxVAEConfig.tiny(**VAE))
    k = jax.random.PRNGKey(0)
    up = _randomize(unet.init(k, jnp.zeros((1, 8, 8, 4)), jnp.ones((1,)), None,
                              jnp.zeros((1, 7, CTX)), deterministic=True), 1)
    vp = _randomize(vae.init(k, jnp.zeros((1, 16, 16, 3))), 2)
    return unet, up, vae, vp


def _pipelines(weights, parameterization):
    unet, up, vae, vp = weights
    jax_pipe = JaxPipeline(JaxLatentDiffusion(
        unet=unet, unet_params=up, vae=vae, vae_params=vp, text_encode=jax_encoder(CTX),
        parameterization=parameterization))
    ucfg, vcfg = ADMConfig(**UNET), VAEConfig.tiny(**VAE)
    port_unet = ADMUNet(ucfg, device="cpu").eval()
    port_unet.load_state_dict(adm_unet_state_dict_from_flax(jax.tree.map(np.asarray, up), ucfg))
    port_vae = AutoencoderKL(vcfg, device="cpu").eval()
    port_vae.load_state_dict(autoencoder_kl_state_dict_from_flax(
        jax.tree.map(np.asarray, vp), vcfg))
    port_pipe = StableDiffusionPipeline(
        LatentDiffusion(port_unet, port_vae, text_encode=constant_context_encoder(CTX),
                        parameterization=parameterization), device="cpu")
    return jax_pipe, port_pipe


@pytest.mark.parametrize("parameterization", ["eps", "v"])
def test_txt2img_matches_jax(weights, parameterization):
    jax_pipe, port_pipe = _pipelines(weights, parameterization)
    kw = dict(steps=6, guidance_scale=7.5, height=16, width=16)
    want = np.asarray(jax_pipe.txt2img(PROMPTS, rng=jax.random.PRNGKey(3), **kw))
    # the JAX pipeline's own initial noise, handed to the port as x_T
    x_T = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (2, 8, 8, 4)))
    got = port_pipe.txt2img(PROMPTS, x_T=torch.tensor(x_T), **kw)
    assert got.shape == (2, 16, 16, 3) and got.dtype == torch.float32
    assert got.min() >= 0.0 and got.max() <= 1.0
    assert want.std() > 1e-3  # the images are not saturated flat
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TRAJ_BOUND * np.abs(want).max())


def test_latent_trajectory_and_intermediates_match_jax(weights):
    """The sampler alone, with `return_intermediate`: every step's latent."""
    jax_pipe, port_pipe = _pipelines(weights, "v")
    cond = jax_pipe.model.get_learned_conditioning(PROMPTS)
    uncond = jax_pipe.model.get_learned_conditioning([""] * 2)
    x_T = np.random.default_rng(5).standard_normal((2, 8, 8, 4)).astype(np.float32)
    kw = dict(unconditional_guidance_scale=3.0, return_intermediate=True)
    want, want_mid = jax_pipe.sampler.sample(4, 2, (8, 8, 4), cond, x_T=jnp.asarray(x_T),
                                             unconditional_conditioning=uncond, **kw)
    with torch.no_grad():
        got, got_mid = port_pipe.sampler.sample(
            4, 2, (8, 8, 4), torch.tensor(np.asarray(cond)), x_T=torch.tensor(x_T),
            unconditional_conditioning=torch.tensor(np.asarray(uncond)), **kw)
    want = np.asarray(want)
    assert len(got_mid) == len(want_mid) == 5
    for g, w in zip(got_mid, want_mid):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=TRAJ_BOUND * np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TRAJ_BOUND * np.abs(want).max())


def test_encode_first_stage_matches_jax(weights):
    jax_pipe, port_pipe = _pipelines(weights, "eps")
    img = np.random.default_rng(6).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    want = np.asarray(jax_pipe.model.encode_first_stage(jnp.asarray(img)))
    with torch.no_grad():
        got = port_pipe.model.encode_first_stage(torch.tensor(img))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=3e-5)  # the VAE bound


def test_txt2img_generator_is_deterministic_and_context_on_device(weights):
    _, port_pipe = _pipelines(weights, "eps")
    kw = dict(steps=3, height=16, width=16)
    a = port_pipe.txt2img(PROMPTS, generator=torch.Generator().manual_seed(7), **kw)
    b = port_pipe.txt2img(PROMPTS, generator=torch.Generator().manual_seed(7), **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    ctx = port_pipe.model.get_learned_conditioning(PROMPTS)
    assert ctx.shape == (2, 77, CTX) and ctx.device.type == "cpu"
    np.testing.assert_array_equal(ctx.numpy(), np.asarray(jax_encoder(CTX)(PROMPTS)))


def test_betas_and_crossattn_conditioning_match_jax(weights):
    """make_ldm_betas, and apply_model's raw-context and `c_crossattn` forms
    (a list of contexts joins along the tokens) against the JAX bundle."""
    from dpm_solver_tpu.pipelines import make_ldm_betas as jax_betas

    np.testing.assert_array_equal(make_ldm_betas(), jax_betas())
    jax_pipe, port_pipe = _pipelines(weights, "eps")
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.asarray([10.0, 700.0], np.float32)
    ca, cb = (rng.standard_normal((2, n, CTX)).astype(np.float32) for n in (5, 3))
    want = np.asarray(jax_pipe.model.apply_model(
        jnp.asarray(x), jnp.asarray(t), {"c_crossattn": [jnp.asarray(ca), jnp.asarray(cb)]}))
    with torch.no_grad():
        tx, tt = torch.tensor(x), torch.tensor(t)
        got = port_pipe.model.apply_model(tx, tt, {"c_crossattn": [torch.tensor(ca),
                                                                   torch.tensor(cb)]})
        raw = port_pipe.model.apply_model(tx, tt, torch.tensor(np.concatenate([ca, cb], 1)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)  # the UNet bound
    torch.testing.assert_close(raw, got, rtol=0, atol=0)


def test_repeat_sample_reuses_its_solver_with_the_new_prompts(weights):
    """A second sampler call at the same shapes takes the solver (and, on
    the card, the CUDA graph) of the first: its CFG closure reads the
    conditioning from tensors the sampler keeps, into which each call copies
    its own. So the second call's latents are those of its own prompts (the
    JAX sampler's on them, within the trajectory bound), not the first's;
    another guidance scale is another solver."""
    jax_pipe, port_pipe = _pipelines(weights, "v")
    x_T = np.random.default_rng(9).standard_normal((2, 8, 8, 4)).astype(np.float32)
    uncond = jax_pipe.model.get_learned_conditioning([""] * 2)
    kw = dict(unconditional_guidance_scale=3.0, return_intermediate=False)
    sampler = port_pipe.sampler
    outs = []
    for prompts in (PROMPTS, ["a lighthouse", "a bowl of ramen"]):
        cond = jax_pipe.model.get_learned_conditioning(prompts)
        want, _ = jax_pipe.sampler.sample(3, 2, (8, 8, 4), cond, x_T=jnp.asarray(x_T),
                                          unconditional_conditioning=uncond, **kw)
        with torch.no_grad():
            got, _ = sampler.sample(3, 2, (8, 8, 4), torch.tensor(np.asarray(cond)),
                                    x_T=torch.tensor(x_T),
                                    unconditional_conditioning=torch.tensor(np.asarray(uncond)),
                                    **kw)
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=TRAJ_BOUND * np.abs(want).max())
        outs.append(got)
    assert len(sampler._solvers) == 1
    assert not torch.equal(outs[0], outs[1])
    with torch.no_grad():
        sampler.sample(3, 2, (8, 8, 4), torch.tensor(np.asarray(cond)), x_T=torch.tensor(x_T),
                       unconditional_conditioning=torch.tensor(np.asarray(uncond)),
                       unconditional_guidance_scale=5.0, return_intermediate=False)
    assert len(sampler._solvers) == 2
