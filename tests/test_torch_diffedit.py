"""Port DiffEdit (dpm_solver_tpu_torch/pipelines/diffedit.py): the twins of
tests/test_diffedit.py's four tests on the port, and the port against the
JAX `diffedit` and `compute_edit_mask`.

The two mask extremes pin the blend semantics down exactly:
  * mask == 1 everywhere (edit all): the correction is the identity, so the
    result equals plain sampling from the same x_T;
  * mask == 0 everywhere (edit nothing): every correction overwrites x with
    the blend target, so the final latent is the last blend entry.
Against JAX, on the same JAX-initialised weights with the JAX draws
regenerated here (`split(rng)` -> the mask's noise, `fold_in(rng_noise, k)`
-> step k's blend noise): the images within 1e-4 of max|x|
(tests/test_solver_parity.py:70-75; the deterministic edit, whose inverse ODE
amplifies fp32 rounding a thousandfold, within 3e-3: DETERMINISTIC_BOUND), the
mask exactly.
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
from dpm_solver_tpu.pipelines import DPMSolverSampler as JaxSampler
from dpm_solver_tpu.pipelines import LatentDiffusion as JaxLatentDiffusion
from dpm_solver_tpu.pipelines.diffedit import compute_edit_mask as jax_compute_edit_mask
from dpm_solver_tpu.pipelines.diffedit import diffedit as jax_diffedit
from dpm_solver_tpu_torch.models import (ADMConfig, ADMUNet, AutoencoderKL, VAEConfig,
                                         constant_context_encoder)
from dpm_solver_tpu_torch.pipelines import (DPMSolverSampler, LatentDiffusion,
                                            compute_edit_mask, diffedit)
from dpm_solver_tpu_torch.solver.plan import get_time_steps
from dpm_solver_tpu_torch.utils.convert import (adm_unet_state_dict_from_flax,
                                                autoencoder_kl_state_dict_from_flax)

TRAJ_BOUND = 1e-4
# the deterministic edit runs the inverse ODE up from t_0 and then samples
# back, 10 CFG steps in all on random weights: on the port alone a 1e-7
# relative change of the source latent moves the edited latents by 2.9e-4
# and a 1e-6 change by 8.9e-4 of max|x|, so fp32 rounding alone (the two
# packages' UNets agree within ~1e-6) gives ~1e-3; a wrong blend table or
# mask gives O(0.1)
DETERMINISTIC_BOUND = 3e-3
UNET = dict(image_size=8, in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1,
            attention_resolutions=(1,), channel_mult=(1, 2), num_heads=2,
            use_spatial_transformer=True, transformer_depth=1, context_dim=24)
VAE = dict(resolution=16, attn_resolutions=())


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


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def ldms():
    unet, vae = JaxADMUNet(JaxADMConfig(**UNET)), JaxAutoencoderKL(config=JaxVAEConfig.tiny(**VAE))
    k = jax.random.PRNGKey(0)
    up = jax.tree.map(np.asarray, _randomize(unet.init(
        k, jnp.zeros((1, 8, 8, 4)), jnp.ones((1,)), None, jnp.zeros((1, 7, 24)),
        deterministic=True), 1))
    vp = jax.tree.map(np.asarray, _randomize(vae.init(k, jnp.zeros((1, 16, 16, 3))), 2))
    ucfg, vcfg = ADMConfig(**UNET), VAEConfig.tiny(**VAE)
    port_unet = ADMUNet(ucfg, device="cpu").eval()
    port_unet.load_state_dict(adm_unet_state_dict_from_flax(up, ucfg))
    port_vae = AutoencoderKL(vcfg, device="cpu").eval()
    port_vae.load_state_dict(autoencoder_kl_state_dict_from_flax(vp, vcfg))
    return (JaxLatentDiffusion(unet=unet, unet_params=up, vae=vae, vae_params=vp,
                               text_encode=jax_encoder(24)),
            LatentDiffusion(port_unet, port_vae, text_encode=constant_context_encoder(24)))


@pytest.fixture(scope="module")
def init_image():
    return np.random.RandomState(0).uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)


def test_diffedit_runs_both_encode_types(ldms, init_image):
    for mode in ("stochastic", "deterministic"):
        img, mask = diffedit(ldms[1], torch.tensor(init_image), "src", "dst", steps=6,
                             encode_type=mode, generator=torch.Generator().manual_seed(1),
                             return_mask=True)
        assert img.shape == (1, 16, 16, 3) and torch.isfinite(img).all()
        assert set(torch.unique(mask).tolist()) <= {0.0, 1.0}


def test_diffedit_mask_one_equals_plain_sampling(ldms, init_image):
    ldm = ldms[1]
    img = diffedit(ldm, torch.tensor(init_image), "src", "dst", steps=6,
                   encode_type="deterministic", mask=torch.ones(8, 8), guidance_scale=3.0)
    # reproduce by hand: encode, then sample with no correction
    sampler = DPMSolverSampler(ldm)
    uc, src, dst = (ldm.get_learned_conditioning([p]) for p in ("", "src", "dst"))
    with torch.no_grad():
        z0 = ldm.encode_first_stage(torch.tensor(init_image))
        z_enc, _ = sampler.encode(6, z0, 0.6, conditioning=src, unconditional_guidance_scale=3.0,
                                  unconditional_conditioning=uc, order=2,
                                  lower_order_final=False)
        lat, _ = sampler.sample(6, 1, tuple(z_enc.shape[1:]), dst,
                                unconditional_guidance_scale=3.0, unconditional_conditioning=uc,
                                x_T=z_enc, t_start=sampler.ratio_to_time(0.6), order=2,
                                lower_order_final=False)
        want = ((ldm.decode_first_stage(lat) + 1) / 2).clamp(0, 1)
    torch.testing.assert_close(img, want, rtol=0, atol=1e-5)


def test_diffedit_mask_zero_returns_last_blend_target(ldms, init_image):
    """With nothing editable every correction overwrites x with the blend
    target, so the output is the decode of the LAST blend entry: z0 noised
    to t_0 with the last step's noise."""
    ldm, steps = ldms[1], 6
    noise = torch.randn(steps + 1, 1, 8, 8, 4, generator=torch.Generator().manual_seed(3))
    img = diffedit(ldm, torch.tensor(init_image), "src", "dst", steps=steps,
                   encode_type="stochastic", mask=torch.zeros(8, 8), noise=noise)
    sampler = DPMSolverSampler(ldm)
    ns = sampler.noise_schedule
    grid = get_time_steps(ns, "time_uniform", sampler.ratio_to_time(0.6), 1.0 / ns.total_N,
                          steps)
    with torch.no_grad():
        z0 = ldm.encode_first_stage(torch.tensor(init_image))
        z_last = sampler.stochastic_encode(z0, sampler.time_to_ratio(float(grid[steps])),
                                           noise=noise[steps])
        want = ((ldm.decode_first_stage(z_last) + 1) / 2).clamp(0, 1)
    torch.testing.assert_close(img, want, rtol=0, atol=1e-5)


def test_compute_edit_mask_shapes(ldms, init_image):
    ldm = ldms[1]
    sampler = DPMSolverSampler(ldm)
    with torch.no_grad():
        z0 = ldm.encode_first_stage(torch.tensor(init_image))
    src, dst = ldm.get_learned_conditioning(["a"]), ldm.get_learned_conditioning(["b"])
    mask = compute_edit_mask(ldm, sampler, z0, src, dst, torch.Generator().manual_seed(4))
    assert mask.shape == (8, 8)
    assert set(torch.unique(mask).tolist()) <= {0.0, 1.0}


def test_compute_edit_mask_matches_jax(ldms, init_image):
    jax_ldm, ldm = ldms
    rng = jax.random.PRNGKey(5)
    z0 = np.asarray(jax_ldm.encode_first_stage(jnp.asarray(init_image)))
    src, dst = jax_encoder(24)(["a cat"]), jax_encoder(24)(["a dog"])
    # clamp_rate 1.5 (threshold at 0.75 of the mean difference) splits this
    # random-weight map; the default 3.5 marks none of it
    want = jax_compute_edit_mask(jax_ldm, JaxSampler(jax_ldm), jnp.asarray(z0), src, dst, rng,
                                 clamp_rate=1.5)
    noise = np.asarray(jax.random.normal(rng, (1, 3, 8, 8, 4)))
    got = compute_edit_mask(ldm, DPMSolverSampler(ldm), torch.tensor(z0),
                            torch.tensor(np.asarray(src)), torch.tensor(np.asarray(dst)),
                            noise=torch.tensor(noise), clamp_rate=1.5)
    assert 0 < got.sum() < 64  # a real split of the map, not a constant
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("encode_type", ["stochastic", "deterministic"])
def test_diffedit_matches_jax(ldms, init_image, encode_type):
    jax_ldm, ldm = ldms
    rng, steps = jax.random.PRNGKey(6), 5
    want_img, want_mask = jax_diffedit(jax_ldm, jnp.asarray(init_image), "a cat", "a dog",
                                       steps=steps, encode_type=encode_type, clamp_rate=1.5,
                                       guidance_scale=3.0, rng=rng, return_mask=True)
    rng_mask, rng_noise = jax.random.split(rng)
    mask_noise = np.asarray(jax.random.normal(rng_mask, (1, 3, 8, 8, 4)))
    noise = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(rng_noise, k),
                                                   (1, 1, 8, 8, 4)))[0]
                      for k in range(steps + 1)])
    img, mask = diffedit(ldm, torch.tensor(init_image), "a cat", "a dog", steps=steps,
                         encode_type=encode_type, guidance_scale=3.0, clamp_rate=1.5,
                         mask_noise=torch.tensor(mask_noise), noise=torch.tensor(noise),
                         return_mask=True)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    assert 0 < mask.sum() < 64  # both regions: edited and re-imposed
    bound = TRAJ_BOUND if encode_type == "stochastic" else DETERMINISTIC_BOUND
    assert _rel(img.numpy(), want_img) < bound
