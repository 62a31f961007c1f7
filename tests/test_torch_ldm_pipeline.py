"""Port the rest of the latent-diffusion surface (dpm_solver_tpu_torch/pipelines/
stable_diffusion.py) against the JAX pipeline, on tiny UNets and first stages.

JAX-initialised weights (every leaf perturbed) go into the port through its
converters; the same latents, images and noise (the JAX draws regenerated
here with `jax.random`, as the JAX functions make them, and passed to the
port) go through both packages. Networks agree within 2e-5 of max|ref|
(tests/test_models.py:64); trajectories and the images decoded from them
within 1e-4 of max|x| (tests/test_solver_parity.py:70-75). The VQ first
stage quantises latents whose nearest codes are clear (the codebook is
spread; the sampled latents are checked for ties before the images are
compared).

Covered: `apply_model` with concat, hybrid and adm conditioning; the VQ
first stage; `stochastic_encode`, `encode` and the time/ratio converters;
img2img, inpaint (with its nearest-resized latent mask) and upscale;
`load_sd_checkpoint` on synthesised CompVis checkpoints with a KL and a VQ
first stage, and its presets; `class_conditional_sample`; the sampler's
solver key over every option; the blend table that inpainting holds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpm_solver_tpu.models.adm_unet import ADMConfig as JaxADMConfig
from dpm_solver_tpu.models.adm_unet import ADMUNet as JaxADMUNet
from dpm_solver_tpu.models.text_encoder import ClassEmbedder as JaxClassEmbedder
from dpm_solver_tpu.models.text_encoder import constant_context_encoder as jax_encoder
from dpm_solver_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from dpm_solver_tpu.models.vae import VAEConfig as JaxVAEConfig
from dpm_solver_tpu.models.vae import VQModel as JaxVQModel
from dpm_solver_tpu.pipelines import DPMSolverSampler as JaxSampler
from dpm_solver_tpu.pipelines import LatentDiffusion as JaxLatentDiffusion
from dpm_solver_tpu.pipelines import StableDiffusionPipeline as JaxPipeline
from dpm_solver_tpu.pipelines import stable_diffusion as jax_sd
from dpm_solver_tpu_torch.models import (ADMConfig, ADMUNet, AutoencoderKL, ClassEmbedder,
                                         VAEConfig, VQModel, constant_context_encoder,
                                         init_random_)
from dpm_solver_tpu_torch.pipelines import (DPMSolverSampler, LatentDiffusion, MaskedBlend,
                                            StableDiffusionPipeline, class_conditional_sample,
                                            load_sd_checkpoint, make_ldm_betas)
from dpm_solver_tpu_torch.pipelines import stable_diffusion as port_sd
from dpm_solver_tpu_torch.utils.convert import (adm_unet_state_dict_from_flax,
                                                autoencoder_kl_state_dict_from_flax,
                                                vq_model_state_dict_from_flax)

NET_TOL = 2e-5
TRAJ_BOUND = 1e-4
CTX = 24
UNET = dict(image_size=8, in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1,
            attention_resolutions=(1, 2), channel_mult=(1, 2), num_heads=2,
            use_spatial_transformer=True, transformer_depth=1, context_dim=CTX)
VAE = dict(resolution=16, attn_resolutions=())
VQ = dict(ch_mult=(1, 2), z_channels=3, embed_dim=3, double_z=False, resolution=16,
          attn_resolutions=())
N_EMBED = 64
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


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / max(np.abs(want).max(), 1e-30))


def _unet_pair(seed, **overrides):
    kw = dict(UNET, **overrides)
    unet = JaxADMUNet(JaxADMConfig(**kw))
    c = kw["in_channels"]
    y = jnp.zeros((1,), jnp.int32) if kw.get("num_classes") else None
    ctx = jnp.zeros((1, 7, kw["context_dim"])) if kw.get("context_dim") else None
    params = jax.tree.map(np.asarray, _randomize(
        unet.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, c)), jnp.ones((1,)), y, ctx,
                  deterministic=True), seed))
    cfg = ADMConfig(**kw)
    port = ADMUNet(cfg, device="cpu").eval()
    port.load_state_dict(adm_unet_state_dict_from_flax(params, cfg))
    return unet, params, port


@pytest.fixture(scope="module")
def kl():
    """The tiny SD-like LDM: cross-attention UNet, KL first stage."""
    unet, up, port_unet = _unet_pair(1)
    vae = JaxAutoencoderKL(config=JaxVAEConfig.tiny(**VAE))
    vp = jax.tree.map(np.asarray, _randomize(vae.init(jax.random.PRNGKey(0),
                                                      jnp.zeros((1, 16, 16, 3))), 2))
    vcfg = VAEConfig.tiny(**VAE)
    port_vae = AutoencoderKL(vcfg, device="cpu").eval()
    port_vae.load_state_dict(autoencoder_kl_state_dict_from_flax(vp, vcfg))
    jax_ldm = JaxLatentDiffusion(unet=unet, unet_params=up, vae=vae, vae_params=vp,
                                 text_encode=jax_encoder(CTX))
    port_ldm = LatentDiffusion(port_unet, port_vae, text_encode=constant_context_encoder(CTX))
    return jax_ldm, port_ldm


def _vq_pair(seed):
    vae = JaxVQModel(config=JaxVAEConfig.tiny(**VQ), n_embed=N_EMBED)
    vp = jax.tree.map(np.asarray, _randomize(vae.init(jax.random.PRNGKey(0),
                                                      jnp.zeros((1, 16, 16, 3))), seed))
    vp["params"]["quantize"]["embedding"] = (
        2.0 * np.random.default_rng(seed).standard_normal((N_EMBED, 3))).astype(np.float32)
    vcfg = VAEConfig.tiny(**VQ)
    port = VQModel(vcfg, n_embed=N_EMBED, device="cpu").eval()
    port.load_state_dict(vq_model_state_dict_from_flax(vp, vcfg))
    return vae, vp, port


@pytest.fixture(scope="module")
def cin():
    """A tiny cin256-like LDM: class context through cross-attention, a VQ-f2
    first stage, cin256's schedule and scale factor."""
    unet, up, port_unet = _unet_pair(3, in_channels=3, out_channels=3, context_dim=16)
    vae, vp, port_vae = _vq_pair(4)
    betas = make_ldm_betas(1000, 0.0015, 0.0195)
    jax_ldm = JaxLatentDiffusion(unet=unet, unet_params=up, vae=vae, vae_params=vp,
                                 betas=betas, scale_factor=1.0)
    port_ldm = LatentDiffusion(port_unet, port_vae, betas=betas, scale_factor=1.0)
    return jax_ldm, port_ldm


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(0).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)


@pytest.mark.parametrize("key", ["concat", "hybrid", "adm"])
def test_apply_model_conditioning_matches_jax(key):
    over = {"concat": dict(in_channels=7, context_dim=None, use_spatial_transformer=False),
            "hybrid": dict(in_channels=7),
            "adm": dict(num_classes=10)}[key]
    unet, params, port = _unet_pair(5, **over)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([3.0, 711.0], np.float32)
    cond = {}
    if key in ("concat", "hybrid"):
        cond["c_concat"] = [rng.standard_normal((2, 8, 8, 3)).astype(np.float32)]
    if key in ("hybrid", "adm"):
        cond["c_crossattn"] = [rng.standard_normal((2, 5, CTX)).astype(np.float32),
                               rng.standard_normal((2, 2, CTX)).astype(np.float32)]
    if key == "adm":
        cond["c_adm"] = np.array([1, 7])
    jax_ldm = JaxLatentDiffusion(unet=unet, unet_params=params, vae=None, vae_params=None,
                                 conditioning_key=key)
    port_ldm = LatentDiffusion(port, None, conditioning_key=key)
    want = jax_ldm.apply_model(jnp.asarray(x), jnp.asarray(t),
                               jax.tree.map(jnp.asarray, cond))
    with torch.no_grad():
        got = port_ldm.apply_model(torch.tensor(x), torch.tensor(t),
                                   jax.tree.map(torch.tensor, cond))
    assert _rel(got.numpy(), want) < NET_TOL
    if key == "concat":  # a bare tensor is the concat input of a concat model
        with torch.no_grad():
            bare = port_ldm.apply_model(torch.tensor(x), torch.tensor(t),
                                        torch.tensor(cond["c_concat"][0]))
        assert torch.equal(bare, got)


def test_vq_first_stage_encode_decode_match_jax(cin, image):
    jax_ldm, port_ldm = cin
    assert port_ldm.is_vq
    want = jax_ldm.encode_first_stage(jnp.asarray(image))
    with torch.no_grad():
        got = port_ldm.encode_first_stage(torch.tensor(image))
    assert _rel(got.numpy(), want) < NET_TOL
    codebook = port_ldm.vae.quantize.embedding.weight.detach().numpy()
    rng = np.random.default_rng(7)
    z = (codebook[rng.integers(0, N_EMBED, (2, 8, 8))]
         + 0.01 * rng.standard_normal((2, 8, 8, 3))).astype(np.float32)
    want = jax_ldm.decode_first_stage(jnp.asarray(z))
    with torch.no_grad():
        got = port_ldm.decode_first_stage(torch.tensor(z))
    assert _rel(got.numpy(), want) < NET_TOL


def test_time_and_ratio_converters_match_jax(kl):
    jax_s, port_s = JaxSampler(kl[0]), DPMSolverSampler(kl[1])
    for v in (0.0, 0.25, 0.6, 1.0):
        assert port_s.ratio_to_time(v) == pytest.approx(jax_s.ratio_to_time(v), abs=1e-12)
        assert port_s.time_to_ratio(v) == pytest.approx(jax_s.time_to_ratio(v), abs=1e-12)
        assert port_s.time_discrete_to_continuous(v * 999) == pytest.approx(
            jax_s.time_discrete_to_continuous(v * 999), abs=1e-12)
        assert port_s.time_continuous_to_discrete(v) == pytest.approx(
            jax_s.time_continuous_to_discrete(v), abs=1e-9)


def test_stochastic_encode_matches_jax(kl):
    jax_s, port_s = JaxSampler(kl[0]), DPMSolverSampler(kl[1])
    z0 = np.random.default_rng(8).standard_normal((2, 8, 8, 4)).astype(np.float32)
    rng = jax.random.PRNGKey(9)
    want = jax_s.stochastic_encode(jnp.asarray(z0), 0.7, rng=rng)
    noise = np.asarray(jax.random.normal(rng, (1, 2, 8, 8, 4)))
    got = port_s.stochastic_encode(torch.tensor(z0), 0.7, noise=torch.tensor(noise))
    assert got.shape == z0.shape
    assert _rel(got.numpy(), want) < 1e-6
    g = torch.Generator().manual_seed(0)
    drawn = port_s.stochastic_encode(torch.tensor(z0), 0.7, generator=g)
    again = port_s.stochastic_encode(torch.tensor(z0), 0.7,
                                     generator=torch.Generator().manual_seed(0))
    assert torch.equal(drawn, again)


def test_deterministic_encode_matches_jax(kl):
    jax_ldm, port_ldm = kl
    z0 = np.random.default_rng(10).standard_normal((1, 8, 8, 4)).astype(np.float32)
    src, uc = jax_encoder(CTX)(["src"]), jax_encoder(CTX)([""])
    want, want_inter = JaxSampler(jax_ldm).encode(
        5, jnp.asarray(z0), 0.6, conditioning=src, unconditional_guidance_scale=3.0,
        unconditional_conditioning=uc)
    with torch.no_grad():
        got, got_inter = DPMSolverSampler(port_ldm).encode(
            5, torch.tensor(z0), 0.6, conditioning=torch.tensor(np.asarray(src)),
            unconditional_guidance_scale=3.0, unconditional_conditioning=torch.tensor(
                np.asarray(uc)))
    assert _rel(got.numpy(), want) < TRAJ_BOUND
    assert len(got_inter) == len(want_inter)
    for a, b in zip(got_inter, want_inter):
        assert _rel(a.numpy(), b) < TRAJ_BOUND


def test_img2img_matches_jax(kl, image):
    jax_ldm, port_ldm = kl
    rng = jax.random.PRNGKey(11)
    want = JaxPipeline(jax_ldm).img2img(jnp.asarray(image), PROMPTS, strength=0.6, steps=5,
                                        guidance_scale=3.0, rng=rng)
    # the JAX img2img: split(rng) -> the first key draws add_noise's (1, *z0.shape)
    noise = np.asarray(jax.random.normal(jax.random.split(rng)[0], (1, 2, 8, 8, 4)))
    got = StableDiffusionPipeline(port_ldm, device="cpu").img2img(
        torch.tensor(image), PROMPTS, strength=0.6, steps=5, guidance_scale=3.0,
        noise=torch.tensor(noise))
    assert got.shape == (2, 16, 16, 3)
    assert _rel(got.numpy(), want) < TRAJ_BOUND


def _inpaint_inputs(seed):
    rng = np.random.default_rng(seed)
    image = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    mask = np.zeros((2, 16, 16), np.float32)
    mask[0, 2:11, 4:13] = 1.0
    mask[1, 6:16, 0:7] = 1.0
    return image, mask


def _inpaint_noise(rng, steps, shape):
    """The JAX inpaint's blend noise: step k draws normal(fold_in(rng, k), (1, *shape))."""
    return np.stack([np.asarray(jax.random.normal(jax.random.fold_in(rng, k), (1, *shape)))[0]
                     for k in range(steps + 1)])


def test_inpaint_matches_jax_and_keeps_the_known_pixels(kl):
    jax_ldm, port_ldm = kl
    image, mask = _inpaint_inputs(12)
    rng, steps = jax.random.PRNGKey(13), 5
    want = JaxPipeline(jax_ldm).inpaint(jnp.asarray(image), jnp.asarray(mask), PROMPTS,
                                        steps=steps, guidance_scale=3.0, rng=rng)
    noise = _inpaint_noise(rng, steps, (2, 8, 8, 4))
    got = StableDiffusionPipeline(port_ldm, device="cpu").inpaint(
        torch.tensor(image), torch.tensor(mask), PROMPTS, steps=steps, guidance_scale=3.0,
        noise=torch.tensor(noise))
    assert got.shape == (2, 16, 16, 3)
    assert _rel(got.numpy(), want) < TRAJ_BOUND
    keep = mask[..., None] == 0
    np.testing.assert_allclose(np.broadcast_to(np.clip((image + 1) / 2, 0, 1), got.shape)[
        np.broadcast_to(keep, got.shape)], got.numpy()[np.broadcast_to(keep, got.shape)],
        rtol=0, atol=1e-6)


def test_inpaint_second_call_reads_its_own_blend_table(kl):
    """A repeat call at the same shapes reuses the sampler's solver (the one
    a CUDA graph would replay) and copies its own image, mask and noise into
    the held MaskedBlend: it equals a fresh pipeline's call."""
    _, port_ldm = kl
    pipe = StableDiffusionPipeline(port_ldm, device="cpu")
    steps, g = 4, torch.Generator().manual_seed(14)
    kw = dict(steps=steps, guidance_scale=3.0)
    first = _inpaint_inputs(15)
    pipe.inpaint(torch.tensor(first[0]), torch.tensor(first[1]), PROMPTS,
                 noise=torch.randn(steps + 1, 2, 8, 8, 4, generator=g), **kw)
    solvers = dict(pipe.sampler._solvers)
    image, mask = _inpaint_inputs(16)
    noise = torch.randn(steps + 1, 2, 8, 8, 4, generator=g)
    got = pipe.inpaint(torch.tensor(image), torch.tensor(mask), PROMPTS, noise=noise, **kw)
    assert pipe.sampler._solvers.keys() == solvers.keys()
    fresh = StableDiffusionPipeline(port_ldm, device="cpu").inpaint(
        torch.tensor(image), torch.tensor(mask), PROMPTS, noise=noise, **kw)
    torch.testing.assert_close(got, fresh, rtol=0, atol=0)


def test_latent_mask_takes_jax_nearest_pixels(kl):
    mask = (np.random.default_rng(17).uniform(size=(2, 64, 48)) > 0.5).astype(np.float32)
    want = (jax.image.resize(jnp.asarray(mask)[..., None], (2, 8, 6, 1), "nearest") >= 0.5)
    got = StableDiffusionPipeline(kl[1], device="cpu").latent_mask(torch.tensor(mask), (8, 6))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.float32))
    np.testing.assert_array_equal(got.numpy()[..., 0], mask[:, 4::8, 4::8])  # pixel 8i + 4


def test_upscale_matches_jax():
    """A concat-conditioned LDM: the LR image joins z_t along channels; the
    latent is the LR size (a VQ-f2 first stage here), the output twice it."""
    unet, up, port_unet = _unet_pair(18, in_channels=6, out_channels=3, context_dim=None,
                                     use_spatial_transformer=False)
    vae, vp, port_vae = _vq_pair(19)
    jax_ldm = JaxLatentDiffusion(unet=unet, unet_params=up, vae=vae, vae_params=vp,
                                 scale_factor=1.0, conditioning_key="concat")
    port_ldm = LatentDiffusion(port_unet, port_vae, scale_factor=1.0, conditioning_key="concat")
    lr = np.random.default_rng(20).uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(21)
    want = JaxPipeline(jax_ldm).upscale(jnp.asarray(lr), steps=4, rng=rng)
    x_T = np.asarray(jax.random.normal(rng, (2, 8, 8, 3)))
    pipe = StableDiffusionPipeline(port_ldm, device="cpu")
    got = pipe.upscale(torch.tensor(lr), steps=4, x_T=torch.tensor(x_T))
    assert got.shape == (2, 16, 16, 3)
    assert _rel(got.numpy(), want) < TRAJ_BOUND
    with pytest.raises(ValueError, match="concat"):
        StableDiffusionPipeline(LatentDiffusion(port_unet, port_vae), device="cpu").upscale(
            torch.tensor(lr))


def test_class_conditional_sample_matches_jax(cin):
    jax_ldm, port_ldm = cin
    jax_embedder = JaxClassEmbedder(11, 16, seed=5)
    table = np.asarray(jax_embedder.params["params"]["embedding"])
    labels = np.array([3, 7])
    rng = jax.random.PRNGKey(22)
    want = jax_sd.class_conditional_sample(jax_ldm, jax_embedder, labels, steps=5,
                                           guidance_scale=3.0, uncond_label=10, rng=rng)
    x_T = np.asarray(jax.random.normal(rng, (2, 8, 8, 3)))
    got = class_conditional_sample(port_ldm, ClassEmbedder(11, 16, embedding=table, device="cpu"),
                                   labels, steps=5, guidance_scale=3.0, uncond_label=10,
                                   x_T=torch.tensor(x_T))
    assert got.shape == (2, 16, 16, 3)
    assert _rel(got.numpy(), want) < TRAJ_BOUND
    with pytest.raises(ValueError, match="uncond_label"):
        class_conditional_sample(port_ldm, ClassEmbedder(11, 16, device="cpu"), labels,
                                 guidance_scale=3.0)


def _checkpoint(vq: bool):
    """A CompVis-style checkpoint synthesised from the port's modules, whose
    parameter names are the reference's: random weights under
    model.diffusion_model.* and first_stage_model.*."""
    g = torch.Generator().manual_seed(23)
    ucfg = ADMConfig(**dict(UNET, in_channels=3, out_channels=3) if vq else UNET)
    vcfg = VAEConfig.tiny(**VQ) if vq else VAEConfig.tiny(**VAE)
    unet = init_random_(ADMUNet(ucfg, device="cpu"), g)
    vae = init_random_(VQModel(vcfg, n_embed=N_EMBED, device="cpu") if vq
                       else AutoencoderKL(vcfg, device="cpu"), g)
    ckpt = {f"model.diffusion_model.{k}": v for k, v in unet.state_dict().items()}
    ckpt.update({f"first_stage_model.{k}": v for k, v in vae.state_dict().items()})
    jcfgs = (JaxADMConfig(**dict(UNET, in_channels=3, out_channels=3) if vq else UNET),
             JaxVAEConfig.tiny(**VQ) if vq else JaxVAEConfig.tiny(**VAE))
    return ckpt, (ucfg, vcfg), jcfgs


@pytest.mark.parametrize("vq", [False, True], ids=["kl", "vq"])
def test_load_sd_checkpoint_matches_jax(vq, tmp_path):
    ckpt, (ucfg, vcfg), (jucfg, jvcfg) = _checkpoint(vq)
    preset = "cin256" if vq else "sd_v1"
    want = jax_sd.load_sd_checkpoint({k: v.numpy() for k, v in ckpt.items()}, preset=preset,
                                     unet_config=jucfg, vae_config=jvcfg)
    path = tmp_path / "model.ckpt"
    torch.save({"state_dict": ckpt}, path)
    for source in (ckpt, str(path)):
        got = load_sd_checkpoint(source, preset=preset, unet_config=ucfg, vae_config=vcfg,
                                 device="cpu")
        assert got.is_vq == vq and isinstance(want.vae, JaxVQModel) == vq
        assert (got.scale_factor, got.parameterization, got.conditioning_key) == (
            want.scale_factor, want.parameterization, want.conditioning_key)
        np.testing.assert_array_equal(got.betas, want.betas)
    rng = np.random.default_rng(24)
    c = ucfg.in_channels
    x = rng.standard_normal((1, 8, 8, c)).astype(np.float32)
    t = np.array([71.0], np.float32)
    ctx = rng.standard_normal((1, 7, CTX)).astype(np.float32)
    with torch.no_grad():
        out = got.apply_model(torch.tensor(x), torch.tensor(t), torch.tensor(ctx))
    assert _rel(out.numpy(), want.apply_model(jnp.asarray(x), jnp.asarray(t),
                                              jnp.asarray(ctx))) < NET_TOL
    if vq:
        codebook = got.vae.quantize.embedding.weight.detach().numpy()
        z = codebook[rng.integers(0, N_EMBED, (1, 8, 8))] + 1e-3 * rng.standard_normal((1, 8, 8, 3))
    else:
        z = rng.standard_normal((1, 8, 8, 4))
    z = z.astype(np.float32)
    with torch.no_grad():
        dec = got.decode_first_stage(torch.tensor(z))
    assert _rel(dec.numpy(), want.decode_first_stage(jnp.asarray(z))) < NET_TOL


def test_load_sd_checkpoint_refuses_quant_and_partial_checkpoints():
    ckpt, (ucfg, vcfg), _ = _checkpoint(False)
    with pytest.raises(NotImplementedError, match="Slice H"):
        load_sd_checkpoint(ckpt, unet_config=ucfg, vae_config=vcfg, quant="w8a8", device="cpu")
    partial = {k: v for k, v in ckpt.items() if "decoder.conv_out" not in k}
    with pytest.raises(KeyError, match="first_stage_model"):
        load_sd_checkpoint(partial, unet_config=ucfg, vae_config=vcfg, device="cpu")
    with pytest.raises(ValueError, match="model.diffusion_model"):
        load_sd_checkpoint({}, device="cpu")


def test_presets_match_jax():
    assert set(port_sd._LDM_PRESETS) == set(jax_sd._LDM_PRESETS)
    for name, (u, v, betas, scale) in port_sd._LDM_PRESETS.items():
        ju, jv, jbetas, jscale = jax_sd._LDM_PRESETS[name]
        assert (betas, scale) == (jbetas, jscale)
        assert u() == ADMConfig(**{f: getattr(ju(), f) for f in u().__dataclass_fields__})
        assert v() == VAEConfig(**{f: getattr(jv(), f) for f in v().__dataclass_fields__})


OPTIONS = dict(steps=5, skip_type="time_uniform", method="multistep", order=2,
               lower_order_final=True, t_start=None, t_end=None)


@pytest.mark.parametrize("change", [
    dict(steps=6), dict(skip_type="logSNR"), dict(method="singlestep"), dict(order=3),
    dict(lower_order_final=False), dict(t_start=0.6), dict(t_end=1e-3),
    dict(correcting_xt_fn=MaskedBlend(torch.zeros(6, 1, 8, 8, 4), torch.ones(1, 8, 8, 1))),
    dict(correcting_xt_fn=lambda x, t, step: x), dict(scale=2.0),
    dict(conditioning=torch.zeros(1, 9, CTX))], ids=lambda c: next(iter(c)))
def test_solver_key_covers_every_sampler_argument(kl, change):
    """Each argument of the sampler enters the key of the DPM_Solver (and so
    of the CUDA graphs) it runs: no call replays another configuration's
    graph. A MaskedBlend keys by its shapes, so each call's values replay."""
    sampler = DPMSolverSampler(kl[1])
    base = dict(conditioning=torch.zeros(1, 7, CTX), scale=3.0, correcting_xt_fn=None)
    args = dict(base, **{k: v for k, v in change.items() if k in base})
    opts = dict(OPTIONS, **{k: v for k, v in change.items() if k in OPTIONS})

    def key(a, o):
        return sampler.solver_key(a["conditioning"], torch.zeros_like(a["conditioning"]),
                                  a["scale"], a["correcting_xt_fn"], **o)

    assert key(args, opts) != key(base, OPTIONS)
    assert key(base, OPTIONS) == key(dict(base), dict(OPTIONS))
    blend = MaskedBlend(torch.ones(6, 1, 8, 8, 4), torch.zeros(1, 8, 8, 1))
    other = MaskedBlend(torch.zeros(6, 1, 8, 8, 4), torch.ones(1, 8, 8, 1))
    assert key(dict(base, correcting_xt_fn=blend), OPTIONS) == key(
        dict(base, correcting_xt_fn=other), OPTIONS)
