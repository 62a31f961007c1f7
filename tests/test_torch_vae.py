"""Port AutoencoderKL (dpm_solver_tpu_torch/models/vae.py) against the JAX model
in fp32.

JAX-initialised parameters (every leaf perturbed) are carried into the port
through `autoencoder_kl_state_dict_from_flax`; on the same image the
posterior and the reconstruction agree within 3e-5, the JAX package's VAE
bound (tests/test_vae.py:73-78). The state-dict round trip through the JAX
package's `convert_autoencoder_kl` and back is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpm_solver_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from dpm_solver_tpu.models.vae import DiagonalGaussian as JaxDiagonalGaussian
from dpm_solver_tpu.models.vae import VAEConfig as JaxVAEConfig
from dpm_solver_tpu.models.vae import convert_autoencoder_kl
from dpm_solver_tpu_torch.models import AutoencoderKL, DiagonalGaussian, VAEConfig, init_random_
from dpm_solver_tpu_torch.utils.convert import autoencoder_kl_state_dict_from_flax

TOL = 3e-5
CONFIGS = {
    "tiny-attn": dict(),                                   # attention at 16 px, both halves
    "tiny-no-attn": dict(resolution=16, attn_resolutions=()),  # tests/test_sd_pipeline.py's
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


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    kw = CONFIGS[request.param]
    jcfg, cfg = JaxVAEConfig.tiny(**kw), VAEConfig.tiny(**kw)
    x = np.random.default_rng(0).uniform(-1, 1, (2, cfg.resolution, cfg.resolution, 3))
    x = x.astype(np.float32)
    jmodel = JaxAutoencoderKL(config=jcfg)
    params = _randomize(jmodel.init(jax.random.key(0), jnp.asarray(x)), 1)
    port = AutoencoderKL(cfg, device="cpu").eval()
    port.load_state_dict(autoencoder_kl_state_dict_from_flax(
        jax.tree.map(np.asarray, params), cfg), strict=True)
    return jmodel, params, port, x


def test_encode_decode_match_jax(pair):
    jmodel, params, port, x = pair
    want_rec, want_post = jmodel.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got_rec, got_post = port(torch.tensor(x))
    np.testing.assert_allclose(got_post.mean.numpy(), np.asarray(want_post.mean),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(got_post.logvar.numpy(), np.asarray(want_post.logvar),
                               rtol=0, atol=TOL)
    assert got_rec.shape == x.shape
    np.testing.assert_allclose(got_rec.numpy(), np.asarray(want_rec), rtol=0, atol=TOL)


def test_decode_of_a_latent_matches_jax(pair):
    jmodel, params, port, x = pair
    f = 2 ** (len(port.config.ch_mult) - 1)
    z = np.random.default_rng(1).standard_normal(
        (2, x.shape[1] // f, x.shape[2] // f, port.config.embed_dim)).astype(np.float32)
    want = jmodel.apply(params, jnp.asarray(z), method=JaxAutoencoderKL.decode)
    with torch.no_grad():
        got = port.decode(torch.tensor(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_posterior_sample_takes_explicit_noise(pair):
    _, _, port, x = pair
    with torch.no_grad():
        post = port.encode(torch.tensor(x))
        noise = torch.randn(post.mean.shape, generator=torch.Generator().manual_seed(2))
        torch.testing.assert_close(post.sample(noise), post.mean + post.std * noise,
                                   rtol=0, atol=0)
        rec, _ = port(torch.tensor(x), noise)
    assert rec.shape == x.shape and torch.isfinite(rec).all()


def test_round_trip_through_jax_converter_is_exact():
    cfg = VAEConfig.tiny()
    sd = init_random_(AutoencoderKL(cfg, device="cpu"),
                      torch.Generator().manual_seed(3)).state_dict()
    flax_params = convert_autoencoder_kl({k: v.numpy() for k, v in sd.items()},
                                         JaxVAEConfig.tiny())
    back = autoencoder_kl_state_dict_from_flax(flax_params, cfg)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_diagonal_gaussian_matches_jax():
    moments = (np.random.default_rng(4).standard_normal((2, 4, 4, 8)) * 30).astype(np.float32)
    ours = DiagonalGaussian.from_moments(torch.tensor(moments))
    theirs = JaxDiagonalGaussian.from_moments(jnp.asarray(moments))
    np.testing.assert_array_equal(ours.logvar.numpy(), np.asarray(theirs.logvar))  # clamped
    np.testing.assert_array_equal(ours.mode().numpy(), np.asarray(theirs.mode()))
    np.testing.assert_allclose(ours.std.numpy(), np.asarray(theirs.std), rtol=1e-6, atol=0)


def test_sd_v1_config_matches_jax_and_counts_83m_parameters():
    ours, theirs = VAEConfig.sd_v1(), JaxVAEConfig.sd_v1()
    assert ours == VAEConfig(**{f: getattr(theirs, f) for f in ours.__dataclass_fields__})
    assert theirs.quant is None  # the int8 option is off
    n = sum(p.numel() for p in AutoencoderKL(VAEConfig.sd_v1(), device="meta").parameters())
    assert n == 83_653_863  # the SD KL-f8 autoencoder
