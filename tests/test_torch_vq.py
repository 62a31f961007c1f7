"""Port VQModel and VectorQuantizer (dpm_solver_tpu_torch/models/vae.py) against
the JAX model in fp32.

JAX-initialised parameters (every leaf perturbed, the codebook redrawn as
well-spread rows) are carried into the port through
`vq_model_state_dict_from_flax`. The pre-quant latent and the decode of a
latent agree within 3e-5, the JAX package's VAE bound (tests/test_vae.py:73-78).
Latents that are quantised are drawn as codebook rows plus small noise, so that
each position's nearest code is clear of the next one by far more than fp32
rounding of the distances: the indices are compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpm_solver_tpu.models.vae import VAEConfig as JaxVAEConfig
from dpm_solver_tpu.models.vae import VectorQuantizer as JaxVectorQuantizer
from dpm_solver_tpu.models.vae import VQModel as JaxVQModel
from dpm_solver_tpu.models.vae import convert_vq_model
from dpm_solver_tpu_torch.models import VAEConfig, VectorQuantizer, VQModel, init_random_
from dpm_solver_tpu_torch.utils.convert import vq_model_state_dict_from_flax

TOL = 3e-5
N_EMBED = 64
TINY = dict(ch_mult=(1, 2), z_channels=3, embed_dim=3, double_z=False, resolution=16,
            attn_resolutions=())
CONFIGS = {"tiny": TINY, "tiny-attn": dict(TINY, attn_resolutions=(8,))}


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


def _near_codes(codebook, shape, seed, noise=1e-2):
    """Latents of `shape` (..., embed_dim): random codebook rows plus small
    noise, and the rows' indices."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, codebook.shape[0], shape[:-1])
    z = codebook[idx] + noise * rng.standard_normal(shape)
    return z.astype(np.float32), idx


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    kw = CONFIGS[request.param]
    jcfg, cfg = JaxVAEConfig.tiny(**kw), VAEConfig.tiny(**kw)
    x = np.random.default_rng(0).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    jmodel = JaxVQModel(config=jcfg, n_embed=N_EMBED)
    params = jax.tree.map(np.asarray, _randomize(jmodel.init(jax.random.key(0), jnp.asarray(x)), 1))
    # codebook rows at least ~1 apart in 3-D: each near-code latent has one clear nearest
    params["params"]["quantize"]["embedding"] = (
        2.0 * np.random.default_rng(5).standard_normal((N_EMBED, 3))).astype(np.float32)
    port = VQModel(cfg, n_embed=N_EMBED, device="cpu").eval()
    port.load_state_dict(vq_model_state_dict_from_flax(params, cfg), strict=True)
    return jmodel, params, port, x


def test_encode_is_the_prequant_latent_of_jax(pair):
    jmodel, params, port, x = pair
    want = jmodel.apply(params, jnp.asarray(x), method=JaxVQModel.encode)
    with torch.no_grad():
        got = port.encode(torch.tensor(x))
    assert got.shape == (2, 8, 8, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


@pytest.mark.parametrize("force_not_quantize", [False, True])
def test_decode_matches_jax(pair, force_not_quantize):
    jmodel, params, port, _ = pair
    z, _ = _near_codes(params["params"]["quantize"]["embedding"], (2, 8, 8, 3), 2)
    want = jmodel.apply(params, jnp.asarray(z), force_not_quantize=force_not_quantize,
                        method=JaxVQModel.decode)
    with torch.no_grad():
        got = port.decode(torch.tensor(z), force_not_quantize=force_not_quantize)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_quantizer_indices_and_loss_match_jax(pair):
    _, params, port, _ = pair
    codebook = params["params"]["quantize"]["embedding"]
    z, idx = _near_codes(codebook, (3, 5, 7, 3), 3)
    want_zq, want_loss, want_idx = JaxVectorQuantizer(N_EMBED, 3).apply(
        {"params": params["params"]["quantize"]}, jnp.asarray(z))
    with torch.no_grad():
        zq, loss, got_idx = port.quantize(torch.tensor(z))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_idx.numpy(), idx)
    np.testing.assert_allclose(zq.numpy(), np.asarray(want_zq), rtol=0, atol=1e-6)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5, atol=0)


def test_straight_through_gradient_reaches_z():
    vq = VectorQuantizer(16, 4)
    z = torch.randn(2, 3, 3, 4, generator=torch.Generator().manual_seed(0), requires_grad=True)
    g = torch.randn(2, 3, 3, 4, generator=torch.Generator().manual_seed(1))
    zq, _, idx = vq(z)
    torch.testing.assert_close(zq.detach(), vq.embedding.weight[idx].detach(), rtol=0, atol=1e-6)
    (zq * g).sum().backward()
    torch.testing.assert_close(z.grad, g, rtol=0, atol=0)


def test_round_trip_through_jax_converter_is_exact():
    cfg = VAEConfig.tiny(**TINY)
    sd = init_random_(VQModel(cfg, n_embed=N_EMBED, device="cpu"),
                      torch.Generator().manual_seed(3)).state_dict()
    flax_params = convert_vq_model({k: v.numpy() for k, v in sd.items()}, JaxVAEConfig.tiny(**TINY))
    back = vq_model_state_dict_from_flax(flax_params, cfg)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_vq_cin256_config_matches_jax_and_counts_parameters():
    ours, theirs = VAEConfig.vq_cin256(), JaxVAEConfig.vq_cin256()
    assert ours == VAEConfig(**{f: getattr(theirs, f) for f in ours.__dataclass_fields__})
    model = VQModel(VAEConfig.vq_cin256(), n_embed=8192, device="meta")
    assert model.quantize.embedding.weight.shape == (8192, 3)
    # the JAX VQModel(vq_cin256, n_embed=8192) counts the same (jax.eval_shape of its init)
    assert sum(p.numel() for p in model.parameters()) == 55_322_782


def test_vq_model_refuses_double_z():
    with pytest.raises(ValueError, match="double_z"):
        VQModel(VAEConfig.tiny(), device="cpu")
