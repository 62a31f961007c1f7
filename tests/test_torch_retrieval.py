"""The port's retrieval pipeline (dpm_solver_tpu_torch/pipelines/retrieval.py)
against the JAX package's `dpm_solver_tpu/pipelines/retrieval.py`, on the CPU.

- `Searcher` from a dict, from one `.npz` and from a directory of shards
  gives the same neighbours; shards whose keys differ are refused;
- exact top-k against the JAX `Searcher` (distinct scores: `torch.topk` and
  `lax.top_k` may order tied indices differently): equal indices, image
  ids and patch coordinates, the normalised neighbour embeddings within
  1e-6;
- `build_image_database` with an image embedder (a fixed projection on
  both sides; the CLIP image embedder itself is held to the JAX one in
  tests/test_torch_text_encoder.py) against the JAX one: the embeddings
  within 2e-5 of their max (tests/test_models.py:64), the same ids, and its
  `.npz` loads into a `Searcher`;
- `knn2img` on a tiny RDM-shaped LDM (a cross-attention UNet over 6-channel
  latents and a KL first stage, random weights of the JAX init's shapes
  carried across by the converters), 4 neighbours, CFG 5 against zeros:
  the images within 1e-4 of max|x| (tests/test_solver_parity.py:70-75), the
  neighbour information equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpm_solver_tpu.models.adm_unet import ADMConfig as JaxADMConfig
from dpm_solver_tpu.models.adm_unet import ADMUNet as JaxADMUNet
from dpm_solver_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from dpm_solver_tpu.models.vae import VAEConfig as JaxVAEConfig
from dpm_solver_tpu.pipelines import LatentDiffusion as JaxLatentDiffusion
from dpm_solver_tpu.pipelines import retrieval as J
from dpm_solver_tpu_torch.models import ADMConfig, ADMUNet, AutoencoderKL, VAEConfig
from dpm_solver_tpu_torch.pipelines import LatentDiffusion
from dpm_solver_tpu_torch.pipelines import retrieval as P
from dpm_solver_tpu_torch.utils.convert import (adm_unet_state_dict_from_flax,
                                                autoencoder_kl_state_dict_from_flax)
from tests.test_torch_wideresnet import random_params

D = 12          # tiny joint-embedding width
NET_TOL = 2e-5  # of max|out|: tests/test_models.py:64
TRAJ_BOUND = 1e-4
EMB_TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's CPU work: these small shapes gain
    nothing from more, and the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _db(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return {"embedding": rng.standard_normal((n, D)).astype(np.float32),
            "img_id": np.arange(n) + 1000,
            "patch_coords": rng.integers(0, 100, (n, 4)).astype(np.int32)}


def _queries(n, seed):
    return np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32)


def test_searcher_loads_a_dict_an_npz_and_a_directory_of_shards(tmp_path):
    db = _db()
    np.savez(tmp_path / "one.npz", **db)
    shards = tmp_path / "shards"
    shards.mkdir()
    np.savez(shards / "part1.npz", **{k: v[:40] for k, v in db.items()})
    np.savez(shards / "part2.npz", **{k: v[40:] for k, v in db.items()})
    q = _queries(3, 1)
    results = [P.Searcher(src, device="cpu").search(q, 5)
               for src in (db, str(tmp_path / "one.npz"), shards)]
    for out in results:
        assert out["nn_embeddings"].shape == (3, 5, D)
        np.testing.assert_array_equal(out["nns"], results[0]["nns"])
        np.testing.assert_array_equal(out["img_ids"], results[0]["img_ids"])
        np.testing.assert_array_equal(out["patch_coords"], results[0]["patch_coords"])
    assert len(P.Searcher(shards, device="cpu")) == 64


def test_searcher_refuses_shards_with_other_keys(tmp_path):
    np.savez(tmp_path / "a.npz", embedding=np.zeros((4, D), np.float32), img_id=np.arange(4))
    np.savez(tmp_path / "b.npz", embedding=np.zeros((4, D), np.float32))
    with pytest.raises(ValueError, match="carries keys"):
        P.Searcher(str(tmp_path), device="cpu")
    with pytest.raises(FileNotFoundError):
        P.Searcher(str(tmp_path / "none"), device="cpu")


@pytest.mark.parametrize("k", [1, 7, 100])
def test_top_k_matches_jax(k):
    db, q = _db(), _queries(5, 2)
    scores = (q / np.linalg.norm(q, axis=1, keepdims=True)) @ (
        db["embedding"] / np.linalg.norm(db["embedding"], axis=1, keepdims=True)).T
    srt = np.sort(scores, axis=1)
    assert np.diff(srt, axis=1).min() > 1e-6     # distinct scores
    want = J.Searcher(db).search(q, k)
    got = P.Searcher(db, device="cpu").search(torch.tensor(q)[:, None].repeat(1, 2, 1), k)
    np.testing.assert_array_equal(got["nns"], np.asarray(want["nns"]))
    np.testing.assert_array_equal(got["img_ids"], want["img_ids"])
    np.testing.assert_array_equal(got["patch_coords"], want["patch_coords"])
    np.testing.assert_allclose(got["nn_embeddings"], want["nn_embeddings"], rtol=0,
                               atol=EMB_TOL)
    np.testing.assert_allclose(got["q_embeddings"], want["q_embeddings"], rtol=0, atol=EMB_TOL)


def _projection_embedder(lib):
    """Any image -> (B, D) callable serves (the CLIP image embedder is held
    to the JAX one in tests/test_torch_text_encoder.py): pixels times a fixed
    projection, on numpy (for JAX) or torch."""
    proj = np.random.RandomState(0).randn(32 * 32 * 3, D).astype(np.float32)

    def embed(batch):
        flat = batch.reshape(batch.shape[0], -1)
        return flat @ (torch.tensor(proj) if lib is torch else jnp.asarray(proj))
    return embed


def test_build_image_database_matches_jax(tmp_path):
    images = np.random.default_rng(5).uniform(-1, 1, (5, 32, 32, 3)).astype(np.float32)
    want = J.build_image_database(images, _projection_embedder(jnp), batch_size=2)
    path = str(tmp_path / "db" / "embeddings.npz")
    got = P.build_image_database(torch.tensor(images), _projection_embedder(torch),
                                 batch_size=2, img_ids=None, save_path=path)
    assert got["embedding"].shape == (5, D) and got["embedding"].dtype == np.float32
    np.testing.assert_allclose(got["embedding"], want["embedding"], rtol=0,
                               atol=NET_TOL * np.abs(want["embedding"]).max())
    np.testing.assert_array_equal(got["img_id"], want["img_id"])
    np.testing.assert_array_equal(got["patch_coords"], want["patch_coords"])
    # each embedding's own nearest neighbour is itself
    out = P.Searcher(path, device="cpu").search(got["embedding"][:3], k=1)
    np.testing.assert_array_equal(out["nns"][:, 0], [0, 1, 2])
    # a list of batches, with ids
    again = P.build_image_database([torch.tensor(images[:3]), torch.tensor(images[3:])],
                                   _projection_embedder(torch), img_ids=np.arange(5) + 7)
    np.testing.assert_array_equal(again["img_id"], np.arange(5) + 7)
    np.testing.assert_allclose(again["embedding"], got["embedding"], rtol=0,
                               atol=NET_TOL * np.abs(got["embedding"]).max())


def _stub_text_embedder(prompts):
    """Deterministic joint-space stub: a unit vector per prompt, (B, 1, D)."""
    rows = []
    for i, p in enumerate(prompts):
        v = np.random.RandomState(len(p) + 31 * i).randn(D).astype(np.float32)
        rows.append(v / np.linalg.norm(v))
    return np.stack(rows)[:, None, :]


@pytest.fixture(scope="module")
def tiny_rdm():
    z = 6
    ukw = dict(image_size=8, in_channels=z, model_channels=32, out_channels=z,
               num_res_blocks=1, attention_resolutions=(1, 2), channel_mult=(1, 2), num_heads=2,
               use_spatial_transformer=True, transformer_depth=1, context_dim=D)
    vkw = dict(resolution=16, attn_resolutions=(), z_channels=z, embed_dim=z)
    unet, vae = JaxADMUNet(config=JaxADMConfig(**ukw)), JaxAutoencoderKL(config=JaxVAEConfig.tiny(**vkw))
    up = random_params(unet, 1, jnp.zeros((1, 8, 8, z)), jnp.ones((1,)), None,
                       jnp.zeros((1, 5, D)))
    vp = random_params(vae, 2, jnp.zeros((1, 16, 16, 3)))
    port_unet = ADMUNet(ADMConfig(**ukw), device="cpu").eval()
    port_unet.load_state_dict(adm_unet_state_dict_from_flax(up, ADMConfig(**ukw)))
    port_vae = AutoencoderKL(VAEConfig.tiny(**vkw), device="cpu").eval()
    port_vae.load_state_dict(autoencoder_kl_state_dict_from_flax(vp, VAEConfig.tiny(**vkw)))
    return (JaxLatentDiffusion(unet=unet, unet_params=up, vae=vae, vae_params=vp),
            LatentDiffusion(port_unet, port_vae))


def test_knn2img_matches_jax(tiny_rdm):
    jax_ldm, port_ldm = tiny_rdm
    prompts = ["a surrealist landscape", "a baroque portrait"]
    key = jax.random.PRNGKey(7)
    kw = dict(knn=4, steps=4, guidance_scale=5.0, height=16, width=16, return_nn_info=True)
    want, want_info = J.knn2img(jax_ldm, prompts, searcher=J.Searcher(_db()), rng=key,
                                text_embedder=lambda p: jnp.asarray(_stub_text_embedder(p)),
                                **kw)
    x_T = torch.tensor(np.asarray(jax.random.normal(key, (2, 8, 8, 6))))
    with torch.no_grad():
        got, info = P.knn2img(port_ldm, prompts, searcher=P.Searcher(_db(), device="cpu"),
                              x_T=x_T, text_embedder=_stub_text_embedder, **kw)
    want = np.asarray(want)
    assert got.shape == want.shape == (2, 16, 16, 3)
    np.testing.assert_array_equal(info["nns"], np.asarray(want_info["nns"]))
    assert np.abs(got.numpy() - want).max() <= TRAJ_BOUND * np.abs(want).max()
