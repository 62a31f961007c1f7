"""Retrieval-augmented generation (knn2img / RDM), on torch.

Port of `dpm_solver_tpu/pipelines/retrieval.py`, the rebuild of
stable-diffusion's scripts/knn2img.py: an exact CLIP joint-space
nearest-neighbour `Searcher` over a patch-embedding database, and a sampling
front end that conditions a latent-diffusion model on [text query ; k
retrieved image embeddings].

The reference configures the `scann` library as brute-force scoring
(knn2img.py:75-84); here, as in the JAX package, the same exact normalised
dot-product top-k runs on the device: one (Q, D) x (D, N) `torch.matmul`
then `torch.topk`. The database format is the reference's: `.npz` files with
`embedding` / `img_id` / `patch_coords` arrays (knn2img.py:68-119). Where two
scores tie, `torch.topk` and `lax.top_k` may order the indices differently.
"""

from __future__ import annotations

import glob
import os
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from dpm_solver_tpu_torch.pipelines.stable_diffusion import DPMSolverSampler, LatentDiffusion
from dpm_solver_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class Searcher:
    """Exact top-k CLIP-space retrieval over a database held on `device` (the
    card by default).

    `database` may be a dict with an `embedding` (N, D) array or tensor
    (plus optional `img_id` / `patch_coords`), a path to one `.npz`, or a
    directory of `.npz` shards (concatenated, as the reference's multi-file
    loader at knn2img.py:103-119; every shard must carry the same keys).
    """

    def __init__(self, database, device=DEFAULT_DEVICE):
        if isinstance(database, (str, os.PathLike)):
            database = self._load(os.fspath(database))
        emb = database["embedding"]
        emb = (emb.to(resolve_device(device), torch.float32) if torch.is_tensor(emb)
               else torch.as_tensor(np.asarray(emb, np.float32), device=resolve_device(device)))
        if emb.dim() != 2:
            raise ValueError(f"embedding must be (N, D), got {tuple(emb.shape)}")
        self.database = dict(database)
        self.database["embedding"] = emb
        # device-resident and normalised: the (Q, D) x (D, N) product's right side
        self._db = emb / torch.clamp(torch.linalg.vector_norm(emb, dim=1, keepdim=True),
                                     min=1e-12)

    @staticmethod
    def _load(path: str) -> dict:
        files = sorted(glob.glob(os.path.join(path, "*.npz"))) \
            if os.path.isdir(path) else [path]
        if not files:
            raise FileNotFoundError(f"no .npz database under {path}")
        shards = []
        keys = None
        for f in files:
            with np.load(f) as z:
                # every shard must carry the same keys, or concatenated
                # metadata would silently misalign with the embeddings
                if keys is None:
                    keys = set(z.files)
                elif set(z.files) != keys:
                    raise ValueError(
                        f"database shard {f} carries keys {sorted(z.files)} "
                        f"but {files[0]} carries {sorted(keys)}")
                shards.append({k: z[k] for k in z.files})
        return {key: (shards[0][key] if len(shards) == 1
                      else np.concatenate([s[key] for s in shards]))
                for key in keys}

    def __len__(self) -> int:
        return self._db.shape[0]

    def search(self, x, k: int) -> dict:
        """The reference's result dict (knn2img.py:134-159), numpy arrays:
        normalised `nn_embeddings` (Q, k, D), `img_ids`, `patch_coords`, `nns`
        indices, `q_embeddings`, `queries`, and `exec_time` (seconds, the
        device's product and top-k included)."""
        x = _numpy(x).astype(np.float32)
        if x.ndim == 3:  # (B, n_repeat, D) conditioning -> first token
            x = x[:, 0]
        q = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)

        start = time.time()
        k = min(k, len(self))
        scores = torch.matmul(torch.as_tensor(q, device=self._db.device), self._db.T)
        nns_t = torch.topk(scores, k, dim=-1).indices
        emb = self.database["embedding"][nns_t]
        nns = nns_t.cpu().numpy()
        elapsed = time.time() - start

        emb = emb.cpu().numpy()
        emb = emb / np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True), 1e-12)
        out = {
            "nn_embeddings": emb,
            "queries": x,
            "exec_time": elapsed,
            "nns": nns,
            "q_embeddings": q,
        }
        for src, dst in (("img_id", "img_ids"), ("patch_coords", "patch_coords")):
            if src in self.database:
                out[dst] = _numpy(self.database[src])[nns]
        return out

    def __call__(self, x, n: int) -> dict:
        return self.search(x, n)


def build_image_database(images, image_embedder, *, img_ids=None,
                         batch_size: int = 64, save_path: Optional[str] = None):
    """Embed images ([-1, 1] NHWC tensor or array, or an iterable of batches)
    with `image_embedder` (e.g. `FrozenCLIPImageEmbedder`) into a
    reference-format database dict of numpy arrays; optionally saved as one
    `.npz`. Stands in for the reference's pre-built artbench/openimages
    databases."""
    chunks = []
    if hasattr(images, "shape"):
        images = [images[i:i + batch_size] for i in range(0, images.shape[0], batch_size)]
    for batch in images:
        batch = batch if torch.is_tensor(batch) else torch.as_tensor(np.asarray(batch))
        chunks.append(_numpy(image_embedder(batch)))
    emb = np.concatenate(chunks).astype(np.float32)
    db = {
        "embedding": emb,
        "img_id": np.asarray(img_ids if img_ids is not None else np.arange(len(emb))),
        "patch_coords": np.zeros((len(emb), 4), np.int32),
    }
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        np.savez(save_path, **db)
    return db


def _sampler(model: LatentDiffusion) -> DPMSolverSampler:
    """The DPMSolverSampler that knn2img keeps on `model`, made at its first call."""
    sampler = model.__dict__.get("_knn2img_sampler")
    if sampler is None:
        sampler = model._knn2img_sampler = DPMSolverSampler(model)
    return sampler


def knn2img(model: LatentDiffusion, prompts: Sequence[str], *,
            text_embedder: Callable, searcher: Optional[Searcher] = None,
            knn: int = 10, steps: int = 50, guidance_scale: float = 5.0,
            height: int = 768, width: int = 768, x_T: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None, order: int = 2,
            method: str = "multistep", return_nn_info: bool = False):
    """Sample images conditioned on [CLIP(text) ; k retrieved neighbours].

    The knn2img main loop (knn2img.py:348-375): the conditioning is the
    normalised joint text embedding (B, n_repeat, D), concatenated with the
    k nearest database embeddings along the token axis, and the
    unconditional branch is zeros (`uc = torch.zeros_like(c)` at :363), not
    an empty-prompt encoding as in txt2img.

    `text_embedder` maps prompts -> (B, n, D) joint-space embeddings
    (`FrozenCLIPTextJointEmbedder` or a stub). The latent shape follows the
    model's own first stage (f16/z16 for RDM). The initial latent is `x_T`
    (B, h, w, z) or a draw from `generator`. The DPMSolverSampler is kept
    on the model (`_sampler`), so its solvers (and CUDA graphs) serve the
    model's later calls.
    """
    if isinstance(prompts, str):
        prompts = [prompts]
    b = len(prompts)
    dev = model.device
    c = torch.as_tensor(text_embedder(prompts)).to(dev, torch.float32)
    if c.dim() == 2:
        c = c[:, None, :]

    nn_info = None
    if searcher is not None and knn > 0:
        nn_info = searcher(c, knn)
        c = torch.cat([c, torch.as_tensor(nn_info["nn_embeddings"], device=dev)], dim=1)

    uc = torch.zeros_like(c) if guidance_scale != 1.0 else None

    f = 2 ** (len(model.vae.config.ch_mult) - 1)
    shape = (height // f, width // f, model.vae.config.z_channels)
    latents, _ = _sampler(model).sample(
        steps, b, shape, c, unconditional_guidance_scale=guidance_scale,
        unconditional_conditioning=uc, x_T=x_T, generator=generator, order=order,
        method=method, return_intermediate=False)
    img = torch.clamp((model.decode_first_stage(latents) + 1.0) / 2.0, 0.0, 1.0)
    return (img, nn_info) if return_nn_info else img
