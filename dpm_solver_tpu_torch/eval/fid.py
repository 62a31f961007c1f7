"""Sample-quality metrics: FID, Inception Score, KID.

Port of `dpm_solver_tpu/eval/fid.py`, the protocol twin of the reference's
evaluation stacks (examples/ddpm_and_guided-diffusion/evaluate/
fid_score.py: calculate_frechet_distance :149-204, the activation
statistics :206-262; score_sde run_lib.py:507-563 with tfgan's IS, FID and
KID over pooled Inception features).

Every metric takes features and logits from any extractor
(`eval/inception.py` has the FID InceptionV3). The statistics run on the
host in float64 (NumPy and SciPy), FID's matrix square root being touchy
and small beside the feature extraction; `frechet_distance_torch` is the
on-device form (an eigendecomposition in float64 on the tensors' device,
the twin of the JAX package's `frechet_distance_jax`).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch


def compute_statistics(features) -> Tuple[np.ndarray, np.ndarray]:
    """(N, D) features -> (mu, sigma) in float64 (ref fid_score.py:225-242)."""
    f = np.asarray(features, dtype=np.float64)
    if f.ndim != 2:
        raise ValueError(f"features must be (N, D), got {f.shape}")
    return f.mean(axis=0), np.cov(f, rowvar=False)


def load_statistics(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's stats npz ('mu', 'sigma'; e.g.
    fid_stats_cifar10_train_pytorch.npz; ref fid_score.py:243-248), float64."""
    with np.load(path) as d:
        return d["mu"].astype(np.float64), d["sigma"].astype(np.float64)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """The Fréchet distance between two Gaussians, the reference's
    (fid_score.py:149-204): the eps-jitter retry and the check on the
    square root's imaginary part included."""
    from scipy import linalg

    mu1 = np.atleast_1d(np.asarray(mu1, dtype=np.float64))
    mu2 = np.atleast_1d(np.asarray(mu2, dtype=np.float64))
    sigma1 = np.atleast_2d(np.asarray(sigma1, dtype=np.float64))
    sigma2 = np.atleast_2d(np.asarray(sigma2, dtype=np.float64))
    if mu1.shape != mu2.shape or sigma1.shape != sigma2.shape:
        raise ValueError(f"mismatched statistics: {mu1.shape} {mu2.shape}, "
                         f"{sigma1.shape} {sigma2.shape}")
    diff = mu1 - mu2
    # (the reference's `disp=False`, dropped by later SciPy, changes only
    # whether the error estimate is returned)
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(f"Imaginary component {np.max(np.abs(covmean.imag))}")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2.0 * np.trace(covmean))


def frechet_distance_torch(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> torch.Tensor:
    """The Fréchet distance on the device of `mu1` (a tensor; the CPU for
    arrays), float64: tr sqrt(S1 S2) from the eigenvalues of the symmetric
    product sqrt(S1) S2 sqrt(S1), which has S1 S2's spectrum."""
    dev = mu1.device if torch.is_tensor(mu1) else torch.device("cpu")
    mu1, sigma1, mu2, sigma2 = (torch.as_tensor(v, dtype=torch.float64, device=dev)
                                for v in (mu1, sigma1, mu2, sigma2))
    jitter = eps * torch.eye(sigma1.shape[0], dtype=torch.float64, device=dev)
    w1, v1 = torch.linalg.eigh(sigma1 + jitter)
    sqrt_s1 = (v1 * torch.sqrt(torch.clamp(w1, min=0.0))) @ v1.T
    inner = sqrt_s1 @ (sigma2 + jitter) @ sqrt_s1
    w = torch.linalg.eigvalsh((inner + inner.T) / 2.0)
    tr_sqrt = torch.sum(torch.sqrt(torch.clamp(w, min=0.0)))
    diff = mu1 - mu2
    return diff @ diff + torch.trace(sigma1) + torch.trace(sigma2) - 2.0 * tr_sqrt


def fid_from_features(features, ref_stats: Union[str, Tuple[np.ndarray, np.ndarray]]) -> float:
    """The FID of generated samples' features against a stats npz or (mu, sigma)."""
    mu1, sigma1 = compute_statistics(features)
    mu2, sigma2 = load_statistics(ref_stats) if isinstance(ref_stats, str) else ref_stats
    return frechet_distance(mu1, sigma1, mu2, sigma2)


def inception_score(logits, splits: int = 10) -> Tuple[float, float]:
    """IS from classifier logits (tfgan's, score_sde run_lib.py:529-538):
    exp(E_x KL(p(y|x) || p(y))) in each split; (mean, std) over the splits."""
    logits = np.asarray(logits, dtype=np.float64)
    probs = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs /= probs.sum(axis=1, keepdims=True)
    scores = []
    for part in np.array_split(np.arange(probs.shape[0]), splits):
        if len(part) == 0:
            continue
        p = probs[part]
        marginal = p.mean(axis=0, keepdims=True)
        kl = np.sum(p * (np.log(p + 1e-16) - np.log(marginal + 1e-16)), axis=1)
        scores.append(np.exp(kl.mean()))
    return float(np.mean(scores)), float(np.std(scores))


def kid_from_features(f_gen, f_ref, *, max_block: int = 1024, seed: Optional[int] = None) -> float:
    """Kernel Inception Distance: the polynomial-kernel MMD^2 with tfgan's
    k(x, y) = (x.y / D + 1)^3, averaged over blocks as
    tfgan.eval.kernel_classifier_distance (score_sde run_lib.py:539-549)."""
    x = np.asarray(f_gen, dtype=np.float64)
    y = np.asarray(f_ref, dtype=np.float64)
    d = x.shape[1]
    if seed is not None:
        rng = np.random.RandomState(seed)
        x = x[rng.permutation(x.shape[0])]
        y = y[rng.permutation(y.shape[0])]
    n = min(x.shape[0], y.shape[0])
    n_blocks = max(1, int(np.ceil(n / max_block)))

    def kern(a, b):
        return (a @ b.T / d + 1.0) ** 3

    vals = []
    for a, b in zip(np.array_split(x[:n], n_blocks), np.array_split(y[:n], n_blocks)):
        m, l = a.shape[0], b.shape[0]
        kxx, kyy, kxy = kern(a, a), kern(b, b), kern(a, b)
        term_x = (kxx.sum() - np.trace(kxx)) / (m * (m - 1))
        term_y = (kyy.sum() - np.trace(kyy)) / (l * (l - 1))
        vals.append(term_x + term_y - 2.0 * kxy.mean())
    return float(np.mean(vals))


def compute_statistics_of_path(path: str, feature_fn: Callable, *, batch_size: int = 50):
    """(mu, sigma) of a sample source (ref evaluate/fid_score.py:231-243):
    an `.npz` of statistics ('mu', 'sigma') or of images ('samples', else
    its first array; uint8, or values above 1.5, read as 0-255), or a
    folder of PNG/JPEG files. An all-PNG folder (the reference's 50k-sample
    FID protocol) goes through the native PNG reader in chunks of
    `batch_size`; any other folder through PIL. `feature_fn` maps
    (B, H, W, 3) float32 tensors in [0, 1] to (features, logits)
    (`eval.inception.make_feature_fn`)."""
    if path.endswith(".npz"):
        with np.load(path) as f:
            if "mu" in f.files and "sigma" in f.files:
                return f["mu"][:], f["sigma"][:]
            arr = f["samples" if "samples" in f.files else f.files[0]]
            scale = arr.dtype == np.uint8 or arr.max() > 1.5
            arr = np.asarray(arr, np.float32)
            if scale:
                arr = arr / 255.0
        batches = (arr[i:i + batch_size] for i in range(0, len(arr), batch_size))
    else:
        batches = _folder_batches(path, batch_size)
    feats = [torch.as_tensor(feature_fn(torch.from_numpy(b))[0]).detach().cpu().numpy()
             for b in batches]
    return compute_statistics(np.concatenate(feats))


def _folder_batches(path: str, batch_size: int):
    """float32 [0, 1] (B, H, W, 3) batches of a folder's PNG/JPEG files in
    sorted order."""
    import os

    files = sorted(os.path.join(path, f) for f in os.listdir(path)
                   if f.lower().endswith((".png", ".jpg", ".jpeg")))
    if not files:
        raise FileNotFoundError(f"no images under {path}")
    if all(f.lower().endswith(".png") for f in files):
        # the native threaded batch decode; the reference reads its 50k-file
        # FID folders through a torch DataLoader for the same reason
        # (evaluate/fid_score.py:146-170: ImagePathDataset + workers)
        from dpm_solver_tpu_torch import native

        for i in range(0, len(files), batch_size):
            yield native.read_png_batch(files[i:i + batch_size], channels=3) \
                .astype(np.float32) / 255.0
        return
    from PIL import Image

    for i in range(0, len(files), batch_size):
        yield np.stack([np.asarray(Image.open(f).convert("RGB"), np.float32) / 255.0
                        for f in files[i:i + batch_size]])


def calculate_fid_given_paths(paths, feature_fn: Callable, *, batch_size: int = 50) -> float:
    """The FID between two sample sources (ref fid_score.py:246-262), each an
    image folder, an npz of images or an npz of statistics."""
    m1, s1 = compute_statistics_of_path(paths[0], feature_fn, batch_size=batch_size)
    m2, s2 = compute_statistics_of_path(paths[1], feature_fn, batch_size=batch_size)
    return frechet_distance(m1, s1, m2, s2)
