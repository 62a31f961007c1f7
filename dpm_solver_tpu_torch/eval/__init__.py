"""Sample-quality metrics (FID, IS, KID) and the FID InceptionV3."""

from dpm_solver_tpu_torch.eval.fid import (
    calculate_fid_given_paths,
    compute_statistics,
    compute_statistics_of_path,
    fid_from_features,
    frechet_distance,
    frechet_distance_torch,
    inception_score,
    kid_from_features,
    load_statistics,
)

__all__ = [
    "calculate_fid_given_paths",
    "compute_statistics",
    "compute_statistics_of_path",
    "fid_from_features",
    "frechet_distance",
    "frechet_distance_torch",
    "inception_score",
    "kid_from_features",
    "load_statistics",
]
