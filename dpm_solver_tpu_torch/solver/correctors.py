"""Corrector hooks: dynamic thresholding.

(ref: dpm_solver_pytorch.py:408-425 dynamic_thresholding_fn; the hooks are
consumed at :1180-1241.)
"""

from __future__ import annotations

import torch

from dpm_solver_tpu_torch.utils.trees import bcast_right


def make_dynamic_thresholding(ratio: float = 0.995, max_val: float = 1.0):
    """Imagen dynamic thresholding: clamp x0 to its per-sample `ratio`-quantile
    of |x0| (floored at `max_val`) and rescale into [-1, 1]."""

    def dynamic_thresholding_fn(x0, t=None):
        del t
        s = torch.quantile(x0.abs().reshape(x0.shape[0], -1), ratio, dim=1)
        s = bcast_right(torch.clamp(s, min=max_val), x0.dim())
        return torch.maximum(torch.minimum(x0, s), -s) / s

    return dynamic_thresholding_fn
