"""Score/noise model plumbing: label conventions per SDE family, on torch.

Port of `dpm_solver_tpu/score.py` (ref score_sde models/utils.py:164-254):
converts a raw network `model_fn(x, labels) -> out` into the continuous-time
score function or noise-prediction function each sampler consumes, with the
per-family time-label conventions:

  VP/subVP continuous : labels = t * 999          out = eps  -> score = -eps/std
  VP discrete         : labels = t * (N-1)        out = eps  -> score = -eps/sqrt(1-abar)
  VE continuous       : labels = sigma(t)         out = score
  VE discrete         : labels = round((T-t)(N-1)) out = score
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from dpm_solver_tpu_torch.sde import VESDE, SubVPSDE, VPSDE, batch_mul


def get_score_fn(sde, model_fn: Callable, continuous: bool = True) -> Callable:
    """Returns score(x, t) with t in [0, T]."""
    if isinstance(sde, (VPSDE, SubVPSDE)):
        if continuous or isinstance(sde, SubVPSDE):
            def score_fn(x, t):
                eps = model_fn(x, t * 999.0)
                std = sde.marginal_prob(torch.zeros_like(x), t)[1]
                return batch_mul(-1.0 / std, eps)
        else:
            sqrt_1m_abar = np.sqrt(1.0 - np.cumprod(1.0 - sde._betas()))
            tables = {}   # (dtype, device) -> the table there, made once

            def score_fn(x, t):
                labels = (t * (sde.N - 1)).to(torch.int64)
                eps = model_fn(x, labels.float())
                key = (x.dtype, x.device)
                if key not in tables:
                    tables[key] = torch.as_tensor(sqrt_1m_abar, dtype=x.dtype, device=x.device)
                return batch_mul(-1.0 / tables[key][labels], eps)
        return score_fn
    if isinstance(sde, VESDE):
        if continuous:
            def score_fn(x, t):
                return model_fn(x, sde.marginal_prob(torch.zeros_like(x), t)[1])
        else:
            def score_fn(x, t):
                return model_fn(x, torch.round((sde.T - t) * (sde.N - 1)).float())
        return score_fn
    raise NotImplementedError(f"no score convention for {type(sde).__name__}")


def get_noise_fn(sde, model_fn: Callable, continuous: bool = True) -> Callable:
    """Returns eps_hat(x, t): the noise-prediction view (DPM-Solver input).

    (ref: models/utils.py get_noise_fn; used at sampling.py:571)
    """
    if not isinstance(sde, (VPSDE, SubVPSDE)):
        # generic route: eps = -std * score
        score_fn = get_score_fn(sde, model_fn, continuous)

        def noise_fn(x, t):
            std = sde.marginal_prob(torch.zeros_like(x), t)[1]
            return batch_mul(-std, score_fn(x, t))

        return noise_fn
    if continuous:
        def noise_fn(x, t):
            return model_fn(x, t * 999.0)
    else:
        def noise_fn(x, t):
            return model_fn(x, t * (sde.N - 1))
    return noise_fn
