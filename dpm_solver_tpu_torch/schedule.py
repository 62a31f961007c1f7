"""Noise schedules for VP diffusion: the logSNR <-> time bijection, on torch.

Port of `dpm_solver_tpu/schedule.py` (ref: dpm_solver_pytorch.py:6-167).
The discrete tables are rounded to float32 once, at construction, exactly as
the JAX package stores them; the torch methods interpolate those tables on
the query's device, and the float64 numpy twins (`*_np`), which the host
planner calls, interpolate the same rounded values in float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SCHEDULES = ("discrete", "linear", "cosine")


def interp_linear_extrap(x, xp, yp):
    """Piecewise-linear interpolation with linear extrapolation at both ends.

    Edge semantics of the reference `interpolate_fn`
    (dpm_solver_pytorch.py:1253-1292): queries beyond the keypoints follow
    the outermost segment. `xp` must be strictly increasing. Takes numpy
    arrays (host) or torch tensors (any device).
    """
    if isinstance(x, torch.Tensor):
        # device tables (NoiseScheduleVP.tables) pass through without a copy
        xp = torch.as_tensor(xp, dtype=x.dtype, device=x.device)
        yp = torch.as_tensor(yp, dtype=x.dtype, device=x.device)
        idx = torch.searchsorted(xp, x.contiguous()).clamp(1, xp.shape[0] - 1)
    else:
        x, xp, yp = np.asarray(x), np.asarray(xp), np.asarray(yp)
        idx = np.clip(np.searchsorted(xp, x, side="left"), 1, xp.shape[0] - 1)
    x0, x1, y0, y1 = xp[idx - 1], xp[idx], yp[idx - 1], yp[idx]
    return y0 + (x - x0) * (y1 - y0) / (x1 - x0)


def _numerical_clip_alpha(log_alphas: np.ndarray, clipped_lambda: float = -5.1) -> np.ndarray:
    """Drop trailing table entries whose half-logSNR falls below `clipped_lambda`
    (ref: dpm_solver_pytorch.py:114-125)."""
    log_sigmas = 0.5 * np.log1p(-np.exp(2.0 * log_alphas))
    lambs = log_alphas - log_sigmas
    n_clip = int(np.searchsorted(lambs[::-1], clipped_lambda))
    if n_clip > 0:
        log_alphas = log_alphas[:-n_clip]
    return log_alphas


def _as_float(t, dtype=torch.float32) -> torch.Tensor:
    """A floating tensor keeps its dtype and device; anything else becomes `dtype`."""
    if isinstance(t, torch.Tensor) and t.is_floating_point():
        return t
    return torch.as_tensor(t, dtype=dtype)


class NoiseScheduleVP:
    """VP forward-process schedule: alpha_t, sigma_t, lambda_t and lambda^{-1}.

    q(x_t | x_0) = N(alpha_t x_0, sigma_t^2 I), lambda_t = log alpha_t - log sigma_t.
    Constructed reference-style, `NoiseScheduleVP('discrete', betas=...)`, or
    through `create`, `discrete`, `linear` and `cosine`, each taking the JAX
    package's arguments. Torch methods take a tensor t and compute in its
    dtype and on its device. `dtype` is the precision the discrete tables are
    rounded to once, the default dtype of `tables()`, and the dtype a t that
    is not a floating tensor is taken in.
    """

    def __init__(self, schedule: str = "discrete", betas=None, alphas_cumprod=None,
                 continuous_beta_0: float = 0.1, continuous_beta_1: float = 20.0,
                 dtype: torch.dtype = torch.float32):
        if schedule not in SCHEDULES:
            raise ValueError(f"Unsupported noise schedule {schedule!r}; need one of {SCHEDULES}.")
        self.schedule, self.dtype = schedule, dtype
        self.beta_0, self.beta_1 = 0.1, 20.0
        self.cosine_s = 0.008
        self.t_array_np = self.log_alpha_array_np = None
        self._tables = {}
        if schedule == "discrete":
            if betas is not None:
                log_alphas = 0.5 * np.cumsum(np.log1p(-np.asarray(betas, dtype=np.float64)))
            elif alphas_cumprod is not None:
                log_alphas = 0.5 * np.log(np.asarray(alphas_cumprod, dtype=np.float64))
            else:
                raise ValueError("discrete schedule needs `betas` or `alphas_cumprod`")
            log_alphas = _numerical_clip_alpha(log_alphas)
            self.total_N = log_alphas.shape[0]
            self.T = 1.0
            # t_i = (i+1)/N over the clipped table (dpm_solver_pytorch.py:105-107);
            # rounded to `dtype` once, like the JAX package's stored tables
            t = np.linspace(0.0, 1.0, self.total_N + 1, dtype=np.float64)[1:]
            rounded = lambda a: torch.as_tensor(a).to(dtype).double().numpy()
            self.t_array_np, self.log_alpha_array_np = rounded(t), rounded(log_alphas)
        elif schedule == "linear":
            self.total_N, self.T = 1000, 1.0
            self.beta_0, self.beta_1 = float(continuous_beta_0), float(continuous_beta_1)
        else:  # cosine: T = 0.9946, as the reference sets it (dpm_solver_jax.py:110-124)
            self.total_N, self.T = 1000, 0.9946

    @staticmethod
    def create(schedule: str = "discrete", betas=None, alphas_cumprod=None,
               continuous_beta_0: float = 0.1, continuous_beta_1: float = 20.0,
               dtype: torch.dtype = torch.float32) -> "NoiseScheduleVP":
        """The JAX package's constructor (dpm_solver_tpu/schedule.py:119-126)."""
        return NoiseScheduleVP(schedule, betas, alphas_cumprod, continuous_beta_0,
                               continuous_beta_1, dtype)

    @staticmethod
    def discrete(betas=None, alphas_cumprod=None,
                 dtype: torch.dtype = torch.float32) -> "NoiseScheduleVP":
        return NoiseScheduleVP("discrete", betas=betas, alphas_cumprod=alphas_cumprod, dtype=dtype)

    @staticmethod
    def linear(beta_0: float = 0.1, beta_1: float = 20.0) -> "NoiseScheduleVP":
        return NoiseScheduleVP("linear", continuous_beta_0=beta_0, continuous_beta_1=beta_1)

    @staticmethod
    def cosine() -> "NoiseScheduleVP":
        return NoiseScheduleVP("cosine")

    def tables(self, device, dtype=None):
        """The discrete (t, log_alpha) tables on `device` in `dtype` (default:
        the schedule's), made once per device and dtype."""
        key = (torch.device(device), dtype or self.dtype)
        if key not in self._tables:
            self._tables[key] = (
                torch.as_tensor(self.t_array_np, dtype=key[1], device=device),
                torch.as_tensor(self.log_alpha_array_np, dtype=key[1], device=device))
        return self._tables[key]

    # ---- torch methods --------------------------------------------------------

    def _log_alpha_cosine(self, t, lib):
        s = self.cosine_s
        return (lib.log(lib.cos((t + s) / (1.0 + s) * math.pi / 2.0))
                - math.log(math.cos(s / (1.0 + s) * math.pi / 2.0)))

    def marginal_log_mean_coeff(self, t: torch.Tensor) -> torch.Tensor:
        """log(alpha_t) for continuous t in (0, T]."""
        t = _as_float(t, self.dtype)
        if self.schedule == "discrete":
            ta, la = self.tables(t.device, t.dtype)
            return interp_linear_extrap(t, ta, la)
        if self.schedule == "linear":
            return -0.25 * t**2 * (self.beta_1 - self.beta_0) - 0.5 * t * self.beta_0
        return self._log_alpha_cosine(t, torch)

    def marginal_alpha(self, t):
        return torch.exp(self.marginal_log_mean_coeff(t))

    def marginal_std(self, t):
        return torch.sqrt(-torch.expm1(2.0 * self.marginal_log_mean_coeff(t)))

    def marginal_lambda(self, t):
        log_alpha = self.marginal_log_mean_coeff(t)
        return log_alpha - 0.5 * torch.log(-torch.expm1(2.0 * log_alpha))

    def inverse_lambda(self, lamb: torch.Tensor) -> torch.Tensor:
        """t such that lambda_t == lamb (lambda is strictly decreasing in t)."""
        lamb = _as_float(lamb, self.dtype)
        zero = torch.zeros_like(lamb)
        if self.schedule == "linear":
            tmp = 2.0 * (self.beta_1 - self.beta_0) * torch.logaddexp(-2.0 * lamb, zero)
            delta = self.beta_0**2 + tmp
            return tmp / (torch.sqrt(delta) + self.beta_0) / (self.beta_1 - self.beta_0)
        log_alpha = -0.5 * torch.logaddexp(zero, -2.0 * lamb)
        if self.schedule == "discrete":
            ta, la = self.tables(lamb.device, lamb.dtype)
            return interp_linear_extrap(log_alpha, la.flip(0), ta.flip(0))
        s = self.cosine_s
        return (torch.arccos(torch.exp(log_alpha + math.log(math.cos(s / (1.0 + s) * math.pi / 2.0))))
                * 2.0 * (1.0 + s) / math.pi - s)

    # ---- float64 numpy twins for the host planner (solver/plan.py) ------------

    def marginal_log_mean_coeff_np(self, t) -> np.ndarray:
        t = np.asarray(t, dtype=np.float64)
        if self.schedule == "discrete":
            return interp_linear_extrap(t, self.t_array_np, self.log_alpha_array_np)
        if self.schedule == "linear":
            return -0.25 * t**2 * (self.beta_1 - self.beta_0) - 0.5 * t * self.beta_0
        return self._log_alpha_cosine(t, np)

    def marginal_alpha_np(self, t) -> np.ndarray:
        return np.exp(self.marginal_log_mean_coeff_np(t))

    def marginal_std_np(self, t) -> np.ndarray:
        return np.sqrt(-np.expm1(2.0 * self.marginal_log_mean_coeff_np(t)))

    def marginal_lambda_np(self, t) -> np.ndarray:
        log_alpha = self.marginal_log_mean_coeff_np(t)
        return log_alpha - 0.5 * np.log(-np.expm1(2.0 * log_alpha))

    def inverse_lambda_np(self, lamb) -> np.ndarray:
        lamb = np.asarray(lamb, dtype=np.float64)
        if self.schedule == "linear":
            tmp = 2.0 * (self.beta_1 - self.beta_0) * np.logaddexp(-2.0 * lamb, 0.0)
            delta = self.beta_0**2 + tmp
            return tmp / (np.sqrt(delta) + self.beta_0) / (self.beta_1 - self.beta_0)
        log_alpha = -0.5 * np.logaddexp(0.0, -2.0 * lamb)
        if self.schedule == "discrete":
            return interp_linear_extrap(log_alpha, self.log_alpha_array_np[::-1],
                                        self.t_array_np[::-1])
        s = self.cosine_s
        return (np.arccos(np.exp(log_alpha + math.log(math.cos(s / (1.0 + s) * math.pi / 2.0))))
                * 2.0 * (1.0 + s) / math.pi - s)


def interpolate_fn(x: torch.Tensor, xp: torch.Tensor, yp: torch.Tensor) -> torch.Tensor:
    """Batched keypoint interpolation of the reference
    (dpm_solver_pytorch.py:1253-1292): x [N, C], xp/yp [C, K] -> [N, C],
    linear extrapolation at both ends, per channel."""
    xt = x.transpose(0, 1).contiguous()                      # [C, N]
    idx = torch.searchsorted(xp.contiguous(), xt).clamp(1, xp.shape[1] - 1)
    g = lambda a, i: torch.gather(a, 1, i)
    x0, x1, y0, y1 = g(xp, idx - 1), g(xp, idx), g(yp, idx - 1), g(yp, idx)
    return (y0 + (xt - x0) * (y1 - y0) / (x1 - x0)).transpose(0, 1)


def expand_dims(v: torch.Tensor, dims: int) -> torch.Tensor:
    """Append trailing singleton axes until `v` has `dims` dimensions
    (dpm_solver_pytorch.py:1295-1305)."""
    v = torch.as_tensor(v)
    return v[(...,) + (None,) * (dims - v.dim())]
