"""DPM-Solver++ multistep over a discrete VP schedule, plain, float64 coefficients.

The release's dpm_solver_pytorch.py (NoiseScheduleVP('discrete'),
model_wrapper, DPM_Solver(algorithm_type="dpmsolver++").sample(method=
"multistep")) written again: the schedule's tables are float32-rounded as
the release stores them and interpolated (linearly, extrapolating at the
ends) in float64; a discrete net sees the label (t - 1/N) * 1000; the grid
is time-uniform or uniform in logSNR from t = 1 to 1/N; orders warm up
1, 2, ... and, with lower_order_final below 10 steps, fall at the end;
the 1st, 2nd and 3rd order updates are the data-prediction multistep
formulas of the "dpmsolver" solver type. The state is float64, each network
call takes it in float32.
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch


def _interp(x, xp, fp):
    """Piecewise-linear interpolation of increasing xp, extrapolating linearly at both ends."""
    x = np.asarray(x, dtype=np.float64)
    i = np.clip(np.searchsorted(xp, x, side="left"), 1, len(xp) - 1)
    x0, x1, y0, y1 = xp[i - 1], xp[i], fp[i - 1], fp[i]
    return y0 + (x - x0) * (y1 - y0) / (x1 - x0)


class DiscreteVP:
    def __init__(self, betas=None, alphas_cumprod=None):
        if betas is not None:
            log_alphas = 0.5 * np.cumsum(np.log1p(-np.asarray(betas, dtype=np.float64)))
        else:
            log_alphas = 0.5 * np.log(np.asarray(alphas_cumprod, dtype=np.float64))
        lambdas = log_alphas - 0.5 * np.log1p(-np.exp(2.0 * log_alphas))
        n_clip = int(np.searchsorted(lambdas[::-1], -5.1))   # numerical_clip_alpha
        if n_clip:
            log_alphas = log_alphas[:-n_clip]
        self.N = len(log_alphas)
        t = np.linspace(0.0, 1.0, self.N + 1, dtype=np.float64)[1:]
        self.t_array = t.astype(np.float32).astype(np.float64)
        self.log_alpha_array = log_alphas.astype(np.float32).astype(np.float64)

    def log_alpha(self, t):
        return _interp(t, self.t_array, self.log_alpha_array)

    def alpha(self, t):
        return np.exp(self.log_alpha(t))

    def sigma(self, t):
        return np.sqrt(-np.expm1(2.0 * self.log_alpha(t)))

    def lam(self, t):
        la = self.log_alpha(t)
        return la - 0.5 * np.log(-np.expm1(2.0 * la))

    def inverse_lambda(self, lam):
        log_alpha = -0.5 * np.logaddexp(0.0, -2.0 * np.asarray(lam, dtype=np.float64))
        return _interp(log_alpha, self.log_alpha_array[::-1], self.t_array[::-1])


def time_grid(ns: DiscreteVP, skip_type: str, steps: int) -> np.ndarray:
    t_T, t_0 = 1.0, 1.0 / ns.N
    if skip_type == "time_uniform":
        return np.linspace(t_T, t_0, steps + 1, dtype=np.float64)
    if skip_type == "logSNR":
        return ns.inverse_lambda(np.linspace(float(ns.lam(t_T)), float(ns.lam(t_0)), steps + 1))
    raise ValueError(f"the reference grid is time_uniform or logSNR, not {skip_type!r}")


def orders(steps: int, order: int, lower_order_final: bool) -> List[int]:
    out = []
    for step in range(1, steps + 1):
        if step < order:
            out.append(step)
        elif lower_order_final and steps < 10:
            out.append(min(order, steps + 1 - step))
        else:
            out.append(order)
    return out


def sample(eps_fn: Callable, ns: DiscreteVP, x: torch.Tensor, *, steps: int, order: int,
           skip_type: str, lower_order_final: bool = True) -> torch.Tensor:
    """DPM-Solver++ multistep from x at t = 1 down to 1/N; `eps_fn(x float32,
    labels float32 (B,))` is the network's noise prediction (with guidance)."""
    ts = time_grid(ns, skip_type, steps)
    x = x.double()
    b = x.shape[0]

    def x0(xx, t):
        label = torch.full((b,), (t - 1.0 / ns.N) * 1000.0, dtype=torch.float32, device=x.device)
        eps = eps_fn(xx.float(), label).double()
        return (xx - float(ns.sigma(t)) * eps) / float(ns.alpha(t))

    t_prev, m_prev = [ts[0]], [x0(x, ts[0])]
    for step, k in enumerate(orders(steps, order, lower_order_final), start=1):
        t = ts[step]
        lam_t, lam0 = float(ns.lam(t)), float(ns.lam(t_prev[-1]))
        h = lam_t - lam0
        a_t = float(ns.alpha(t))
        phi_1 = np.expm1(-h)
        x = float(ns.sigma(t) / ns.sigma(t_prev[-1])) * x - a_t * phi_1 * m_prev[-1]
        if k >= 2:
            lam1 = float(ns.lam(t_prev[-2]))
            r0 = (lam0 - lam1) / h
            d1_0 = (m_prev[-1] - m_prev[-2]) / r0
        if k == 2:
            x = x - 0.5 * a_t * phi_1 * d1_0
        elif k == 3:
            lam2 = float(ns.lam(t_prev[-3]))
            r1 = (lam1 - lam2) / h
            d1_1 = (m_prev[-2] - m_prev[-3]) / r1
            d1 = d1_0 + r0 / (r0 + r1) * (d1_0 - d1_1)
            d2 = (d1_0 - d1_1) / (r0 + r1)
            phi_2 = phi_1 / h + 1.0
            phi_3 = phi_2 / h - 0.5
            x = x + a_t * phi_2 * d1 - a_t * phi_3 * d2
        elif k != 1:
            raise ValueError(f"the reference multistep solver has orders 1-3, not {k}")
        t_prev.append(t)
        if step < steps:
            m_prev.append(x0(x, t))
        t_prev, m_prev = t_prev[-3:], m_prev[-3:]
    return x
