"""Adaptive step-size DPM-Solver (DPM-Solver-12 / -23), as a host loop on torch.

Port of `dpm_solver_tpu/solver/adaptive.py` (ref dpm_solver_pytorch.py:956-1010).
The step size depends on the running error estimate, so there is no plan:
as in the JAX package the step's schedule math (lambda, lambda^{-1}, alpha,
sigma) runs on the device in x's dtype, through the coefficient code of
`solver/updates.py` with `lib=torch`, and each micro-update is the fused
update kernel fed a one-row coefficient table built on the device. The JAX
`lax.while_loop` becomes a Python loop: the accept test compares E, a global
max over the batch, with 1 on the device (`torch.where`, as in the JAX body),
and each iteration reads one scalar back, the loop condition |s - t_0| >
t_err. That sync is inherent: the next step size depends on it.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from dpm_solver_tpu_torch.ops.fused_update import fused_update
from dpm_solver_tpu_torch.schedule import NoiseScheduleVP
from dpm_solver_tpu_torch.solver import updates as U
from dpm_solver_tpu_torch.solver.plan import end_time
from dpm_solver_tpu_torch.utils.trees import bcast_right


def _row_table(a: torch.Tensor, b) -> torch.Tensor:
    """(1, 5) fp32 table (a, b0, b1, b2, 0) of one segment row on a's device;
    Python-float coefficients are filled there, not copied from the host."""
    cols = [v if isinstance(v, torch.Tensor) else a.new_full((), v) for v in (a, *b, 0.0)]
    return torch.stack(cols).reshape(1, 5).float()


def _exec_segment_rows(eval_fn, x, hist, rows, *, skip_first: int = 0):
    """Apply singlestep micro-rows on the device; returns (x_final, hist)."""
    x_out = x
    for idx, (t_next, a, b, eval_after) in enumerate(rows):
        if idx < skip_first:
            continue
        y = fused_update(_row_table(a, b), 0, x, *hist)
        if eval_after:
            hist = [eval_fn(y, t_next)] + hist[:-1]
        else:
            x_out = y
    return x_out, hist


def adaptive_sample(
    model_fn: Callable,
    ns: NoiseScheduleVP,
    x: torch.Tensor,
    *,
    order: int = 3,
    t_start: Optional[float] = None,
    t_end: Optional[float] = None,
    algorithm_type: str = "dpmsolver++",
    correcting_x0_fn: Optional[Callable] = None,
    h_init: float = 0.05,
    atol: float = 0.0078,
    rtol: float = 0.05,
    theta: float = 0.9,
    t_err: float = 1e-5,
    solver_type: str = "dpmsolver",
) -> Tuple[torch.Tensor, int]:
    """Returns (x_0, nfe). Semantics match the reference controller
    (embedded 1-2 or 2-3 pair, Gotta-Go-Fast defaults, L2-over-delta error,
    all-or-nothing accept)."""
    if algorithm_type not in U.ODE_ALGORITHMS:
        raise ValueError("adaptive solver supports dpmsolver/dpmsolver++ only")
    if order not in (2, 3):
        raise ValueError(f"adaptive order must be 2 or 3, got {order}")
    t_0 = end_time(ns, t_end)
    t_T = ns.T if t_start is None else t_start
    predict_x0 = U.is_predict_x0(algorithm_type)
    x = x.float().contiguous()

    def eval_fn(xi, t):
        eps = model_fn(xi, t).float()
        if not predict_x0:
            return eps.contiguous()
        alpha_t = bcast_right(ns.marginal_alpha(t), xi.dim())
        sigma_t = bcast_right(ns.marginal_std(t), xi.dim())
        x0 = (xi - sigma_t * eps) / alpha_t
        if correcting_x0_fn is not None:
            x0 = correcting_x0_fn(x0, t)
        return x0.contiguous()

    if order == 2:
        r_lo, r_hi = (None, None), (0.5, None)
        lo_order, hi_order = 1, 2
        hi_skip = 0          # higher reuses only m_s
    else:
        r_lo, r_hi = (1.0 / 3.0, None), (1.0 / 3.0, 2.0 / 3.0)
        lo_order, hi_order = 2, 3
        hi_skip = 1          # higher reuses m_s AND m_s1 (same r1 -> same s1)

    scalar = lambda v: torch.tensor(v, dtype=x.dtype, device=x.device)
    lambda_0 = ns.marginal_lambda(scalar(t_0))
    rows = lambda s, t, k, r: U.singlestep_segment_rows(
        ns, s, t, k, r1=r[0], r2=r[1], algorithm_type=algorithm_type,
        solver_type=solver_type, lib=torch)

    x_prev, s = x, scalar(t_T)
    lam_s, h, nfe = ns.marginal_lambda(s), scalar(h_init), 0
    while bool((s - t_0).abs() > t_err):  # the one host sync of an iteration
        t = ns.inverse_lambda(lam_s + h)
        m_s = eval_fn(x, s)
        zeros = torch.zeros_like(m_s)
        x_lower, hist = _exec_segment_rows(eval_fn, x, [m_s, zeros, zeros],
                                           rows(s, t, lo_order, r_lo))
        x_higher, _ = _exec_segment_rows(eval_fn, x, hist, rows(s, t, hi_order, r_hi),
                                         skip_first=hi_skip)
        delta = torch.clamp(rtol * torch.maximum(x_lower.abs(), x_prev.abs()), min=atol)
        diff = (x_higher - x_lower) / delta
        err = diff.reshape(diff.shape[0], -1).square().mean(-1).sqrt().max()
        accept = err <= 1.0
        x = torch.where(accept, x_higher, x)
        x_prev = torch.where(accept, x_lower, x_prev)
        s = torch.where(accept, t, s)
        lam_s = torch.where(accept, ns.marginal_lambda(t), lam_s)
        h = torch.minimum(theta * h * err ** (-1.0 / order), lambda_0 - lam_s)
        nfe += order
    return x, nfe
