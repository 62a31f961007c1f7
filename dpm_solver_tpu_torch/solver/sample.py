"""Trajectory executor + the public DPM_Solver API, on torch.

Port of `dpm_solver_tpu/solver/sample.py`. The JAX executor compiles a
host-built :class:`SamplePlan` into one XLA program (`lax.scan` over the
coefficient rows plus an unrolled tail). Here the same plan runs as a Python
loop over rows that already live on the device (`SamplePlan.device_tables`):
every coefficient is read from a device tensor, the update is the fused
kernel (`ops/fused_update.py`), and the loop makes no host sync, so a later
change can capture it as one CUDA graph.

Public surface mirrors the reference `DPM_Solver`
(dpm_solver_pytorch.py:337-1245): `.sample`, `.inverse`, `.add_noise`, plus
the functional `build_sampler`. SDE noise is passed in as a tensor.
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, Optional

import torch

from dpm_solver_tpu_torch.ops.fused_update import fused_update
from dpm_solver_tpu_torch.schedule import NoiseScheduleVP
from dpm_solver_tpu_torch.solver import updates as U
from dpm_solver_tpu_torch.solver.adaptive import adaptive_sample
from dpm_solver_tpu_torch.solver.correctors import make_dynamic_thresholding
from dpm_solver_tpu_torch.solver.plan import (
    ALPHA,
    SIGMA,
    T_NEXT,
    SamplePlan,
    build_multistep_plan,
    build_singlestep_plan,
    build_unipc_plan,
    end_time,
)
from dpm_solver_tpu_torch.utils.trees import bcast_right

METHODS = ("multistep", "singlestep", "singlestep_fixed", "adaptive", "unipc")


def _to_x0(x, eps, t, alpha_t, sigma_t, correcting_x0_fn):
    """Reference `data_prediction_fn` core (dpm_solver_pytorch.py:433-442)."""
    x0 = (x - sigma_t * eps) / alpha_t
    if correcting_x0_fn is not None:
        x0 = correcting_x0_fn(x0, t)
    return x0


def _make_eval_fn(model_fn, predict_x0: bool, correcting_x0_fn):
    """Per-NFE model evaluation in the solver's prediction space, in fp32."""

    def eval_fn(x, t, alpha_t, sigma_t):
        eps = model_fn(x, t).float()
        if not predict_x0:
            return eps
        return _to_x0(x, eps, t, alpha_t, sigma_t, correcting_x0_fn)

    return eval_fn


def _noise_at(noise, plan: SamplePlan, step: int):
    """SDE noise of 1-based `step` (the JAX executor's `fold_in(rng, step)`)."""
    if not plan.has_noise:
        return None
    return noise[step - 1]


def execute_plan(
    model_fn: Callable,
    plan: SamplePlan,
    x: torch.Tensor,
    *,
    predict_x0: bool,
    noise: Optional[torch.Tensor] = None,
    correcting_x0_fn: Optional[Callable] = None,
    correcting_xt_fn: Optional[Callable] = None,
    return_intermediate: bool = False,
):
    """Run a planned trajectory from x (fp32) on x's device.

    SDE plans take `noise`, one standard-normal draw per step:
    (steps, *x.shape), where noise[step - 1] enters step `step`.

    History is the newest-first triple of the JAX executor (`_push_hist`),
    kept as a Python list of three tensors that rotates on each push: no
    tensor is copied or updated in place.
    """
    if plan.has_noise:
        if noise is None:
            raise ValueError("SDE plan requires `noise` of shape (steps, *x.shape)")
        if tuple(noise.shape[1:]) != tuple(x.shape):
            raise ValueError(f"noise must be (steps, *{tuple(x.shape)}); got {tuple(noise.shape)}")
    x = x.float().contiguous()
    dev = plan.device_tables(x.device)
    eval_fn = _make_eval_fn(model_fn, predict_x0, correcting_x0_fn)
    intermediates: List[torch.Tensor] = []
    zeros = torch.zeros_like(x)
    hist = [zeros, zeros, zeros]

    def push(m):
        hist[:] = [m.contiguous(), hist[0], hist[1]]

    # --- initial model eval (multistep-style plans) ---
    if not math.isnan(plan.t_first):
        t0, a0, s0 = dev["init"]
        push(eval_fn(x, t0, a0, s0))
        if plan.initial_correct_record:
            if correcting_xt_fn is not None:
                x = correcting_xt_fn(x, t0, 0)
            if return_intermediate:
                intermediates.append(x)

    # --- homogeneous body: update -> correct -> record -> eval ---
    if plan.scan_rows is not None:
        tab, corr = dev["scan"], dev["scan_corr"]
        for i in range(plan.scan_rows.n_ops):
            step = i + 1
            t_next, alpha, sigma = tab[i, T_NEXT], tab[i, ALPHA], tab[i, SIGMA]
            x_new = fused_update(tab, i, x, *hist, _noise_at(noise, plan, step))
            if correcting_xt_fn is not None:
                x_new = correcting_xt_fn(x_new, t_next, step)
            m = eval_fn(x_new, t_next, alpha, sigma)
            if corr is not None:
                # UniC: re-anchor at the previous x with the step's one model
                # value as the extra term (the fused update with z = m)
                x_new = fused_update(corr, i, x, *hist, m.contiguous())
                if correcting_xt_fn is not None:
                    x_new = correcting_xt_fn(x_new, t_next, step)
            push(m)
            x = x_new
            if return_intermediate:
                intermediates.append(x)

    # --- singlestep segment groups: history is segment-local ---
    for gs, tab in zip(plan.seg_scans, dev["seg"]):
        r = len(gs.eval_after)
        for seg in range(gs.n_seg):
            step = int(gs.step_index[seg])
            hist[:] = [zeros, zeros, zeros]
            for k in range(r):
                row = seg * r + k
                y = fused_update(tab, row, x, *hist)
                if gs.commit[k]:
                    if correcting_xt_fn is not None:
                        y = correcting_xt_fn(y, tab[row, T_NEXT], step)
                    x = y
                if gs.eval_after[k]:
                    push(eval_fn(y, tab[row, T_NEXT], tab[row, ALPHA], tab[row, SIGMA]))
            if return_intermediate:
                intermediates.append(x)

    # --- tail: heterogeneous micro-ops ---
    if plan.tail_rows is not None:
        tab = dev["tail"]
        for k in range(plan.tail_rows.n_ops):
            step = plan.tail_step_index[k]
            y = fused_update(tab, k, x, *hist, _noise_at(noise, plan, step))
            if plan.tail_commit[k]:
                if correcting_xt_fn is not None:
                    y = correcting_xt_fn(y, tab[k, T_NEXT], step)
                x = y
                if return_intermediate:
                    intermediates.append(x)
            if plan.tail_eval[k]:
                push(eval_fn(y, tab[k, T_NEXT], tab[k, ALPHA], tab[k, SIGMA]))

    # --- optional denoise-to-zero: x <- x0_prediction(x, t_0) ---
    if plan.denoise_final:
        t_d = torch.tensor(plan.t_denoise, dtype=torch.float32, device=x.device)
        if predict_x0:
            x = eval_fn(x, t_d, plan.alpha_denoise, plan.sigma_denoise)
        else:
            x = _to_x0(x, model_fn(x, t_d).float(), t_d, plan.alpha_denoise,
                       plan.sigma_denoise, correcting_x0_fn)
        if correcting_xt_fn is not None:
            x = correcting_xt_fn(x, t_d, plan.denoise_step_index)
        if return_intermediate:
            intermediates.append(x)

    if return_intermediate:
        return x, intermediates
    return x


# --------------------------------------------------------------------------- #
# plan construction from reference-style arguments
# --------------------------------------------------------------------------- #


def make_plan(
    ns: NoiseScheduleVP,
    *,
    steps: int = 20,
    t_start: Optional[float] = None,
    t_end: Optional[float] = None,
    order: int = 2,
    skip_type: str = "time_uniform",
    method: str = "multistep",
    lower_order_final: bool = True,
    denoise_to_zero: bool = False,
    solver_type: str = "dpmsolver",
    algorithm_type: str = "dpmsolver++",
    timesteps=None,
    variant: str = "bh2",
) -> SamplePlan:
    if method == "unipc":
        return build_unipc_plan(
            ns, steps, order, t_start=t_start, t_end=t_end, skip_type=skip_type,
            algorithm_type=algorithm_type, variant=variant,
            lower_order_final=lower_order_final, denoise_to_zero=denoise_to_zero,
            timesteps=timesteps,
        )
    if method == "multistep":
        return build_multistep_plan(
            ns, steps, order, t_start=t_start, t_end=t_end, skip_type=skip_type,
            algorithm_type=algorithm_type, solver_type=solver_type,
            lower_order_final=lower_order_final, denoise_to_zero=denoise_to_zero,
            timesteps=timesteps,
        )
    if method in ("singlestep", "singlestep_fixed"):
        return build_singlestep_plan(
            ns, steps, order, t_start=t_start, t_end=t_end, skip_type=skip_type,
            algorithm_type=algorithm_type, solver_type=solver_type,
            fixed=(method == "singlestep_fixed"), denoise_to_zero=denoise_to_zero,
        )
    raise ValueError(f"make_plan supports fixed-grid methods, got {method!r}")


def build_sampler(
    model_fn: Callable,
    ns: NoiseScheduleVP,
    *,
    algorithm_type: str = "dpmsolver++",
    correcting_x0_fn: Optional[Callable] = None,
    correcting_xt_fn: Optional[Callable] = None,
    return_intermediate: bool = False,
    **plan_kwargs: Any,
) -> Callable:
    """Functional entry: plans once and returns `fn(x, noise=None) -> x0`."""
    plan = make_plan(ns, algorithm_type=algorithm_type, **plan_kwargs)
    predict_x0 = U.is_predict_x0(algorithm_type)

    def fn(x, noise=None):
        return execute_plan(
            model_fn, plan, x, predict_x0=predict_x0, noise=noise,
            correcting_x0_fn=correcting_x0_fn, correcting_xt_fn=correcting_xt_fn,
            return_intermediate=return_intermediate,
        )

    return fn


# --------------------------------------------------------------------------- #
# reference-compatible class API
# --------------------------------------------------------------------------- #


class DPM_Solver:
    """Drop-in equivalent of the reference `DPM_Solver` class, on torch.

    `.sample` plans each configuration once, on the host in float64, and
    keeps the plan (and its device tables) for later calls. SDE algorithm
    types take their noise as a tensor (`noise=` of `.sample`).
    `method="adaptive"` runs `solver/adaptive.py` (no plan: its step sizes
    follow the error estimate). `mesh=` is not ported yet and raises.
    """

    def __init__(
        self,
        model_fn: Callable,
        noise_schedule: NoiseScheduleVP,
        algorithm_type: str = "dpmsolver++",
        correcting_x0_fn: Optional[Any] = None,
        correcting_xt_fn: Optional[Callable] = None,
        thresholding_max_val: float = 1.0,
        dynamic_thresholding_ratio: float = 0.995,
    ):
        if algorithm_type not in U.ALGORITHM_TYPES:
            raise ValueError(
                f"algorithm_type must be one of {U.ALGORITHM_TYPES}, got {algorithm_type!r}")
        self.model_fn_raw = model_fn
        self.noise_schedule = noise_schedule
        self.algorithm_type = algorithm_type
        if correcting_x0_fn == "dynamic_thresholding":
            self.correcting_x0_fn = make_dynamic_thresholding(
                dynamic_thresholding_ratio, thresholding_max_val)
        else:
            self.correcting_x0_fn = correcting_x0_fn
        self.correcting_xt_fn = correcting_xt_fn
        self._plans = {}

    # -- reference helper surface ------------------------------------------------

    def noise_prediction_fn(self, x, t):
        return self.model_fn_raw(x, t)

    def data_prediction_fn(self, x, t):
        ns = self.noise_schedule
        eps = self.noise_prediction_fn(x, t)
        alpha_t = bcast_right(ns.marginal_alpha(t), x.dim())
        sigma_t = bcast_right(ns.marginal_std(t), x.dim())
        x0 = (x - sigma_t * eps) / alpha_t
        if self.correcting_x0_fn is not None:
            x0 = self.correcting_x0_fn(x0, t)
        return x0

    def add_noise(self, x, t, noise):
        """xt = alpha_t x + sigma_t noise; t of shape (t_size,), noise of shape
        (t_size, *x.shape). (ref: dpm_solver_pytorch.py:1012-1030)"""
        ns = self.noise_schedule
        t = torch.atleast_1d(torch.as_tensor(t, dtype=torch.float32, device=x.device))
        alpha_t, sigma_t = ns.marginal_alpha(t), ns.marginal_std(t)
        x = x[None]
        xt = bcast_right(alpha_t, x.dim()) * x + bcast_right(sigma_t, x.dim()) * noise
        return xt[0] if t.shape[0] == 1 else xt

    # -- sampling ----------------------------------------------------------------

    def sample(
        self,
        x: torch.Tensor,
        steps: int = 20,
        t_start: Optional[float] = None,
        t_end: Optional[float] = None,
        order: int = 2,
        skip_type: str = "time_uniform",
        method: str = "multistep",
        lower_order_final: bool = True,
        denoise_to_zero: bool = False,
        solver_type: str = "dpmsolver",
        atol: float = 0.0078,
        rtol: float = 0.05,
        return_intermediate: bool = False,
        noise: Optional[torch.Tensor] = None,
        variant: str = "bh2",
        mesh=None,
        denoise: Optional[bool] = None,
    ):
        if denoise is not None:  # older JAX kwarg (dpm_solver_jax.py:966-968)
            denoise_to_zero = bool(denoise)
        if method not in METHODS:
            raise ValueError(f"method must be one of {METHODS}, got {method!r}")
        if mesh is not None:
            raise NotImplementedError(
                "mesh= is not ported to dpm_solver_tpu_torch yet (Slice G)")
        # the older JAX API spells it 'dpm_solver' (dpm_solver_jax.py:541)
        solver_type = {"dpm_solver": "dpmsolver"}.get(solver_type, solver_type)
        if method == "adaptive":
            return self._sample_adaptive(x, order, t_start, t_end, denoise_to_zero,
                                         solver_type, atol, rtol, return_intermediate)
        key = (steps, t_start, t_end, order, skip_type, method, lower_order_final,
               denoise_to_zero, solver_type, variant)
        plan = self._plans.get(key)
        if plan is None:
            plan = make_plan(
                self.noise_schedule, steps=steps, t_start=t_start, t_end=t_end,
                order=order, skip_type=skip_type, method=method,
                lower_order_final=lower_order_final, denoise_to_zero=denoise_to_zero,
                solver_type=solver_type, algorithm_type=self.algorithm_type,
                variant=variant,
            )
            self._plans[key] = plan
        return execute_plan(
            self.model_fn_raw, plan, x,
            predict_x0=U.is_predict_x0(self.algorithm_type), noise=noise,
            correcting_x0_fn=self.correcting_x0_fn,
            correcting_xt_fn=self.correcting_xt_fn,
            return_intermediate=return_intermediate,
        )

    def _sample_adaptive(self, x, order, t_start, t_end, denoise_to_zero, solver_type,
                         atol, rtol, return_intermediate):
        if return_intermediate:
            raise ValueError("cannot save intermediates with the adaptive solver")
        if self.correcting_xt_fn is not None:
            raise ValueError("cannot use correcting_xt_fn with the adaptive solver")
        x_out, _nfe = adaptive_sample(
            self.model_fn_raw, self.noise_schedule, x, order=order, t_start=t_start,
            t_end=t_end, algorithm_type=self.algorithm_type,
            correcting_x0_fn=self.correcting_x0_fn, atol=atol, rtol=rtol,
            solver_type=solver_type)
        if denoise_to_zero:
            # the reference applies denoise_to_zero after every method,
            # adaptive included (dpm_solver_pytorch.py:1235-1241)
            ns = self.noise_schedule
            t_d = end_time(ns, t_end)
            t_dev = torch.tensor(t_d, dtype=x_out.dtype, device=x_out.device)
            x_out = _to_x0(x_out, self.model_fn_raw(x_out, t_dev).float(), t_dev,
                           float(ns.marginal_alpha_np(t_d)), float(ns.marginal_std_np(t_d)),
                           self.correcting_x0_fn)
        return x_out

    def inverse(
        self,
        x: torch.Tensor,
        steps: int = 20,
        t_start: Optional[float] = None,
        t_end: Optional[float] = None,
        order: int = 2,
        skip_type: str = "time_uniform",
        method: str = "multistep",
        lower_order_final: bool = True,
        denoise_to_zero: bool = False,
        solver_type: str = "dpmsolver",
        atol: float = 0.0078,
        rtol: float = 0.05,
        return_intermediate: bool = False,
        noise: Optional[torch.Tensor] = None,
    ):
        """Run the ODE t_start -> T for deterministic encoding (DiffEdit).

        (ref: dpm_solver_pytorch.py:1032-1045)
        """
        ns = self.noise_schedule
        t_0 = end_time(ns, t_start)
        t_T = ns.T if t_end is None else t_end
        return self.sample(
            x, steps=steps, t_start=t_0, t_end=t_T, order=order, skip_type=skip_type,
            method=method, lower_order_final=lower_order_final,
            denoise_to_zero=denoise_to_zero, solver_type=solver_type, atol=atol, rtol=rtol,
            return_intermediate=return_intermediate, noise=noise,
        )
