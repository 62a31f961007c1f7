"""Trajectory executor + the public DPM_Solver API, on torch.

Port of `dpm_solver_tpu/solver/sample.py`. The JAX executor compiles a
host-built :class:`SamplePlan` into one XLA program (`lax.scan` over the
coefficient rows plus an unrolled tail), cached per plan and input
signature (`DPM_Solver.sample(jit=True)`). Here the same plan runs as a
Python loop over rows that already live on the device
(`SamplePlan.device_tables`): every coefficient is read from a device
tensor, the update is the fused kernel (`ops/fused_update.py`), and after
the first call the loop makes no host sync and no tensor from host data. So
on a CUDA tensor the whole fixed-grid trajectory is captured once as one
CUDA graph and replayed (`GraphedSampler`, the counterpart of JAX's
`jit_hoisting_constants`), which is what `sample(jit=True)` does there; on
the CPU, and with `jit=False`, the loop runs eagerly.

Public surface mirrors the reference `DPM_Solver`
(dpm_solver_pytorch.py:337-1245): `.sample`, `.inverse`, `.add_noise`, plus
the functional `build_sampler`. SDE noise is passed in as a tensor.
"""

from __future__ import annotations

import contextlib
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
from dpm_solver_tpu_torch.utils.graphs import SegmentedGraph
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


def _device_guard(x: torch.Tensor):
    """x's device made the current one for a call (the fused update's Triton
    launcher reads it), once a call rather than once a launch."""
    return torch.cuda.device(x.device) if x.device.type == "cuda" else contextlib.nullcontext()


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

    The fused update's operand checks are made here once a call: the tables
    are the plan's own, x and every model value are made contiguous fp32 of
    x's shape and device as they enter the history, so each launch skips
    them (`fused_update(check=False)`).
    """
    if plan.has_noise:
        if noise is None:
            raise ValueError("SDE plan requires `noise` of shape (steps, *x.shape)")
        if tuple(noise.shape[1:]) != tuple(x.shape):
            raise ValueError(f"noise must be (steps, *{tuple(x.shape)}); got {tuple(noise.shape)}")
        if noise.device != x.device:
            raise ValueError(f"noise is on {noise.device}, x on {x.device}")
        noise = noise.float().contiguous()
    if x.numel() >= 2**31:
        raise ValueError("the fused update takes fewer than 2**31 elements")
    with _device_guard(x):
        return _run_plan(model_fn, plan, x.float().contiguous(), predict_x0, noise,
                         correcting_x0_fn, correcting_xt_fn, return_intermediate)


def _run_plan(model_fn, plan, x, predict_x0, noise, correcting_x0_fn, correcting_xt_fn,
              return_intermediate):
    dev = plan.device_tables(x.device)
    eval_fn = _make_eval_fn(model_fn, predict_x0, correcting_x0_fn)
    intermediates: List[torch.Tensor] = []
    zeros = torch.zeros_like(x)
    hist = [zeros, zeros, zeros]

    def state(u):
        """A value the fused update reads: contiguous fp32 of x's shape and device."""
        u = u.float().contiguous()
        if u.shape != x.shape or u.device != x.device:
            raise ValueError(f"the solver's state must be {tuple(x.shape)} on {x.device}; got "
                             f"{tuple(u.shape)} on {u.device}")
        return u

    def push(m):
        hist[:] = [state(m), hist[0], hist[1]]

    def update(tab, row, y, z=None):
        return fused_update(tab, row, y, *hist, z, check=False)

    # --- initial model eval (multistep-style plans) ---
    if not math.isnan(plan.t_first):
        t0, a0, s0 = dev["init"]
        push(eval_fn(x, t0, a0, s0))
        if plan.initial_correct_record:
            if correcting_xt_fn is not None:
                x = state(correcting_xt_fn(x, t0, 0))
            if return_intermediate:
                intermediates.append(x)

    # --- homogeneous body: update -> correct -> record -> eval ---
    if plan.scan_rows is not None:
        tab, corr = dev["scan"], dev["scan_corr"]
        for i in range(plan.scan_rows.n_ops):
            step = i + 1
            t_next, alpha, sigma = tab[i, T_NEXT], tab[i, ALPHA], tab[i, SIGMA]
            x_new = update(tab, i, x, _noise_at(noise, plan, step))
            if correcting_xt_fn is not None:
                x_new = state(correcting_xt_fn(x_new, t_next, step))
            m = state(eval_fn(x_new, t_next, alpha, sigma))
            if corr is not None:
                # UniC: re-anchor at the previous x with the step's one model
                # value as the extra term (the fused update with z = m)
                x_new = update(corr, i, x, m)
                if correcting_xt_fn is not None:
                    x_new = state(correcting_xt_fn(x_new, t_next, step))
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
                y = update(tab, row, x)
                if gs.commit[k]:
                    if correcting_xt_fn is not None:
                        y = state(correcting_xt_fn(y, tab[row, T_NEXT], step))
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
            y = update(tab, k, x, _noise_at(noise, plan, step))
            if plan.tail_commit[k]:
                if correcting_xt_fn is not None:
                    y = state(correcting_xt_fn(y, tab[k, T_NEXT], step))
                x = y
                if return_intermediate:
                    intermediates.append(x)
            if plan.tail_eval[k]:
                push(eval_fn(y, tab[k, T_NEXT], tab[k, ALPHA], tab[k, SIGMA]))

    # --- optional denoise-to-zero: x <- x0_prediction(x, t_0) ---
    if plan.denoise_final:
        t_d = dev["denoise"]
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
# the fixed-grid trajectory as one CUDA graph
# --------------------------------------------------------------------------- #


def graph_key(x: torch.Tensor, noise: Optional[torch.Tensor] = None, *batched) -> tuple:
    """What a captured trajectory is specialised to besides its plan, as the
    JAX cache key (`dpm_solver_tpu/solver/sample.py:512-516`) has it: x's
    shape, dtype and device, and the noise's shape and dtype (None: no
    noise); and the shape, dtype and device of each per-sample tensor the
    call passes on (`GraphedSampler`'s `batched`)."""
    return (tuple(x.shape), x.dtype, x.device,
            None if noise is None else (tuple(noise.shape), noise.dtype),
            *((tuple(b.shape), b.dtype, b.device) for b in batched))


def _clone(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    return type(out)(_clone(u) for u in out)


class GraphedSampler:
    """`fn(x, noise=None, *batched)` captured once per `graph_key` and
    replayed: the port's counterpart of
    `dpm_solver_tpu/solver/sample.py::jit_hoisting_constants`, for
    `build_sampler` users (and `DPM_Solver.sample(jit=True)`).

    jit_hoisting_constants compiles the sampler once and feeds its closed-over
    arrays (the weights) to the program as arguments. Here the program is
    the graph of every kernel the call launches; x, the noise and the
    per-sample tensors `batched` (conditioning rows a sharded sampler slices
    with x, `parallel/mesh.py`) are static buffers each call copies into, and
    the result is copied out. The graph reads every other tensor the closure
    holds (the weights, the plan's tables, a caller's conditioning) where it
    lay at capture: a caller that changes one between calls updates it in
    place (`copy_`), as `pipelines/stable_diffusion.py::DPMSolverSampler`
    does with each call's conditioning.

    On a CUDA x, the first call of a key runs `fn` once eagerly on a side
    stream (it builds the plan's device tables, compiles and loads the
    kernels), then captures it (`utils/graphs.py::SegmentedGraph`: one graph,
    or one a segment where the network's gloo collectives split it, as under
    tensor parallelism over gloo); a failed capture raises. A replay launches every
    captured kernel but runs no Python outside the collectives, so the launch
    counters of `ops` count the warm call and the capture, never a replay.
    On a CPU x, `fn` runs eagerly. `GraphedSampler.captures` counts captures.
    """

    captures = 0

    def __init__(self, fn: Callable):
        self.fn = fn
        self._graphs = {}

    def _call(self, x, noise, batched):
        if batched:
            return self.fn(x, noise, *batched)
        return self.fn(x) if noise is None else self.fn(x, noise)

    def __call__(self, x: torch.Tensor, noise: Optional[torch.Tensor] = None, *batched):
        if x.device.type != "cuda":
            return self._call(x, noise, batched)
        key = graph_key(x, noise, *batched)
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._graphs[key] = self._capture(x, noise, batched)
        graph, statics, out = entry
        for static, value in zip(statics, (x, noise, *batched)):
            if static is not None:
                static.copy_(value)
        graph.replay()
        return _clone(out)

    def _capture(self, x, noise, batched):
        statics = [None if u is None else u.clone() for u in (x, noise, *batched)]
        args = (statics[0], statics[1], tuple(statics[2:]))
        with torch.cuda.device(x.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self._call(*args)
            torch.cuda.current_stream().wait_stream(side)
            graph = SegmentedGraph()
            out = graph.capture(self._call, *args)
        GraphedSampler.captures += 1
        return graph, statics, out


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
    """Functional entry: plans once and returns `fn(x, noise=None) -> x0`,
    run eagerly; `GraphedSampler(fn)` replays it as a CUDA graph."""
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
    keeps the plan (and its device tables) for later calls. With `jit=True`
    (the JAX default) a fixed-grid call on a CUDA x replays a CUDA graph of
    the whole trajectory, captured once per JAX cache key (the plan's
    arguments, `return_intermediate`, and x's shape, dtype and device and
    the noise's: `graph_key`) and kept on the solver, as JAX keeps its
    compiled program (`GraphedSampler`); with `jit=False`, or on the CPU,
    the loop runs eagerly. SDE algorithm types take their noise as a tensor
    (`noise=` of `.sample`). `method="adaptive"` runs `solver/adaptive.py`
    (no plan: its step sizes follow the error estimate, one host read a
    step), eagerly whatever `jit` says. `mesh=` (a DeviceMesh,
    `parallel.make_mesh`) splits the global batch x (and the noise) over
    the mesh's data axis: each rank replays its rows' trajectory
    (`parallel.make_sharded_sampler`) and every rank returns the gathered
    global result. The model function runs on a rank's rows, so any
    per-sample conditioning it closes over must be that rank's rows
    (`parallel.batch_sharding(mesh).local`), as the pipelines do.
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
        # plan key + return_intermediate (+ the mesh) -> GraphedSampler (or
        # the sharded sampler over it)
        self._graphed = {}

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
        jit: bool = True,
    ):
        if denoise is not None:  # older JAX kwarg (dpm_solver_jax.py:966-968)
            denoise_to_zero = bool(denoise)
        if method not in METHODS:
            raise ValueError(f"method must be one of {METHODS}, got {method!r}")
        if mesh is not None and not jit:
            raise ValueError("mesh= implies a graphed (jit) sampler; jit=False is not supported "
                             "with a mesh (drop mesh= for eager execution)")
        if mesh is not None and method == "adaptive":
            raise ValueError("method='adaptive' does not take a mesh (per-rank step-size control "
                             "would diverge across shards); shard fixed-grid methods")
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

        def run(xx, nz=None):
            return execute_plan(
                self.model_fn_raw, plan, xx,
                predict_x0=U.is_predict_x0(self.algorithm_type), noise=nz,
                correcting_x0_fn=self.correcting_x0_fn,
                correcting_xt_fn=self.correcting_xt_fn,
                return_intermediate=return_intermediate,
            )

        if mesh is not None:
            if plan.has_noise and noise is None:
                # the single-device path's check, before any rank slices
                raise ValueError("SDE plan requires `noise` of shape (steps, *x.shape), on the "
                                 "mesh path too")
            gkey = key + (return_intermediate, mesh)
            sharded = self._graphed.get(gkey)
            if sharded is None:
                from dpm_solver_tpu_torch.parallel.mesh import make_sharded_sampler

                sharded = self._graphed[gkey] = make_sharded_sampler(run, mesh)
            return sharded(x, noise)
        if not jit or x.device.type != "cuda":
            return run(x, noise)
        graphed = self._graphed.get(key + (return_intermediate,))
        if graphed is None:
            graphed = self._graphed[key + (return_intermediate,)] = GraphedSampler(run)
        return graphed(x, noise)

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
        jit: bool = True,
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
            return_intermediate=return_intermediate, noise=noise, jit=jit,
        )
