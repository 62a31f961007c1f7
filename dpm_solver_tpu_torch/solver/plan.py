"""Host-side trajectory planning: time grids and static coefficient tables.

The TPU-first idea: for the fixed-grid methods (multistep / singlestep /
singlestep_fixed) *nothing* about the trajectory depends on the data — the
time grid, per-step orders, and every exponential-integrator coefficient are
functions of the noise schedule and the run configuration only. So we compute
them all here, on the host, in float64, and the device loop degenerates to

    for each row { A, b[3], s_noise, alpha/sigma at the eval time }

with one model evaluation per row. No interpolation, no inverse_lambda and
no host sync inside the trajectory: `SamplePlan.device_tables` packs the rows
into fp32 tensors on the device once per plan and device, and the executor
(solver/sample.py) reads each coefficient there.

Port of `dpm_solver_tpu/solver/plan.py`; numpy float64 only, no torch except
in `device_tables`.

(ref semantics being planned: dpm_solver_pytorch.py:453-539 grids,
:1171-1233 multistep/singlestep loops.)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from dpm_solver_tpu_torch.schedule import NoiseScheduleVP
from dpm_solver_tpu_torch.solver import updates as U

SKIP_TYPES = ("logSNR", "time_uniform", "time_quadratic", "karras")
MIN_SCAN = 2  # shortest run of same-order singlestep segments kept as a seg scan


# --------------------------------------------------------------------------- #
# time grids
# --------------------------------------------------------------------------- #


def get_time_steps(ns: NoiseScheduleVP, skip_type: str, t_T: float, t_0: float,
                   N: int) -> np.ndarray:
    """Decreasing time grid with N+1 points from t_T to t_0 (float64 host).

    (ref: dpm_solver_pytorch.py:453-480)
    """
    if skip_type == "logSNR":
        lambda_T = ns.marginal_lambda_np(t_T)
        lambda_0 = ns.marginal_lambda_np(t_0)
        logsnr_steps = np.linspace(float(lambda_T), float(lambda_0), N + 1)
        return np.asarray(ns.inverse_lambda_np(logsnr_steps), dtype=np.float64)
    elif skip_type == "time_uniform":
        return np.linspace(t_T, t_0, N + 1, dtype=np.float64)
    elif skip_type == "time_quadratic":
        return np.linspace(t_T ** 0.5, t_0 ** 0.5, N + 1, dtype=np.float64) ** 2
    elif skip_type == "karras":
        # Karras et al. (arXiv:2206.00364 eq. 5) rho=7 spacing of the
        # noise-to-signal ratio sigma = sigma_t/alpha_t = exp(-lambda), the
        # grid diffusers exposes as `use_karras_sigmas` for the DPM-Solver
        # schedulers the reference README recommends (README.md:46,71-79).
        # Not present in the reference's own code (sampler grids only at
        # dpm_solver_pytorch.py:453-480); endpoints coincide with the other
        # grids, interior points concentrate steps at low noise.
        rho = 7.0
        lambda_T = float(ns.marginal_lambda_np(np.float64(t_T)))
        lambda_0 = float(ns.marginal_lambda_np(np.float64(t_0)))
        sigma_max, sigma_min = np.exp(-lambda_T), np.exp(-lambda_0)
        ramp = np.linspace(0.0, 1.0, N + 1, dtype=np.float64)
        inv_rho = 1.0 / rho
        sigmas = (sigma_max ** inv_rho
                  + ramp * (sigma_min ** inv_rho - sigma_max ** inv_rho)) ** rho
        lambdas = -np.log(sigmas)
        return np.asarray(ns.inverse_lambda_np(lambdas), dtype=np.float64)
    raise ValueError(f"Unsupported skip_type {skip_type!r}; need one of {SKIP_TYPES}")


def get_orders_and_timesteps_for_singlestep_solver(
    ns: NoiseScheduleVP, steps: int, order: int, skip_type: str, t_T: float, t_0: float
) -> Tuple[np.ndarray, List[int]]:
    """Split `steps` NFE into segments of orders <= `order` ("DPM-Solver-fast").

    (ref: dpm_solver_pytorch.py:482-539)
    """
    if order == 3:
        K = steps // 3 + 1
        if steps % 3 == 0:
            orders = [3] * (K - 2) + [2, 1]
        elif steps % 3 == 1:
            orders = [3] * (K - 1) + [1]
        else:
            orders = [3] * (K - 1) + [2]
    elif order == 2:
        if steps % 2 == 0:
            K = steps // 2
            orders = [2] * K
        else:
            K = steps // 2 + 1
            orders = [2] * (K - 1) + [1]
    elif order == 1:
        K = steps
        orders = [1] * steps
    else:
        raise ValueError(f"'order' must be 1/2/3, got {order}")
    if skip_type == "logSNR":
        # To reproduce the results in the DPM-Solver paper
        timesteps_outer = get_time_steps(ns, skip_type, t_T, t_0, K)
    else:
        fine = get_time_steps(ns, skip_type, t_T, t_0, steps)
        timesteps_outer = fine[np.cumsum([0] + orders)]
    return timesteps_outer, orders


# --------------------------------------------------------------------------- #
# plan representation
# --------------------------------------------------------------------------- #


# columns of a packed device row table (`PlanRows.table`); the fused update
# kernel reads columns A..S of a row, (a, b0, b1, b2, s_noise)
A, B0, B1, B2, S, T_NEXT, ALPHA, SIGMA = range(8)


@dataclasses.dataclass(frozen=True)
class PlanRows:
    """Per-micro-op coefficient table; float64 arrays with leading dim n_ops.

    Row semantics (executed by solver/sample.py):
        x      <- a * x_anchor + b @ hist + s_noise * z
        commit: x_anchor <- x;  correcting_xt(x, t_next, step_index); record
        eval:   hist <- push(model(x, t_next) [-> x0-space], hist)
    """

    a: np.ndarray            # [n]
    b: np.ndarray            # [n, 3] newest-first history coefficients
    s_noise: np.ndarray      # [n] noise coefficient (0 for ODE rows)
    t_next: np.ndarray       # [n] state time after the row (model-label time)
    alpha_next: np.ndarray   # [n] alpha at t_next (x0 conversion at eval)
    sigma_next: np.ndarray   # [n] sigma at t_next
    # UniPC corrector extension (None for plain predictor rows): the row's
    # committed state is A*x + b_corr@hist + c_corr*m_new where m_new is the
    # model value at the predicted point (then pushed into history).
    b_corr: Optional[np.ndarray] = None   # [n, 3]
    c_corr: Optional[np.ndarray] = None   # [n]

    @property
    def n_ops(self) -> int:
        return self.a.shape[0]

    def reshape(self, lead: Tuple[int, ...]) -> "PlanRows":
        """The same rows with leading dims `lead` in place of n_ops."""
        nd = self.a.ndim
        return PlanRows(**{f.name: None if getattr(self, f.name) is None else
                           getattr(self, f.name).reshape(lead + getattr(self, f.name).shape[nd:])
                           for f in dataclasses.fields(self)})

    def table(self, device):
        """Rows packed as one fp32 (n, 8) tensor on `device`, columns
        A, B0, B1, B2, S, T_NEXT, ALPHA, SIGMA."""
        import torch

        cols = [self.a, self.b[:, 0], self.b[:, 1], self.b[:, 2], self.s_noise,
                self.t_next, self.alpha_next, self.sigma_next]
        return torch.tensor(np.stack(cols, axis=1), dtype=torch.float32, device=device)

    def corr_table(self, device):
        """UniPC corrector rows as (n, 5) fp32 (a, bc0, bc1, bc2, c_corr): the
        corrector x = a*x + bc@hist + c_corr*m is the fused update with z = m."""
        import torch

        cols = [self.a, self.b_corr[:, 0], self.b_corr[:, 1], self.b_corr[:, 2], self.c_corr]
        return torch.tensor(np.stack(cols, axis=1), dtype=torch.float32, device=device)

    @staticmethod
    def from_lists(rows: Sequence[Tuple], ns: NoiseScheduleVP) -> "PlanRows":
        """rows: (t_next, A, (b0,b1,b2), s_noise) tuples in float64, with
        two optional trailing entries ((bc0,bc1,bc2), c_corr) for UniPC
        corrector rows (all-or-none across the list)."""
        t_next = np.asarray([r[0] for r in rows], dtype=np.float64)
        a = np.asarray([r[1] for r in rows], dtype=np.float64)
        b = np.asarray([r[2] for r in rows], dtype=np.float64)
        s = np.asarray([r[3] for r in rows], dtype=np.float64)
        alpha = ns.marginal_alpha_np(t_next)
        sigma = ns.marginal_std_np(t_next)
        has_corr = len(rows[0]) > 4
        assert all((len(r) > 4) == has_corr for r in rows)
        return PlanRows(
            a=a, b=b, s_noise=s, t_next=t_next,
            alpha_next=np.asarray(alpha, dtype=np.float64),
            sigma_next=np.asarray(sigma, dtype=np.float64),
            b_corr=np.asarray([r[4] for r in rows], dtype=np.float64) if has_corr else None,
            c_corr=np.asarray([r[5] for r in rows], dtype=np.float64) if has_corr else None,
        )


@dataclasses.dataclass(frozen=True)
class SegScan:
    """A run of same-order singlestep segments.

    `rows` holds PlanRows whose arrays have shape [n_seg, R, ...]: R static
    micro-ops per segment (identity+eval at the segment start, then the
    order's intermediate/final updates). Singlestep segments never share
    model evaluations across segments (all updates are anchored at the
    segment start, ref dpm_solver_pytorch.py:594-794), so the history resets
    at every segment. This is the `to_sparse_list` same-order grouping of
    the reference JAX sampler (dpm_solver_jax.py:1111-1114,1181-1197) in
    coefficient-table form; the JAX package runs each group as one
    `lax.scan`, the port as a loop over the segments.
    """

    rows: PlanRows                              # arrays shaped [n_seg, R]
    eval_after: Tuple[bool, ...]                # per micro-op, length R
    commit: Tuple[bool, ...]                    # per micro-op, length R
    step_index: np.ndarray = None               # [n_seg] outer-step index

    @property
    def n_seg(self) -> int:
        return self.rows.a.shape[0]


def end_time(ns: NoiseScheduleVP, t_end: Optional[float] = None) -> float:
    """`t_end`, or the reference's default end time: 1/N on a discrete
    schedule, 1e-3 on a continuous one."""
    if t_end is not None:
        return t_end
    return 1.0 / ns.total_N if ns.schedule == "discrete" else 1e-3


def _grid_and_orders(ns, steps, order, *, t_start, t_end, skip_type,
                     lower_order_final, timesteps):
    """Shared multistep/UniPC planning: endpoint defaults, grid resolution,
    and the reference's warm-up + lower_order_final order schedule
    (dpm_solver_pytorch.py:1184-1201)."""
    t_0 = end_time(ns, t_end)
    t_T = ns.T if t_start is None else t_start
    assert t_0 > 0 and t_T > 0
    assert steps >= order
    if timesteps is None:
        timesteps = get_time_steps(ns, skip_type, t_T, t_0, steps)
    else:
        timesteps = np.asarray(timesteps, dtype=np.float64)
        assert timesteps.shape == (steps + 1,)
        t_0 = float(timesteps[-1])
    orders = []
    for step in range(1, steps + 1):
        if step < order:
            orders.append(step)                  # warm-up (ref :1184-1193)
        elif lower_order_final and steps < 10:
            orders.append(min(order, steps + 1 - step))   # ref :1196-1201
        else:
            orders.append(order)
    return timesteps, t_0, orders


@dataclasses.dataclass(frozen=True)
class SamplePlan:
    """A fully-planned trajectory.

    `scan_rows` is the homogeneous body (every row: update -> commit -> eval).
    `seg_scans` are runs of same-order singlestep segments. `tail_rows`/`tail_flags` are the
    heterogeneous remainder executed unrolled (singleton singlestep segments,
    the final no-eval update, denoise_to_zero). `t_first` is the initial
    model-eval time.
    """

    t_first: float
    alpha_first: float
    sigma_first: float
    scan_rows: Optional[PlanRows]               # homogeneous prefix (may be None)
    tail_rows: Optional[PlanRows]               # unrolled remainder (may be None)
    seg_scans: Tuple["SegScan", ...] = ()       # scanned singlestep groups
    tail_eval: Tuple[bool, ...] = ()            # eval-after flag per tail row
    tail_commit: Tuple[bool, ...] = ()          # commit/anchor flag per tail row
    tail_step_index: Tuple[int, ...] = ()       # reference `step` for correcting_xt
    has_noise: bool = False                     # any SDE row present
    n_nfe: int = 0                              # model evals (excl. denoise)
    # multistep corrects/records the initial state at step 0 (ref :1180-1183);
    # singlestep does not.
    initial_correct_record: bool = True
    # denoise_to_zero: final x <- x0_prediction(x, t_denoise) (always x0-space,
    # ref dpm_solver_pytorch.py:541-545,1235-1241). NaNs when disabled.
    denoise_final: bool = False
    t_denoise: float = float("nan")
    alpha_denoise: float = float("nan")
    sigma_denoise: float = float("nan")
    denoise_step_index: int = -1
    # fp32 device tables, packed once per device by `device_tables`
    _device: Dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def device_tables(self, device) -> Dict:
        """The plan's rows as fp32 tensors on `device`, packed on first use:
        'init' (t, alpha, sigma) of the first eval, 'scan', 'scan_corr',
        'tail', 'seg' (one table per seg scan, n_seg*R rows) and 'denoise'
        (the denoise-to-zero time, a 0-d tensor, or None). After the first
        use the executor makes no tensor from host data, so a CUDA graph can
        capture it."""
        import torch

        key = torch.device(device)
        if key not in self._device:
            rows = self.scan_rows
            self._device[key] = dict(
                init=torch.tensor([self.t_first, self.alpha_first, self.sigma_first],
                                  dtype=torch.float32, device=key),
                scan=None if rows is None else rows.table(key),
                scan_corr=None if rows is None or rows.b_corr is None
                else rows.corr_table(key),
                tail=None if self.tail_rows is None else self.tail_rows.table(key),
                seg=[g.rows.reshape((g.rows.a.size,)).table(key) for g in self.seg_scans],
                denoise=torch.tensor(self.t_denoise, dtype=torch.float32, device=key)
                if self.denoise_final else None,
            )
        return self._device[key]


# --------------------------------------------------------------------------- #
# plan construction
# --------------------------------------------------------------------------- #


def build_multistep_plan(
    ns: NoiseScheduleVP,
    steps: int,
    order: int,
    *,
    t_start: Optional[float] = None,
    t_end: Optional[float] = None,
    skip_type: str = "time_uniform",
    algorithm_type: str = "dpmsolver++",
    solver_type: str = "dpmsolver",
    lower_order_final: bool = True,
    denoise_to_zero: bool = False,
    timesteps: Optional[np.ndarray] = None,
) -> SamplePlan:
    """Plan a multistep (Adams-Bashforth-like) trajectory.

    Reproduces the reference sampling loop exactly (dpm_solver_pytorch.py:1171-1213):
    warm-up with ascending orders 1..order-1, then order-`order` updates, with
    `lower_order_final` shrinking the order near the end when steps < 10, and
    no model evaluation after the final update.

    `timesteps` (optional, shape [steps+1], decreasing) overrides the built-in
    grid — use for custom spacings (e.g. externally computed sigmas).
    """
    max_order = 2 if algorithm_type in U.SDE_ALGORITHMS else 3
    if order > max_order:
        raise ValueError(f"{algorithm_type} supports order <= {max_order}, got {order}")
    timesteps, t_0, orders = _grid_and_orders(
        ns, steps, order, t_start=t_start, t_end=t_end, skip_type=skip_type,
        lower_order_final=lower_order_final, timesteps=timesteps)

    rows = []
    for step, step_order in enumerate(orders, start=1):
        t_prev = timesteps[max(0, step - step_order):step]
        a, b, s = U.multistep_row(
            ns, list(t_prev), timesteps[step], step_order,
            algorithm_type=algorithm_type, solver_type=solver_type, lib=np,
        )
        rows.append((timesteps[step], a, b, s))

    return _assemble_uniform_plan(
        ns, timesteps[0], rows, denoise_final=denoise_to_zero, t_0=t_0,
        has_noise=algorithm_type in U.SDE_ALGORITHMS,
    )


def build_unipc_plan(
    ns: NoiseScheduleVP,
    steps: int,
    order: int,
    *,
    t_start: Optional[float] = None,
    t_end: Optional[float] = None,
    skip_type: str = "time_uniform",
    algorithm_type: str = "dpmsolver++",
    variant: str = "bh2",
    lower_order_final: bool = True,
    denoise_to_zero: bool = False,
    timesteps: Optional[np.ndarray] = None,
) -> SamplePlan:
    """Plan a UniPC trajectory (arXiv:2302.04867) — beyond the reference.

    Same grid/warm-up/order schedule as `build_multistep_plan` (the official
    UniPC sampler reuses the DPM-Solver multistep loop structure); every
    in-scan row carries both the UniP predictor and the UniC corrector
    (which re-uses the step's single model eval), and the final update is
    predictor-only so NFE == steps exactly, matching the official
    `disable_corrector`-on-last-step convention.
    """
    if algorithm_type not in U.ODE_ALGORITHMS:
        raise ValueError("UniPC is ODE-only")
    timesteps, t_0, orders = _grid_and_orders(
        ns, steps, order, t_start=t_start, t_end=t_end, skip_type=skip_type,
        lower_order_final=lower_order_final, timesteps=timesteps)

    rows = []
    for step, step_order in enumerate(orders, start=1):
        t_prev = timesteps[max(0, step - step_order):step]
        a, bp, bc, cc = U.unipc_row(
            ns, list(t_prev), timesteps[step], step_order,
            algorithm_type=algorithm_type, variant=variant, lib=np,
        )
        if step < steps:
            rows.append((timesteps[step], a, bp, 0.0, bc, cc))
        else:  # last update: predictor only, no eval after
            rows.append((timesteps[step], a, bp, 0.0))

    return _assemble_uniform_plan(
        ns, timesteps[0], rows, denoise_final=denoise_to_zero, t_0=t_0,
        has_noise=False,
    )


def build_singlestep_plan(
    ns: NoiseScheduleVP,
    steps: int,
    order: int,
    *,
    t_start: Optional[float] = None,
    t_end: Optional[float] = None,
    skip_type: str = "time_uniform",
    algorithm_type: str = "dpmsolver++",
    solver_type: str = "dpmsolver",
    fixed: bool = False,
    denoise_to_zero: bool = False,
) -> SamplePlan:
    """Plan a singlestep (Runge-Kutta-like) trajectory.

    `fixed=False` is "DPM-Solver-fast" (mixed orders using all NFE); `fixed=True`
    repeats order-`order` segments steps//order times.
    (ref: dpm_solver_pytorch.py:1214-1232)
    """
    t_0 = end_time(ns, t_end)
    t_T = ns.T if t_start is None else t_start
    assert t_0 > 0 and t_T > 0
    if fixed:
        K = steps // order
        orders = [order] * K
        timesteps_outer = get_time_steps(ns, skip_type, t_T, t_0, K)
    else:
        timesteps_outer, orders = get_orders_and_timesteps_for_singlestep_solver(
            ns, steps=steps, order=order, skip_type=skip_type, t_T=t_T, t_0=t_0
        )

    def segment_micro_rows(seg):
        """All micro-op rows for one segment, with eval/commit flags."""
        seg_order = orders[seg]
        s, t = timesteps_outer[seg], timesteps_outer[seg + 1]
        # r1/r2 from the *inner* grid of the segment (ref :1221-1227); for
        # logSNR spacing these are exactly 1/3, 2/3 (resp. 1/2).
        inner = get_time_steps(ns, skip_type, float(s), float(t), seg_order)
        lam_inner = ns.marginal_lambda_np(inner)
        h = lam_inner[-1] - lam_inner[0]
        r1 = None if seg_order <= 1 else float((lam_inner[1] - lam_inner[0]) / h)
        r2 = None if seg_order <= 2 else float((lam_inner[2] - lam_inner[0]) / h)
        # fresh model eval at the segment start: identity row with eval
        rows = [(s, 1.0, (0.0, 0.0, 0.0), 0.0)]
        evals, commits = [True], [False]
        for t_next, a, b, eval_after in U.singlestep_segment_rows(
                ns, float(s), float(t), seg_order, r1=r1, r2=r2,
                algorithm_type=algorithm_type, solver_type=solver_type, lib=np):
            rows.append((t_next, a, b, 0.0))
            evals.append(eval_after)
            commits.append(not eval_after)  # only the segment-final row commits
        return rows, evals, commits

    # group consecutive same-order segments (`to_sparse_list` semantics,
    # ref dpm_solver_jax.py:1181-1197): runs of >= MIN_SCAN segments become
    # seg scans; the remainder goes to the tail. Once a group is in the tail
    # every later group is too — the executor runs all seg_scans before the
    # tail, so scanned groups must form a prefix. (The layout matches the JAX
    # package's plan, built with its default min_scan = 2, row for row.)
    groups: List[Tuple[int, int]] = []          # (order, count)
    for seg_order in orders:
        if groups and groups[-1][0] == seg_order:
            groups[-1] = (seg_order, groups[-1][1] + 1)
        else:
            groups.append((seg_order, 1))

    seg_scans: List[SegScan] = []
    tail: List[Tuple] = []
    tail_eval: List[bool] = []
    tail_commit: List[bool] = []
    tail_step: List[int] = []
    nfe = 0
    seg = 0
    scanning = True
    for g_order, g_count in groups:
        scanning = scanning and g_count >= MIN_SCAN
        if scanning:
            flat, evals, commits = [], None, None
            for k in range(g_count):
                rows, evals, commits = segment_micro_rows(seg + k)
                flat.extend(rows)
                nfe += sum(evals)
            R = len(evals)
            rows2d = PlanRows.from_lists(flat, ns).reshape((g_count, R))
            seg_scans.append(SegScan(
                rows=rows2d, eval_after=tuple(evals), commit=tuple(commits),
                step_index=np.arange(seg, seg + g_count, dtype=np.int32)))
        else:
            for k in range(g_count):
                rows, evals, commits = segment_micro_rows(seg + k)
                tail.extend(rows)
                tail_eval.extend(evals)
                tail_commit.extend(commits)
                tail_step.extend([seg + k] * len(rows))
                nfe += sum(evals)
        seg += g_count

    plan = _finalize_tail_plan(
        ns, t_first=None, tail=tail, tail_eval=tail_eval, tail_commit=tail_commit,
        tail_step=tail_step, nfe=nfe, denoise_final=denoise_to_zero, t_0=t_0,
        seg_scans=tuple(seg_scans),
        last_step_index=len(orders) - 1,
    )
    return plan


def _denoise_fields(ns, denoise_final, t_0, last_step_index):
    if not denoise_final:
        return dict(denoise_final=False)
    return dict(
        denoise_final=True,
        t_denoise=float(t_0),
        alpha_denoise=float(ns.marginal_alpha_np(t_0)),
        sigma_denoise=float(ns.marginal_std_np(t_0)),
        denoise_step_index=last_step_index + 1,
    )


def _assemble_uniform_plan(ns, t_first, rows, *, denoise_final, t_0, has_noise):
    """Multistep: rows[0:-1] scan (update+eval), last row tail (no eval)."""
    nfe = len(rows)  # first eval + (n-1) in-loop evals == steps
    scan_rows = PlanRows.from_lists(rows[:-1], ns) if len(rows) > 1 else None
    return SamplePlan(
        t_first=float(t_first),
        alpha_first=float(ns.marginal_alpha_np(t_first)),
        sigma_first=float(ns.marginal_std_np(t_first)),
        scan_rows=scan_rows,
        tail_rows=PlanRows.from_lists([rows[-1]], ns),
        tail_eval=(False,),
        tail_commit=(True,),
        tail_step_index=(len(rows),),
        has_noise=has_noise,
        n_nfe=nfe,
        **_denoise_fields(ns, denoise_final, t_0, len(rows)),
    )


def _finalize_tail_plan(ns, *, t_first, tail, tail_eval, tail_commit, tail_step,
                        nfe, denoise_final, t_0, seg_scans=(),
                        last_step_index=None):
    if not tail and not seg_scans:
        # zero segments (e.g. singlestep_fixed with steps < order): the
        # reference runs an empty loop and returns x unchanged
        return SamplePlan(
            t_first=float("nan"), alpha_first=1.0, sigma_first=0.0,
            scan_rows=None, tail_rows=None, has_noise=False, n_nfe=0,
            initial_correct_record=False,
            **_denoise_fields(ns, denoise_final, t_0, -1),
        )
    if last_step_index is None:
        last_step_index = tail_step[-1]
    return SamplePlan(
        t_first=float("nan") if t_first is None else float(t_first),
        alpha_first=1.0,
        sigma_first=0.0,
        scan_rows=None,
        seg_scans=tuple(seg_scans),
        tail_rows=PlanRows.from_lists(tail, ns) if tail else None,
        tail_eval=tuple(tail_eval),
        tail_commit=tuple(tail_commit),
        tail_step_index=tuple(tail_step),
        has_noise=False,
        n_nfe=nfe,
        initial_correct_record=False,
        **_denoise_fields(ns, denoise_final, t_0, last_step_index),
    )
