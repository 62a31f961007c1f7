"""Exponential-integrator update coefficients for DPM-Solver / DPM-Solver++.

Every solver update in this framework is the linear combination

    x_next = A * x_anchor + b0 * M0 + b1 * M1 + b2 * M2 + s_noise * z

where M0..M2 are the most recent cached model values (newest first), x_anchor
is the segment anchor (== the current state for multistep methods), and z is a
standard normal draw (SDE variants only; s_noise == 0 for the ODE solvers).

This module computes (A, (b0, b1, b2), s_noise) for every update rule:

  * order 1/2/3 multistep (Adams-Bashforth-like) updates
      (ref semantics: dpm_solver_pytorch.py:547-592,796-904)
  * order 1/2/3 singlestep (Runge-Kutta-like) segment micro-updates
      (ref semantics: dpm_solver_pytorch.py:594-794)
  * SDE-DPM-Solver / SDE-DPM-Solver++ order 1/2 multistep updates
      (not implemented anywhere in the reference repo; formulas from the
      DPM-Solver++ paper, arXiv:2211.01095, app. "SDE-DPM-Solver++"; the
      "midpoint"/"heun" naming follows the community convention)

All functions take `lib=numpy`, on the host in float64: the planner
(solver/plan.py) computes every coefficient table this way, and the executor
only reads the rows. This module is the JAX package's `solver/updates.py`
unchanged in substance (it never imported jax): numpy only, no torch.
`algorithm_type` selects the prediction space: "dpmsolver++" variants
combine x0 predictions, "dpmsolver" variants combine eps predictions.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

ODE_ALGORITHMS = ("dpmsolver", "dpmsolver++")
SDE_ALGORITHMS = ("sde-dpmsolver", "sde-dpmsolver++")
ALGORITHM_TYPES = ODE_ALGORITHMS + SDE_ALGORITHMS
SOLVER_TYPES = ("dpmsolver", "taylor", "midpoint", "heun")


def is_predict_x0(algorithm_type: str) -> bool:
    return algorithm_type in ("dpmsolver++", "sde-dpmsolver++")


def _marginals(ns, t, lib):
    """(log_alpha, alpha, sigma, lam) at time t from either precision path."""
    if lib is np:
        log_alpha = ns.marginal_log_mean_coeff_np(t)
        lam = ns.marginal_lambda_np(t)
    else:
        log_alpha = ns.marginal_log_mean_coeff(t)
        lam = ns.marginal_lambda(t)
    alpha = lib.exp(log_alpha)
    sigma = lib.sqrt(-lib.expm1(2.0 * log_alpha))
    return log_alpha, alpha, sigma, lam


def _zeros3(b0, b1=0.0, b2=0.0):
    return (b0, b1, b2)


# --------------------------------------------------------------------------- #
# Multistep updates (history = model values at previous *grid* points)
# --------------------------------------------------------------------------- #


def multistep_row(ns, t_prev: Sequence, t, order: int, *, algorithm_type: str,
                  solver_type: str = "dpmsolver", lib=np):
    """Coefficients for one multistep update from t_prev[-1] to t.

    `t_prev` holds the previous grid times, newest LAST (reference
    `t_prev_list` convention); only the trailing `order` entries are used.
    Returned b-coefficients are indexed newest FIRST: b0 multiplies the model
    value at t_prev[-1], b1 at t_prev[-2], b2 at t_prev[-3].
    """
    if algorithm_type not in ALGORITHM_TYPES:
        raise ValueError(f"bad algorithm_type {algorithm_type!r}")
    if algorithm_type in SDE_ALGORITHMS:
        return _sde_multistep_row(ns, t_prev, t, order, algorithm_type=algorithm_type,
                                  solver_type=solver_type, lib=lib)
    pp = algorithm_type == "dpmsolver++"

    log_alpha_prev0, _, sigma_prev0, lam_prev0 = _marginals(ns, t_prev[-1], lib)
    log_alpha_t, alpha_t, sigma_t, lam_t = _marginals(ns, t, lib)
    h = lam_t - lam_prev0

    if pp:
        A = sigma_t / sigma_prev0
        phi_1 = lib.expm1(-h)
        c1 = -alpha_t * phi_1          # coefficient on M0 (ref :569-576,824-837)
        phi_2 = phi_1 / h + 1.0
        phi_3 = phi_2 / h - 0.5
        cD1 = alpha_t * phi_2          # + on D1 (ref :884-893)
        cD2 = -alpha_t * phi_3
        c_taylor2 = alpha_t * (phi_1 / h + 1.0)   # + on D1_0 (ref :832-837)
        c_dpms2 = -0.5 * alpha_t * phi_1          # - on D1_0 (ref :826-831)
    else:
        A = lib.exp(log_alpha_t - log_alpha_prev0)
        phi_1 = lib.expm1(h)
        c1 = -sigma_t * phi_1
        phi_2 = phi_1 / h - 1.0
        phi_3 = phi_2 / h - 0.5
        cD1 = -sigma_t * phi_2
        cD2 = -sigma_t * phi_3
        c_taylor2 = -sigma_t * (phi_1 / h - 1.0)
        c_dpms2 = -0.5 * sigma_t * phi_1

    if order == 1:
        return A, _zeros3(c1), 0.0

    lam_prev1 = _marginals(ns, t_prev[-2], lib)[3]
    h_0 = lam_prev0 - lam_prev1
    r0 = h_0 / h
    if order == 2:
        # x = A x + c1 M0 + c2 * D1_0,  D1_0 = (M0 - M1)/r0
        c2 = c_dpms2 if solver_type == "dpmsolver" else c_taylor2
        return A, _zeros3(c1 + c2 / r0, -c2 / r0), 0.0
    if order == 3:
        lam_prev2 = _marginals(ns, t_prev[-3], lib)[3]
        h_1 = lam_prev1 - lam_prev2
        r1 = h_1 / h
        # D1_0 = (M0-M1)/r0, D1_1 = (M1-M2)/r1,
        # D1 = D1_0 + r0/(r0+r1) (D1_0 - D1_1), D2 = (D1_0 - D1_1)/(r0+r1)
        # x = A x + c1 M0 + cD1 D1 + cD2 D2   (ref :876-903)
        g = r0 / (r0 + r1)
        coef_d10 = cD1 * (1.0 + g) + cD2 / (r0 + r1)
        coef_d11 = -cD1 * g - cD2 / (r0 + r1)
        b0 = c1 + coef_d10 / r0
        b1 = -coef_d10 / r0 + coef_d11 / r1
        b2 = -coef_d11 / r1
        return A, (b0, b1, b2), 0.0
    raise ValueError(f"multistep order must be 1/2/3, got {order}")


def _sde_multistep_row(ns, t_prev, t, order, *, algorithm_type, solver_type, lib):
    """SDE-DPM-Solver(++) multistep coefficients (orders 1 and 2).

    x0-space ("sde-dpmsolver++", arXiv:2211.01095):
      x_t = (sigma_t/sigma_s) e^{-h} x + alpha_t (1 - e^{-2h}) M0
            [+ c2 * D1_0] + sigma_t sqrt(1 - e^{-2h}) z
      c2 = 0.5 alpha_t (1-e^{-2h})                       (midpoint)
      c2 = alpha_t ((1-e^{-2h})/(-2h) + 1)               (heun)

    eps-space ("sde-dpmsolver"):
      x_t = (alpha_t/alpha_s) x - 2 sigma_t (e^{h}-1) M0
            [+ c2 * D1_0] + sigma_t sqrt(e^{2h}-1) z
      c2 = -sigma_t (e^{h}-1)                            (midpoint)
      c2 = -2 sigma_t ((e^{h}-1)/h - 1)                  (heun)
    """
    if order not in (1, 2):
        raise ValueError(f"SDE multistep supports order 1/2, got {order}")
    if solver_type in ("dpmsolver", "midpoint"):
        heun = False
    elif solver_type in ("taylor", "heun"):
        heun = True
    else:
        raise ValueError(f"bad solver_type {solver_type!r}")

    log_alpha_prev0, alpha_prev0, sigma_prev0, lam_prev0 = _marginals(ns, t_prev[-1], lib)
    log_alpha_t, alpha_t, sigma_t, lam_t = _marginals(ns, t, lib)
    h = lam_t - lam_prev0

    if algorithm_type == "sde-dpmsolver++":
        A = sigma_t / sigma_prev0 * lib.exp(-h)
        em2h = -lib.expm1(-2.0 * h)  # 1 - e^{-2h}
        c1 = alpha_t * em2h
        s_noise = sigma_t * lib.sqrt(em2h)
        c2 = alpha_t * (em2h / (-2.0 * h) + 1.0) if heun else 0.5 * alpha_t * em2h
    else:  # sde-dpmsolver
        A = lib.exp(log_alpha_t - log_alpha_prev0)
        eh = lib.expm1(h)  # e^{h} - 1
        c1 = -2.0 * sigma_t * eh
        s_noise = sigma_t * lib.sqrt(lib.expm1(2.0 * h))
        c2 = -2.0 * sigma_t * (eh / h - 1.0) if heun else -sigma_t * eh

    if order == 1:
        return A, _zeros3(c1), s_noise
    lam_prev1 = _marginals(ns, t_prev[-2], lib)[3]
    r0 = (lam_prev0 - lam_prev1) / h
    # D1_0 = (M0 - M1)/r0
    return A, _zeros3(c1 + c2 / r0, -c2 / r0), s_noise


# --------------------------------------------------------------------------- #
# Singlestep segments (Runge-Kutta-like; all updates anchored at segment start)
# --------------------------------------------------------------------------- #


def singlestep_segment_rows(ns, s, t, order: int, *, r1=None, r2=None,
                            algorithm_type: str, solver_type: str = "dpmsolver",
                            lib=np):
    """Micro-update rows for one singlestep segment from s to t.

    Returns a list of (t_next, A, (b0, b1, b2), eval_after) tuples. The
    executor applies them in sequence with x_anchor fixed at the segment start;
    `eval_after` marks rows whose resulting state must be fed to the model
    (pushing the value onto the newest-first history). The model value at `s`
    itself (history slot 0 before the first row) must already be present.

    b-coefficients index the history *at the time the row executes*:
    e.g. for order 3 the final row sees hist = [M_s2, M_s1, M_s].
    (ref: dpm_solver_pytorch.py:547-794)
    """
    if algorithm_type not in ODE_ALGORITHMS:
        raise ValueError(f"singlestep supports ODE algorithms only, got {algorithm_type!r}")
    pp = algorithm_type == "dpmsolver++"
    taylor = solver_type == "taylor"
    if solver_type not in ("dpmsolver", "taylor"):
        raise ValueError(f"bad solver_type {solver_type!r}")

    log_alpha_s, _, sigma_s, lam_s = _marginals(ns, s, lib)
    log_alpha_t, alpha_t, sigma_t, lam_t = _marginals(ns, t, lib)
    h = lam_t - lam_s

    def ratio_A(log_alpha_u, sigma_u):
        return (sigma_u / sigma_s) if pp else lib.exp(log_alpha_u - log_alpha_s)

    if order == 1:
        if pp:
            b = -alpha_t * lib.expm1(-h)
        else:
            b = -sigma_t * lib.expm1(h)
        return [(t, ratio_A(log_alpha_t, sigma_t), _zeros3(b), False)]

    if order == 2:
        r1 = 0.5 if r1 is None else r1
        lam_s1 = lam_s + r1 * h
        s1 = ns.inverse_lambda_np(lam_s1) if lib is np else ns.inverse_lambda(lam_s1)
        log_alpha_s1, alpha_s1, sigma_s1, _ = _marginals(ns, s1, lib)
        if pp:
            phi_11 = lib.expm1(-r1 * h)
            phi_1 = lib.expm1(-h)
            b_mid = -alpha_s1 * phi_11
            c1 = -alpha_t * phi_1
            cD = (alpha_t * (phi_1 / h + 1.0)) / r1 if taylor else (-0.5 / r1) * alpha_t * phi_1
        else:
            phi_11 = lib.expm1(r1 * h)
            phi_1 = lib.expm1(h)
            b_mid = -sigma_s1 * phi_11
            c1 = -sigma_t * phi_1
            cD = (-1.0 / r1) * sigma_t * (phi_1 / h - 1.0) if taylor else (-0.5 / r1) * sigma_t * phi_1
        # row 1: x_s1 = A1 x + b_mid M_s ; eval -> M_s1
        # row 2: x_t  = A2 x + cD M_s1 + (c1 - cD) M_s    (cD on (M_s1 - M_s))
        return [
            (s1, ratio_A(log_alpha_s1, sigma_s1), _zeros3(b_mid), True),
            (t, ratio_A(log_alpha_t, sigma_t), _zeros3(cD, c1 - cD), False),
        ]

    if order == 3:
        r1 = 1.0 / 3.0 if r1 is None else r1
        r2 = 2.0 / 3.0 if r2 is None else r2
        lam_s1 = lam_s + r1 * h
        lam_s2 = lam_s + r2 * h
        if lib is np:
            s1, s2 = ns.inverse_lambda_np(lam_s1), ns.inverse_lambda_np(lam_s2)
        else:
            s1, s2 = ns.inverse_lambda(lam_s1), ns.inverse_lambda(lam_s2)
        log_alpha_s1, alpha_s1, sigma_s1, _ = _marginals(ns, s1, lib)
        log_alpha_s2, alpha_s2, sigma_s2, _ = _marginals(ns, s2, lib)
        if pp:
            phi_11 = lib.expm1(-r1 * h)
            phi_12 = lib.expm1(-r2 * h)
            phi_1 = lib.expm1(-h)
            phi_22 = lib.expm1(-r2 * h) / (r2 * h) + 1.0
            phi_2 = phi_1 / h + 1.0
            phi_3 = phi_2 / h - 0.5
            b_s1 = -alpha_s1 * phi_11                                # row 1 on M_s
            c_s2_ms = -alpha_s2 * phi_12                             # row 2 base on M_s
            c_s2_d = (r2 / r1) * alpha_s2 * phi_22                   # row 2 on (M_s1 - M_s)
            c1 = -alpha_t * phi_1
            cD1 = alpha_t * phi_2
            cD2 = -alpha_t * phi_3
        else:
            phi_11 = lib.expm1(r1 * h)
            phi_12 = lib.expm1(r2 * h)
            phi_1 = lib.expm1(h)
            phi_22 = lib.expm1(r2 * h) / (r2 * h) - 1.0
            phi_2 = phi_1 / h - 1.0
            phi_3 = phi_2 / h - 0.5
            b_s1 = -sigma_s1 * phi_11
            c_s2_ms = -sigma_s2 * phi_12
            c_s2_d = -(r2 / r1) * sigma_s2 * phi_22
            c1 = -sigma_t * phi_1
            cD1 = -sigma_t * phi_2
            cD2 = -sigma_t * phi_3

        rows = [
            # x_s1 = A1 x + b_s1 M_s                    (hist: [M_s])
            (s1, ratio_A(log_alpha_s1, sigma_s1), _zeros3(b_s1), True),
            # x_s2 = A2 x + c_s2_d M_s1 + (c_s2_ms - c_s2_d) M_s  (hist: [M_s1, M_s])
            (s2, ratio_A(log_alpha_s2, sigma_s2), _zeros3(c_s2_d, c_s2_ms - c_s2_d), True),
        ]
        if taylor:
            # D1_0 = (M_s1-M_s)/r1, D1_1 = (M_s2-M_s)/r2,
            # D1 = (r2 D1_0 - r1 D1_1)/(r2-r1), D2 = 2 (D1_1 - D1_0)/(r2-r1)
            # x_t = A x + c1 M_s + cD1 D1 + cD2 D2     (ref :740-750)
            coef_d10 = cD1 * r2 / (r2 - r1) - cD2 * 2.0 / (r2 - r1)
            coef_d11 = -cD1 * r1 / (r2 - r1) + cD2 * 2.0 / (r2 - r1)
            b_ms2 = coef_d11 / r2
            b_ms1 = coef_d10 / r1
            b_ms = c1 - coef_d10 / r1 - coef_d11 / r2
        else:
            # x_t = A x + c1 M_s + (cD1/r2)(M_s2 - M_s)  (ref :734-739)
            b_ms2 = cD1 / r2
            b_ms1 = 0.0 * b_ms2
            b_ms = c1 - cD1 / r2
        rows.append((t, ratio_A(log_alpha_t, sigma_t), (b_ms2, b_ms1, b_ms), False))
        return rows

    raise ValueError(f"singlestep order must be 1/2/3, got {order}")


def unipc_row(ns, t_prev: Sequence, t, order: int, *,
              algorithm_type: str = "dpmsolver++", variant: str = "bh2",
              lib=np):
    """Predictor + corrector coefficient rows for UniPC (arXiv:2302.04867).

    Beyond the reference repo (which stops at DPM-Solver++); semantics
    follow the official UniPC `multistep_uni_pc_bh_update`, including its
    "simplified" special cases (order-2 predictor rho=[1/2], order-1
    corrector rho=[1/2]). `t_prev` newest LAST; order-K uses the trailing K
    entries. Returns

        (A, b_pred, b_corr, c_corr)

    with the usual row semantics x_pred = A x + b_pred @ hist, and the
    corrector re-anchoring at the SAME x with the new model value m_t:
    x_corr = A x + b_corr @ hist + c_corr * m_t. One model eval per step
    (the corrector reuses m_t as the next step's newest history entry).
    ODE only ("dpmsolver" = noise prediction, "dpmsolver++" = data
    prediction); `variant` selects B(h): 'bh1' = h, 'bh2' = expm1(h).

    Host-only (lib=np): the rho systems solve a KxK Vandermonde on floats.
    """
    import math

    if algorithm_type not in ODE_ALGORITHMS:
        raise ValueError("UniPC rows are ODE-only; got "
                         f"{algorithm_type!r}")
    if not 1 <= order <= 3:
        raise ValueError(f"unipc order must be 1/2/3, got {order}")
    pp = algorithm_type == "dpmsolver++"

    log_alpha_prev0, _, sigma_prev0, lam_prev0 = _marginals(ns, t_prev[-1],
                                                            lib)
    log_alpha_t, alpha_t, sigma_t, lam_t = _marginals(ns, t, lib)
    h = lam_t - lam_prev0
    hh = -h if pp else h
    h_phi_1 = lib.expm1(hh)
    B_h = hh if variant == "bh1" else lib.expm1(hh)
    if variant not in ("bh1", "bh2"):
        raise ValueError(f"unipc variant must be bh1|bh2, got {variant!r}")

    K = order
    rks = []  # r_i for the older history points, i = 1..K-1
    for i in range(1, K):
        lam_i = _marginals(ns, t_prev[-1 - i], lib)[3]
        rks.append(float((lam_i - lam_prev0) / h))
    rks_full = rks + [1.0]

    R = np.array([[r ** (i - 1) for r in rks_full] for i in range(1, K + 1)],
                 dtype=np.float64)
    bvec = []
    h_phi_k = h_phi_1 / hh - 1.0
    for i in range(1, K + 1):
        bvec.append(h_phi_k * math.factorial(i) / B_h)
        h_phi_k = h_phi_k / hh - 1.0 / math.factorial(i + 1)
    bvec = np.array(bvec, dtype=np.float64)

    if K == 1:
        rhos_p = np.zeros(0)
    elif K == 2:  # official "simplified version" for the order-2 predictor
        rhos_p = np.array([0.5])
    else:
        rhos_p = np.linalg.solve(R[:-1, :-1], bvec[:-1])
    if K == 1:  # official "simplified version" for the order-1 corrector
        rhos_c = np.array([0.5])
    else:
        rhos_c = np.linalg.solve(R, bvec)

    if pp:
        A = sigma_t / sigma_prev0
        scale = alpha_t
    else:
        A = lib.exp(log_alpha_t - log_alpha_prev0)
        scale = sigma_t
    base0 = -scale * h_phi_1          # coefficient on M0 in x_t_

    # predictor: x_t_ - scale * B_h * sum_i rho_p[i] * (M_{i+1} - M0)/r_i
    bp = [base0, 0.0, 0.0]
    for i, r in enumerate(rks):
        c = scale * B_h * rhos_p[i] / r if i < len(rhos_p) else 0.0
        bp[0] += c
        bp[i + 1] -= c
    # corrector: same older terms with rho_c[:-1], plus the D1_t term
    # -scale*B_h*rho_c[-1]*(m_t - M0)
    bc = [base0, 0.0, 0.0]
    for i, r in enumerate(rks):
        c = scale * B_h * rhos_c[i] / r
        bc[0] += c
        bc[i + 1] -= c
    bc[0] += scale * B_h * rhos_c[-1]
    c_corr = -scale * B_h * rhos_c[-1]

    return A, tuple(bp), tuple(bc), c_corr
