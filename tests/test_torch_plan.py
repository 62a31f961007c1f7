"""Port planner (dpm_solver_tpu_torch/solver/plan.py) against the JAX `make_plan`.

Both sides plan on the host in float64; the JAX plan is built under
`jax.enable_x64` so its rows stay float64, and every row field must agree
within 1e-12 relative to its largest magnitude, for multistep orders 1-3,
singlestep and singlestep_fixed, on the logSNR, time_uniform and
time_quadratic grids. The device packing (`SamplePlan.device_tables`) is
checked against the rows in fp32.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpm_solver_tpu import NoiseScheduleVP as JaxNS
from dpm_solver_tpu.solver.sample import make_plan as jax_make_plan
from dpm_solver_tpu_torch import NoiseScheduleVP
from dpm_solver_tpu_torch.solver.plan import A, ALPHA, B0, B2, S, SIGMA, T_NEXT
from dpm_solver_tpu_torch.solver.sample import make_plan

REL = 1e-12
BETAS = np.linspace(1e-4, 0.02, 1000, dtype=np.float64)
FIELDS = ("a", "b", "s_noise", "t_next", "alpha_next", "sigma_next", "b_corr", "c_corr")

CONFIGS = (
    [dict(method="multistep", order=o, skip_type=sk, steps=10)
     for o, sk in itertools.product((1, 2, 3), ("logSNR", "time_uniform", "time_quadratic"))]
    + [dict(method=m, order=o, skip_type=sk, steps=9)
       for m, o, sk in itertools.product(("singlestep", "singlestep_fixed"), (2, 3),
                                         ("logSNR", "time_uniform", "time_quadratic"))]
    + [dict(method="multistep", order=3, skip_type="logSNR", steps=6,
            algorithm_type="dpmsolver", denoise_to_zero=True),
       dict(method="multistep", order=2, skip_type="time_uniform", steps=8,
            algorithm_type="sde-dpmsolver++"),
       dict(method="singlestep", order=3, skip_type="logSNR", steps=10, t_end=1e-3,
            schedule="linear"),
       dict(method="unipc", order=3, skip_type="logSNR", steps=10)]
)


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.max(np.abs(want)))) if want.size else 1.0
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=REL)


def _rows_close(got, want):
    assert (got is None) == (want is None)
    if got is None:
        return
    for f in FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if g is not None:
            assert isinstance(g, np.ndarray) and g.dtype == np.float64, f
            _close(g, w)


def _plans(cfg):
    cfg = dict(cfg)
    schedule = cfg.pop("schedule", "discrete")
    if schedule == "linear":
        ns_j, ns_t = JaxNS.linear(), NoiseScheduleVP.linear()
    else:
        ns_j, ns_t = JaxNS.discrete(betas=BETAS), NoiseScheduleVP.discrete(betas=BETAS)
    with jax.enable_x64(True):
        want = jax_make_plan(ns_j, dtype=jnp.float64, **cfg)
    return make_plan(ns_t, **cfg), want


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: "-".join(map(str, c.values())))
def test_plan_rows_match_jax(cfg):
    got, want = _plans(cfg)
    for f in ("alpha_first", "sigma_first", "t_denoise", "alpha_denoise", "sigma_denoise"):
        g, w = getattr(got, f), getattr(want, f)
        assert np.isnan(g) == np.isnan(w), f
        if not np.isnan(w):
            _close(g, w)
    assert np.isnan(got.t_first) == np.isnan(want.t_first)
    if not np.isnan(want.t_first):
        _close(got.t_first, want.t_first)
    for f in ("tail_eval", "tail_commit", "tail_step_index", "has_noise", "n_nfe",
              "initial_correct_record", "denoise_final", "denoise_step_index"):
        assert getattr(got, f) == getattr(want, f), f
    _rows_close(got.scan_rows, want.scan_rows)
    _rows_close(got.tail_rows, want.tail_rows)
    assert len(got.seg_scans) == len(want.seg_scans)
    for g, w in zip(got.seg_scans, want.seg_scans):
        assert (g.eval_after, g.commit) == (w.eval_after, w.commit)
        np.testing.assert_array_equal(g.step_index, w.step_index)
        _rows_close(g.rows, w.rows)


@pytest.mark.parametrize("cfg", [CONFIGS[2], CONFIGS[13], CONFIGS[-1]],
                         ids=["multistep", "singlestep", "unipc"])
def test_device_tables_pack_rows_in_fp32(cfg):
    plan, _ = _plans(cfg)
    dev = plan.device_tables("cpu")
    assert dev is plan.device_tables(torch.device("cpu"))  # packed once per device
    pairs = [(plan.scan_rows, dev["scan"]), (plan.tail_rows, dev["tail"])]
    pairs += [(g.rows.reshape((g.rows.a.size,)), t) for g, t in zip(plan.seg_scans, dev["seg"])]
    for rows, tab in pairs:
        if rows is None:
            assert tab is None
            continue
        assert tab.dtype == torch.float32 and tab.shape == (rows.n_ops, 8)
        want = np.stack([rows.a, *rows.b.T, rows.s_noise, rows.t_next, rows.alpha_next,
                         rows.sigma_next], axis=1).astype(np.float32)
        np.testing.assert_array_equal(tab.numpy(), want)
        np.testing.assert_array_equal(tab[:, A].numpy(), rows.a.astype(np.float32))
        np.testing.assert_array_equal(tab[:, B0:B2 + 1].numpy(), rows.b.astype(np.float32))
        for col, f in ((S, "s_noise"), (T_NEXT, "t_next"), (ALPHA, "alpha_next"),
                       (SIGMA, "sigma_next")):
            np.testing.assert_array_equal(tab[:, col].numpy(),
                                          getattr(rows, f).astype(np.float32))
    if plan.scan_rows is not None and plan.scan_rows.b_corr is not None:
        corr = dev["scan_corr"].numpy()
        np.testing.assert_array_equal(corr[:, 1:4], plan.scan_rows.b_corr.astype(np.float32))
        np.testing.assert_array_equal(corr[:, 4], plan.scan_rows.c_corr.astype(np.float32))
