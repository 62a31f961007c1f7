"""Port `NoiseScheduleVP` (dpm_solver_tpu_torch/schedule.py) against the JAX package.

Torch fp32 methods within 1e-6 of the JAX fp32 methods, relative to the
largest magnitude compared (both interpolate the same fp32-rounded tables
with the same ops); the float64 host twins that the planner calls within
1e-12 (they interpolate the same rounded tables in float64).

One exception, measured: the cosine schedule's sigma and lambda near t = 0.
There sigma = sqrt(-expm1(2 log alpha)) amplifies a 1-ulp difference between
XLA's and torch's fp32 `cos` by 1/(2|log alpha|), so the two fp32 results
differ by up to 1.5e-6 (sigma) and 3.7e-5 (lambda), each at points where the
other is the exact one. Both are held to the float64 truth instead: the
port's error may not exceed the JAX package's own error plus 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpm_solver_tpu import NoiseScheduleVP as JaxNS
from dpm_solver_tpu.schedule import expand_dims as jax_expand_dims
from dpm_solver_tpu.schedule import interpolate_fn as jax_interpolate_fn
from dpm_solver_tpu_torch import NoiseScheduleVP, expand_dims, interpolate_fn

FP32_REL = 1e-6
HOST_REL = 1e-12


def _cosine_alphas_cumprod(n=1000, s=0.008):
    steps = np.arange(n + 1, dtype=np.float64) / n
    f = np.cos((steps + s) / (1 + s) * np.pi / 2) ** 2
    return np.clip(f[1:] / f[0], 1e-8, None)


def _pair(kind):
    betas = np.linspace(1e-4, 0.02, 1000, dtype=np.float64)
    if kind == "discrete":
        return JaxNS.discrete(betas=betas), NoiseScheduleVP.discrete(betas=betas)
    if kind == "discrete_alphas_cumprod":
        # the cosine table drives the numerical clip of the lambda tail
        ac = _cosine_alphas_cumprod()
        return (JaxNS.discrete(alphas_cumprod=ac),
                NoiseScheduleVP("discrete", alphas_cumprod=ac))
    if kind == "linear":
        return JaxNS.linear(), NoiseScheduleVP.linear()
    return JaxNS.cosine(), NoiseScheduleVP.cosine()


def _grid(ns, n):
    """n times from the schedule's first table time (1e-3 if continuous) to T:
    below the first table time the discrete schedule extrapolates to
    log alpha > 0, where sigma is not defined."""
    lo = 1e-3 if ns.schedule != "discrete" else max(1e-3, float(ns.t_array_np[0]))
    return np.linspace(lo, ns.T, n)


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.all(np.isfinite(want)) and np.all(np.isfinite(got))
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=rel)


KINDS = ["discrete", "discrete_alphas_cumprod", "linear", "cosine"]
ILL_CONDITIONED = {("cosine", "marginal_std"), ("cosine", "marginal_lambda")}


@pytest.mark.parametrize("kind", KINDS)
def test_static_fields_match(kind):
    j, t = _pair(kind)
    assert (t.schedule, t.total_N, t.T) == (j.schedule, j.total_N, j.T)
    if kind.startswith("discrete"):
        np.testing.assert_array_equal(t.t_array_np, np.asarray(j.t_array, np.float64))
        np.testing.assert_array_equal(t.log_alpha_array_np,
                                      np.asarray(j.log_alpha_array, np.float64))


@pytest.mark.parametrize("kind", KINDS)
def test_torch_methods_match_jax(kind):
    _hold_methods(*_pair(kind), kind)


def _hold_methods(j, t, kind):
    """The fp32 torch methods of `t` against the JAX object `j` (the cosine
    schedule's ill-conditioned pair against the float64 truth)."""
    ts = _grid(t, 333).astype(np.float32)
    for name in ("marginal_log_mean_coeff", "marginal_alpha", "marginal_std",
                 "marginal_lambda"):
        want = np.asarray(getattr(j, name)(jnp.asarray(ts)))
        got = getattr(t, name)(torch.tensor(ts)).numpy()
        assert got.dtype == np.float32
        if (kind, name) in ILL_CONDITIONED:
            exact = getattr(t, name + "_np")(ts.astype(np.float64))
            scale = max(1.0, float(np.max(np.abs(exact))))
            jax_err = np.max(np.abs(want - exact)) / scale
            assert np.max(np.abs(got - exact)) / scale <= jax_err + FP32_REL
        else:
            _close(got, want, FP32_REL)
    lambdas = np.asarray(j.marginal_lambda(jnp.asarray(ts)))
    _close(t.inverse_lambda(torch.tensor(lambdas)).numpy(),
           np.asarray(j.inverse_lambda(jnp.asarray(lambdas))), FP32_REL)


# the JAX package's constructor forms (dpm_solver_tpu/schedule.py:73-86 routes
# a reference-style call to `create`, :119-126; `discrete` takes dtype, :177-178),
# each built the same way on both sides: (kind for the cosine rule, port, JAX)
_BETAS = np.linspace(1e-4, 0.02, 1000, dtype=np.float64)
FORMS = {
    "ref_discrete_dtype": ("discrete",
                           lambda: NoiseScheduleVP("discrete", betas=_BETAS, dtype=torch.float32),
                           lambda: JaxNS("discrete", betas=_BETAS, dtype=jnp.float32)),
    "ref_linear_betas": ("linear",
                         lambda: NoiseScheduleVP("linear", continuous_beta_0=0.05,
                                                 continuous_beta_1=15.0),
                         lambda: JaxNS("linear", continuous_beta_0=0.05, continuous_beta_1=15.0)),
    "create_linear": ("linear", lambda: NoiseScheduleVP.create("linear"),
                      lambda: JaxNS.create("linear")),
    "create_cosine": ("cosine", lambda: NoiseScheduleVP.create("cosine", dtype=torch.float32),
                      lambda: JaxNS.create("cosine", dtype=jnp.float32)),
    "create_discrete_alphas_cumprod": (
        "discrete", lambda: NoiseScheduleVP.create(
            "discrete", alphas_cumprod=_cosine_alphas_cumprod(), dtype=torch.float32),
        lambda: JaxNS.create("discrete", alphas_cumprod=_cosine_alphas_cumprod(),
                             dtype=jnp.float32)),
    "discrete_dtype": ("discrete",
                       lambda: NoiseScheduleVP.discrete(betas=_BETAS, dtype=torch.float32),
                       lambda: JaxNS.discrete(betas=_BETAS, dtype=jnp.float32)),
}


@pytest.mark.parametrize("form", FORMS)
def test_constructor_forms_match_jax(form):
    kind, port, ref = FORMS[form]
    t, j = port(), ref()
    assert (t.schedule, t.total_N, t.T, t.beta_0, t.beta_1) == \
        (j.schedule, j.total_N, j.T, j.beta_0, j.beta_1)
    _hold_methods(j, t, kind)


def test_dtype_sets_the_tables_and_untyped_times():
    """`dtype` rounds the discrete tables once and is the default of
    `tables()` and the dtype of a t that is not a floating tensor."""
    t32 = NoiseScheduleVP.discrete(betas=_BETAS)
    t64 = NoiseScheduleVP("discrete", betas=_BETAS, dtype=torch.float64)
    assert t32.tables("cpu")[1].dtype == torch.float32
    assert t64.tables("cpu")[1].dtype == torch.float64
    want = 0.5 * np.cumsum(np.log1p(-_BETAS))
    np.testing.assert_array_equal(t64.log_alpha_array_np, want)
    np.testing.assert_array_equal(t32.log_alpha_array_np, want.astype(np.float32))
    assert t64.marginal_log_mean_coeff(0.5).dtype == torch.float64
    assert t32.marginal_log_mean_coeff(0.5).dtype == torch.float32
    got = t64.marginal_log_mean_coeff(torch.tensor([0.25, 0.5], dtype=torch.float64))
    np.testing.assert_allclose(got.numpy(), t64.marginal_log_mean_coeff_np([0.25, 0.5]),
                               rtol=0, atol=1e-15)


@pytest.mark.parametrize("kind", KINDS)
def test_host_twins_match_jax(kind):
    j, t = _pair(kind)
    ts = _grid(t, 1001)
    for name in ("marginal_log_mean_coeff_np", "marginal_alpha_np", "marginal_std_np",
                 "marginal_lambda_np"):
        _close(getattr(t, name)(ts), getattr(j, name)(ts), HOST_REL)
    lambdas = j.marginal_lambda_np(ts)
    _close(t.inverse_lambda_np(lambdas), j.inverse_lambda_np(lambdas), HOST_REL)


def test_reference_helpers_match_jax():
    rng = np.random.default_rng(0)
    xp = np.sort(rng.standard_normal((3, 7)), axis=1).astype(np.float32)
    yp = rng.standard_normal((3, 7)).astype(np.float32)
    x = (rng.standard_normal((11, 3)) * 2).astype(np.float32)  # incl. extrapolation
    want = np.asarray(jax_interpolate_fn(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(yp)))
    got = interpolate_fn(torch.tensor(x), torch.tensor(xp), torch.tensor(yp)).numpy()
    _close(got, want, FP32_REL)
    v = np.arange(4.0, dtype=np.float32)
    assert tuple(expand_dims(torch.tensor(v), 4).shape) == \
        tuple(jax_expand_dims(jnp.asarray(v), 4).shape) == (4, 1, 1, 1)
