"""Port adaptive solver (dpm_solver_tpu_torch/solver/adaptive.py) against the JAX one.

On the analytic toy model of tests/test_solver_parity.py, implemented in both
frameworks, orders 2 and 3 of dpmsolver and dpmsolver++ on the linear and the
discrete schedule take the same number of model evaluations as the JAX
`lax.while_loop` controller and end within 5e-3 of max|x|, the repo's
adaptive bound (tests/test_solver_parity.py:286: each side accepts its steps
on its own fp32 error estimate). The same holds through `DPM_Solver.sample`
with denoise_to_zero, and for a tiny VP NCSN++ (FIR resampling, residual
input pyramid) on continuous-VP labels. The errors the JAX entry raises are
raised too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dpm_solver_tpu as J
import dpm_solver_tpu_torch as P
from dpm_solver_tpu.models.ncsnpp import NCSNpp as JaxNCSNpp
from dpm_solver_tpu.models.ncsnpp import NCSNppConfig as JaxConfig
from dpm_solver_tpu.models.ncsnpp_convert import params_from_torch
from dpm_solver_tpu.solver.adaptive import adaptive_sample as jax_adaptive
from dpm_solver_tpu_torch.models import NCSNpp, NCSNppConfig, init_random_
from dpm_solver_tpu_torch.solver.adaptive import adaptive_sample

TOL = 5e-3
SHAPE = (3, 2, 4, 4)
BETAS = np.linspace(1e-4, 0.02, 1000, dtype=np.float64)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's CPU work, the module fixtures' too:
    these small shapes gain nothing from more, and the suite runs several
    workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def toy_jax(x, t_in):
    t = jnp.reshape(t_in, (-1,) + (1,) * (x.ndim - 1))
    return jnp.sin(3.0 * x) * jnp.cos(0.01 * t) + 0.1 * x * (1.0 + 0.001 * t)


def toy_torch(x, t_in):
    t = torch.reshape(t_in, (-1,) + (1,) * (x.dim() - 1))
    return torch.sin(3.0 * x) * torch.cos(0.01 * t) + 0.1 * x * (1.0 + 0.001 * t)


def _schedules(kind):
    if kind == "discrete":
        return J.NoiseScheduleVP.discrete(betas=BETAS), P.NoiseScheduleVP.discrete(betas=BETAS)
    return J.NoiseScheduleVP.linear(), P.NoiseScheduleVP.linear()


def assert_traj_close(got, want, tol=TOL):
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol)


@pytest.mark.parametrize("schedule", ["linear", "discrete"])
@pytest.mark.parametrize("algorithm", ["dpmsolver++", "dpmsolver"])
@pytest.mark.parametrize("order", [2, 3])
def test_toy_model_same_nfe_and_result_as_jax(schedule, algorithm, order):
    ns_j, ns_t = _schedules(schedule)
    x = np.random.default_rng(11).standard_normal(SHAPE).astype(np.float32)
    want, nfe_j = jax_adaptive(J.model_wrapper(toy_jax, ns_j), ns_j, jnp.asarray(x), order=order,
                               algorithm_type=algorithm, t_end=1e-3)
    got, nfe_t = adaptive_sample(P.model_wrapper(toy_torch, ns_t), ns_t, torch.tensor(x),
                                 order=order, algorithm_type=algorithm, t_end=1e-3)
    assert nfe_t == int(nfe_j) and got.dtype == torch.float32
    assert_traj_close(got.numpy(), np.asarray(want))


def test_class_api_with_denoise_to_zero_matches_jax():
    ns_j, ns_t = _schedules("discrete")
    x = np.random.default_rng(3).standard_normal(SHAPE).astype(np.float32)
    kw = dict(method="adaptive", order=2, t_end=1e-3, denoise_to_zero=True)
    want = J.DPM_Solver(J.model_wrapper(toy_jax, ns_j), ns_j).sample(jnp.asarray(x), **kw)
    got = P.DPM_Solver(P.model_wrapper(toy_torch, ns_t), ns_t).sample(torch.tensor(x), **kw)
    assert_traj_close(got.numpy(), np.asarray(want))


def test_tiny_vp_ncsnpp_same_nfe_and_result_as_jax():
    """The tiny twin of cifar10_ncsnpp_vp: FIR resampling, residual input
    pyramid, positional embedding of t*999; order 3, dpmsolver++."""
    kw = dict(fir=True, progressive_input="residual", num_res_blocks=1)
    cfg = NCSNppConfig.tiny(**kw)
    port = init_random_(NCSNpp(cfg, device="cpu"), torch.Generator().manual_seed(0)).eval()
    params = params_from_torch({k: v.numpy() for k, v in port.state_dict().items()},
                               JaxConfig.tiny(**kw))
    jax_net = JaxNCSNpp(config=JaxConfig.tiny(**kw))
    ns_j, ns_t = _schedules("linear")
    x = np.random.default_rng(4).standard_normal((2, 16, 16, 3)).astype(np.float32)
    raw_j = lambda u, t: jax_net.apply(params, u, t * 999.0, deterministic=True)
    want, nfe_j = jax_adaptive(J.model_wrapper(raw_j, ns_j), ns_j, jnp.asarray(x), order=3,
                               t_end=1e-3)
    with torch.no_grad():
        got, nfe_t = adaptive_sample(P.model_wrapper(lambda u, t: port(u, t * 999.0), ns_t),
                                     ns_t, torch.tensor(x), order=3, t_end=1e-3)
    assert nfe_t == int(nfe_j) and torch.isfinite(got).all()
    assert_traj_close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kwargs,match", [
    (dict(order=1), "order"),
    (dict(order=2, return_intermediate=True), "intermediates"),
    (dict(order=2, mesh=object()), "mesh"),
])
def test_class_api_raises_what_jax_raises(kwargs, match):
    _, ns_t = _schedules("linear")
    solver = P.DPM_Solver(P.model_wrapper(toy_torch, ns_t), ns_t)
    with pytest.raises((ValueError, NotImplementedError), match=match):
        solver.sample(torch.zeros(SHAPE), method="adaptive", **kwargs)


def test_adaptive_refuses_sde_algorithms_and_xt_correction():
    _, ns_t = _schedules("linear")
    model_fn = P.model_wrapper(toy_torch, ns_t)
    with pytest.raises(ValueError, match="dpmsolver"):
        adaptive_sample(model_fn, ns_t, torch.zeros(SHAPE), algorithm_type="sde-dpmsolver++")
    solver = P.DPM_Solver(model_fn, ns_t, correcting_xt_fn=lambda x, t, step: x)
    with pytest.raises(ValueError, match="correcting_xt_fn"):
        solver.sample(torch.zeros(SHAPE), method="adaptive", order=2)
