"""Port executor (dpm_solver_tpu_torch/solver/sample.py) against the JAX `DPM_Solver`.

(a) On the analytic toy model of tests/test_solver_parity.py, implemented in
    both frameworks, over that file's configs (:90-105): multistep, singlestep
    and singlestep_fixed; orders 1-3; dpmsolver and dpmsolver++; taylor;
    denoise_to_zero. Also UniPC, dynamic thresholding, and the SDE solvers fed
    the JAX executor's own normal draws as the port's `noise`. Both sides plan
    the same float64 rows, so the tolerance is 1e-4 relative to max|x|
    (`assert_traj_close`, test_solver_parity.py:70-75) for every config.
    The wrapper's parameterizations and its guidance modes (classifier-free,
    and classifier guidance with an analytic classifier) are held to the JAX
    `model_wrapper` within 1e-6.
    `inverse` passes the adaptive solver's atol and rtol through, and
    `sample(denoise=)` is the older spelling of denoise_to_zero, as in the
    JAX `DPM_Solver`.
(b) The whole slice, small: the tiny DDPM UNet with one random init carried
    into both frameworks, batch 2 at 16x16, DPM-Solver++ 3M for 10 NFE on the
    logSNR grid of the discrete schedule, through `model_wrapper` and
    `DPM_Solver.sample` on both sides, within the same 1e-4 bound.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dpm_solver_tpu as J
import dpm_solver_tpu_torch as P
from dpm_solver_tpu.models import DDPMUNet as JaxDDPMUNet
from dpm_solver_tpu.models import DDPMUNetConfig as JaxConfig
from dpm_solver_tpu.utils.convert import convert_ddpm_unet
from dpm_solver_tpu_torch.models import DDPMUNet, DDPMUNetConfig, init_random_
from dpm_solver_tpu_torch.solver.sample import build_sampler

TOL = 1e-4
SHAPE = (3, 2, 4, 4)
BETAS = np.linspace(1e-4, 0.02, 1000, dtype=np.float64)

CONFIGS = [
    ("discrete", "dpmsolver++", dict(steps=10, order=2, skip_type="time_uniform", method="multistep")),
    ("discrete", "dpmsolver++", dict(steps=10, order=3, skip_type="logSNR", method="multistep")),
    ("discrete", "dpmsolver++", dict(steps=6, order=3, skip_type="logSNR", method="multistep")),
    ("discrete", "dpmsolver", dict(steps=12, order=2, skip_type="time_quadratic", method="multistep")),
    ("discrete", "dpmsolver", dict(steps=10, order=3, skip_type="time_uniform", method="multistep", solver_type="taylor")),
    ("discrete", "dpmsolver++", dict(steps=12, order=2, method="multistep", solver_type="taylor")),
    ("linear", "dpmsolver++", dict(steps=10, order=3, skip_type="logSNR", method="singlestep", t_end=1e-3)),
    ("linear", "dpmsolver", dict(steps=10, order=3, skip_type="logSNR", method="singlestep", t_end=1e-3)),
    ("discrete", "dpmsolver++", dict(steps=9, order=2, skip_type="time_uniform", method="singlestep")),
    ("discrete", "dpmsolver++", dict(steps=9, order=3, skip_type="time_quadratic", method="singlestep")),
    ("discrete", "dpmsolver", dict(steps=9, order=3, skip_type="time_uniform", method="singlestep", solver_type="taylor")),
    ("discrete", "dpmsolver++", dict(steps=9, order=3, method="singlestep_fixed", skip_type="time_uniform")),
    ("discrete", "dpmsolver++", dict(steps=6, order=3, skip_type="logSNR", method="multistep", denoise_to_zero=True)),
    ("discrete", "dpmsolver++", dict(steps=20, order=2, skip_type="time_uniform", method="multistep")),
    ("discrete", "dpmsolver++", dict(steps=10, order=1, skip_type="logSNR", method="multistep")),
    ("discrete", "dpmsolver++", dict(steps=10, order=3, skip_type="logSNR", method="unipc")),
    ("linear", "dpmsolver", dict(steps=8, order=2, skip_type="time_uniform", method="unipc", t_end=1e-3)),
]


def assert_traj_close(got, want, tol=TOL):
    """test_solver_parity.py:70-75: absolute error relative to max|x|."""
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol)


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


@pytest.mark.parametrize("schedule,algorithm,kwargs", CONFIGS,
                         ids=lambda v: v if isinstance(v, str) else None)
def test_toy_model_matches_jax(schedule, algorithm, kwargs):
    ns_j, ns_t = _schedules(schedule)
    x = np.random.default_rng(0).standard_normal(SHAPE).astype(np.float32)
    solver_j = J.DPM_Solver(J.model_wrapper(toy_jax, ns_j), ns_j, algorithm_type=algorithm)
    solver_t = P.DPM_Solver(P.model_wrapper(toy_torch, ns_t), ns_t, algorithm_type=algorithm)
    want = np.asarray(solver_j.sample(jnp.asarray(x), **kwargs))
    got = solver_t.sample(torch.tensor(x), **kwargs)
    assert got.dtype == torch.float32 and got.shape == SHAPE
    assert_traj_close(got.numpy(), want)


@pytest.mark.parametrize("algorithm,order", [("sde-dpmsolver++", 2), ("sde-dpmsolver", 1)])
def test_sde_with_jax_noise_matches_jax(algorithm, order):
    """The JAX executor draws normal(fold_in(rng, step)) for steps 1..N; the
    port takes those draws as `noise`, so the two trajectories must agree."""
    import jax

    ns_j, ns_t = _schedules("discrete")
    kwargs = dict(steps=8, order=order, skip_type="time_uniform", method="multistep")
    x = np.random.default_rng(3).standard_normal(SHAPE).astype(np.float32)
    rng = jax.random.PRNGKey(7)
    noise = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(rng, i), SHAPE))
                      for i in range(1, kwargs["steps"] + 1)])
    want = np.asarray(J.DPM_Solver(J.model_wrapper(toy_jax, ns_j), ns_j, algorithm_type=algorithm)
                      .sample(jnp.asarray(x), rng=rng, **kwargs))
    got = P.DPM_Solver(P.model_wrapper(toy_torch, ns_t), ns_t, algorithm_type=algorithm) \
        .sample(torch.tensor(x), noise=torch.tensor(noise), **kwargs)
    assert_traj_close(got.numpy(), want)


def test_dynamic_thresholding_matches_jax():
    ns_j, ns_t = _schedules("discrete")
    kwargs = dict(steps=10, order=2, skip_type="time_uniform", method="multistep")
    x = (np.random.default_rng(4).standard_normal(SHAPE) * 3).astype(np.float32)
    knobs = dict(correcting_x0_fn="dynamic_thresholding", thresholding_max_val=1.5,
                 dynamic_thresholding_ratio=0.9)
    want = np.asarray(J.DPM_Solver(J.model_wrapper(toy_jax, ns_j), ns_j, **knobs)
                      .sample(jnp.asarray(x), **kwargs))
    got = P.DPM_Solver(P.model_wrapper(toy_torch, ns_t), ns_t, **knobs) \
        .sample(torch.tensor(x), **kwargs)
    assert_traj_close(got.numpy(), want)


def toy_log_prob_jax(x, t_in, c):
    return -jnp.sum((x - c) ** 2, axis=(1, 2, 3)) * (1.0 + 0.001 * t_in)


def toy_log_prob_torch(x, t_in, c):
    return -((x - c) ** 2).sum((1, 2, 3)) * (1.0 + 0.001 * t_in)


@pytest.mark.parametrize("model_type", ["noise", "x_start", "v", "score"])
@pytest.mark.parametrize("guidance", ["uncond", "classifier-free", "classifier"])
def test_model_wrapper_matches_jax(model_type, guidance):
    ns_j, ns_t = _schedules("discrete")
    rng = np.random.default_rng(5)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    cond = rng.standard_normal((SHAPE[0], 1, 1, 1)).astype(np.float32)
    t = np.asarray([0.02, 0.3, 0.9], dtype=np.float32)
    kw = {}
    if guidance == "classifier-free":
        kw = dict(guidance_type=guidance, guidance_scale=3.0)
        jkw = dict(kw, condition=jnp.asarray(cond), unconditional_condition=jnp.zeros_like(cond))
        tkw = dict(kw, condition=torch.tensor(cond),
                   unconditional_condition=torch.zeros(cond.shape))
        jax_net = lambda u, s, c: toy_jax(u, s) * (1.0 + c)
        torch_net = lambda u, s, c: toy_torch(u, s) * (1.0 + c)
    elif guidance == "classifier":
        kw = dict(guidance_type=guidance, guidance_scale=2.0)
        jkw = dict(kw, condition=jnp.asarray(cond), classifier_fn=toy_log_prob_jax)
        tkw = dict(kw, condition=torch.tensor(cond), classifier_fn=toy_log_prob_torch)
        jax_net, torch_net = toy_jax, toy_torch
    else:
        jkw = tkw = kw
        jax_net, torch_net = toy_jax, toy_torch
    want = np.asarray(J.model_wrapper(jax_net, ns_j, model_type=model_type, **jkw)(
        jnp.asarray(x), jnp.asarray(t)))
    got = P.model_wrapper(torch_net, ns_t, model_type=model_type, **tkw)(
        torch.tensor(x), torch.tensor(t)).numpy()
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-6)


def test_build_sampler_and_intermediates_match_class_api():
    _, ns_t = _schedules("discrete")
    x = torch.tensor(np.random.default_rng(1).standard_normal(SHAPE).astype(np.float32))
    kwargs = dict(steps=10, order=3, skip_type="logSNR", method="multistep")
    model_fn = P.model_wrapper(toy_torch, ns_t)
    want = P.DPM_Solver(model_fn, ns_t).sample(x, **kwargs)
    fn = build_sampler(model_fn, ns_t, return_intermediate=True, **kwargs)
    got, inter = fn(x)
    assert torch.equal(got, want)
    assert len(inter) == 11 and torch.equal(inter[0], x) and torch.equal(inter[-1], got)


def test_unsupported_paths_raise():
    _, ns_t = _schedules("discrete")
    solver = P.DPM_Solver(P.model_wrapper(toy_torch, ns_t), ns_t)
    x = torch.zeros(SHAPE)
    # the adaptive solver runs (Slice D), but keeps the JAX entry's refusals
    with pytest.raises(ValueError, match="intermediates"):
        solver.sample(x, method="adaptive", return_intermediate=True)
    # a mesh (parallel.make_mesh) is taken, with the JAX entry's refusals
    with pytest.raises(ValueError, match="jit"):
        solver.sample(x, mesh=object(), jit=False)
    with pytest.raises(ValueError, match="adaptive"):
        solver.sample(x, mesh=object(), method="adaptive")
    with pytest.raises(ValueError, match="classifier_fn"):
        P.model_wrapper(toy_torch, ns_t, guidance_type="classifier")
    # classifier guidance runs (Slice C): eps - s * sigma_t * grad_x log p,
    # here grad_x of -sum(x^2) = -2x, taken under no_grad as the sampler does
    t = torch.full((SHAPE[0],), 0.5)
    guided = P.model_wrapper(toy_torch, ns_t, guidance_type="classifier", guidance_scale=2.0,
                             classifier_fn=lambda u, s, c: -(u ** 2).sum((1, 2, 3)))
    with torch.no_grad():
        got = guided(x + 1.0, t)
    want = toy_torch(x + 1.0, (t - 1e-3) * 1000.0) + 2.0 * ns_t.marginal_std(t)[:, None, None, None] * 2.0 * (x + 1.0)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    sde = P.DPM_Solver(P.model_wrapper(toy_torch, ns_t), ns_t, algorithm_type="sde-dpmsolver++")
    with pytest.raises(ValueError, match="noise"):
        sde.sample(x, steps=4, order=2)


def test_whole_slice_tiny_unet_matches_jax():
    """Tiny UNet, batch 2, 16x16, DPM-Solver++ 3M, 10 NFE, logSNR, discrete."""
    cfg = DDPMUNetConfig.tiny(resolution=16)
    port = init_random_(DDPMUNet(cfg, device="cpu"), torch.Generator().manual_seed(0)).eval()
    params = convert_ddpm_unet({k: v.numpy() for k, v in port.state_dict().items()})
    jax_net = JaxDDPMUNet(JaxConfig.tiny(resolution=16))
    ns_j, ns_t = _schedules("discrete")
    kwargs = dict(steps=10, order=3, skip_type="logSNR", method="multistep")
    x = np.random.default_rng(2).standard_normal((2, 16, 16, 3)).astype(np.float32)

    solver_j = J.DPM_Solver(J.model_wrapper(lambda u, t: jax_net.apply(params, u, t), ns_j),
                            ns_j, algorithm_type="dpmsolver++")
    want = np.asarray(solver_j.sample(jnp.asarray(x), **kwargs))
    solver_t = P.DPM_Solver(P.model_wrapper(port, ns_t), ns_t, algorithm_type="dpmsolver++")
    with torch.no_grad():
        got = solver_t.sample(torch.tensor(x), **kwargs)
    assert got.shape == (2, 16, 16, 3) and torch.isfinite(got).all()
    assert_traj_close(got.numpy(), want)


def test_inverse_passes_atol_rtol_to_the_adaptive_solver():
    """inverse(method="adaptive", atol=, rtol=) against the JAX inverse, within
    1e-4 of max|x|, and unlike the defaults' result. The adaptive controller
    steps toward t = 0 only, in both packages (its step is clamped by
    minimum(., lambda_0 - lambda_s): dpm_solver_tpu/solver/adaptive.py:124),
    so an adaptive inverse from t_0 up to T does not end in either; the
    inverse is taken over the direction the controller runs."""
    ns_j, ns_t = _schedules("discrete")
    x = np.random.default_rng(6).standard_normal(SHAPE).astype(np.float32)
    solver_j = J.DPM_Solver(J.model_wrapper(toy_jax, ns_j), ns_j)
    solver_t = P.DPM_Solver(P.model_wrapper(toy_torch, ns_t), ns_t)
    kw = dict(method="adaptive", order=3, t_start=1.0, t_end=1e-3)
    want = np.asarray(solver_j.inverse(jnp.asarray(x), atol=0.02, rtol=0.1, **kw))
    got = solver_t.inverse(torch.tensor(x), atol=0.02, rtol=0.1, **kw).numpy()
    assert_traj_close(got, want)
    default = solver_t.inverse(torch.tensor(x), **kw).numpy()
    assert np.abs(default - got).max() > 1e-2 * np.abs(want).max()


def test_sample_denoise_is_denoise_to_zero():
    _, ns_t = _schedules("discrete")
    x = torch.tensor(np.random.default_rng(7).standard_normal(SHAPE).astype(np.float32))
    solver = P.DPM_Solver(P.model_wrapper(toy_torch, ns_t), ns_t)
    kwargs = dict(steps=6, order=3, skip_type="logSNR", method="multistep")
    denoised = solver.sample(x, denoise_to_zero=True, **kwargs)
    assert torch.equal(solver.sample(x, denoise=True, **kwargs), denoised)
    assert not torch.equal(solver.sample(x, **kwargs), denoised)
    assert torch.equal(solver.sample(x, denoise=False, denoise_to_zero=True, **kwargs),
                       solver.sample(x, **kwargs))


# --------------------------------------------------------------------------- #
# jit=: the JAX API's compiled trajectory, a CUDA graph in the port
# --------------------------------------------------------------------------- #

JIT_CONFIGS = [
    ("discrete", "dpmsolver++", dict(steps=10, order=3, skip_type="logSNR", method="multistep")),
    ("linear", "dpmsolver++", dict(steps=10, order=3, skip_type="logSNR", method="singlestep",
                                   t_end=1e-3)),
    ("discrete", "dpmsolver++", dict(steps=6, order=3, skip_type="logSNR", method="multistep",
                                     denoise_to_zero=True)),
]


@pytest.mark.parametrize("schedule,algorithm,kwargs", JIT_CONFIGS,
                         ids=["multistep", "singlestep", "denoise"])
def test_sample_takes_jit_like_jax(schedule, algorithm, kwargs):
    """`sample(jit=)` as the JAX `DPM_Solver.sample` takes it: on the CPU
    both settings run the same eager loop (a CUDA graph needs a CUDA x), and
    both equal the JAX jitted trajectory within 1e-4 of max|x|."""
    ns_j, ns_t = _schedules(schedule)
    x = np.random.default_rng(11).standard_normal(SHAPE).astype(np.float32)
    want = np.asarray(J.DPM_Solver(J.model_wrapper(toy_jax, ns_j), ns_j, algorithm_type=algorithm)
                      .sample(jnp.asarray(x), jit=True, **kwargs))
    solver = P.DPM_Solver(P.model_wrapper(toy_torch, ns_t), ns_t, algorithm_type=algorithm)
    eager = solver.sample(torch.tensor(x), jit=False, **kwargs)
    jitted = solver.sample(torch.tensor(x), jit=True, **kwargs)
    assert torch.equal(eager, jitted)
    assert_traj_close(jitted.numpy(), want)
    assert not solver._graphed  # no graph is made for a CPU x


def test_graph_key_holds_shape_dtype_device_and_noise():
    """The capture key (`graph_key`) separates what the JAX cache key
    (dpm_solver_tpu/solver/sample.py:512-516) separates: x's shape, dtype and
    device, and whether noise comes (and its shape)."""
    x = torch.zeros(SHAPE)
    key = P.solver.graph_key
    assert key(x) == key(torch.ones(SHAPE))
    assert key(x) != key(torch.zeros(2, 2, 4, 4))
    assert key(x) != key(x.to(torch.float64))
    assert key(x) != key(torch.zeros(SHAPE, device="meta"))
    noise = torch.zeros((4,) + SHAPE)
    assert key(x) != key(x, noise)
    assert key(x, noise) != key(x, torch.zeros((5,) + SHAPE))


@pytest.mark.parametrize("algorithm", ["dpmsolver++", "sde-dpmsolver++"])
def test_graphed_sampler_is_the_eager_sampler_on_the_cpu(algorithm):
    """`GraphedSampler`, the counterpart of `jit_hoisting_constants` for
    `build_sampler` users, returns the eager result (and takes the noise of
    an SDE plan) on a CPU x, where there is no graph to capture."""
    _, ns_t = _schedules("discrete")
    kwargs = dict(steps=8, order=2, skip_type="time_uniform", method="multistep")
    fn = build_sampler(P.model_wrapper(toy_torch, ns_t), ns_t, algorithm_type=algorithm, **kwargs)
    rng = np.random.default_rng(12)
    x = torch.tensor(rng.standard_normal(SHAPE).astype(np.float32))
    noise = (torch.tensor(rng.standard_normal((8,) + SHAPE).astype(np.float32))
             if algorithm.startswith("sde") else None)
    graphed = P.GraphedSampler(fn)
    before = P.GraphedSampler.captures
    got = graphed(x) if noise is None else graphed(x, noise)
    assert torch.equal(got, fn(x, noise))
    assert P.GraphedSampler.captures == before and not graphed._graphs


SAFE_PLANS = {
    "multistep": ("discrete", "dpmsolver++", dict(steps=6, order=3, skip_type="logSNR",
                                                  method="multistep")),
    "singlestep": ("linear", "dpmsolver++", dict(steps=9, order=3, skip_type="logSNR",
                                                 method="singlestep", t_end=1e-3)),
    "denoise": ("discrete", "dpmsolver", dict(steps=6, order=2, skip_type="time_uniform",
                                              method="multistep", denoise_to_zero=True)),
    "unipc": ("discrete", "dpmsolver++", dict(steps=6, order=2, skip_type="logSNR",
                                              method="unipc")),
    "sde": ("discrete", "sde-dpmsolver++", dict(steps=6, order=2, skip_type="time_uniform",
                                                method="multistep")),
}


@pytest.mark.parametrize("name", sorted(SAFE_PLANS))
def test_executor_makes_no_tensor_from_host_data_after_the_warm_call(name, monkeypatch):
    """What a CUDA graph cannot capture is a copy from host memory: after one
    warm call (which packs the plan's device tables and the schedule's), a
    call of `execute_plan` makes no tensor from host data, for a multistep,
    a singlestep, a denoise-to-zero, a UniPC and an SDE plan."""
    schedule, algorithm, kwargs = SAFE_PLANS[name]
    _, ns_t = _schedules(schedule)
    fn = build_sampler(P.model_wrapper(toy_torch, ns_t), ns_t, algorithm_type=algorithm, **kwargs)
    rng = np.random.default_rng(13)
    x = torch.tensor(rng.standard_normal(SHAPE).astype(np.float32))
    noise = (torch.tensor(rng.standard_normal((6,) + SHAPE).astype(np.float32))
             if algorithm.startswith("sde") else None)
    want = fn(x, noise)

    def guard(make):
        def made(data, *args, **kw):
            if not isinstance(data, torch.Tensor):
                raise AssertionError(f"a tensor made from host data {type(data).__name__}")
            return make(data, *args, **kw)
        return made

    monkeypatch.setattr(torch, "tensor", guard(torch.tensor))
    monkeypatch.setattr(torch, "as_tensor", guard(torch.as_tensor))
    assert torch.equal(fn(x, noise), want)
