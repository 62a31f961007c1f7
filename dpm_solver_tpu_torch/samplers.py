"""Classic sampler zoo on torch: predictor-corrector, DDIM, ancestral DDPM, PLMS.

Port of `dpm_solver_tpu/samplers.py`:
  * the predictor/corrector registry and the PC sampler
    (score_sde_jax/sampling.py:101-456);
  * DDIM (`generalized_steps`) and ancestral DDPM (`ddpm_steps`)
    (ddpm_and_guided-diffusion/functions/denoising.py:21-104) on
    NoiseScheduleVP's discrete tables, and PLMS (stable-diffusion plms.py);
  * `slerp` and `interpolation_grid` for latent interpolation.

Randomness. The JAX loops draw their noise inside `lax.scan` from split keys,
a stream no torch generator reproduces. So each sampler here takes its
standard-normal draws from outside: `noise=`, a tensor (draws, *x.shape)
whose rows are used in the order the JAX loop uses its draws, or
`generator=`, a `torch.Generator` on x's device that draws the same count in
the same order. Each sampler states its number of draws.

The loops run eagerly, one network evaluation at a time, on x's device; the
networks launch their own kernels. Predictors and correctors keep the JAX
registry's signatures with the key replaced by `draw`, a callable that
returns the next standard-normal draw of x's shape.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from dpm_solver_tpu_torch.schedule import NoiseScheduleVP
from dpm_solver_tpu_torch.sde import VESDE, VPSDE, _grid_index, batch_mul, reverse_sde

_PREDICTORS = {}
_CORRECTORS = {}


def register_predictor(name, draws: int = 1):
    """Register a predictor under `name`; `draws`: the standard-normal draws
    one step makes."""
    def deco(fn):
        fn.draws = draws
        _PREDICTORS[name] = fn
        return fn
    return deco


def register_corrector(name, draws: int = 1):
    """Register a corrector under `name`; `draws`: the draws of one of its
    inner steps."""
    def deco(fn):
        fn.draws = draws
        _CORRECTORS[name] = fn
        return fn
    return deco


def get_predictor(name):
    return _PREDICTORS[name]


def get_corrector(name):
    return _CORRECTORS[name]


class Draws:
    """`count` standard-normal draws of `like`'s shape, dtype and device,
    handed out in order: the rows of `noise` (count, *shape), or fresh draws
    from `generator`."""

    def __init__(self, count: int, like: torch.Tensor, noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None):
        self.shape, self.dtype, self.device = tuple(like.shape), like.dtype, like.device
        self.count = count
        self.generator, self.used = generator, 0
        if noise is None:
            if generator is None and count:
                raise ValueError(f"pass noise= of shape {(count, *self.shape)} or a "
                                 "torch.Generator on x's device")
        elif tuple(noise.shape) != (count, *self.shape):
            raise ValueError(f"noise must be {(count, *self.shape)}; got {tuple(noise.shape)}")
        else:
            noise = noise.to(self.device, self.dtype)
        self.noise = noise

    def __call__(self) -> torch.Tensor:
        if self.used >= self.count:
            raise RuntimeError(f"more than the {self.count} draws stated")
        self.used += 1
        if self.noise is not None:
            return self.noise[self.used - 1]
        return torch.randn(self.shape, generator=self.generator, dtype=self.dtype,
                           device=self.device)


def time_grid(start: float, stop: float, num: int, device=None) -> torch.Tensor:
    """`jnp.linspace(start, stop, num)` in float32 as XLA compiles it: step
    i * (1 / (num - 1)), the stop's term reassociated to i * (stop / (num -
    1)), the last point `stop`. `torch.linspace` differs in the last bit at
    about half the points, and one ulp can move `t * (N - 1)` across an
    integer: the ancestral predictor's and `_alpha_for`'s table index."""
    f32 = np.float32
    if num == 1:
        return torch.tensor([start], dtype=torch.float32, device=device)
    div = num - 1
    i = np.arange(div, dtype=f32)
    r = f32(f32(1.0) / f32(div))
    head = f32(start) * (f32(1.0) - i * r) + i * f32(f32(stop) * r)
    grid = np.concatenate([head.astype(f32), [f32(stop)]]).astype(f32)
    return torch.from_numpy(grid).to(device)


# ---- predictors: (draw, x, t, sde, score_fn, probability_flow) -> (x, x_mean) ----


@register_predictor("euler_maruyama")
def euler_maruyama_predictor(draw, x, t, sde, score_fn, probability_flow=False):
    rsde = reverse_sde(sde, score_fn, probability_flow)
    dt = -sde.T / sde.N
    z = draw()
    drift, diffusion = rsde.sde(x, t)
    x_mean = x + drift * dt
    return x_mean + batch_mul(diffusion, math.sqrt(-dt) * z), x_mean


@register_predictor("reverse_diffusion")
def reverse_diffusion_predictor(draw, x, t, sde, score_fn, probability_flow=False):
    f, g = reverse_sde(sde, score_fn, probability_flow).discretize(x, t)
    z = draw()
    x_mean = x - f
    return x_mean + batch_mul(g, z), x_mean


@register_predictor("ancestral_sampling")
def ancestral_sampling_predictor(draw, x, t, sde, score_fn, probability_flow=False):
    """DDPM/SMLD ancestral step (ref sampling.py AncestralSamplingPredictor)."""
    assert not probability_flow
    idx = _grid_index(t, sde.N, sde.T)
    if isinstance(sde, VPSDE):
        beta = torch.as_tensor(sde._betas(), dtype=x.dtype, device=x.device)[idx]
        score = score_fn(x, t)
        x_mean = batch_mul(1.0 / torch.sqrt(1.0 - beta), x + batch_mul(beta, score))
        return x_mean + batch_mul(torch.sqrt(beta), draw()), x_mean
    if isinstance(sde, VESDE):
        sigmas = torch.as_tensor(sde._sigmas(), dtype=x.dtype, device=x.device)
        sigma = sigmas[idx]
        adjacent = torch.where(idx == 0, torch.zeros_like(sigma), sigmas[(idx - 1).clamp(min=0)])
        score = score_fn(x, t)
        x_mean = x + batch_mul(sigma**2 - adjacent**2, score)
        std = torch.sqrt(adjacent**2 * (sigma**2 - adjacent**2)
                         / torch.clamp(sigma**2, min=1e-20))
        return x_mean + batch_mul(std, draw()), x_mean
    raise NotImplementedError


@register_predictor("none", draws=0)
def none_predictor(draw, x, t, sde, score_fn, probability_flow=False):
    return x, x


# ---- correctors: (draw, x, t, sde, score_fn, snr, n_steps) -> (x, x_mean) ----


def _alpha_for(sde, t, dtype):
    if isinstance(sde, VPSDE):
        betas = torch.as_tensor(sde._betas(), dtype=dtype, device=t.device)
        return 1.0 - betas[_grid_index(t, sde.N, sde.T)]
    return torch.ones_like(t)


def _batch_norm_mean(v: torch.Tensor) -> torch.Tensor:
    """The mean over the batch of the per-sample L2 norms."""
    return torch.linalg.vector_norm(v.reshape(v.shape[0], -1), dim=-1).mean()


@register_corrector("langevin")
def langevin_corrector(draw, x, t, sde, score_fn, snr=0.16, n_steps=1):
    """Langevin MCMC corrector; the step size comes from the batch means of
    the gradient's and the noise's per-sample norms, as in the reference."""
    alpha = _alpha_for(sde, t, x.dtype)
    x_mean = x
    for _ in range(n_steps):
        grad = score_fn(x, t)
        noise = draw()
        step_size = (snr * _batch_norm_mean(noise) / _batch_norm_mean(grad)) ** 2 * 2.0 * alpha
        x_mean = x + batch_mul(step_size, grad)
        x = x_mean + batch_mul(torch.sqrt(2.0 * step_size), noise)
    return x, x_mean


@register_corrector("ald")
def ald_corrector(draw, x, t, sde, score_fn, snr=0.16, n_steps=1):
    """Annealed Langevin Dynamics (NCSNv2): step size from the target std."""
    alpha = _alpha_for(sde, t, x.dtype)
    std = sde.marginal_prob(torch.zeros_like(x), t)[1]
    x_mean = x
    for _ in range(n_steps):
        grad = score_fn(x, t)
        noise = draw()
        step_size = (snr * std) ** 2 * 2.0 * alpha
        x_mean = x + batch_mul(step_size, grad)
        x = x_mean + batch_mul(torch.sqrt(2.0 * step_size), noise)
    return x, x_mean


@register_corrector("none", draws=0)
def none_corrector(draw, x, t, sde, score_fn, snr=0.16, n_steps=1):
    return x, x


# ---- PC sampler ----


def pc_draws(sde, predictor: str, corrector: str, n_corrector_steps: int) -> int:
    """The standard-normal draws of one PC run: per step the corrector's
    (one an inner step), then the predictor's."""
    return sde.N * (get_corrector(corrector).draws * n_corrector_steps
                    + get_predictor(predictor).draws)


def get_pc_sampler(
    sde,
    score_fn: Callable,
    *,
    predictor: str = "reverse_diffusion",
    corrector: str = "none",
    snr: float = 0.16,
    n_corrector_steps: int = 1,
    probability_flow: bool = False,
    denoise: bool = True,
    eps: float = 1e-3,
) -> Callable:
    """Returns sampler(x_T, noise=None, generator=None) -> (x0, nfe).

    N steps on the grid from T down to `eps`, each the corrector then the
    predictor (ref loop: score_sde_jax/sampling.py:391-456). Draws:
    `pc_draws(sde, predictor, corrector, n_corrector_steps)`, in each step
    the corrector's inner steps' and then the predictor's.
    """
    pred = get_predictor(predictor)
    corr = get_corrector(corrector)
    evals_per_step = ((0 if predictor == "none" else 1)
                      + (0 if corrector == "none" else n_corrector_steps))

    def sampler(x, noise=None, generator=None):
        draw = Draws(pc_draws(sde, predictor, corrector, n_corrector_steps), x, noise, generator)
        timesteps = time_grid(sde.T, eps, sde.N, device=x.device)
        x_mean = x
        for i in range(sde.N):
            tb = timesteps[i].to(x.dtype).expand(x.shape[0])
            x, x_mean = corr(draw, x, tb, sde, score_fn, snr, n_corrector_steps)
            x, x_mean = pred(draw, x, tb, sde, score_fn, probability_flow)
        return (x_mean if denoise else x), sde.N * evals_per_step

    return sampler


# ---- DDIM / ancestral DDPM / PLMS on discrete beta tables ----


def _abar(ns: NoiseScheduleVP) -> np.ndarray:
    """alpha-bar at the discrete grid's n_train times, float64."""
    n = ns.total_N
    log_alpha = np.asarray(ns.marginal_log_mean_coeff_np(
        (np.arange(n, dtype=np.float64) + 1) / n))
    return np.exp(2.0 * log_alpha)


def _rows(x: torch.Tensor, *cols) -> list:
    """The host tables as float32 rows on x's device (the JAX scan's rows)."""
    return [torch.as_tensor(np.asarray(c), dtype=torch.float32, device=x.device) for c in cols]


def _labels(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return t.expand(x.shape[0])


def ddim_sampler(
    model_fn: Callable,
    ns: NoiseScheduleVP,
    *,
    steps: int = 50,
    eta: float = 0.0,
    skip_type: str = "uniform",
) -> Callable:
    """DDIM (`generalized_steps`, denoising.py:21-51): sampler(x, noise=None,
    generator=None) -> x0.

    model_fn(x, t_discrete_float) -> eps. eta=0 is deterministic DDIM (no
    draws); eta > 0 draws one standard normal a step (as many as the
    deduplicated grid has steps: `len(sampler.t_seq)`).
    """
    n_train = ns.total_N
    if skip_type == "uniform":
        seq = np.linspace(0, n_train - 1, steps + 1)[1:].astype(np.int64)
    elif skip_type == "quad":
        seq = (np.linspace(0, np.sqrt(n_train * 0.8), steps) ** 2).astype(np.int64)
    else:
        raise ValueError(skip_type)
    seq = np.unique(seq)
    abar = _abar(ns)
    at_seq = abar[seq][::-1].copy()                       # descending time
    at_next_seq = np.concatenate([[1.0], abar[seq]])[:-1][::-1].copy()
    t_seq = seq[::-1].astype(np.float64).copy()

    def sampler(x, noise=None, generator=None):
        draw = Draws(len(t_seq) if eta > 0 else 0, x, noise, generator)
        for t, at, at_next in zip(*(r.unbind(0) for r in _rows(x, t_seq, at_seq, at_next_seq))):
            e = model_fn(x, _labels(x, t))
            x0 = (x - e * torch.sqrt(1.0 - at)) / torch.sqrt(at)
            c1 = eta * torch.sqrt((1.0 - at / at_next) * (1.0 - at_next) / (1.0 - at))
            c2 = torch.sqrt(torch.clamp(1.0 - at_next - c1**2, min=0.0))
            x_next = torch.sqrt(at_next) * x0 + c2 * e
            if eta > 0:
                x_next = x_next + c1 * draw()
            x = x_next
        return x

    sampler.t_seq = t_seq
    return sampler


def ddpm_ancestral_sampler(model_fn: Callable, ns: NoiseScheduleVP,
                           *, steps: Optional[int] = None) -> Callable:
    """Ancestral DDPM sampling (`ddpm_steps`, denoising.py:54-104):
    sampler(x, noise=None, generator=None) -> x0. One draw a step (`steps`,
    n_train by default), the last one masked out at t = 0; the variance is
    the fixed-large beta of the subsampled grid."""
    n_train = ns.total_N
    steps = n_train if steps is None else steps
    seq = np.linspace(0, n_train - 1, steps).astype(np.int64)
    abar = _abar(ns)
    t_seq = seq[::-1].astype(np.float64).copy()
    at = abar[seq][::-1].copy()
    atm1 = np.concatenate([[1.0], abar[seq]])[:-1][::-1].copy()
    beta_t = 1.0 - at / atm1  # subsampled-grid beta (denoising.py:81)

    def sampler(x, noise=None, generator=None):
        draw = Draws(len(t_seq), x, noise, generator)
        for t, at_i, atm1_i, beta_i in zip(*(r.unbind(0) for r in
                                              _rows(x, t_seq, at, atm1, beta_t))):
            e = model_fn(x, _labels(x, t))
            x0 = torch.clamp((x - e * torch.sqrt(1.0 - at_i)) / torch.sqrt(at_i), -1.0, 1.0)
            mean = (torch.sqrt(atm1_i) * beta_i * x0
                    + torch.sqrt(1.0 - beta_i) * (1.0 - atm1_i) * x) / (1.0 - at_i)
            # fixed-LARGE variance, as the reference (denoising.py:102)
            logvar = torch.log(torch.clamp(beta_i, min=1e-20))
            mask = (t > 0).to(x.dtype)
            x = mean + mask * torch.exp(0.5 * logvar) * draw()
        return x

    return sampler


# Adams-Bashforth coefficients for history depths 1..4 (newest first)
_AB = np.zeros((4, 4), np.float32)
_AB[0, 0] = 1.0
_AB[1, :2] = [3 / 2, -1 / 2]
_AB[2, :3] = [23 / 12, -16 / 12, 5 / 12]
_AB[3, :4] = [55 / 24, -59 / 24, 37 / 24, -9 / 24]


def plms_sampler(
    model_fn: Callable,
    ns: NoiseScheduleVP,
    *,
    steps: int = 50,
) -> Callable:
    """PLMS / pseudo-linear-multistep (ref stable-diffusion ldm/models/
    diffusion/plms.py:11-236): sampler(x) -> x0, no draws.

    Adams-Bashforth extrapolation of eps over the DDIM update: the first step
    spends one extra NFE on a midpoint-style correction (so `steps` + 1 NFE
    in all), later steps use a 3-deep eps history with the 2nd/3rd/4th-order
    coefficients at depth min(step, 3)."""
    n_train = ns.total_N
    seq = np.unique(np.linspace(0, n_train - 1, steps + 1)[1:].astype(np.int64))
    abar = _abar(ns)
    at_seq = abar[seq][::-1].copy()
    at_next_seq = np.concatenate([[1.0], abar[seq]])[:-1][::-1].copy()
    t_seq = seq[::-1].astype(np.float64).copy()
    # next-LOWER grid time for each reversed step (last pairs with 0)
    t_next_seq = np.concatenate([[0], seq])[:-1][::-1].astype(np.float64).copy()

    def ddim_step(x, e, at, at_next):
        x0 = (x - e * torch.sqrt(1.0 - at)) / torch.sqrt(at)
        return torch.sqrt(at_next) * x0 + torch.sqrt(1.0 - at_next) * e

    def sampler(x, noise=None, generator=None):
        zeros = torch.zeros_like(x)
        hist = [zeros, zeros, zeros]
        ab = torch.as_tensor(_AB, device=x.device)
        rows = _rows(x, t_seq, at_seq, at_next_seq, t_next_seq)
        for count, (t, at, at_next, t_next) in enumerate(zip(*(r.unbind(0) for r in rows))):
            e_t = model_fn(x, _labels(x, t))
            if count == 0:
                # midpoint correction: evaluate at the DDIM-predicted x_prev
                e_next = model_fn(ddim_step(x, e_t, at, at_next), _labels(x, t_next))
                e_prime = (e_t + e_next) / 2.0
            else:
                c = ab[min(count, 3)]
                e_prime = c[0] * e_t + c[1] * hist[0] + c[2] * hist[1] + c[3] * hist[2]
            x = ddim_step(x, e_prime, at, at_next)
            hist = [e_t, hist[0], hist[1]]
        return x

    return sampler


def slerp(z1, z2, alpha):
    """Spherical interpolation between noise latents (ref
    runners/diffusion.py:487-492: sample_interpolation's slerp). `alpha`
    may be a scalar or a vector (one output per alpha)."""
    z1, z2 = torch.as_tensor(z1), torch.as_tensor(z2)
    theta = torch.arccos(torch.clamp(
        torch.sum(z1 * z2) / (torch.linalg.vector_norm(z1) * torch.linalg.vector_norm(z2)),
        -1.0, 1.0))
    alpha = torch.as_tensor(alpha, dtype=z1.dtype, device=z1.device)
    a = alpha.reshape(alpha.shape + (1,) * z1.dim())
    out = (torch.sin((1.0 - a) * theta) / torch.sin(theta) * z1[None]
           + torch.sin(a * theta) / torch.sin(theta) * z2[None])
    return out if alpha.dim() else out[0]


def interpolation_grid(shape, n: int = 11, *, noise: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None, device=None):
    """Two noise draws slerp'd at n evenly spaced alphas (the runner's
    arange(0, 1.01, 0.1) grid) -> (n, *shape) batch of x_T. Draws: 2, from
    `noise` (2, *shape) or `generator` (on `device`, else the generator's)."""
    if noise is None:
        if generator is None:
            raise ValueError(f"pass noise= of shape {(2, *shape)} or a torch.Generator")
        noise = torch.randn((2, *shape), generator=generator,
                            device=device or generator.device)
    elif tuple(noise.shape) != (2, *shape):
        raise ValueError(f"noise must be {(2, *shape)}; got {tuple(noise.shape)}")
    return slerp(noise[0], noise[1], time_grid(0.0, 1.0, n, device=noise.device))
