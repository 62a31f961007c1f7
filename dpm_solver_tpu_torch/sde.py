"""SDE library: VP / sub-VP / VE forward SDEs and their reverse processes, on torch.

Port of `dpm_solver_tpu/sde.py` (ref score_sde sde_lib.py:9-256). The SDEs
are frozen dataclasses; every method takes torch tensors and computes in
their dtype and on their device. `prior_sampling` draws from an explicit
`torch.Generator`, since torch and `jax.random` never give the same stream,
on `device`, else on the generator's device, else on the card (raising when
there is none, as the model constructors do).
The reverse process is a function factory returning pure (drift, diffusion)
and discretize closures, as in the JAX package.

`VPSDE.to_noise_schedule` bridges the VP SDE to the solver layer's
`NoiseScheduleVP`, so DPM-Solver runs on score_sde networks directly (the
reference wires it the same way at score_sde_jax/sampling.py:562).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from dpm_solver_tpu_torch.schedule import NoiseScheduleVP
from dpm_solver_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from dpm_solver_tpu_torch.utils.trees import bcast_right


def batch_mul(a, b):
    """Multiply per-batch scalars against batched tensors."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return bcast_right(a, max(a.dim(), b.dim())) * b


def _prior_logp(z: torch.Tensor, var: float) -> torch.Tensor:
    n = math.prod(z.shape[1:])
    return -n / 2.0 * math.log(2 * math.pi * var) - torch.sum(
        z.reshape(z.shape[0], -1) ** 2, -1) / (2.0 * var)


def _normal(shape, generator: Optional[torch.Generator], dtype, device) -> torch.Tensor:
    if device is None:
        device = generator.device if generator is not None else DEFAULT_DEVICE
    return torch.randn(shape, generator=generator, dtype=dtype, device=resolve_device(device))


def _grid_index(t: torch.Tensor, n: int, big_t: float) -> torch.Tensor:
    return (t * (n - 1) / big_t).to(torch.int64)


@dataclasses.dataclass(frozen=True)
class VPSDE:
    """dx = -1/2 beta(t) x dt + sqrt(beta(t)) dw (DDPM continuous limit)."""

    beta_0: float = 0.1
    beta_1: float = 20.0
    N: int = 1000

    @property
    def T(self):
        return 1.0

    def _betas(self):
        return np.linspace(self.beta_0 / self.N, self.beta_1 / self.N, self.N)

    def sde(self, x, t):
        beta_t = self.beta_0 + t * (self.beta_1 - self.beta_0)
        return batch_mul(-0.5 * beta_t, x), torch.sqrt(beta_t)

    def marginal_prob(self, x, t):
        log_mean = -0.25 * t**2 * (self.beta_1 - self.beta_0) - 0.5 * t * self.beta_0
        return batch_mul(torch.exp(log_mean), x), torch.sqrt(-torch.expm1(2.0 * log_mean))

    def prior_sampling(self, shape, generator=None, dtype=torch.float32, device=None):
        return _normal(shape, generator, dtype, device)

    def prior_logp(self, z):
        return _prior_logp(z, 1.0)

    def discretize(self, x, t):
        """DDPM ancestral discretization: f, G at the grid point nearest t."""
        betas = torch.as_tensor(self._betas(), dtype=x.dtype, device=x.device)
        beta = betas[_grid_index(t, self.N, self.T)]
        return batch_mul(torch.sqrt(1.0 - beta), x) - x, torch.sqrt(beta)

    def to_noise_schedule(self) -> NoiseScheduleVP:
        return NoiseScheduleVP.linear(self.beta_0, self.beta_1)


@dataclasses.dataclass(frozen=True)
class SubVPSDE:
    """Sub-VP SDE (better likelihoods; score_sde eq. 29)."""

    beta_0: float = 0.1
    beta_1: float = 20.0
    N: int = 1000

    @property
    def T(self):
        return 1.0

    def sde(self, x, t):
        beta_t = self.beta_0 + t * (self.beta_1 - self.beta_0)
        discount = -torch.expm1(-2.0 * self.beta_0 * t - (self.beta_1 - self.beta_0) * t**2)
        return batch_mul(-0.5 * beta_t, x), torch.sqrt(beta_t * discount)

    def marginal_prob(self, x, t):
        log_mean = -0.25 * t**2 * (self.beta_1 - self.beta_0) - 0.5 * t * self.beta_0
        return batch_mul(torch.exp(log_mean), x), -torch.expm1(2.0 * log_mean)

    def prior_sampling(self, shape, generator=None, dtype=torch.float32, device=None):
        return _normal(shape, generator, dtype, device)

    def prior_logp(self, z):
        return _prior_logp(z, 1.0)

    def discretize(self, x, t):
        dt = 1.0 / self.N
        drift, diffusion = self.sde(x, t)
        return drift * dt, diffusion * math.sqrt(dt)


@dataclasses.dataclass(frozen=True)
class VESDE:
    """Variance-exploding SDE (SMLD/NCSN)."""

    sigma_min: float = 0.01
    sigma_max: float = 50.0
    N: int = 1000

    @property
    def T(self):
        return 1.0

    def _sigmas(self):
        return np.exp(np.linspace(math.log(self.sigma_min), math.log(self.sigma_max), self.N))

    def sigma(self, t):
        return self.sigma_min * (self.sigma_max / self.sigma_min) ** t

    def sde(self, x, t):
        diffusion = self.sigma(t) * math.sqrt(
            2.0 * (math.log(self.sigma_max) - math.log(self.sigma_min)))
        return torch.zeros_like(x), diffusion

    def marginal_prob(self, x, t):
        return x, self.sigma(t)

    def prior_sampling(self, shape, generator=None, dtype=torch.float32, device=None):
        return _normal(shape, generator, dtype, device) * self.sigma_max

    def prior_logp(self, z):
        return _prior_logp(z, self.sigma_max**2)

    def discretize(self, x, t):
        """SMLD ancestral discretization."""
        sigmas = torch.as_tensor(self._sigmas(), dtype=x.dtype, device=x.device)
        idx = _grid_index(t, self.N, self.T)
        sigma = sigmas[idx]
        adjacent = torch.where(idx == 0, torch.zeros_like(sigma), sigmas[(idx - 1).clamp(min=0)])
        return torch.zeros_like(x), torch.sqrt(sigma**2 - adjacent**2)


class ReverseSDE(NamedTuple):
    """Pure-function reverse-time SDE/ODE."""

    T: float
    N: int
    sde: Callable          # (x, t) -> (drift, diffusion)
    discretize: Callable   # (x, t) -> (f, G)
    probability_flow: bool


def reverse_sde(fwd, score_fn: Callable, probability_flow: bool = False) -> ReverseSDE:
    """Reverse process of `fwd` under `score_fn` (ref sde_lib.py:72-110)."""
    scale = 0.5 if probability_flow else 1.0

    def rev(x, t):
        drift, diffusion = fwd.sde(x, t)
        drift = drift - batch_mul(diffusion**2, score_fn(x, t) * scale)
        return drift, torch.zeros_like(diffusion) if probability_flow else diffusion

    def rev_discretize(x, t):
        f, g = fwd.discretize(x, t)
        rev_f = f - batch_mul(g**2, score_fn(x, t) * scale)
        return rev_f, torch.zeros_like(g) if probability_flow else g

    return ReverseSDE(T=fwd.T, N=fwd.N, sde=rev, discretize=rev_discretize,
                      probability_flow=probability_flow)
