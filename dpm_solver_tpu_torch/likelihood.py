"""Exact log-likelihood (bits/dim) through the probability-flow ODE, on torch.

Port of `dpm_solver_tpu/likelihood.py` (ref examples/score_sde_jax/
likelihood.py:28-123): the Hutchinson–Skilling estimate of the drift's
divergence, integrated with the state over the augmented [x, log p] ODE by
`ode.odeint_rk45`, from eps to T; and the black-box `ode_sampler` (ref
sampling.py:459-536), which integrates the same drift from T down to eps.

The divergence. The JAX package rides one `jax.jvp` per stage. The port
takes the same estimator eps^T J eps with one vector-Jacobian product,
`torch.autograd.grad((drift * eps).sum(), x)` dotted with eps, the score_sde
reference's own form: a forward-mode rule for each hand-written kernel is
not needed, and the backward runs the kernels the guided path already uses
(the attention dq and dk/dv kernels, conv3x3's input gradient). Freeze the
network's parameters (`requires_grad_(False)`) before calling
`likelihood_fn`: a conv3x3 whose weight requires grad computes its weight
gradient in every backward, which the estimator never reads.

Random probes come from an explicit `torch.Generator`, or as a tensor
(`epsilon=`): torch and `jax.random` never give the same stream.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from dpm_solver_tpu_torch.ode import odeint_rk45
from dpm_solver_tpu_torch.sde import batch_mul, reverse_sde
from dpm_solver_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


def hutchinson_divergence(fn: Callable, x: torch.Tensor, t: torch.Tensor,
                          eps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(fn(x, t), eps^T J_fn(x) eps per batch element), from one forward and
    one vector-Jacobian product; the primal comes back detached."""
    with torch.enable_grad():
        xi = x.detach().requires_grad_(True)
        out = fn(xi, t)
        vjp, = torch.autograd.grad((out * eps).sum(), xi)
    return out.detach(), (vjp * eps).sum(dim=tuple(range(1, x.dim())))


def sample_hutchinson(shape, kind: str = "Rademacher", dtype=torch.float32,
                      device=DEFAULT_DEVICE,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """A probe of `shape`: standard normal ("Gaussian") or +-1 ("Rademacher")."""
    device = resolve_device(device)
    if kind == "Gaussian":
        return torch.randn(shape, generator=generator, dtype=dtype, device=device)
    if kind == "Rademacher":
        bits = torch.randint(0, 2, shape, generator=generator, device=device)
        return bits.to(dtype) * 2.0 - 1.0
    raise ValueError(f"Hutchinson type {kind!r} unknown")


def get_likelihood_fn(
    sde,
    score_fn: Callable,
    *,
    hutchinson_type: str = "Rademacher",
    rtol: float = 1e-5,
    atol: float = 1e-5,
    eps: float = 1e-5,
    max_steps: int = 20_000,
    inverse_scaler_grad: Optional[float] = None,
):
    """Returns `likelihood_fn(data, *, generator=None, epsilon=None) ->
    (bpd, z, nfe)`: bits/dim (B,), the latent z at T, and the function
    evaluations of the integration.

    The probe is `epsilon` if given, else drawn on data's device from
    `generator`. `inverse_scaler_grad`: d(inverse_scaler)/dx at 0, 0.5 for
    centred [-1, 1] data, 1.0 (the default) for [0, 1] data (ref
    likelihood.py:118-121: offset = log2(grad) + 8).
    """
    grad0 = 1.0 if inverse_scaler_grad is None else float(inverse_scaler_grad)
    offset = math.log2(grad0) + 8.0
    drift_fn = reverse_sde(sde, score_fn, probability_flow=True).sde

    def likelihood_fn(data: torch.Tensor, *, generator: Optional[torch.Generator] = None,
                      epsilon: Optional[torch.Tensor] = None):
        if epsilon is None:
            epsilon = sample_hutchinson(data.shape, hutchinson_type, data.dtype, data.device,
                                        generator)
        epsilon = epsilon.to(device=data.device, dtype=data.dtype)

        def aug_drift(state, t):
            x, _ = state
            vec_t = torch.full((x.shape[0],), t, dtype=x.dtype, device=x.device)
            return hutchinson_divergence(lambda xi, ti: drift_fn(xi, ti)[0], x, vec_t, epsilon)

        init = (data, data.new_zeros((data.shape[0],)))
        (z, delta_logp), nfe = odeint_rk45(aug_drift, init, eps, float(sde.T), rtol=rtol,
                                           atol=atol, max_steps=max_steps)
        n_dim = data[0].numel()
        bpd = -(sde.prior_logp(z) + delta_logp) / math.log(2.0) / n_dim + offset
        return bpd, z, nfe

    return likelihood_fn


def ode_sampler(
    sde,
    score_fn: Callable,
    shape: Tuple[int, ...],
    *,
    generator: Optional[torch.Generator] = None,
    x_init: Optional[torch.Tensor] = None,
    rtol: float = 1e-5,
    atol: float = 1e-5,
    eps: float = 1e-3,
    denoise: bool = False,
    max_steps: int = 20_000,
    device=DEFAULT_DEVICE,
) -> Tuple[torch.Tensor, int]:
    """Black-box probability-flow sampler (ref sampling.py:459-536): draw
    from the prior at T on `device` (or start from `x_init`, on its own
    device), integrate T -> eps, and optionally take one reverse-diffusion
    (Tweedie) step to t = 0. Returns (x, nfe). Runs without autograd."""
    drift_fn = reverse_sde(sde, score_fn, probability_flow=True).sde
    with torch.no_grad():
        x = sde.prior_sampling(shape, generator, device=device) if x_init is None else x_init

        def func(xi, t):
            return drift_fn(xi, torch.full((xi.shape[0],), t, dtype=xi.dtype,
                                           device=xi.device))[0]

        x, nfe = odeint_rk45(func, x, float(sde.T), eps, rtol=rtol, atol=atol,
                             max_steps=max_steps)
        if denoise:
            vec_t = torch.full((x.shape[0],), eps, dtype=x.dtype, device=x.device)
            f, g = sde.sde(x, vec_t)
            x = x - (f - batch_mul(g ** 2, score_fn(x, vec_t))) * eps
    return x, nfe
