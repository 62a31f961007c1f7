"""Score-matching training losses (the score_sde layer).

Counterpart of `dpm_solver_tpu/training/losses.py` (score_sde_jax
losses.py:65-178):
  * `sde_loss_fn`: continuous denoising score matching for any SDE family,
    with the paper's sigma^2 weighting or likelihood weighting
    (arXiv:2101.09258) and mean or sum reduction;
  * `smld_loss_fn` / `ddpm_loss_fn`: the discrete legacy objectives
    (descending-sigma NCSN and eps-MSE DDPM);
  * `make_score_train_step`: gradient, optimiser and in-step EMA on the
    port's `TrainState`; `make_eval_loss_step`: the loss on the EMA.

A loss is `loss(x0, rng, *, sharding=None, **draws)`: `rng` is the step's
`StepRng`, whose generator gives the draws the keyword arguments do not (t
and z; labels and noise), and whose dropout seed runs the model call when the
loss was built with `score_rng` / `model_rng` (the model in train mode). With
a `sharding` (the data-parallel step, `make_score_train_step(mesh=)`), x0 and
the draws are the global batch's and the loss is the mean over this rank's
rows of them.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import numpy as np
import torch

from dpm_solver_tpu_torch.sde import VESDE, VPSDE, batch_mul
from dpm_solver_tpu_torch.training.train import (StepRng, TrainState, apply_gradients,
                                                 data_parallel, rank_rows)


def _reduce(values: torch.Tensor, reduce_mean: bool) -> torch.Tensor:
    flat = values.reshape(values.shape[0], -1)
    return flat.mean(-1) if reduce_mean else 0.5 * flat.sum(-1)


def _call(rng: StepRng, live: bool, device, fn, *args):
    with rng.dropout(device) if live else contextlib.nullcontext():
        return fn(*args)


def sde_loss_fn(sde, score_fn: Callable, *, reduce_mean: bool = True,
                likelihood_weighting: bool = False, eps: float = 1e-5,
                score_rng: bool = False) -> Callable:
    """loss(x0, rng, *, t=None, z=None) -> scalar; `score_fn(x, t)`, run
    under the step's dropout seed when `score_rng`."""

    def loss(x0: torch.Tensor, rng: StepRng, *, t: Optional[torch.Tensor] = None,
             z: Optional[torch.Tensor] = None, sharding=None) -> torch.Tensor:
        gen = rng.generator(x0.device)
        if t is None:
            t = torch.rand(x0.shape[0], generator=gen, device=x0.device) * (sde.T - eps) + eps
        if z is None:
            z = torch.randn(x0.shape, generator=gen, device=x0.device, dtype=x0.dtype)
        x0, t, z = rank_rows(sharding, x0, t, z)
        mean, std = sde.marginal_prob(x0, t)
        x_t = mean + batch_mul(std, z)
        score = _call(rng, score_rng, x0.device, score_fn, x_t, t)
        if likelihood_weighting:
            g2 = sde.sde(torch.zeros_like(x0), t)[1] ** 2
            losses = _reduce(torch.square(score + batch_mul(1.0 / std, z)), reduce_mean) * g2
        else:
            losses = _reduce(torch.square(batch_mul(std, score) + z), reduce_mean)
        return torch.mean(losses)

    return loss


def smld_loss_fn(vesde: VESDE, model_fn: Callable, *, reduce_mean: bool = False,
                 model_rng: bool = False) -> Callable:
    """The legacy NCSN objective on descending sigmas (ref losses.py:124-150).
    loss(x0, rng, *, labels=None, z=None); `model_fn(x, labels)` takes
    discrete labels (int64)."""
    if not isinstance(vesde, VESDE):
        raise TypeError("smld_loss_fn takes a VESDE")
    sigmas_desc = np.asarray(vesde._sigmas())[::-1].copy()

    def loss(x0: torch.Tensor, rng: StepRng, *, labels: Optional[torch.Tensor] = None,
             z: Optional[torch.Tensor] = None, sharding=None) -> torch.Tensor:
        gen = rng.generator(x0.device)
        if labels is None:
            labels = torch.randint(0, vesde.N, (x0.shape[0],), generator=gen, device=x0.device)
        if z is None:
            z = torch.randn(x0.shape, generator=gen, device=x0.device, dtype=x0.dtype)
        x0, labels, z = rank_rows(sharding, x0, labels.to(x0.device), z)
        sigmas = torch.as_tensor(sigmas_desc, dtype=x0.dtype, device=x0.device)[labels]
        noise = batch_mul(sigmas, z)
        score = _call(rng, model_rng, x0.device, model_fn, x0 + noise, labels)
        target = -batch_mul(1.0 / sigmas ** 2, noise)
        return torch.mean(_reduce(torch.square(score - target), reduce_mean) * sigmas ** 2)

    return loss


def ddpm_loss_fn(vpsde: VPSDE, model_fn: Callable, *, reduce_mean: bool = True,
                 model_rng: bool = False) -> Callable:
    """The legacy DDPM eps-MSE on the discrete beta table (ref
    losses.py:152-178). loss(x0, rng, *, labels=None, z=None)."""
    if not isinstance(vpsde, VPSDE):
        raise TypeError("ddpm_loss_fn takes a VPSDE")
    ab = np.cumprod(1.0 - np.asarray(vpsde._betas()))
    sqrt_ab, sqrt_1mab = np.sqrt(ab), np.sqrt(1.0 - ab)

    def loss(x0: torch.Tensor, rng: StepRng, *, labels: Optional[torch.Tensor] = None,
             z: Optional[torch.Tensor] = None, sharding=None) -> torch.Tensor:
        gen = rng.generator(x0.device)
        if labels is None:
            labels = torch.randint(0, vpsde.N, (x0.shape[0],), generator=gen, device=x0.device)
        if z is None:
            z = torch.randn(x0.shape, generator=gen, device=x0.device, dtype=x0.dtype)
        x0, labels, z = rank_rows(sharding, x0, labels.to(x0.device), z)
        table = lambda v: torch.as_tensor(v, dtype=x0.dtype, device=x0.device)[labels]
        x_t = batch_mul(table(sqrt_ab), x0) + batch_mul(table(sqrt_1mab), z)
        out = _call(rng, model_rng, x0.device, model_fn, x_t, labels)
        return torch.mean(_reduce(torch.square(out - z), reduce_mean))

    return loss


def make_score_train_step(loss_fn: Callable, tx, *, mesh=None) -> Callable:
    """step(state, x0, seed, **draws) -> (state, metrics): the loss at the
    step's `StepRng(seed, state.step)`, its gradient, the optimiser and the
    EMA (`train.apply_gradients`). With a `mesh`, data-parallel over its data
    axis as `train.make_train_step`'s: x0 and the draws global."""
    sharding, group = data_parallel(mesh)

    def step(state: TrainState, x0: torch.Tensor, seed: int, **draws):
        if sharding is not None:
            draws["sharding"] = sharding
        loss = loss_fn(x0, StepRng(seed, state.step), **draws)
        return state, apply_gradients(state, tx, loss, group)

    step.mesh = mesh
    return step


@contextlib.contextmanager
def ema_swapped(state: TrainState):
    """The EMA in the module's parameters for the block (their storage
    swapped, no copy), the trained values back after it."""

    def swap():
        for k, p in state.params.items():
            e = state.ema_params[k]
            p.data, e.data = e.data, p.data

    swap()
    try:
        yield
    finally:
        swap()


def make_eval_loss_step(loss_fn: Callable) -> Callable:
    """eval_step(state, x0, seed, **draws) -> the loss on the EMA parameters
    (ref run_lib eval), with no gradient."""

    def step(state: TrainState, x0: torch.Tensor, seed: int, **draws):
        with torch.no_grad(), ema_swapped(state):
            return loss_fn(x0, StepRng(seed, state.step), **draws)

    return step
