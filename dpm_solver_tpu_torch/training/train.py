"""Training loop building blocks: the DDPM eps-MSE loss, optimiser state, EMA.

Counterpart of `dpm_solver_tpu/training/train.py`:
  * eps-prediction MSE with antithetic time sampling
    (ddpm_and_guided-diffusion/functions/losses.py:4-20 +
     runners/diffusion.py:208-213);
  * in-step EMA of the parameters (models/ema.py:4-49);
  * the optimiser: Adam after a linear warmup from 0, with global-norm
    clipping (score_sde_jax/losses.py:28-62), with optax's semantics
    (`training/optim.py`).

Where the JAX step is a pure function of (params, batch, rng), the port's
step updates the model's parameters, the optimiser state and the EMA in
place: `TrainState.params` holds the module's own parameter tensors. The
randomness is explicit: a step draws from `StepRng(seed, state.step)`, the
run's seed folded with the step as the JAX step folds its key, so a resumed
run repeats the draws of an uninterrupted one. Each step function also takes
its draws as tensors (t, eps, ...), which the CPU tests use to feed it the
JAX step's own draws (`jax.random` and torch never give the same stream).

Dropout runs on the default generators, seeded from the step's seed for the
model call (`StepRng.dropout`): `torch.utils.checkpoint` (remat) saves and
restores exactly those generators, so a block's mask is drawn again on
recompute.

Data parallelism (`mesh=`, a DeviceMesh from `parallel.make_mesh`): the step
takes the global batch on every rank, draws t and eps for the global batch
(the single-process draws), runs the rank's rows, and averages the gradients
over the mesh's data axis with a bucketed all-reduce before the optimiser
(`apply_gradients(group=)`), so the global-norm clip sees the global
gradient, as under XLA. `torch.autograd.grad` never reaches
DistributedDataParallel's hooks, so the all-reduce is explicit. Dropout masks
are drawn per rank (GSPMD draws them for the global batch).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from dpm_solver_tpu_torch.training.optim import Adam, linear_schedule, trainable

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class StepRng:
    """The randomness of one step: the run's seed folded with the step.
    `generator(device, stream)` seeds a fresh torch.Generator on the device
    for the step's explicit draws; `dropout(device)` seeds the default
    generators for the model call. Streams keep the draws of one step apart."""

    seed: int
    step: int

    def key(self, stream: int) -> int:
        ss = np.random.SeedSequence([self.seed % 2 ** 63, self.step, stream])
        return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))

    def generator(self, device, stream: int = 0) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(self.key(stream))

    @contextlib.contextmanager
    def dropout(self, device) -> Iterator[None]:
        """Seed the default generators (those dropout draws from) for the
        model call, and restore them after it."""
        device = torch.device(device)
        devices = [device.index or 0] if device.type == "cuda" else []
        with torch.random.fork_rng(devices=devices):
            torch.manual_seed(self.key(1))
            yield


@dataclasses.dataclass
class TrainState:
    """step (an int on the host), params (name -> the module's own parameter
    tensor, updated in place), opt_state (the optimiser's, `optim.py`),
    ema_params (name -> fp32 copies), ema_rate."""

    step: int
    params: Params
    opt_state: dict
    ema_params: Params
    ema_rate: float = 0.9999


def make_optimizer(lr: float = 2e-4, warmup: int = 5000, grad_clip: float = 1.0) -> Adam:
    """Adam after a linear warmup from 0 (lr 0 at the first update), with
    global-norm clipping: optax.chain(clip_by_global_norm, adam(schedule))."""
    return Adam(linear_schedule(0.0, lr, warmup) if warmup else lr, grad_clip)


def make_train_state(params: Union[nn.Module, Mapping[str, torch.Tensor]], *, lr: float = 2e-4,
                     warmup: int = 5000, grad_clip: float = 1.0, ema_rate: float = 0.9999,
                     tx=None) -> Tuple[TrainState, Any]:
    """A fresh state at step 0 over `params` (a module: its trainable
    parameters, which the state then updates in place); the EMA starts as a
    copy of them."""
    tx = make_optimizer(lr, warmup, grad_clip) if tx is None else tx
    params = trainable(params)
    with torch.no_grad():
        ema = {k: p.detach().clone() for k, p in params.items()}
    return TrainState(step=0, params=params, opt_state=tx.init(params), ema_params=ema,
                      ema_rate=ema_rate), tx


@torch.no_grad()
def ema_update(ema: Params, new: Params, rate: float) -> None:
    """ema <- ema * rate + new * (1 - rate), in place."""
    e = list(ema.values())
    torch._foreach_mul_(e, rate)
    torch._foreach_add_(e, [new[k] for k in ema], alpha=1.0 - rate)


def apply_gradients(state: TrainState, tx, loss: torch.Tensor, group=None
                    ) -> Dict[str, torch.Tensor]:
    """Differentiate `loss` with respect to the state's parameters, update
    them with `tx`, then the EMA, and advance the step. The metrics: the
    loss and the gradients' global norm (before clipping), 0-d tensors.
    With a process `group` (the data axis), `loss` is the rank's share of the
    batch mean: the gradients and the reported loss are averaged over the
    group first."""
    names = list(state.params)
    grads = torch.autograd.grad(loss, [state.params[k] for k in names])
    if group is not None:
        from dpm_solver_tpu_torch.parallel.mesh import all_reduce_mean_

        loss = loss.detach().clone()
        all_reduce_mean_(list(grads) + [loss], group)
    norm = tx.step(state.params, dict(zip(names, grads)), state.opt_state)
    ema_update(state.ema_params, state.params, state.ema_rate)
    state.step += 1
    return {"loss": loss.detach(), "grad_norm": norm}


def antithetic_times(generator: torch.Generator, batch: int, num_timesteps: int) -> torch.Tensor:
    """t ~ U{0..T-1} with antithetic pairing t, T-1-t (the reference
    runner's variance reduction)."""
    t_half = torch.randint(0, num_timesteps, ((batch + 1) // 2,), generator=generator,
                           device=generator.device)
    return torch.cat([t_half, num_timesteps - 1 - t_half])[:batch]


def data_parallel(mesh, axis: str = "data"):
    """(batch sharding, process group) of the data axis of `mesh`, or
    (None, None) without a mesh."""
    if mesh is None:
        return None, None
    from dpm_solver_tpu_torch.parallel.mesh import axis_group, batch_sharding

    return batch_sharding(mesh, axis), axis_group(mesh, axis)


def rank_rows(sharding, *tensors):
    """Each tensor's rows of this rank under `sharding` (unchanged without one)."""
    if sharding is None:
        return tensors
    return tuple(sharding.local(t) for t in tensors)


def make_train_step(apply_fn: Callable, ns, tx, *, num_timesteps: int = 1000,
                    loss_type: str = "simple", dropout_rng: bool = False,
                    mesh=None) -> Callable:
    """step(state, x0, seed, *, t=None, eps=None) -> (state, metrics).

    `apply_fn(x, t_discrete_float)` is the eps-prediction net (a DDPMUNet
    with discrete labels 0..N-1); loss = E[sum_px (eps - eps_hat)^2], the
    reference's. `dropout_rng=True` runs it under the step's dropout seed
    (the net in train mode keeps its dropout live, as the reference trains).
    t (B,) int and eps (x0's shape) replace the step's own draws. With a
    `mesh` the step is data-parallel over its data axis (module docstring):
    x0, t and eps are global, each rank runs its rows."""
    if loss_type != "simple":
        raise ValueError(f"unknown loss_type {loss_type!r}")
    # alpha-bar table for discrete t, fp32 as in the JAX step
    t_grid = (torch.arange(num_timesteps, dtype=torch.float32) + 1.0) / num_timesteps
    log_alpha = ns.marginal_log_mean_coeff(t_grid).float()
    tables = {}

    def table(device):
        if device not in tables:
            tables[device] = (torch.exp(log_alpha).to(device),
                              torch.sqrt(-torch.expm1(2.0 * log_alpha)).to(device))
        return tables[device]

    sharding, group = data_parallel(mesh)

    def step(state: TrainState, x0: torch.Tensor, seed: int, *,
             t: Optional[torch.Tensor] = None, eps: Optional[torch.Tensor] = None):
        rng = StepRng(seed, state.step)
        gen = rng.generator(x0.device)
        if t is None:
            t = antithetic_times(gen, x0.shape[0], num_timesteps)
        if eps is None:
            eps = torch.randn(x0.shape, generator=gen, device=x0.device, dtype=x0.dtype)
        x0, t, eps = rank_rows(sharding, x0, t.to(x0.device), eps)
        sqrt_ab, sqrt_1mab = table(x0.device)
        xt = x0 * sqrt_ab[t][:, None, None, None] + eps * sqrt_1mab[t][:, None, None, None]
        with rng.dropout(x0.device) if dropout_rng else contextlib.nullcontext():
            out = apply_fn(xt, t.float())
        loss = torch.mean(torch.sum(torch.square(eps - out), dim=(1, 2, 3)))
        return state, apply_gradients(state, tx, loss, group)

    step.mesh = mesh
    return step


def make_multi_step(step_fn: Callable, n_steps: int) -> Callable:
    """multi_step(state, batches, seed) -> (state, metrics): `n_steps` steps
    over the leading [n_steps] axis of `batches`, a host loop (the JAX
    package's lax.scan, the reference's n_jitted_steps); metrics stacked."""

    def multi_step(state, batches, seed):
        if len(batches) != n_steps:
            raise ValueError(f"multi_step takes {n_steps} batches, got {len(batches)}")
        out = []
        for batch in batches:
            state, metrics = step_fn(state, batch, seed)
            out.append(metrics)
        return state, {k: torch.stack([m[k] for m in out]) for k in out[0]}

    return multi_step
