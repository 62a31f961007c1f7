"""Latent-diffusion training: the p_losses objective over a frozen first stage.

Counterpart of `dpm_solver_tpu/training/latent.py` (the reference LDM's
ldm/models/diffusion/ddpm.py):
  * q_sample and the eps / x0 target MSE (`DDPM.p_losses`, ddpm.py:294-320),
    and the v target of the SD-2.x lineage;
  * the frozen VAE encode with the LDM scale factor
    (`LatentDiffusion.encode_first_stage`, ddpm.py:706); only the UNet trains;
  * per-sample mean square over the latent dims, meaned over the batch
    (`loss_simple` with the default zero logvar, ddpm.py:330-345);
  * classifier-free-guidance training: each sample's context replaced by
    `uncond_context` with probability `cond_dropout`.

The step updates the UNet's parameters in place (`train.TrainState`); the
first stage is a frozen module the encode function closes over.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from dpm_solver_tpu_torch.training.train import (StepRng, TrainState, apply_gradients,
                                                 data_parallel, rank_rows)

# the streams of one step's explicit draws (train.StepRng)
_T_EPS, _ENCODE, _COND = 0, 2, 3


def make_latent_train_step(unet_apply: Callable, tx, betas, *,
                           encode_fn: Optional[Callable] = None, parameterization: str = "eps",
                           cond_dropout: float = 0.0,
                           uncond_context: Optional[torch.Tensor] = None, mesh=None) -> Callable:
    """step(state, images, context, seed, *, t=None, eps=None, drop=None)
    -> (state, metrics).

    unet_apply(z_t, t_float, context) -> prediction (t a discrete label
    0..N-1 as float, as `LatentDiffusion.apply_model` passes it).
    encode_fn(images, generator) -> scaled latents z0, with no gradient;
    None: the batch holds latents already. parameterization: eps | x0 | v
    (v = sqrt(ab) eps - sqrt(1 - ab) x0). t (B,) int, eps (z0's shape) and
    drop (B,) bool (the samples whose context is replaced) replace the
    step's own draws. With a `mesh`, data-parallel over its data axis as
    `train.make_train_step`'s: the batch and the draws are global and each
    rank trains on its rows; the frozen encode runs on the global batch on
    every rank, so that its posterior draw is the single-process one."""
    if parameterization not in ("eps", "x0", "v"):
        raise ValueError(f"unknown parameterization {parameterization!r}")
    if cond_dropout and uncond_context is None:
        raise ValueError("cond_dropout needs an uncond_context")
    alphas_cumprod = np.cumprod(1.0 - np.asarray(betas, np.float64))
    n_t = len(alphas_cumprod)
    sqrt_ab = torch.as_tensor(np.sqrt(alphas_cumprod), dtype=torch.float32)
    sqrt_1mab = torch.as_tensor(np.sqrt(1.0 - alphas_cumprod), dtype=torch.float32)

    sharding, group = data_parallel(mesh)

    def step(state: TrainState, images: torch.Tensor, context: Optional[torch.Tensor],
             seed: int, *, t: Optional[torch.Tensor] = None,
             eps: Optional[torch.Tensor] = None, drop: Optional[torch.Tensor] = None):
        rng = StepRng(seed, state.step)
        dev = images.device
        if encode_fn is None:
            z0 = images
        else:
            with torch.no_grad():
                z0 = encode_fn(images, rng.generator(dev, _ENCODE))
        b = z0.shape[0]
        gen = rng.generator(dev, _T_EPS)
        if t is None:
            t = torch.randint(0, n_t, (b,), generator=gen, device=dev)
        if eps is None:
            eps = torch.randn(z0.shape, generator=gen, device=dev, dtype=z0.dtype)
        t = t.to(dev)
        if cond_dropout:
            if drop is None:
                drop = torch.rand(b, generator=rng.generator(dev, _COND), device=dev) < cond_dropout
            uc = torch.as_tensor(uncond_context, dtype=context.dtype, device=dev)
            context = torch.where(drop.to(dev)[:, None, None], uc.expand(context.shape), context)
        if context is not None:
            z0, t, eps, context = rank_rows(sharding, z0, t, eps, context)
        else:
            z0, t, eps = rank_rows(sharding, z0, t, eps)
        a = sqrt_ab.to(dev)[t][:, None, None, None]
        s = sqrt_1mab.to(dev)[t][:, None, None, None]
        out = unet_apply(a * z0 + s * eps, t.float(), context)
        target = eps if parameterization == "eps" else z0 if parameterization == "x0" \
            else a * eps - s * z0
        loss = torch.mean(torch.square(out - target), dim=(1, 2, 3)).mean()
        return state, apply_gradients(state, tx, loss, group)

    step.mesh = mesh
    return step


def vae_encode_fn(vae, *, scale_factor: float = 0.18215, sample: bool = True) -> Callable:
    """(images, generator) -> scaled latents, for `make_latent_train_step`:
    `LatentDiffusion.encode_first_stage` + `get_first_stage_encoding`
    (ddpm.py:706, 830-841): the posterior's sample (not its mode) while
    training, times scale_factor, with no gradient."""

    def encode(images: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        with torch.no_grad():
            posterior = vae.encode(images)
            if not sample:
                return scale_factor * posterior.mode().float()
            noise = torch.randn(posterior.mean.shape, generator=generator,
                                device=posterior.mean.device, dtype=posterior.mean.dtype)
            return scale_factor * posterior.sample(noise).float()

    return encode
