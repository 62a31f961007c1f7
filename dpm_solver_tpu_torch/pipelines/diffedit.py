"""DiffEdit: mask-guided image editing on the latent-diffusion pipeline.

Port of `dpm_solver_tpu/pipelines/diffedit.py`, the behavioural twin of the
reference notebook (examples/stable-diffusion/scripts/diffedit_inpaint.ipynb):
  * `compute_edit_mask` (cell 4 `get_mask`): noise the source latent,
    predict eps under the source and the target prompts, binarise the
    normalised |difference| map;
  * `diffedit` (cell 6): encode the latent to `encode_ratio` (stochastically,
    or by the deterministic DPM-Solver inverse ODE), then sample back under
    the target prompt while re-imposing the unedited region after every
    solver step.

The per-step blend targets are one (steps + 1, ...) table indexed by the
step, read through a `MaskedBlend` that the sampler holds per signature, so
the edit replays from one CUDA graph (`jit=True`) with each call's table and
mask. Noise comes from explicit tensors or a `torch.Generator`.
"""

from __future__ import annotations

from typing import Optional

import torch

from dpm_solver_tpu_torch.pipelines.stable_diffusion import (DPMSolverSampler, LatentDiffusion,
                                                             MaskedBlend, _images)
from dpm_solver_tpu_torch.solver.plan import get_time_steps


@torch.no_grad()
def compute_edit_mask(model: LatentDiffusion, sampler: DPMSolverSampler,
                      init_latent: torch.Tensor, src_ctx: torch.Tensor, dst_ctx: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None, *, n_noised: int = 3,
                      encode_ratio: float = 0.5, clamp_rate: float = 3.5) -> torch.Tensor:
    """Binary (H, W) mask of the region the prompts disagree on (cell 4): 1
    marks latent pixels to EDIT. The latent is noised `n_noised` times (with
    `noise`, (n_noised, H, W, C) or (1, n_noised, H, W, C), else draws from
    `generator`); `clamp_rate` trades sparsity: the mean |eps difference|
    map is clamped at its mean * clamp_rate, scaled to [0, 1] and
    thresholded at 0.5."""
    if init_latent.shape[0] != 1:
        raise ValueError("mask estimation expects a single image latent")
    lat = init_latent.repeat(n_noised, 1, 1, 1)

    def rep(c):
        return c.repeat(n_noised, *([1] * (c.dim() - 1)))

    noised = sampler.stochastic_encode(lat, encode_ratio, noise=noise, generator=generator)
    t_label = torch.full((n_noised,), sampler.time_continuous_to_discrete(
        sampler.ratio_to_time(encode_ratio)), device=lat.device)
    pre_src = model.apply_model(noised, t_label, rep(src_ctx))
    pre_dst = model.apply_model(noised, t_label, rep(dst_ctx))
    diff = (pre_src - pre_dst).abs().mean(dim=(0, 3))  # (H, W)
    max_v = diff.mean() * clamp_rate
    mask = torch.minimum(diff.clamp(min=0.0), max_v) / max_v
    return (mask > 0.5).to(init_latent.dtype)


@torch.no_grad()
def diffedit(model: LatentDiffusion, init_image: torch.Tensor, src_prompt: str,
             dst_prompt: str, *, encode_ratio: float = 0.6, steps: int = 20,
             encode_type: str = "stochastic", guidance_scale: float = 7.5, order: int = 2,
             n_noised: int = 3, clamp_rate: float = 3.5,
             generator: Optional[torch.Generator] = None,
             mask_noise: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
             mask: Optional[torch.Tensor] = None, return_mask: bool = False,
             sampler: Optional[DPMSolverSampler] = None, jit: bool = True):
    """Edit `init_image` ([-1, 1] NHWC, batch 1) from `src_prompt` to
    `dst_prompt` (notebook cell 6). Returns images in [0, 1] (and the latent
    mask when `return_mask`).

    Noise: `mask_noise` for `compute_edit_mask` (when no `mask` is given)
    and, for the stochastic encoding, `noise` (steps + 1, *latent shape),
    the blend target of each step; what is not given is drawn from
    `generator` (a CPU generator seeded with 42 when neither is given).
    `sampler`: a DPMSolverSampler of `model` to reuse (its solvers and CUDA
    graphs); a new one by default, as in the JAX function."""
    if encode_type not in ("stochastic", "deterministic"):
        raise ValueError(f"encode_type must be stochastic or deterministic, got {encode_type!r}")
    if generator is None:
        generator = torch.Generator().manual_seed(42)
    sampler = sampler or DPMSolverSampler(model)
    uc = model.get_learned_conditioning([""])
    src = model.get_learned_conditioning([src_prompt])
    dst = model.get_learned_conditioning([dst_prompt])
    z0 = model.encode_first_stage(init_image.to(model.device))

    if mask is None:
        mask = compute_edit_mask(model, sampler, z0, src, dst, generator, mask_noise,
                                 n_noised=n_noised, encode_ratio=0.5, clamp_rate=clamp_rate)
    mask = mask.to(z0.device, z0.dtype)
    mask4 = mask[None, :, :, None]

    # the sampling grid's times (t_enc -> t_0, decreasing); a blend target a step
    ns = sampler.noise_schedule
    t_enc = sampler.ratio_to_time(encode_ratio)
    grid = get_time_steps(ns, "time_uniform", t_enc, 1.0 / ns.total_N, steps)
    if encode_type == "stochastic":
        # the notebook re-noises the original to the CURRENT step's level at
        # each correction (fresh noise a level)
        blend = sampler.blend_table(z0, grid, noise=noise, generator=generator)
        x_T = blend[0]
    else:
        z_enc, inter = sampler.encode(steps, z0, encode_ratio, conditioning=src,
                                      unconditional_guidance_scale=guidance_scale,
                                      unconditional_conditioning=uc, order=order,
                                      lower_order_final=False, return_intermediate=True, jit=jit)
        # the encode grid (t_0 -> t_enc) is the sampling grid reversed
        full = list(inter) if len(inter) == steps + 1 else [z0] + list(inter)
        if len(full) != steps + 1:
            raise RuntimeError(f"the inverse gave {len(full)} states for {steps} steps")
        blend = torch.stack(full[::-1])
        x_T = z_enc

    latents, _ = sampler.sample(
        steps, x_T.shape[0], tuple(x_T.shape[1:]), dst,
        unconditional_guidance_scale=guidance_scale, unconditional_conditioning=uc, x_T=x_T,
        t_start=t_enc, order=order, lower_order_final=False,
        correcting_xt_fn=MaskedBlend(blend, mask4), return_intermediate=False, jit=jit)
    img = _images(model.decode_first_stage(latents))
    return (img, mask) if return_mask else img
