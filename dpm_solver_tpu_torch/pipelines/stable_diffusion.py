"""Stable Diffusion sampling pipeline: latent DPM-Solver++ with CFG, then the VAE.

Port of `dpm_solver_tpu/pipelines/stable_diffusion.py`:
  * `make_ldm_betas`: LDM's sqrt-space linear beta schedule;
  * `LatentDiffusion`: the minimal model bundle the sampler needs
    (`apply_model`, first-stage encode/decode, text conditioning);
  * `DPMSolverSampler`: the reference adapter's sampling (sampler.py:8-89):
    CFG multistep DPM-Solver++ over latents;
  * `StableDiffusionPipeline.txt2img` (scripts/txt2img.py:97-345: CFG at
    scale 7.5, [0, 1] NHWC images).

The initial noise comes from an explicit `torch.Generator` or an `x_T`
tensor. `img2img`, `inpaint`, `upscale`, the sampler's encode and time
converters, `load_sd_checkpoint`, `class_conditional_sample`, concat and
class-label conditioning, VQ first stages and `mesh=` are not ported yet.
CFG folds the conditional and unconditional halves into one doubled UNet
batch (`model_wrapper`). On the card the sampler's trajectory replays as one
CUDA graph (`jit=True`, `DPM_Solver.sample`), captured once per latent,
conditioning and guidance signature: the CFG closure reads the
conditioning from tensors the sampler keeps, into which each call copies
its own, so a later call at the same shapes replays with its own prompts.
The VAE decode runs eagerly.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from dpm_solver_tpu_torch.schedule import NoiseScheduleVP
from dpm_solver_tpu_torch.solver import DPM_Solver
from dpm_solver_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from dpm_solver_tpu_torch.wrapper import model_wrapper


def _cond_tree(fn, c):
    """fn over the tensors of a conditioning (a tensor, or a dict, list or
    tuple of them; None stays None)."""
    if c is None:
        return None
    if isinstance(c, dict):
        return {k: _cond_tree(fn, v) for k, v in c.items()}
    if isinstance(c, (list, tuple)):
        return type(c)(_cond_tree(fn, v) for v in c)
    return fn(torch.as_tensor(c))


def _cond_copy(dst, src) -> None:
    """Copy conditioning `src` into the tensors of `dst`, of the same structure."""
    if isinstance(dst, dict):
        for k in dst:
            _cond_copy(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for d, v in zip(dst, src):
            _cond_copy(d, v)
    elif dst is not None:
        dst.copy_(torch.as_tensor(src))


def make_ldm_betas(n_timestep: int = 1000, linear_start: float = 0.00085,
                   linear_end: float = 0.0120) -> np.ndarray:
    """LDM's 'linear' beta schedule is sqrt-space linear
    (ldm/modules/diffusionmodules/util.py make_beta_schedule)."""
    return np.linspace(linear_start ** 0.5, linear_end ** 0.5, n_timestep,
                       dtype=np.float64) ** 2


@dataclasses.dataclass
class LatentDiffusion:
    """Minimal LDM bundle: a UNet over latents (`models.ADMUNet`) + a KL
    first stage (`models.AutoencoderKL`) + text glue.

    `text_encode(prompts) -> (B, T, context_dim)` is injected (any callable;
    its output moves to the UNet's device). `scale_factor` follows
    v1-inference.yaml (0.18215); `parameterization` is "eps" or "v" (SD-2.1).
    """

    unet: nn.Module
    vae: nn.Module
    text_encode: Optional[Callable] = None
    betas: np.ndarray = dataclasses.field(default_factory=make_ldm_betas)
    scale_factor: float = 0.18215
    parameterization: str = "eps"

    @property
    def alphas_cumprod(self) -> np.ndarray:
        return np.cumprod(1.0 - self.betas)

    @property
    def device(self) -> torch.device:
        return next(self.unet.parameters()).device

    def to(self, device) -> "LatentDiffusion":
        self.unet.to(device)
        self.vae.to(device)
        return self

    def apply_model(self, x: torch.Tensor, t: torch.Tensor, cond) -> torch.Tensor:
        """Prediction on latents; t are discrete labels in [0, N).

        DiffusionWrapper twin for cross-attention (ddpm.py:1396-1416): `cond`
        is the context tensor (the txt2img path), or a dict whose
        `c_crossattn` is a tensor or a list of tensors joined along tokens.
        """
        if isinstance(cond, dict):
            ca = cond["c_crossattn"]
            cond = torch.cat(list(ca), dim=1) if isinstance(ca, (list, tuple)) else ca
        return self.unet(x, t, None, cond)

    def get_learned_conditioning(self, prompts) -> torch.Tensor:
        if self.text_encode is None:
            raise ValueError("no text encoder attached")
        return torch.as_tensor(self.text_encode(prompts)).to(self.device)

    def encode_first_stage(self, img: torch.Tensor,
                           noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """image in [-1, 1] NHWC -> scaled latent: the posterior's mode, or its
        sample with the standard-normal `noise` when one is given."""
        posterior = self.vae.encode(img)
        z = posterior.mode() if noise is None else posterior.sample(noise)
        return self.scale_factor * z

    def decode_first_stage(self, z: torch.Tensor) -> torch.Tensor:
        return self.vae.decode(z / self.scale_factor)


class DPMSolverSampler:
    """Reference-compatible adapter (sampler.py:8-89): CFG multistep
    DPM-Solver++ over LDM latents on the time-uniform grid."""

    def __init__(self, model: LatentDiffusion):
        self.model = model
        self.noise_schedule = NoiseScheduleVP("discrete", alphas_cumprod=model.alphas_cumprod)
        # (conditioning signature, guidance scale) -> (conditioning tensors,
        # unconditional ones, the DPM_Solver whose CFG closure reads them)
        self._solvers = {}

    def _model_fn(self, conditioning, unconditional_conditioning, scale):
        model_type = {"eps": "noise", "v": "v"}[self.model.parameterization]
        return model_wrapper(
            lambda x, t, c: self.model.apply_model(x, t, c),
            self.noise_schedule,
            model_type=model_type,
            guidance_type="classifier-free",
            condition=conditioning,
            unconditional_condition=unconditional_conditioning,
            guidance_scale=scale,
        )

    def _solver(self, conditioning, unconditional_conditioning, scale) -> DPM_Solver:
        """The DPM_Solver of this conditioning's signature (shapes, dtypes,
        devices) and guidance scale, its CFG closure over tensors kept here,
        into which this call's conditioning is copied: the counterpart of
        `jit_hoisting_constants` turning closed-over arrays into arguments,
        so that the solver's CUDA graphs serve every later call at the same
        shapes, each with its own prompts."""
        sig = lambda t: (tuple(t.shape), str(t.dtype), str(t.device))
        key = repr((_cond_tree(sig, conditioning), _cond_tree(sig, unconditional_conditioning),
                    float(scale)))
        if key not in self._solvers:
            cond, uncond = (_cond_tree(torch.clone, c)
                            for c in (conditioning, unconditional_conditioning))
            self._solvers[key] = cond, uncond, DPM_Solver(
                self._model_fn(cond, uncond, scale), self.noise_schedule,
                algorithm_type="dpmsolver++")
        cond, uncond, solver = self._solvers[key]
        _cond_copy(cond, conditioning)
        _cond_copy(uncond, unconditional_conditioning)
        return solver

    def sample(self, S: int, batch_size: int, shape: Tuple[int, int, int], conditioning=None,
               *, unconditional_guidance_scale: float = 1.0, unconditional_conditioning=None,
               x_T: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
               return_intermediate: bool = True, jit: bool = True):
        """`shape` is the (H, W, C) latent shape (NHWC). The initial noise is
        `x_T`, or a standard normal draw from `generator`. Returns
        (x, intermediates) like the reference, intermediates None unless
        `return_intermediate`. `jit`: as `DPM_Solver.sample`'s (a CUDA graph
        on the card)."""
        h, w, c = shape
        dev = self.model.device
        if x_T is None:
            if generator is None:
                raise ValueError("pass x_T or a torch.Generator")
            x_T = torch.randn((batch_size, h, w, c), generator=generator,
                              device=generator.device)
        x_T = x_T.to(dev)
        solver = self._solver(conditioning, unconditional_conditioning,
                              unconditional_guidance_scale)
        out = solver.sample(x_T, steps=S, order=2, skip_type="time_uniform",
                            method="multistep", lower_order_final=True,
                            return_intermediate=return_intermediate, jit=jit)
        return out if return_intermediate else (out, None)


class StableDiffusionPipeline:
    """txt2img front end (ref scripts/txt2img.py:97-345). Latent shape =
    image / 8 for the SD VAE; CFG runs as one doubled batch.

    The models move to `device`, the card by default (raises when there is
    none).
    """

    def __init__(self, model: LatentDiffusion, device=DEFAULT_DEVICE):
        self.model = model.to(resolve_device(device))
        self.sampler = DPMSolverSampler(model)
        # spatial reduction of the first stage (8x for the SD VAE)
        self.vae_factor = 2 ** (len(model.vae.config.ch_mult) - 1)

    @torch.no_grad()
    def txt2img(self, prompts, *, negative_prompt: str = "", steps: int = 25,
                guidance_scale: float = 7.5, height: int = 512, width: int = 512,
                generator: Optional[torch.Generator] = None,
                x_T: Optional[torch.Tensor] = None, jit: bool = True) -> torch.Tensor:
        """Images (B, height, width, 3) in [0, 1], fp32. The initial latent
        noise is `x_T`, else a draw from `generator` (a CPU generator seeded
        with 0 when neither is given). `jit`: the sampler's (a CUDA graph of
        the trajectory on the card; the VAE decode runs eagerly)."""
        if isinstance(prompts, str):
            prompts = [prompts]
        b = len(prompts)
        cond = self.model.get_learned_conditioning(prompts)
        uncond = self.model.get_learned_conditioning([negative_prompt] * b)
        if x_T is None and generator is None:
            generator = torch.Generator().manual_seed(0)
        f = self.vae_factor
        latents, _ = self.sampler.sample(
            steps, b, (height // f, width // f, self.model.vae.config.z_channels), cond,
            unconditional_guidance_scale=guidance_scale, unconditional_conditioning=uncond,
            x_T=x_T, generator=generator, return_intermediate=False, jit=jit)
        img = self.model.decode_first_stage(latents)
        return ((img.float() + 1.0) / 2.0).clamp(0.0, 1.0)
