"""Latent-diffusion sampling pipelines: latent DPM-Solver++ with CFG, the first stage.

Port of `dpm_solver_tpu/pipelines/stable_diffusion.py`:
  * `make_ldm_betas`: LDM's sqrt-space linear beta schedule;
  * `LatentDiffusion`: the minimal model bundle the sampler needs
    (`apply_model` with cross-attention, concat, hybrid and class (adm)
    conditioning; first-stage encode/decode through a KL or a VQ first
    stage; text conditioning);
  * `DPMSolverSampler`: the reference adapter (sampler.py:8-162): CFG
    DPM-Solver++ over latents with every solver option, `encode` (the
    deterministic inverse ODE), `stochastic_encode` (q(x_t | x_0)) and the
    time/ratio converters;
  * `StableDiffusionPipeline`: txt2img (scripts/txt2img.py:97-345), img2img,
    text-guided inpainting by masked latent resampling, and concat-
    conditioned upscaling;
  * `load_sd_checkpoint` (a CompVis checkpoint, through the presets sd_v1,
    sd_v2_1, cin256 and rdm_768) and `class_conditional_sample`.

Noise comes from an explicit `torch.Generator` or from tensors passed in
(`x_T=`, `noise=`). On the card the sampler's trajectory replays as one CUDA
graph (`jit=True`, `DPM_Solver.sample`), captured once per signature: the
sampler keeps one DPM_Solver per (conditioning shapes, guidance scale,
solver options, correction) and its CFG closure reads the conditioning from
tensors the sampler holds, into which each call copies its own; a
`MaskedBlend` correction (inpainting, DiffEdit) is held the same way, so a
later call at the same shapes replays with its own prompts, image and mask.
The first-stage encode and decode run eagerly. `load_sd_checkpoint(quant=)`
takes the int8 serving path (`ops/quant.py`) as the JAX function does.
`sample(mesh=)` and `txt2img(mesh=)` split the global batch over a mesh's
data axis (`parallel/mesh.py`): each rank samples its rows, with its rows of
the conditioning (and of a blend's table and mask), and the result is
gathered on every rank.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from dpm_solver_tpu_torch.models.adm_unet import ADMConfig, ADMUNet
from dpm_solver_tpu_torch.models.vae import AutoencoderKL, VAEConfig, VQModel
from dpm_solver_tpu_torch.ops.quant import check_mode
from dpm_solver_tpu_torch.schedule import NoiseScheduleVP
from dpm_solver_tpu_torch.solver import DPM_Solver
from dpm_solver_tpu_torch.solver.plan import get_time_steps
from dpm_solver_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from dpm_solver_tpu_torch.utils.resize import resize
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


def _signature(t: torch.Tensor) -> tuple:
    return tuple(t.shape), str(t.dtype), str(t.device)


def make_ldm_betas(n_timestep: int = 1000, linear_start: float = 0.00085,
                   linear_end: float = 0.0120) -> np.ndarray:
    """LDM's 'linear' beta schedule is sqrt-space linear
    (ldm/modules/diffusionmodules/util.py make_beta_schedule)."""
    return np.linspace(linear_start ** 0.5, linear_end ** 0.5, n_timestep,
                       dtype=np.float64) ** 2


def _images(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 1], fp32."""
    return ((x.float() + 1.0) / 2.0).clamp(0.0, 1.0)


@dataclasses.dataclass
class LatentDiffusion:
    """Minimal LDM bundle: a UNet over latents (`models.ADMUNet`) + a KL or VQ
    first stage (`models.AutoencoderKL`, `models.VQModel`) + conditioning
    glue.

    `text_encode(prompts) -> (B, T, context_dim)` is injected (any callable;
    its output moves to the UNet's device). `scale_factor` follows
    v1-inference.yaml (0.18215); `parameterization` is "eps" or "v" (SD-2.1);
    `conditioning_key` is "crossattn", "concat", "hybrid", "adm" or "none".
    """

    unet: nn.Module
    vae: nn.Module
    text_encode: Optional[Callable] = None
    betas: np.ndarray = dataclasses.field(default_factory=make_ldm_betas)
    scale_factor: float = 0.18215
    parameterization: str = "eps"
    conditioning_key: str = "crossattn"

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

        DiffusionWrapper twin (ddpm.py:1396-1416): `cond` is either a raw
        cross-attention context tensor (the txt2img path; the concat input
        for a "concat" model) or a dict with any of `c_concat` (joined onto
        x along channels: the super-resolution and inpainting LDMs),
        `c_crossattn` (the context, joined along tokens) and `c_adm` (the
        class labels), each a tensor or a list of tensors.
        """
        if cond is None:
            cond = {}
        elif not isinstance(cond, dict):
            cond = ({"c_concat": cond} if self.conditioning_key == "concat"
                    else {"c_crossattn": cond})

        def as_list(v):
            return list(v) if isinstance(v, (list, tuple)) else [v]

        xc = x
        if cond.get("c_concat") is not None:
            xc = torch.cat([x] + [torch.as_tensor(c).to(x.dtype) for c in as_list(cond["c_concat"])],
                           dim=-1)
        context = None
        if cond.get("c_crossattn") is not None:
            ca = as_list(cond["c_crossattn"])
            context = ca[0] if len(ca) == 1 else torch.cat(ca, dim=1)
        return self.unet(xc, t, cond.get("c_adm"), context)

    def get_learned_conditioning(self, prompts) -> torch.Tensor:
        if self.text_encode is None:
            raise ValueError("no text encoder attached")
        return torch.as_tensor(self.text_encode(prompts)).to(self.device)

    @property
    def is_vq(self) -> bool:
        return isinstance(self.vae, VQModel)

    def encode_first_stage(self, img: torch.Tensor,
                           noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """image in [-1, 1] NHWC -> scaled latent. KL: the posterior's mode, or
        its sample with the standard-normal `noise` when one is given. VQ:
        the PRE-quant latent (the VQModelInterface convention,
        autoencoder.py:14-34)."""
        if self.is_vq:
            z = self.vae.encode(img)
        else:
            posterior = self.vae.encode(img)
            z = posterior.mode() if noise is None else posterior.sample(noise)
        return self.scale_factor * z

    def decode_first_stage(self, z: torch.Tensor) -> torch.Tensor:
        """The VQ first stage quantises first, as VQModelInterface's decode does."""
        return self.vae.decode(z / self.scale_factor)


class MaskedBlend:
    """The correction inpainting and DiffEdit run after every solver step:
    x * mask + (1 - mask) * table[step], where `table` (steps + 1, *x.shape)
    holds each step's blend target (the known latent noised to that step's
    level) and `mask` (1 = regenerate) broadcasts against x.

    `DPMSolverSampler.sample` keeps one MaskedBlend of its own per signature
    and copies each call's table and mask into it, so a trajectory replayed
    from its CUDA graph reads this call's values, not the first call's."""

    def __init__(self, table: torch.Tensor, mask: torch.Tensor):
        self.table, self.mask = table, mask

    def __call__(self, x: torch.Tensor, t, step: int) -> torch.Tensor:
        return x * self.mask + (1.0 - self.mask) * self.table[step]

    def signature(self) -> tuple:
        return "blend", _signature(self.table), _signature(self.mask)


def _rank_rows(sharding, x_T, conditioning, unconditional_conditioning, correcting_xt_fn):
    """This rank's rows of a sharded call's per-sample inputs: x_T, each
    tensor of both conditionings, and a MaskedBlend's table (along its batch
    dim 1) and a per-sample mask. A tensor whose leading dim is not the
    batch's cannot be split and raises."""
    n = x_T.shape[0]

    def rows(t, dim=0):
        if t.shape[dim] != n:
            raise ValueError(f"a sharded call splits its per-sample inputs with x_T's {n} rows; "
                             f"got one of shape {tuple(t.shape)}")
        return sharding.local(t, dim).contiguous()

    cond = _cond_tree(rows, conditioning)
    uncond = _cond_tree(rows, unconditional_conditioning)
    if isinstance(correcting_xt_fn, MaskedBlend):
        mask = correcting_xt_fn.mask
        correcting_xt_fn = MaskedBlend(rows(correcting_xt_fn.table, 1),
                                       rows(mask) if mask.shape[0] == n else mask)
    elif correcting_xt_fn is not None:
        raise ValueError("a sharded call takes a MaskedBlend correction (whose table and mask it "
                         "splits) or none")
    return rows(x_T), cond, uncond, correcting_xt_fn


class DPMSolverSampler:
    """Reference-compatible adapter (sampler.py:8-162): CFG DPM-Solver++ over
    LDM latents, deterministic and stochastic encoding."""

    def __init__(self, model: LatentDiffusion):
        self.model = model
        self.noise_schedule = NoiseScheduleVP("discrete", alphas_cumprod=model.alphas_cumprod)
        # the solver key -> (conditioning tensors, unconditional ones, the
        # held MaskedBlend or None, the DPM_Solver whose closures read them)
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

    def solver_key(self, conditioning, unconditional_conditioning, scale, correcting_xt_fn=None,
                   **options) -> tuple:
        """What one of the sampler's DPM_Solvers (and so its CUDA graphs) is
        specialised to: the conditioning's and the unconditional
        conditioning's signatures (shapes, dtypes, devices), the guidance
        scale, every solver option (`options`: steps, skip_type, method,
        order, lower_order_final, t_start, t_end), and the correction: a
        MaskedBlend by its signature, any other callable by identity (a
        new callable captures a new graph)."""
        if correcting_xt_fn is None or isinstance(correcting_xt_fn, MaskedBlend):
            corr = None if correcting_xt_fn is None else correcting_xt_fn.signature()
        else:
            corr = correcting_xt_fn
        return (repr((_cond_tree(_signature, conditioning),
                      _cond_tree(_signature, unconditional_conditioning), float(scale),
                      sorted(options.items()))), corr)

    def _solver(self, conditioning, unconditional_conditioning, scale, correcting_xt_fn=None,
                **options) -> DPM_Solver:
        """The DPM_Solver of this key, its CFG closure (and correction) over
        tensors kept here, into which this call's conditioning (and blend
        table and mask) are copied: the counterpart of
        `jit_hoisting_constants` turning closed-over arrays into arguments,
        so that the solver's CUDA graphs serve every later call of the key,
        each with its own values."""
        key = self.solver_key(conditioning, unconditional_conditioning, scale, correcting_xt_fn,
                              **options)
        if key not in self._solvers:
            cond, uncond = (_cond_tree(torch.clone, c)
                            for c in (conditioning, unconditional_conditioning))
            blend = (MaskedBlend(correcting_xt_fn.table.clone(), correcting_xt_fn.mask.clone())
                     if isinstance(correcting_xt_fn, MaskedBlend) else None)
            self._solvers[key] = cond, uncond, blend, DPM_Solver(
                self._model_fn(cond, uncond, scale), self.noise_schedule,
                algorithm_type="dpmsolver++",
                correcting_xt_fn=correcting_xt_fn if blend is None else blend)
        cond, uncond, blend, solver = self._solvers[key]
        _cond_copy(cond, conditioning)
        _cond_copy(uncond, unconditional_conditioning)
        if blend is not None:
            blend.table.copy_(correcting_xt_fn.table)
            blend.mask.copy_(correcting_xt_fn.mask)
        return solver

    def sample(self, S: int, batch_size: int, shape: Tuple[int, int, int], conditioning=None,
               *, unconditional_guidance_scale: float = 1.0, unconditional_conditioning=None,
               x_T: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
               skip_type: str = "time_uniform", method: str = "multistep", order: int = 2,
               lower_order_final: bool = True, correcting_xt_fn: Optional[Callable] = None,
               t_start: Optional[float] = None, t_end: Optional[float] = None,
               return_intermediate: bool = True, jit: bool = True, mesh=None):
        """`shape` is the (H, W, C) latent shape (NHWC). The initial noise is
        `x_T`, or a standard normal draw from `generator`. Returns
        (x, intermediates) like the reference, intermediates None unless
        `return_intermediate`. `correcting_xt_fn(x, t, step)` runs after each
        step (a `MaskedBlend` replays from the graph with each call's
        table and mask). `jit`: as `DPM_Solver.sample`'s (a CUDA graph on
        the card).

        `mesh`: a DeviceMesh (`parallel.make_mesh`); the batch (which must
        divide over its data axis) is split over it: each rank samples its
        rows of x_T with its rows of the conditioning, the unconditional
        conditioning and a MaskedBlend's table and mask (graphed on the
        card, one capture a rank), and every rank returns the gathered
        global x and intermediates."""
        if mesh is not None and not jit:
            raise ValueError("mesh= implies a graphed (jit) sampler; jit=False is not supported "
                             "with a mesh")
        h, w, c = shape
        dev = self.model.device
        if x_T is None:
            if generator is None:
                raise ValueError("pass x_T or a torch.Generator")
            x_T = torch.randn((batch_size, h, w, c), generator=generator,
                              device=generator.device)
        x_T = x_T.to(dev)
        options = dict(steps=S, skip_type=skip_type, method=method, order=order,
                       lower_order_final=lower_order_final, t_start=t_start, t_end=t_end)
        sharding = None
        if mesh is not None:
            from dpm_solver_tpu_torch.parallel.mesh import batch_sharding

            sharding = batch_sharding(mesh)
            x_T, conditioning, unconditional_conditioning, correcting_xt_fn = _rank_rows(
                sharding, x_T, conditioning, unconditional_conditioning, correcting_xt_fn)
        solver = self._solver(conditioning, unconditional_conditioning,
                              unconditional_guidance_scale, correcting_xt_fn, **options)
        out = solver.sample(x_T, **options, return_intermediate=return_intermediate, jit=jit)
        if sharding is not None:
            out = sharding.gather(out)
        return out if return_intermediate else (out, None)

    def stochastic_encode(self, x0: torch.Tensor, encode_ratio: float,
                          noise: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """q(x_t | x_0) forward noising to `encode_ratio` (sampler.py:91-96):
        alpha_t x0 + sigma_t noise, `noise` of x0's shape (or (1, *x0.shape),
        the JAX `add_noise` draw) or drawn from `generator`."""
        t_end = self.ratio_to_time(encode_ratio)
        if noise is None:
            if generator is None:
                raise ValueError("pass noise or a torch.Generator")
            noise = torch.randn((1, *x0.shape), generator=generator, device=generator.device)
        noise = noise.to(x0.device, x0.dtype).reshape(1, *x0.shape)
        return DPM_Solver(None, self.noise_schedule).add_noise(x0, [t_end], noise)

    def encode(self, S: int, x: torch.Tensor, encode_ratio: float, conditioning=None, *,
               unconditional_guidance_scale: float = 1.0, unconditional_conditioning=None,
               skip_type: str = "time_uniform", method: str = "multistep", order: int = 2,
               lower_order_final: bool = False, return_intermediate: bool = True,
               jit: bool = True):
        """Deterministic ODE encoding x_0 -> x_t (sampler.py:98-138): the
        solver's inverse from t_0 up to `ratio_to_time(encode_ratio)`."""
        t_end = self.ratio_to_time(encode_ratio)
        options = dict(steps=S, skip_type=skip_type, method=method, order=order,
                       lower_order_final=lower_order_final, t_start=None, t_end=t_end)
        solver = self._solver(conditioning, unconditional_conditioning,
                              unconditional_guidance_scale, None, inverse=True, **options)
        out = solver.inverse(x.to(self.model.device), **options,
                             return_intermediate=return_intermediate, jit=jit)
        return out if return_intermediate else (out, None)

    # -- time <-> ratio converters (sampler.py:140-162) -----------------------

    def time_discrete_to_continuous(self, t_discrete):
        return (t_discrete + 1.0) / self.noise_schedule.total_N

    def time_continuous_to_discrete(self, t_continuous):
        return t_continuous * self.noise_schedule.total_N - 1.0

    def ratio_to_time(self, ratio):
        n = self.noise_schedule.total_N
        return (1.0 - 1.0 / n) * ratio + 1.0 / n

    def time_to_ratio(self, t_continuous):
        n = self.noise_schedule.total_N
        return (t_continuous - 1.0 / n) / (1.0 - 1.0 / n)

    def blend_table(self, z0: torch.Tensor, t_grid, noise: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(len(t_grid), *z0.shape): z0 noised to each time of the grid,
        `noise[k]` (or a draw from `generator`) at time k."""
        if noise is None:
            if generator is None:
                raise ValueError("pass noise or a torch.Generator")
            noise = torch.randn((len(t_grid), *z0.shape), generator=generator,
                                device=generator.device)
        return torch.stack([self.stochastic_encode(z0, self.time_to_ratio(float(t)), noise[k])
                            for k, t in enumerate(t_grid)])


class StableDiffusionPipeline:
    """txt2img / img2img / inpaint / upscale front end (ref
    scripts/txt2img.py:97-345, scripts/img2img.py, scripts/inpaint.py).
    Latent shape = image / 2^(levels - 1) of the first stage (8x for the SD
    VAE); CFG runs as one doubled batch.

    The models move to `device`, the card by default (raises when there is
    none).
    """

    def __init__(self, model: LatentDiffusion, device=DEFAULT_DEVICE):
        self.model = model.to(resolve_device(device))
        self.sampler = DPMSolverSampler(model)
        # spatial reduction of the first stage (8x for the SD VAE)
        self.vae_factor = 2 ** (len(model.vae.config.ch_mult) - 1)

    def _conditioning(self, prompts, negative_prompt: str):
        if isinstance(prompts, str):
            prompts = [prompts]
        cond = self.model.get_learned_conditioning(prompts)
        return len(prompts), cond, self.model.get_learned_conditioning(
            [negative_prompt] * len(prompts))

    @torch.no_grad()
    def txt2img(self, prompts, *, negative_prompt: str = "", steps: int = 25,
                guidance_scale: float = 7.5, height: int = 512, width: int = 512,
                generator: Optional[torch.Generator] = None,
                x_T: Optional[torch.Tensor] = None, order: int = 2, method: str = "multistep",
                jit: bool = True, mesh=None) -> torch.Tensor:
        """Images (B, height, width, 3) in [0, 1], fp32. The initial latent
        noise is `x_T`, else a draw from `generator` (a CPU generator seeded
        with 0 when neither is given). `method`: any fixed-grid solver method.
        `jit`: the sampler's (a CUDA graph of the trajectory on the card; the
        VAE decode runs eagerly). `mesh`: shard the prompt batch over the
        mesh's data axis (the serving scale-out path; the batch must divide
        over it): each rank encodes the prompts itself, then samples and
        decodes its rows, and every rank returns the gathered images. The
        text encoder must give every process the same values, as a real
        one does (`constant_context_encoder` seeds from the per-process
        string hash and does not)."""
        b, cond, uncond = self._conditioning(prompts, negative_prompt)
        if x_T is None and generator is None:
            generator = torch.Generator().manual_seed(0)
        f = self.vae_factor
        latents, _ = self.sampler.sample(
            steps, b, (height // f, width // f, self.model.vae.config.z_channels), cond,
            unconditional_guidance_scale=guidance_scale, unconditional_conditioning=uncond,
            x_T=x_T, generator=generator, order=order, method=method,
            return_intermediate=False, jit=jit, mesh=mesh)
        if mesh is None:
            return _images(self.model.decode_first_stage(latents))
        from dpm_solver_tpu_torch.parallel.mesh import batch_sharding

        sharding = batch_sharding(mesh)
        return sharding.gather(_images(self.model.decode_first_stage(sharding.local(latents))))

    @torch.no_grad()
    def img2img(self, init_image: torch.Tensor, prompts, *, strength: float = 0.75,
                negative_prompt: str = "", steps: int = 25, guidance_scale: float = 7.5,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None, order: int = 2,
                jit: bool = True) -> torch.Tensor:
        """init_image in [-1, 1] NHWC; noised to the `strength` ratio (with
        `noise`, (1, *latent shape) or the latent's shape, else a draw from
        `generator`), then sampled back down in max(1, int(steps * strength))
        steps from t = ratio_to_time(strength) at order min(order, those
        steps) (ref scripts/img2img.py semantics)."""
        b, cond, uncond = self._conditioning(prompts, negative_prompt)
        if init_image.shape[0] != b:
            raise ValueError(f"{init_image.shape[0]} images for {b} prompts")
        if noise is None and generator is None:
            generator = torch.Generator().manual_seed(0)
        z0 = self.model.encode_first_stage(init_image.to(self.model.device))
        z_t = self.sampler.stochastic_encode(z0, strength, noise=noise, generator=generator)
        steps_eff = max(1, int(steps * strength))
        latents, _ = self.sampler.sample(
            steps_eff, b, tuple(z0.shape[1:]), cond, unconditional_guidance_scale=guidance_scale,
            unconditional_conditioning=uncond, x_T=z_t,
            t_start=self.sampler.ratio_to_time(strength), order=min(order, steps_eff),
            return_intermediate=False, jit=jit)
        return _images(self.model.decode_first_stage(latents))

    def latent_mask(self, mask: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        """A pixel mask (B, H, W[, 1]) -> (B, h, w, 1) at latent size: JAX's
        "nearest" resize (pixel floor((i + 0.5) * H / h)), then >= 0.5."""
        if mask.dim() == 3:
            mask = mask[..., None]
        return (resize(mask.float(), hw, "nearest") >= 0.5).float()

    @torch.no_grad()
    def inpaint(self, init_image: torch.Tensor, mask: torch.Tensor, prompts, *,
                negative_prompt: str = "", steps: int = 25, guidance_scale: float = 7.5,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None, order: int = 2,
                jit: bool = True) -> torch.Tensor:
        """Text-guided inpainting by masked latent resampling (the JAX
        `inpaint`): after every solver step the known region (mask 0) is
        re-imposed from the init latent noised to that step's level (a
        `MaskedBlend` over the time-uniform grid's steps + 1 times, `noise`
        (steps + 1, *latent shape) or draws from `generator`), and the image
        is composited in pixel space as the reference does
        (scripts/inpaint.py:88-96: (1 - mask) * image + mask * predicted).

        init_image: (B, H, W, 3) in [-1, 1]; mask: (B, H, W) or (B, H, W, 1),
        1 = regenerate, 0 = keep."""
        b, cond, uncond = self._conditioning(prompts, negative_prompt)
        if init_image.shape[0] != b:
            raise ValueError(f"{init_image.shape[0]} images for {b} prompts")
        if noise is None and generator is None:
            generator = torch.Generator().manual_seed(0)
        dev = self.model.device
        init_image = init_image.to(dev)
        mask = mask.to(dev, init_image.dtype)
        if mask.dim() == 3:
            mask = mask[..., None]
        z0 = self.model.encode_first_stage(init_image)
        mask_latent = self.latent_mask(mask, tuple(z0.shape[1:3])).to(z0.dtype)
        ns = self.sampler.noise_schedule
        grid = get_time_steps(ns, "time_uniform", float(ns.T), 1.0 / ns.total_N, steps)
        blend = self.sampler.blend_table(z0, grid, noise=noise, generator=generator)
        latents, _ = self.sampler.sample(
            steps, b, tuple(z0.shape[1:]), cond, unconditional_guidance_scale=guidance_scale,
            unconditional_conditioning=uncond, x_T=blend[0], order=order,
            correcting_xt_fn=MaskedBlend(blend, mask_latent), return_intermediate=False, jit=jit)
        pred = _images(self.model.decode_first_stage(latents))
        return (1.0 - mask) * _images(init_image) + mask * pred

    @torch.no_grad()
    def upscale(self, lr_image: torch.Tensor, *, steps: int = 50,
                generator: Optional[torch.Generator] = None,
                x_T: Optional[torch.Tensor] = None, order: int = 2,
                cond_encode: Optional[Callable] = None, context=None,
                jit: bool = True) -> torch.Tensor:
        """Blind super-resolution with a concat-conditioned LDM (the bsr-sr
        models: conditioning_key "concat", an identity cond stage: the LR
        image joins z_t along channels at every step; the latent is the LR
        size, so the output is LR * vae_factor). `cond_encode`: an optional
        LR -> conditioning map; `context`: the cross-attention conditioning
        of a "hybrid" model.

        lr_image: (B, h, w, 3) in [-1, 1]."""
        model = self.model
        if model.conditioning_key not in ("concat", "hybrid"):
            raise ValueError("upscale needs a concat-conditioned LDM")
        if model.conditioning_key == "hybrid" and context is None:
            raise ValueError("hybrid-conditioned model: pass `context` "
                             "(cross-attention conditioning) to upscale")
        b, h, w = lr_image.shape[:3]
        lr_image = lr_image.to(model.device)
        cond = {"c_concat": lr_image if cond_encode is None else cond_encode(lr_image)}
        if context is not None:
            cond["c_crossattn"] = torch.as_tensor(context).to(model.device)
        if x_T is None and generator is None:
            generator = torch.Generator().manual_seed(0)
        latents, _ = self.sampler.sample(
            steps, b, (h, w, model.vae.config.z_channels), cond,
            unconditional_guidance_scale=1.0, x_T=x_T, generator=generator, order=order,
            return_intermediate=False, jit=jit)
        return _images(model.decode_first_stage(latents))


_LDM_PRESETS = {
    # name -> (unet_config, vae_config, betas kwargs, scale_factor)
    "sd_v1": (ADMConfig.sd_v1, VAEConfig.sd_v1,
              dict(linear_start=0.00085, linear_end=0.0120), 0.18215),
    "sd_v2_1": (ADMConfig.sd_v2_1, VAEConfig.sd_v1,
                dict(linear_start=0.00085, linear_end=0.0120), 0.18215),
    "cin256": (ADMConfig.cin256, VAEConfig.vq_cin256,
               dict(linear_start=0.0015, linear_end=0.0195), 1.0),
    "rdm_768": (ADMConfig.rdm_768, VAEConfig.rdm_768,
                dict(linear_start=0.0015, linear_end=0.015), 0.22765929),
}


def _torch_state_dict(path: Union[str, Path]) -> dict:
    """A checkpoint file's flat state dict: a plain one, or a CompVis
    `{"state_dict": ...}` wrapper (`torch.load`, tensors only)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return obj


def _load_strict_subset(module: nn.Module, sd: dict, what: str) -> None:
    """Load the module's keys from `sd` (keys it does not have are ignored,
    as the JAX converters ignore them); a missing key raises."""
    own = module.state_dict()
    missing = sorted(set(own) - set(sd))
    if missing:
        raise KeyError(f"{what}: the checkpoint lacks {len(missing)} keys, e.g. {missing[:3]}")
    module.load_state_dict({k: sd[k] if isinstance(sd[k], torch.Tensor)
                            else torch.from_numpy(np.asarray(sd[k])) for k in own}, strict=True)


def load_sd_checkpoint(path_or_state_dict, *, preset: str = "sd_v1",
                       unet_config: Optional[ADMConfig] = None,
                       vae_config: Optional[VAEConfig] = None,
                       text_encode: Optional[Callable] = None,
                       parameterization: Optional[str] = None,
                       conditioning_key: Optional[str] = None, quant: Optional[str] = None,
                       compute_dtype: torch.dtype = torch.float32,
                       device=DEFAULT_DEVICE) -> LatentDiffusion:
    """Build a LatentDiffusion from a CompVis checkpoint: `model.diffusion_model.*`
    into `ADMUNet.load_state_dict`, `first_stage_model.*` into an
    AutoencoderKL or, when the checkpoint holds `quantize.embedding.weight`,
    a VQModel (n_embed from the codebook's rows). `preset` selects the
    geometry, the schedule and the scale factor (sd_v1 | sd_v2_1 | cin256 |
    rdm_768: the reference's LDM config files); explicit configs override
    it. Takes a state dict (tensors or arrays) or a `.ckpt`/`.pt` path read
    by `torch.load`. The networks are built on `device` (the card by
    default) and compute in `compute_dtype`. `quant` ("w8a8" or
    "w8a8_conv", off by default) sets both configs' `quant`, the int8
    serving path (`ops/quant.py`): a config switch only, the state dict is
    the same."""
    check_mode(quant)
    sd = (_torch_state_dict(path_or_state_dict) if isinstance(path_or_state_dict, (str, Path))
          else dict(path_or_state_dict))
    if preset not in _LDM_PRESETS:
        raise ValueError(f"unknown preset {preset!r}; one of {sorted(_LDM_PRESETS)}")
    u_default, v_default, beta_kw, scale = _LDM_PRESETS[preset]
    unet_config = unet_config or u_default()
    vae_config = vae_config or v_default()
    if quant is not None:
        unet_config = dataclasses.replace(unet_config, quant=quant)
        vae_config = dataclasses.replace(vae_config, quant=quant)
    dev = resolve_device(device)

    prefix = "model.diffusion_model."
    unet_sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    if not unet_sd:
        raise ValueError("no model.diffusion_model.* keys in checkpoint")
    unet = ADMUNet(unet_config, compute_dtype, device=dev)
    _load_strict_subset(unet, unet_sd, "model.diffusion_model")

    prefix = "first_stage_model."
    vae_sd = {k[len(prefix):] if k.startswith(prefix) else k: v for k, v in sd.items()}
    codebook = next((v for k, v in sd.items() if k.endswith("quantize.embedding.weight")), None)
    if codebook is not None:
        vae = VQModel(vae_config, n_embed=int(np.shape(codebook)[0]),
                      compute_dtype=compute_dtype, device=dev)
    else:
        vae = AutoencoderKL(vae_config, compute_dtype, device=dev)
    _load_strict_subset(vae, vae_sd, "first_stage_model")

    if parameterization is None:
        # SD-2.x checkpoints (linear transformer projections) are v-prediction
        parameterization = "v" if unet_config.use_linear_in_transformer else "eps"
    if conditioning_key is None:
        # a UNet eating more channels than the latent has => concat
        # conditioning (SR / inpainting LDMs; ddpm.py:442-443's concat_mode);
        # hybrid when it also cross-attends
        extra = unet_config.in_channels > vae_config.embed_dim
        has_ctx = unet_config.context_dim is not None
        conditioning_key = ("hybrid" if extra and has_ctx else "concat" if extra
                            else "crossattn" if has_ctx else "none")
    return LatentDiffusion(unet=unet.eval(), vae=vae.eval(), text_encode=text_encode,
                           betas=make_ldm_betas(1000, **beta_kw), scale_factor=scale,
                           parameterization=parameterization, conditioning_key=conditioning_key)


@torch.no_grad()
def class_conditional_sample(model: LatentDiffusion, class_embedder, labels, *, steps: int = 20,
                             guidance_scale: float = 1.0, uncond_label: Optional[int] = None,
                             latent_hw: Optional[Tuple[int, int]] = None,
                             generator: Optional[torch.Generator] = None,
                             x_T: Optional[torch.Tensor] = None, order: int = 2,
                             sampler: Optional[DPMSolverSampler] = None,
                             jit: bool = True) -> torch.Tensor:
    """Class-conditional LDM sampling (ref scripts/sample_diffusion.py with
    the cin256 ClassEmbedder conditioning): labels -> embedded context ->
    CFG DPM-Solver++ (the unconditional half embeds `uncond_label`) ->
    first-stage decode, images in [0, 1]. Works with either first stage.
    The initial noise is `x_T`, else a draw from `generator` (a CPU
    generator seeded with 0 when neither is given). `sampler`: a
    DPMSolverSampler of `model` to reuse (its solvers and CUDA graphs);
    a new one by default, as in the JAX function."""
    labels = torch.as_tensor(labels, dtype=torch.int64)
    b = labels.shape[0]
    sampler = sampler or DPMSolverSampler(model)
    cond = class_embedder(labels).to(model.device)
    uncond = None
    if guidance_scale != 1.0:
        if uncond_label is None:
            raise ValueError("CFG needs an uncond_label (the embedder's 'unconditional' class id)")
        uncond = class_embedder(torch.full((b,), uncond_label, dtype=torch.int64)).to(model.device)
    f = 2 ** (len(model.vae.config.ch_mult) - 1)
    hw = latent_hw or (model.vae.config.resolution // f, model.vae.config.resolution // f)
    if x_T is None and generator is None:
        generator = torch.Generator().manual_seed(0)
    latents, _ = sampler.sample(
        steps, b, (hw[0], hw[1], model.vae.config.z_channels), cond,
        unconditional_guidance_scale=guidance_scale, unconditional_conditioning=uncond,
        x_T=x_T, generator=generator, order=order, return_intermediate=False, jit=jit)
    return _images(model.decode_first_stage(latents))
