"""Cascaded pixel-space diffusion (DeepFloyd-IF style), on torch.

Port of `dpm_solver_tpu/pipelines/cascade.py`: a base text/class-conditional
stage followed by super-resolution stages, each an independently configured
DPM-Solver run on the port's `model_wrapper` and `DPM_Solver`, with the
reference's noise-augmentation conditioning on the upsampled input (the
SuperResModel pattern, guided_diffusion/unet.py:666-680; the model itself
concatenates its low-res input, e.g. through `models.super_res_inputs`).

Stages chain on the host (their shapes differ). `DPM_Solver.sample`'s
default `jit=True` replays each stage's trajectory as one CUDA graph on the
card; a stage keeps its solver (and so its graphs) across calls.

Randomness: each stage takes three standard-normal tensors, as the JAX
stage splits its key three ways: x_T (batch, res, res, channels), the noise
augmentation of its low-res input (1, batch, low res, low res, channels),
and, for an `sde-*` algorithm, the solver's noise (steps, batch, res, res,
channels). Pass them per stage (`noise=[{"x_T": ..., "aug": ..., "sde":
...}, ...]`), or a `generator` that draws them in that order, stage by
stage, on the model's device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from dpm_solver_tpu_torch.pipelines.stable_diffusion import _cond_copy, _cond_tree, _signature
from dpm_solver_tpu_torch.schedule import NoiseScheduleVP
from dpm_solver_tpu_torch.solver import DPM_Solver
from dpm_solver_tpu_torch.wrapper import model_wrapper


@dataclasses.dataclass
class CascadeStage:
    """One stage of the cascade.

    `model(x, t, cond, low_res)` -> eps; `low_res` is None for the base
    stage, else the previous stage's (noise-augmented) output which the model
    itself conditions on (SuperResModel concatenates it: `super_res_inputs`).
    `aug_level`: noise-augmentation ratio applied to the low-res conditioning
    (IF-style; 0 disables). SDE algorithm types take a solver noise tensor.
    """

    model: Callable
    noise_schedule: NoiseScheduleVP
    resolution: int
    channels: int = 3
    steps: int = 25
    order: int = 2
    method: str = "multistep"
    skip_type: str = "time_uniform"
    algorithm_type: str = "dpmsolver++"
    guidance_scale: float = 1.0
    aug_level: float = 0.0
    t_end: Optional[float] = None


class CascadePipeline:
    """Base stage + upsampler stages; `sample(cond, uncond, batch=,
    noise=|generator=)`."""

    def __init__(self, stages: Sequence[CascadeStage]):
        assert stages, "need at least one stage"
        self.stages = list(stages)
        # per stage: (the signature of its conditioning and low-res input,
        # the tensors its model reads, its DPM_Solver); a call of the same
        # signature copies its values into those tensors, so the solver's
        # CUDA graphs serve it
        self._solvers = {}

    def _solver(self, i: int, cond, uncond, low_res) -> DPM_Solver:
        stage = self.stages[i]
        given = dict(cond=cond, uncond=uncond, low_res=low_res)
        key = repr({k: _cond_tree(_signature, v) for k, v in given.items()})
        if i in self._solvers and self._solvers[i][0] == key:
            _, held, solver = self._solvers[i]
            for k, v in given.items():
                _cond_copy(held[k], v)
            return solver
        held = {k: _cond_tree(torch.clone, v) for k, v in given.items()}

        def raw(x, t, c):
            # SuperResModel contract (unet.py:666-680): the MODEL concatenates
            # the low-res conditioning itself (e.g. via super_res_inputs); the
            # pipeline hands over raw x + low_res exactly once
            return stage.model(x, t, c, held["low_res"])

        if uncond is not None:
            model_fn = model_wrapper(
                raw, stage.noise_schedule, model_type="noise", guidance_type="classifier-free",
                condition=held["cond"], unconditional_condition=held["uncond"],
                guidance_scale=stage.guidance_scale)
        else:
            model_fn = model_wrapper(lambda x, t: raw(x, t, held["cond"]), stage.noise_schedule,
                                     model_type="noise")
        solver = DPM_Solver(model_fn, stage.noise_schedule, algorithm_type=stage.algorithm_type)
        self._solvers[i] = key, held, solver
        return solver

    def stage_noise(self, i: int, batch: int, generator: torch.Generator) -> dict:
        """Stage i's three draws from `generator`, in the JAX stage's order."""
        stage = self.stages[i]
        shape = (batch, stage.resolution, stage.resolution, stage.channels)
        dev = generator.device
        out = {"x_T": torch.randn(shape, generator=generator, device=dev)}
        if i > 0:
            low = self.stages[i - 1]
            out["aug"] = torch.randn((1, batch, low.resolution, low.resolution, low.channels),
                                     generator=generator, device=dev)
        if stage.algorithm_type.startswith("sde"):
            out["sde"] = torch.randn((stage.steps, *shape), generator=generator, device=dev)
        return out

    def _run_stage(self, i: int, cond, uncond, draws: dict, low_res=None):
        stage = self.stages[i]
        ns = stage.noise_schedule
        if low_res is not None and stage.aug_level > 0:
            # IF-style noise augmentation of the conditioning image
            low_res = DPM_Solver(None, ns).add_noise(
                low_res, [stage.aug_level * ns.T], draws["aug"].to(low_res.device))
        solver = self._solver(i, cond, uncond, low_res)
        needs_noise = stage.algorithm_type.startswith("sde")
        return solver.sample(
            draws["x_T"], steps=stage.steps, t_end=stage.t_end or 1e-3, order=stage.order,
            skip_type=stage.skip_type, method=stage.method,
            noise=draws["sde"] if needs_noise else None)

    def sample(self, cond=None, uncond=None, *, batch: int = 1,
               noise: Optional[Sequence[dict]] = None,
               generator: Optional[torch.Generator] = None,
               return_all_stages: bool = False):
        if noise is None and generator is None:
            raise ValueError("pass noise= (one dict a stage) or a torch.Generator")
        outs, x = [], None
        for i in range(len(self.stages)):
            draws = noise[i] if noise is not None else self.stage_noise(i, batch, generator)
            x = self._run_stage(i, cond, uncond, draws, low_res=x)
            outs.append(x)
        return outs if return_all_stages else x
