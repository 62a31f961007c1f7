from dpm_solver_tpu_torch.pipelines.stable_diffusion import (
    DPMSolverSampler,
    LatentDiffusion,
    StableDiffusionPipeline,
    make_ldm_betas,
)

__all__ = [
    "DPMSolverSampler",
    "LatentDiffusion",
    "StableDiffusionPipeline",
    "make_ldm_betas",
]
