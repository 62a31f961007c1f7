from dpm_solver_tpu_torch.pipelines.diffedit import compute_edit_mask, diffedit
from dpm_solver_tpu_torch.pipelines.stable_diffusion import (
    DPMSolverSampler,
    LatentDiffusion,
    MaskedBlend,
    StableDiffusionPipeline,
    class_conditional_sample,
    load_sd_checkpoint,
    make_ldm_betas,
)

__all__ = [
    "DPMSolverSampler",
    "LatentDiffusion",
    "MaskedBlend",
    "StableDiffusionPipeline",
    "class_conditional_sample",
    "compute_edit_mask",
    "diffedit",
    "load_sd_checkpoint",
    "make_ldm_betas",
]
