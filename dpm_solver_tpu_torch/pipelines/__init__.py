from dpm_solver_tpu_torch.pipelines.cascade import CascadePipeline, CascadeStage
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
from dpm_solver_tpu_torch.pipelines.retrieval import Searcher, build_image_database, knn2img

__all__ = [
    "CascadePipeline",
    "CascadeStage",
    "Searcher",
    "build_image_database",
    "knn2img",
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
