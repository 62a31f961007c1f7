from dpm_solver_tpu_torch.models.adm_unet import (ADMClassifier, ADMConfig, ADMUNet,
                                                  AttentionPool2d, layout, super_res_inputs)
from dpm_solver_tpu_torch.models.ddpm_unet import DDPMUNet, DDPMUNetConfig, init_random_
from dpm_solver_tpu_torch.models.discriminator import NLayerDiscriminator
from dpm_solver_tpu_torch.models.lpips import LPIPS
from dpm_solver_tpu_torch.models.ncsnpp import NCSNpp, NCSNppConfig
from dpm_solver_tpu_torch.models.ncsnv2 import NCSNv2, NCSNv2Config
from dpm_solver_tpu_torch.models.clip import CLIPModel, CLIPTextModel, CLIPTowerConfig
from dpm_solver_tpu_torch.models.clip_tokenizer import CLIPTokenizer
from dpm_solver_tpu_torch.models.text_encoder import (BERTEmbedder, ClassEmbedder,
                                                      FrozenCLIPEmbedder, FrozenCLIPImageEmbedder,
                                                      FrozenCLIPTextJointEmbedder, SpatialRescaler,
                                                      constant_context_encoder)
from dpm_solver_tpu_torch.models.transformer import SpatialTransformer
from dpm_solver_tpu_torch.models.vae import (AutoencoderKL, DiagonalGaussian, VAEConfig,
                                             VectorQuantizer, VQModel)
from dpm_solver_tpu_torch.models.wideresnet import WideResNetClassifier

__all__ = [
    "ADMClassifier",
    "ADMConfig",
    "ADMUNet",
    "AttentionPool2d",
    "AutoencoderKL",
    "BERTEmbedder",
    "CLIPModel",
    "CLIPTextModel",
    "CLIPTokenizer",
    "CLIPTowerConfig",
    "ClassEmbedder",
    "DDPMUNet",
    "DDPMUNetConfig",
    "DiagonalGaussian",
    "FrozenCLIPEmbedder",
    "FrozenCLIPImageEmbedder",
    "FrozenCLIPTextJointEmbedder",
    "LPIPS",
    "NCSNpp",
    "NCSNppConfig",
    "NCSNv2",
    "NCSNv2Config",
    "NLayerDiscriminator",
    "SpatialRescaler",
    "SpatialTransformer",
    "VAEConfig",
    "VQModel",
    "VectorQuantizer",
    "WideResNetClassifier",
    "constant_context_encoder",
    "init_random_",
    "layout",
    "super_res_inputs",
]
