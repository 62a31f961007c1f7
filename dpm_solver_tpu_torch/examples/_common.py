"""What the demos share: the device flag, seeded random weights, and PNG output."""

from __future__ import annotations

import os

import numpy as np
import torch


def add_device_flag(parser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="where the networks run: the card (default) or cpu")


def seeded(module, seed: int):
    """`module` with seeded random weights (the demos' default bundle)."""
    from dpm_solver_tpu_torch.models import init_random_

    dev = next(module.parameters()).device
    return init_random_(module, torch.Generator(device=dev).manual_seed(seed)).eval()


def tiny_sd_bundle(dev, context_dim: int, text_encode=None):
    """The JAX demos' tiny SD-shaped bundle (a 32-channel cross-attention UNet
    over 8x8 latents, a KL first stage at 32 px), seeded random weights."""
    from dpm_solver_tpu_torch.models import ADMConfig, ADMUNet
    from dpm_solver_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from dpm_solver_tpu_torch.pipelines import LatentDiffusion

    ucfg = ADMConfig(image_size=8, in_channels=4, model_channels=32, out_channels=4,
                     num_res_blocks=1, attention_resolutions=(1, 2), channel_mult=(1, 2),
                     num_heads=2, use_spatial_transformer=True, transformer_depth=1,
                     context_dim=context_dim)
    vcfg = VAEConfig.tiny(resolution=32, attn_resolutions=())
    return LatentDiffusion(seeded(ADMUNet(ucfg, device=dev), 0),
                           seeded(AutoencoderKL(vcfg, device=dev), 1), text_encode=text_encode)


def save_png(image: np.ndarray, path: str) -> None:
    """An (H, W, 3) or (H, W) image in [0, 1] as a PNG (the port's encoder)."""
    from dpm_solver_tpu_torch import native

    arr = (np.clip(image, 0.0, 1.0) * 255).astype(np.uint8)
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=-1)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    native.write_png_batch(arr[None], [path])
