"""The training initialisers of the JAX models, on the port's parameters.

Training from scratch starts from the distribution the JAX package's
`model.init` draws (its own draws never match a torch generator's, so the
tests compare the distributions, tensor by tensor):

- DDPM UNet and ADM UNet (with its spatial transformers): Flax's defaults,
  `lecun_normal` kernels (variance_scaling(1, fan_in, truncated_normal)),
  zero biases, unit norm scales; the ADM UNet zeroes the kernels the JAX
  model builds with `_zero_init` (each res block's out conv, each attention's
  and transformer's proj_out, the output conv), and its class embedding is
  `nn.Embed`'s normal(1 / sqrt(features)).
- The first stages (AutoencoderKL, VQModel), frozen while a UNet trains:
  Flax's defaults, the VQ codebook uniform(-1 / n_embed, 1 / n_embed).
- LPIPS: Flax's defaults for the VGG trunk, the `lin{k}` heads 1 (the JAX
  model's constant init); the PatchGAN discriminator: `weights_init`'s
  N(0, 0.02) conv weights with zero biases, BatchNorm scales N(1, 0.02)
  and zero biases (running moments 0 and 1), ActNorm the identity.
- NCSN++ / DDPM++: `ddpm_init(scale)` = variance_scaling(scale, fan_avg,
  uniform) everywhere (`dpm_solver_tpu/models/ncsnpp.py:150-154`), with
  `config.init_scale` (0 -> 1e-10) on each res block's second conv, each
  attention's output projection and the convs to the image; the fused
  q|k|v projection's fans are those of the JAX model's one (C, 3C) Dense;
  the frozen Fourier features normal(fourier_scale).
- NCSNv2 / NCSNv1: every conv variance_scaling(1/3, fan_in, uniform)
  (`ncsn_conv`'s `_ncsn_init`) with zero biases; InstanceNorm++'s alpha and
  gamma normal(0.02) + 1, beta zeros; the conditional norms' embedding
  table the same by its (gamma | alpha | beta) thirds.

Fans follow Flax's rule on the port's layouts: a Linear weight (out, in), a
conv weight (out, in, kh, kw), NCSN++'s NIN weight `W` (in, out).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

_TRUNC_STD = 0.87962566103423978  # std of a standard normal truncated to [-2, 2]


def fans(weight: torch.Tensor, in_out: bool = False) -> Tuple[int, int]:
    """(fan_in, fan_out) of a torch-layout weight, by Flax's rule (the
    receptive field times the input or output features); `in_out`: the
    weight is stored (in, out), as NCSN++'s NIN `W`."""
    if weight.dim() == 2:
        return (weight.shape[0], weight.shape[1]) if in_out else (weight.shape[1], weight.shape[0])
    rf = math.prod(weight.shape[2:])
    return weight.shape[1] * rf, weight.shape[0] * rf


@torch.no_grad()
def variance_scaling_(p: torch.Tensor, scale: float, mode: str, distribution: str,
                      fan: Tuple[int, int], generator: torch.Generator) -> torch.Tensor:
    """jax.nn.initializers.variance_scaling on `p`, with (fan_in, fan_out) `fan`."""
    n = {"fan_in": fan[0], "fan_out": fan[1], "fan_avg": (fan[0] + fan[1]) / 2}[mode]
    var = scale / max(1.0, n)
    dev = generator.device
    if distribution == "truncated_normal":
        std = math.sqrt(var) / _TRUNC_STD
        vals = torch.empty(p.shape, device=dev)
        torch.nn.init.trunc_normal_(vals, 0.0, std, -2 * std, 2 * std, generator=generator)
    elif distribution == "uniform":
        lim = math.sqrt(3 * var)
        vals = torch.rand(p.shape, generator=generator, device=dev) * (2 * lim) - lim
    elif distribution == "normal":
        vals = torch.randn(p.shape, generator=generator, device=dev) * math.sqrt(var)
    else:
        raise ValueError(f"unknown distribution {distribution!r}")
    return p.copy_(vals)


def lecun_normal_(p: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    return variance_scaling_(p, 1.0, "fan_in", "truncated_normal", fans(p), generator)


def ddpm_init_(p: torch.Tensor, generator: torch.Generator, scale: float = 1.0,
               fan: Optional[Tuple[int, int]] = None, in_out: bool = False) -> torch.Tensor:
    """NCSN++'s `ddpm_init(scale)`: variance_scaling(scale, fan_avg, uniform),
    scale 0 taken as 1e-10."""
    return variance_scaling_(p, 1e-10 if scale == 0 else scale, "fan_avg", "uniform",
                             fan or fans(p, in_out), generator)


@torch.no_grad()
def _defaults_(model: nn.Module, generator: torch.Generator, zero: set) -> None:
    """Flax's defaults: lecun_normal weights (the modules in `zero`: zeros),
    zero biases, unit norm scales, embeddings normal(1 / sqrt(features))."""
    for mod in model.modules():
        for name, p in mod.named_parameters(recurse=False):
            if name == "bias" or (p.dim() == 1 and name != "weight"):
                p.zero_()
            elif isinstance(mod, (nn.GroupNorm, nn.LayerNorm)) or p.dim() == 1:
                p.fill_(1.0)
            elif mod in zero:
                p.zero_()
            elif isinstance(mod, nn.Embedding):
                variance_scaling_(p, 1.0, "fan_in", "normal", (p.shape[1], p.shape[1]), generator)
            else:
                lecun_normal_(p, generator)


@torch.no_grad()
def _ncsnpp_(model: nn.Module, generator: torch.Generator) -> None:
    from dpm_solver_tpu_torch.models.ddpm_unet import Conv2d
    from dpm_solver_tpu_torch.models.ncsnpp import (FourierFeatures, GroupNorm, ResBlockpp,
                                                    SelfAttention2D)

    cfg = model.config
    scaled = set()   # ddpm_init(init_scale)
    fused = set()    # the q|k|v NINs: the fans of one (C, 3C) Dense
    for mod in model.modules():
        if isinstance(mod, ResBlockpp):
            scaled.add(mod.Conv_1)
        elif isinstance(mod, SelfAttention2D):
            scaled.add(mod.NIN_3)
            fused.update((mod.NIN_0, mod.NIN_1, mod.NIN_2))
        elif isinstance(mod, Conv2d) and mod.out_channels == cfg.image_channels:
            scaled.add(mod)
    for mod in model.modules():
        for name, p in mod.named_parameters(recurse=False):
            if isinstance(mod, FourierFeatures):
                p.copy_(torch.randn(p.shape, generator=generator, device=generator.device)
                        * cfg.fourier_scale)
            elif isinstance(mod, (GroupNorm, nn.GroupNorm)):
                p.fill_(1.0 if name == "weight" else 0.0)
            elif p.dim() == 1:
                p.zero_()
            elif mod in fused:
                ddpm_init_(p, generator, fan=(p.shape[0], 3 * p.shape[1]))
            else:
                ddpm_init_(p, generator, cfg.init_scale if mod in scaled else 1.0,
                           in_out=name == "W")


@torch.no_grad()
def _ncsnv2_(model: nn.Module, generator: torch.Generator) -> None:
    from dpm_solver_tpu_torch.models.ncsnv2 import (CondInstanceNormPlus, InstanceNormPlus,
                                                    NCSNConv)

    def normal_plus_one_(p):
        p.copy_(torch.randn(p.shape, generator=generator, device=generator.device) * 0.02 + 1.0)

    for mod in model.modules():
        if isinstance(mod, NCSNConv):
            variance_scaling_(mod.weight, 1.0 / 3.0, "fan_in", "uniform", fans(mod.weight),
                              generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, InstanceNormPlus):
            normal_plus_one_(mod.alpha)
            normal_plus_one_(mod.gamma)
            if mod.beta is not None:
                mod.beta.zero_()
        elif isinstance(mod, CondInstanceNormPlus):
            table = mod.embed.weight
            normal_plus_one_(table[:, :2 * mod.channels])
            table[:, 2 * mod.channels:].zero_()


def init_train_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter of a DDPMUNet, ADMUNet, NCSNpp, NCSNv2,
    AutoencoderKL, VQModel, LPIPS or NLayerDiscriminator from the JAX model's initialisers (module docstring), from
    `generator` (on its device). Returns the model."""
    from dpm_solver_tpu_torch.models.adm_unet import ADMAttention, ADMResBlock, ADMUNet
    from dpm_solver_tpu_torch.models.ddpm_unet import DDPMUNet
    from dpm_solver_tpu_torch.models.ncsnpp import NCSNpp
    from dpm_solver_tpu_torch.models.ncsnv2 import NCSNv2
    from dpm_solver_tpu_torch.models.transformer import SpatialTransformer
    from dpm_solver_tpu_torch.models.vae import AutoencoderKL, VectorQuantizer, VQModel

    from dpm_solver_tpu_torch.models.discriminator import (ActNorm, BatchNorm,
                                                          NLayerDiscriminator, bn_scale_init_,
                                                          gan_conv_init_)
    from dpm_solver_tpu_torch.models.lpips import LPIPS, LPIPS_CHANNELS

    if isinstance(model, NCSNpp):
        _ncsnpp_(model, generator)
    elif isinstance(model, LPIPS):
        _defaults_(model.net, generator, set())
        for k in range(len(LPIPS_CHANNELS)):
            getattr(model, f"lin{k}").model[1].weight.data.fill_(1.0)
    elif isinstance(model, NLayerDiscriminator):
        with torch.no_grad():
            for mod in model.modules():
                if isinstance(mod, nn.Conv2d):
                    gan_conv_init_(mod.weight, generator)
                    if mod.bias is not None:
                        mod.bias.zero_()
                elif isinstance(mod, BatchNorm):
                    bn_scale_init_(mod.weight, generator)
                    mod.bias.zero_()
                    mod.reset_running_stats()
                elif isinstance(mod, ActNorm):
                    mod.loc.zero_()
                    mod.scale.fill_(1.0)
    elif isinstance(model, NCSNv2):
        _ncsnv2_(model, generator)
    elif isinstance(model, (DDPMUNet, AutoencoderKL, VQModel)):
        _defaults_(model, generator, set())
        for mod in model.modules():
            if isinstance(mod, VectorQuantizer):
                n = mod.embedding.weight.shape[0]
                with torch.no_grad():
                    mod.embedding.weight.copy_(torch.rand(
                        mod.embedding.weight.shape, generator=generator,
                        device=generator.device) * (2.0 / n) - 1.0 / n)
    elif isinstance(model, ADMUNet):
        zero = {model.out[2]}
        for mod in model.modules():
            if isinstance(mod, ADMResBlock):
                zero.add(mod.out_layers[3])
            elif isinstance(mod, (ADMAttention, SpatialTransformer)):
                zero.add(mod.proj_out)
        _defaults_(model, generator, zero)
    else:
        raise TypeError(f"init_train_ takes DDPMUNet, ADMUNet, NCSNpp, NCSNv2, AutoencoderKL, "
                        f"VQModel, LPIPS or NLayerDiscriminator, got {type(model).__name__}")
    return model
