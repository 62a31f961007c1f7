"""The PatchGAN discriminator of first-stage (VAE / VQGAN) adversarial training.

Port of `dpm_solver_tpu/models/discriminator.py`, the twin of
`taming.modules.discriminator.model.NLayerDiscriminator` (with
`weights_init` and `ActNorm`), which the reference's autoencoder losses
build (ldm/modules/losses/contperceptual.py:22-25, vqperceptual.py:67-71):

  Conv(ndf, 4x4, s2, p1) -> LeakyReLU(0.2)
  for n in 1..n_layers-1: Conv(ndf*min(2^n, 8), 4x4, s2, p1, no bias) -> norm -> LeakyReLU(0.2)
  Conv(ndf*min(2^n_layers, 8), 4x4, s1, p1, no bias) -> norm -> LeakyReLU(0.2)
  Conv(1, 4x4, s1, p1)                                  # patch logits

NHWC in, (B, H', W', 1) fp32 logits out; the convs are `F.conv2d` (the
library conv), as the JAX package leaves them to flax's `nn.Conv`.
Parameter names are taming's `main.{i}` (its nn.Sequential's indices).

The norm is BatchNorm with flax's semantics (`nn.BatchNorm(momentum=0.9,
epsilon=1e-5)` in training mode), not torch's: it normalises with the
batch's biased variance, E[x^2] - E[x]^2 (flax's fast variance, clipped at
0), and its running moments become 0.9 * running + 0.1 * batch with that
same biased variance (torch's `running_var` takes the unbiased one). It is
functional: `forward(x, batch_stats)` takes the running moments and returns
them updated beside the logits, so a caller threads them (the
discriminator pass real -> fake) or drops them (the generator pass). With
`use_actnorm=True` the norm is taming's ActNorm, `scale * (x + loc)`, and
the convs before it keep their bias.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from dpm_solver_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

BN_MOMENTUM, BN_EPS = 0.9, 1e-5


@torch.no_grad()
def gan_conv_init_(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """`weights_init` for a conv: N(0, 0.02)."""
    return weight.copy_(0.02 * torch.randn(weight.shape, generator=generator,
                                           device=generator.device))


@torch.no_grad()
def bn_scale_init_(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """`weights_init` for a BatchNorm scale: N(1, 0.02) (its bias 0)."""
    return weight.copy_(1.0 + 0.02 * torch.randn(weight.shape, generator=generator,
                                                 device=generator.device))


class BatchNorm(nn.BatchNorm2d):
    """flax's training-mode BatchNorm over an NCHW map's channels: taming's
    `BatchNorm2d` parameters and buffers (so its state dicts load), flax's
    arithmetic (`functional`); torch's own forward is not used."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=BN_EPS)

    def functional(self, x: torch.Tensor, mean_run: torch.Tensor, var_run: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(y, running mean, running var) for fp32 x, from the running moments given."""
        mean = x.mean((0, 2, 3))
        var = torch.clamp((x * x).mean((0, 2, 3)) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        mean, var = mean.detach(), var.detach()
        return (y, BN_MOMENTUM * mean_run + (1.0 - BN_MOMENTUM) * mean,
                BN_MOMENTUM * var_run + (1.0 - BN_MOMENTUM) * var)


class ActNorm(nn.Module):
    """taming's ActNorm, `scale * (x + loc)` per channel (loc and scale
    (1, C, 1, 1); logdet unused). taming initialises them from the first
    batch; here they are explicit (`actnorm_stats_from_batch` gives that
    initialisation; identity otherwise)."""

    def __init__(self, channels: int):
        super().__init__()
        self.loc = nn.Parameter(torch.zeros(1, channels, 1, 1))
        self.scale = nn.Parameter(torch.ones(1, channels, 1, 1))
        self.register_buffer("initialized", torch.tensor(1, dtype=torch.uint8))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.scale * (x + self.loc)


def actnorm_stats_from_batch(x: torch.Tensor, epsilon: float = 1e-6
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loc, scale) per channel of NHWC `x` as taming's ActNorm initialises
    them from a batch: -mean and 1 / (std + eps), std Bessel-corrected."""
    x = x.float()
    dims = tuple(range(x.dim() - 1))
    return -x.mean(dims), 1.0 / (x.std(dims, correction=1) + epsilon)


class NLayerDiscriminator(nn.Module):
    """NHWC images -> (B, H', W', 1) fp32 patch logits (module docstring).
    Built on `device`, the card by default."""

    def __init__(self, ndf: int = 64, n_layers: int = 3, use_actnorm: bool = False,
                 input_nc: int = 3, device=DEFAULT_DEVICE):
        super().__init__()
        self.n_layers = n_layers
        norm = ActNorm if use_actnorm else BatchNorm
        with torch.device(resolve_device(device)):
            layers = [nn.Conv2d(input_nc, ndf, 4, 2, 1), nn.LeakyReLU(0.2)]
            ch = ndf
            for n in range(1, n_layers + 1):
                out = ndf * min(2 ** n, 8)
                layers += [nn.Conv2d(ch, out, 4, 2 if n < n_layers else 1, 1, bias=use_actnorm),
                           norm(out), nn.LeakyReLU(0.2)]
                ch = out
            layers.append(nn.Conv2d(ch, 1, 4, 1, 1))
            self.main = nn.Sequential(*layers)

    def batch_stats(self) -> Dict[str, torch.Tensor]:
        """The running moments, by state-dict name (`main.{i}.running_mean`,
        `main.{i}.running_var`): the module's own buffers (empty for ActNorm)."""
        return {f"main.{i}.{leaf}": getattr(m, leaf) for i, m in enumerate(self.main)
                if isinstance(m, BatchNorm) for leaf in ("running_mean", "running_var")}

    def forward(self, x: torch.Tensor, batch_stats: Optional[Mapping[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(logits, the running moments after this batch) from `batch_stats`
        (the module's own buffers when None), which are not changed."""
        stats = dict(self.batch_stats() if batch_stats is None else batch_stats)
        h = x.float().permute(0, 3, 1, 2)
        for i, m in enumerate(self.main):
            if isinstance(m, BatchNorm):
                mk, vk = f"main.{i}.running_mean", f"main.{i}.running_var"
                h, stats[mk], stats[vk] = m.functional(h, stats[mk], stats[vk])
            else:
                h = m(h)
        return h.permute(0, 2, 3, 1), stats


__all__ = ["ActNorm", "BatchNorm", "NLayerDiscriminator", "actnorm_stats_from_batch",
           "bn_scale_init_", "gan_conv_init_"]
