"""Noise-conditional WideResNet classifier (score_sde's guidance classifier), on torch.

Port of `dpm_solver_tpu/models/wideresnet.py`, twin of score_sde_jax's
models/wideresnet_noise_conditional.py:122-330 and the logit/grad plumbing
of models/utils.py:267-329: a GroupNorm WideResNet (WRN-28-10 by default)
conditioned on log-sigma through Gaussian Fourier features, zero-pad/pool
residual matching, per-image standardization, CIFAR mean/std
preprocessing, and the class-conditional score gradient that
`controllable.get_pc_conditional_sampler` adds to the score.

Modules sit under the JAX module's names (`fourier`, `temb_0`,
`group1_block0.conv1`, ...): `utils/convert.py::
wideresnet_state_dict_from_flax` carries the JAX parameters across. NHWC,
fp32. The JAX model convolves with flax's `nn.Conv`, outside any Pallas
kernel, so every conv here is `F.conv2d`; a stride-2 conv pads as flax's
SAME does (0 before and 1 after on an even map, not 1 and 1).
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from dpm_solver_tpu_torch.models.ddpm_unet import GroupNorm32, swish
from dpm_solver_tpu_torch.models.ncsnpp import FourierFeatures
from dpm_solver_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

_CIFAR_MEAN = (0.49139968, 0.48215841, 0.44653091)
_CIFAR_STD = (0.24703223, 0.24348513, 0.26158784)


class GroupNorm(GroupNorm32):
    """flax `nn.GroupNorm(min(C // 4, 32), epsilon=1e-5)` on NHWC."""

    def __init__(self, channels: int):
        super().__init__(channels, groups=min(channels // 4, 32), eps=1e-5)


def _gn_relu(norm: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return F.relu(norm(x))


class SameConv(nn.Module):
    """A bias-free 3x3 flax `nn.Conv(padding="SAME")` of stride 1 or 2 on NHWC:
    the total padding max((ceil(n / s) - 1) * s + 3 - n, 0), its smaller half
    before."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, 3, 3))
        self.stride = stride
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = []
        for n in (x.shape[2], x.shape[1]):
            total = max((-(-n // self.stride) - 1) * self.stride + 3 - n, 0)
            pads += [total // 2, total - total // 2]
        out = F.conv2d(F.pad(x.permute(0, 3, 1, 2), pads), self.weight, stride=self.stride)
        return out.permute(0, 2, 3, 1)


def _residual_add(block_x: torch.Tensor, orig_x: torch.Tensor) -> torch.Tensor:
    """Pad channels with zeros / avg-pool spatially so shapes match
    (ref :210-226)."""
    stride = orig_x.shape[1] // block_x.shape[1]
    if stride > 1:
        orig_x = F.avg_pool2d(orig_x.permute(0, 3, 1, 2), stride, stride).permute(0, 2, 3, 1)
    extra = block_x.shape[-1] - orig_x.shape[-1]
    if extra > 0:
        orig_x = F.pad(orig_x, (0, extra))
    return block_x + orig_x


class WRNBlock(nn.Module):
    def __init__(self, in_ch: int, channels: int, stride: int = 1,
                 activate_before_residual: bool = False, temb_dim: int = 512):
        super().__init__()
        self.activate_before_residual = activate_before_residual
        self.init_bn = GroupNorm(in_ch)
        self.conv1 = SameConv(in_ch, channels, stride)
        self.temb_proj = nn.Linear(temb_dim, channels)
        self.bn_2 = GroupNorm(channels)
        self.conv2 = SameConv(channels, channels)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        if self.activate_before_residual:
            x = _gn_relu(self.init_bn, x)
        orig_x = x
        block_x = x if self.activate_before_residual else _gn_relu(self.init_bn, x)
        block_x = self.conv1(block_x) + self.temb_proj(swish(temb))[:, None, None, :]
        block_x = self.conv2(_gn_relu(self.bn_2, block_x))
        return _residual_add(block_x, orig_x)


class WideResNetClassifier(nn.Module):
    """x NHWC (preprocessed), sigmas (B,) -> (B, num_outputs) logits. Built
    on `device`, the card by default (raises when there is none), in eval
    mode; the Fourier features' W is frozen."""

    def __init__(self, blocks_per_group: int = 4, channel_multiplier: int = 10,
                 num_outputs: int = 10, device=DEFAULT_DEVICE):
        super().__init__()
        self.blocks_per_group = blocks_per_group
        with torch.device(resolve_device(device)):
            self.fourier = FourierFeatures(128, 16.0)
            self.temb_0 = nn.Linear(256, 512)
            self.temb_1 = nn.Linear(512, 512)
            self.init_conv = SameConv(3, 16)
            ch = 16
            for g, (width, stride, abr) in enumerate([
                    (16 * channel_multiplier, 1, True),
                    (32 * channel_multiplier, 2, False),
                    (64 * channel_multiplier, 2, False)]):
                for i in range(blocks_per_group):
                    self.add_module(f"group{g}_block{i}", WRNBlock(
                        ch, width, stride if i == 0 else 1,
                        activate_before_residual=abr and i == 0))
                    ch = width
            self.pre_pool_bn = GroupNorm(ch)
            self.logits = nn.Linear(ch, num_outputs)
        self.eval()

    def forward(self, x: torch.Tensor, sigmas: torch.Tensor) -> torch.Tensor:
        n = math.prod(x.shape[1:])
        std, mean = torch.std_mean(x, dim=(1, 2, 3), keepdim=True, correction=0)
        x = (x - mean) / torch.clamp(std, min=1.0 / math.sqrt(n))
        temb = self.temb_0(self.fourier(torch.log(sigmas)))
        temb = self.temb_1(swish(temb))
        x = self.init_conv(x)
        for g in range(3):
            for i in range(self.blocks_per_group):
                x = getattr(self, f"group{g}_block{i}")(x, temb)
        x = _gn_relu(self.pre_pool_bn, x).mean(dim=(1, 2))
        return self.logits(x)


def get_logit_fn(classifier: WideResNetClassifier) -> Callable:
    """CIFAR-standardized logits (ref models/utils.py:293-315):
    logit_fn(data, ve_noise_scale)."""

    def logit_fn(data, ve_noise_scale):
        mean = torch.tensor(_CIFAR_MEAN, dtype=data.dtype, device=data.device)
        std = torch.tensor(_CIFAR_STD, dtype=data.dtype, device=data.device)
        return classifier((data - mean) / std, ve_noise_scale)

    return logit_fn


def get_classifier_grad_fn(logit_fn: Callable) -> Callable:
    """grad_x log p(y | x, sigma) (ref models/utils.py:318-329), by autograd
    of the summed log-softmax at the labels; plugs into
    `controllable.get_pc_conditional_sampler` as classifier_grad_fn(x, t, y)
    once t is mapped to the VE noise scale. Freeze the classifier
    (`requires_grad_(False)`), or each call computes its weight gradients."""

    def grad_fn(data, ve_noise_scale, labels):
        with torch.enable_grad():
            d = data.detach().requires_grad_(True)
            lp = torch.log_softmax(logit_fn(d, ve_noise_scale), dim=-1)
            picked = lp[torch.arange(labels.shape[0], device=lp.device), labels].sum()
            return torch.autograd.grad(picked, d)[0]

    return grad_fn
