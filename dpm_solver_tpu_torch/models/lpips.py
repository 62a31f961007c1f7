"""LPIPS perceptual distance (VGG16 backbone) on NHWC tensors.

Port of `dpm_solver_tpu/models/lpips.py`, the twin of the
`taming.modules.losses.lpips.LPIPS` network that the reference's
first-stage losses use (ldm/modules/losses/contperceptual.py:17,
vqperceptual.py:57):

  * inputs in [-1, 1]; the ScalingLayer's fixed shift and scale;
  * torchvision VGG16's `features` trunk, tapped after relu1_2, relu2_2,
    relu3_3, relu4_3 and relu5_3;
  * each tap unit-normalised over its channels at each position (fp32, eps
    1e-10);
  * the squared difference through a 1x1 bias-free head per tap
    (`lin{k}`), its spatial mean, summed over the five taps: (B, 1, 1, 1).

The trunk's convs are `nn.Conv2d` (the library conv), as the JAX package
leaves them to flax's `nn.Conv` outside any kernel; the network runs in
fp32. Parameter names are taming's (`net.slice{s}.{i}`, torchvision's
layer index i inside each slice; `lin{k}.model.1.weight` (1, C, 1, 1)), and
`load_state_dict` also takes a torchvision VGG16 (`features.{i}`) with
`lin{k}.weight` heads, as `convert_torch_lpips` does.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from dpm_solver_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

# the RGB shift and scale of LPIPS' ScalingLayer (fixed, not learned)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# torchvision VGG16 `features` conv indices of each slice, with their widths
_VGG_SLICES: Tuple[Tuple[Tuple[int, int], ...], ...] = (
    ((0, 64), (2, 64)),
    ((5, 128), (7, 128)),
    ((10, 256), (12, 256), (14, 256)),
    ((17, 512), (19, 512), (21, 512)),
    ((24, 512), (26, 512), (28, 512)),
)
LPIPS_CHANNELS: Tuple[int, ...] = tuple(s[-1][1] for s in _VGG_SLICES)


class VGG16Features(nn.Module):
    """VGG16's `features` trunk as taming's five slices (`slice{s}.{i}`,
    each conv followed by its ReLU, a 2x2/2 max-pool before slices 2-5);
    NHWC in, the five taps NCHW out."""

    def __init__(self):
        super().__init__()
        in_ch = 3
        for si, convs in enumerate(_VGG_SLICES):
            layers = nn.Sequential()
            if si > 0:
                layers.add_module(str(convs[0][0] - 1), nn.MaxPool2d(2, 2))
            for idx, width in convs:
                layers.add_module(str(idx), nn.Conv2d(in_ch, width, 3, padding=1))
                layers.add_module(str(idx + 1), nn.ReLU())
                in_ch = width
            setattr(self, f"slice{si + 1}", layers)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        h, taps = x.permute(0, 3, 1, 2), []
        for si in range(len(_VGG_SLICES)):
            h = getattr(self, f"slice{si + 1}")(h)
            taps.append(h)
        return tuple(taps)


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """x / (||x||_channels + eps) at each position (LPIPS `normalize_tensor`), fp32."""
    x = x.float()
    return x / (torch.sqrt(torch.sum(x * x, dim=1, keepdim=True)) + eps)


class NetLinLayer(nn.Module):
    """taming's head: (Dropout, 1x1 conv to one channel, no bias); the
    dropout is the identity, LPIPS running in eval mode only."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), nn.Conv2d(channels, 1, 1, bias=False))


def lpips_state_dict(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A taming LPIPS state dict (`net.slice{s}.{i}.*`, `lin{k}.model.1.weight`
    or `lins.{k}.model.1.weight`), or a torchvision VGG16 (`features.{i}.*`)
    with `lin{k}.weight` heads, in `LPIPS`'s own names. Other keys (the
    ScalingLayer's buffers, VGG's classifier) are dropped."""
    def get(*names):
        for n in names:
            if n in state_dict:
                return torch.as_tensor(state_dict[n])
        raise KeyError(f"none of {names} in the state dict")

    out = {}
    for si, convs in enumerate(_VGG_SLICES):
        for idx, width in convs:
            for leaf in ("weight", "bias"):
                out[f"net.slice{si + 1}.{idx}.{leaf}"] = get(
                    f"net.slice{si + 1}.{idx}.{leaf}", f"features.{idx}.{leaf}")
    for k, c in enumerate(LPIPS_CHANNELS):
        out[f"lin{k}.model.1.weight"] = get(f"lin{k}.model.1.weight", f"lins.{k}.model.1.weight",
                                            f"lin{k}.weight").reshape(1, c, 1, 1)
    return out


class LPIPS(nn.Module):
    """Perceptual distance d(x, y) of NHWC RGB images in [-1, 1], (B, 1, 1, 1)
    (it broadcasts against a per-pixel loss, as in contperceptual.py:50-51).
    Built on `device`, the card by default."""

    def __init__(self, device=DEFAULT_DEVICE):
        super().__init__()
        dev = resolve_device(device)
        with torch.device(dev):
            self.net = VGG16Features()
            for k, c in enumerate(LPIPS_CHANNELS):
                setattr(self, f"lin{k}", NetLinLayer(c))
                nn.init.ones_(getattr(self, f"lin{k}").model[1].weight)
        self.register_buffer("shift", torch.as_tensor(_SHIFT, device=dev), persistent=False)
        self.register_buffer("scale", torch.as_tensor(_SCALE, device=dev), persistent=False)

    def load_state_dict(self, state_dict: Mapping[str, torch.Tensor], strict: bool = True,
                        assign: bool = False):
        """Either naming `lpips_state_dict` takes."""
        return super().load_state_dict(lpips_state_dict(state_dict), strict=strict, assign=assign)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        fx = self.net((x.float() - self.shift) / self.scale)
        fy = self.net((y.float() - self.shift) / self.scale)
        total = 0.0
        for k, (tx, ty) in enumerate(zip(fx, fy)):
            diff = torch.square(_unit_normalize(tx) - _unit_normalize(ty))
            w = getattr(self, f"lin{k}").model[1].weight.reshape(1, -1, 1, 1)
            score = torch.sum(diff * w, dim=1, keepdim=True)
            total = total + torch.mean(score, dim=(2, 3), keepdim=True)
        return total.permute(0, 2, 3, 1)


__all__ = ["LPIPS", "LPIPS_CHANNELS", "NetLinLayer", "VGG16Features", "lpips_state_dict"]
