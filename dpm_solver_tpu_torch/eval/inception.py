"""InceptionV3, the FID variant, on NHWC tensors: the FID/IS feature extractor.

Port of `dpm_solver_tpu/eval/inception.py`, the architecture twin of the
reference's torch port (examples/ddpm_and_guided-diffusion/evaluate/
inception.py:16-328, the pytorch-fid network): torchvision's InceptionV3
with the FID changes (`count_include_pad=False` average pools in the A, C
and E_1 blocks, a max-pool branch with pad 1 in E_2, 1008-way logits) and
the reference's input handling (a bilinear resize to 299 x 299, as
`jax.image.resize` computes it, antialiased when shrinking:
`utils/resize.py`; [0, 1] -> [-1, 1]).

The convs are `F.conv2d` (the library conv; the JAX package leaves them to
flax's `nn.Conv`), in fp32; BatchNorm is inference-only, its running
statistics with eps 1e-3, `(x - mean) * rsqrt(var + 1e-3) * weight + bias`
as in the JAX model. Parameter names are pt_inception-2015-12-05's
(`Mixed_5b.branch1x1.conv.weight`, `Mixed_5b.branch1x1.bn.running_var`,
`fc.weight`), so that checkpoint loads with `load_state_dict`; it is not in
the repo (the image has no network), and `random_feature_params` gives the
JAX package's random weights for runs without it.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dpm_solver_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from dpm_solver_tpu_torch.utils.resize import resize


class BasicConv2d(nn.Module):
    """Conv (no bias) + inference BatchNorm(eps 1e-3) + ReLU (torchvision's)."""

    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bn = self.bn
        x = self.conv(x)
        scale = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
        return F.relu((x - bn.running_mean[:, None, None]) * scale[:, None, None]
                      + bn.bias[:, None, None])


def _avgpool3(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 average pool, pad 1, padding not counted (the FID
    variant, ref inception.py:216-233)."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), self.branch5x5_2(self.branch5x5_1(x)), b3,
                          self.branch_pool(_avgpool3(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avgpool3(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7,
                          F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    """E_1 (`max_pool=False`: the FID average pool) or E_2 (the max-pool
    branch, pad 1; ref inception.py:264-328)."""

    def __init__(self, cin: int, max_pool: bool):
        super().__init__()
        self.max_pool = max_pool
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = F.max_pool2d(x, 3, stride=1, padding=1) if self.max_pool else _avgpool3(x)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


class FIDInceptionV3(nn.Module):
    """NHWC images -> (pool3 features (B, 2048), logits (B, 1008)).
    `resize_input` resizes to 299 x 299 (bilinear, `jax.image.resize`'s);
    `normalize_input` maps [0, 1] to [-1, 1] (ref inception.py:129-163).
    Built on `device`, the card by default."""

    def __init__(self, resize_input: bool = True, normalize_input: bool = True,
                 device=DEFAULT_DEVICE):
        super().__init__()
        self.resize_input, self.normalize_input = resize_input, normalize_input
        with torch.device(resolve_device(device)):
            self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
            self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
            self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
            self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
            self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
            self.Mixed_5b = InceptionA(192, 32)
            self.Mixed_5c = InceptionA(256, 64)
            self.Mixed_5d = InceptionA(288, 64)
            self.Mixed_6a = InceptionB(288)
            self.Mixed_6b = InceptionC(768, 128)
            self.Mixed_6c = InceptionC(768, 160)
            self.Mixed_6d = InceptionC(768, 160)
            self.Mixed_6e = InceptionC(768, 192)
            self.Mixed_7a = InceptionD(768)
            self.Mixed_7b = InceptionE(1280, max_pool=False)
            self.Mixed_7c = InceptionE(2048, max_pool=True)
            self.fc = nn.Linear(2048, 1008)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.float()
        if self.resize_input:
            x = resize(x, (299, 299), "bilinear")
        if self.normalize_input:
            x = 2.0 * x - 1.0
        x = x.permute(0, 3, 1, 2)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for name in ("5b", "5c", "5d", "6a", "6b", "6c", "6d", "6e", "7a", "7b", "7c"):
            x = getattr(self, f"Mixed_{name}")(x)
        feats = x.mean(dim=(2, 3))  # the adaptive average pool to 1 x 1
        return feats, self.fc(feats)


# the JAX model's leaf names -> this model's, per ConvBN
_BN_LEAVES = {"bn_bias": "bn.bias", "bn_mean": "bn.running_mean", "bn_scale": "bn.weight",
              "bn_var": "bn.running_var"}


def _flax_leaves(model: FIDInceptionV3):
    """(Flax path, Flax-layout shape, state-dict key) of every parameter of
    the JAX FIDInceptionV3, in the order `jax.tree_util` flattens its params
    (each dict's keys sorted)."""
    out = []
    for name, mod in model.named_modules():
        if isinstance(mod, BasicConv2d):
            parts = tuple(name.split("."))
            c = mod.conv.weight.shape[0]
            for leaf, key in _BN_LEAVES.items():
                out.append((parts + (leaf,), (c,), f"{name}.{key}"))
            o, i, kh, kw = mod.conv.weight.shape
            out.append((parts + ("conv", "kernel"), (kh, kw, i, o), f"{name}.conv.weight"))
    out.append((("fc", "bias"), (1008,), "fc.bias"))
    out.append((("fc", "kernel"), (2048, 1008), "fc.weight"))
    return sorted(out)


def random_feature_params(seed: int = 0) -> Dict[str, torch.Tensor]:
    """The JAX package's random FIDInceptionV3 weights (`random_feature_params`,
    for runs without the pt_inception checkpoint; its FIDs are pipeline
    statistics, not comparable to published numbers), as this model's state
    dict: drawn with NumPy from `seed` in the JAX tree's leaf order, BN
    variances U(0.3, 1.7), scales N(1, 0.2), means and biases N(0, 0.2),
    kernels N(0, 1 / fan_in); the same values, so the same features. Flax's
    default init leaves every folded BatchNorm at the identity, and 94
    stacked conv + BN + ReLU layers then collapse the features to a near
    constant; randomised statistics keep them apart."""
    rng = np.random.default_rng(seed)
    out = {}
    with torch.device("meta"):
        model = FIDInceptionV3(device="meta")
    for path, shape, key in _flax_leaves(model):
        name = path[-1]
        if name == "bn_var":
            a = rng.uniform(0.3, 1.7, shape)
        elif name == "bn_scale":
            a = rng.normal(1.0, 0.2, shape)
        elif name in ("bn_mean", "bn_bias", "bias"):
            a = rng.normal(0.0, 0.2, shape)
        else:
            fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
            a = rng.normal(0.0, 1.0 / np.sqrt(fan_in), shape)
        a = np.asarray(a, np.float32)
        if name == "kernel":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
        out[key] = torch.from_numpy(np.ascontiguousarray(a))
    for name, mod in model.named_modules():
        if isinstance(mod, BasicConv2d):
            out[f"{name}.bn.num_batches_tracked"] = torch.tensor(0)
    return out


def make_feature_fn(state_dict: Dict[str, torch.Tensor], *, resize_input: bool = True,
                    normalize_input: bool = True, device=DEFAULT_DEVICE) -> Callable:
    """fn(images (B, H, W, 3) in [0, 1], numpy or a tensor) -> (features,
    logits) on `device`: the extractor the FID/IS pipeline maps over sample
    batches, a frozen `FIDInceptionV3` holding `state_dict`."""
    dev = resolve_device(device)
    model = FIDInceptionV3(resize_input, normalize_input, device=dev)
    model.load_state_dict(state_dict)
    model.eval().requires_grad_(False)

    def fn(images):
        with torch.no_grad():
            return model(torch.as_tensor(images, device=dev))

    return fn


__all__ = ["BasicConv2d", "FIDInceptionV3", "make_feature_fn", "random_feature_params"]
