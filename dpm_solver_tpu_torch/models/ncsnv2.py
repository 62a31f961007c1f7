"""NCSNv2 / NCSNv1 (RefineNet score networks) in PyTorch, NHWC.

Port of `dpm_solver_tpu/models/ncsnv2.py`, twin of the reference legacy
score models (score_sde_jax/models/ncsnv2.py:45-200, the RefineNet blocks of
models/layers.py:117-441, InstanceNorm++ of models/normalization.py:81-140):
a dilated ResNet backbone, a RefineNet decoder (RCU / MSF / CRP blocks),
InstanceNorm++, a geometric sigma ladder indexed by integer labels. NCSNv1
is the class-conditional-normalization variant (`conditional_norm=True`:
ConditionalInstanceNorm++ with a per-label (gamma, alpha, beta)).

Every module sits under the JAX module's name (`conv_in`, `level1_down`,
`refine0.rcu_in0.conv2`, ...), so `utils/convert.py::
ncsnv2_state_dict_from_flax` is a rename and a transpose; the score_sde
reference's auto-numbered tree maps onto those names through
`ncsnv2_params_from_reference`. Activations are NHWC, as the port's other
score models take them; the network computes in fp32.

Where the kernels run: nowhere. The JAX model convolves with flax's
`nn.Conv`, outside any Pallas kernel, so every conv here is `F.conv2d`
(cuDNN on the card).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dpm_solver_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from dpm_solver_tpu_torch.utils.resize import resize


def get_sigmas(sigma_min: float, sigma_max: float, num_scales: int) -> np.ndarray:
    """Geometric, descending (ref models/utils.py get_sigmas)."""
    return np.exp(np.linspace(np.log(sigma_max), np.log(sigma_min),
                              num_scales)).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class NCSNv2Config:
    nf: int = 128
    image_size: int = 32
    channels: int = 3
    centered: bool = False
    scale_by_sigma: bool = True
    sigma_min: float = 0.01
    sigma_max: float = 50.0
    num_scales: int = 232
    interpolation: str = "bilinear"
    conditional_norm: bool = False  # True -> NCSNv1
    # pyramid: per level (channel mult, dilation); level 0 is never
    # downsampled. Defaults are the 32px NCSNv2 (ref ncsnv2.py:45-113);
    # the 128/256px variants deepen these (ref :202-356).
    level_specs: Tuple[Tuple[int, int], ...] = ((1, 1), (2, 1), (2, 2), (2, 4))
    refine_mults: Tuple[int, ...] = (2, 2, 2, 1)

    @staticmethod
    def cifar10() -> "NCSNv2Config":
        return NCSNv2Config()

    @staticmethod
    def px128() -> "NCSNv2Config":
        return NCSNv2Config(
            image_size=128,
            level_specs=((1, 1), (2, 1), (2, 1), (4, 2), (4, 4)),
            refine_mults=(4, 2, 2, 1, 1))

    @staticmethod
    def px256() -> "NCSNv2Config":
        return NCSNv2Config(
            image_size=256,
            level_specs=((1, 1), (2, 1), (2, 1), (2, 1), (4, 2), (4, 4)),
            refine_mults=(4, 2, 2, 2, 1, 1))

    @staticmethod
    def tiny(**overrides) -> "NCSNv2Config":
        base = dict(nf=16, image_size=16, num_scales=10)
        base.update(overrides)
        return NCSNv2Config(**base)


class NCSNConv(nn.Module):
    """flax `nn.Conv` with SAME padding and dilation, on NHWC: weight (out,
    in, k, k), padding dilation * (k // 2) each side."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, dilation: int = 1,
                 bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        self.dilation, self.padding = dilation, dilation * (kernel // 2)
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.conv2d(x.permute(0, 3, 1, 2), self.weight, self.bias,
                       padding=self.padding, dilation=self.dilation)
        return out.permute(0, 2, 3, 1)


def _instance_stats(x: torch.Tensor):
    """InstanceNorm++'s shared part: x standardised per instance and channel,
    and the per-channel means standardised across the channels (population
    variances, as `jnp.var`)."""
    means = x.mean(dim=(1, 2))
    v, m = torch.var_mean(means, dim=-1, keepdim=True, correction=0)
    means_plus = (means - m) / torch.sqrt(v + 1e-5)
    h = (x - means[:, None, None, :]) / torch.sqrt(
        torch.var(x, dim=(1, 2), keepdim=True, correction=0) + 1e-5)
    return h, means_plus[:, None, None, :]


class InstanceNormPlus(nn.Module):
    """InstanceNorm++ (ref normalization.py:81-104): instance norm with the
    per-channel means re-injected after standardizing them across channels."""

    def __init__(self, channels: int, bias: bool = True):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(channels))
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels)) if bias else None

    def forward(self, x: torch.Tensor, y: Optional[torch.Tensor] = None) -> torch.Tensor:
        h, means_plus = _instance_stats(x)
        h = (h + means_plus * self.alpha) * self.gamma
        return h if self.beta is None else h + self.beta


class CondInstanceNormPlus(nn.Module):
    """Class-conditional InstanceNorm++ (ref normalization.py:107-140):
    (gamma, alpha, beta) looked up from a per-label embedding."""

    def __init__(self, channels: int, num_classes: int, bias: bool = True):
        super().__init__()
        self.channels, self.bias = channels, bias
        self.embed = nn.Embedding(num_classes, (3 if bias else 2) * channels)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        h, means_plus = _instance_stats(x)
        parts = torch.split(self.embed(y), self.channels, dim=-1)
        gamma, alpha = parts[0][:, None, None, :], parts[1][:, None, None, :]
        # gamma scales the alpha-reinjected activation too (normalization.py:138)
        out = gamma * (h + means_plus * alpha)
        return out + parts[2][:, None, None, :] if self.bias else out


def _mean_pool(x):
    return (x[:, ::2, ::2] + x[:, 1::2, ::2] + x[:, ::2, 1::2]
            + x[:, 1::2, 1::2]) / 4.0


class NCSNResBlock(nn.Module):
    """Dilated/resampled residual block (ref layers.py:354-441, both the
    unconditional and the conditional variants). The backbone convs keep
    their biases; only RefineNet's RCU/CRP convs are bias-free."""

    def __init__(self, in_dim: int, out_dim: int, make_norm, resample: Optional[str] = None,
                 dilation: int = 1):
        super().__init__()
        self.resample, self.dilation = resample, dilation
        conv = functools.partial(NCSNConv, dilation=dilation)
        self.norm1 = make_norm(in_dim)
        if resample == "down":
            self.conv1 = conv(in_dim, in_dim)
            self.norm2 = make_norm(in_dim)
            self.conv2 = conv(in_dim, out_dim)
        else:
            self.conv1 = conv(in_dim, out_dim)
            self.norm2 = make_norm(out_dim)
            self.conv2 = conv(out_dim, out_dim)
        if resample == "down" or out_dim != in_dim:
            # a dilated 3x3 where the block dilates, else a 1x1
            self.shortcut = conv(in_dim, out_dim) if dilation > 1 else NCSNConv(
                in_dim, out_dim, kernel=1)

    def forward(self, x: torch.Tensor, y: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = F.elu(self.norm1(x, y))
        if self.resample == "down":
            h = F.elu(self.norm2(self.conv1(h), y))
            if self.dilation > 1:
                return self.conv2(h) + self.shortcut(x)
            return _mean_pool(self.conv2(h)) + _mean_pool(self.shortcut(x))
        shortcut = self.shortcut(x) if hasattr(self, "shortcut") else x
        h = self.conv2(F.elu(self.norm2(self.conv1(h), y)))
        return h + shortcut


class RCU(nn.Module):
    """Residual conv units (ref layers.py:154-170); bias-free convs."""

    def __init__(self, features: int, n_blocks: int = 2, n_stages: int = 2, make_norm=None):
        super().__init__()
        self.n_blocks, self.n_stages = n_blocks, n_stages
        n = n_blocks * n_stages
        for i in range(n):
            if make_norm is not None:
                self.add_module(f"norm{i}", make_norm(features))
            self.add_module(f"conv{i}", NCSNConv(features, features, bias=False))
        self.normed = make_norm is not None

    def forward(self, x: torch.Tensor, y: Optional[torch.Tensor] = None) -> torch.Tensor:
        i = 0
        for _ in range(self.n_blocks):
            residual = x
            for _ in range(self.n_stages):
                if self.normed:
                    x = getattr(self, f"norm{i}")(x, y)
                x = getattr(self, f"conv{i}")(F.elu(x))
                i += 1
            x = x + residual
        return x


class CRP(nn.Module):
    """Chained residual pooling (ref layers.py:117-150): 5x5 stride-1 SAME
    pooling, max in v2, average (the padding counted, flax's default) in the
    conditional v1."""

    def __init__(self, features: int, n_stages: int = 2, make_norm=None):
        super().__init__()
        self.n_stages, self.normed = n_stages, make_norm is not None
        for i in range(n_stages):
            if make_norm is not None:
                self.add_module(f"norm{i}", make_norm(features))
            self.add_module(f"conv{i}", NCSNConv(features, features, bias=False))

    def forward(self, x: torch.Tensor, y: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = F.elu(x)
        path = x
        for i in range(self.n_stages):
            if self.normed:
                path = getattr(self, f"norm{i}")(path, y).permute(0, 3, 1, 2)
                path = F.avg_pool2d(path, 5, stride=1, padding=2, count_include_pad=True)
            else:
                path = F.max_pool2d(path.permute(0, 3, 1, 2), 5, stride=1, padding=2)
            path = getattr(self, f"conv{i}")(path.permute(0, 2, 3, 1))
            x = path + x
        return x


class MSF(nn.Module):
    """Multi-scale fusion (ref layers.py:173-229): each input convolved to
    `features` and resized (`jax.image.resize`'s semantics) to the first's
    size, then summed."""

    def __init__(self, in_channels, features: int, interpolation: str = "bilinear",
                 make_norm=None):
        super().__init__()
        self.method = {"bilinear": "bilinear", "nearest_neighbor": "nearest"}[interpolation]
        self.normed = make_norm is not None
        for i, c in enumerate(in_channels):
            if make_norm is not None:
                self.add_module(f"norm{i}", make_norm(c))
            self.add_module(f"conv{i}", NCSNConv(c, features))

    def forward(self, xs, shape, y: Optional[torch.Tensor] = None) -> torch.Tensor:
        total = 0.0
        for i, xi in enumerate(xs):
            if self.normed:
                xi = getattr(self, f"norm{i}")(xi, y)
            total = total + resize(getattr(self, f"conv{i}")(xi), shape, self.method)
        return total


class RefineBlock(nn.Module):
    """RefineNet block: per-input RCUs -> MSF -> CRP -> output RCU
    (ref layers.py:232-309); its size is its first input's."""

    def __init__(self, in_channels, features: int, start: bool = False, end: bool = False,
                 interpolation: str = "bilinear", make_norm=None):
        super().__init__()
        self.start = start
        for i, c in enumerate(in_channels):
            self.add_module(f"rcu_in{i}", RCU(c, 2, 2, make_norm))
        if not start:
            self.msf = MSF(in_channels, features, interpolation, make_norm)
        self.crp = CRP(features, 2, make_norm)
        self.rcu_out = RCU(features, 3 if end else 1, 2, make_norm)

    def forward(self, xs, y: Optional[torch.Tensor] = None) -> torch.Tensor:
        hs = [getattr(self, f"rcu_in{i}")(xi, y) for i, xi in enumerate(xs)]
        h = hs[0] if self.start else self.msf(hs, tuple(xs[0].shape[1:3]), y)
        return self.rcu_out(self.crp(h, y), y)


class NCSNv2(nn.Module):
    """x NHWC (B, H, W, C), labels (B,) integer sigma indices -> score (ref
    ncsnv2.py:45-113; `conditional_norm=True` gives NCSNv1, :116-200). Built
    on `device`, the card by default (raises when there is none)."""

    def __init__(self, config: NCSNv2Config, device=DEFAULT_DEVICE):
        super().__init__()
        with torch.device(resolve_device(device)):
            self._construct(config)
        self.eval()

    def _construct(self, cfg: NCSNv2Config):
        self.config = cfg
        if cfg.conditional_norm:
            make_norm = functools.partial(CondInstanceNormPlus, num_classes=cfg.num_scales)
        else:
            make_norm = InstanceNormPlus
        self.register_buffer("sigmas", torch.tensor(
            get_sigmas(cfg.sigma_min, cfg.sigma_max, cfg.num_scales)))
        nf = cfg.nf
        self.conv_in = NCSNConv(cfg.channels, nf)
        ch, level_ch = nf, []
        for i, (mult, dil) in enumerate(cfg.level_specs):
            if i == 0:
                self.level0_pre = NCSNResBlock(ch, mult * nf, make_norm)
            else:
                self.add_module(f"level{i}_down", NCSNResBlock(
                    ch, mult * nf, make_norm, resample="down", dilation=dil))
            ch = mult * nf
            self.add_module(f"level{i}_res", NCSNResBlock(ch, ch, make_norm, dilation=dil))
            level_ch.append(ch)
        n_levels = len(cfg.level_specs)
        ref_norm = make_norm if cfg.conditional_norm else None
        r_ch = None
        for j, mult in enumerate(cfg.refine_mults):
            i = n_levels - 1 - j
            ins = [level_ch[i]] if r_ch is None else [level_ch[i], r_ch]
            self.add_module(f"refine{j}", RefineBlock(
                ins, mult * nf, start=(j == 0), end=(j == n_levels - 1),
                interpolation=cfg.interpolation, make_norm=ref_norm))
            r_ch = mult * nf
        self.norm_out = make_norm(r_ch)
        self.conv_out = NCSNConv(r_ch, cfg.channels)

    def forward(self, x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        labels = labels.long()
        y = labels if cfg.conditional_norm else None
        h = x if cfg.centered else 2.0 * x - 1.0
        h = self.conv_in(h)
        layers = []
        for i in range(len(cfg.level_specs)):
            h = (self.level0_pre(h, y) if i == 0
                 else getattr(self, f"level{i}_down")(layers[-1], y))
            h = getattr(self, f"level{i}_res")(h, y)
            layers.append(h)
        r = None
        for j in range(len(cfg.refine_mults)):
            i = len(cfg.level_specs) - 1 - j
            r = getattr(self, f"refine{j}")([layers[i]] if r is None else [layers[i], r], y)
        h = self.conv_out(F.elu(self.norm_out(r, y)))
        if cfg.scale_by_sigma:
            h = h / self.sigmas[labels].reshape(-1, *([1] * (x.dim() - 1)))
        return h


def ncsnv2_params_from_reference(ref_params, cfg: NCSNv2Config) -> dict:
    """Reference score_sde_jax NCSNv2 auto-numbered tree (nested dicts of
    arrays) -> the JAX package's layout, `{"params": ...}` (unconditional
    variant; the reference NCSNv1 forward is unrunnable: its conditional
    'down' resblock calls the normalizer partial without constructing it,
    score_sde_jax/models/layers.py:413). The port's copy of
    `dpm_solver_tpu/models/ncsnv2.py:371-438`; feed the result to
    `utils/convert.py::ncsnv2_state_dict_from_flax`."""
    assert not cfg.conditional_norm
    ref = ref_params.get("params", ref_params)

    def resblock(sub, *, resample, dilation, has_shortcut):
        out = {"norm1": dict(sub["InstanceNorm2dPlus_0"]),
               "norm2": dict(sub["InstanceNorm2dPlus_1"])}
        c = 0
        if resample == "down":
            out["conv1"] = dict(sub[f"Conv_{c}"]); c += 1
            if dilation > 1:
                out["conv2"] = dict(sub[f"Conv_{c}"]); c += 1
                out["shortcut"] = dict(sub[f"Conv_{c}"])
            else:
                out["conv2"] = dict(sub["ConvMeanPool_0"]["Conv_0"])
                out["shortcut"] = dict(sub["ConvMeanPool_1"]["Conv_0"])
        else:
            if has_shortcut:
                out["shortcut"] = dict(sub[f"Conv_{c}"]); c += 1
            out["conv1"] = dict(sub[f"Conv_{c}"]); c += 1
            out["conv2"] = dict(sub[f"Conv_{c}"])
        return out

    def rcu(sub, n):
        return {f"conv{i}": dict(sub[f"Conv_{i}"]) for i in range(n)}

    def refine(sub, n_inputs, end):
        out = {}
        for i in range(n_inputs):
            out[f"rcu_in{i}"] = rcu(sub[f"RCUBlock_{i}"], 4)
        if n_inputs > 1:
            out["msf"] = {f"conv{i}": dict(sub["MSFBlock_0"][f"Conv_{i}"])
                          for i in range(n_inputs)}
        out["crp"] = {f"conv{i}": dict(sub["CRPBlock_0"][f"Conv_{i}"]) for i in range(2)}
        out["rcu_out"] = rcu(sub[f"RCUBlock_{n_inputs}"], (3 if end else 1) * 2)
        return out

    p = {"conv_in": dict(ref["Conv_0"])}
    rb_i = 0
    for i, (mult, dil) in enumerate(cfg.level_specs):
        if i == 0:
            p["level0_pre"] = resblock(
                ref[f"ResidualBlock_{rb_i}"], resample=None, dilation=1,
                has_shortcut="Conv_2" in ref[f"ResidualBlock_{rb_i}"])
        else:
            p[f"level{i}_down"] = resblock(
                ref[f"ResidualBlock_{rb_i}"], resample="down", dilation=dil, has_shortcut=True)
        rb_i += 1
        p[f"level{i}_res"] = resblock(
            ref[f"ResidualBlock_{rb_i}"], resample=None, dilation=dil, has_shortcut=False)
        rb_i += 1

    n_levels = len(cfg.level_specs)
    for j in range(len(cfg.refine_mults)):
        p[f"refine{j}"] = refine(ref[f"RefineBlock_{j}"], 1 if j == 0 else 2,
                                 end=(j == n_levels - 1))
    p["norm_out"] = dict(ref["InstanceNorm2dPlus_0"])
    p["conv_out"] = dict(ref["Conv_1"])
    return {"params": p}
