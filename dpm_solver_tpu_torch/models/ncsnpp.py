"""NCSN++ / DDPM++ score network (Song et al. 2021) in PyTorch, NHWC.

Port of `dpm_solver_tpu/models/ncsnpp.py`, twin of the reference torch model
(score_sde_pytorch/models/ncsnpp.py:36-377 with layerspp.py). Parameter
names are the reference's state-dict keys: every layer sits in
`all_modules.<i>` in the reference constructor's order, under the reference
submodule names (`GroupNorm_0`, `Conv_0`, `Dense_0`, `NIN_0`..`NIN_3`,
`Conv2d_0`, `W`), with the reference layouts (conv weights OIHW, linear
weights (out, in), NIN weights (in, out)). A reference checkpoint is one
plain `load_state_dict`; `utils/convert.py::ncsnpp_state_dict_from_flax`
carries the JAX package's parameters across. As in the reference, the
parameter-free pyramid resamples of the `output_skip` / `input_skip` modes
are attributes, not list entries, while every other resample takes an index
whether it holds parameters or not; the `sigmas` buffer holds the discrete
sigma ladder.

Activations stay NHWC. Dtypes are placed as in the JAX model
(`compute_dtype`, :306-308, :463): convs and matmuls in `compute_dtype`,
GroupNorm statistics and output in fp32 (Flax's GroupNorm promotes a bf16
input to its fp32 parameters), the network output fp32.

Where the kernels run: every `Conv3x3` site of the JAX model (ResBlockpp's
two convs and the non-FIR up-resample conv) goes through `ops.conv3x3`, and
every SelfAttention2D through `ops.token_attention` (one head, dh = C, q/k/v
read in place from one fused projection). What the JAX model leaves to XLA
stays a library op: conv_in, conv_out, the pyramid and stride-2 convs are
`F.conv2d`, the 1x1 shortcuts and NIN projections matmuls, and the FIR
resamples `ops/resample.py`'s depthwise convs. The model starts in eval
mode (dropout off, the JAX default deterministic=True); `.train()` makes each
block's dropout live at `config.dropout`; `config.remat` recomputes each
block in the backward (`torch.utils.checkpoint`) wherever autograd records.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dpm_solver_tpu_torch.models.ddpm_unet import (Conv1x1, Conv2d, GroupNorm32, Linear,
                                                   swish, timestep_embedding)
from dpm_solver_tpu_torch.ops import resample as rs
from dpm_solver_tpu_torch.ops.attention import token_attention
from dpm_solver_tpu_torch.ops.conv3x3 import Conv3x3
from dpm_solver_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

_SQRT2 = math.sqrt(2.0)


@dataclasses.dataclass(frozen=True)
class NCSNppConfig:
    """Static architecture hyperparameters (ref config tree, e.g.
    configs/vp/cifar10_ddpmpp_deep_continuous.py:60-82)."""

    nf: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 2, 2)
    num_res_blocks: int = 8
    attn_resolutions: Tuple[int, ...] = (16,)
    dropout: float = 0.1
    resamp_with_conv: bool = True
    conditional: bool = True
    fir: bool = False
    fir_kernel: Tuple[float, ...] = (1.0, 3.0, 3.0, 1.0)
    skip_rescale: bool = True
    resblock_type: str = "biggan"  # "biggan" | "ddpm"
    progressive: str = "none"  # none | output_skip | residual
    progressive_input: str = "none"  # none | input_skip | residual
    progressive_combine: str = "sum"  # sum | cat
    embedding_type: str = "positional"  # positional | fourier
    fourier_scale: float = 16.0
    init_scale: float = 0.0
    nonlinearity: str = "swish"
    scale_by_sigma: bool = False
    data_centered: bool = True
    image_size: int = 32
    image_channels: int = 3
    # sigma ladder for discrete-VE positional nets (ref mutils.get_sigmas)
    sigma_min: float = 0.01
    sigma_max: float = 50.0
    num_scales: int = 1000
    # recompute each res block in the backward (where autograd records)
    remat: bool = False

    def __post_init__(self):
        assert self.resblock_type in ("biggan", "ddpm")
        assert self.progressive in ("none", "output_skip", "residual")
        assert self.progressive_input in ("none", "input_skip", "residual")
        assert self.progressive_combine in ("sum", "cat")
        assert self.embedding_type in ("positional", "fourier")

    @staticmethod
    def cifar10_ddpmpp(deep: bool = False) -> "NCSNppConfig":
        """VP DDPM++ (cont.): configs/vp/cifar10_ddpmpp{_deep}_continuous.py."""
        return NCSNppConfig(num_res_blocks=8 if deep else 4)

    @staticmethod
    def cifar10_ncsnpp(deep: bool = False) -> "NCSNppConfig":
        """VE NCSN++ (cont.): configs/ve/cifar10_ncsnpp{_deep}_continuous.py."""
        return NCSNppConfig(num_res_blocks=8 if deep else 4, fir=True,
                            progressive_input="residual", embedding_type="fourier",
                            scale_by_sigma=True, data_centered=False)

    @staticmethod
    def cifar10_ncsnpp_vp(deep: bool = False) -> "NCSNppConfig":
        """VP/subVP NCSN++: configs/{vp,subvp}/cifar10_ncsnpp*_continuous.py
        (FIR + residual input pyramid, positional embedding, no sigma-scaling)."""
        return NCSNppConfig(num_res_blocks=8 if deep else 4, fir=True,
                            progressive_input="residual")

    @staticmethod
    def celeba64() -> "NCSNppConfig":
        """VE NCSN++ @64px: configs/ve/celeba_ncsnpp.py (positional embedding,
        discrete sigma ladder)."""
        return NCSNppConfig(num_res_blocks=4, fir=True, progressive_input="residual",
                            scale_by_sigma=True, data_centered=False, image_size=64,
                            sigma_max=90.0, num_scales=1000)

    @staticmethod
    def px256() -> "NCSNppConfig":
        """VE NCSN++ @256px: configs/ve/{celebahq_256,ffhq_256,church,
        bedroom}_ncsnpp_continuous.py (7-level pyramid, output_skip +
        input_skip progressive, Fourier embedding)."""
        return NCSNppConfig(ch_mult=(1, 1, 2, 2, 2, 2, 2), num_res_blocks=2, dropout=0.0,
                            fir=True, progressive="output_skip", progressive_input="input_skip",
                            embedding_type="fourier", scale_by_sigma=True, data_centered=False,
                            image_size=256)

    @staticmethod
    def px1024() -> "NCSNppConfig":
        """VE NCSN++ @1024px: configs/ve/{celebahq,ffhq}_ncsnpp_continuous.py
        (nf 16, 8-level pyramid)."""
        return NCSNppConfig(nf=16, ch_mult=(1, 2, 4, 8, 16, 32, 32, 32), num_res_blocks=1,
                            dropout=0.0, fir=True, progressive="output_skip",
                            progressive_input="input_skip", embedding_type="fourier",
                            scale_by_sigma=True, data_centered=False, image_size=1024)

    @staticmethod
    def tiny(**overrides) -> "NCSNppConfig":
        base = dict(nf=32, ch_mult=(1, 2), num_res_blocks=2, dropout=0.0,
                    attn_resolutions=(8,), image_size=16)
        base.update(overrides)
        return NCSNppConfig(**base)


def get_sigmas(sigma_min: float, sigma_max: float, num_scales: int) -> np.ndarray:
    """Geometric, descending (ref models/utils.py get_sigmas)."""
    return np.exp(np.linspace(np.log(sigma_max), np.log(sigma_min),
                              num_scales)).astype(np.float32)


def get_act(name: str):
    return {"elu": F.elu, "relu": F.relu, "swish": swish,
            "lrelu": lambda x: F.leaky_relu(x, negative_slope=0.2)}[name]


class GroupNorm(GroupNorm32):
    """The reference's nn.GroupNorm(min(C // 4, 32), C, eps=1e-6) on NHWC,
    statistics and output in fp32."""

    def __init__(self, channels: int):
        super().__init__(channels, groups=min(channels // 4, 32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float())


class NIN(nn.Module):
    """The reference's NIN (layers.py): x @ W + b over the channels, W (in, out)."""

    def __init__(self, in_ch: int, out_ch: int, compute_dtype: torch.dtype):
        super().__init__()
        self.W = nn.Parameter(torch.empty(in_ch, out_ch))
        self.b = nn.Parameter(torch.zeros(out_ch))
        self.compute_dtype = compute_dtype
        nn.init.xavier_uniform_(self.W)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.W.t().to(dt), self.b.to(dt))


class Conv2dWeights(nn.Module):
    """The parameters of the reference's StyleGAN2 `up_or_down_sampling.Conv2d`:
    weight (out, in, k, k) and bias, applied by `Resample`."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)


def _stride2_same(conv: Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 3x3 stride-2 conv with SAME padding (Flax nn.Conv's)."""
    pads = []
    for n in (x.shape[2], x.shape[1]):
        total = max((n + 1) // 2 * 2 - 2 + 3 - n, 0)
        pads += [total // 2, total - total // 2]
    return conv(F.pad(x, (0, 0, *pads)))


class FourierFeatures(nn.Module):
    """Random Fourier embedding of log-sigma; W is a frozen draw
    (ref layerspp.py:33-43, GaussianFourierProjection)."""

    def __init__(self, dim: int, scale: float = 16.0):
        super().__init__()
        self.W = nn.Parameter(torch.randn(dim) * scale, requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ang = 2 * math.pi * x[:, None] * self.W[None, :]
        return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class SelfAttention2D(nn.Module):
    """Single-head attention over HW tokens (ref AttnBlockpp, layerspp.py:61-83).
    The reference's three NIN q/k/v projections run as one (C, 3C) matmul;
    the attention kernel reads q, k and v in place from its output."""

    def __init__(self, channels: int, skip_rescale: bool, compute_dtype: torch.dtype):
        super().__init__()
        self.GroupNorm_0 = GroupNorm(channels)
        for i in range(4):
            setattr(self, f"NIN_{i}", NIN(channels, channels, compute_dtype))
        self.skip_rescale = skip_rescale
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = x.shape
        dt = self.compute_dtype
        h = self.GroupNorm_0(x).reshape(b, hh * ww, c).to(dt)
        nins = (self.NIN_0, self.NIN_1, self.NIN_2)
        w = torch.cat([m.W for m in nins], dim=1).to(dt)
        bias = torch.cat([m.b for m in nins]).to(dt)
        q, k, v = F.linear(h, w.t(), bias).split(c, dim=-1)
        h = self.NIN_3(token_attention(q, k, v, num_heads=1, scale=c ** -0.5))
        h = x.to(h.dtype) + h.reshape(b, hh, ww, c)
        return h / _SQRT2 if self.skip_rescale else h


class Resample(nn.Module):
    """Standalone 2x up/downsample, optionally conv-fused (ref layerspp.py:86-143
    Upsample/Downsample, incl. the StyleGAN2 Conv2d path)."""

    def __init__(self, in_ch: int, direction: str, out_ch: Optional[int] = None,
                 with_conv: bool = False, fir: bool = False,
                 fir_kernel: Tuple[float, ...] = (1.0, 3.0, 3.0, 1.0),
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        out_ch = out_ch or in_ch
        self.up, self.with_conv, self.fir = direction == "up", with_conv, fir
        self.fir_kernel, self.compute_dtype = fir_kernel, compute_dtype
        if with_conv and fir:
            self.Conv2d_0 = Conv2dWeights(in_ch, out_ch)
        elif with_conv:
            self.Conv_0 = (Conv3x3(in_ch, out_ch, compute_dtype) if self.up
                           else Conv2d(in_ch, out_ch, compute_dtype, stride=2, padding=0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if not self.fir:
            if self.up:
                x = rs.nearest_upsample_2d(x)
                return self.Conv_0(x) if self.with_conv else x
            return _stride2_same(self.Conv_0, x) if self.with_conv else rs.mean_downsample_2d(x)
        if not self.with_conv:
            fn = rs.upsample_2d if self.up else rs.downsample_2d
            return fn(x.to(dt), self.fir_kernel, factor=2)
        fn = rs.upsample_conv_2d if self.up else rs.conv_downsample_2d
        kern = self.Conv2d_0.weight.permute(2, 3, 1, 0)    # HWIO
        return fn(x.to(dt), kern.to(dt), k=self.fir_kernel) + self.Conv2d_0.bias.to(dt)


class ResBlockpp(nn.Module):
    """Residual block covering the reference's ResnetBlockDDPMpp and
    ResnetBlockBigGANpp (layerspp.py:146-227), incl. in-block resampling."""

    def __init__(self, in_ch: int, out_ch: Optional[int] = None, *, variant: str = "biggan",
                 direction: Optional[str] = None, act_name: str = "swish",
                 temb_dim: Optional[int] = None, skip_rescale: bool = True, fir: bool = False,
                 fir_kernel: Tuple[float, ...] = (1.0, 3.0, 3.0, 1.0),
                 compute_dtype: torch.dtype = torch.float32, dropout: float = 0.0,
                 remat: bool = False):
        super().__init__()
        out_ch = out_ch or in_ch
        dt = self.compute_dtype = compute_dtype
        self.remat = remat
        self.variant, self.direction, self.act_name = variant, direction, act_name
        self.skip_rescale, self.fir, self.fir_kernel = skip_rescale, fir, fir_kernel
        self.GroupNorm_0 = GroupNorm(in_ch)
        self.Conv_0 = Conv3x3(in_ch, out_ch, dt)
        if temb_dim is not None:
            self.Dense_0 = Linear(temb_dim, out_ch, dt)
        self.GroupNorm_1 = GroupNorm(out_ch)
        self.Dropout_0 = nn.Dropout(dropout)
        self.Conv_1 = Conv3x3(out_ch, out_ch, dt)
        if in_ch != out_ch or direction is not None:
            if variant == "biggan":
                self.Conv_2 = Conv1x1(in_ch, out_ch, dt)
            else:
                self.NIN_0 = NIN(in_ch, out_ch, dt)

    def _resample(self, v: torch.Tensor) -> torch.Tensor:
        if self.direction is None:
            return v
        if self.fir:
            fn = rs.upsample_2d if self.direction == "up" else rs.downsample_2d
            return fn(v, self.fir_kernel, factor=2)
        if self.direction == "up":
            return rs.nearest_upsample_2d(v)
        return rs.mean_downsample_2d(v)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.remat and torch.is_grad_enabled():
            # the checkpoint keeps the default generators' state, so the
            # recompute draws the same dropout mask
            return checkpoint(self._forward, x, temb, use_reentrant=False)
        return self._forward(x, temb)

    def _forward(self, x: torch.Tensor, temb: Optional[torch.Tensor]) -> torch.Tensor:
        act, dt = get_act(self.act_name), self.compute_dtype
        h = act(self.GroupNorm_0(x)).to(dt)
        if self.variant == "biggan":
            h = self._resample(h)
            x = self._resample(x.to(dt))
        h = self.Conv_0(h)
        if temb is not None:
            h = h + self.Dense_0(act(temb))[:, None, None, :]
        h = self.Conv_1(self.Dropout_0(act(self.GroupNorm_1(h))))
        for shortcut in ("Conv_2", "NIN_0"):
            if hasattr(self, shortcut):
                x = getattr(self, shortcut)(x)
        h = x.to(h.dtype) + h
        return h / _SQRT2 if self.skip_rescale else h


class Combine(nn.Module):
    """Input-pyramid combiner (ref layerspp.Combine): a 1x1 conv of the
    pyramid, summed with or concatenated before the trunk's features."""

    def __init__(self, in_ch: int, out_ch: int, method: str, compute_dtype: torch.dtype):
        super().__init__()
        self.Conv_0 = Conv1x1(in_ch, out_ch, compute_dtype)
        self.method = method

    def forward(self, pyramid: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        z = self.Conv_0(pyramid)
        return torch.cat([z, h], dim=-1) if self.method == "cat" else z + h


class NCSNpp(nn.Module):
    """NCSN++/DDPM++ UNet; x NHWC (B, H, W, C), time_cond of shape (B,):
    labels for `positional` embedding (t * 999 on continuous VP), sigmas for
    `fourier` (ref ncsnpp.py:41-243). Built on `device`, the card by default
    (raises when there is none), in eval mode."""

    def __init__(self, config: NCSNppConfig, compute_dtype: torch.dtype = torch.float32,
                 device=DEFAULT_DEVICE):
        super().__init__()
        with torch.device(resolve_device(device)):
            self._construct(config, compute_dtype)
        self.eval()

    def _construct(self, cfg: NCSNppConfig, dt: torch.dtype):
        self.config, self.compute_dtype = cfg, dt
        nf, levels = cfg.nf, len(cfg.ch_mult)
        res_at = [cfg.image_size // (2 ** i) for i in range(levels)]
        channels = cfg.image_channels
        self.register_buffer("sigmas", torch.tensor(
            get_sigmas(cfg.sigma_min, cfg.sigma_max, cfg.num_scales)))
        block = functools.partial(
            ResBlockpp, variant=cfg.resblock_type, act_name=cfg.nonlinearity,
            temb_dim=4 * nf if cfg.conditional else None, skip_rescale=cfg.skip_rescale,
            fir=cfg.fir, fir_kernel=cfg.fir_kernel, compute_dtype=dt, dropout=cfg.dropout,
            remat=cfg.remat)
        attn = functools.partial(SelfAttention2D, skip_rescale=cfg.skip_rescale,
                                 compute_dtype=dt)
        resample = functools.partial(Resample, fir=cfg.fir, fir_kernel=cfg.fir_kernel,
                                     compute_dtype=dt)
        ddpm = cfg.resblock_type == "ddpm"

        mods = []
        if cfg.embedding_type == "fourier":
            mods.append(FourierFeatures(nf, cfg.fourier_scale))
        if cfg.conditional:
            embed_dim = 2 * nf if cfg.embedding_type == "fourier" else nf
            mods += [Linear(embed_dim, 4 * nf, dt), Linear(4 * nf, 4 * nf, dt)]
        # parameter-free pyramid resamples: attributes, as in the reference
        if cfg.progressive == "output_skip":
            self.pyramid_upsample = resample(channels, "up")
        if cfg.progressive_input == "input_skip":
            self.pyramid_downsample = resample(channels, "down")

        mods.append(Conv2d(channels, nf, dt))  # conv_in
        hs_c, in_ch, pyramid_in_ch = [nf], nf, channels
        for i in range(levels):
            for _ in range(cfg.num_res_blocks):
                mods.append(block(in_ch, nf * cfg.ch_mult[i]))
                in_ch = nf * cfg.ch_mult[i]
                if res_at[i] in cfg.attn_resolutions:
                    mods.append(attn(in_ch))
                hs_c.append(in_ch)
            if i == levels - 1:
                continue
            mods.append(resample(in_ch, "down", with_conv=cfg.resamp_with_conv) if ddpm
                        else block(in_ch, direction="down"))
            if cfg.progressive_input == "input_skip":
                mods.append(Combine(pyramid_in_ch, in_ch, cfg.progressive_combine, dt))
                if cfg.progressive_combine == "cat":
                    in_ch *= 2
            elif cfg.progressive_input == "residual":
                mods.append(resample(pyramid_in_ch, "down", out_ch=in_ch, with_conv=True))
                pyramid_in_ch = in_ch
            hs_c.append(in_ch)

        mods += [block(in_ch), attn(in_ch), block(in_ch)]

        pyramid_ch = 0
        for i in reversed(range(levels)):
            for _ in range(cfg.num_res_blocks + 1):
                mods.append(block(in_ch + hs_c.pop(), nf * cfg.ch_mult[i]))
                in_ch = nf * cfg.ch_mult[i]
            if res_at[i] in cfg.attn_resolutions:
                mods.append(attn(in_ch))
            if cfg.progressive == "output_skip":
                mods += [GroupNorm(in_ch), Conv2d(in_ch, channels, dt)]
            elif cfg.progressive == "residual":
                if i == levels - 1:
                    mods += [GroupNorm(in_ch), Conv2d(in_ch, in_ch, dt)]
                else:
                    mods.append(resample(pyramid_ch, "up", out_ch=in_ch, with_conv=True))
                pyramid_ch = in_ch
            if i != 0:
                mods.append(resample(in_ch, "up", with_conv=cfg.resamp_with_conv) if ddpm
                            else block(in_ch, direction="up"))
        assert not hs_c
        if cfg.progressive != "output_skip":
            mods += [GroupNorm(in_ch), Conv2d(in_ch, channels, dt)]
        self.all_modules = nn.ModuleList(mods)

    def forward(self, x: torch.Tensor, time_cond: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        act = get_act(cfg.nonlinearity)
        levels = len(cfg.ch_mult)
        res_at = [cfg.image_size // (2 ** i) for i in range(levels)]
        ddpm = cfg.resblock_type == "ddpm"
        mods = iter(self.all_modules)

        # ---- time / noise-level embedding ------------------------------------
        if cfg.embedding_type == "fourier":
            temb = next(mods)(torch.log(time_cond))
            used_sigmas = time_cond
        else:
            temb = timestep_embedding(time_cond, cfg.nf)
            # discrete-VE nets: time_cond indexes the sigma ladder
            used_sigmas = self.sigmas[time_cond.long()] if cfg.scale_by_sigma else None
        temb = next(mods)(temb) if cfg.conditional else None
        temb = next(mods)(act(temb)) if cfg.conditional else None

        if not cfg.data_centered:
            x = 2.0 * x - 1.0

        # ---- encoder ------------------------------------------------------------
        pyramid_in = x if cfg.progressive_input != "none" else None
        hs = [next(mods)(x)]
        for i in range(levels):
            for _ in range(cfg.num_res_blocks):
                h = next(mods)(hs[-1], temb)
                if res_at[i] in cfg.attn_resolutions:
                    h = next(mods)(h)
                hs.append(h)
            if i == levels - 1:
                continue
            h = next(mods)(hs[-1]) if ddpm else next(mods)(hs[-1], temb)
            if cfg.progressive_input == "input_skip":
                pyramid_in = self.pyramid_downsample(pyramid_in)
                h = next(mods)(pyramid_in, h)
            elif cfg.progressive_input == "residual":
                pyramid_in = next(mods)(pyramid_in) + h
                if cfg.skip_rescale:
                    pyramid_in = pyramid_in / _SQRT2
                h = pyramid_in
            hs.append(h)

        # ---- bottleneck ---------------------------------------------------------
        h = next(mods)(hs[-1], temb)
        h = next(mods)(h)
        h = next(mods)(h, temb)

        # ---- decoder ------------------------------------------------------------
        pyramid = None
        for i in reversed(range(levels)):
            for _ in range(cfg.num_res_blocks + 1):
                h = next(mods)(torch.cat([h, hs.pop()], dim=-1), temb)
            if res_at[i] in cfg.attn_resolutions:
                h = next(mods)(h)
            if cfg.progressive != "none":
                to_img = cfg.progressive == "output_skip"
                if i == levels - 1 or to_img:
                    norm, conv = next(mods), next(mods)
                    branch = conv(act(norm(h)))
                if i == levels - 1:
                    pyramid = branch
                elif to_img:
                    pyramid = self.pyramid_upsample(pyramid) + branch
                else:
                    pyramid = next(mods)(pyramid) + h
                    if cfg.skip_rescale:
                        pyramid = pyramid / _SQRT2
                    h = pyramid
            if i != 0:
                h = next(mods)(h) if ddpm else next(mods)(h, temb)
        assert not hs

        if cfg.progressive == "output_skip":
            h = pyramid
        else:
            norm, conv = next(mods), next(mods)
            h = conv(act(norm(h)))
        h = h.float()  # solver math downstream is fp32
        if cfg.scale_by_sigma:
            h = h / used_sigmas.reshape(-1, 1, 1, 1)
        return h
