"""DDPM UNet (Ho et al. 2020 CIFAR architecture) in PyTorch, NHWC.

Port of `dpm_solver_tpu/models/ddpm_unet.py`, twin of the reference torch
model (examples/ddpm_and_guided-diffusion/models/diffusion.py:6-341).
Parameter names are the reference's state-dict keys (`temb.dense.0`,
`down.1.attn.0.q`, `mid.block_1`, ...) in its layouts (conv weights OIHW,
linear weights (out, in)), so a reference checkpoint is one plain
`load_state_dict`, and `utils/convert.py` carries JAX parameters across.

Activations stay NHWC, the layout of the JAX model and of the kernels. The
dtypes are placed by hand, as in the JAX model, with no autocast: parameters
are fp32 and are cast to `compute_dtype` (bf16 on the card) where they are
used; GroupNorm statistics are fp32; attention softmax is fp32 inside the
kernel; the network returns fp32.

Where the kernels run: every ResnetBlock conv and the Upsample conv go
through `ops.conv3x3` (47 launches per CIFAR forward), every AttnBlock
through `ops.token_attention` (6 per CIFAR forward). The convs the JAX model
leaves to XLA stay library ops here: `conv_in`, `conv_out` and the stride-2
`Downsample` conv are `F.conv2d`, and the 1x1 convs (`nin_shortcut`, q, k, v,
`proj_out`) are matmuls (`F.linear`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dpm_solver_tpu_torch.ops.attention import token_attention
from dpm_solver_tpu_torch.ops.conv3x3 import Conv3x3
from dpm_solver_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


@dataclasses.dataclass(frozen=True)
class DDPMUNetConfig:
    ch: int = 128
    out_ch: int = 3
    ch_mult: Tuple[int, ...] = (1, 2, 2, 2)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (16,)
    dropout: float = 0.1
    in_channels: int = 3
    resolution: int = 32
    resamp_with_conv: bool = True
    conditional: bool = True

    @staticmethod
    def cifar10() -> "DDPMUNetConfig":
        return DDPMUNetConfig()

    @staticmethod
    def celeba() -> "DDPMUNetConfig":
        """configs/celeba.yml model section (DDPM 64x64)."""
        return DDPMUNetConfig(ch_mult=(1, 2, 2, 2, 4), resolution=64)

    @staticmethod
    def lsun256() -> "DDPMUNetConfig":
        """LSUN/CelebAHQ 256px DDPM (score_sde configs/vp/ddpm/
        {church,bedroom,celebahq}.py: ch_mult (1,1,2,2,4,4))."""
        return DDPMUNetConfig(ch_mult=(1, 1, 2, 2, 4, 4), resolution=256)

    @staticmethod
    def tiny(resolution: int = 16) -> "DDPMUNetConfig":
        """Small config for tests."""
        return DDPMUNetConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                              attn_resolutions=(8,), dropout=0.0,
                              resolution=resolution)


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding, fairseq/tensor2tensor convention: [sin | cos], fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) / (half - 1)
                      * torch.arange(half, dtype=torch.float32, device=t.device))
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


class GroupNorm32(nn.Module):
    """GroupNorm(32, eps=1e-6) over the channels of an NHWC tensor.

    Statistics in fp32 whatever the activation dtype, the result cast back.
    Groups are contiguous channel ranges, as in `nn.GroupNorm` and Flax.
    """

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-6):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[0], x.shape[-1]
        xf = x.float().reshape(b, -1, self.groups, c // self.groups)
        var, mean = torch.var_mean(xf, dim=(1, 3), correction=0, keepdim=True)
        y = ((xf - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        return (y * self.weight + self.bias).to(x.dtype)


class Linear(nn.Linear):
    """`nn.Linear` computed in `compute_dtype` (fp32 parameters cast per call)."""

    def __init__(self, in_features: int, out_features: int, compute_dtype: torch.dtype):
        super().__init__(in_features, out_features)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Conv1x1(nn.Module):
    """1x1 `nn.Conv2d` weights (CO, C, 1, 1) applied to NHWC as a matmul."""

    def __init__(self, in_channels: int, out_channels: int, compute_dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 1, 1))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.compute_dtype = compute_dtype
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight[:, :, 0, 0].to(dt), self.bias.to(dt))


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` on NHWC tensors in `compute_dtype` (the library conv)."""

    def __init__(self, in_channels, out_channels, compute_dtype, stride=1, padding=1):
        super().__init__(in_channels, out_channels, 3, stride=stride, padding=padding)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        out = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt), self.bias.to(dt),
                       stride=self.stride, padding=self.padding)
        return out.permute(0, 2, 3, 1).contiguous()


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_channels: Optional[int],
                 compute_dtype: torch.dtype, dropout: float = 0.0):
        super().__init__()
        dt = compute_dtype
        self.norm1 = GroupNorm32(in_channels)
        self.conv1 = Conv3x3(in_channels, out_channels, dt)
        if temb_channels is not None:
            self.temb_proj = Linear(temb_channels, out_channels, dt)
        self.norm2 = GroupNorm32(out_channels)
        self.dropout = nn.Dropout(dropout)
        self.conv2 = Conv3x3(out_channels, out_channels, dt)
        if in_channels != out_channels:
            self.nin_shortcut = Conv1x1(in_channels, out_channels, dt)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor]) -> torch.Tensor:
        h = self.conv1(swish(self.norm1(x)))
        if temb is not None:  # unconditional nets pass None (ref ddpm.py:78)
            h = h + self.temb_proj(swish(temb))[:, None, None, :]
        # live under .train(), off under .eval() (the JAX deterministic flag)
        h = self.conv2(self.dropout(swish(self.norm2(h))))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over HW tokens (ref AttnBlock semantics)."""

    def __init__(self, channels: int, compute_dtype: torch.dtype):
        super().__init__()
        self.norm = GroupNorm32(channels)
        self.q = Conv1x1(channels, channels, compute_dtype)
        self.k = Conv1x1(channels, channels, compute_dtype)
        self.v = Conv1x1(channels, channels, compute_dtype)
        self.proj_out = Conv1x1(channels, channels, compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = x.shape
        h = self.norm(x)
        q, k, v = (m(h).reshape(b, hh * ww, c) for m in (self.q, self.k, self.v))
        h = token_attention(q, k, v, num_heads=1, scale=c ** -0.5).reshape(b, hh, ww, c)
        return x + self.proj_out(h)


class Downsample(nn.Module):
    def __init__(self, channels: int, with_conv: bool, compute_dtype: torch.dtype):
        super().__init__()
        self.with_conv = with_conv
        if with_conv:
            self.conv = Conv2d(channels, channels, compute_dtype, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.with_conv:
            # asymmetric (0,1) pad on H and W, then VALID stride-2 conv
            return self.conv(F.pad(x, (0, 0, 0, 1, 0, 1)))
        return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1).contiguous()


class Upsample(nn.Module):
    def __init__(self, channels: int, with_conv: bool, compute_dtype: torch.dtype):
        super().__init__()
        if with_conv:
            self.conv = Conv3x3(channels, channels, compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)  # nearest 2x
        return self.conv(x) if hasattr(self, "conv") else x


class DDPMUNet(nn.Module):
    """eps-prediction UNet; x NHWC (B, H, W, C), t of shape (B,) (continuous labels ok).

    Built on `device`, the card by default (raises when there is none), in
    eval mode (dropout off, the JAX default deterministic=True); `.train()`
    makes dropout live at `config.dropout`.
    """

    def __init__(self, config: DDPMUNetConfig, compute_dtype: torch.dtype = torch.float32,
                 device=DEFAULT_DEVICE):
        super().__init__()
        with torch.device(resolve_device(device)):
            self._construct(config, compute_dtype)
        self.eval()

    def _construct(self, config: DDPMUNetConfig, compute_dtype: torch.dtype):
        cfg = self.config = config
        dt = self.compute_dtype = compute_dtype
        num_res = len(cfg.ch_mult)
        temb_ch = cfg.ch * 4 if cfg.conditional else None
        if cfg.conditional:
            self.temb = nn.Module()
            self.temb.dense = nn.ModuleList([Linear(cfg.ch, temb_ch, dt),
                                             Linear(temb_ch, temb_ch, dt)])
        self.conv_in = Conv2d(cfg.in_channels, cfg.ch, dt)

        curr_res = cfg.resolution
        in_mult = (1,) + tuple(cfg.ch_mult)
        block_in = cfg.ch
        self.down = nn.ModuleList()
        for i_level in range(num_res):
            level = nn.Module()
            level.block, level.attn = nn.ModuleList(), nn.ModuleList()
            block_in = cfg.ch * in_mult[i_level]
            block_out = cfg.ch * cfg.ch_mult[i_level]
            for _ in range(cfg.num_res_blocks):
                level.block.append(ResnetBlock(block_in, block_out, temb_ch, dt, cfg.dropout))
                block_in = block_out
                if curr_res in cfg.attn_resolutions:
                    level.attn.append(AttnBlock(block_in, dt))
            if i_level != num_res - 1:
                level.downsample = Downsample(block_in, cfg.resamp_with_conv, dt)
                curr_res //= 2
            self.down.append(level)

        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock(block_in, block_in, temb_ch, dt, cfg.dropout)
        self.mid.attn_1 = AttnBlock(block_in, dt)
        self.mid.block_2 = ResnetBlock(block_in, block_in, temb_ch, dt, cfg.dropout)

        up = []
        for i_level in reversed(range(num_res)):
            level = nn.Module()
            level.block, level.attn = nn.ModuleList(), nn.ModuleList()
            block_out = cfg.ch * cfg.ch_mult[i_level]
            skip_in = cfg.ch * cfg.ch_mult[i_level]
            for i_block in range(cfg.num_res_blocks + 1):
                if i_block == cfg.num_res_blocks:
                    skip_in = cfg.ch * in_mult[i_level]
                level.block.append(ResnetBlock(block_in + skip_in, block_out, temb_ch, dt,
                                               cfg.dropout))
                block_in = block_out
                if curr_res in cfg.attn_resolutions:
                    level.attn.append(AttnBlock(block_in, dt))
            if i_level != 0:
                level.upsample = Upsample(block_in, cfg.resamp_with_conv, dt)
                curr_res *= 2
            up.insert(0, level)
        self.up = nn.ModuleList(up)  # up[i_level], as in the reference

        self.norm_out = GroupNorm32(block_in)
        self.conv_out = Conv2d(block_in, cfg.out_ch, dt)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        num_res = len(cfg.ch_mult)
        temb = None
        if cfg.conditional:
            temb = self.temb.dense[0](timestep_embedding(t, cfg.ch))
            temb = self.temb.dense[1](swish(temb))

        hs = [self.conv_in(x)]
        for i_level in range(num_res):
            level = self.down[i_level]
            for i_block in range(cfg.num_res_blocks):
                h = level.block[i_block](hs[-1], temb)
                if len(level.attn) > 0:
                    h = level.attn[i_block](h)
                hs.append(h)
            if i_level != num_res - 1:
                hs.append(level.downsample(hs[-1]))

        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(hs[-1], temb)), temb)

        for i_level in reversed(range(num_res)):
            level = self.up[i_level]
            for i_block in range(cfg.num_res_blocks + 1):
                h = level.block[i_block](torch.cat([h, hs.pop()], dim=-1), temb)
                if len(level.attn) > 0:
                    h = level.attn[i_block](h)
            if i_level != 0:
                h = level.upsample(h)

        h = self.conv_out(swish(self.norm_out(h)))
        return h.float()


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter from `generator`: weights N(0, 1/fan_in), norm
    scales 1, biases N(0, 0.01^2) (NIN's `b` too). Random weights for runs without a checkpoint;
    no layer is left at zero (the zero-initialised output projections of the
    reference would otherwise make half of each block compute nothing). The
    values are drawn on the generator's device."""
    dev = generator.device
    for name, p in model.named_parameters():
        if name.endswith(("bias", ".b")):  # ".b": the score_sde NIN bias
            vals = torch.randn(p.shape, generator=generator, device=dev) * 0.01
        elif p.dim() == 1:  # GroupNorm / LayerNorm scale
            vals = torch.ones(p.shape, device=dev)
        else:
            vals = torch.randn(p.shape, generator=generator, device=dev) / math.sqrt(p[0].numel())
        p.copy_(vals)
    return model
