"""The DDPM CIFAR-10 UNet (Ho et al. 2020) in plain float32 PyTorch, NHWC.

examples/ddpm_and_guided-diffusion/models/diffusion.py of the DPM-Solver
release: a [sin | cos] time embedding (freqs exp(-ln(10^4) i / (half - 1)))
through two dense layers, res blocks of GroupNorm(32, eps 1e-6), swish and
3x3 convs with the time projection added after the first conv, single-head
attention at the listed resolutions, a stride-2 conv after a (0, 1, 0, 1)
pad to downsample, nearest x2 and a 3x3 conv to upsample. Dropout is off
(sampling). Keys are the release's state-dict keys.
"""

from __future__ import annotations

import torch
from torch import nn

from port_bench.reference.layers import (FP32, Conv, Linear, Norm, Precision, attention,
                                         group_norm, nearest_x2, silu, sinusoid)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, temb: int):
        super().__init__()
        self.norm1, self.conv1 = Norm(cin), Conv(cin, cout)
        self.temb_proj = Linear(temb, cout)
        self.norm2, self.conv2 = Norm(cout), Conv(cout, cout)
        if cin != cout:
            self.nin_shortcut = Conv(cin, cout, k=1)

    def forward(self, x, temb, prec: Precision):
        h = self.conv1(silu(group_norm(x, self.norm1, 1e-6)), prec)
        h = h + self.temb_proj(silu(temb), prec)[:, None, None, :]
        h = self.conv2(silu(group_norm(h, self.norm2, 1e-6)), prec)
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x, prec)
        return x + h


class AttnBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.norm = Norm(c)
        self.q, self.k, self.v, self.proj_out = (Conv(c, c, k=1) for _ in range(4))

    def forward(self, x, prec: Precision):
        b, hh, ww, c = x.shape
        h = group_norm(x, self.norm, 1e-6).reshape(b, hh * ww, c)
        q, k, v = (m(h, prec) for m in (self.q, self.k, self.v))
        out = attention(q, k, v, 1, c ** -0.5, prec).reshape(b, hh, ww, c)
        return x + self.proj_out(out, prec)


class _Level(nn.Module):
    def __init__(self):
        super().__init__()
        self.block, self.attn = nn.ModuleList(), nn.ModuleList()


class _Resample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv(c, c)


class DDPMUNet(nn.Module):
    """`cfg`: the configuration file's `model` group (ch, out_ch, ch_mult,
    num_res_blocks, attn_resolutions, in_channels, resolution)."""

    def __init__(self, cfg: dict):
        super().__init__()
        ch, mults, nres = cfg["ch"], cfg["ch_mult"], cfg["num_res_blocks"]
        self.ch, self.levels, self.nres = ch, len(mults), nres
        temb = 4 * ch
        self.temb = nn.Module()
        self.temb.dense = nn.ModuleList([Linear(ch, temb), Linear(temb, temb)])
        self.conv_in = Conv(cfg["in_channels"], ch)
        res, in_mult = cfg["resolution"], (1,) + tuple(mults)
        self.down = nn.ModuleList()
        for i, mult in enumerate(mults):
            level = _Level()
            block_in = ch * in_mult[i]
            for _ in range(nres):
                level.block.append(ResnetBlock(block_in, ch * mult, temb))
                block_in = ch * mult
                if res in cfg["attn_resolutions"]:
                    level.attn.append(AttnBlock(block_in))
            if i != len(mults) - 1:
                level.downsample = _Resample(block_in)
                res //= 2
            self.down.append(level)
        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock(block_in, block_in, temb)
        self.mid.attn_1 = AttnBlock(block_in)
        self.mid.block_2 = ResnetBlock(block_in, block_in, temb)
        up = []
        for i in reversed(range(len(mults))):
            level = _Level()
            skip_in = ch * mults[i]
            for j in range(nres + 1):
                if j == nres:
                    skip_in = ch * in_mult[i]
                level.block.append(ResnetBlock(block_in + skip_in, ch * mults[i], temb))
                block_in = ch * mults[i]
                if res in cfg["attn_resolutions"]:
                    level.attn.append(AttnBlock(block_in))
            if i != 0:
                level.upsample = _Resample(block_in)
                res *= 2
            up.insert(0, level)
        self.up = nn.ModuleList(up)
        self.norm_out = Norm(block_in)
        self.conv_out = Conv(block_in, cfg["out_ch"])

    def forward(self, x: torch.Tensor, t: torch.Tensor, prec: Precision = FP32) -> torch.Tensor:
        temb = self.temb.dense[0](sinusoid(t, self.ch, cos_first=False, shift=1), prec)
        temb = self.temb.dense[1](silu(temb), prec)
        hs = [self.conv_in(x, prec)]
        for i, level in enumerate(self.down):
            for j, block in enumerate(level.block):
                h = block(hs[-1], temb, prec)
                if len(level.attn):
                    h = level.attn[j](h, prec)
                hs.append(h)
            if i != self.levels - 1:
                padded = torch.nn.functional.pad(hs[-1], (0, 0, 0, 1, 0, 1))
                hs.append(level.downsample.conv(padded, prec, stride=2, padding=0))
        h = self.mid.block_1(hs[-1], temb, prec)
        h = self.mid.block_2(self.mid.attn_1(h, prec), temb, prec)
        for i in reversed(range(self.levels)):
            level = self.up[i]
            for j, block in enumerate(level.block):
                h = block(torch.cat([h, hs.pop()], dim=-1), temb, prec)
                if len(level.attn):
                    h = level.attn[j](h, prec)
            if i != 0:
                h = level.upsample.conv(nearest_x2(h), prec)
        return self.conv_out(silu(group_norm(h, self.norm_out, 1e-6)), prec)
