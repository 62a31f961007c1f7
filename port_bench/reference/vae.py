"""The KL-f8 first stage of Stable Diffusion in plain float32 PyTorch, NHWC.

ldm/modules/diffusionmodules/model.py's Encoder and Decoder and
ldm/models/autoencoder.py's AutoencoderKL (quant_conv, post_quant_conv),
as v1-inference.yaml's first_stage_config builds them: res blocks of
GroupNorm(32, eps 1e-6), swish and 3x3 convs, one single-head attention in
the middle, nearest x2 and a 3x3 conv to upsample, a stride-2 conv after a
(0, 1, 0, 1) pad to downsample. Only `decode` runs; the encoder is here so
that the state dict has every key of the checkpoint's `first_stage_model.*`.
"""

from __future__ import annotations

import torch
from torch import nn

from port_bench.reference.layers import (FP32, Conv, Norm, Precision, attention, group_norm,
                                         nearest_x2, silu)


class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1, self.conv1 = Norm(cin), Conv(cin, cout)
        self.norm2, self.conv2 = Norm(cout), Conv(cout, cout)
        if cin != cout:
            self.nin_shortcut = Conv(cin, cout, k=1)

    def forward(self, x, prec: Precision):
        h = self.conv1(silu(group_norm(x, self.norm1, 1e-6)), prec)
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
        out = attention(q, k, v, 1, c ** -0.5, prec)
        return x + self.proj_out(out, prec).reshape(b, hh, ww, c)


class _Level(nn.Module):
    def __init__(self):
        super().__init__()
        self.block, self.attn = nn.ModuleList(), nn.ModuleList()


class _Resample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv(c, c)


def _mid(c: int) -> nn.Module:
    mid = nn.Module()
    mid.block_1, mid.attn_1, mid.block_2 = ResBlock(c, c), AttnBlock(c), ResBlock(c, c)
    return mid


class Encoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        ch, mults = cfg["ch"], cfg["ch_mult"]
        self.conv_in = Conv(cfg["in_channels"], ch)
        self.down = nn.ModuleList()
        block_in = ch
        for i, mult in enumerate(mults):
            level = _Level()
            for _ in range(cfg["num_res_blocks"]):
                level.block.append(ResBlock(block_in, ch * mult))
                block_in = ch * mult
            if i != len(mults) - 1:
                level.downsample = _Resample(block_in)
            self.down.append(level)
        self.mid = _mid(block_in)
        self.norm_out = Norm(block_in)
        z = cfg["z_channels"]
        self.conv_out = Conv(block_in, 2 * z if cfg["double_z"] else z)


class Decoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        ch, mults = cfg["ch"], cfg["ch_mult"]
        block_in = ch * mults[-1]
        self.conv_in = Conv(cfg["z_channels"], block_in)
        self.mid = _mid(block_in)
        up = []
        for i in reversed(range(len(mults))):
            level = _Level()
            for _ in range(cfg["num_res_blocks"] + 1):
                level.block.append(ResBlock(block_in, ch * mults[i]))
                block_in = ch * mults[i]
            if i != 0:
                level.upsample = _Resample(block_in)
            up.insert(0, level)
        self.up = nn.ModuleList(up)
        self.norm_out = Norm(block_in)
        self.conv_out = Conv(block_in, cfg["out_ch"])

    def forward(self, z, prec: Precision):
        h = self.conv_in(z, prec)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h, prec), prec), prec)
        for i in reversed(range(len(self.up))):
            for block in self.up[i].block:
                h = block(h, prec)
            if i != 0:
                h = self.up[i].upsample.conv(nearest_x2(h), prec)
        return self.conv_out(silu(group_norm(h, self.norm_out, 1e-6)), prec)


class AutoencoderKL(nn.Module):
    """`cfg`: the configuration file's `first_stage` group (ddconfig and embed_dim)."""

    def __init__(self, cfg: dict):
        super().__init__()
        if cfg["attn_resolutions"]:
            raise ValueError("the reference first stage has attention in the middle only")
        z, e = cfg["z_channels"], cfg["embed_dim"]
        self.encoder, self.decoder = Encoder(cfg), Decoder(cfg)
        self.quant_conv = Conv(2 * z if cfg["double_z"] else z, 2 * e if cfg["double_z"] else e,
                               k=1)
        self.post_quant_conv = Conv(e, z, k=1)

    def decode(self, z: torch.Tensor, prec: Precision = FP32) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z, prec), prec)


def to_images(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 1], clipped."""
    return ((x + 1.0) / 2.0).clamp(0.0, 1.0)

