"""The Stable Diffusion v1 UNet in plain float32 PyTorch, NHWC.

The openaimodel.py UNetModel of CompVis' latent diffusion with its
SpatialTransformer (ldm/modules/attention.py), as v1-inference.yaml builds
it: res blocks without scale-shift, a cross-attention transformer of depth
1 after each res block at the listed downsample rates, heads of
channels // num_heads, GEGLU feed-forward (x * gelu(gate), exact gelu),
1x1-conv proj_in/proj_out, GroupNorm eps 1e-5 in the res blocks and the
output, 1e-6 in the transformers, LayerNorm eps 1e-5. Keys are the
checkpoint's `model.diffusion_model.*` keys without the prefix.
"""

from __future__ import annotations

import torch
from torch import nn

from port_bench.reference.layers import (FP32, Conv, Linear, Norm, Precision, attention,
                                         group_norm, layer_norm, nearest_x2, silu, sinusoid)


class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, emb: int):
        super().__init__()
        self.in_layers = nn.ModuleList([Norm(cin), nn.Identity(), Conv(cin, cout)])
        self.emb_layers = nn.ModuleList([nn.Identity(), Linear(emb, cout)])
        self.out_layers = nn.ModuleList([Norm(cout), nn.Identity(), nn.Identity(),
                                         Conv(cout, cout)])
        if cin != cout:
            self.skip_connection = Conv(cin, cout, k=1)

    def forward(self, x, emb, prec: Precision):
        h = self.in_layers[2](silu(group_norm(x, self.in_layers[0], 1e-5)), prec)
        h = h + self.emb_layers[1](silu(emb), prec)[:, None, None, :]
        h = self.out_layers[3](silu(group_norm(h, self.out_layers[0], 1e-5)), prec)
        if hasattr(self, "skip_connection"):
            x = self.skip_connection(x, prec)
        return x + h


class CrossAttention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int = None):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Linear(dim, inner, bias=False)
        self.to_k = Linear(context_dim or dim, inner, bias=False)
        self.to_v = Linear(context_dim or dim, inner, bias=False)
        self.to_out = nn.ModuleList([Linear(inner, dim)])

    def forward(self, x, context, prec: Precision):
        ctx = x if context is None else context
        q, k, v = self.to_q(x, prec), self.to_k(ctx, prec), self.to_v(ctx, prec)
        out = attention(q, k, v, self.heads, self.dim_head ** -0.5, prec)
        return self.to_out[0](out, prec)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Linear(dim, 2 * inner)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(), Linear(dim * mult, dim)])

    def forward(self, x, prec: Precision):
        h, gate = self.net[0].proj(x, prec).chunk(2, dim=-1)
        return self.net[2](h * torch.nn.functional.gelu(gate), prec)


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int):
        super().__init__()
        self.attn1 = CrossAttention(dim, heads, dim_head)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim)
        self.norm1, self.norm2, self.norm3 = Norm(dim), Norm(dim), Norm(dim)

    def forward(self, x, context, prec: Precision):
        x = x + self.attn1(layer_norm(x, self.norm1), None, prec)
        x = x + self.attn2(layer_norm(x, self.norm2), context, prec)
        return x + self.ff(layer_norm(x, self.norm3), prec)


class SpatialTransformer(nn.Module):
    def __init__(self, channels: int, heads: int, dim_head: int, depth: int, context_dim: int):
        super().__init__()
        inner = heads * dim_head
        self.norm = Norm(channels)
        self.proj_in = Conv(channels, inner, k=1)
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock(inner, heads, dim_head, context_dim) for _ in range(depth)])
        self.proj_out = Conv(inner, channels, k=1)

    def forward(self, x, context, prec: Precision):
        b, hh, ww, c = x.shape
        h = self.proj_in(group_norm(x, self.norm, 1e-6), prec).reshape(b, hh * ww, -1)
        for block in self.transformer_blocks:
            h = block(h, context, prec)
        return x + self.proj_out(h, prec).reshape(b, hh, ww, c)


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.op = Conv(channels, channels)

    def forward(self, x, prec: Precision):
        return self.op(x, prec, stride=2, padding=1)


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv(channels, channels)

    def forward(self, x, prec: Precision):
        return self.conv(nearest_x2(x), prec)


class SDUNet(nn.Module):
    """`cfg`: the configuration file's `unet` group (in_channels,
    out_channels, model_channels, attention_resolutions, num_res_blocks,
    channel_mult, num_heads, transformer_depth, context_dim)."""

    def __init__(self, cfg: dict):
        super().__init__()
        mc, heads = cfg["model_channels"], cfg["num_heads"]
        emb = 4 * mc
        depth, ctx = cfg["transformer_depth"], cfg["context_dim"]
        attn_at = set(cfg["attention_resolutions"])
        self.model_channels = mc
        self.time_embed = nn.ModuleList([Linear(mc, emb), nn.Identity(), Linear(emb, emb)])

        def xattn(ch):
            return SpatialTransformer(ch, heads, ch // heads, depth, ctx)

        ch = mc * cfg["channel_mult"][0]
        self.input_blocks = nn.ModuleList([nn.ModuleList([Conv(cfg["in_channels"], ch)])])
        chans, ds = [ch], 1
        for level, mult in enumerate(cfg["channel_mult"]):
            for _ in range(cfg["num_res_blocks"]):
                layers = [ResBlock(ch, mult * mc, emb)]
                ch = mult * mc
                if ds in attn_at:
                    layers.append(xattn(ch))
                self.input_blocks.append(nn.ModuleList(layers))
                chans.append(ch)
            if level != len(cfg["channel_mult"]) - 1:
                self.input_blocks.append(nn.ModuleList([Downsample(ch)]))
                chans.append(ch)
                ds *= 2
        self.middle_block = nn.ModuleList([ResBlock(ch, ch, emb), xattn(ch), ResBlock(ch, ch, emb)])
        self.output_blocks = nn.ModuleList()
        for level, mult in list(enumerate(cfg["channel_mult"]))[::-1]:
            for i in range(cfg["num_res_blocks"] + 1):
                layers = [ResBlock(ch + chans.pop(), mult * mc, emb)]
                ch = mult * mc
                if ds in attn_at:
                    layers.append(xattn(ch))
                if level and i == cfg["num_res_blocks"]:
                    layers.append(Upsample(ch))
                    ds //= 2
                self.output_blocks.append(nn.ModuleList(layers))
        self.out = nn.ModuleList([Norm(ch), nn.Identity(), Conv(ch, cfg["out_channels"])])

    def _run(self, mods, h, emb, context, prec):
        for mod in mods:
            if isinstance(mod, ResBlock):
                h = mod(h, emb, prec)
            elif isinstance(mod, SpatialTransformer):
                h = mod(h, context, prec)
            else:
                h = mod(h, prec)
        return h

    def forward(self, x: torch.Tensor, t: torch.Tensor, context: torch.Tensor,
                prec: Precision = FP32) -> torch.Tensor:
        """eps of latents x (B, H, W, C) at labels t (B,) under context (B, S, D)."""
        emb = self.time_embed[0](sinusoid(t, self.model_channels, cos_first=True, shift=0), prec)
        emb = self.time_embed[2](silu(emb), prec)
        h, hs = x, []
        for mods in self.input_blocks:
            h = self._run(mods, h, emb, context, prec)
            hs.append(h)
        h = self._run(self.middle_block, h, emb, context, prec)
        for mods in self.output_blocks:
            h = self._run(mods, torch.cat([h, hs.pop()], dim=-1), emb, context, prec)
        return self.out[2](silu(group_norm(h, self.out[0], 1e-5)), prec)
