"""Cross-attention SpatialTransformer stack (Stable Diffusion's conditioning path), NHWC.

Port of `dpm_solver_tpu/models/transformer.py`, twin of the reference
ldm/modules/attention.py: CrossAttention (:152-195), GEGLU/FeedForward
(:37-65), BasicTransformerBlock (:196-215) and SpatialTransformer (:218-261).
Parameter names are the reference's state-dict keys (`attn1.to_q`,
`attn1.to_out.0`, `ff.net.0.proj`, `ff.net.2`, `norm1`, `proj_in`,
`transformer_blocks.0`, ...) in its layouts.

Where the kernels run (every call, whatever the shape; the JAX package's
measured v5e routing tables are not carried over):
- norm1 -> the self-attention's q|k|v: `ops.ln_linear`, one (d, 3*inner)
  weight made of to_q|to_k|to_v; q, k and v are column slices of its output,
  which the attention kernel reads in place;
- norm2 -> the cross-attention's to_q: `ops.ln_linear`;
- norm3: a plain fp32 LayerNorm, then `ops.geglu_ff`;
- both attentions: `ops.token_attention`.
The key/value projections of the context, to_out and proj_in/proj_out are
library matmuls.

Under `quant` ("w8a8" or "w8a8_conv", the JAX int8 serving path,
`ops/quant.py`): q/k/v, to_out and a linear proj_in are `QuantLinear`
(W8A8 products), the feed-forward is `w8a8_geglu`, and each pre-LN runs
apart (fp32, cast to the compute dtype) before its int8 product, as the JAX
modules do (transformer.py:94-117, :168-174): neither `ln_linear` nor
`geglu_ff` launches. The attention stays `token_attention`; proj_out
(zero-initialised) and the 1x1-conv projections stay float. The kernels
take the weights in torch's Linear layout, as the modules hold them.
Dtypes are placed by hand: parameters fp32, cast to `compute_dtype` where
they are used (the q|k|v weight is concatenated in the same cast, on every
call: the reference's separate to_q/to_k/to_v keys stay the only copy);
LayerNorm and GroupNorm statistics fp32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from dpm_solver_tpu_torch.models.ddpm_unet import Conv1x1, GroupNorm32, Linear
from dpm_solver_tpu_torch.ops import quant as q8
from dpm_solver_tpu_torch.ops.attention import token_attention
from dpm_solver_tpu_torch.ops.geglu import geglu_ff
from dpm_solver_tpu_torch.ops.ln_linear import layer_norm_fp32, ln_linear
from dpm_solver_tpu_torch.ops.quant import QuantLinear, check_mode, w8a8_geglu, wants_dense_quant
from dpm_solver_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


class CrossAttention(nn.Module):
    """Multi-head attention; keys/values from `context` (defaults to x itself).

    to_q/to_k/to_v are bias-free, to_out has a bias (attention.py:161-168).
    x arrives un-normalised; `ln` (a LayerNorm holding the pre-norm's weight
    and bias) is fused into the query projection (q|k|v for self-attention)
    through `ops.ln_linear`. The context is never normalised (attention.py:206
    norms only the query stream). Under `quant` the projections are
    `QuantLinear` and the pre-norm runs apart.
    """

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: Optional[int] = None, compute_dtype: torch.dtype = torch.float32,
                 quant: Optional[str] = None):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head, self.compute_dtype = heads, dim_head, compute_dtype
        check_mode(quant)
        self.quant = quant

        def proj(i, o, bias=False):
            if wants_dense_quant(quant):
                return QuantLinear(i, o, bias, compute_dtype)
            return nn.Linear(i, o, bias=bias)

        self.to_q = proj(query_dim, inner)
        self.to_k = proj(context_dim or query_dim, inner)
        self.to_v = proj(context_dim or query_dim, inner)
        self.to_out = nn.ModuleList([proj(inner, query_dim, bias=True)])

    def forward(self, x: torch.Tensor, ln: nn.LayerNorm,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        if wants_dense_quant(self.quant):
            return self._forward_quant(x, ln, context)
        dt = self.compute_dtype
        inner = self.heads * self.dim_head
        x = x.to(dt)

        def project(weight):  # the pre-norm fused into the query-side projection
            return ln_linear(x, ln.weight, ln.bias, weight.to(dt), eps=ln.eps)

        if context is None:
            # self-attention: one (3*inner, d) product, q/k/v read in place
            qkv = project(torch.cat([self.to_q.weight, self.to_k.weight, self.to_v.weight]))
            q, k, v = qkv.split(inner, dim=-1)
        else:
            q = project(self.to_q.weight)
            ctx = context.to(dt)
            k, v = F.linear(ctx, self.to_k.weight.to(dt)), F.linear(ctx, self.to_v.weight.to(dt))
        out = token_attention(q, k, v, num_heads=self.heads, scale=self.dim_head ** -0.5)
        proj = self.to_out[0]
        return F.linear(out, proj.weight.to(dt), proj.bias.to(dt))

    def _forward_quant(self, x, ln, context):
        """The JAX quant branch: xn = LN(x) in fp32, cast to the compute
        dtype; W8A8 q|k|v (one product: the per-row scales are xn's either
        way, the per-column ones each weight's) or q from xn and k, v from
        the context as it comes; W8A8 to_out."""
        dt = self.compute_dtype
        inner = self.heads * self.dim_head
        xn = layer_norm_fp32(x, ln.weight, ln.bias, eps=ln.eps).to(dt)
        if context is None:
            w = torch.cat([self.to_q.weight, self.to_k.weight, self.to_v.weight])
            q, k, v = q8.w8a8_matmul(xn, w, out_dtype=dt).split(inner, dim=-1)
        else:
            q, k, v = self.to_q(xn), self.to_k(context), self.to_v(context)
        out = token_attention(q, k, v, num_heads=self.heads, scale=self.dim_head ** -0.5)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    """Holds the gated in-projection `proj` (dim -> 2 * inner: [h | gate])."""

    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * inner)


class GEGLUFeedForward(nn.Module):
    """FeedForward with the gated-GELU projection (attention.py:37-65; SD
    always gates, glu=True), through `ops.geglu_ff`, after the pre-norm `ln`
    (norm3) as a plain fp32 LayerNorm; under `quant`, through `w8a8_geglu`."""

    def __init__(self, dim: int, mult: int = 4, compute_dtype: torch.dtype = torch.float32,
                 quant: Optional[str] = None):
        super().__init__()
        check_mode(quant)
        inner = dim * mult
        self.compute_dtype, self.quant = compute_dtype, quant
        # reference keys: net.0.proj, net.2 (net.1 is the parameter-free dropout)
        self.net = nn.ModuleList([GEGLU(dim, inner), nn.Dropout(0.0), nn.Linear(inner, dim)])

    def forward(self, x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
        dt = self.compute_dtype
        x = layer_norm_fp32(x, ln.weight, ln.bias, eps=ln.eps)
        proj, out = self.net[0].proj, self.net[2]
        if wants_dense_quant(self.quant):
            return w8a8_geglu(x.to(dt), proj.weight, proj.bias, out.weight, out.bias)
        return geglu_ff(x.to(dt), proj.weight.to(dt), proj.bias, out.weight.to(dt), out.bias)


class TransformerBlock(nn.Module):
    """Pre-LayerNorm self-attention -> cross-attention(context) -> GEGLU MLP
    (BasicTransformerBlock, attention.py:196-215). The three LayerNorms hold
    parameters only; the sub-modules apply them (fused where a kernel takes
    them)."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: Optional[int] = None,
                 compute_dtype: torch.dtype = torch.float32, quant: Optional[str] = None):
        super().__init__()
        self.attn1 = CrossAttention(dim, heads, dim_head, None, compute_dtype, quant)
        self.ff = GEGLUFeedForward(dim, compute_dtype=compute_dtype, quant=quant)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim, compute_dtype, quant)
        self.norm1, self.norm2, self.norm3 = nn.LayerNorm(dim), nn.LayerNorm(dim), nn.LayerNorm(dim)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn1(x, self.norm1)
        x = x + self.attn2(x, self.norm2, context=context)
        return x + self.ff(x, self.norm3)


class SpatialTransformer(nn.Module):
    """GroupNorm -> 1x1 proj -> transformer over HW tokens -> out proj,
    residual (attention.py:218-261). NHWC in and out.

    `linear_proj` uses token-space Linear projections instead of 1x1 convs:
    the SD-2.x `use_linear_in_transformer` variant (the same math; the
    checkpoint weight ranks differ). Built on `device`, the card by default.
    `quant`: the blocks' int8 mode; a linear proj_in is then `QuantLinear`.
    """

    def __init__(self, in_channels: int, heads: int, dim_head: int, depth: int = 1,
                 context_dim: Optional[int] = None, linear_proj: bool = False,
                 compute_dtype: torch.dtype = torch.float32, device=DEFAULT_DEVICE,
                 quant: Optional[str] = None):
        super().__init__()
        check_mode(quant)
        inner = heads * dim_head
        dt = compute_dtype
        with torch.device(resolve_device(device)):
            self.norm = GroupNorm32(in_channels, eps=1e-6)
            proj = Linear if linear_proj else Conv1x1
            self.proj_in = (QuantLinear(in_channels, inner, compute_dtype=dt)
                            if linear_proj and wants_dense_quant(quant)
                            else proj(in_channels, inner, dt))
            self.transformer_blocks = nn.ModuleList(
                [TransformerBlock(inner, heads, dim_head, context_dim, dt, quant)
                 for _ in range(depth)])
            self.proj_out = proj(inner, in_channels, dt)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, hh, ww, c = x.shape
        h = self.proj_in(self.norm(x)).reshape(b, hh * ww, -1)
        for block in self.transformer_blocks:
            h = block(h, context=context)
        return x + self.proj_out(h).reshape(b, hh, ww, c)
