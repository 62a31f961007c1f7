"""Plain float32 building blocks of the reference networks, NHWC.

Every layer holds its parameters under the names and in the layouts of the
published torch checkpoints (Conv2d weights (O, I, kh, kw), Linear weights
(O, I)), so a state dict keyed as CompVis, OpenAI CLIP or the DDPM release
key theirs loads with `load_state_dict`. The arithmetic is plain PyTorch in
float32: `F.conv2d`, matmuls, a float32 softmax. Nothing here imports the
program under test.

`Precision` is the one switch of the arithmetic: "fp32" (the reference) or
"fp8" (the control: every product's operands rounded to float8 e4m3 with a
per-tensor scale for activations and a per-output-channel scale for
weights, the products then taken in float32).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = 448.0   # the largest finite float8 e4m3 value


def _fp8(x: torch.Tensor, dims) -> torch.Tensor:
    amax = x.abs().amax(dim=dims, keepdim=True).clamp_min(1e-12)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class Precision:
    """Where the operands of a product are rounded: nowhere ("fp32"), or to
    float8 e4m3 ("fp8")."""

    KINDS = ("fp32", "fp8")

    def __init__(self, kind: str = "fp32"):
        if kind not in self.KINDS:
            raise ValueError(f"precision must be one of {self.KINDS}, got {kind!r}")
        self.kind = kind

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return _fp8(x, tuple(range(x.dim()))) if self.kind == "fp8" else x

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        return _fp8(w, tuple(range(1, w.dim()))) if self.kind == "fp8" else w


FP32 = Precision("fp32")


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


class Norm(nn.Module):
    """The parameters of a GroupNorm or LayerNorm."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))


def group_norm(x: torch.Tensor, norm: Norm, eps: float, groups: int = 32) -> torch.Tensor:
    """GroupNorm over the channels of an NHWC tensor, groups of contiguous channels."""
    b, c = x.shape[0], x.shape[-1]
    xg = x.reshape(b, -1, groups, c // groups)
    var, mean = torch.var_mean(xg, dim=(1, 3), correction=0, keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return y * norm.weight + norm.bias


def layer_norm(x: torch.Tensor, norm: Norm, eps: float = 1e-5) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), norm.weight, norm.bias, eps)


class Conv(nn.Module):
    """Conv2d parameters, weight (O, I, k, k) and bias (O,)."""

    def __init__(self, cin: int, cout: int, k: int = 3, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        if bias:
            self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor, prec: Precision, stride: int = 1,
                padding: int = -1) -> torch.Tensor:
        k = self.weight.shape[-1]
        pad = k // 2 if padding < 0 else padding
        if k == 1:
            return F.linear(prec.act(x), prec.weight(self.weight[:, :, 0, 0]), self.bias)
        out = F.conv2d(prec.act(x).permute(0, 3, 1, 2), prec.weight(self.weight), self.bias,
                       stride=stride, padding=pad)
        return out.permute(0, 2, 3, 1)


class Linear(nn.Module):
    """Linear parameters, weight (O, I) and an optional bias (O,)."""

    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        if bias:
            self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor, prec: Precision) -> torch.Tensor:
        return F.linear(prec.act(x), prec.weight(self.weight), getattr(self, "bias", None))


class Embedding(nn.Module):
    def __init__(self, n: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(n, dim))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, scale: float,
              prec: Precision, mask: torch.Tensor = None, rows: int = 1024) -> torch.Tensor:
    """softmax(q k^T * scale + mask) v per head, float32; q (B, T, H*dh),
    k and v (B, S, H*dh). Queries go `rows` at a time, so the logits of a
    4,096-token map fit in memory."""
    b, t, inner = q.shape
    dh = inner // heads
    qh, kh, vh = (prec.act(u).reshape(b, -1, heads, dh).transpose(1, 2) for u in (q, k, v))
    out = []
    for r in range(0, t, rows):
        z = (qh[:, :, r:r + rows] @ kh.transpose(-1, -2)) * scale
        if mask is not None:
            z = z + mask[r:r + rows]
        p = torch.softmax(z, dim=-1)
        out.append(prec.act(p) @ vh)
    return torch.cat(out, dim=2).transpose(1, 2).reshape(b, t, inner)


def sinusoid(t: torch.Tensor, dim: int, cos_first: bool, shift: int) -> torch.Tensor:
    """Sinusoidal time embedding: freqs exp(-ln(10^4) * i / (half - shift)),
    [cos | sin] (OpenAI) or [sin | cos] (DDPM)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) / (half - shift)
                      * torch.arange(half, dtype=torch.float32, device=t.device))
    args = t.float()[:, None] * freqs[None, :]
    parts = (torch.cos(args), torch.sin(args)) if cos_first else (torch.sin(args), torch.cos(args))
    return torch.cat(parts, dim=-1)


def nearest_x2(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
