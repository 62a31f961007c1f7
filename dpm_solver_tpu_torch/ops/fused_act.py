"""Fused bias-add + scaled LeakyReLU: two Triton kernels and their plain twins.

Replaces the Pallas kernel `dpm_solver_tpu/ops/fused_act.py::fused_bias_act`
(`_row_call` with `_fwd_kernel` and `_bwd_kernel`), itself the twin of the
reference's score_sde CUDA op (op/fused_bias_act_kernel.cu, op/fused_act.py):

    forward   out = scale * leaky_relu(x + bias, slope), bias over the last axis
    backward  dx  = g * (out >= 0 ? scale : slope * scale), db = sum of dx over rows

The forward saves only its output: the backward rebuilds the mask from the
output's sign (scale > 0 and leaky_relu keeps the sign), as the Pallas custom
VJP does. db is a torch sum over rows, as the JAX package leaves it to XLA.

What bounds it on the H100: two flops per element against 4-8 bytes read and
written per element (fp32 or bf16), so it is bound by HBM bandwidth
(3.35 TB/s). Each kernel is one masked 2-D pass over rows x channels: a block
of BLOCK_R rows and BLOCK_C channels, the bias row loaded once per block and
broadcast, the ragged row and channel tails masked (the Pallas wrapper pads
rows to its block multiple, `_pack_rows`; here nothing is copied). The
arithmetic is fp32 with one rounding of the result; slope and scale are
kernel arguments, so one compiled kernel serves every value. Triton's masked
block loads reach the bytes per second a CUDA kernel would here.

Nothing calls it on a sampling path: the JAX NCSN++ uses `jax.nn` activations
(`models/ncsnpp.py:157-163`), and so does the port.

Dispatch is by device only: CPU tensors take `bias_act_plain` (and its
autograd); CUDA tensors launch the kernels or raise. `fused_bias_act.launches`
counts forward launches, `fused_bias_act_bwd.launches` backward launches.
"""

from __future__ import annotations

import functools
import math

import torch

from dpm_solver_tpu_torch.ops import _build

SQRT2 = math.sqrt(2.0)
BLOCK_ELEMS = 4096  # elements of one block: BLOCK_R * BLOCK_C


def bias_act_plain(x: torch.Tensor, bias: torch.Tensor, negative_slope: float = 0.2,
                   scale: float = SQRT2) -> torch.Tensor:
    """The same function in plain PyTorch, in x's dtype (the JAX `bias_act_xla`)."""
    y = x + bias.to(x.dtype)
    return scale * torch.where(y >= 0, y, negative_slope * y)


def bias_act_grad_plain(g: torch.Tensor, out: torch.Tensor, negative_slope: float = 0.2,
                        scale: float = SQRT2) -> torch.Tensor:
    """dx from the cotangent and the saved output, in plain PyTorch."""
    return g * torch.where(out >= 0, scale, negative_slope * scale).to(g.dtype)


@functools.cache
def _kernels():
    import triton
    import triton.language as tl

    @triton.jit
    def bias_act_fwd(x_ptr, b_ptr, out_ptr, rows, cols, slope, scale,
                     BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
        r = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
        c = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = c < cols
        mask = (r[:, None] < rows) & cmask[None, :]
        offs = r[:, None].to(tl.int64) * cols + c[None, :]
        bias = tl.load(b_ptr + c, mask=cmask).to(tl.float32)
        y = tl.load(x_ptr + offs, mask=mask).to(tl.float32) + bias[None, :]
        out = scale * tl.where(y >= 0, y, slope * y)
        tl.store(out_ptr + offs, out.to(out_ptr.dtype.element_ty), mask=mask)

    @triton.jit
    def bias_act_bwd(g_ptr, o_ptr, dx_ptr, rows, cols, slope, scale,
                     BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
        r = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
        c = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
        mask = (r[:, None] < rows) & (c < cols)[None, :]
        offs = r[:, None].to(tl.int64) * cols + c[None, :]
        g = tl.load(g_ptr + offs, mask=mask).to(tl.float32)
        out = tl.load(o_ptr + offs, mask=mask).to(tl.float32)
        dx = g * tl.where(out >= 0, scale, slope * scale)
        tl.store(dx_ptr + offs, dx.to(dx_ptr.dtype.element_ty), mask=mask)

    return triton, bias_act_fwd, bias_act_bwd


def _check(x, other, what):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what} takes float32 or bfloat16 tensors, not {x.dtype}")
    if x.dim() == 0 or x.shape[-1] == 0:
        raise ValueError(f"{what} needs a channel axis")
    if other.device != x.device or not x.is_contiguous() or not other.is_contiguous():
        raise ValueError(f"{what} takes contiguous tensors on one device")


def _launch(kernel, a, b, out, cols, negative_slope, scale):
    triton = _kernels()[0]
    rows = a.numel() // cols
    block_c = min(triton.next_power_of_2(cols), 256)
    block_r = BLOCK_ELEMS // block_c
    grid = (triton.cdiv(rows, block_r), triton.cdiv(cols, block_c))
    with torch.cuda.device(a.device):
        kernel[grid](a, b, out, rows, cols, float(negative_slope), float(scale),
                     BLOCK_R=block_r, BLOCK_C=block_c, num_warps=4)
    return out


def _forward(x, bias, negative_slope, scale):
    if _build.device_type(x, "fused_bias_act") == "cpu":
        return bias_act_plain(x, bias, negative_slope, scale)
    bias = bias.to(torch.float32).contiguous()
    _check(x, bias, "fused_bias_act")
    if bias.shape != (x.shape[-1],):
        raise ValueError(f"fused_bias_act: bias {tuple(bias.shape)} is not ({x.shape[-1]},)")
    out = _launch(_kernels()[1], x, bias, torch.empty_like(x), x.shape[-1], negative_slope,
                  scale)
    fused_bias_act.launches += 1
    return out


def fused_bias_act_bwd(g: torch.Tensor, out: torch.Tensor, negative_slope: float = 0.2,
                       scale: float = SQRT2) -> torch.Tensor:
    """dx = g * (out >= 0 ? scale : slope * scale), in out's dtype."""
    if _build.device_type(out, "fused_bias_act_bwd") == "cpu":
        return bias_act_grad_plain(g.to(out.dtype), out, negative_slope, scale)
    g = g.to(out.dtype).contiguous()
    _check(out, g, "fused_bias_act_bwd")
    if g.shape != out.shape:
        raise ValueError("fused_bias_act_bwd: the cotangent and the output differ in shape")
    dx = _launch(_kernels()[2], g, out, torch.empty_like(out), out.shape[-1], negative_slope,
                 scale)
    fused_bias_act_bwd.launches += 1
    return dx


class _FusedBiasAct(torch.autograd.Function):
    """Autograd for `fused_bias_act`; saves only the output."""

    @staticmethod
    def forward(ctx, x, bias, negative_slope, scale):
        out = _forward(x, bias, negative_slope, scale)
        ctx.save_for_backward(out)
        ctx.negative_slope, ctx.scale, ctx.bias_dtype = negative_slope, scale, bias.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        out, = ctx.saved_tensors
        dx = fused_bias_act_bwd(g, out, ctx.negative_slope, ctx.scale)
        db = None
        if ctx.needs_input_grad[1]:
            db = dx.reshape(-1, dx.shape[-1]).float().sum(0).to(ctx.bias_dtype)
        return dx, db, None, None


def fused_bias_act(x: torch.Tensor, bias: torch.Tensor, negative_slope: float = 0.2,
                   scale: float = SQRT2) -> torch.Tensor:
    """scale * leaky_relu(x + bias, negative_slope); bias (C,) over x's last
    axis, any rank. Differentiable in x and bias."""
    if torch.is_grad_enabled() and (x.requires_grad or bias.requires_grad):
        return _FusedBiasAct.apply(x, bias, negative_slope, scale)
    return _forward(x, bias, negative_slope, scale)


fused_bias_act.launches = 0
fused_bias_act_bwd.launches = 0
