"""3x3 stride-1 SAME conv in NHWC: the hand-written CUDA kernel and its plain twin.

Counterpart of `dpm_solver_tpu/ops/conv3x3.py` (`conv3x3`, `Conv3x3`, and the
custom VJP `_conv3x3_bwd`). The public function keeps the JAX entry's layout:
x (B, H, W, C), w (3, 3, C, CO), bias (CO,), and is differentiable. The
kernels live in `csrc/conv3x3.cu`; its header says what they replace, what
bounds them on the H100 and how they are built.

Routes (`conv3x3_plan`, decided here and handed to the kernel): bf16 with C
and CO multiples of 8 (every conv of the sampling paths but the SD VAE's
conv_in, C = 4, and conv_out, CO = 3) takes "wgmma", the TMA-fed `wgmma`
kernel, whose block owns a 128-pixel output patch (w_t, h_t, b_t) chosen per
map size by `conv3x3_patch`; other bf16 shapes (TMA cannot stride rows that
are not a multiple of 16 bytes), and tensors off a 16-byte boundary, take
"narrow": an `mma.sync` kernel whose persistent blocks walk 16 x 16 output
patches (and 64-column passes of a wide CO), each patch's input with its
halo copied into shared memory and all 9 taps read there, its tile
(`narrow_tile`) fitted to the narrow side, on the weight laid out by
`narrow_weight`; fp32 takes "f32", the exact CUDA-core kernel, every C and
CO: a 128 x 128 output tile a block in a cp.async ring, and where those
tiles fill the card's 132 SMs badly, its reduction split into
`ConvPlan.split` contiguous ranges (`f32_split`) whose partial sums a
second pass adds in a fixed order (no atomics), so a launch is bitwise
repeatable.

The backward mirrors `_conv3x3_bwd`: dx is the same 3x3 SAME conv of the
cotangent with the spatially flipped, in/out-transposed weight, so it runs the
same kernel (`conv3x3_dx`): "wgmma" on `flip_weight`'s copy, "narrow" on
`narrow_weight`'s flipped layout, "f32" in the kernel's dx mode, which
reads the weight in place; dw is a library conv, as
the JAX package leaves it to XLA; db is a sum. Only the gradients autograd
asks for are computed: with frozen weights (classifier guidance, bits/dim)
that is dx alone.

Dispatch is by device only: a CPU tensor takes `conv3x3_plain`; a CUDA tensor
launches the kernel or raises. `conv3x3.launches` counts forward launches,
`conv3x3_dx.launches` the input-gradient launches; `.launches_by_route`
counts each by route.
"""

from __future__ import annotations

import dataclasses
import functools
from collections import Counter
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dpm_solver_tpu_torch.ops import _build
from dpm_solver_tpu_torch.ops.quant import check_mode, w8a8_conv, wants_conv_quant

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
WGMMA_ROUTE = 2   # dpm_conv3x3_fwd's route code ("narrow", "f32": their own entries)
PATCH_PIXELS = 128   # output pixels of one "wgmma" block: two warpgroups of 64
WGMMA_BLOCK_N = 128  # output channels of one "wgmma" block
WGMMA_STAGES = 3     # its ring of (128 x 64 input, 64 x 128 weight) bf16 tiles
# shared memory of one "wgmma" block (csrc/conv3x3.cu): the ring, 1024 bytes
# to align it to a swizzle atom, a full and an empty barrier per stage
WGMMA_SMEM = 1024 + WGMMA_STAGES * 2 * (PATCH_PIXELS * 64 + 64 * WGMMA_BLOCK_N) \
    + 16 * WGMMA_STAGES
# the "f32" kernel's tile (csrc/conv3x3.cu's F32_* constants, which
# tests/test_torch_kernel_plans.py holds equal): output pixels and channels
# a block, input channels of one tap a stage, the cp.async ring, threads;
# and the SMs whose waves the split reduction fills, one block an SM
F32_BLOCK_M = 128
F32_BLOCK_N = 128
F32_BLOCK_K = 16
F32_STAGES = 4
F32_THREADS = 256
F32_SMS = 132
F32_WAVE_FILL = 0.9   # the least share of the SMs every wave of blocks keeps busy
# a stage: the 128 x 16 input tile and the weight tile, each 128 rows of
# 16 + 4 floats (16-byte aligned rows, reads on distinct banks)
F32_SMEM = F32_STAGES * (F32_BLOCK_M + F32_BLOCK_N) * (F32_BLOCK_K + 4) * 4


# the "narrow" kernel (csrc/conv3x3.cu's NR_* constants, which
# tests/test_torch_kernel_plans.py holds equal): output patches of
# NARROW_PATCH (rows, pixels) of one image, each patch's input with the
# one-pixel halo in shared memory, a cp.async ring of NARROW_STAGES stages
NARROW_PATCH = (16, 16)
NARROW_STAGES = 2
NARROW_THREADS = 256
NARROW_HALO_PIXELS = (NARROW_PATCH[0] + 2) * (NARROW_PATCH[1] + 2)


def narrow_tile(cin: int, cout: int) -> Tuple[int, int]:
    """The "narrow" kernel's (kc, nt) for cin -> cout channels: kc input
    channels a stage (8 where cin <= 8, one m16n8k8 product a tap, so the
    VAE's 4 channels pad to 8; else 64 beside cout <= 8, four m16n8k16, and
    32 beside a wider cout, whose weight tile would not fit twice at 64),
    nt 8-column output tiles a pass (1 where cout <= 8: the VAE's 3 output
    channels pad to 8; else 8, 64-column passes, each a unit of work of its
    own)."""
    return (8 if cin <= 8 else 64 if cout <= 8 else 32), (1 if cout <= 8 else 8)


def narrow_smem(tile: Tuple[int, int]) -> int:
    """Dynamic shared memory of one "narrow" block: NARROW_STAGES stages of
    the halo patch's kc channels and the [9][8 nt][kc] weight tile, each row
    padded to an odd multiple of 16 bytes (distinct banks for ldmatrix)."""
    kc, nt = tile
    pitch = kc if kc == 8 else kc + 8
    return NARROW_STAGES * (NARROW_HALO_PIXELS + 9 * 8 * nt) * pitch * 2


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """route: "wgmma", "narrow" or "f32"; patch: the "wgmma" route's output
    patch (w_t, h_t, b_t), PATCH_PIXELS pixels, else (0, 0, 0); tile: the
    "narrow" route's (kc, nt) (`narrow_tile`), else (0, 0). For "f32":
    split, the contiguous ranges the reduction is cut into (each a block of
    the grid, summed by a second pass in range order). dx: the plan is an
    input gradient's, whose weight is read flipped ("f32": in place, the
    kernel's dx mode; "narrow": `narrow_weight`'s layout; "wgmma":
    `flip_weight`'s copy)."""

    route: str
    patch: Tuple[int, int, int] = (0, 0, 0)
    tile: Tuple[int, int] = (0, 0)
    split: int = 1
    dx: bool = False

    @property
    def f32_tile(self) -> Tuple[int, int, int, int]:
        """(block_m, block_n, block_k, stages): the tile the C entry checks."""
        return F32_BLOCK_M, F32_BLOCK_N, F32_BLOCK_K, F32_STAGES

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of one block of the route's kernel."""
        if self.route == "narrow":
            return narrow_smem(self.tile)
        return F32_SMEM if self.route == "f32" else WGMMA_SMEM

    def grid(self, x_shape, co: int) -> Tuple[int, int, int]:
        """The launch's work: "f32", its grid (pixel tiles, channel tiles,
        split); "narrow", (units, 1, 1), the (16 x 16 output patch, pass of
        8 nt output channels) pairs its persistent grid (at most the blocks
        the SMs hold) walks."""
        b, h, w, _ = x_shape
        if self.route == "narrow":
            ph, pw = NARROW_PATCH
            return (b * -(-h // ph) * -(-w // pw) * -(-co // (8 * self.tile[1])), 1, 1)
        return (-(-(b * h * w) // F32_BLOCK_M), -(-co // F32_BLOCK_N), self.split)

    def ranges(self, cin: int) -> list:
        """The "f32" reduction's [first, last) step of each split range; step s
        is tap s // ceil(cin / block_k), input channels from
        (s % ceil(cin / block_k)) * block_k."""
        steps = f32_steps(cin)
        return [(steps * z // self.split, steps * (z + 1) // self.split)
                for z in range(self.split)]


def f32_steps(cin: int) -> int:
    """Stages of the "f32" reduction: 9 taps x ceil(cin / F32_BLOCK_K)."""
    return 9 * -(-cin // F32_BLOCK_K)


def f32_split(x_shape, co: int) -> int:
    """The ranges the "f32" reduction is cut into. The kernel runs one block
    an SM, so blocks past a whole wave of F32_SMS start a second wave: the
    split is the least S >= max(1, F32_SMS // tiles) at which every wave of
    tiles x S blocks keeps F32_WAVE_FILL of the SMs busy, at most one range
    a step. Path E at b8: 2 tiles (4x4) -> 66, 8 (8x8) -> 16, 32 (16x16) ->
    4, 64 (32x32) -> 2: 128-132 blocks; 48 tiles -> 5 (240 blocks, two
    waves); from 128 tiles on mostly 1."""
    b, h, w, c = x_shape
    tiles = -(-(b * h * w) // F32_BLOCK_M) * -(-co // F32_BLOCK_N)
    split, steps = max(1, F32_SMS // tiles), f32_steps(c)
    while split < steps and tiles * split < F32_WAVE_FILL * F32_SMS * -(-tiles * split // F32_SMS):
        split += 1
    return min(split, steps)


def conv3x3_patch(b: int, h: int, w: int) -> Tuple[int, int, int]:
    """The 128-pixel output patch (w_t, h_t, b_t) of a (b, h, w) map: of the
    power-of-two boxes up to 16 columns wide, the one that tiles the map in
    the fewest patches, i.e. computes the fewest pixels past its edges (a
    tie goes to the wider, then the taller box: longer contiguous rows).
    16x8x1 at W = 32, 96 or 768, 8x8x2 at 8x8 and 24x24, 4x4x8 at 4x4 and
    12x12. The part of a patch past the map reads zeros and is not stored."""
    best = None
    for pw in (16, 8, 4, 2, 1):
        for ph in (128, 64, 32, 16, 8, 4, 2, 1):
            if pw * ph > PATCH_PIXELS:
                continue
            pb = PATCH_PIXELS // (pw * ph)
            tiles = -(-w // pw) * -(-h // ph) * -(-b // pb)
            if best is None or tiles < best[0]:
                best = (tiles, (pw, ph, pb))
    return best[1]


@functools.lru_cache(maxsize=4096)
def conv3x3_plan(x_shape, co: int, dtype: torch.dtype, aligned: bool = True,
                 dx: bool = False) -> ConvPlan:
    """The route and patch ("wgmma"), tile ("narrow") or split ("f32") for
    x (B, H, W, C) -> CO channels in `dtype`; `aligned`: x and w start on
    16-byte boundaries (TMA needs it); `dx`: the input gradient, x the
    cotangent (B, H, W, CO of the forward) and co the forward's C."""
    b, h, w, c = x_shape
    if dtype == torch.float32:
        return ConvPlan("f32", split=f32_split(tuple(x_shape), co), dx=dx)
    if c % 8 == 0 and co % 8 == 0 and aligned:
        return ConvPlan("wgmma", conv3x3_patch(b, h, w), dx=dx)
    return ConvPlan("narrow", tile=narrow_tile(c, co), dx=dx)


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The same function through `F.conv2d`, in x's dtype."""
    out = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
                   None if bias is None else bias.to(x.dtype), padding=1)
    return out.permute(0, 2, 3, 1).contiguous()


def _check(x, w, bias, dx=False):
    """x (B,H,W,Cin) and w (3,3,C,CO) with Cin = C, or (dx) Cin = CO."""
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3):
        raise ValueError(f"conv3x3 takes x (B,H,W,C) and w (3,3,C,CO); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if w.shape[3 if dx else 2] != x.shape[3]:
        raise ValueError(f"conv3x3{'_dx' if dx else ''}: w {tuple(w.shape)} does not take "
                         f"{x.shape[3]} input channels")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"conv3x3 kernel takes float32 or bfloat16 x and w of one "
                        f"dtype; got {x.dtype} and {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv3x3 kernel needs contiguous x and w")
    if w.device != x.device or (bias is not None and bias.device != x.device):
        raise ValueError("conv3x3: x, w and bias must share a device")
    if bias is not None and (bias.shape != (w.shape[3],) or bias.dtype != torch.float32
                             or not bias.is_contiguous()):
        raise ValueError(f"conv3x3 kernel takes a contiguous float32 bias of shape "
                         f"({w.shape[3]},)")
    if x.numel() >= 2**31 or w.numel() >= 2**31:
        raise ValueError("conv3x3 kernel takes fewer than 2**31 elements per tensor")


def narrow_weight(w: torch.Tensor, tile: Tuple[int, int], dx: bool = False) -> torch.Tensor:
    """The (3, 3, C, CO) weight in the layout the "narrow" kernel copies:
    [9][npad][cpad], for each tap each output channel's input channels
    contiguous, zero past them (cpad a multiple of kc, npad of 8 nt), so its
    copies are unmasked 16-byte ones. dx: the input gradient's weight, the
    taps flipped, its outputs C and its inputs CO."""
    kc, nt = tile
    taps = (w.flip(0, 1) if dx else w).reshape(9, w.shape[2], w.shape[3])
    rows = taps if dx else taps.transpose(1, 2)   # [tap][output][input]
    n, k = rows.shape[1:]
    return F.pad(rows, (0, -(-k // kc) * kc - k, 0, -(-n // (8 * nt)) * 8 * nt - n)).contiguous()


def _launch(x, w, bias, counter, dx=False):
    """One launch of the plan's kernel; `dx`: the input gradient of the
    (3,3,C,CO) weight w at cotangent x, w read flipped: in place ("f32"), in
    `narrow_weight`'s layout ("narrow") or from `flip_weight`'s copy
    ("wgmma")."""
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()
    _check(x, w, bias, dx)
    b, h, wd, c = x.shape
    co = w.shape[2] if dx else w.shape[3]
    # a bf16 dx reads a fresh, aligned copy of the weight
    plan = conv3x3_plan(x.shape, co, x.dtype, aligned=x.data_ptr() % 16 == 0
                        and (dx or w.data_ptr() % 16 == 0), dx=dx)
    out = torch.empty((b, h, wd, co), dtype=x.dtype, device=x.device)
    bias_ptr = None if bias is None else bias.data_ptr()
    stream = _build.stream_ptr(x.device)
    if plan.route == "f32":
        ws = (torch.empty((plan.split, b * h * wd, co), dtype=torch.float32, device=x.device)
              if plan.split > 1 else None)
        code = _build.library().dpm_conv3x3_f32(
            x.data_ptr(), w.data_ptr(), bias_ptr, out.data_ptr(),
            None if ws is None else ws.data_ptr(), b, h, wd, c, co, int(plan.dx),
            *plan.f32_tile, plan.split, stream)
    elif plan.route == "narrow":
        wp = narrow_weight(w, plan.tile, dx)
        code = _build.library().dpm_conv3x3_narrow(
            x.data_ptr(), wp.data_ptr(), bias_ptr, out.data_ptr(), b, h, wd, c, co,
            *plan.tile, *NARROW_PATCH, NARROW_STAGES, stream)
    else:
        wt = flip_weight(w) if dx else w
        code = _build.library().dpm_conv3x3_fwd(
            x.data_ptr(), wt.data_ptr(), bias_ptr, out.data_ptr(), b, h, wd, c, co,
            WGMMA_ROUTE, *plan.patch, stream)
    _build.check(code, counter.__name__)
    counter.launches += 1
    counter.launches_by_route[plan.route] += 1
    return out


def _forward(x, w, bias):
    if _build.device_type(x, "conv3x3") == "cpu":
        return conv3x3_plain(x, w, bias)
    return _launch(x, w, bias, conv3x3)


def flip_weight(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, CO) -> the (3, 3, CO, C) weight whose SAME conv is the
    input gradient: spatially flipped, in and out channels swapped."""
    return w.flip(0, 1).transpose(2, 3).contiguous()


def conv3x3_dx(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Input gradient of `conv3x3` at cotangent g (B, H, W, CO): the 3x3 SAME
    conv of g with `flip_weight(w)`, through the same kernels (`_launch`)."""
    if _build.device_type(g, "conv3x3_dx") == "cpu":
        return conv3x3_plain(g, flip_weight(w))
    return _launch(g.contiguous(), w.contiguous(), None, conv3x3_dx, dx=True)


class _Conv3x3Fn(torch.autograd.Function):
    """Autograd for `conv3x3`; keeps x only when dw is asked for."""

    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None, w)
        ctx.bias_dtype = None if bias is None else bias.dtype
        return _forward(x, w, bias)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = conv3x3_dx(g, w)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(
                x.permute(0, 3, 1, 2), (w.shape[3], w.shape[2], 3, 3),
                g.permute(0, 3, 1, 2), padding=1).permute(2, 3, 1, 0)
        if ctx.bias_dtype is not None and ctx.needs_input_grad[2]:
            db = g.float().sum((0, 1, 2)).to(ctx.bias_dtype)
        return dx, dw, db


def conv3x3(x: torch.Tensor, w: torch.Tensor,
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """3x3 stride-1 SAME NHWC conv; x (B,H,W,C), w (3,3,C,CO), bias (CO,).
    Differentiable in x, w and bias."""
    if torch.is_grad_enabled() and any(u is not None and u.requires_grad for u in (x, w, bias)):
        return _Conv3x3Fn.apply(x, w, bias)
    return _forward(x, w, bias)


conv3x3.launches = 0
conv3x3.launches_by_route = Counter()
conv3x3_dx.launches = 0
conv3x3_dx.launches_by_route = Counter()


class Conv3x3(nn.Module):
    """`nn.Conv2d(C, CO, 3, padding=1)` on NHWC tensors, through `conv3x3`.

    Stores the reference layout, weight (CO, C, 3, 3) and bias (CO,), so
    reference state dicts load unchanged. The weight is permuted to
    (3, 3, C, CO) and cast to the compute dtype on every call: at most
    3*3*512*256 values, one small copy beside the conv itself.

    `quant="w8a8_conv"` (the JAX `Conv3x3(quant=)`) computes it with
    `ops.quant.w8a8_conv` from the fp32 weight instead; the other modes
    (None, "w8a8") take the kernel.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 compute_dtype: torch.dtype = torch.float32, quant: Optional[str] = None):
        super().__init__()
        check_mode(quant)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 3, 3))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.compute_dtype, self.quant = compute_dtype, quant
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if wants_conv_quant(self.quant):
            return w8a8_conv(x.to(dt), self.weight.permute(2, 3, 1, 0), self.bias)
        w = self.weight.permute(2, 3, 1, 0).to(dt).contiguous()
        return conv3x3(x.to(dt).contiguous(), w, self.bias)
