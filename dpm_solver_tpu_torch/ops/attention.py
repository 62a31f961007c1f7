"""Attention, forward and backward: the hand-written CUDA kernels and their plain twins.

Counterpart of `dpm_solver_tpu/ops/attention.py` (`token_attention`, whose
Pallas paths are `fused_attention` / `flash_attention` and their custom VJPs).
`token_attention` keeps the JAX head-major interface: q (B, T, H*dh) and
k, v (B, S, H*dh) in, (B, T, H*dh) out, and is differentiable.

Forward: one kernel, in `csrc/attention.cu`, stands in for all four Pallas
forwards (`_forward`, `_flash_forward`, `_flash_forward_T`,
`_panel_forward_T`), which compute the same function: in bf16 a TMA + `wgmma`
kernel (route "wgmma"), in fp32 an exact CUDA-core one (route "f32"). It
takes every head dim of the presets (`FWD_HEAD_DIMS`): 32, 40, 64, 80, 96,
128, 160, 192, 256, 384, 512, 576 and 960 (40/80/160: SD-1's heads; 96 and
192: the ADM ImageNet-64 and -128 presets'; 512: the VAE's single mid-block
head; 384, 576 and 960: the class-conditional LDM's single heads, cin256).
The tile each head dim runs
(queries a block, keys a tile, the reduction padded to whole 64-column
swizzle tiles, output columns a block, ring stages) is chosen here,
`attention_plan`, and handed to the kernel, which refuses any other. q, k
and v need unit stride along the channels only: the column slices of one
fused qkv projection are read in place, not copied. The JAX package's v5e
gate (Pallas only for S >= 1024) is not carried over.

Backward (when autograd asks for it): the forward also writes each row's
base-2 log-sum-exp (`attention_lse`, the port of the Pallas side pass `_lse`),
and two kernels in `csrc/attention_bwd.cu` rebuild P from it:
`attention_dq` and `attention_dkv`, the port of `_mha_backward`'s dq and dk/dv
kernels, at every head dim of the forward (`FWD_HEAD_DIMS`) in both dtypes:
in bf16 TMA + `wgmma` kernels (route "wgmma"; at dh 960, whose two owned
64-row operands do not fit a block, streaming both sides in 64-column
chunks), in fp32 exact CUDA-core ones ("f32"). Their
tiles per head dim and dtype are fixed in the C source; `attention_bwd_plan`
states the same rule, for the shared-memory figure and the grid.
`delta = rowsum(dO * O)` is a torch op, as the JAX package leaves it outside
its kernels.

Attention with its out-projection and residual (`attention_out_fused`, the
port of `_attn_out_forward`): one kernel in `csrc/attention_out.cu` keeps the
heads' outputs in shared memory and multiplies them by w_out there, at every
head dim with H*dh up to 1280: in bf16 the forward's TMA + `wgmma` mainloop
with the projection as its epilogue (route "wgmma"), in fp32 exact CUDA-core
blocks ("f32"); `attention_out_plan` chooses the tile. Its backward is the
recompute VJP of the unfused composition, as in the JAX package. Like
there, no model calls it (`attn_out_fused_wins`).

Dispatch is by device only: a CPU tensor takes the plain twin
(`attention_plain`, `attention_lse_plain`, `attention_backward_plain`,
`attention_out_plain`); a CUDA tensor launches the kernel or raises. Each of
`token_attention`, `attention_lse`, `attention_dq`, `attention_dkv` and
`attention_out_fused` counts its own kernel launches in `.launches`: a
forward that writes the lse counts under `attention_lse` only.
`token_attention`, `attention_lse`, `attention_dq`, `attention_dkv` and
`attention_out_fused` also count them by route, in `.launches_by_route`.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from collections import Counter
from typing import Optional, Tuple

import torch

from dpm_solver_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the head dims of the fused out-projection (and the forward's and the
# backward's first set)
HEAD_DIMS = (32, 40, 64, 80, 128, 160, 256, 512)
# the forward's (its lse's, the backward's): every head dim of the port's presets
# (ADMConfig.*, DDPMUNetConfig.*, NCSNppConfig.*, the VAEs' mid-blocks, the
# BERT embedder's 64)
FWD_HEAD_DIMS = (32, 40, 64, 80, 96, 128, 160, 192, 256, 384, 512, 576, 960)
WIDE_DV = 192  # output columns a bf16 block owns at the single heads past 256 but 512
_LOG2E = math.log2(math.e)
SMEM_PER_BLOCK = 232448  # bytes of shared memory one block may use on the H100


@dataclasses.dataclass(frozen=True)
class AttentionTile:
    """The tile the forward kernel runs at one head dim and dtype.

    route: "wgmma" (bf16: TMA-fed `wgmma`, one producer warp and
    block_q / 64 consumer warpgroups) or "f32" (exact, CUDA cores,
    register-tiled: csrc/attention_f32.cuh). block_q: queries a block;
    block_kv: keys a tile; d_pad: the q/k width as staged in shared memory
    (bf16: 64-column swizzle tiles: TMA fills columns past dh with zeros;
    fp32: dh); dv: output columns one block owns (dh, 256 of the 512-wide
    head, WIDE_DV of 384, 576 and 960: grid.z = dh / dv; fp32 splits further
    where a launch has few blocks, `grid`); stages: K/V ring depth (fp32:
    cp.async buffers, two where they fit, one at dh 960). The bf16 kernel overlaps each key tile's softmax with the
    previous tile's P.V product at dh <= 64 (csrc/attention.cu's header
    says why only there)."""

    route: str
    block_q: int
    block_kv: int
    d_pad: int
    dv: int
    stages: int

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of one block (csrc/attention.cu's layout)."""
        if self.route == "f32":  # the queries (pitch dh + 2, + 4 at 16 slices), two
            # buffers of k and v rows (pitch dh + 2), the logits (pitch tile + 1),
            # three row stats
            dh = self.d_pad
            po = dh + (4 if _f32_parts(dh) == 16 else 2)
            return 4 * (F32_ROWS * po + self.stages * 2 * self.block_kv * (dh + 2)
                        + F32_ROWS * (self.block_kv + 1) + 3 * F32_ROWS)
        dv_pad = -(-self.dv // 64) * 64
        stage = 128 * self.block_kv * (self.d_pad + dv_pad) // 64
        # + 1024 to align to a swizzle atom, + the q, full and empty barriers
        return 1024 + 128 * self.block_q * self.d_pad // 64 + self.stages * stage \
            + 8 * (1 + 2 * self.stages)

    def grid(self, b: int, t: int, heads: int) -> Tuple[int, int, int]:
        """(query tiles, B*H, output column slices) of one launch. bf16: the
        tile's slices (dh / dv). fp32: while the blocks are fewer than
        F32_MIN_BLOCKS and the head splits into halves of whole 64-column
        runs, twice the slices (path E's 4x4 mid-block, T = 16 at b8 with
        dh 256: 8 blocks -> 32; its 16x16 site's 128 blocks stay whole)."""
        blocks = -(-t // self.block_q) * b * heads
        if self.route != "f32":  # dv < dh only in whole 64-column runs (256, WIDE_DV)
            return blocks // (b * heads), b * heads, self.d_pad // self.dv if self.dv % 64 == 0 else 1
        slices = 1
        while blocks * slices < F32_MIN_BLOCKS and self.dv % (128 * slices) == 0:
            slices *= 2
        return blocks // (b * heads), b * heads, slices

    def launch_dv(self, b: int, t: int, heads: int) -> int:
        """The output columns one block of this launch owns."""
        return self.dv // self.grid(b, t, heads)[2] if self.route == "f32" else self.dv


@functools.lru_cache(maxsize=None)
def attention_plan(dh: int, dtype: torch.dtype = torch.bfloat16) -> AttentionTile:
    """The forward's tile for head dim `dh`: 128 queries (two consumer
    warpgroups) and 128-key tiles up to dh 128, 64-key tiles at 160 and 256
    (whose q and K/V stages would not fit 227 KB otherwise), and for the
    512-wide head one warpgroup, 32-key tiles and two 256-wide output
    halves; dh 96 and 192 as 80 and 160. The single heads of 384, 576 and
    960: one warpgroup, WIDE_DV-column output slices and the widest key
    tile of 64, 32 or 16 whose two stages fit beside the q tile (64, 32,
    16). fp32: 16 queries (F32_ROWS) and key tiles of F32_THREADS / parts
    keys (128 up to dh 80, 64 at 96 to 160, 32 at 192 and 256, 16 from
    384), two cp.async buffers where they fit (one at dh 960): the
    register-tiled rule the fp32 backward keeps (csrc/attention_f32.cuh)."""
    if dh not in FWD_HEAD_DIMS:
        raise ValueError(f"attention kernel takes head dims {FWD_HEAD_DIMS}, got {dh}")
    if dtype == torch.float32:
        tile = AttentionTile("f32", F32_ROWS, F32_THREADS // _f32_parts(dh), dh, dh, F32_STAGES)
        return tile if tile.smem_bytes <= SMEM_PER_BLOCK else dataclasses.replace(tile, stages=1)
    d_pad = -(-dh // 64) * 64
    if dh == 512:
        return AttentionTile("wgmma", 64, 32, d_pad, 256, 2)
    if dh > 256:
        return next(tile for tile in (AttentionTile("wgmma", 64, kv, d_pad, WIDE_DV, 2)
                                      for kv in (64, 32, 16))
                    if tile.smem_bytes <= SMEM_PER_BLOCK)
    if dh >= 160:
        return AttentionTile("wgmma", 128, 64, d_pad, dh, 2)
    return AttentionTile("wgmma", 128, 128, d_pad, dh, 2 if dh >= 80 else 3)


# The backward's tile rule (csrc/attention_bwd.cu states it with the same
# constants, at compile time; tests/test_torch_kernel_plans.py holds the two
# together). bf16: one consumer warpgroup owns 64 rows a block and streams
# the widest tile (64, 32 or 16 rows) whose registers stay within the budget
# and whose two stages fit a block; a third stage where it costs no block an
# SM. Output columns: the whole head up to 256, 256-column slices of 512,
# WIDE_DV-column slices of the single heads 384, 576 and 960. Where the two
# owned 64-row operands and two stages of the narrowest tile do not fit
# (dh 960: 240 KB for the owned operands alone) the block owns no operand:
# it streams both sides in 64-column chunks ("chunked": a ring of
# BF16_CHUNK_STAGES stages of one chunk of the owned rows and of the
# streamed tile, and, after a tile's chunks, one stage of the tile's output
# columns). fp32: 16 owned rows; 256 threads make 4x4 patches of z and dp,
# each patch split over the head dim into `parts` slices of at most
# F32_SLICE columns (16 at most), so a streamed tile is 256 / parts rows;
# two cp.async buffers where they fit, else one; where even one does not
# (dh 960), 32 parts (a warp a patch) and 8-row tiles. dk/dv keeps both
# outputs in a block where their sums fit the register budget, else one
# output a block (grid.z).
BF16_ROWS = 64            # owned rows a bf16 block (its consumer warpgroup)
BF16_THREADS = 160        # the warpgroup and one producer warp
BF16_MAX_COLS = 256       # output columns a block: dh 512 in two slices
BF16_REG_BUDGET = 176     # sums + logits + fragments, registers a thread
BF16_MAX_STAGES = 3
BF16_CHUNK_STAGES = 4     # the chunked ring's depth (dh 960)
BF16_BLOCKS_PER_SM = 2    # what the register budget lets share an SM
SM_SMEM = 233472          # shared memory of one SM (1 KB of it kept per block)
F32_ROWS = 16             # owned rows an fp32 block
F32_THREADS = 256
F32_SLICE = 40            # head-dim columns a phase-1 lane sums, at most
F32_STAGES = 2            # the fp32 forward's K/V buffers where they fit (csrc/attention.cu)
F32_MIN_BLOCKS = 128      # the fp32 forward splits its output columns below this
F32_REG_BUDGET = 128      # phase-1 partial sums + the output sums, registers a thread


def _pad64(d: int) -> int:
    return -(-d // 64) * 64


def _bf16_cols(dh: int) -> int:
    """Output columns a bf16 block accumulates."""
    return dh if dh <= BF16_MAX_COLS else BF16_MAX_COLS if dh % BF16_MAX_COLS == 0 else WIDE_DV


def _bf16_regs(outs: int, cols: int, tile: int) -> int:
    """fp32 registers a thread: the sums, the logits and dp, the p and ds fragments."""
    return outs * cols // 2 + 3 * tile // 2


def _bf16_smem(dh: int, tile: int, stages: int, dkv: bool, chunked: bool = False) -> int:
    """A bf16 block's dynamic shared memory: + 1024 to align a swizzle atom;
    the two owned operands and the ring of streamed tiles (chunked: the ring
    of chunk stages, each a 64-column chunk of two owned and two streamed
    operands), (dk/dv) each stage's lse and delta rows, the owned, full and
    empty barriers."""
    if chunked:
        body = stages * 2 * (BF16_ROWS + tile) * 128
    else:
        body = 2 * BF16_ROWS * _pad64(dh) * 2 + stages * 2 * tile * _pad64(dh) * 2
    return 1024 + body + (stages * 2 * tile * 4 if dkv else 0) + 8 * (1 + 2 * stages)


def _f32_parts(dh: int) -> int:
    """Head-dim slices of an fp32 phase-1 patch: a power of two >= 2 with
    slices of at most F32_SLICE columns, at most 16 (past dh 640 a slice is
    wider: the forward's dh 960 sums 60 columns a lane)."""
    parts = 2
    while parts * F32_SLICE < dh and parts < 16:
        parts *= 2
    return parts


def _f32_bwd_smem(dh: int, parts: int, bufs: int) -> int:
    """An fp32 backward block's dynamic shared memory: the owned rows (pitch
    dh + 2 | 4), `bufs` buffers of two streamed tiles (pitch dh + 2) and
    their lse and delta, p and ds (pitch tile + 1), the owned rows' lse and
    delta."""
    tile = F32_THREADS // parts
    po, ps = dh + (4 if parts == 16 else 2), dh + 2
    return 4 * (2 * F32_ROWS * po + bufs * (2 * tile * ps + 2 * tile)
                + 2 * F32_ROWS * (tile + 1) + 2 * F32_ROWS)


def _bf16_blocks(smem: int) -> int:
    return min(SM_SMEM // (smem + 1024), BF16_BLOCKS_PER_SM)


@dataclasses.dataclass(frozen=True)
class BwdKernelTile:
    """The tile one backward kernel runs (`attention_bwd_plan`).

    kernel: "dq" (a block owns queries and streams keys) or "dkv" (owns
    keys, streams queries). rows: the rows a block owns; tile: the rows a
    streamed tile holds; cols: the output columns a block accumulates (dh,
    256 of the 512-wide head, WIDE_DV of 384, 576 and 960); outs: the
    outputs a dk/dv block accumulates (2: dk and dv; 1: one, the other in a
    second block of the grid, which recomputes the logits); stages: the
    ring's depth ("f32": cp.async buffers); chunked: bf16 streams the owned
    rows too, in 64-column chunks (dh 960)."""

    route: str
    kernel: str
    dh: int
    rows: int
    tile: int
    cols: int
    outs: int
    stages: int
    chunked: bool = False

    @property
    def slices(self) -> int:
        """Output column slices, each its own block (grid.z)."""
        return self.dh // self.cols

    @property
    def passes(self) -> int:
        """Blocks that split one dk/dv row tile's two outputs (grid.z)."""
        return 2 // self.outs if self.kernel == "dkv" else 1

    @property
    def parts(self) -> int:
        """fp32: head-dim slices of a phase-1 patch (F32_THREADS / tile)."""
        return F32_THREADS // self.tile

    def col_slices(self) -> list:
        """[start, stop) of each block's output columns."""
        return [(i * self.cols, (i + 1) * self.cols) for i in range(self.slices)]

    @property
    def regs(self) -> int:
        """fp32 registers a thread (csrc/attention_bwd.cu: "wgmma" the sums,
        the logits and dp and the p/ds fragments; "f32" the phase-1 partial
        sums and the 4 x ceil(dh/64) output sums of each output)."""
        if self.route == "f32":
            return 32 + 4 * -(-self.dh // 64) * self.outs
        return _bf16_regs(self.outs, self.cols, self.tile)

    @property
    def reg_budget(self) -> int:
        return F32_REG_BUDGET if self.route == "f32" else BF16_REG_BUDGET

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of one block (csrc/attention_bwd.cu's layout)."""
        if self.route == "f32":
            return _f32_bwd_smem(self.dh, self.parts, self.stages)
        return _bf16_smem(self.dh, self.tile, self.stages, self.kernel == "dkv", self.chunked)

    def grid(self, b: int, t: int, s: int, heads: int) -> tuple:
        """(row tiles, B*H, slices x passes) at queries t, keys s."""
        owned = s if self.kernel == "dkv" else t
        return (-(-owned // self.rows), b * heads, self.slices * self.passes)


@dataclasses.dataclass(frozen=True)
class AttentionBwdTile:
    """The tiles the dq and dk/dv kernels run at one head dim and dtype.
    route: "wgmma" (bf16: TMA + `wgmma`) or "f32" (exact, CUDA cores)."""

    route: str
    dq: BwdKernelTile
    dkv: BwdKernelTile


def _bwd_kernel_tile(dh: int, dtype: torch.dtype, kernel: str) -> BwdKernelTile:
    dkv = kernel == "dkv"
    if dtype == torch.float32:
        parts = _f32_parts(dh)
        if _f32_bwd_smem(dh, parts, 1) > SMEM_PER_BLOCK:
            parts = 32
        outs = 2 if dkv and 32 + 8 * -(-dh // 64) <= F32_REG_BUDGET else 1
        bufs = 2 if _f32_bwd_smem(dh, parts, 2) <= SMEM_PER_BLOCK else 1
        return BwdKernelTile("f32", kernel, dh, F32_ROWS, F32_THREADS // parts, dh,
                             outs if dkv else 1, bufs)
    cols = _bf16_cols(dh)
    outs = 2 if dkv and _bf16_regs(2, dh, 32) <= BF16_REG_BUDGET else 1
    fits = [t for t in (64, 32, 16) if _bf16_regs(outs, cols, t) <= BF16_REG_BUDGET]
    owned = [t for t in fits if _bf16_smem(dh, t, 2, dkv) <= SMEM_PER_BLOCK]
    if not owned:
        return BwdKernelTile("wgmma", kernel, dh, BF16_ROWS, fits[0], cols, outs,
                             BF16_CHUNK_STAGES, chunked=True)
    tile = owned[0]
    deep = _bf16_smem(dh, tile, BF16_MAX_STAGES, dkv)
    stages = (BF16_MAX_STAGES if deep <= SMEM_PER_BLOCK and _bf16_blocks(deep)
              >= _bf16_blocks(_bf16_smem(dh, tile, 2, dkv)) else 2)
    return BwdKernelTile("wgmma", kernel, dh, BF16_ROWS, tile, cols, outs, stages)


@functools.lru_cache(maxsize=None)
def attention_bwd_plan(dh: int, dtype: torch.dtype = torch.bfloat16) -> AttentionBwdTile:
    """The dq and dk/dv kernels' tiles at head dim `dh`, every head dim of
    the forward (`FWD_HEAD_DIMS`) in both dtypes. bf16 ("wgmma"): 64 owned
    rows, streamed tiles of 64 rows up to dh 160 (dk/dv: up to 96, and
    160), 32 at dh 192, 256 and 384 (and dk/dv at 128), 16 at 512 and 576;
    dk/dv takes both outputs in one block up to dh 128 and one a block from
    dh 160 on; the 512-wide head runs two 256-column slices, 384, 576 and
    960 WIDE_DV-column slices; dh 960 streams its owned rows in 64-column
    chunks (32-row tiles). fp32 ("f32"): 16 owned rows, 128-row tiles up to
    dh 80, 64 at 96 to 160, 32 at 192 and 256, 16 at 384 to 576, 8 at 960
    (one buffer, dk and dv in separate blocks). The kernels pick the same
    tiles themselves (csrc/attention_bwd.cu)."""
    if dh not in FWD_HEAD_DIMS:
        raise ValueError(f"attention backward kernels take head dims {FWD_HEAD_DIMS}, got {dh}")
    if dtype not in _DTYPES:
        raise TypeError(f"attention backward kernels take float32 or bfloat16, got {dtype}")
    dq, dkv = (_bwd_kernel_tile(dh, dtype, kernel) for kernel in ("dq", "dkv"))
    return AttentionBwdTile(dq.route, dq, dkv)


def _heads(u: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, L, H*dh) -> fp32 (B, H, L, dh)."""
    b, length, inner = u.shape
    return u.float().reshape(b, length, num_heads, inner // num_heads).transpose(1, 2)


def _merge(u: torch.Tensor) -> torch.Tensor:
    """(B, H, L, dh) -> (B, L, H*dh)."""
    b, h, length, dh = u.shape
    return u.transpose(1, 2).reshape(b, length, h * dh)


def _scale(q: torch.Tensor, num_heads: int, scale: Optional[float]) -> float:
    return (q.shape[-1] // num_heads) ** -0.5 if scale is None else scale


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    num_heads: int, scale: Optional[float] = None) -> torch.Tensor:
    """The same function in plain PyTorch: logits, softmax and P@V in fp32,
    the output cast back to q's dtype."""
    scale = _scale(q, num_heads, scale)
    qh, kh, vh = (_heads(u, num_heads) for u in (q, k, v))
    p = torch.softmax(qh @ kh.transpose(-1, -2) * scale, dim=-1)
    return _merge(p @ vh).to(q.dtype)


def attention_lse_plain(q: torch.Tensor, k: torch.Tensor, *, num_heads: int,
                        scale: Optional[float] = None) -> torch.Tensor:
    """(B*H, T) fp32 base-2 log-sum-exp of each row's logits pre-scaled by
    scale*log2(e), the convention of the JAX `_lse_kernel`:
    log2(sum 2^(z*scale*log2e)) = logsumexp(z*scale) * log2(e)."""
    scale = _scale(q, num_heads, scale)
    z = _heads(q, num_heads) @ _heads(k, num_heads).transpose(-1, -2)
    lse = torch.logsumexp(z * scale, dim=-1) * _LOG2E
    return lse.reshape(-1, q.shape[1])


def attention_delta(o: torch.Tensor, g: torch.Tensor, num_heads: int) -> torch.Tensor:
    """delta = rowsum(dO * O) per head, fp32 (B*H, T)."""
    return (_heads(g, num_heads) * _heads(o, num_heads)).sum(-1).reshape(-1, o.shape[1])


def _backward_plain(q, k, v, g, lse, delta, num_heads, scale):
    """dq, dk, dv from the recompute-free formulas of the kernels, in fp32:
    p = exp2(z*scale*log2e - lse), ds = p*(dO v^T - delta), dq = scale*ds k,
    dk = scale*ds^T q, dv = p^T dO; cast to q's dtype."""
    b, t, _ = q.shape
    qh, kh, vh, gh = (_heads(u, num_heads) for u in (q, k, v, g))
    z = qh @ kh.transpose(-1, -2)
    p = torch.exp2(z * (scale * _LOG2E) - lse.reshape(b, num_heads, t, 1))
    ds = p * (gh @ vh.transpose(-1, -2) - delta.reshape(b, num_heads, t, 1))
    grads = (scale * ds @ kh, scale * ds.transpose(-1, -2) @ qh, p.transpose(-1, -2) @ gh)
    return tuple(_merge(u).to(q.dtype) for u in grads)


def attention_backward_plain(q, k, v, o, lse, g, num_heads: int,
                             scale: Optional[float] = None) -> Tuple[torch.Tensor, ...]:
    """(dq, dk, dv) of `attention_plain` at cotangent g, given the forward's
    output o and base-2 lse, by the same formulas as the kernels."""
    scale = _scale(q, num_heads, scale)
    return _backward_plain(q, k, v, g, lse, attention_delta(o, g, num_heads), num_heads, scale)


def _check(q, k, v, num_heads):
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"token_attention takes q (B,T,H*dh) and k, v (B,S,H*dh); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, t, inner = q.shape
    if k.shape[0] != b or k.shape[2] != inner or inner % num_heads:
        raise ValueError(f"token_attention: shapes {tuple(q.shape)} / {tuple(k.shape)} "
                         f"do not split into {num_heads} heads")
    if t == 0 or k.shape[1] == 0:
        raise ValueError("token_attention needs at least one query and one key")
    dh = inner // num_heads
    if dh not in FWD_HEAD_DIMS:
        raise ValueError(f"attention kernel takes head dims {FWD_HEAD_DIMS}, got {dh}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"attention kernel takes float32 or bfloat16 q, k, v of one "
                        f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if any(u.stride(2) != 1 for u in (q, k, v)):
        raise ValueError("attention kernel needs q, k, v with unit stride along the channels")
    if q.dtype == torch.bfloat16 and any(u.data_ptr() % 16 or u.stride(0) % 8 or u.stride(1) % 8
                                         for u in (q, k, v)):
        raise ValueError("attention kernel needs 16-byte aligned bf16 q, k, v rows")
    if k.device != q.device or v.device != q.device:
        raise ValueError("token_attention: q, k, v must share a device")
    if b * num_heads >= 65536:
        raise ValueError("attention kernel takes B*H < 65536")


def _attend(q, k, v, num_heads, scale, with_lse):
    """(o, lse or None): the forward kernel on CUDA, the plain twins on the
    CPU. A launch counts under `attention_lse` if it writes the lse, else
    under `token_attention`."""
    if _build.device_type(q, "token_attention") == "cpu":
        return (attention_plain(q, k, v, num_heads=num_heads, scale=scale),
                attention_lse_plain(q, k, num_heads=num_heads, scale=scale) if with_lse else None)
    _check(q, k, v, num_heads)
    b, t, inner = q.shape
    s = k.shape[1]
    out = torch.empty((b, t, inner), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b * num_heads, t), dtype=torch.float32, device=q.device)
           if with_lse else None)
    counter = attention_lse if with_lse else token_attention
    tile = attention_plan(inner // num_heads, q.dtype)
    code = _build.library().dpm_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, t, s, num_heads, inner // num_heads,
        float(scale * _LOG2E), *q.stride()[:2], *k.stride()[:2], *v.stride()[:2],
        _DTYPES[q.dtype], tile.block_q, tile.block_kv, tile.d_pad,
        tile.launch_dv(b, t, num_heads), tile.stages, _build.stream_ptr(q.device))
    _build.check(code, counter.__name__)
    counter.launches += 1
    counter.launches_by_route[tile.route] += 1
    return out, lse


def attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, num_heads: int,
                  scale: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward with its residual: (o, lse), lse fp32 (B*H, T) in base 2."""
    return _attend(q, k, v, num_heads, _scale(q, num_heads, scale), with_lse=True)


def _check_bwd(q, k, v, g, num_heads) -> AttentionBwdTile:
    """The checks of the forward and of the cotangent; the backward's tile."""
    _check(q, k, v, num_heads)
    tile = attention_bwd_plan(q.shape[2] // num_heads, q.dtype)
    if g.shape != q.shape or g.dtype != q.dtype or not g.is_contiguous():
        raise ValueError(f"attention backward takes a contiguous cotangent of q's shape and "
                         f"dtype; got {tuple(g.shape)} {g.dtype}")
    return tile


def _bwd_args(q, k, v, g, lse, delta, num_heads, scale):
    b, t, inner = q.shape
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
            delta.data_ptr()), (b, t, k.shape[1], num_heads, inner // num_heads,
                                float(scale * _LOG2E), float(scale), *q.stride()[:2],
                                *k.stride()[:2], *v.stride()[:2], _DTYPES[q.dtype],
                                _build.stream_ptr(q.device))


def attention_dq(q, k, v, g, lse, delta, *, num_heads: int, scale: float) -> torch.Tensor:
    """dq (B, T, H*dh) from the forward's inputs, the cotangent g, the base-2
    lse and delta (both fp32 (B*H, T))."""
    if _build.device_type(q, "attention_dq") == "cpu":
        return _backward_plain(q, k, v, g, lse, delta, num_heads, scale)[0]
    tile = _check_bwd(q, k, v, g, num_heads)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    ins, rest = _bwd_args(q, k, v, g, lse, delta, num_heads, scale)
    _build.check(_build.library().dpm_attention_bwd_dq(*ins, dq.data_ptr(), *rest),
                 "attention_dq")
    attention_dq.launches += 1
    attention_dq.launches_by_route[tile.route] += 1
    return dq


def attention_dkv(q, k, v, g, lse, delta, *, num_heads: int,
                  scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv), each (B, S, H*dh), from the same inputs as `attention_dq`."""
    if _build.device_type(q, "attention_dkv") == "cpu":
        return _backward_plain(q, k, v, g, lse, delta, num_heads, scale)[1:]
    tile = _check_bwd(q, k, v, g, num_heads)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    ins, rest = _bwd_args(q, k, v, g, lse, delta, num_heads, scale)
    _build.check(_build.library().dpm_attention_bwd_dkv(*ins, dk.data_ptr(), dv.data_ptr(),
                                                        *rest), "attention_dkv")
    attention_dkv.launches += 1
    attention_dkv.launches_by_route[tile.route] += 1
    return dk, dv


class _TokenAttention(torch.autograd.Function):
    """Autograd for `token_attention`: the forward keeps (q, k, v, o, lse);
    the backward runs the dq and dk/dv kernels (on the CPU, one plain pass
    for all three)."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, scale):
        o, lse = attention_lse(q, k, v, num_heads=num_heads, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.num_heads, ctx.scale = num_heads, scale
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        heads, scale = ctx.num_heads, ctx.scale
        g = g.contiguous()
        delta = attention_delta(o, g, heads)
        if _build.device_type(q, "token_attention") == "cpu":
            return (*_backward_plain(q, k, v, g, lse, delta, heads, scale), None, None)
        dq = dk = dv = None
        if ctx.needs_input_grad[0]:
            dq = attention_dq(q, k, v, g, lse, delta, num_heads=heads, scale=scale)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dk, dv = attention_dkv(q, k, v, g, lse, delta, num_heads=heads, scale=scale)
        return dq, dk, dv, None, None


def token_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    num_heads: int, scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v per head; q (B,T,H*dh), k/v (B,S,H*dh).
    Differentiable in q, k and v. The autograd Function, and the lse it
    keeps, are taken only when grad mode is on and an input requires grad
    (inside `Function.forward` grad mode is off and `needs_input_grad`
    ignores it, so the forward cannot tell by itself)."""
    scale = _scale(q, num_heads, scale)
    if torch.is_grad_enabled() and any(u.requires_grad for u in (q, k, v)):
        return _TokenAttention.apply(q, k, v, num_heads, scale)
    return _attend(q, k, v, num_heads, scale, with_lse=False)[0]


# --------------------------------------------------------------------------- #
# attention -> out-projection -> residual, fused (csrc/attention_out.cu)
# --------------------------------------------------------------------------- #

OUT_MAX_INNER = 1280  # H*dh: SD-2.1's and SD-1's widest transformer (csrc MAX_INNER)
OUT_MAX_C = 1280      # output channels (csrc MAX_C)
OUT_N_CHUNK = 128     # bf16: output columns a projection pass (csrc OUT_NCH)
# The compiled bf16 tiles of each head dim, (queries a block, keys a tile,
# ring stages), widest first: three, two, then one consumer warpgroup, and at
# dh 256 and 512 wider key tiles or deeper rings while the concat buffer
# leaves room (csrc/attention_out.cu's OUT_TILE list, in the same order)
OUT_TILES = {32: ((192, 64, 3), (128, 64, 3), (64, 64, 3)),
             40: ((192, 64, 3), (128, 64, 3), (64, 64, 3)),
             64: ((192, 64, 3), (128, 64, 3), (64, 64, 3)), 80: ((128, 32, 2), (64, 32, 3)),
             128: ((128, 32, 2), (64, 32, 3)), 160: ((64, 16, 3),),
             256: ((64, 64, 2), (64, 16, 2)), 512: ((64, 16, 2), (64, 16, 1))}


@dataclasses.dataclass(frozen=True)
class AttentionOutTile:
    """The tile `attention_out_fused`'s kernel runs at one (dh, H*dh, dtype).

    route: "wgmma" (bf16: TMA + `wgmma`, one producer warp and rows / 64
    consumer warpgroups) or "f32" (exact, CUDA cores, register-tiled:
    csrc/attention_f32.cuh). rows: queries a block, which walks every head;
    block_kv: keys a tile; stages: the ring's depth (f32: cp.async buffers);
    cluster: CTAs that split a query tile's heads (1: one block holds them
    all; more: each attends to H / cluster heads, gathers the others'
    outputs through distributed shared memory and computes the output
    passes n = rank (mod cluster)); n_chunk: output columns a projection
    pass (f32: the block's threads, a column each); w_rows: rows of w_out a ring stage holds (bf16:
    a K/V stage's bytes over n_chunk columns; f32: 0, w_out is read from
    device memory)."""

    route: str
    dh: int
    inner: int
    rows: int
    block_kv: int
    stages: int
    cluster: int
    n_chunk: int
    w_rows: int

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of one block (csrc/attention_out.cu's layout)."""
        dh = self.dh
        if self.route == "f32":  # the concat buffer (16 x H*dh), the queries (pitch
            # dh + 2 | 4), the K/V buffers (pitch dh + 2), the logits, three row stats
            po = dh + (4 if _f32_parts(dh) == 16 else 2)
            return 4 * (F32_ROWS * self.inner + F32_ROWS * po
                        + self.stages * 2 * self.block_kv * (dh + 2)
                        + F32_ROWS * (self.block_kv + 1) + 3 * F32_ROWS)
        # + 1024 to align a swizzle atom, the q tile, the ring (K and V tiles of
        # 64-column runs; V of a 256-wide output half at dh 512), the concat
        # buffer in whole 64-column tiles, the qfull/qempty/full/empty barriers
        stage = 128 * self.block_kv * (_pad64(dh) + _pad64(min(dh, 256))) // 64
        return (1024 + 128 * self.rows * _pad64(dh) // 64 + self.stages * stage
                + 128 * self.rows * _pad64(self.inner) // 64 + 8 * (2 + 2 * self.stages))

    def grid(self, b: int, t: int) -> Tuple[int, int]:
        """(CTAs along x: cluster x query tiles, batch) of one launch."""
        return self.cluster * -(-t // self.rows), b


def _out_f32_stages(dh: int) -> int:
    """The fp32 kernel's K/V buffers at `dh`: two where they fit beside the
    concat buffer of the head dim's widest H*dh, else one (csrc out_f32_bufs)."""
    tile = AttentionOutTile("f32", dh, OUT_MAX_INNER // dh * dh, F32_ROWS,
                            F32_THREADS // _f32_parts(dh), 2, 1, F32_THREADS, 0)
    return 2 if tile.smem_bytes <= SMEM_PER_BLOCK else 1


# The bf16 plan's estimate of a launch (`_out_estimate`): a CTA's rate on
# the tensor cores by its consumer warpgroups (one warpgroup: alone on an SM,
# or two CTAs sharing one), a CTA's fixed time, and the cluster gather's time
# a MB, fitted to H100 timings of every tile and cluster size at the SD-2.1
# and SD-1 sites (chip_smoke.py times the plan's pick at each)
OUT_SMS = 132
OUT_TFLOPS = {(1, 1): 1.4, (1, 2): 1.0, (2, 1): 2.1, (3, 1): 2.4}
OUT_CTA_MS = 0.015
OUT_GATHER_MS_PER_MB = 0.02
OUT_MAX_CLUSTER = 8   # CTAs a cluster (the portable limit; csrc MAX_CLUSTER)


def _out_estimate(tile: AttentionOutTile, b: int, t: int, s: int, c: int) -> float:
    """ms one launch takes by the model above: whole waves of CTAs (one an
    SM, two where two fit its shared memory at 64 rows), each CTA its heads'
    attention and its output passes at its rate, plus the fixed time and its
    share of the gather."""
    heads, dh = tile.inner // tile.dh, tile.dh
    per_sm = 2 if tile.rows == 64 and 2 * (tile.smem_bytes + 1024) <= SM_SMEM else 1
    ctas = tile.cluster * b * -(-t // tile.rows)
    waves = -(-ctas // (OUT_SMS * per_sm))
    hc = heads // tile.cluster
    chunks = -(-c // tile.n_chunk)
    passes = -(-chunks // tile.cluster)  # a CTA's output passes
    gflop = (4 * tile.rows * hc * -(-s // tile.block_kv) * tile.block_kv * -(-dh // 16) * 16
             + 2 * tile.rows * -(-tile.inner // 16) * 16 * tile.n_chunk * passes) / 1e9
    gather_mb = (tile.cluster - 1) / tile.cluster * tile.rows * tile.inner * 2 / 1e6
    return waves * (gflop / OUT_TFLOPS[(tile.rows // 64, per_sm)] + OUT_CTA_MS
                    + OUT_GATHER_MS_PER_MB * gather_mb)


@functools.lru_cache(maxsize=None)
def attention_out_plan(dh: int, inner: int, c: int, dtype: torch.dtype = torch.bfloat16,
                       b: int = 1, t: Optional[int] = None,
                       s: Optional[int] = None) -> AttentionOutTile:
    """The fused kernel's tile at head dim `dh`, H*dh = `inner`, C = `c`,
    for a launch of b x t queries over s keys (t None: a grid of many waves).
    bf16 ("wgmma"): among `OUT_TILES[dh]` whose shared memory (the q tile,
    the ring and the rows x H*dh concat buffer) fits 227 KB at this `inner`,
    and cluster sizes that divide H (1, 2, 4, 8: a cluster's CTAs split the
    heads and gather the concat buffer through distributed shared memory),
    the pair `_out_estimate` rates fastest; with t None, the first tile
    that fits and no cluster. w_out arrives through the ring in
    OUT_N_CHUNK-column passes. fp32 ("f32"): 16 queries, the fp32
    forward's key tile (256 / parts keys), two cp.async buffers where they
    fit at the head dim's widest H*dh, one block holding every head."""
    if dh not in HEAD_DIMS:
        raise ValueError(f"attention_out kernel takes head dims {HEAD_DIMS}, got {dh}")
    if inner % dh or not 0 < inner <= OUT_MAX_INNER:
        raise ValueError(f"attention_out kernel takes H*dh <= {OUT_MAX_INNER} in whole heads "
                         f"of {dh}, got {inner}")
    if c % 8 or not 0 < c <= OUT_MAX_C:
        raise ValueError(f"attention_out kernel takes C % 8 == 0 and C <= {OUT_MAX_C}, got {c}")
    if dtype not in _DTYPES:
        raise TypeError(f"attention_out kernel takes float32 or bfloat16, got {dtype}")
    if dtype == torch.float32:
        return AttentionOutTile("f32", dh, inner, F32_ROWS, F32_THREADS // _f32_parts(dh),
                                _out_f32_stages(dh), 1, F32_THREADS, 0)
    tiles = []
    for rows, kv, stages in OUT_TILES[dh]:
        stage = 128 * kv * (_pad64(dh) + _pad64(min(dh, 256))) // 64
        tile = AttentionOutTile("wgmma", dh, inner, rows, kv, stages, 1, OUT_N_CHUNK,
                                stage // (2 * OUT_N_CHUNK) // 16 * 16)
        if tile.smem_bytes <= SMEM_PER_BLOCK:
            tiles.append(tile)
    if t is None:
        return tiles[0]
    heads = inner // dh
    clusters = [n for n in (1, 2, 4, 8) if n <= OUT_MAX_CLUSTER and heads % n == 0]
    return min((dataclasses.replace(tile, cluster=n) for tile in tiles for n in clusters),
               key=lambda tile: _out_estimate(tile, b, t, t if s is None else s, c))


def _compose(attend, q, k, v, w_out, bias, residual, num_heads, scale):
    """attend(q, k, v) -> concat heads @ w_out with fp32 sums (+ bias) -> +
    residual, in the residual's dtype: the JAX `attention_out_ref`."""
    o = attend(q, k, v, num_heads=num_heads, scale=scale)
    proj = o.float() @ w_out.to(o.dtype).float()
    if bias is not None:
        proj = proj + bias.float()
    return (proj + residual.float()).to(residual.dtype)


def attention_out_plain(q, k, v, w_out, bias, residual, *, num_heads: int,
                        scale: Optional[float] = None) -> torch.Tensor:
    """The unfused composition in plain PyTorch (`attention_plain`, then the
    projection and the residual add), the function `attention_out_fused`
    computes (dpm_solver_tpu/ops/attention.py:1115-1126)."""
    return _compose(attention_plain, q, k, v, w_out, bias, residual, num_heads, scale)


def _check_out(q, k, v, w_out, bias, residual, num_heads) -> AttentionOutTile:
    """The checks of the attention and of the projection's operands; the tile."""
    _check(q, k, v, num_heads)
    b, t, inner = q.shape
    c = w_out.shape[-1]
    tile = attention_out_plan(inner // num_heads, inner, c, q.dtype, b, t, k.shape[1])
    if w_out.shape != (inner, c) or w_out.dtype != q.dtype or not w_out.is_contiguous():
        raise ValueError(f"attention_out kernel takes a contiguous w_out ({inner}, C) of q's "
                         f"dtype; got {tuple(w_out.shape)} {w_out.dtype}")
    if residual.shape != (b, t, c) or residual.dtype != q.dtype or not residual.is_contiguous():
        raise ValueError(f"attention_out kernel takes a contiguous residual ({b}, {t}, {c}) "
                         f"of q's dtype; got {tuple(residual.shape)} {residual.dtype}")
    if bias is not None and (bias.shape != (c,) or bias.dtype != torch.float32):
        raise ValueError(f"attention_out kernel takes a float32 bias of shape ({c},)")
    if q.dtype == torch.bfloat16 and (w_out.data_ptr() % 16 or residual.data_ptr() % 16):
        raise ValueError("attention_out kernel needs a 16-byte aligned bf16 w_out and residual")
    if any(u.device != q.device for u in (w_out, residual) + (() if bias is None else (bias,))):
        raise ValueError("attention_out_fused: all tensors must share a device")
    if b >= 65536:
        raise ValueError("attention_out kernel takes B < 65536")
    return tile


def _attention_out_forward(q, k, v, w_out, bias, residual, num_heads, scale):
    if _build.device_type(q, "attention_out_fused") == "cpu":
        return attention_out_plain(q, k, v, w_out, bias, residual, num_heads=num_heads,
                                   scale=scale)
    w_out = w_out.to(q.dtype).contiguous()
    bias = None if bias is None else bias.to(torch.float32).contiguous()
    if bias is not None and bias.data_ptr() % 16:
        bias = bias.clone()  # the bf16 kernel reads it in pairs
    tile = _check_out(q, k, v, w_out, bias, residual, num_heads)
    b, t, inner = q.shape
    out = torch.empty_like(residual)
    code = _build.library().dpm_attention_out_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), w_out.data_ptr(),
        None if bias is None else bias.data_ptr(), residual.data_ptr(), out.data_ptr(),
        b, t, k.shape[1], num_heads, inner // num_heads, w_out.shape[1],
        float(scale * _LOG2E), *q.stride()[:2], *k.stride()[:2], *v.stride()[:2],
        _DTYPES[q.dtype], tile.rows, tile.block_kv, tile.stages, tile.cluster, tile.n_chunk,
        tile.w_rows, _build.stream_ptr(q.device))
    _build.check(code, "attention_out_fused")
    attention_out_fused.launches += 1
    attention_out_fused.launches_by_route[tile.route] += 1
    return out


class _AttentionOut(torch.autograd.Function):
    """Autograd for `attention_out_fused`: the backward is the recompute VJP
    of the unfused composition (the JAX `_attn_out_bwd`, :1230-1244), whose
    attention is `token_attention` and so, on the card, its forward-with-lse
    and dq, dk/dv kernels at every head dim."""

    @staticmethod
    def forward(ctx, q, k, v, w_out, bias, residual, num_heads, scale):
        ctx.save_for_backward(q, k, v, w_out, bias, residual)
        ctx.num_heads, ctx.scale = num_heads, scale
        return _attention_out_forward(q, k, v, w_out, bias, residual, num_heads, scale)

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad[:6]
        with torch.enable_grad():
            inputs = [None if u is None else u.detach().requires_grad_(n)
                      for u, n in zip(ctx.saved_tensors, needs)]
            out = _compose(token_attention, *inputs, ctx.num_heads, ctx.scale)
            wanted = [u for u, n in zip(inputs, needs) if n]
            grads = iter(torch.autograd.grad(out, wanted, g.to(out.dtype)))
        return (*(next(grads) if n else None for n in needs), None, None)


def attention_out_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        w_out: torch.Tensor, bias: Optional[torch.Tensor],
                        residual: torch.Tensor, num_heads: int,
                        scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v -> concat heads -> @ w_out (+ bias) -> +
    residual, with the attention output never leaving the chip.

    q (B, T, H*dh); k, v (B, S, H*dh); w_out (H*dh, C); bias (C,) or None;
    residual (B, T, C); the result in the residual's dtype. On the card dh
    is one of HEAD_DIMS, H*dh <= OUT_MAX_INNER, C % 8 == 0 and C <=
    OUT_MAX_C (`attention_out_plan`). Differentiable in every tensor input.
    Nothing in the port calls it, as in the JAX package
    (`attn_out_fused_wins`)."""
    scale = _scale(q, num_heads, scale)
    tensors = (q, k, v, w_out, bias, residual)
    if torch.is_grad_enabled() and any(u is not None and u.requires_grad for u in tensors):
        return _AttentionOut.apply(*tensors, num_heads, scale)
    return _attention_out_forward(*tensors, num_heads, scale)


# The self-attention sites, (T, H, dh, C), where the fused kernel beat the
# unfused composition (token_attention, then F.linear with the bias, then
# the add) on the H100 in the same call (chip_smoke.py's row-10 timing, which
# times both at every site it checks): SD-2.1's 96x96 level at CFG b8,
# SD-1's 8x8 level at CFG b2, and the 256-wide single head at b8. Where it
# lost (SD-2.1's 48x48 to 12x12, SD-1's 64x64 to 16x16, the VAE's 512-wide
# head), the unfused composition stays.
_ATTN_OUT_WINS: list = [(9216, 5, 64, 320), (64, 8, 160, 1280), (256, 1, 256, 256)]


def attn_out_fused_wins(t: int, s: int, num_heads: int, dh: int, c: int) -> bool:
    """Model-side dispatch (the JAX `attn_out_fused_wins`): fuse the
    out-projection and residual into the attention kernel at this site?
    True only at a measured win on self-attention (T == S). No model calls
    it, as in the JAX package."""
    return t == s and (t, num_heads, dh, c) in _ATTN_OUT_WINS


token_attention.launches = 0
token_attention.launches_by_route = Counter()
attention_lse.launches = 0
attention_lse.launches_by_route = Counter()
attention_dq.launches = 0
attention_dq.launches_by_route = Counter()
attention_dkv.launches = 0
attention_dkv.launches_by_route = Counter()
attention_out_fused.launches = 0
attention_out_fused.launches_by_route = Counter()
