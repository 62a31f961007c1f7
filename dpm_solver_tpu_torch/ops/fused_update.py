"""The solver's update x' = a*x + b0*h0 + b1*h1 + b2*h2 (+ s*z) as one Triton pass.

Replaces the Pallas kernel `dpm_solver_tpu/ops/fused_update.py::
fused_solver_update` (bodies `_kernel_ode` and `_kernel_noise`). There the
coefficients travelled as scalar-prefetch operands so that one compiled
kernel served every step of the `lax.scan`. Here they are read from a device
fp32 table, `coef[row, 0:5] = (a, b0, b1, b2, s)`, by pointer and row index,
never from Python floats: the executor's loop makes no host sync, and a
CUDA graph of the whole trajectory (`solver/sample.py::GraphedSampler`)
replays every launch with its row baked in.

The tensors are fp32 on the solver's path (solver math is fp32); bf16 is
taken too, with the arithmetic in fp32 and one rounding of the result.

What bounds it on the H100: a pure streaming pass that reads 4 or 5
equal-sized tensors once and writes one, two flops per element read, so it
is bound by HBM bandwidth (3.35 TB/s): 0.9-9.4 us at the paths' sizes
(147,456 elements on path B to 1,572,864 on C). That is less than one
launch costs the host (the checks, the device guard, the allocation and
Triton's Python launcher: about 40-50 us), so launched eagerly it runs at
the host's pace whatever its body does; replayed from a CUDA graph it costs
the launch latency and one DRAM round trip. The design serves that:
- a grid of at most one wave (`fused_update_grid`): 256-thread programs,
  each loading 16 bytes a thread per stream (4 fp32 or 8 bf16 values), and
  where a wave of 660 programs (5 an SM: 1,280 threads at up to 48
  registers) would not cover the tensor, each walks ITERS consecutive
  blocks, so no program waits for a second wave's slot;
- in each block every stream's loads are issued before the first FMA, and
  the 4-5 coefficients are loaded once a program;
- nothing on the host that a capture cannot hold: no Python float read
  from a device tensor, no allocation sized by device data; and
  `check=False` lets the executor, which builds the tables and the history
  itself, skip the per-launch checks (`_check`) it already guarantees and
  the device guard it holds once a call.

It stays Triton: a fused elementwise pass with no reuse and no tensor-core
work, where nothing CUDA C++ offers on Hopper (TMA, `wgmma`, a shared-memory
layout) has a job to do, and Triton's masked 16-byte block loads move the
same bytes a second a hand-written loop would.

Dispatch is by device only: CPU tensors take `fused_update_plain`; CUDA
tensors launch the kernel or raise. `fused_update.launches` counts launches.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

N_COEF = 5  # a, b0, b1, b2, s
NUM_WARPS = 8          # 256 threads a program
VEC_BYTES = 16         # bytes a thread loads per stream and block
SMS = 132
PROGRAMS_PER_SM = 5    # 1,280 threads an SM at up to 48 registers a thread
WAVE = SMS * PROGRAMS_PER_SM


def fused_update_grid(n: int, itemsize: int) -> Tuple[int, int, int]:
    """(programs, iters, block) of one launch over n elements of `itemsize`
    bytes: a block is VEC_BYTES a thread of NUM_WARPS warps (1,024 fp32 or
    2,048 bf16 elements); a program walks `iters` consecutive blocks, the
    fewest that keep the grid within one wave of WAVE programs."""
    block = VEC_BYTES // itemsize * 32 * NUM_WARPS
    blocks = max(1, -(-n // block))
    iters = -(-blocks // WAVE)
    return -(-blocks // iters), iters, block


def fused_update_plain(coef: torch.Tensor, row: int, x: torch.Tensor,
                       h0: torch.Tensor, h1: torch.Tensor, h2: torch.Tensor,
                       z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The same update in plain PyTorch, coefficients read from `coef[row]`,
    in fp32 and rounded once to x's dtype."""
    c = coef[row].float()
    out = c[0] * x.float() + c[1] * h0.float() + c[2] * h1.float() + c[3] * h2.float()
    if z is not None:
        out = out + c[4] * z.float()
    return out.to(x.dtype)


@functools.cache
def _kernel():
    import triton
    import triton.language as tl

    # `row` changes every step: keep it a runtime argument, not a specialization
    @triton.jit(do_not_specialize=["row"])
    def fused_update_kernel(coef_ptr, row_stride, row, x_ptr, h0_ptr, h1_ptr,
                            h2_ptr, z_ptr, out_ptr, n, HAS_Z: tl.constexpr,
                            ITERS: tl.constexpr, BLOCK: tl.constexpr):
        c = coef_ptr + row * row_stride
        a = tl.load(c)
        b0 = tl.load(c + 1)
        b1 = tl.load(c + 2)
        b2 = tl.load(c + 3)
        if HAS_Z:
            s = tl.load(c + 4)
        first = tl.program_id(0) * (ITERS * BLOCK)
        for i in tl.static_range(ITERS):
            offs = first + i * BLOCK + tl.arange(0, BLOCK)
            mask = offs < n
            # every stream's loads before the first product
            xv = tl.load(x_ptr + offs, mask=mask)
            v0 = tl.load(h0_ptr + offs, mask=mask)
            v1 = tl.load(h1_ptr + offs, mask=mask)
            v2 = tl.load(h2_ptr + offs, mask=mask)
            if HAS_Z:
                zv = tl.load(z_ptr + offs, mask=mask)
            acc = a * xv.to(tl.float32)
            acc += b0 * v0.to(tl.float32)
            acc += b1 * v1.to(tl.float32)
            acc += b2 * v2.to(tl.float32)
            if HAS_Z:
                acc += s * zv.to(tl.float32)
            tl.store(out_ptr + offs, acc.to(out_ptr.dtype.element_ty), mask=mask)

    return fused_update_kernel


def _check(coef, row, x, hs, z):
    if coef.dim() != 2 or coef.shape[1] < N_COEF or coef.dtype != torch.float32:
        raise ValueError(f"fused_update takes a float32 coefficient table (rows, >= "
                         f"{N_COEF}); got {tuple(coef.shape)} {coef.dtype}")
    if coef.stride(1) != 1:
        raise ValueError("fused_update needs unit stride along a coefficient row")
    if not 0 <= row < coef.shape[0]:
        raise IndexError(f"fused_update: row {row} outside a table of {coef.shape[0]} rows")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_update takes float32 or bfloat16 tensors, not {x.dtype}")
    for t in (x, *hs) + (() if z is None else (z,)):
        if t.shape != x.shape or t.dtype != x.dtype or not t.is_contiguous():
            raise ValueError("fused_update takes contiguous x, h0, h1, h2 (and z) of one "
                             "shape and dtype")
        if t.device != x.device:
            raise ValueError("fused_update: all tensors must share a device")
    if coef.device != x.device:
        raise ValueError("fused_update: the coefficient table must be on x's device")
    if x.numel() >= 2**31:
        raise ValueError("fused_update takes fewer than 2**31 elements")


def fused_update(coef: torch.Tensor, row: int, x: torch.Tensor, h0: torch.Tensor,
                 h1: torch.Tensor, h2: torch.Tensor, z: Optional[torch.Tensor] = None, *,
                 check: bool = True) -> torch.Tensor:
    """x' = a*x + b0*h0 + b1*h1 + b2*h2 (+ s*z), (a, b0, b1, b2, s) = coef[row, :5].

    check=False: the caller vouches for what `_check` verifies and holds
    x's device as the current one (the executor, once a call)."""
    if x.device.type == "cpu":
        return fused_update_plain(coef, row, x, h0, h1, h2, z)
    if x.device.type != "cuda":
        raise ValueError(f"fused_update runs on cpu or cuda, not {x.device}")
    if check:
        _check(coef, row, x, (h0, h1, h2), z)
        with torch.cuda.device(x.device):
            return _launch(coef, row, x, h0, h1, h2, z)
    return _launch(coef, row, x, h0, h1, h2, z)


def _launch(coef, row, x, h0, h1, h2, z):
    out = torch.empty_like(x)
    n = x.numel()
    programs, iters, block = fused_update_grid(n, x.element_size())
    _kernel()[(programs,)](coef, coef.stride(0), row, x, h0, h1, h2, x if z is None else z, out,
                           n, HAS_Z=z is not None, ITERS=iters, BLOCK=block,
                           num_warps=NUM_WARPS)
    fused_update.launches += 1
    return out


fused_update.launches = 0
