"""The solver's update x' = a*x + b0*h0 + b1*h1 + b2*h2 (+ s*z) as one Triton pass.

Replaces the Pallas kernel `dpm_solver_tpu/ops/fused_update.py::
fused_solver_update` (bodies `_kernel_ode` and `_kernel_noise`). There the
coefficients travelled as scalar-prefetch operands so that one compiled
kernel served every step of the `lax.scan`. Here they are read from a device
fp32 table, `coef[row, 0:5] = (a, b0, b1, b2, s)`, by pointer and row index,
never from Python floats: the executor's loop then makes no host sync and
can later be captured as a CUDA graph.

The tensors are fp32 on the solver's path (solver math is fp32); bf16 is
taken too, with the arithmetic in fp32 and one rounding of the result.

What bounds it on the H100: it is a pure streaming pass that reads 4 or 5
equal-sized fp32 tensors once and writes one, with no reuse and two flops per
element read, so it is bound by HBM bandwidth (3.35 TB/s) and, at CIFAR's
(64, 32, 32, 3) = 196,608 elements (about 4 MB moved), by launch latency. The
design does what a bandwidth-bound pass can: one masked 1-D block per
program, so every byte moves once and the ragged tail needs no padded copy,
with 1024-element blocks in 4 warps for wide coalesced loads. Triton's masked
block loads reach the same bytes per second a CUDA kernel would here, which
is why this one kernel is Triton.

Dispatch is by device only: CPU tensors take `fused_update_plain`; CUDA
tensors launch the kernel or raise. `fused_update.launches` counts launches.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

BLOCK = 1024
N_COEF = 5  # a, b0, b1, b2, s


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
                            BLOCK: tl.constexpr):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        c = coef_ptr + row * row_stride
        a = tl.load(c)
        b0 = tl.load(c + 1)
        b1 = tl.load(c + 2)
        b2 = tl.load(c + 3)
        acc = a * tl.load(x_ptr + offs, mask=mask).to(tl.float32)
        acc += b0 * tl.load(h0_ptr + offs, mask=mask).to(tl.float32)
        acc += b1 * tl.load(h1_ptr + offs, mask=mask).to(tl.float32)
        acc += b2 * tl.load(h2_ptr + offs, mask=mask).to(tl.float32)
        if HAS_Z:
            acc += tl.load(c + 4) * tl.load(z_ptr + offs, mask=mask).to(tl.float32)
        tl.store(out_ptr + offs, acc.to(out_ptr.dtype.element_ty), mask=mask)

    return triton, fused_update_kernel


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
                 h1: torch.Tensor, h2: torch.Tensor,
                 z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x' = a*x + b0*h0 + b1*h1 + b2*h2 (+ s*z), (a, b0, b1, b2, s) = coef[row, :5]."""
    if x.device.type == "cpu":
        return fused_update_plain(coef, row, x, h0, h1, h2, z)
    if x.device.type != "cuda":
        raise ValueError(f"fused_update runs on cpu or cuda, not {x.device}")
    _check(coef, row, x, (h0, h1, h2), z)
    triton, kernel = _kernel()
    out = torch.empty_like(x)
    n = x.numel()
    with torch.cuda.device(x.device):
        kernel[(triton.cdiv(n, BLOCK),)](
            coef, coef.stride(0), row, x, h0, h1, h2, x if z is None else z, out, n,
            HAS_Z=z is not None, BLOCK=BLOCK, num_warps=4)
    fused_update.launches += 1
    return out


fused_update.launches = 0
