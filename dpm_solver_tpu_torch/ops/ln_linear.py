"""LayerNorm -> Linear: the hand-written CUDA kernels and their plain twin.

Counterpart of `dpm_solver_tpu/ops/ln_linear.py` (`layer_norm_fp32`,
`ln_linear_reference`, and `ln_linear`, whose Pallas path is `_fused_call`
and whose VJP is `_bwd`). `ln_linear(x, gamma, beta, w, bias)` computes
LN(x; gamma, beta) @ w.T (+ bias) over the last axis of x, with w (n, d) in
torch's Linear layout (the JAX function takes its transpose): fp32
statistics with the two-pass variance, the normalised rows rounded once to
w's dtype, an fp32 accumulator, the output in x's dtype. The kernels live in
`csrc/ln_linear.cu`; its header says what they replace, what bounds them on
the H100 and how they are built.

Routes (`ln_linear_plan`, decided here and handed to the C entry):
- "wgmma": bf16 with d and n multiples of 8 and 16-byte aligned tensors:
  TMA + `wgmma` against the normalised row tile, resident where it fits the
  block's shared memory beside a ring of at least two W stages (every SD
  and cin256 site), else (d > 1,536 at 64 rows: the retrieval LDM's middle
  block, d = 1,792) resident in segments of `seg` 64-column tiles, each
  loaded, normalised and multiplied in turn after the rows' statistics are
  read from device memory. The plan picks the rows a block (64 at d <= 320,
  where two blocks share an SM; 128 at d <= 640 while that fills the card;
  else 64), the ring's depth, the segment and the run of 128-column output
  tiles a block walks, so that the grid covers the card's 132 SMs where the
  tiles allow;
- "wmma": other bf16 shapes (d or n not a multiple of 8, unaligned): the
  `mma.sync` (WMMA) kernel with W staged synchronously, d <= 1,536;
- "f32": the exact CUDA-core kernel, d <= 3,632 (16 rows of fp32 resident).
`ln_linear.launches` counts launches, `ln_linear.launches_by_route` counts
them by route.

Gradients: `ln_linear` is differentiable through `_LnLinearFn`, taken only
when grad mode is on and an input requires grad. Its backward is
`ln_linear_vjp`, the recompute VJP of `ln_linear_plain` (autograd over
library ops), as the JAX package's `_bwd` is an XLA recompute VJP of
`ln_linear_reference`, not a Pallas kernel.

The JAX package's measured v5e site table (`_SITE_WINS`) is not carried
over: the fused and unfused forms compute the same function, and on a CUDA
tensor the port always takes a kernel.

Dispatch is by device only: a CPU tensor takes `ln_linear_plain`; a CUDA
tensor launches the plan's kernel or raises.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Optional

import torch

from dpm_solver_tpu_torch.ops import _build

ROUTES = {"f32": 0, "wmma": 1, "wgmma": 2}   # the C entry's route codes
# the "wmma" kernel keeps a 64-row tile of width d resident in shared memory
MAX_D = 1536
# the "f32" kernel keeps 16 fp32 rows of width d: 227 KB / 64 bytes a column
F32_MAX_D = 3632
SMS = 132              # streaming multiprocessors of one H100 SXM
BLOCK_N = 128          # output columns of one "wgmma" tile
STAGE_BYTES = BLOCK_N * 128   # one W stage: 128 rows x 64 along d, bf16
MAX_STAGES = 4
SMEM_PER_BLOCK = 232448       # what one block may use on the H100 (227 KB)
SMEM_PER_SM = 233472          # the SM's 228 KB, of which 1 KB a block is reserved
# a block's cost of loading and normalising its rows, in column tiles
ROW_TILE_COST = 2


def wgmma_smem(rows: int, d: int, stages: int) -> int:
    """Shared memory of one "wgmma" block (csrc/ln_linear.cu, `ln_smem`):
    1024 bytes to align to a swizzle atom, the resident row tile in 64-column
    swizzle tiles, the W ring, the row tile's barrier and a full and an
    empty barrier per stage."""
    return 1024 + rows * 128 * -(-d // 64) + stages * STAGE_BYTES + 8 + 16 * stages


def wgmma_seg_smem(rows: int, seg: int, stages: int) -> int:
    """The segmented form's (`ln_seg_smem`): `seg` 64-column tiles of the row
    tile, the W ring, the segment's full and empty barriers and the ring's."""
    return 1024 + rows * 128 * seg + stages * STAGE_BYTES + 16 + 16 * stages


@dataclasses.dataclass(frozen=True)
class LnLinearPlan:
    """route: "wgmma", "wmma" or "f32". For "wgmma": rows (128 or 64) a
    block, stages of its W ring, run: the 128-column output tiles one block
    walks (blockIdx.y takes the runs), seg: 0 where the row tile is
    resident, else the 64-column tiles of it a resident segment holds. The
    other routes leave them 0."""

    route: str
    rows: int = 0
    stages: int = 0
    run: int = 0
    seg: int = 0

    def blocks(self, m: int, n: int) -> int:
        col_tiles = -(-n // BLOCK_N)
        return -(-m // self.rows) * -(-col_tiles // self.run)


def _stages(rows: int, d: int) -> int:
    fixed = wgmma_smem(rows, d, 0)
    return min(MAX_STAGES, (SMEM_PER_BLOCK - fixed) // (STAGE_BYTES + 16))


def ln_linear_plan(m: int, d: int, n: int, dtype: torch.dtype,
                   aligned: bool = True) -> LnLinearPlan:
    """The route and tile for x (m, d) @ w (n, d).T in `dtype`; `aligned`:
    x, w and the output start on 16-byte boundaries (TMA needs it).

    64 rows a block where two such blocks, each with a full ring, fit an
    SM (d <= 320): one block's statistics and stores then run under the
    other's products. Else 128 rows at d <= 640 while those blocks, one
    column tile each, fill the card; else 64. The ring takes as many 16 KB
    stages (up to 4) as fit beside the row tile; where fewer than 2 fit,
    the ring takes 4 and the row tile is kept in the fewest segments of
    equal width that fit beside it (`seg` 64-column tiles each).

    The column tiles split into runs, one block each. Of the runs that give
    at least a block for every slot of the card (or as many blocks as the
    tiles allow), the plan takes the one with the least estimated time: the
    waves of blocks times a block's work, its run of column tiles plus
    ROW_TILE_COST for loading and normalising its rows."""
    if dtype == torch.float32:
        return LnLinearPlan("f32")
    if d % 8 or n % 8 or not aligned:
        return LnLinearPlan("wmma")
    col_tiles = -(-n // BLOCK_N)
    per_sm = 1
    if 2 * (wgmma_smem(64, d, MAX_STAGES) + 1024) <= SMEM_PER_SM:
        rows, per_sm = 64, 2
    elif d <= 640 and -(-m // 128) * col_tiles >= SMS:
        rows = 128
    else:
        rows = 64
    stages, seg = _stages(rows, d), 0
    if stages < 2:  # the row tile in segments, beside a full ring, in as few as fit, even
        stages, kch = MAX_STAGES, -(-d // 64)
        most = (SMEM_PER_BLOCK - wgmma_seg_smem(rows, 0, stages)) // (rows * 128)
        seg = -(-kch // -(-kch // most))
    row_tiles = -(-m // rows)
    slots = SMS * per_sm
    least = min(slots, row_tiles * col_tiles)

    def cost(run):
        runs = -(-col_tiles // run)
        return -(-row_tiles * runs // slots) * (run + ROW_TILE_COST), -run

    run = min((r for r in range(1, col_tiles + 1) if row_tiles * -(-col_tiles // r) >= least),
              key=cost)
    return LnLinearPlan("wgmma", rows, stages, run, seg)


def layer_norm_fp32(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
                    eps: float = 1e-5) -> torch.Tensor:
    """fp32 LayerNorm over the last axis, two-pass variance E[(x - mean)^2]
    (torch.nn.LayerNorm semantics). Returns fp32; callers cast."""
    xv = x.float()
    mean = xv.mean(dim=-1, keepdim=True)
    var = (xv - mean).square().mean(dim=-1, keepdim=True)
    xn = (xv - mean) * torch.rsqrt(var + eps)
    return xn * gamma.float() + beta.float()


def ln_linear_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    w: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                    eps: float = 1e-5) -> torch.Tensor:
    """The unfused composition the kernels match: fp32 LayerNorm, cast to
    w's dtype, matmul with an fp32 result (+ fp32 bias), cast to x's dtype."""
    xn = layer_norm_fp32(x, gamma, beta, eps=eps).to(w.dtype)
    out = xn.float() @ w.float().t()  # w's dtype in, fp32 out
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def ln_linear_vjp(g: torch.Tensor, x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  w: torch.Tensor, bias: Optional[torch.Tensor] = None, *, eps: float = 1e-5,
                  needs=(True,) * 5) -> tuple:
    """(dx, dgamma, dbeta, dw, dbias) at cotangent g: the VJP of
    `ln_linear_plain`, recomputed from the inputs (the JAX package's `_bwd`);
    None where `needs` is False or bias is None. Each gradient has its
    input's dtype."""
    needs = tuple(bool(n) for n in needs[:4]) + (bias is not None and bool(needs[4]),)
    with torch.enable_grad():
        ins = [None if t is None else t.detach().requires_grad_(n)
               for t, n in zip((x, gamma, beta, w, bias), needs)]
        out = ln_linear_plain(*ins[:4], ins[4], eps=eps)
        wanted = [t for t, n in zip(ins, needs) if n]
        grads = iter(torch.autograd.grad(out, wanted, g.to(out.dtype)))
    return tuple(next(grads) if n else None for n in needs)


def _check(x2, gamma, beta, w, bias, plan: LnLinearPlan = None):
    """Raise on what the kernels do not take; with no plan, MAX_D binds."""
    m, d = x2.shape
    if w.dim() != 2 or w.shape[1] != d:
        raise ValueError(f"ln_linear takes x (..., d) and w (n, d); got d = {d} and "
                         f"w {tuple(w.shape)}")
    n = w.shape[0]
    if x2.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x2.dtype:
        raise TypeError(f"ln_linear kernel takes float32 or bfloat16 x and w of one dtype; "
                        f"got {x2.dtype} and {w.dtype}")
    for name, t, size in (("gamma", gamma, d), ("beta", beta, d), ("bias", bias, n)):
        if t is not None and (t.shape != (size,) or t.dtype != torch.float32
                              or not t.is_contiguous()):
            raise ValueError(f"ln_linear kernel takes a contiguous float32 {name} of "
                             f"shape ({size},)")
    if not (x2.is_contiguous() and w.is_contiguous()):
        raise ValueError("ln_linear kernel needs contiguous x and w")
    if any(t is not None and t.device != x2.device for t in (gamma, beta, w, bias)):
        raise ValueError("ln_linear: x, gamma, beta, w and bias must share a device")
    limit = F32_MAX_D if plan is not None and plan.route == "f32" else MAX_D
    if (plan is None or plan.route != "wgmma") and d > limit:
        raise ValueError(f"ln_linear's {plan.route if plan else 'wmma'} kernel takes d <= "
                         f"{limit}, got {d}")
    if m * max(d, n) >= 2**31 or d * n >= 2**31:
        raise ValueError("ln_linear kernel takes fewer than 2**31 elements per tensor")


def ln_linear_launch(x2, gamma, beta, w, bias, eps, plan: LnLinearPlan) -> torch.Tensor:
    """Run `plan`'s kernel on x2 (m, d) on the card; count the launch."""
    gamma, beta = gamma.to(torch.float32).contiguous(), beta.to(torch.float32).contiguous()
    if plan.route == "wgmma":   # read as float4 there
        gamma, beta = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (gamma, beta))
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()
    _check(x2, gamma, beta, w, bias, plan)
    (m, d), n = x2.shape, w.shape[0]
    out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    code = _build.library().dpm_ln_linear_fwd(
        x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), m, d, n, float(eps),
        ROUTES[plan.route], plan.rows, plan.run, plan.stages, plan.seg,
        _build.stream_ptr(x2.device))
    _build.check(code, "ln_linear")
    ln_linear.launches += 1
    ln_linear.launches_by_route[plan.route] += 1
    return out


def _forward(x, gamma, beta, w, bias, eps):
    if _build.device_type(x, "ln_linear") == "cpu":
        return ln_linear_plain(x, gamma, beta, w, bias, eps=eps)
    lead, d = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, d)
    n = w.shape[0]
    if x2.shape[0] == 0:
        return x.new_empty((*lead, n))
    # the output is a fresh allocation: 16-byte aligned
    aligned = x2.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    plan = ln_linear_plan(x2.shape[0], d, n, x.dtype, aligned)
    return ln_linear_launch(x2, gamma, beta, w, bias, eps, plan).reshape(*lead, n)


class _LnLinearFn(torch.autograd.Function):
    """Autograd for `ln_linear`: keeps the inputs; the backward is
    `ln_linear_vjp`."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w, bias, eps):
        ctx.save_for_backward(x, gamma, beta, w, bias)
        ctx.eps = eps
        return _forward(x, gamma, beta, w, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, gamma, beta, w, bias = ctx.saved_tensors
        grads = ln_linear_vjp(g, x, gamma, beta, w, bias, eps=ctx.eps,
                              needs=ctx.needs_input_grad[:5])
        return (*grads, None)


def ln_linear(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, w: torch.Tensor,
              bias: Optional[torch.Tensor] = None, *, eps: float = 1e-5) -> torch.Tensor:
    """LN(x; gamma, beta) @ w.T (+ bias) over the last axis; x (..., d), w (n, d).
    Differentiable in every tensor input (see the module docstring)."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, gamma, beta, w, bias)):
        return _LnLinearFn.apply(x, gamma, beta, w, bias, eps)
    return _forward(x, gamma, beta, w, bias, eps)


ln_linear.launches = 0
ln_linear.launches_by_route = Counter()
