"""GEGLU feed-forward: the hand-written CUDA kernels and their plain twin.

Counterpart of `dpm_solver_tpu/ops/geglu.py` (`_gelu_exact`, `_ref_impl`,
and `geglu_ff`, whose Pallas path is `_geglu_pallas` and whose VJP is `_bwd`):

    [h | gate] = x @ w1.T + b1          (d -> 2 * inner, fp32)
    out = (bf16(h * gelu(gate))) @ w2.T + b2     (inner -> d, fp32, then x's dtype)

The weights are in torch's Linear layout (the JAX function takes their
transposes): `w1` is (2 * inner, d) with the [h | gate] row halves in that
order (the reference's `proj(x).chunk(2)`); b1 (2 * inner,), w2 (d, inner),
b2 (d,). The kernels live in `csrc/geglu.cu`; its header says what they
replace, what bounds them on the H100 and how they are built.

Routes (`geglu_plan`, decided here and handed to the C entry):
- "wgmma": bf16 with d and inner multiples of 8 and 16-byte aligned tensors
  (every SD site): two TMA + `wgmma` kernels, the gate (x @ w1.T, b1, gelu,
  the product, one rounding) writing the gated tile P (M, inner) to a
  scratch buffer allocated here, and the down-projection (P @ w2.T + b2).
  The plan picks each kernel's row tile, and at small M a split of the
  down-projection's reduction (its fp32 partials in a second scratch buffer,
  summed by a third kernel), so that the grid covers the card's 132 SMs;
- "wmma": bf16 with ragged widths: the fused `mma.sync` (WMMA) kernel that
  splits the output columns and recomputes the gate per slice;
- "f32": the exact CUDA-core kernel.
One call counts one launch in `geglu_ff.launches` (and one under its route
in `geglu_ff.launches_by_route`), however many kernels its route runs.

Gradients: `geglu_ff` is differentiable through `_GegluFn`, taken only when
grad mode is on and an input requires grad. Its backward is `geglu_vjp`, the
recompute VJP of `geglu_plain` (autograd over library matmuls), as the JAX
package's `_bwd` is an XLA recompute VJP of `_ref_impl`, not a Pallas kernel.

The JAX package's v5e gate (`geglu_supported`, m >= 16384) is not carried
over: on a CUDA tensor the port always takes a kernel.

Dispatch is by device only: a CPU tensor takes `geglu_plain`; a CUDA tensor
launches the plan's kernels or raises.
"""

from __future__ import annotations

import dataclasses
from collections import Counter

import torch

from dpm_solver_tpu_torch.ops import _build

ROUTES = {"f32": 0, "wmma": 1, "wgmma": 2}   # the C entry's route codes
# the "wmma" kernel keeps a 32-row tile of width d resident in shared memory
MAX_D = 1536
SMS = 132              # streaming multiprocessors of one H100 SXM
GATE_COLS = 64         # inner columns of one gate block
GATE_STAGES = 3        # its ring of (rows x 64 x, 128 x 64 W1) bf16 tiles
DOWN_COLS = 160        # output columns of one down block
DOWN_STAGES = 4        # its ring of (rows x 64 P, 160 x 64 W2) bf16 tiles
MAX_SPLITS = 16


def gate_smem(rows: int) -> int:
    """Shared memory of one gate block (csrc/geglu.cu, `GateTile`): the
    ring, 1024 bytes to align it to a swizzle atom, a full and an empty
    barrier per stage."""
    return 1024 + GATE_STAGES * (rows * 128 + 2 * GATE_COLS * 128) + 16 * GATE_STAGES


def down_smem(rows: int) -> int:
    """Shared memory of one down block (csrc/geglu.cu, `DownTile`)."""
    return 1024 + DOWN_STAGES * (rows * 128 + DOWN_COLS * 128) + 16 * DOWN_STAGES


@dataclasses.dataclass(frozen=True)
class GegluPlan:
    """route: "wgmma", "wmma" or "f32". For "wgmma": gate_rows and down_rows
    (128 or 64), the rows of a gate block (GATE_COLS inner columns) and of a
    down block (DOWN_COLS output columns); splits, the down kernel's split of
    the reduction over inner (1: none). The other routes leave them 0."""

    route: str
    gate_rows: int = 0
    down_rows: int = 0
    splits: int = 0

    def gate_blocks(self, m: int, inner: int) -> int:
        return -(-m // self.gate_rows) * -(-inner // GATE_COLS)

    def down_blocks(self, m: int, d: int) -> int:
        return -(-m // self.down_rows) * -(-d // DOWN_COLS) * self.splits


def geglu_plan(m: int, d: int, inner: int, dtype: torch.dtype, aligned: bool = True) -> GegluPlan:
    """The route and tiles for x (m, d) -> inner -> d in `dtype`; `aligned`:
    the tensors start on 16-byte boundaries (TMA needs it).

    The gate kernel runs two blocks an SM: 128-row blocks while they give at
    least two per SM, else 64. The down kernel runs one: 128-row blocks
    while they give at least one per SM, else 64; and where even those fall
    short, the fewest splits of the reduction that make up the difference
    (each split at least 4 of the 64-deep chunks)."""
    if dtype == torch.float32:
        return GegluPlan("f32")
    if d % 8 or inner % 8 or not aligned:
        return GegluPlan("wmma")
    gate_rows = 128 if -(-m // 128) * -(-inner // GATE_COLS) >= 2 * SMS else 64
    down_rows = 128 if -(-m // 128) * -(-d // DOWN_COLS) >= SMS else 64
    blocks = -(-m // down_rows) * -(-d // DOWN_COLS)
    chunks = -(-inner // 64)
    splits = 1
    if blocks < SMS:
        splits = min(-(-SMS // blocks), max(1, chunks // 4), MAX_SPLITS)
        per = -(-chunks // splits)
        splits = -(-chunks // per)   # no split left empty
    return GegluPlan("wgmma", gate_rows, down_rows, splits)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """gelu(approximate=False): x * Phi(x)."""
    return 0.5 * x * (1.0 + torch.erf(x * 2.0 ** -0.5))


def geglu_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                b2: torch.Tensor) -> torch.Tensor:
    """The unfused composition the kernels match: fp32 h and gate, the gated
    tile cast to x's dtype, an fp32 down-projection, the output in x's dtype.
    The products take the rounded operands in fp32, i.e. bf16 inputs with an
    fp32 result (XLA's `preferred_element_type=float32`)."""
    h = x.float() @ w1.to(x.dtype).float().t() + b1.float()
    h, gate = h.chunk(2, dim=-1)
    hg = (h * gelu_exact(gate)).to(x.dtype)
    return (hg.float() @ w2.to(x.dtype).float().t() + b2.float()).to(x.dtype)


def geglu_vjp(g: torch.Tensor, x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor, needs=(True,) * 5) -> tuple:
    """(dx, dw1, db1, dw2, db2) at cotangent g: the VJP of `geglu_plain`,
    recomputed from the inputs (the JAX package's `_bwd`); None where
    `needs` is False. Each gradient has its input's dtype."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(bool(n)) for t, n in zip((x, w1, b1, w2, b2), needs)]
        out = geglu_plain(*ins)
        wanted = [t for t, n in zip(ins, needs) if n]
        grads = iter(torch.autograd.grad(out, wanted, g.to(out.dtype)))
    return tuple(next(grads) if n else None for n in needs)


def _check(x2, w1, b1, w2, b2, plan: GegluPlan = None):
    """Raise on what the kernels do not take; with no plan, MAX_D binds."""
    m, d = x2.shape
    if w2.dim() != 2 or w2.shape[0] != d:
        raise ValueError(f"geglu_ff takes w2 (d, inner); got {tuple(w2.shape)} for d = {d}")
    inner = w2.shape[1]
    if tuple(w1.shape) != (2 * inner, d):
        raise ValueError(f"geglu_ff takes w1 (2 * inner, d) = ({2 * inner}, {d}); got "
                         f"{tuple(w1.shape)}")
    if x2.dtype not in (torch.float32, torch.bfloat16) or w1.dtype != x2.dtype \
            or w2.dtype != x2.dtype:
        raise TypeError(f"geglu kernel takes float32 or bfloat16 x, w1 and w2 of one dtype; "
                        f"got {x2.dtype}, {w1.dtype}, {w2.dtype}")
    for name, t, size in (("b1", b1, 2 * inner), ("b2", b2, d)):
        if t.shape != (size,) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"geglu kernel takes a contiguous float32 {name} of shape "
                             f"({size},)")
    if not (x2.is_contiguous() and w1.is_contiguous() and w2.is_contiguous()):
        raise ValueError("geglu kernel needs contiguous x, w1 and w2")
    if any(t.device != x2.device for t in (w1, b1, w2, b2)):
        raise ValueError("geglu_ff: x, w1, b1, w2 and b2 must share a device")
    if (plan is None or plan.route == "wmma") and d > MAX_D:
        raise ValueError(f"geglu's wmma kernel takes d <= {MAX_D}, got {d}")
    if m * max(d, inner) >= 2**31 or d * 2 * inner >= 2**31:
        raise ValueError("geglu kernel takes fewer than 2**31 elements per tensor")


def geglu_launch(x2, w1, b1, w2, b2, plan: GegluPlan) -> torch.Tensor:
    """Run `plan`'s kernels on x2 (m, d) on the card; count the launch."""
    b1, b2 = b1.to(torch.float32).contiguous(), b2.to(torch.float32).contiguous()
    _check(x2, w1, b1, w2, b2, plan)
    m, d = x2.shape
    inner = w2.shape[1]
    out = torch.empty_like(x2)
    p = part = None
    if plan.route == "wgmma":
        p = torch.empty((m, inner), dtype=x2.dtype, device=x2.device)
        if plan.splits > 1:
            part = torch.empty((plan.splits, m, d), dtype=torch.float32, device=x2.device)
    code = _build.library().dpm_geglu_fwd(
        x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        out.data_ptr(), None if p is None else p.data_ptr(),
        None if part is None else part.data_ptr(), m, d, inner, ROUTES[plan.route],
        plan.gate_rows, plan.down_rows, plan.splits, _build.stream_ptr(x2.device))
    _build.check(code, "geglu_ff")
    geglu_ff.launches += 1
    geglu_ff.launches_by_route[plan.route] += 1
    return out


def _forward(x, w1, b1, w2, b2):
    if _build.device_type(x, "geglu_ff") == "cpu":
        return geglu_plain(x, w1, b1, w2, b2)
    lead, d = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, d)
    if x2.shape[0] == 0:
        return torch.empty_like(x)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x2, w1, w2))
    plan = geglu_plan(x2.shape[0], d, w2.shape[-1], x.dtype, aligned)
    return geglu_launch(x2, w1, b1, w2, b2, plan).reshape(*lead, d)


class _GegluFn(torch.autograd.Function):
    """Autograd for `geglu_ff`: keeps the inputs; the backward is `geglu_vjp`."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return _forward(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        return geglu_vjp(g, *ctx.saved_tensors, needs=ctx.needs_input_grad)


def geglu_ff(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
             b2: torch.Tensor) -> torch.Tensor:
    """GEGLU feed-forward over the last axis of x (..., d) -> (..., d).
    Differentiable in every input (see the module docstring)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1, b1, w2, b2)):
        return _GegluFn.apply(x, w1, b1, w2, b2)
    return _forward(x, w1, b1, w2, b2)


geglu_ff.launches = 0
geglu_ff.launches_by_route = Counter()
