"""GEGLU feed-forward: the hand-written CUDA kernel and its plain twin.

Counterpart of `dpm_solver_tpu/ops/geglu.py` (`_gelu_exact`, `_ref_impl`,
and `geglu_ff`, whose Pallas path is `_geglu_pallas`):

    [h | gate] = x @ w1.T + b1          (d -> 2 * inner, fp32)
    out = (bf16(h * gelu(gate))) @ w2.T + b2     (inner -> d, fp32, then x's dtype)

The weights are in torch's Linear layout (the JAX function takes their
transposes): `w1` is (2 * inner, d) with the [h | gate] row halves in that
order (the reference's `proj(x).chunk(2)`); b1 (2 * inner,), w2 (d, inner),
b2 (d,).
The kernel lives in `csrc/geglu.cu`; its header says what it replaces, what
bounds it on the H100 and how it is built. The (M, inner) intermediate never
reaches device memory there.

The JAX package's v5e gate (`geglu_supported`, m >= 16384) is not carried
over: on a CUDA tensor the port always takes the kernel.

Dispatch is by device only: a CPU tensor takes `geglu_plain`; a CUDA tensor
launches the kernel or raises. `geglu_ff.launches` counts launches.
"""

from __future__ import annotations

import torch

from dpm_solver_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the bf16 kernel keeps a 32-row tile of width d resident in shared memory
MAX_D = 1536


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """gelu(approximate=False): x * Phi(x)."""
    return 0.5 * x * (1.0 + torch.erf(x * 2.0 ** -0.5))


def geglu_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                b2: torch.Tensor) -> torch.Tensor:
    """The unfused composition the kernel matches: fp32 h and gate, the gated
    tile cast to x's dtype, an fp32 down-projection, the output in x's dtype.
    The products take the rounded operands in fp32, i.e. bf16 inputs with an
    fp32 result (XLA's `preferred_element_type=float32`)."""
    h = x.float() @ w1.to(x.dtype).float().t() + b1.float()
    h, gate = h.chunk(2, dim=-1)
    hg = (h * gelu_exact(gate)).to(x.dtype)
    return (hg.float() @ w2.to(x.dtype).float().t() + b2.float()).to(x.dtype)


def _check(x2, w1, b1, w2, b2):
    m, d = x2.shape
    if w2.dim() != 2 or w2.shape[0] != d:
        raise ValueError(f"geglu_ff takes w2 (d, inner); got {tuple(w2.shape)} for d = {d}")
    inner = w2.shape[1]
    if tuple(w1.shape) != (2 * inner, d):
        raise ValueError(f"geglu_ff takes w1 (2 * inner, d) = ({2 * inner}, {d}); got "
                         f"{tuple(w1.shape)}")
    if x2.dtype not in _DTYPES or w1.dtype != x2.dtype or w2.dtype != x2.dtype:
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
    if d > MAX_D:
        raise ValueError(f"geglu kernel takes d <= {MAX_D}, got {d}")
    if m * d >= 2**31 or d * 2 * inner >= 2**31:
        raise ValueError("geglu kernel takes fewer than 2**31 elements per tensor")


def geglu_ff(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
             b2: torch.Tensor) -> torch.Tensor:
    """GEGLU feed-forward over the last axis of x (..., d) -> (..., d)."""
    if x.device.type == "cpu":
        return geglu_plain(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"geglu_ff runs on cpu or cuda, not {x.device}")
    lead, d = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, d)
    b1, b2 = b1.to(torch.float32).contiguous(), b2.to(torch.float32).contiguous()
    _check(x2, w1, b1, w2, b2)
    m, inner = x2.shape[0], w2.shape[1]
    out = torch.empty_like(x2)
    if m:
        code = _build.library().dpm_geglu_fwd(
            x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            out.data_ptr(), m, d, inner, _DTYPES[x.dtype], _build.stream_ptr(x.device))
        _build.check(code, "geglu_ff")
        geglu_ff.launches += 1
    return out.reshape(*lead, d)


geglu_ff.launches = 0

