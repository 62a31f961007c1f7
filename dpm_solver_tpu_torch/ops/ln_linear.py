"""LayerNorm -> Linear: the hand-written CUDA kernel and its plain twin.

Counterpart of `dpm_solver_tpu/ops/ln_linear.py` (`layer_norm_fp32`,
`ln_linear_reference`, and `ln_linear`, whose Pallas path is `_fused_call`).
`ln_linear(x, gamma, beta, w, bias)` computes LN(x; gamma, beta) @ w.T
(+ bias) over the last axis of x, with w (n, d) in torch's Linear layout (the
JAX function takes its transpose): fp32 statistics with the two-pass
variance, the normalised rows rounded once to w's dtype, an fp32
accumulator, the output in x's dtype. The kernel lives in `csrc/ln_linear.cu`; its header says what
it replaces, what bounds it on the H100 and how it is built.

The JAX package's measured v5e site table (`_SITE_WINS`) is not carried
over: the fused and unfused forms compute the same function, and on a CUDA
tensor the port always takes the kernel.

Dispatch is by device only: a CPU tensor takes `ln_linear_plain`; a CUDA
tensor launches the kernel or raises. `ln_linear.launches` counts launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from dpm_solver_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the bf16 kernel keeps a 64-row tile of width d resident in shared memory
MAX_D = 1536


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
    """The unfused composition the kernel matches: fp32 LayerNorm, cast to
    w's dtype, matmul with an fp32 result (+ fp32 bias), cast to x's dtype."""
    xn = layer_norm_fp32(x, gamma, beta, eps=eps).to(w.dtype)
    out = xn.float() @ w.float().t()  # w's dtype in, fp32 out
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def _check(x2, gamma, beta, w, bias):
    m, d = x2.shape
    if w.dim() != 2 or w.shape[1] != d:
        raise ValueError(f"ln_linear takes x (..., d) and w (n, d); got d = {d} and "
                         f"w {tuple(w.shape)}")
    n = w.shape[0]
    if x2.dtype not in _DTYPES or w.dtype != x2.dtype:
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
    if d > MAX_D:
        raise ValueError(f"ln_linear kernel takes d <= {MAX_D}, got {d}")
    if m * max(d, n) >= 2**31 or d * n >= 2**31:
        raise ValueError("ln_linear kernel takes fewer than 2**31 elements per tensor")


def ln_linear(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, w: torch.Tensor,
              bias: Optional[torch.Tensor] = None, *, eps: float = 1e-5) -> torch.Tensor:
    """LN(x; gamma, beta) @ w.T (+ bias) over the last axis; x (..., d), w (n, d)."""
    if x.device.type == "cpu":
        return ln_linear_plain(x, gamma, beta, w, bias, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"ln_linear runs on cpu or cuda, not {x.device}")
    lead, d = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, d)
    gamma, beta = gamma.to(torch.float32).contiguous(), beta.to(torch.float32).contiguous()
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()
    _check(x2, gamma, beta, w, bias)
    m, n = x2.shape[0], w.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m:
        code = _build.library().dpm_ln_linear_fwd(
            x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(), m, d, n, float(eps),
            _DTYPES[x.dtype], _build.stream_ptr(x.device))
        _build.check(code, "ln_linear")
        ln_linear.launches += 1
    return out.reshape(*lead, n)


ln_linear.launches = 0
