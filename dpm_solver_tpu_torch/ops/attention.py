"""Attention, forward and backward: the hand-written CUDA kernels and their plain twins.

Counterpart of `dpm_solver_tpu/ops/attention.py` (`token_attention`, whose
Pallas paths are `fused_attention` / `flash_attention` and their custom VJPs).
`token_attention` keeps the JAX head-major interface: q (B, T, H*dh) and
k, v (B, S, H*dh) in, (B, T, H*dh) out, and is differentiable.

Forward: one kernel, in `csrc/attention.cu`, stands in for all four Pallas
forwards (`_forward`, `_flash_forward`, `_flash_forward_T`,
`_panel_forward_T`), which compute the same function. It takes head dims 32,
64, 128, 256 and 512 (the VAE's single mid-block head). q, k and v need unit
stride along the channels only: the column slices of one fused qkv projection
are read in place, not copied. The JAX package's v5e gate (Pallas only for
S >= 1024) is not carried over.

Backward (when autograd asks for it): the forward also writes each row's
base-2 log-sum-exp (`attention_lse`, the port of the Pallas side pass `_lse`),
and two kernels in `csrc/attention_bwd.cu` rebuild P from it:
`attention_dq` and `attention_dkv`, the port of `_mha_backward`'s dq and dk/dv
kernels, head dim 64 only. `delta = rowsum(dO * O)` is a torch op, as the JAX
package leaves it outside its kernels.

Dispatch is by device only: a CPU tensor takes the plain twin
(`attention_plain`, `attention_lse_plain`, `attention_backward_plain`); a
CUDA tensor launches the kernel or raises. Each of `token_attention`,
`attention_lse`, `attention_dq` and `attention_dkv` counts its own kernel
launches in `.launches`: a forward that writes the lse counts under
`attention_lse` only.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from dpm_solver_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256, 512)
BWD_HEAD_DIMS = (64,)
_LOG2E = math.log2(math.e)


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
    if dh not in HEAD_DIMS:
        raise ValueError(f"attention kernel takes head dims {HEAD_DIMS}, got {dh}")
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
    code = _build.library().dpm_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, t, s, num_heads, inner // num_heads,
        float(scale * _LOG2E), *q.stride()[:2], *k.stride()[:2], *v.stride()[:2],
        _DTYPES[q.dtype], _build.stream_ptr(q.device))
    _build.check(code, counter.__name__)
    counter.launches += 1
    return out, lse


def attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, num_heads: int,
                  scale: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward with its residual: (o, lse), lse fp32 (B*H, T) in base 2."""
    return _attend(q, k, v, num_heads, _scale(q, num_heads, scale), with_lse=True)


def _check_bwd(q, k, v, g, num_heads):
    _check(q, k, v, num_heads)
    dh = q.shape[2] // num_heads
    if dh not in BWD_HEAD_DIMS:
        raise ValueError(f"attention backward kernels take head dims {BWD_HEAD_DIMS}, got {dh}")
    if g.shape != q.shape or g.dtype != q.dtype or not g.is_contiguous():
        raise ValueError(f"attention backward takes a contiguous cotangent of q's shape and "
                         f"dtype; got {tuple(g.shape)} {g.dtype}")


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
    _check_bwd(q, k, v, g, num_heads)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    ins, rest = _bwd_args(q, k, v, g, lse, delta, num_heads, scale)
    _build.check(_build.library().dpm_attention_bwd_dq(*ins, dq.data_ptr(), *rest),
                 "attention_dq")
    attention_dq.launches += 1
    return dq


def attention_dkv(q, k, v, g, lse, delta, *, num_heads: int,
                  scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv), each (B, S, H*dh), from the same inputs as `attention_dq`."""
    if _build.device_type(q, "attention_dkv") == "cpu":
        return _backward_plain(q, k, v, g, lse, delta, num_heads, scale)[1:]
    _check_bwd(q, k, v, g, num_heads)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    ins, rest = _bwd_args(q, k, v, g, lse, delta, num_heads, scale)
    _build.check(_build.library().dpm_attention_bwd_dkv(*ins, dk.data_ptr(), dv.data_ptr(),
                                                        *rest), "attention_dkv")
    attention_dkv.launches += 1
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


token_attention.launches = 0
attention_lse.launches = 0
attention_dq.launches = 0
attention_dkv.launches = 0
