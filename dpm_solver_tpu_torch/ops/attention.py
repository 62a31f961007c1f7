"""Attention forward: the hand-written CUDA kernel and its plain twin.

Counterpart of the forward of `dpm_solver_tpu/ops/attention.py`
(`token_attention`, whose Pallas path is `fused_attention` -> `_forward`).
`token_attention` keeps the JAX head-major interface: q (B, T, H*dh) and
k, v (B, S, H*dh) in, (B, T, H*dh) out. The one kernel, in
`csrc/attention.cu`, stands in for all four Pallas forwards (`_forward`,
`_flash_forward`, `_flash_forward_T`, `_panel_forward_T`), which compute the
same function; its header says what it replaces, what bounds it on the H100
and how it is built. It takes head dims 32, 64, 128, 256 and 512 (the VAE's
single mid-block head). q, k and v need unit stride along the channels only:
the column slices of one fused qkv projection are read in place, not copied.
The JAX package's v5e gate (Pallas only for S >= 1024) is not carried over.

Dispatch is by device only: a CPU tensor takes `attention_plain`; a CUDA
tensor launches the kernel or raises. `token_attention.launches` counts
kernel launches. The backward (the lse, dq and dk/dv Pallas kernels) is not
ported yet.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from dpm_solver_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256, 512)
_LOG2E = math.log2(math.e)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    num_heads: int, scale: Optional[float] = None) -> torch.Tensor:
    """The same function in plain PyTorch: logits, softmax and P@V in fp32,
    the output cast back to q's dtype."""
    b, t, inner = q.shape
    s = k.shape[1]
    dh = inner // num_heads
    scale = dh ** -0.5 if scale is None else scale

    def heads(u, length):
        return u.float().reshape(b, length, num_heads, dh).transpose(1, 2)

    qh, kh, vh = heads(q, t), heads(k, s), heads(v, s)
    p = torch.softmax(qh @ kh.transpose(-1, -2) * scale, dim=-1)
    out = (p @ vh).transpose(1, 2).reshape(b, t, inner)
    return out.to(q.dtype)


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


def token_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    num_heads: int, scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v per head; q (B,T,H*dh), k/v (B,S,H*dh)."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, num_heads=num_heads, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"token_attention runs on cpu or cuda, not {q.device}")
    _check(q, k, v, num_heads)
    b, t, inner = q.shape
    s = k.shape[1]
    dh = inner // num_heads
    scale = dh ** -0.5 if scale is None else scale
    out = torch.empty((b, t, inner), dtype=q.dtype, device=q.device)
    code = _build.library().dpm_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t, s,
        num_heads, dh, float(scale * _LOG2E), *q.stride()[:2], *k.stride()[:2],
        *v.stride()[:2], _DTYPES[q.dtype], _build.stream_ptr(q.device))
    _build.check(code, "token_attention")
    token_attention.launches += 1
    return out


token_attention.launches = 0
