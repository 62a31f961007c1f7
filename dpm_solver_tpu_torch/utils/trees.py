"""Small tensor helpers."""

from __future__ import annotations

import torch


def bcast_right(v, ndim: int) -> torch.Tensor:
    """Append trailing singleton dims to `v` until it has `ndim` dims.

    Per-batch scalars (B,) broadcast against (B, H, W, C) activations.
    (ref semantics: expand_dims, dpm_solver_pytorch.py:1295-1305)
    """
    v = torch.as_tensor(v)
    if v.dim() > ndim:
        raise ValueError(f"cannot broadcast ndim {v.dim()} -> {ndim}")
    return v.reshape(tuple(v.shape) + (1,) * (ndim - v.dim()))
