"""Image resizing with `jax.image.resize`'s semantics, on torch tensors.

`jax.image.resize` (jax/_src/image/scale.py) resamples each spatial axis by
one weight matrix, `compute_weight_mat`: a kernel (triangle for "linear",
Keys' cubic for "cubic", Lanczos) evaluated at the distance from each
output sample's centre in input coordinates, widened by the reduction
factor when downsampling (antialias), each column normalised to sum to 1.
`torch.nn.functional.interpolate` agrees with it only approximately (and
only with `antialias=True`), so the port builds the same matrices on the
host (in float32, as JAX does) and applies them as products: both packages
then compute the same function. "nearest" picks input pixel floor((i + 0.5) * in / out)
(an 8x reduction takes pixel 8i + 4; torch's "nearest" takes 8i), as JAX
does, in float32.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

_METHODS = {"linear": "linear", "bilinear": "linear", "trilinear": "linear",
            "triangle": "linear", "cubic": "cubic", "bicubic": "cubic",
            "tricubic": "cubic", "lanczos3": "lanczos3", "lanczos5": "lanczos5",
            "nearest": "nearest"}


def _kernel(name: str, x: np.ndarray) -> np.ndarray:
    """jax/_src/image/scale.py's kernels, on float32 `x`."""
    f32 = np.float32
    if name == "linear":
        return np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    if name == "cubic":  # Keys (1981), a = -0.5
        out = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0)
        out = np.where(x >= 1.0, ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0)) * x + f32(2.0), out)
        return np.where(x >= 2.0, f32(0.0), out)
    radius = f32(3.0 if name == "lanczos3" else 5.0)
    y = radius * np.sin(f32(np.pi) * x) * np.sin(f32(np.pi) * x / radius)
    out = np.where(x > 1e-3, y / np.where(x != 0, f32(np.pi ** 2) * x ** 2, f32(1.0)), f32(1.0))
    return np.where(x > radius, f32(0.0), out)


@functools.lru_cache(maxsize=64)
def resize_weights(in_size: int, out_size: int, method: str = "linear",
                   antialias: bool = True) -> np.ndarray:
    """(in_size, out_size) float32 matrix W of one axis: out[j] = sum_i
    in[i] W[i, j] (`compute_weight_mat` with scale out/in and no
    translation, in float32 and in its order of operations, as JAX runs it
    with x64 off: its sample positions carry float32 rounding, ~1e-5 of a
    pixel at 256 px, which float64 weights would not reproduce)."""
    name = _METHODS[method]
    if name == "nearest":
        w = np.zeros((in_size, out_size), np.float32)
        w[nearest_indices(in_size, out_size), np.arange(out_size)] = 1.0
        return w
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0)) if antialias else f32(1.0)
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.0) - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = _kernel(name, x).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * float(np.finfo(np.float32).eps)),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= f32(-0.5)) & (sample_f <= f32(in_size - 0.5))
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    """The input pixel each output pixel of a "nearest" resize takes."""
    offsets = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) \
        * np.float32(in_size) / np.float32(out_size)
    return np.floor(offsets.astype(np.float32)).astype(np.int64)


def resize(x: torch.Tensor, size: Tuple[int, int], method: str = "linear",
           antialias: bool = True) -> torch.Tensor:
    """NHWC `x` resampled to (H', W') = `size` as `jax.image.resize(x, (B, H',
    W', C), method)` computes it (antialiased when downsampling). An axis
    whose size does not change is left as it is, as there."""
    if method not in _METHODS:
        raise ValueError(f"resize method must be one of {sorted(_METHODS)}, got {method!r}")
    b, h, w, c = x.shape
    oh, ow = size
    if not torch.is_floating_point(x):
        x = x.float()
    if _METHODS[method] == "nearest":
        if oh != h:
            x = x[:, torch.from_numpy(nearest_indices(h, oh)).to(x.device)]
        if ow != w:
            x = x[:, :, torch.from_numpy(nearest_indices(w, ow)).to(x.device)]
        return x
    if oh != h:
        wh = torch.from_numpy(resize_weights(h, oh, method, antialias)).to(x.device, x.dtype)
        x = torch.einsum("bhwc,hk->bkwc", x, wh)
    if ow != w:
        ww = torch.from_numpy(resize_weights(w, ow, method, antialias)).to(x.device, x.dtype)
        x = torch.einsum("bhwc,wk->bhkc", x, ww)
    return x

