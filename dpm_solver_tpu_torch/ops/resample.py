"""FIR up/down-resampling ops (StyleGAN2 `upfirdn2d` family), on torch, NHWC.

Port of `dpm_solver_tpu/ops/resample.py`. There is no Pallas kernel here:
the JAX package runs each resample as one dilated depthwise XLA conv, and the
port runs it as one depthwise `F.conv2d` (`groups=C`), a library conv. The
chain pad -> zero-insert -> FIR -> decimate maps onto it as:

  * zero insertion  -> samples scattered `up` apart into a zero tensor (the
    JAX conv's `lhs_dilation`: zeros between samples only),
  * padding/cropping -> `F.pad` with possibly negative edges,
  * FIR filter       -> the flipped taps as a depthwise weight (a true
    convolution, as `scipy.signal.upfirdn` and the reference),
  * decimation       -> the conv's stride `down`.

Separable windows (a 1-D tap vector) run as two rank-1 depthwise convs, as
in the JAX package. Public functions take and return NHWC tensors.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def fir_taps(k, gain: float = 1.0, separable: bool = True):
    """Normalize a 1-D tap vector / 2-D window into filter taps.

    Returns (k1, k2) of 1-D taps when the filter is separable (given 1-D),
    else (k2d, None). Normalized so a constant signal is scaled by `gain`.
    """
    k = np.asarray(k, dtype=np.float64)
    if k.ndim == 1:
        k = k / k.sum()
        if separable:
            return (k * gain).astype(np.float32), k.astype(np.float32)
        return (np.outer(k, k) * gain).astype(np.float32), None
    assert k.ndim == 2 and k.shape[0] == k.shape[1]
    return (k / k.sum() * gain).astype(np.float32), None


def _zero_insert(x: torch.Tensor, up: Tuple[int, int]) -> torch.Tensor:
    """NCHW x with up-1 zeros between neighbouring samples along H and W."""
    uh, uw = up
    if uh == 1 and uw == 1:
        return x
    n, c, h, w = x.shape
    z = x.new_zeros((n, c, (h - 1) * uh + 1, (w - 1) * uw + 1))
    z[:, :, ::uh, ::uw] = x
    return z


_FLIPPED_TAPS = {}


def _flipped_taps(taps_hw: np.ndarray, dtype, device) -> torch.Tensor:
    """The flipped taps on `device`, made once per (taps, dtype, device), so
    a sampling call captured as a CUDA graph makes no tensor from host data."""
    key = (taps_hw.shape, taps_hw.tobytes(), dtype, torch.device(device))
    if key not in _FLIPPED_TAPS:
        _FLIPPED_TAPS[key] = torch.as_tensor(np.ascontiguousarray(taps_hw[::-1, ::-1]),
                                             dtype=dtype, device=device)
    return _FLIPPED_TAPS[key]


def _depthwise(x, taps_hw, *, up, down, pad):
    """One depthwise conv doing zero-insert + pad + FIR + decimate per axis,
    on an NCHW tensor; pad = ((top, bottom), (left, right))."""
    c = x.shape[1]
    kh, kw = taps_hw.shape
    w = _flipped_taps(taps_hw, x.dtype, x.device).expand(c, 1, kh, kw)
    (p0, p1), (q0, q1) = pad
    x = F.pad(_zero_insert(x, up), (q0, q1, p0, p1))
    return F.conv2d(x, w, stride=down, groups=c)


def upfirdn2d(x: torch.Tensor, k, up: int = 1, down: int = 1,
              pad: Tuple[int, int] = (0, 0), gain: float = 1.0) -> torch.Tensor:
    """Upsample by zero insertion, pad, FIR-filter, and decimate (NHWC).

      out[h] = decimate_down( conv( pad(zero_insert_up(x), pad0, pad1), k ) )

    `pad` entries may be negative (cropping). `k` is raw taps, 1-D or 2-D,
    not pre-normalized; pass `gain` for magnitude scaling.
    """
    assert x.dim() == 4, "expected NHWC"
    pad0, pad1 = pad
    # zero insertion puts zeros between samples only; the reference also
    # puts up-1 after the last one, so they join the high-side padding
    trail = up - 1
    k1, k2 = fir_taps(k, gain=gain)
    h = x.permute(0, 3, 1, 2)
    p = (pad0, pad1 + trail)
    if k2 is not None:  # separable: two rank-1 passes
        h = _depthwise(h, k1[:, None], up=(up, 1), down=(down, 1), pad=(p, (0, 0)))
        h = _depthwise(h, k2[None, :], up=(1, up), down=(1, down), pad=((0, 0), p))
    else:
        h = _depthwise(h, k1, up=(up, up), down=(down, down), pad=(p, p))
    return h.permute(0, 2, 3, 1).contiguous()


def _taps_width(k, factor):
    if k is None:
        k = [1.0] * factor
    return k, np.atleast_1d(np.asarray(k)).shape[0]


def upsample_2d(x, k: Optional[Sequence[float]] = None, factor: int = 2, gain: float = 1.0):
    """FIR-interpolated `factor`x upsampling (ref up_or_down_sampling.py:333-369)."""
    k, width = _taps_width(k, factor)
    p = width - factor
    return upfirdn2d(x, k, up=factor, pad=((p + 1) // 2 + factor - 1, p // 2),
                     gain=gain * factor ** 2)


def downsample_2d(x, k: Optional[Sequence[float]] = None, factor: int = 2, gain: float = 1.0):
    """FIR-antialiased `factor`x downsampling (ref up_or_down_sampling.py:372-411)."""
    k, width = _taps_width(k, factor)
    p = width - factor
    return upfirdn2d(x, k, down=factor, pad=((p + 1) // 2, p // 2), gain=gain)


def upsample_conv_2d(x, w, k: Optional[Sequence[float]] = None, factor: int = 2,
                     gain: float = 1.0):
    """Fused 2x-upsample + 3x3 conv (ref up_or_down_sampling.py:89-165).

    `w` is HWIO. As in the JAX package the reference's two flip+IO-swaps
    cancel, so the transposed conv is a plain correlation with the raw
    weight over the zero-inserted input, then the FIR smoothing.
    """
    kh, kw, _c_in, _c_out = w.shape
    assert kh == kw
    k, width = _taps_width(k, factor)
    p = (width - factor) - (kw - 1)
    h = _zero_insert(x.permute(0, 3, 1, 2), (factor, factor))
    h = F.conv2d(h, w.to(x.dtype).permute(3, 2, 0, 1), padding=kh - 1)
    return upfirdn2d(h.permute(0, 2, 3, 1), k, pad=((p + 1) // 2 + factor - 1, p // 2 + 1),
                     gain=gain * factor ** 2)


def conv_downsample_2d(x, w, k: Optional[Sequence[float]] = None, factor: int = 2,
                       gain: float = 1.0):
    """Fused FIR-antialias + stride-`factor` 3x3 conv (ref :168-209); `w` HWIO."""
    kh, kw, _c_in, _c_out = w.shape
    assert kh == kw
    k, width = _taps_width(k, factor)
    p = (width - factor) + (kw - 1)
    h = upfirdn2d(x, k, pad=((p + 1) // 2, p // 2), gain=gain).permute(0, 3, 1, 2)
    h = F.conv2d(h, w.to(x.dtype).permute(3, 2, 0, 1), stride=factor)
    return h.permute(0, 2, 3, 1).contiguous()


def nearest_upsample_2d(x, factor: int = 2):
    """Nearest-neighbor upsample (ref naive_upsample_2d, :76-80)."""
    n, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(n, h, factor, w, factor, c)
    return x.reshape(n, h * factor, w * factor, c)


def mean_downsample_2d(x, factor: int = 2):
    """Box-filter (mean-pool) downsample (ref naive_downsample_2d, :83-86)."""
    n, h, w, c = x.shape
    return x.reshape(n, h // factor, factor, w // factor, factor, c).mean(dim=(2, 4))
