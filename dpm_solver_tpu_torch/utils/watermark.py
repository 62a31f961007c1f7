"""Invisible watermark: blind DWT-DCT embed/decode, pure numpy/scipy.

Port of `dpm_solver_tpu/utils/watermark.py`. The reference stamps every
Stable-Diffusion output with the ``invisible-watermark`` library's ``dwtDct``
method (scripts/txt2img.py:69-74,261-264: ``put_watermark`` with the bytes
payload ``"StableDiffusionV1"``) and ships a decoder CLI
(scripts/tests/test_watermark.py: 136-bit ``dwtDct`` decode). This is a
self-contained behavioral twin of the same classic scheme: 1-level Haar DWT
of the chroma planes, quantization-index embedding of one mid-frequency DCT
coefficient per 4x4 LL block, majority vote on decode, with the same API
shape and payload conventions (bit length = 8 x len(text), default payload
"StableDiffusionV1" = 136 bits). The same arithmetic as the JAX module, so
both stamp the same bytes.

Host-side post-processing of uint8 images, once per saved PNG, not per NFE:
it stays on the host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

try:  # scipy ships with the port's dependencies; guard for minimal installs
    from scipy.fft import dctn, idctn
except ImportError:  # pragma: no cover
    dctn = idctn = None

DEFAULT_WM = "StableDiffusionV1"
_BLOCK = 4
_SCALE = 36.0
# mid-frequency coefficient of the 4x4 DCT block: high enough to survive
# the inverse transforms, low enough to stay invisible
_POS = (2, 1)


def _rgb_to_yuv(img: np.ndarray) -> np.ndarray:
    m = np.array([[0.299, 0.587, 0.114],
                  [-0.14713, -0.28886, 0.436],
                  [0.615, -0.51499, -0.10001]], np.float64)
    return img @ m.T


def _yuv_to_rgb(img: np.ndarray) -> np.ndarray:
    m = np.array([[1.0, 0.0, 1.13983],
                  [1.0, -0.39465, -0.58060],
                  [1.0, 2.03211, 0.0]], np.float64)
    return img @ m.T


def _haar2(x):
    """1-level 2-D Haar DWT -> (LL, (LH, HL, HH)); even dims required."""
    a = (x[0::2] + x[1::2]) / 2.0
    d = (x[0::2] - x[1::2]) / 2.0
    ll = (a[:, 0::2] + a[:, 1::2]) / 2.0
    lh = (a[:, 0::2] - a[:, 1::2]) / 2.0
    hl = (d[:, 0::2] + d[:, 1::2]) / 2.0
    hh = (d[:, 0::2] - d[:, 1::2]) / 2.0
    return ll, (lh, hl, hh)


def _ihaar2(ll, bands):
    lh, hl, hh = bands
    a = np.empty((ll.shape[0], 2 * ll.shape[1]))
    d = np.empty_like(a)
    a[:, 0::2], a[:, 1::2] = ll + lh, ll - lh
    d[:, 0::2], d[:, 1::2] = hl + hh, hl - hh
    out = np.empty((2 * ll.shape[0], a.shape[1]))
    out[0::2], out[1::2] = a + d, a - d
    return out


def _bits(payload: bytes) -> np.ndarray:
    return np.unpackbits(np.frombuffer(payload, np.uint8))


def _embed_plane(plane: np.ndarray, bits: np.ndarray) -> np.ndarray:
    ll, bands = _haar2(plane)
    h, w = (ll.shape[0] // _BLOCK) * _BLOCK, (ll.shape[1] // _BLOCK) * _BLOCK
    n = len(bits)
    ncols = w // _BLOCK
    for bi, i in enumerate(range(0, h, _BLOCK)):
        for bj, j in enumerate(range(0, w, _BLOCK)):
            bit = bits[(bi * ncols + bj) % n]
            block = dctn(ll[i:i + _BLOCK, j:j + _BLOCK], norm="ortho")
            c = block[_POS]
            block[_POS] = (np.floor(c / _SCALE) + 0.25 + 0.5 * bit) * _SCALE
            ll[i:i + _BLOCK, j:j + _BLOCK] = idctn(block, norm="ortho")
    return _ihaar2(ll, bands)


def _extract_plane(plane: np.ndarray, n: int, votes: np.ndarray) -> None:
    ll, _ = _haar2(plane)
    h, w = (ll.shape[0] // _BLOCK) * _BLOCK, (ll.shape[1] // _BLOCK) * _BLOCK
    ncols = w // _BLOCK
    for bi, i in enumerate(range(0, h, _BLOCK)):
        for bj, j in enumerate(range(0, w, _BLOCK)):
            block = dctn(ll[i:i + _BLOCK, j:j + _BLOCK], norm="ortho")
            frac = block[_POS] / _SCALE - np.floor(block[_POS] / _SCALE)
            votes[(bi * ncols + bj) % n] += 1.0 if frac > 0.5 else -1.0


def put_watermark(img: np.ndarray, wm: str = DEFAULT_WM) -> np.ndarray:
    """Embed ``wm`` into a uint8 RGB (H, W, 3) image; returns uint8 RGB.

    Twin of ``put_watermark`` (txt2img.py:69-74). Requires H and W
    divisible by 4 and at least 8x(payload bits) pixels for full coverage
    (standard SD sizes are fine: 512x512 carries 136 bits ~120x each).
    """
    if dctn is None:
        raise RuntimeError("scipy is required for watermarking")
    arr = np.asarray(img)
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError("expected uint8 RGB (H, W, 3)")
    h, w = arr.shape[:2]
    if h % 4 or w % 4:
        raise ValueError("image sides must be divisible by 4")
    bits = _bits(wm.encode("utf-8"))
    n_blocks = (h // 2 // _BLOCK) * (w // 2 // _BLOCK)
    if n_blocks < len(bits):
        raise ValueError(
            f"image too small for a {len(bits)}-bit payload: "
            f"{n_blocks} embeddable blocks per plane; need >= 1 per bit "
            f"(min side ~{8 * int(np.ceil(np.sqrt(len(bits))))} px square)")
    yuv = _rgb_to_yuv(arr.astype(np.float64))
    for ch in (1, 2):  # chroma planes only, as dwtDct does
        yuv[..., ch] = _embed_plane(yuv[..., ch], bits)
    return np.clip(np.rint(_yuv_to_rgb(yuv)), 0, 255).astype(np.uint8)


def decode_watermark(img: np.ndarray, n_bits: int = 136) -> bytes:
    """Blind-decode an ``n_bits`` payload (test_watermark.py semantics:
    136 bits = 17 bytes = "StableDiffusionV1"). Returns the payload bytes."""
    if dctn is None:
        raise RuntimeError("scipy is required for watermarking")
    arr = np.asarray(img)
    if arr.dtype != np.uint8 or arr.ndim != 3:
        raise ValueError("expected uint8 RGB (H, W, 3)")
    # tolerate crops/odd sizes: decode over the largest aligned region
    arr = arr[: arr.shape[0] // 4 * 4, : arr.shape[1] // 4 * 4]
    votes = np.zeros(n_bits)
    yuv = _rgb_to_yuv(arr.astype(np.float64))
    for ch in (1, 2):
        _extract_plane(yuv[..., ch], n_bits, votes)
    return np.packbits((votes > 0).astype(np.uint8)).tobytes()


def decode_watermark_text(img: np.ndarray, n_bits: int = 136,
                          errors: str = "replace") -> Optional[str]:
    try:
        return decode_watermark(img, n_bits).decode("utf-8", errors=errors)
    except Exception:  # noqa: BLE001 — mirrors the reference's bare except
        return None
