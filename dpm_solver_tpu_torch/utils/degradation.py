"""BSRGAN-style image degradation pipelines for blind-SR training data.

Port of `dpm_solver_tpu/utils/degradation.py`, the behavioral twin of
examples/stable-diffusion/ldm/modules/image_degradation/
{bsrgan,bsrgan_light}.py (the "Designing a Practical Degradation Model for
Deep Blind Image Super-Resolution" recipe the LDM superres dataset applies
on the host): random an/isotropic Gaussian blurs, multi-interpolation
rescales, three Gaussian-noise flavors, Poisson / speckle noise, JPEG
round-trips, USM sharpening, and the shuffled-op pipelines
`degradation_bsrgan` (paired patches), `degradation_bsrgan_variant`
(full + light flavors) and `degradation_bsrgan_plus`.

Host-side data augmentation (numpy, cv2, scipy), as in the JAX package: no
device work, so nothing here touches torch. Every sampler draws from an
explicit `np.random.Generator`, in the JAX module's order, so the same seed
gives the same images there and here. Kernels are vectorized and the
pipelines are data-driven op lists.

Matlab-semantic helpers (`fspecial` gaussian, `imresize` bicubic with
antialiasing) are implemented from their published definitions
(bsrgan_light.py:145-226 documents the expected behavior).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

try:  # cv2 ships with the port's dependencies; guard for minimal installs
    import cv2
    _HAS_CV2 = True
except ImportError:  # pragma: no cover
    _HAS_CV2 = False

from scipy import ndimage
import scipy.linalg

# cv2 interpolation codes drawn by the reference: 1=linear, 2=cubic, 3=area.
_INTERPS = (1, 2, 3)


def _rng(rng) -> np.random.Generator:
    return rng if isinstance(rng, np.random.Generator) \
        else np.random.default_rng(rng)


def _resize(img, wh: Tuple[int, int], interpolation: int):
    return cv2.resize(img, wh, interpolation=interpolation)


# --------------------------------------------------------------- blur kernels


def isotropic_gaussian_kernel(size: int, sigma: float) -> np.ndarray:
    """Matlab `fspecial('gaussian', size, sigma)` semantics
    (bsrgan_light.py:187-199): centered grid, sub-eps truncation,
    sum-normalized."""
    half = (size - 1) / 2.0
    y, x = np.mgrid[-half:half + 1, -half:half + 1]
    h = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    h[h < np.finfo(float).eps * h.max()] = 0.0
    s = h.sum()
    return h / s if s != 0 else h


def anisotropic_gaussian_kernel(size: int, theta: float, l1: float,
                                l2: float) -> np.ndarray:
    """Rotated-covariance Gaussian kernel (bsrgan_light.py:65-96): the
    eigenbasis is the reflection [[c, s], [s, -c]], eigenvalues (l1, l2),
    density evaluated on the half-open centered grid, sum-normalized."""
    c, s = np.cos(theta), np.sin(theta)
    V = np.array([[c, s], [s, -c]])
    cov = V @ np.diag([l1, l2]) @ np.linalg.inv(V)
    center = size / 2.0 + 0.5
    coords = np.arange(size) - center + 1
    xx, yy = np.meshgrid(coords, coords)  # k[y, x] evaluated at (cx, cy)
    pts = np.stack([xx, yy], axis=-1)
    prec = np.linalg.inv(cov)
    expo = -0.5 * np.einsum("...i,ij,...j->...", pts, prec, pts)
    k = np.exp(expo) / (2.0 * np.pi * np.sqrt(np.linalg.det(cov)))
    return k / k.sum()


def shift_kernel(k: np.ndarray, sf: int, upper_left: bool = True
                 ) -> np.ndarray:
    """Bilinear sub-pixel shift by 0.5*(sf-1) (bsrgan_light.py:99-126),
    aligning a blur kernel with zero-phase nearest downsampling."""
    h, w = k.shape[:2]
    shift = (sf - 1) * 0.5
    ys = np.arange(h, dtype=np.float64)
    xs = np.arange(w, dtype=np.float64)
    y1 = np.clip(ys + (shift if upper_left else -shift), 0, h - 1)
    x1 = np.clip(xs + (shift if upper_left else -shift), 0, w - 1)
    # separable bilinear gather
    y0 = np.floor(y1).astype(int)
    x0 = np.floor(x1).astype(int)
    y0c = np.minimum(y0 + 1, h - 1)
    x0c = np.minimum(x0 + 1, w - 1)
    wy = (y1 - y0)[:, None]
    wx = (x1 - x0)[None, :]
    g = (k[np.ix_(y0, x0)] * (1 - wy) * (1 - wx)
         + k[np.ix_(y0c, x0)] * wy * (1 - wx)
         + k[np.ix_(y0, x0c)] * (1 - wy) * wx
         + k[np.ix_(y0c, x0c)] * wy * wx)
    return g


def blur(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Mirror-padded 2D convolution per channel (bsrgan_light.py:128-142)."""
    return ndimage.convolve(img, k[..., None], mode="mirror")


# ------------------------------------------------- matlab bicubic (imresize)


def _cubic(x):
    ax = np.abs(x)
    ax2, ax3 = ax * ax, ax * ax * ax
    return ((1.5 * ax3 - 2.5 * ax2 + 1.0) * (ax <= 1)
            + (-0.5 * ax3 + 2.5 * ax2 - 4.0 * ax + 2.0)
            * ((ax > 1) & (ax <= 2)))


def _imresize_weights(in_len, out_len, scale):
    kernel_width = 4.0
    if scale < 1:  # antialiasing: stretch the kernel
        kernel_width /= scale
    x = np.arange(1, out_len + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    p = int(np.ceil(kernel_width)) + 2
    idx = left[:, None] + np.arange(p)[None, :] - 1
    dist = u[:, None] - idx - 1
    w = scale * _cubic(scale * dist) if scale < 1 else _cubic(dist)
    w = w / np.sum(w, axis=1, keepdims=True)
    # symmetric (edge-inclusive) reflection at the borders, matching the
    # reference imresize_np's flipped boundary patches
    idx = idx.astype(int)
    for _ in range(2):
        idx = np.where(idx < 0, -idx - 1, idx)
        idx = np.where(idx > in_len - 1, 2 * in_len - 1 - idx, idx)
    idx = np.clip(idx, 0, in_len - 1)
    # drop all-zero taps
    keep = ~np.all(w == 0, axis=0)
    return w[:, keep], idx[:, keep]


def matlab_bicubic_resize(img: np.ndarray, scale: float) -> np.ndarray:
    """`util.imresize_np(img, scale, antialiasing=True)` twin: matlab
    imresize semantics (cubic a=-0.5, antialiased when downscaling,
    replicate borders, output size ceil(in*scale))."""
    h, w = img.shape[:2]
    out_h, out_w = int(np.ceil(h * scale)), int(np.ceil(w * scale))
    wh, ih = _imresize_weights(h, out_h, out_h / h)
    ww, iw = _imresize_weights(w, out_w, out_w / w)
    # rows
    out = np.empty((out_h, w) + img.shape[2:], dtype=np.float64)
    for o in range(wh.shape[1]):
        contrib = img[ih[:, o]] * wh[:, o][(...,) + (None,) * (img.ndim - 1)]
        out = contrib if o == 0 else out + contrib
    # cols
    res = np.empty((out_h, out_w) + img.shape[2:], dtype=np.float64)
    for o in range(ww.shape[1]):
        contrib = out[:, iw[:, o]] \
            * ww[:, o][(None, ...) + (None,) * (img.ndim - 2)]
        res = contrib if o == 0 else res + contrib
    return res.astype(img.dtype, copy=False)


# ------------------------------------------------------------ degradation ops


def add_sharpening(img, weight=0.5, radius=50, threshold=10):
    """USM sharpening with soft threshold mask (bsrgan.py:299-322)."""
    if radius % 2 == 0:
        radius += 1
    blurred = cv2.GaussianBlur(img, (radius, radius), 0)
    residual = img - blurred
    mask = (np.abs(residual) * 255 > threshold).astype(np.float32)
    soft_mask = cv2.GaussianBlur(mask, (radius, radius), 0)
    sharp = np.clip(img + weight * residual, 0, 1)
    return soft_mask * sharp + (1 - soft_mask) * img


def add_blur(img, rng, sf=4, *, light=False):
    """Random an/isotropic Gaussian blur. Width/size laws follow the flavor:
    full (bsrgan.py:325-337) vs light (bsrgan_light.py:325-340)."""
    rng = _rng(rng)
    wd2 = 4.0 + sf
    wd = 2.0 + 0.2 * sf
    if light:
        wd2, wd = wd2 / 4.0, wd / 4.0
    if rng.random() < 0.5:
        ksize = (int(rng.integers(2, 12)) + 3 if light
                 else 2 * int(rng.integers(2, 12)) + 3)
        k = anisotropic_gaussian_kernel(
            ksize, rng.random() * np.pi, wd2 * rng.random(),
            wd2 * rng.random())
    else:
        ksize = (int(rng.integers(2, 5)) + 3 if light
                 else 2 * int(rng.integers(2, 12)) + 3)
        k = isotropic_gaussian_kernel(ksize, wd * rng.random())
    return blur(img, k)


def add_resize(img, rng, sf=4):
    """Random re-scale: 20% up to [1,2]x, 70% down to [0.5/sf,1]x, else
    identity scale (bsrgan.py:343-354)."""
    rng = _rng(rng)
    r = rng.random()
    if r > 0.8:
        s = rng.uniform(1.0, 2.0)
    elif r < 0.7:
        s = rng.uniform(0.5 / sf, 1.0)
    else:
        s = 1.0
    img = _resize(img, (int(s * img.shape[1]), int(s * img.shape[0])),
                  int(rng.choice(_INTERPS)))
    return np.clip(img, 0.0, 1.0)


def _correlated_color_noise(rng, shape_hw, level):
    """Channel-correlated Gaussian noise: covariance U^T diag(r) U scaled by
    (level/255)^2 (bsrgan_light.py:373-387 third branch)."""
    d = np.diag(rng.random(3))
    u = scipy.linalg.orth(rng.random((3, 3)))
    cov = np.abs((level / 255.0) ** 2 * (u.T @ d @ u))
    return rng.multivariate_normal(np.zeros(3), cov,
                                   shape_hw).astype(np.float32)


def add_gaussian_noise(img, rng, noise_level1=2, noise_level2=25):
    rng = _rng(rng)
    level = int(rng.integers(noise_level1, noise_level2 + 1))
    r = rng.random()
    if r > 0.6:  # per-channel ("color") noise
        img = img + rng.normal(0, level / 255.0,
                               img.shape).astype(np.float32)
    elif r < 0.4:  # shared-across-channels ("gray") noise
        img = img + rng.normal(0, level / 255.0,
                               (*img.shape[:2], 1)).astype(np.float32)
    else:
        img = img + _correlated_color_noise(rng, img.shape[:2], noise_level2)
    return np.clip(img, 0.0, 1.0)


def add_speckle_noise(img, rng, noise_level1=2, noise_level2=25):
    """Multiplicative flavor of the same three noise branches
    (bsrgan.py:390-405)."""
    rng = _rng(rng)
    level = int(rng.integers(noise_level1, noise_level2 + 1))
    img = np.clip(img, 0.0, 1.0)
    r = rng.random()
    if r > 0.6:
        img = img + img * rng.normal(0, level / 255.0,
                                     img.shape).astype(np.float32)
    elif r < 0.4:
        img = img + img * rng.normal(0, level / 255.0,
                                     (*img.shape[:2], 1)).astype(np.float32)
    else:
        img = img + img * _correlated_color_noise(rng, img.shape[:2],
                                                  noise_level2)
    return np.clip(img, 0.0, 1.0)


def add_poisson_noise(img, rng):
    """Shot noise at 10^[2,4] events/unit; half the time luminance-only
    (bsrgan.py:408-419)."""
    rng = _rng(rng)
    img = np.clip((img * 255.0).round(), 0, 255) / 255.0
    vals = 10 ** (2 * rng.random() + 2.0)
    if rng.random() < 0.5:
        img = rng.poisson(img * vals).astype(np.float32) / vals
    else:
        gray = img[..., :3] @ np.array([0.299, 0.587, 0.114])
        gray = np.clip((gray * 255.0).round(), 0, 255) / 255.0
        img = img + (rng.poisson(gray * vals).astype(np.float32) / vals
                     - gray)[..., None]
    return np.clip(img, 0.0, 1.0)


def add_jpeg_noise(img, rng, quality_min=30, quality_max=95):
    """JPEG encode/decode round trip at random quality. Full-strength
    pipelines draw quality 30-95 (bsrgan.py:418-426); the light flavor
    draws 80-95 (bsrgan_light.py:422-428)."""
    rng = _rng(rng)
    q = int(rng.integers(quality_min, quality_max + 1))
    u8 = np.uint8(np.clip(img * 255.0, 0, 255).round())
    ok, enc = cv2.imencode(".jpg", cv2.cvtColor(u8, cv2.COLOR_RGB2BGR),
                           [int(cv2.IMWRITE_JPEG_QUALITY), q])
    assert ok
    dec = cv2.cvtColor(cv2.imdecode(enc, 1), cv2.COLOR_BGR2RGB)
    return dec.astype(np.float32) / 255.0


def paired_random_crop(lq, hq, rng, sf=4, lq_patchsize=64):
    """Aligned LQ/HQ patch crop (bsrgan.py:431-439)."""
    rng = _rng(rng)
    h, w = lq.shape[:2]
    rh = int(rng.integers(0, h - lq_patchsize + 1))
    rw = int(rng.integers(0, w - lq_patchsize + 1))
    lq = lq[rh:rh + lq_patchsize, rw:rw + lq_patchsize]
    hq = hq[rh * sf:(rh + lq_patchsize) * sf,
            rw * sf:(rw + lq_patchsize) * sf]
    return lq, hq


# ---------------------------------------------------------------- pipelines


def _mod_crop(img, sf):
    h, w = img.shape[:2]
    # the reference crops rows by w%sf and cols by h%sf (bsrgan.py:551) —
    # kept verbatim for distribution parity on non-square inputs
    return img[:w - w % sf, :h - h % sf, ...].copy()


def _maybe_predownsample(img, rng, sf, scale2_prob=0.25):
    """sf=4 pipelines halve first with prob scale2_prob, then run at sf=2
    (bsrgan.py:556-563); 50/50 cv2 vs matlab-bicubic."""
    if sf == 4 and rng.random() < scale2_prob:
        if rng.random() < 0.5:
            img = _resize(img, (img.shape[1] // 2, img.shape[0] // 2),
                          int(rng.choice(_INTERPS)))
        else:
            img = matlab_bicubic_resize(img, 0.5)
        return np.clip(img, 0.0, 1.0), 2
    return img, sf


def _shuffled_order(rng, n=7):
    """Random op order with downsample2 kept before downsample3
    (bsrgan.py:565-568)."""
    order = list(rng.permutation(n))
    i2, i3 = order.index(2), order.index(3)
    if i2 > i3:
        order[i2], order[i3] = order[i3], order[i2]
    return order


def _downsample2(img, rng, sf, resize_prob):
    """Either a random-factor rescale or shifted-kernel blur + nearest
    ::sf decimation (bsrgan.py:581-595)."""
    if rng.random() < resize_prob:
        s = rng.uniform(1.0, 2.0 * sf)
        img = _resize(img, (int(img.shape[1] / s), int(img.shape[0] / s)),
                      int(rng.choice(_INTERPS)))
    else:
        k = isotropic_gaussian_kernel(25, rng.uniform(0.1, 0.6 * sf))
        k = shift_kernel(k, sf)
        img = blur(img, k / k.sum())[0::sf, 0::sf, ...]
    return np.clip(img, 0.0, 1.0)


def degradation_bsrgan_variant(image: np.ndarray, sf: int = 4,
                               rng=None, *, light: bool = False
                               ) -> Dict[str, np.ndarray]:
    """Unpaired degradation used by the LDM SR dataloaders. uint8 HWC in,
    {'image': uint8 LQ} out. `light=False` twins bsrgan.py:534-621 (two
    blur slots, noise 2-25, resize_prob 0.75); `light=True` twins
    bsrgan_light.py:534-621 (one blur, noise 1-2, resize_prob 0.8)."""
    rng = _rng(rng)
    jpeg_q = (80, 95) if light else (30, 95)
    img = image.astype(np.float32) / 255.0
    img = _mod_crop(img, sf)
    img, sf_run = _maybe_predownsample(img, rng, sf)

    a = b = None
    for op in _shuffled_order(rng):
        if op == 0:
            img = add_blur(img, rng, sf=sf_run, light=light)
        elif op == 1:
            if not light:
                img = add_blur(img, rng, sf=sf_run, light=light)
        elif op == 2:
            a, b = img.shape[1], img.shape[0]
            img = _downsample2(img, rng, sf_run,
                               resize_prob=0.8 if light else 0.75)
        elif op == 3:
            if a is None:  # downsample2 always precedes (order invariant)
                a, b = img.shape[1], img.shape[0]
            img = np.clip(_resize(img, (int(a / sf_run), int(b / sf_run)),
                                  int(rng.choice(_INTERPS))), 0.0, 1.0)
        elif op == 4:
            lo, hi = (1, 2) if light else (2, 25)
            img = add_gaussian_noise(img, rng, lo, hi)
        elif op == 5:
            if rng.random() < 0.9:
                img = add_jpeg_noise(img, rng, *jpeg_q)
        # op 6 (camera ISP) requires an isp_model; disabled in the
        # reference variants too (bsrgan.py:611-615)

    img = add_jpeg_noise(img, rng, *jpeg_q)
    return {"image": np.uint8(np.clip(img * 255.0, 0, 255).round())}


def degradation_bsrgan(img: np.ndarray, sf: int = 4,
                       lq_patchsize: int = 72, rng=None, *,
                       light: bool = False
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Paired-patch pipeline: float [0,1] HWC in, (lq, hq patch) out.

    `light=False` twins bsrgan.py::degradation_bsrgan (full blur widths,
    noise 2-25, JPEG 30-95); `light=True` twins
    bsrgan_light.py:442-530 (light blur widths, noise 2-8, JPEG 80-95).
    """
    rng = _rng(rng)
    jpeg_q = (80, 95) if light else (30, 95)
    sf_ori = sf
    img = _mod_crop(np.asarray(img, np.float32), sf)
    h, w = img.shape[:2]
    if h < lq_patchsize * sf or w < lq_patchsize * sf:
        raise ValueError(f"img size ({h}x{w}) is too small for "
                         f"{lq_patchsize}x{sf}")
    hq = img.copy()
    img, sf_run = _maybe_predownsample(img, rng, sf)

    a = b = None
    for op in _shuffled_order(rng):
        if op in (0, 1):
            img = add_blur(img, rng, sf=sf_run, light=light)
        elif op == 2:
            a, b = img.shape[1], img.shape[0]
            img = _downsample2(img, rng, sf_run, resize_prob=0.75)
        elif op == 3:
            if a is None:
                a, b = img.shape[1], img.shape[0]
            img = np.clip(_resize(img, (int(a / sf_run), int(b / sf_run)),
                                  int(rng.choice(_INTERPS))), 0.0, 1.0)
        elif op == 4:
            img = add_gaussian_noise(img, rng, 2, 8 if light else 25)
        elif op == 5:
            if rng.random() < 0.9:
                img = add_jpeg_noise(img, rng, *jpeg_q)

    img = add_jpeg_noise(img, rng, *jpeg_q)
    return paired_random_crop(img, hq, rng, sf_ori, lq_patchsize)


def degradation_bsrgan_plus(img: np.ndarray, sf: int = 4,
                            shuffle_prob: float = 0.5,
                            use_sharp: bool = True,
                            lq_patchsize: int = 64, rng=None
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """BSRGAN+Real-ESRGAN combined 13-op pipeline (bsrgan.py:
    degradation_bsrgan_plus): two blur/resize/noise rounds, optional USM
    sharpening, fixed-or-shuffled order, final rescale+JPEG+paired crop."""
    rng = _rng(rng)
    img = _mod_crop(np.asarray(img, np.float32), sf)
    h, w = img.shape[:2]
    if h < lq_patchsize * sf or w < lq_patchsize * sf:
        raise ValueError(f"img size ({h}x{w}) is too small for "
                         f"{lq_patchsize}x{sf}")
    if use_sharp:
        img = add_sharpening(img)
    hq = img.copy()

    if rng.random() < shuffle_prob:
        order = list(rng.permutation(13))
    else:
        order = list(range(13))
        order[2:6] = list(rng.permutation(order[2:6]))
        order[9:13] = list(rng.permutation(order[9:13]))

    poisson_prob = speckle_prob = 0.1
    for op in order:
        if op in (0, 7):
            img = add_blur(img, rng, sf=sf)
        elif op in (1, 8):
            img = add_resize(img, rng, sf=sf)
        elif op in (2, 9):
            img = add_gaussian_noise(img, rng, 2, 25)
        elif op in (3, 10):
            if rng.random() < poisson_prob:
                img = add_poisson_noise(img, rng)
        elif op in (4, 11):
            if rng.random() < speckle_prob:
                img = add_speckle_noise(img, rng)
        elif op == 6:
            img = add_jpeg_noise(img, rng)
        # ops 5/12 (camera ISP) need an isp_model — absent, as in the
        # reference invocation

    img = _resize(img, (int(hq.shape[1] / sf), int(hq.shape[0] / sf)),
                  int(rng.choice(_INTERPS)))
    img = add_jpeg_noise(img, rng)
    return paired_random_crop(img, hq, rng, sf, lq_patchsize)


# aliases matching the reference's import surface (image_degradation/
# __init__.py)
def degradation_fn_bsr(image, sf=4, rng=None):
    return degradation_bsrgan_variant(image, sf=sf, rng=rng, light=False)


def degradation_fn_bsr_light(image, sf=4, rng=None):
    return degradation_bsrgan_variant(image, sf=sf, rng=rng, light=True)
