"""The port's BSRGAN degradation (dpm_solver_tpu_torch/utils/degradation.py)
and blind-SR data (`data.superres_example`, `data.superres_dataset`) against
the JAX package's functions, under the same `np.random.Generator` seeds:
every public function gives the JAX function's array, bit for bit (both are
host numpy, cv2 and scipy in the same order of draws). Held to the JAX
functions, not to the reference checkout."""

import numpy as np
import pytest

from dpm_solver_tpu import data as jdata
from dpm_solver_tpu.utils import degradation as JD
from dpm_solver_tpu_torch import data as pdata
from dpm_solver_tpu_torch.utils import degradation as PD


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _same(u, v)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _both(name, *args, seed=None, **kw):
    """fn(*args, rng, **kw) in both packages, each with its own generator of `seed`."""
    out = []
    for mod in (PD, JD):
        extra = () if seed is None else (np.random.default_rng(seed),)
        out.append(getattr(mod, name)(*args, *extra, **kw))
    _same(*out)
    return out[0]


def _img(seed, hw=(48, 48)):
    return np.random.default_rng(seed).random((*hw, 3)).astype(np.float32)


@pytest.mark.parametrize("size,sigma", [(7, 1.2), (15, 3.0), (25, 0.4)])
def test_kernels(size, sigma):
    _both("isotropic_gaussian_kernel", size, sigma)
    _both("anisotropic_gaussian_kernel", size, 0.7, 2.0 * sigma, sigma)
    k = _both("isotropic_gaussian_kernel", size, sigma)
    for sf in (2, 3, 4):
        for upper_left in (True, False):
            _both("shift_kernel", k, sf, upper_left=upper_left)
    _both("blur", _img(0), k)


@pytest.mark.parametrize("hw,scale", [((48, 40), 0.5), ((33, 47), 0.25), ((20, 24), 2.0),
                                      ((64, 64), 0.75)])
def test_matlab_bicubic_resize(hw, scale):
    _both("matlab_bicubic_resize", _img(1, hw), scale)
    _both("matlab_bicubic_resize", _img(2, hw)[..., 0], scale)


@pytest.mark.parametrize("seed", range(4))
def test_noise_blur_resize_and_jpeg_ops(seed):
    img = _img(seed + 10)
    _both("add_sharpening", img)
    for light in (False, True):
        _both("add_blur", img, seed=seed, sf=4, light=light)
    _both("add_resize", img, seed=seed, sf=4)
    _both("add_gaussian_noise", img, seed=seed)
    _both("add_gaussian_noise", img, seed=seed + 100, noise_level1=2, noise_level2=8)
    _both("add_speckle_noise", img, seed=seed)
    _both("add_poisson_noise", img, seed=seed)
    _both("add_jpeg_noise", img, seed=seed)
    _both("add_jpeg_noise", img, seed=seed, quality_min=80, quality_max=95)
    hq = _img(seed, (96, 96))
    _both("paired_random_crop", hq[::4, ::4], hq, seed=seed, sf=4, lq_patchsize=16)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("light", [False, True])
def test_pipelines(seed, light):
    u8 = (np.random.default_rng(seed).random((96, 96, 3)) * 255).astype(np.uint8)
    img = np.random.default_rng(seed + 1).random((160, 160, 3)).astype(np.float32)
    for name, arg, kw in (("degradation_bsrgan_variant", u8, dict(sf=4, light=light)),
                          ("degradation_bsrgan", img, dict(sf=2, lq_patchsize=32, light=light))):
        _same(getattr(PD, name)(arg, rng=np.random.default_rng(seed), **kw),
              getattr(JD, name)(arg, rng=np.random.default_rng(seed), **kw))
    _same(PD.degradation_bsrgan_plus(img, sf=2, lq_patchsize=32, use_sharp=light,
                                     rng=np.random.default_rng(seed)),
          JD.degradation_bsrgan_plus(img, sf=2, lq_patchsize=32, use_sharp=light,
                                     rng=np.random.default_rng(seed)))
    for alias in ("degradation_fn_bsr", "degradation_fn_bsr_light"):
        _same(getattr(PD, alias)(u8, rng=np.random.default_rng(seed)),
              getattr(JD, alias)(u8, rng=np.random.default_rng(seed)))


def test_int_seeds_and_errors_match():
    u8 = (np.random.default_rng(0).random((96, 96, 3)) * 255).astype(np.uint8)
    _same(PD.degradation_bsrgan_variant(u8, rng=5), JD.degradation_bsrgan_variant(u8, rng=5))
    for mod in (PD, JD):
        with pytest.raises(ValueError, match="too small"):
            mod.degradation_bsrgan(_img(0, (40, 40)), sf=4, lq_patchsize=32)


@pytest.mark.parametrize("deg", ["bsrgan", "bsrgan_light", "cv_nearest", "cv_bilinear",
                                 "cv_bicubic", "cv_area", "cv_lanczos", "pil_nearest",
                                 "pil_bilinear", "pil_bicubic", "pil_box", "pil_hamming",
                                 "pil_lanczos"])
def test_superres_example_matches_jax(deg):
    img = (np.random.default_rng(11).random((140, 180, 3)) * 255).astype(np.uint8)
    for center in (False, True):
        _same(pdata.superres_example(img, size=64, degradation=deg, center_crop=center,
                                     rng=np.random.default_rng(3)),
              jdata.superres_example(img, size=64, degradation=deg, center_crop=center,
                                     rng=np.random.default_rng(3)))
    with pytest.raises(ValueError):
        pdata.superres_example(img, size=64, degradation="nope", rng=0)


def test_superres_dataset_matches_jax(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(12)
    for i, (h, w) in enumerate([(90, 120), (128, 96), (100, 100), (160, 140), (96, 130)]):
        arr = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        mode = "L" if i == 3 else "RGB"
        Image.fromarray(arr if mode == "RGB" else arr[..., 0], mode).save(tmp_path / f"{i}.png")
    (tmp_path / "notes.txt").write_text("not an image")
    kw = dict(size=32, batch_size=2, degradation="bsrgan_light", seed=4, repeat=False)
    got = list(pdata.superres_dataset(str(tmp_path), **kw))
    want = list(jdata.superres_dataset(str(tmp_path), **kw))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["image"].shape == (2, 32, 32, 3) and g["LR_image"].shape == (2, 8, 8, 3)
        _same(g, w)
    more = pdata.superres_dataset(str(tmp_path), **dict(kw, repeat=True))
    assert [next(more)["image"].shape for _ in range(4)] == [(2, 32, 32, 3)] * 4
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        pdata.superres_dataset(str(tmp_path / "empty"), **kw)
