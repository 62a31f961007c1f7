"""The port's data path (dpm_solver_tpu_torch/data.py) against the JAX
package's (dpm_solver_tpu/data.py), on the CPU.

- The transforms (`scaler`, `inverse_scaler`, `logit_transform`,
  `data_transform`, `inverse_data_transform`) within 1e-6; the
  dequantization noise is the port's generator's.
- `load_cifar10_dir`: equal arrays.
- `make_dataset` with shuffle and flips off: equal to JAX's `numpy_iterator`
  batches, the [devices, (n_jitted_steps,) per_device, H, W, C] layout
  included. With them on: the same batches for the same seed, other ones
  for another, each image once an epoch.
- `tfrecord_dataset_native`: equal to JAX's to the bit, shuffle, flips and
  dequantization on, the same seed, on raw-tensor and encoded records, with
  and without a resize.
- The TensorFlow readers (`tfrecord_dataset`, `tfds_dataset`,
  `image_folder_dataset`, `lsun_dataset` in tests/test_torch_lmdb.py) with
  shuffle and flips off: within RESIZE_BOUND = 2e-4/255 of the [0, 1]
  scale, the gap between TF's antialiased resizes and `jax.image.resize`'s
  (1.2e-4 of the 0-255 scale measured, bicubic 300x410 -> 256; 1.1e-4
  bilinear). Where the two references' own gap is larger (bilinear 140x200
  -> 128x183: 1.19e-3 of the 0-255 scale), the test measures it and adds
  RESIZE_BOUND. PNG decodes are exact. JPEG: TF decodes with its own
  libjpeg-turbo, the port with the system's libjpeg (PIL's pixels); they
  differ by up to 7 levels on these noisy images, so a JPEG batch is held
  to each image's measured decode gap times the resize's gain
  (`_jpeg_bound`; measured 2.80 and 5.26 levels against bounds of 4.00 and
  8.57).
- The geometry twins: the float twins within RESIZE_BOUND. The uint8 round
  trip of `crop_resize_tf`, on a sharp-edged image whose bicubic result
  overshoots [0, 255]: within 1 everywhere, and equal wherever TF's float
  is farther than 1e-3 from an integer (TF's truncation of a flat region's
  254.99992 against its 255.0 is the ±1; the count is asserted below).
- `prefetch_iterator`: order kept, exceptions passed on.
"""

import json
import os
import pickle
import types

import numpy as np
import pytest
import torch

from dpm_solver_tpu import data as jdata
from dpm_solver_tpu_torch import data as pdata
from dpm_solver_tpu_torch import native
from tests.test_torch_native_io import _example, _raw_example, _write_tfrecord

RESIZE_BOUND = 2e-4 / 255


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for the host loops here: the suite runs several
    workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tf():
    tf = pytest.importorskip("tensorflow")
    tf.config.experimental.set_visible_devices([], "GPU")
    return tf


def _images(n, h, w, seed):
    """uint8 images: smooth fields, a sharp vertical edge, noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        base = 127 + 100 * np.sin(xx / (5.0 + i) + i) * np.cos(yy / 7.0)
        base[:, w // 3:] = 255 * (i % 2)
        out[i] = np.clip(base[..., None] + rng.normal(0, 10, (h, w, 3)), 0, 255)
    return out


def _gain(in_hw, out_hw, method):
    """The most the port's resize can grow a pixel difference: per axis
    that changes size, the largest column L1 norm of its weights."""
    from dpm_solver_tpu_torch.utils.resize import resize_weights

    g = 1.0
    for i, o in zip(in_hw, out_hw):
        if i != o:
            g *= float(np.abs(resize_weights(int(i), int(o), method)).sum(0).max())
    return g


def _jpeg_bound(payloads, out_hw, method, crop_square=False):
    """JPEG: TF decodes with its own libjpeg-turbo, the port with the
    system's libjpeg (PIL's pixels, and the JAX package's native ones): the
    bound on the [0, 1] scale is each image's decode gap (measured here, in
    levels) times the resize's gain, over 255, plus RESIZE_BOUND."""
    tf = _tf()
    worst = 0.0
    for data in payloads:
        theirs = tf.image.decode_image(data, channels=3, expand_animations=False).numpy()
        ours = pdata._decode_image(data)
        hw = (min(ours.shape[:2]),) * 2 if crop_square else ours.shape[:2]
        worst = max(worst, np.abs(theirs.astype(int) - ours).max() * _gain(hw, out_hw, method))
    return worst / 255 + RESIZE_BOUND


def _tf_jax_resize_gap(img, size, method):
    """max |tf.image.resize - jax.image.resize| (both antialiased) of one
    float HWC image: the two references' own gap, which the port, following
    `jax.image.resize`, inherits."""
    import jax

    tf = _tf()
    theirs = tf.image.resize(img, size, method=method, antialias=True).numpy()
    jmethod = {"bilinear": "linear", "bicubic": "cubic"}[method]
    ours = np.asarray(jax.image.resize(img, (*size, img.shape[-1]), jmethod, antialias=True))
    return float(np.abs(theirs - ours).max())


# ------------------------------------------------------------- transforms


@pytest.mark.parametrize("cfg", [dict(centered=True), dict(centered=False),
                                 dict(centered=False, logit_transform=True)],
                         ids=["centered", "plain", "logit"])
def test_transforms_match_jax(cfg):
    cfg = types.SimpleNamespace(**{"uniform_dequantization": False,
                                   "gaussian_dequantization": False, "logit_transform": False,
                                   **cfg})
    x = np.random.default_rng(0).uniform(0.001, 0.999, (2, 5, 5, 3)).astype(np.float32)
    xt = torch.from_numpy(x)
    for got, want in [
            (pdata.scaler(cfg.centered)(xt), jdata.scaler(cfg.centered)(x)),
            (pdata.inverse_scaler(cfg.centered)(xt), jdata.inverse_scaler(cfg.centered)(x)),
            (pdata.logit_transform(xt), jdata.logit_transform(x)),
            (pdata.data_transform(cfg, xt), jdata.data_transform(cfg, x)),
            (pdata.inverse_data_transform(cfg, xt * 6 - 3),
             jdata.inverse_data_transform(cfg, x * 6 - 3))]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_dequantization_draws_from_the_generator():
    """Uniform then Gaussian dequantization, each from `generator` in that
    order; without a generator, none (as the JAX function without a key)."""
    cfg = types.SimpleNamespace(uniform_dequantization=True, gaussian_dequantization=True,
                                logit_transform=False, centered=True)
    x = torch.rand(2, 4, 4, 3, generator=torch.Generator().manual_seed(0))
    got = pdata.data_transform(cfg, x, generator=torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(5)
    u = torch.rand(x.shape, generator=g)
    z = torch.randn(x.shape, generator=g)
    torch.testing.assert_close(got, 2.0 * ((x * 255.0 + u) / 256.0 + z * 0.01) - 1.0,
                               rtol=0, atol=0)
    torch.testing.assert_close(pdata.data_transform(cfg, x), 2.0 * x - 1.0, rtol=0, atol=0)


# ----------------------------------------------------------- CIFAR and arrays


def test_load_cifar10_dir_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(tmp_path / name, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (7, 3072), dtype=np.uint8),
                         b"labels": list(rng.integers(0, 10, 7))}, f, protocol=2)
    for train in (True, False):
        got = pdata.load_cifar10_dir(str(tmp_path), train=train)
        want = jdata.load_cifar10_dir(str(tmp_path), train=train)
        assert got.shape == want.shape == ((35 if train else 7), 32, 32, 3)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype,nd,jit,centered", [("uint8", 2, 1, True), ("uint8", 1, 3, False),
                                                   ("float32", 2, 2, True)])
def test_make_dataset_matches_jax_unshuffled(dtype, nd, jit, centered):
    """Shuffle and flips off: JAX's batches, layout included."""
    _tf()
    imgs = _images(13, 6, 5, 2)
    if dtype == "float32":
        imgs = imgs.astype(np.float32) / 255.0
    kw = dict(batch_size=4, n_jitted_steps=jit, num_local_devices=nd, random_flip=False,
              centered=centered, shuffle=False, repeat=False)
    want = list(jdata.numpy_iterator(jdata.make_dataset(imgs, **kw)))
    got = list(pdata.numpy_iterator(pdata.make_dataset(imgs, **kw)))
    assert len(got) == len(want) == 13 // (4 * jit)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    # repeated: batches run on across the epoch's end
    it = pdata.make_dataset(imgs, **dict(kw, repeat=True))
    flat = np.concatenate([next(it).reshape(-1, 6, 5, 3) for _ in range(5)])
    ref = np.concatenate([imgs] * 10)[:len(flat)].astype(np.float32)
    ref = ref / 255.0 if dtype == "uint8" else ref
    np.testing.assert_array_equal(flat, ref * 2.0 - 1.0 if centered else ref)


def test_make_dataset_shuffled_by_seed_each_image_once():
    imgs = np.arange(24, dtype=np.uint8).reshape(24, 1, 1, 1).repeat(3, -1)
    kw = dict(batch_size=8, num_local_devices=2, random_flip=True,
              uniform_dequantization=True)

    def epoch(seed):
        it = pdata.make_dataset(imgs, seed=seed, **kw)
        return np.concatenate([next(it).reshape(-1, 1, 1, 3) for _ in range(3)])

    a, b, c = epoch(0), epoch(0), epoch(1)
    assert a.shape == (24, 1, 1, 3)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    # dequantized pixel v: (u + v) / 256 with u in [0, 1)
    assert sorted(np.floor(a[:, 0, 0, 0] * 256.0).astype(int).tolist()) == list(range(24))


# -------------------------------------------------------------- TFRecords


def _ffhq_records(tmp_path, n, c=3, h=12, w=10, seed=3):
    imgs = [np.ascontiguousarray(np.transpose(im, (2, 0, 1))[:c])
            for im in _images(n, h, w, seed)]
    path = str(tmp_path / "ffhq-r08.tfrecords")
    _write_tfrecord(path, [_raw_example(im) for im in imgs])
    return path, imgs


@pytest.mark.parametrize("resolution", [0, 8], ids=["same_size", "resized"])
def test_tfrecord_dataset_native_bitwise_equal_to_jax(resolution, tmp_path):
    """Shuffle, flips and dequantization on, one seed: the same bits (the
    same draws of one default_rng, PIL's BILINEAR for the resize)."""
    path, _ = _ffhq_records(tmp_path, 11)
    kw = dict(resolution=resolution, batch_size=3, uniform_dequantization=True, centered=True,
              random_flip=True, shuffle=True, repeat=True, seed=9)
    want, got = jdata.tfrecord_dataset_native(path, **kw), pdata.tfrecord_dataset_native(path, **kw)
    for _ in range(8):   # past two epochs
        np.testing.assert_array_equal(next(got), next(want))


def test_tfrecord_dataset_native_encoded_bitwise_equal_to_jax(tmp_path):
    imgs = _images(6, 9, 7, 4)
    paths = [str(tmp_path / f"e{i}.png") for i in range(6)]
    native.write_png_batch(imgs, paths)
    rec = str(tmp_path / "enc.tfrecord")
    _write_tfrecord(rec, [_example(open(p, "rb").read(), i) for i, p in enumerate(paths)])
    kw = dict(resolution=0, batch_size=2, image_key="image", shape_key=None, label_key="label",
              uniform_dequantization=True, random_flip=True, seed=2)
    want, got = jdata.tfrecord_dataset_native(rec, **kw), pdata.tfrecord_dataset_native(rec, **kw)
    for _ in range(5):
        g, w = next(got), next(want)
        np.testing.assert_array_equal(g["image"], w["image"])
        np.testing.assert_array_equal(g["label"], w["label"])


@pytest.mark.parametrize("resolution", [0, 8, 16], ids=["none", "down", "up"])
def test_tfrecord_dataset_matches_jax(resolution, tmp_path):
    _tf()
    path, _ = _ffhq_records(tmp_path, 7)
    kw = dict(resolution=resolution, batch_size=3, centered=False, random_flip=False,
              shuffle=False, repeat=False)
    want = list(jdata.numpy_iterator(jdata.tfrecord_dataset(path, **kw)))
    got = list(pdata.tfrecord_dataset(path, **kw))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        assert np.abs(g - w).max() <= RESIZE_BOUND
        if not resolution:
            np.testing.assert_array_equal(g, w)


def test_tfrecord_dataset_shuffled_by_seed(tmp_path):
    path, _ = _ffhq_records(tmp_path, 6)
    kw = dict(resolution=0, batch_size=3, random_flip=True, uniform_dequantization=True)
    a = next(pdata.tfrecord_dataset(path, seed=1, **kw))
    b = next(pdata.tfrecord_dataset(path, seed=1, **kw))
    c = next(pdata.tfrecord_dataset(path, seed=2, **kw))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def _tfds_dir(tmp_path, fmt, size, n=7, shards=2):
    """A prepared TFDS directory (dataset_info.json, features.json, split
    shards of encoded-image Examples with a ClassLabel)."""
    import io

    from PIL import Image

    root = tmp_path / "tfds" / "celeb_a" / "2.1.0"
    root.mkdir(parents=True)
    payloads = []
    for im in _images(n, *size, 5):
        bio = io.BytesIO()
        Image.fromarray(im).save(bio, format=fmt, quality=92)
        payloads.append(bio.getvalue())
    per = -(-n // shards)
    for s in range(shards):
        recs = [_example(payloads[i], i % 5, key=b"img") for i in range(s * per, min(n, (s + 1) * per))]
        _write_tfrecord(str(root / f"celeb_a-train.tfrecord-{s:05d}-of-{shards:05d}"), recs)
    (root / "dataset_info.json").write_text(json.dumps({"name": "celeb_a", "splits": [
        {"name": "train", "shardLengths": [str(per)] * shards}]}))
    (root / "features.json").write_text(json.dumps({"featuresDict": {"features": {
        "img": {"pythonClassName": "tensorflow_datasets.core.features.image_feature.Image"},
        "lbl": {"pythonClassName": "tensorflow_datasets.core.features.class_label_feature"
                                   ".ClassLabel"}}}}))
    return str(tmp_path / "tfds"), payloads


@pytest.mark.parametrize("fmt,transform,resolution,size",
                         [("PNG", None, 0, (30, 24)), ("PNG", None, 16, (30, 24)),
                          ("JPEG", None, 12, (30, 24)),
                          ("PNG", "celeba_scoresde", 64, (160, 150))])
def test_tfds_dataset_matches_jax(fmt, transform, resolution, size, tmp_path):
    """Shuffle and flips off, labels on: JAX's batches within RESIZE_BOUND
    (JPEG: `_jpeg_bound`), the labels equal."""
    _tf()
    data_dir, payloads = _tfds_dir(tmp_path, fmt, size)
    bound = (_jpeg_bound(payloads, (resolution,) * 2, "bilinear") if fmt == "JPEG"
             else RESIZE_BOUND)
    kw = dict(name="celeb_a", split="train", resolution=resolution, batch_size=3,
              shuffle=False, random_flip=False, repeat=False, with_labels=True,
              transform=transform)
    want = [{k: np.asarray(v) for k, v in b.items()} for b in jdata.tfds_dataset(data_dir, **kw)]
    got = list(pdata.tfds_dataset(data_dir, **kw))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["image"].shape == w["image"].shape and g["image"].dtype == np.float32
        assert np.abs(g["image"] - w["image"]).max() <= bound
        np.testing.assert_array_equal(g["label"], w["label"])
    with pytest.raises(ValueError, match="unknown transform"):
        pdata.tfds_dataset(data_dir, name="celeb_a", transform="nope")


# ---------------------------------------------------------- image folders


def _folder(tmp_path, fmt, sizes, seed=6):
    from PIL import Image

    d = tmp_path / f"folder_{fmt.lower()}"
    d.mkdir()
    for i, (h, w) in enumerate(sizes):
        img = _images(1, h, w, seed + i)[0]
        if fmt == "PNG":
            native.write_png_batch(img[None], [str(d / f"{i:03d}.png")])
        else:
            Image.fromarray(img).save(d / f"{i:03d}.jpg", quality=92)
    return str(d)


FOLDER_CASES = [("PNG", None, 32, [(40, 56), (70, 45), (33, 33), (64, 90)]),
                ("JPEG", None, 24, [(40, 56), (70, 45), (33, 33), (64, 90)]),
                ("PNG", "celeba_ddpm", 64, [(218, 178)] * 4),
                ("PNG", "celeba_scoresde", 64, [(218, 178)] * 4),
                ("PNG", "lsun_scoresde", 128, [(140, 200), (256, 160), (130, 130), (150, 170)])]


@pytest.mark.parametrize("fmt,transform,resolution,sizes", FOLDER_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in FOLDER_CASES])
def test_image_folder_dataset_matches_jax(fmt, transform, resolution, sizes, tmp_path):
    """Shuffle and flips off: JAX's batches within RESIZE_BOUND (generic
    bicubic, and each float geometry twin); JPEG within `_jpeg_bound`;
    lsun_scoresde at 128 px (bilinear to a non-integer ratio, 140x200 ->
    128x183 among them) within the references' own resize gap there
    (measured 1.19e-3 of the 0-255 scale) plus RESIZE_BOUND."""
    _tf()
    d = _folder(tmp_path, fmt, sizes)
    files = sorted(os.listdir(d))
    if fmt == "JPEG":
        bound = _jpeg_bound([open(os.path.join(d, f), "rb").read() for f in files],
                            (resolution,) * 2, "bicubic", crop_square=True)
    elif transform == "lsun_scoresde":
        gaps = []
        for f in files:
            img = pdata._decode_image(open(os.path.join(d, f), "rb").read())
            hw = np.asarray(img.shape[:2], np.float32)
            size = tuple(np.round(hw * (np.float32(resolution) / hw.min())).astype(int))
            gaps.append(_tf_jax_resize_gap(img.astype(np.float32) * pdata._U8_SCALE, size,
                                           "bilinear"))
        bound = max(gaps) + RESIZE_BOUND
    else:
        bound = RESIZE_BOUND
    kw = dict(resolution=resolution, batch_size=2, centered=False, random_flip=False,
              shuffle=False, repeat=False, transform=transform)
    want = [np.asarray(b) for b in jdata.image_folder_dataset(d, **kw)]
    got = list(pdata.image_folder_dataset(d, **kw))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2, resolution, resolution, 3)
        assert np.abs(g - w).max() <= bound


def test_image_folder_dataset_uint8_round_trip_within_one_level(tmp_path):
    """lsun_scoresde at 96 px takes crop_resize_tf's uint8 round trip: JAX's
    batches within one level (1/255) of the [0, 1] scale, as the geometry
    twin's rule below."""
    _tf()
    d = _folder(tmp_path, "PNG", [(120, 150), (100, 100)])
    kw = dict(resolution=96, batch_size=2, random_flip=False, shuffle=False, repeat=False,
              transform="lsun_scoresde")
    (want,), (got,) = [np.asarray(b) for b in jdata.image_folder_dataset(d, **kw)], \
        list(pdata.image_folder_dataset(d, **kw))
    assert np.abs(got - want).max() <= 1.0 / 255 + 1e-7


def test_image_folder_dataset_shuffle_flip_and_errors(tmp_path):
    d = _folder(tmp_path, "PNG", [(20, 20)] * 6)
    kw = dict(resolution=8, batch_size=3)
    a, b, c = (next(pdata.image_folder_dataset(d, seed=s, **kw)) for s in (1, 1, 2))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    with pytest.raises(ValueError, match="unknown transform"):
        pdata.image_folder_dataset(d, transform="nope", **kw)
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        pdata.image_folder_dataset(str(empty), **kw)


# ------------------------------------------------------- geometry twins


def _celeba_like(seed):
    """178x218 uint8 image (CelebA aligned geometry: W=178, H=218)."""
    return np.random.default_rng(seed).integers(0, 256, (218, 178, 3), dtype=np.uint8)


@pytest.mark.parametrize("name,resolution,image", [
    ("celeba_ddpm", 128, "celeba"), ("celeba_ddpm", 64, "celeba"),
    ("celeba_scoresde", 140, "celeba"), ("celeba_scoresde", 64, "celeba"),
    ("lsun_scoresde", 128, "wide")])
def test_float_geometry_twins_match_jax(name, resolution, image):
    tf = _tf()
    img = _celeba_like(1) if image == "celeba" else _images(1, 256, 512, 7)[0]
    want = np.asarray(jdata.DATASET_TRANSFORMS[name](tf.constant(img), resolution))
    got = pdata.DATASET_TRANSFORMS[name](img, resolution)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= RESIZE_BOUND


def test_crop_resize_uint8_round_trip():
    """A sharp-edged image whose bicubic result overshoots [0, 255]. TF's
    cast of a tensor whose size is a multiple of its vector packet (64 x 64
    x 3) truncates and saturates; the port truncates and clamps. Rules:
    within 1 everywhere; equal wherever TF's float is farther than 1e-3 from
    an integer (where it is nearer, TF's float and `jax.image.resize`'s
    straddle the integer on a flat region: 254.99992 against 255.0)."""
    tf = _tf()
    img = np.zeros((150, 200, 3), np.uint8)
    img[:, 100:] = 255
    img[40:80, 60:120] = 255
    img[100:, :, 1] = 128
    tf_float = np.asarray(tf.image.resize(tf.constant(img[:, 25:175]), (64, 64),
                                          method="bicubic", antialias=True))
    assert tf_float.min() < -0.5 and tf_float.max() > 255.5   # the overshoot
    want = np.asarray(jdata.crop_resize_tf(tf.constant(img), 64)).astype(int)
    got = pdata.crop_resize_tf(img, 64)
    assert got.dtype == np.uint8 and got.shape == (64, 64, 3)
    d = got.astype(int) - want
    assert np.abs(d).max() <= 1
    far = np.abs(tf_float - np.round(tf_float)) > 1e-3
    np.testing.assert_array_equal(got[far], want[far])
    # the one-level pixels all lie where TF's float is near an integer
    # (measured with TF 2.21: 2,500 of the 12,288, among the 11,012 within
    # 1e-3 of an integer, the image's flat regions)
    assert int((d != 0).sum()) == int((d[~far] != 0).sum())
    # a crop at the resolution is the identity, as the JAX twin's golden test
    np.testing.assert_array_equal(pdata.crop_resize_tf(img, 150), img[:, 25:175])


# --------------------------------------------------------------- prefetch


def test_prefetch_iterator_keeps_order_and_passes_exceptions():
    import time

    def slow(n):
        for i in range(n):
            time.sleep(0.001 * (i % 3))
            yield i

    assert list(pdata.prefetch_iterator(slow(50), depth=1)) == list(range(50))

    def boom():
        yield from range(3)
        raise KeyError("worker failed")

    it = pdata.prefetch_iterator(boom(), depth=2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    with pytest.raises(KeyError, match="worker failed"):
        next(it)
