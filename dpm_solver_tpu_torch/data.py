"""Input pipelines on the host: numpy batches in the JAX package's layout.

Port of `dpm_solver_tpu/data.py`, the protocol twin of
examples/score_sde_jax/datasets.py:23-206 (uniform dequantization, random
flips, [0,1] or centered scaling, the [local_devices, n_jitted_steps,
per_device_batch] layout) and the torch example's folder datasets
(ddpm_and_guided-diffusion/datasets/*). The names and signatures are the
JAX package's; the work is numpy and PyTorch on the CPU, and the readers go
through the port's own host-IO runtime (`native/`: the TFRecord index, the
Example walker, the PNG and JPEG decoders; `utils/lmdb.py` and its native
walker). Nothing here imports TensorFlow.

What changes with TensorFlow gone:
- every pipeline is a plain iterator of numpy batches on a prefetch thread
  (`prefetch_iterator`); `numpy_iterator` passes its batches through;
- the TF twins (`make_dataset`, `tfrecord_dataset`, `tfds_dataset`,
  `image_folder_dataset`, `lsun_dataset`) draw their order, flips and
  dequantization noise from numpy generators seeded by `seed`: a fresh
  permutation each epoch (each item once an epoch), where TF's shuffle
  buffer and unseeded `random_flip_left_right` have no stream to match; with
  shuffle and flips off they compute TF's values;
- resizes are `jax.image.resize`'s (`utils/resize.py`), which agree with
  `tf.image.resize(..., antialias=True)` to ~1.2e-4 of the 0-255 scale at
  most sizes (1.2e-3 at some bilinear ratios);
- PNG and JPEG go through the port's native decoders (the JPEG one is the
  system's libjpeg, PIL's pixels, not TF's own libjpeg-turbo);
- the uint8 round trip of `crop_resize_tf` saturates (truncate, then clamp
  to [0, 255]), as TF's cast does everywhere but a vector packet's tail;
- `tfrecord_dataset_native` is the JAX function's exact twin: one
  `np.random.default_rng(seed)` draws the permutation, the flips and the
  dequantization noise in its order, and a size change takes PIL's
  BILINEAR, as there.
`superres_example` and `superres_dataset` are the JAX functions' twins on
cv2, PIL and the port's copy of the BSRGAN pipeline (`utils/degradation.py`):
one `np.random.Generator` draws the order, the crops and the degradations in
the JAX order, so a seed gives the same batches in both packages.
"""

from __future__ import annotations

import os
import pickle
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional

import numpy as np
import torch

# tf.image.convert_image_dtype's uint8 -> float32 rule: a product with the
# float32 of 1/255 (not a division, which differs at 126 of the 256 values)
_U8_SCALE = np.float32(1.0 / 255)


def scaler(centered: bool):
    """[0,1] -> model space (ref datasets.py get_data_scaler)."""
    return (lambda x: x * 2.0 - 1.0) if centered else (lambda x: x)


def inverse_scaler(centered: bool):
    return (lambda x: (x + 1.0) / 2.0) if centered else (lambda x: x)


def logit_transform(x: torch.Tensor, lam: float = 1e-6) -> torch.Tensor:
    """[0,1] pixels -> logit space (ref ddpm_and_guided-diffusion/
    datasets/__init__.py:184-186)."""
    x = lam + (1.0 - 2.0 * lam) * x
    return torch.log(x) - torch.log1p(-x)


def data_transform(data_cfg, x: torch.Tensor, *,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """[0,1] images -> model space per the config's data block
    (ref datasets/__init__.py:189-203: dequantization, then rescale to
    [-1,1] (`centered`) OR logit transform). The dequantization noise comes
    from `generator` (on x's device); without one there is none."""
    if getattr(data_cfg, "uniform_dequantization", False) and generator is not None:
        u = torch.rand(x.shape, generator=generator, dtype=x.dtype, device=x.device)
        x = (x * 255.0 + u) / 256.0
    if getattr(data_cfg, "gaussian_dequantization", False) and generator is not None:
        x = x + torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device) * 0.01
    if getattr(data_cfg, "logit_transform", False):
        return logit_transform(x)
    if data_cfg.centered:
        return 2.0 * x - 1.0
    return x


def inverse_data_transform(data_cfg, x: torch.Tensor) -> torch.Tensor:
    """Model space -> [0,1] images, clipped
    (ref datasets/__init__.py:206-215)."""
    if getattr(data_cfg, "logit_transform", False):
        x = torch.sigmoid(x)
    elif data_cfg.centered:
        x = (x + 1.0) / 2.0
    return torch.clamp(x, 0.0, 1.0)


def load_cifar10_dir(path: str, *, train: bool = True) -> np.ndarray:
    """CIFAR-10 python-pickle directory (data_batch_1..5 / test_batch) ->
    uint8 NHWC array. The standard distribution format, no tfds needed."""
    names = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
    parts = []
    for n in names:
        with open(os.path.join(path, n), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        parts.append(np.asarray(d[b"data"], np.uint8))
    flat = np.concatenate(parts)
    return flat.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)


# --------------------------------------------------------------------------- #
# order, flips, dequantization: the TF twins' host-side stand-ins
# --------------------------------------------------------------------------- #


def _index_batches(n: int, size: int, order: Optional[Callable[[], np.ndarray]],
                   repeat: bool) -> Iterator[np.ndarray]:
    """Index arrays of `size` items over epochs of n items, each epoch in
    `order()` (or 0..n-1 without one), the incomplete last batch dropped.
    With repeat, batches run on across epoch ends (tf.data's repeat, then
    batch); without, the one epoch ends the stream."""
    pending = np.empty(0, np.int64)
    while True:
        epoch = order() if order is not None else np.arange(n)
        pending = np.concatenate([pending, epoch])
        while len(pending) >= size:
            yield pending[:size]
            pending = pending[size:]
        if not repeat:
            return


def _flip_dequantize(batch: np.ndarray, rng: np.random.Generator, random_flip: bool,
                     uniform_dequantization: bool) -> np.ndarray:
    """Random horizontal flips (each image with probability 1/2), then
    uniform dequantization, (u + x * 255) / 256, of a float32 [B, H, W, C]
    batch, from `rng` in that order."""
    if random_flip:
        flips = rng.random(len(batch)) < 0.5
        batch[flips] = batch[flips, :, ::-1]
    if uniform_dequantization:
        batch = (rng.random(batch.shape, dtype=np.float32) + batch * 255.0) / 256.0
    return batch


def make_dataset(
    images: np.ndarray,
    *,
    batch_size: int,
    n_jitted_steps: int = 1,
    num_local_devices: Optional[int] = None,
    uniform_dequantization: bool = False,
    random_flip: bool = True,
    centered: bool = False,
    shuffle: bool = True,
    seed: int = 0,
    repeat: bool = True,
) -> Iterator[np.ndarray]:
    """uint8/float NHWC array -> iterator of float32 batches in the
    reference's layout [devices, (n_jitted_steps,) per_device, H, W, C]
    (ref datasets.py:86-99). `num_local_devices` defaults to 1: one card
    until the port's parallel slice. Integer pixels (0..255) are scaled to
    [0, 1]; float ones are taken as they are."""
    nd = num_local_devices or 1
    if batch_size % nd:
        raise ValueError(f"batch {batch_size} not divisible by {nd} devices")
    per_device = batch_size // nd
    images = np.asarray(images)
    integer_pixels = np.issubdtype(images.dtype, np.integer)
    rng = np.random.default_rng(seed)
    lead = (nd, n_jitted_steps, per_device) if n_jitted_steps > 1 else (nd, per_device)
    order = (lambda: rng.permutation(len(images))) if shuffle else None

    def gen():
        for idx in _index_batches(len(images), batch_size * n_jitted_steps, order, repeat):
            batch = images[idx].astype(np.float32)
            if integer_pixels:
                batch = batch / np.float32(255.0)
            batch = _flip_dequantize(batch, rng, random_flip, uniform_dequantization)
            if centered:
                batch = batch * 2.0 - 1.0
            yield batch.reshape(lead + batch.shape[1:])

    return prefetch_iterator(gen())


def numpy_iterator(ds) -> Iterator[np.ndarray]:
    for batch in ds:
        yield batch.numpy() if hasattr(batch, "numpy") else np.asarray(batch)


def prefetch_iterator(it: Iterator, depth: int = 2) -> Iterator:
    """Run `it` on a worker thread with a bounded queue — the host-side
    equivalent of tf.data's `.prefetch(depth)`, so batch prep overlaps the
    accelerator step. Exceptions propagate to the consumer."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()

    def worker():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:  # noqa: BLE001 — re-raised consumer-side
            q.put((sentinel, e))
            return
        q.put((sentinel, None))

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if isinstance(item, tuple) and len(item) == 2 and item[0] is sentinel:
            if item[1] is not None:
                raise item[1]
            return
        yield item


# --------------------------------------------------------------------------- #
# TFRecords
# --------------------------------------------------------------------------- #


def _record_index(paths):
    """[(path index, offset, length)] of every record in `paths`, and the
    files' maps."""
    from dpm_solver_tpu_torch import native

    if isinstance(paths, str):
        paths = [paths]
    index = []
    for pi, p in enumerate(paths):
        offs, lens = native.tfrecord_index(p)
        index.extend((pi, int(o), int(n)) for o, n in zip(offs, lens))
    if not index:
        raise FileNotFoundError(f"no records under {paths}")
    return index, [np.memmap(p, np.uint8, mode="r") for p in paths]


def _decode_raw(rec: bytes, image_key: str, shape_key: str) -> np.ndarray:
    """A raw-tensor record's {shape_key: int64[3] (C, H, W), image_key:
    bytes} -> uint8 HWC."""
    from dpm_solver_tpu_torch import native

    shape = _example_int64_list(rec, shape_key)
    img = np.frombuffer(native.example_bytes(rec, image_key), np.uint8).reshape(shape)
    return np.transpose(img, (1, 2, 0))  # CHW -> HWC


def tfrecord_dataset(path, *, resolution: int, batch_size: int,
                     uniform_dequantization: bool = False,
                     centered: bool = False, random_flip: bool = False,
                     shuffle: bool = True, repeat: bool = True, seed: int = 0):
    """FFHQ/CelebAHQ TFRecord pipeline: records hold a CHW uint8 tensor as
    {'shape': int64[3], 'data': bytes} (ref datasets.py:151-171). Emits
    [B, H, W, C] float32 batches in model space: each image to [0, 1] as
    `tf.image.convert_image_dtype` does, resized to `resolution` (bilinear,
    antialiased) when given one, flipped, dequantized and scaled."""
    index, blobs = _record_index(path)
    rng = np.random.default_rng(seed)
    order = (lambda: rng.permutation(len(index))) if shuffle else None

    def load(i):
        pi, off, length = index[i]
        img = _decode_raw(bytes(blobs[pi][off:off + length]), "data", "shape")
        img = img.astype(np.float32) * _U8_SCALE
        return _resize_hwc(img, (resolution, resolution), "bilinear") if resolution else img

    def gen():
        with ThreadPoolExecutor() as pool:
            for idx in _index_batches(len(index), batch_size, order, repeat):
                batch = np.stack(list(pool.map(load, idx)))
                batch = _flip_dequantize(batch, rng, random_flip, uniform_dequantization)
                yield batch * 2.0 - 1.0 if centered else batch

    return prefetch_iterator(gen())


def tfrecord_dataset_native(paths, *, resolution: int, batch_size: int,
                            image_key: str = "data",
                            shape_key: Optional[str] = "shape",
                            label_key: Optional[str] = None,
                            uniform_dequantization: bool = False,
                            centered: bool = False,
                            random_flip: bool = False,
                            shuffle: bool = True, repeat: bool = True,
                            seed: int = 0, prefetch: int = 2):
    """TensorFlow-free TFRecord reader on the native host-IO runtime
    (`dpm_solver_tpu_torch.native`): mmap + CRC32C record indexing and a
    wire-format Example walker in C++, the native PNG/JPEG decoders for
    encoded payloads. Two record layouts, as in the reference:

      * raw CHW tensors: {'shape': int64[3], 'data': raw bytes} — the
        FFHQ/CelebAHQ format (ref score_sde_jax/datasets.py:151-171);
        pass shape_key='shape'.
      * encoded images: {image_key: png/jpeg bytes[, label]} — the
        prepared-TFDS format; pass shape_key=None.

    Yields [B, H, W, C] float32 batches in model space (or
    {'image', 'label'} dicts when label_key is set); infinite when repeat.
    The JAX function's exact twin: one `np.random.default_rng(seed)` draws
    each epoch's permutation, then each batch's flips, then its
    dequantization noise; a size change is PIL's BILINEAR resize.
    """
    from dpm_solver_tpu_torch import native

    index, blobs = _record_index(paths)
    rng = np.random.default_rng(seed)

    def decode_encoded_batch(payloads) -> np.ndarray:
        h, w, c, _ = native.image_probe_mem(payloads[0])
        return native.decode_image_batch(payloads, h, w, min(c, 3))

    def maybe_resize(img: np.ndarray) -> np.ndarray:
        if resolution and img.shape[:2] != (resolution, resolution):
            from PIL import Image

            img = np.asarray(Image.fromarray(img).resize(
                (resolution, resolution), Image.BILINEAR))
        return img

    def finish(batch_u8, labels):
        """uint8 [B,H,W,C] -> model space with the reference pipeline's
        dequant/flip/scaling semantics (score_sde_jax/datasets.py:173-199)."""
        batch = np.stack([maybe_resize(im) for im in batch_u8]).astype(np.float32) / 255.0
        if random_flip:
            flips = rng.random(len(batch)) < 0.5
            batch[flips] = batch[flips, :, ::-1]
        if uniform_dequantization:
            batch = (rng.random(batch.shape).astype(np.float32) + batch * 255.0) / 256.0
        if centered:
            batch = batch * 2.0 - 1.0
        if label_key is not None:
            return {"image": batch, "label": np.asarray(labels, np.int64)}
        return batch

    def epochs():
        while True:
            order = rng.permutation(len(index)) if shuffle else np.arange(len(index))
            for b0 in range(0, len(order) - batch_size + 1, batch_size):
                recs = []
                for i in order[b0:b0 + batch_size]:
                    pi, off, length = index[i]
                    recs.append(bytes(blobs[pi][off:off + length]))
                labels = ([native.example_int64(r, label_key) for r in recs]
                          if label_key is not None else None)
                if shape_key is not None:
                    imgs = [_decode_raw(r, image_key, shape_key) for r in recs]
                else:
                    imgs = decode_encoded_batch([bytes(native.example_bytes(r, image_key))
                                                 for r in recs])
                yield finish(imgs, labels)
            if not repeat:
                return

    return prefetch_iterator(epochs(), depth=prefetch)


def _example_int64_list(rec: bytes, key: str):
    """All int64 values of a feature (the raw-tensor format stores the CHW
    shape as a 3-vector)."""
    from dpm_solver_tpu_torch import native as _n

    rec = bytes(rec)
    span = _n._find_feature_py(rec, key)
    if span is None:
        raise KeyError(key)
    vals = []
    for f, wire, v, s, e in _n._walk_fields(rec, *span):
        if f == 3 and wire == 2:  # Int64List
            for lf, lw, lv, ls, le in _n._walk_fields(rec, s, e):
                if lf == 1 and lw == 0:
                    vals.append(lv)
                elif lf == 1 and lw == 2:  # packed
                    i = ls
                    while i < le:
                        pv, i = _n._varint(rec, i)
                        vals.append(pv)
    if not vals:
        raise KeyError(key)
    return vals


# --------------------------------------------------------------------------- #
# encoded images: PNG and JPEG through the native decoders, the rest PIL
# --------------------------------------------------------------------------- #


def _decode_image(data) -> np.ndarray:
    """An encoded image -> uint8 HWC RGB, as `tf.image.decode_image(...,
    channels=3)`: PNG and JPEG through the port's native decoders, any other
    format (LSUN ships webp) through PIL, imported here, which raises if it
    is absent."""
    from dpm_solver_tpu_torch import native

    if native.image_kind(data) == "unknown":
        import io

        from PIL import Image

        with Image.open(io.BytesIO(bytes(data))) as im:
            return np.asarray(im.convert("RGB"), np.uint8)
    h, w, _, _ = native.image_probe_mem(data)
    return native.decode_image_batch([data], h, w, 3, threads=1)[0]


def _square_bicubic(img: np.ndarray, resolution: int) -> np.ndarray:
    """uint8 HWC -> float32 [0, 1] at resolution x resolution: the centre
    square (`tf.image.resize_with_crop_or_pad` to the short side), a
    bicubic antialiased resize, /255 and a clip (the LSUN and generic
    folder pipelines)."""
    h, w = img.shape[:2]
    side = min(h, w)
    top, left = (h - side) // 2, (w - side) // 2
    img = _resize_hwc(img[top:top + side, left:left + side].astype(np.float32),
                      (resolution, resolution), "bicubic")
    return np.clip(img / np.float32(255.0), 0.0, 1.0)


def lsun_dataset(root: str, *, resolution: int, batch_size: int,
                 centered: bool = False, random_flip: bool = True,
                 shuffle: bool = True, repeat: bool = True, seed: int = 0):
    """LSUN LMDB environment -> iterator of [B, H, W, C] float32 batches.

    Twin of the reference's ``LSUNClass`` (ddpm_and_guided-diffusion/
    datasets/lsun.py:12-58: lmdb env -> per-key image buffer -> decode)
    and its LSUN transform chain (datasets/__init__.py: Resize +
    CenterCrop to ``image_size``). The LMDB file is read through
    utils/lmdb.py, its entry table from the native walker, which gives O(1)
    access to every record: the order is a full permutation per epoch from
    `np.random.RandomState(seed)` (the JAX package's draw), which then draws
    each batch's flips.
    """
    from dpm_solver_tpu_torch.utils.lmdb import LMDBReader

    reader = LMDBReader(root)
    if len(reader) == 0:
        raise FileNotFoundError(f"LMDB at {root} holds no entries")
    table = reader.entry_table()
    rng = np.random.RandomState(seed)
    order = (lambda: rng.permutation(len(table))) if shuffle else None

    def load(j):
        return _square_bicubic(_decode_image(reader.read(int(table[j, 2]), int(table[j, 3]))),
                               resolution)

    def gen():
        with ThreadPoolExecutor() as pool:
            for idx in _index_batches(len(table), batch_size, order, repeat):
                batch = np.stack(list(pool.map(load, idx)))
                if random_flip:
                    flips = rng.random_sample(len(batch)) < 0.5
                    batch[flips] = batch[flips, :, ::-1]
                yield batch * 2.0 - 1.0 if centered else batch

    return prefetch_iterator(gen())


# --------------------------------------------------------------------------- #
# dataset-specific geometry twins
#
# FID comparability against published numbers depends on EXACT crop/resize
# semantics, so each reference dataset's preprocessing is reproduced
# operation-for-operation (not through the generic center-square path).
# Each maps a uint8 HWC array to a float32 HWC array in [0, 1] at
# `resolution` (`crop_resize_tf`: to uint8), with `jax.image.resize`'s
# antialiased resizes (`utils/resize.py`) where the reference has TF's.
# --------------------------------------------------------------------------- #

# the ddpm example's CelebA window: 128x128 centered at (cx=89, cy=121) on
# the 178x218 aligned images -> rows [57, 185), cols [25, 153)
# (ddpm_and_guided-diffusion/datasets/__init__.py:60-66 with Crop at :14-27)
CELEBA_DDPM_WINDOW = (57, 185, 25, 153)


def _resize_hwc(img: np.ndarray, size, method: str) -> np.ndarray:
    """float32 HWC -> HWC at `size` (h, w), antialiased, as
    `tf.image.resize(img, size, method, antialias=True)` on TF's side."""
    from dpm_solver_tpu_torch.utils.resize import resize

    x = torch.from_numpy(np.ascontiguousarray(img, np.float32))[None]
    return resize(x, tuple(int(s) for s in size), method, antialias=True)[0].numpy()


def celeba_ddpm_transform(img, resolution):
    """ddpm-example CelebA: fixed 128x128 crop + torchvision Resize
    (bilinear antialias) + ToTensor (datasets/__init__.py:60-92)."""
    r0, r1, c0, c1 = CELEBA_DDPM_WINDOW
    img = np.asarray(img)[r0:r1, c0:c1, :].astype(np.float32)
    img = _resize_hwc(img, (resolution, resolution), "bilinear")
    return np.clip(img / np.float32(255.0), 0.0, 1.0)


def _central_crop_tf(img, size):
    """(score_sde_jax/datasets.py:63-67)"""
    top = (img.shape[0] - size) // 2
    left = (img.shape[1] - size) // 2
    return img[top:top + size, left:left + size, :]


def _resize_small_tf(img, resolution):
    """Shrink so the SHORT side equals `resolution`, preserving aspect
    (score_sde_jax/datasets.py:54-60; bilinear antialias; the new size
    rounded half to even from float32, as tf.round)."""
    hw = np.asarray(img.shape[:2], np.float32)
    ratio = np.float32(resolution) / hw.min()
    return _resize_hwc(img, np.round(hw * ratio).astype(np.int32), "bilinear")


def celeba_scoresde_transform(img, resolution):
    """score_sde CelebA: to-float -> central_crop(140) -> resize_small
    (score_sde_jax/datasets.py:126-129). Crop FIRST, then shrink."""
    img = np.asarray(img).astype(np.float32) * _U8_SCALE
    return _resize_small_tf(_central_crop_tf(img, 140), resolution)


def crop_resize_tf(img, resolution):
    """Center-square crop then BICUBIC antialias resize, cast back to uint8
    BEFORE the float conversion (score_sde_jax/datasets.py:40-52 — the
    uint8 round-trip is part of the reference semantics). The cast
    truncates and saturates to [0, 255] (bicubic overshoots at sharp
    edges)."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    crop = min(h, w)
    img = img[(h - crop) // 2:(h + crop) // 2, (w - crop) // 2:(w + crop) // 2]
    img = _resize_hwc(img.astype(np.float32), (resolution, resolution), "bicubic")
    return np.clip(np.trunc(img), 0, 255).astype(np.uint8)


def lsun_scoresde_transform(img, resolution):
    """score_sde LSUN: at 128px shrink-then-center-crop, otherwise
    crop_resize (score_sde_jax/datasets.py:136-149)."""
    if resolution == 128:
        img = np.asarray(img).astype(np.float32) * _U8_SCALE
        return _central_crop_tf(_resize_small_tf(img, resolution), resolution)
    return crop_resize_tf(img, resolution).astype(np.float32) * _U8_SCALE


DATASET_TRANSFORMS = {
    "celeba_ddpm": celeba_ddpm_transform,
    "celeba_scoresde": celeba_scoresde_transform,
    "lsun_scoresde": lsun_scoresde_transform,
}


def _transform_fn(transform: Optional[str]):
    fn = DATASET_TRANSFORMS.get(transform) if transform else None
    if transform and fn is None:
        raise ValueError(f"unknown transform {transform!r}; "
                         f"have {sorted(DATASET_TRANSFORMS)}")
    return fn


def image_folder_dataset(path: str, *, resolution: int, batch_size: int,
                         centered: bool = False, random_flip: bool = True,
                         shuffle: bool = True, repeat: bool = True,
                         seed: int = 0, transform: Optional[str] = None):
    """PNG/JPEG folder -> iterator of [B, H, W, C] float32 batches.
    `transform` selects a dataset-specific geometry twin from
    DATASET_TRANSFORMS (exact reference crop/resize semantics); default is
    the generic bicubic central-crop resize (ref datasets.py crop_resize /
    FFHQ handling). Order and flips come from `np.random.default_rng(seed)`."""
    files = sorted(
        os.path.join(path, f) for f in os.listdir(path)
        if f.lower().endswith((".png", ".jpg", ".jpeg")))
    if not files:
        raise FileNotFoundError(f"no images under {path}")
    fn = _transform_fn(transform)
    rng = np.random.default_rng(seed)
    order = (lambda: rng.permutation(len(files))) if shuffle else None

    def load(i):
        with open(files[i], "rb") as f:
            img = _decode_image(f.read())
        if fn is not None:
            return np.clip(fn(img, resolution), 0.0, 1.0)
        return _square_bicubic(img, resolution)

    def gen():
        with ThreadPoolExecutor() as pool:
            for idx in _index_batches(len(files), batch_size, order, repeat):
                batch = _flip_dequantize(np.stack(list(pool.map(load, idx))), rng, random_flip,
                                         False)
                yield batch * 2.0 - 1.0 if centered else batch

    return prefetch_iterator(gen())


# --------------------------------------------------------------------------- #
# blind super-resolution pairs
# --------------------------------------------------------------------------- #


def superres_example(image_u8, *, size: int, downscale_f: int = 4,
                     degradation: str = "bsrgan_light", min_crop_f: float = 0.5,
                     max_crop_f: float = 1.0, center_crop: bool = False, rng=None):
    """One blind-SR training example from a uint8 HWC image.

    Twin of `ImageNetSR.__getitem__` (examples/stable-diffusion/ldm/data/
    imagenet.py:272-372): random-side square crop (side = min_side *
    U[min_crop_f, max_crop_f], random or center), INTER_AREA resize to
    `size`, then the selected degradation -> {'image', 'LR_image'} both
    float32 HWC in [-1, 1]. `degradation` is 'bsrgan', 'bsrgan_light', or
    one of the cv_* / pil_* interpolation names of imagenet.py:313-325.
    """
    import cv2

    from dpm_solver_tpu_torch.utils import degradation as D

    rng = rng if isinstance(rng, np.random.Generator) else np.random.default_rng(rng)
    assert size % downscale_f == 0
    lr_size = size // downscale_f
    img = np.asarray(image_u8, np.uint8)
    h, w = img.shape[:2]
    side = int(min(h, w) * rng.uniform(min_crop_f, max_crop_f))
    if center_crop:
        top, left = (h - side) // 2, (w - side) // 2
    else:
        top = int(rng.integers(0, h - side + 1))
        left = int(rng.integers(0, w - side + 1))
    img = img[top:top + side, left:left + side]
    img = cv2.resize(img, (size, size), interpolation=cv2.INTER_AREA)

    if degradation in ("bsrgan", "bsrgan_light"):
        lr = D.degradation_bsrgan_variant(img, sf=downscale_f, rng=rng,
                                          light=(degradation == "bsrgan_light"))["image"]
    elif degradation.startswith("cv_"):
        code = {"cv_nearest": cv2.INTER_NEAREST, "cv_bilinear": cv2.INTER_LINEAR,
                "cv_bicubic": cv2.INTER_CUBIC, "cv_area": cv2.INTER_AREA,
                "cv_lanczos": cv2.INTER_LANCZOS4}[degradation]
        lr = cv2.resize(img, (lr_size, lr_size), interpolation=code)
    elif degradation.startswith("pil_"):
        from PIL import Image

        code = {"pil_nearest": Image.NEAREST, "pil_bilinear": Image.BILINEAR,
                "pil_bicubic": Image.BICUBIC, "pil_box": Image.BOX,
                "pil_hamming": Image.HAMMING, "pil_lanczos": Image.LANCZOS}[degradation]
        lr = np.asarray(Image.fromarray(img).resize((lr_size, lr_size), code), np.uint8)
    else:
        raise ValueError(f"unknown degradation {degradation!r}")
    return {"image": (img / 127.5 - 1.0).astype(np.float32),
            "LR_image": (lr / 127.5 - 1.0).astype(np.float32)}


def superres_dataset(path: str, *, size: int, batch_size: int, downscale_f: int = 4,
                     degradation: str = "bsrgan_light", min_crop_f: float = 0.5,
                     max_crop_f: float = 1.0, center_crop: bool = False, seed: int = 0,
                     repeat: bool = True) -> Iterator:
    """Image folder (PNG / JPEG, read by PIL) -> iterator of {'image',
    'LR_image'} numpy batches for SR-LDM training, on the prefetch thread:
    the BSRGAN pipeline is cv2 / scipy work on the host."""
    from PIL import Image

    files = sorted(os.path.join(path, f) for f in os.listdir(path)
                   if f.lower().endswith((".png", ".jpg", ".jpeg")))
    if not files:
        raise FileNotFoundError(f"no images under {path}")
    rng = np.random.default_rng(seed)

    def gen():
        while True:
            hqs, lrs = [], []
            for i in rng.permutation(len(files)):
                img = Image.open(files[i])
                if img.mode != "RGB":
                    img = img.convert("RGB")
                ex = superres_example(
                    np.asarray(img, np.uint8), size=size, downscale_f=downscale_f,
                    degradation=degradation, min_crop_f=min_crop_f, max_crop_f=max_crop_f,
                    center_crop=center_crop, rng=rng)
                hqs.append(ex["image"])
                lrs.append(ex["LR_image"])
                if len(hqs) == batch_size:
                    yield {"image": np.stack(hqs), "LR_image": np.stack(lrs)}
                    hqs, lrs = [], []
            if not repeat:
                return

    return prefetch_iterator(gen())


# ------------------------------------------------------- TFDS on-disk reader


def _tfds_locate(data_dir: str, name: Optional[str], split: str):
    """Resolve a TFDS directory (data_dir[/name]/version) and its split
    shard files + feature spec, without tensorflow_datasets installed."""
    import json

    def _version_key(d):
        # numeric-aware so 10.0.0 beats 9.0.0 (plain sort would not)
        parts = d.split(".")
        if all(p.isdigit() for p in parts):
            return (1, tuple(int(p) for p in parts))
        return (0, d)

    root = data_dir
    if name is not None and os.path.isdir(os.path.join(data_dir, name)):
        root = os.path.join(data_dir, name)
    # descend config/version directories until dataset_info.json appears
    for depth in range(3):
        if os.path.exists(os.path.join(root, "dataset_info.json")):
            break
        subs = sorted(
            (d for d in os.listdir(root)
             if os.path.isdir(os.path.join(root, d))), key=_version_key)
        if not subs:
            break
        if depth == 0 and name is None and len(subs) > 1 \
                and not all(s[0].isdigit() for s in subs):
            raise ValueError(f"ambiguous TFDS dir {data_dir}: "
                             f"pass name= (candidates: {subs})")
        root = os.path.join(root, subs[-1])  # latest version
    info_path = os.path.join(root, "dataset_info.json")
    if not os.path.exists(info_path):
        raise FileNotFoundError(f"no dataset_info.json under {data_dir}")
    with open(info_path) as f:
        info = json.load(f)
    ds_name = info.get("name", name or "dataset")
    splits = {s["name"]: s for s in info.get("splits", [])}
    if split not in splits:
        raise ValueError(f"split {split!r} not in {sorted(splits)}")
    n_shards = len(splits[split].get("shardLengths", [])) or 1
    template = splits[split].get(
        "filepathTemplate",
        "{DATASET}-{SPLIT}.{FILEFORMAT}-{SHARD_X_OF_Y}")
    files = []
    for i in range(n_shards):
        fname = (template
                 .replace("{DATASET}", ds_name)
                 .replace("{SPLIT}", split)
                 .replace("{FILEFORMAT}", "tfrecord")
                 .replace("{SHARD_X_OF_Y}", f"{i:05d}-of-{n_shards:05d}"))
        files.append(os.path.join(root, fname))
    missing = [f for f in files if not os.path.exists(f)]
    if missing:
        raise FileNotFoundError(f"missing shards, e.g. {missing[0]}")

    feat_path = os.path.join(root, "features.json")
    image_key, label_key = "image", None
    if os.path.exists(feat_path):
        with open(feat_path) as f:
            feats = json.load(f)
        # TFDS nests the mapping as [content ->] featuresDict -> features
        # (older versions flatten differently); walk to the leaf dict
        content = feats.get("content", feats)
        if "featuresDict" in content:
            content = content["featuresDict"]
        if "features" in content:
            content = content["features"]
        if "featuresDict" in content:
            content = content["featuresDict"].get("features", {})
        if not isinstance(content, dict):
            content = {}
        for key, spec in content.items():
            kind = json.dumps(spec)
            if "Image" in kind and image_key == "image":
                image_key = key
            if "ClassLabel" in kind:
                label_key = key
    return files, image_key, label_key


def tfds_dataset(data_dir: str, *, name: Optional[str] = None,
                 split: str = "train", resolution: int = 0,
                 batch_size: int = 128,
                 uniform_dequantization: bool = False,
                 centered: bool = False, random_flip: bool = False,
                 shuffle: bool = True, repeat: bool = True, seed: int = 0,
                 transform: Optional[str] = None, with_labels: bool = False):
    """Read a prepared tensorflow_datasets directory WITHOUT the tfds
    package (zero-egress twin of the reference's `tfds.builder(...)` +
    `as_dataset` path, score_sde_jax/datasets.py:103-199): locates the
    version dir, parses dataset_info.json / features.json, decodes the
    encoded-image Example records, and applies the same preprocessing
    surface as the other pipelines here (`transform` selects the
    dataset-specific geometry twin, e.g. 'celeba_scoresde' / 'lsun').
    Order, flips and dequantization come from `np.random.default_rng(seed)`;
    a record without the label reads -1, as TF's default."""
    from dpm_solver_tpu_torch import native

    files, image_key, label_key = _tfds_locate(data_dir, name, split)
    if with_labels and label_key is None:
        raise ValueError("with_labels=True but no ClassLabel feature "
                         "detected in features.json")
    fn = _transform_fn(transform)
    index, blobs = _record_index(files)
    rng = np.random.default_rng(seed)
    order = (lambda: rng.permutation(len(index))) if shuffle else None

    def load(i):
        pi, off, length = index[i]
        rec = bytes(blobs[pi][off:off + length])
        img = _decode_image(native.example_bytes(rec, image_key))
        if fn is not None:
            img = np.clip(fn(img, resolution), 0.0, 1.0)
        else:
            img = img.astype(np.float32) * _U8_SCALE
            if resolution:
                img = _resize_hwc(img, (resolution, resolution), "bilinear")
        label = -1
        if label_key:
            try:
                label = native.example_int64(rec, label_key)
            except KeyError:
                pass
        return img, label

    def gen():
        with ThreadPoolExecutor() as pool:
            for idx in _index_batches(len(index), batch_size, order, repeat):
                imgs, labels = zip(*pool.map(load, idx))
                batch = _flip_dequantize(np.stack(imgs), rng, random_flip, uniform_dequantization)
                if centered:
                    batch = batch * 2.0 - 1.0
                if with_labels and label_key:
                    yield {"image": batch, "label": np.asarray(labels, np.int64)}
                else:
                    yield batch

    return prefetch_iterator(gen())
