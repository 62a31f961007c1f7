"""The port's host-IO runtime (dpm_solver_tpu_torch/native) on the CPU.

- The 13 cases of tests/test_native_io.py on the port's own libraries (the
  core, `io.cpp`; the PNG codec on zlib, `png.cpp`; the JPEG decoder on
  libjpeg, `jpeg.cpp`), the FID folder case through the port's
  `compute_statistics_of_path`.
- The port against the JAX package's native output on the same inputs: the
  same TFRecord offsets and lengths, the same Example bytes and ints, PNGs
  that each side reads back equal, and the port's PNG decoder against
  libpng (the JAX package's reader) over every colour type and bit depth,
  with and without tRNS and Adam7 interlacing, at each channel count asked:
  equal bytes (and equal refusals). A colour PNG carrying colorimetry asked
  for gray, which libpng linearises, the port refuses.
- The pure-Python twins (`_tfrecord_index_py`, `_example_*_py`) equal the
  C++ parsers.
- Builds: two processes building into one fresh directory at once both
  load; a missing or failing compiler, and a missing header, raise with
  the compiler's message; nothing falls back.
"""

import io
import itertools
import os
import shutil
import struct
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np
import pytest

from dpm_solver_tpu_torch import native
from dpm_solver_tpu_torch.native import build as nbuild


@pytest.fixture(scope="module")
def jax_native():
    """The JAX package's native library. Its first build writes one shared
    temporary file, so a test worker that raced another to it may have
    marked it unavailable though the finished library is on disk: look
    again for up to a minute."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from dpm_solver_tpu import native as jn

    for _ in range(120):
        if jn.available():
            return jn
        jn._load_failed = False
        time.sleep(0.5)
    pytest.fail("the JAX package's native library does not load")


def _mask(c):
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _write_tfrecord(path, payloads):
    """TFRecord framing by hand, with the port's CRC32C."""
    with open(path, "wb") as f:
        for p in payloads:
            header = struct.pack("<Q", len(p))
            f.write(header + struct.pack("<I", _mask(native.crc32c(header))))
            f.write(p + struct.pack("<I", _mask(native.crc32c(p))))


def _ld(field, payload):
    """A length-delimited protobuf field (varint length)."""
    out = bytes([field << 3 | 2])
    n = len(payload)
    while True:
        b = n & 0x7F
        n >>= 7
        out += bytes([b | (0x80 if n else 0)])
        if not n:
            return out + payload


def _example(image_bytes, label, key=b"image"):
    """A serialized tf.train.Example {key: bytes, 'label': int64}."""
    img_feat = _ld(1, _ld(1, image_bytes))
    lbl_feat = _ld(3, bytes([1 << 3 | 0, label]))
    return _ld(1, _ld(1, _ld(1, key) + _ld(2, img_feat)) + _ld(1, _ld(1, b"label") + _ld(2, lbl_feat)))


def _raw_example(img_chw):
    """{'shape': Int64List[C, H, W] (packed), 'data': CHW bytes}: FFHQ's layout."""
    shape = b"".join(bytes([v]) if v < 128 else bytes([v & 0x7F | 0x80, v >> 7])
                     for v in img_chw.shape)
    shape_feat = _ld(3, _ld(1, shape))
    data_feat = _ld(1, _ld(1, img_chw.tobytes()))
    return _ld(1, _ld(1, _ld(1, b"data") + _ld(2, data_feat))
               + _ld(1, _ld(1, b"shape") + _ld(2, shape_feat)))


# ------------------------------------------- PNG files of every kind, by hand


def _chunk(kind, data):
    return struct.pack(">I", len(data)) + kind + data + struct.pack(
        ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


ADAM7 = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2)]
SOURCE_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# (colour type, bit depth): every combination the PNG format allows
FORMATS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
           (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


def _pack_row(row, depth):
    if depth == 8:
        return bytes(np.asarray(row, np.uint8))
    if depth == 16:
        return np.asarray(row, ">u2").tobytes()
    bits = "".join(format(int(v), f"0{depth}b") for v in row)
    bits += "0" * (-len(bits) % 8)
    return bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))


def _filter_row(row, prior, kind, bpp):
    """One scanline under filter `kind` (None, Sub, Up, Average, Paeth)."""
    out = bytearray(len(row))
    for i, x in enumerate(row):
        a = row[i - bpp] if i >= bpp else 0
        b = prior[i] if prior is not None else 0
        c = prior[i - bpp] if prior is not None and i >= bpp else 0
        p = a + b - c
        paeth = a if abs(p - a) <= abs(p - b) and abs(p - a) <= abs(p - c) else \
            b if abs(p - b) <= abs(p - c) else c
        out[i] = (x - [0, a, b, (a + b) >> 1, paeth][kind]) & 0xFF
    return bytes([kind]) + bytes(out)


def png_bytes(samples, color, depth, rng, interlace=False, plte=None, trns=None, extra=b""):
    """A PNG of `samples` (H, W, source channels) with random row filters,
    optionally Adam7-interlaced, its IDAT split in two chunks."""
    bpp = max(1, SOURCE_CHANNELS[color] * depth // 8)
    data = b""
    for x0, y0, dx, dy in (ADAM7 if interlace else [(0, 0, 1, 1)]):
        sub = samples[y0::dy, x0::dx]
        prior = None
        for r in sub.reshape(sub.shape[0], -1) if sub.size else ():
            row = _pack_row(r, depth)
            data += _filter_row(row, prior, int(rng.integers(0, 5)), bpp)
            prior = row
    h, w = samples.shape[:2]
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color,
                                                              0, 0, int(interlace))) + extra
    if plte is not None:
        out += _chunk(b"PLTE", plte)
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    z = zlib.compress(data, 6)
    return out + _chunk(b"IDAT", z[:len(z) // 2]) + _chunk(b"IDAT", z[len(z) // 2:]) \
        + _chunk(b"IEND", b"")


def _random_png(color, depth, interlace, use_trns, rng):
    h, w = int(rng.integers(1, 20)), int(rng.integers(1, 20))
    plte = trns = None
    if color == 3:
        n = int(rng.integers(1, 2 ** depth + 1))
        samples = rng.integers(0, n, (h, w, 1))
        plte = rng.integers(0, 256, 3 * n).astype(np.uint8).tobytes()
        if use_trns:
            trns = rng.integers(0, 256, int(rng.integers(1, n + 1))).astype(np.uint8).tobytes()
    else:
        samples = rng.integers(0, 2 ** depth, (h, w, SOURCE_CHANNELS[color]))
        if color in (2, 6):   # some gray pixels, which RGB -> gray passes through
            gray = rng.random((h, w)) < 0.3
            samples[gray, 1] = samples[gray, 2] = samples[gray, 0]
        if use_trns and color in (0, 2):
            trns = np.asarray(samples[0, 0], ">u2").tobytes()
    return png_bytes(samples, color, depth, rng, interlace, plte, trns), h, w


def _decode_or_error(lib, payload, h, w, c):
    try:
        return lib.decode_image_batch([payload], h, w, c)
    except IOError:
        return "refused"


# ------------------------------------------------ tests/test_native_io.py's 13


def test_crc32c_known_answer():
    # RFC 3720 / Castagnoli check value
    assert native.crc32c(b"123456789") == 0xE3069283
    assert native.crc32c(b"") == 0


@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_png_roundtrip_rgb_and_gray(c, tmp_path):
    rng = np.random.default_rng(c)
    imgs = rng.integers(0, 256, size=(5, 23, 31, c), dtype=np.uint8)
    paths = [str(tmp_path / f"im_{c}_{i}.png") for i in range(5)]
    native.write_png_batch(imgs, paths)
    assert native.png_probe(paths[0]) == (23, 31, c)
    np.testing.assert_array_equal(native.read_png_batch(paths), imgs)


def test_png_matches_pil_both_directions(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, size=(16, 20, 3), dtype=np.uint8)
    ours = str(tmp_path / "ours.png")
    native.write_png_batch(img[None], [ours])
    np.testing.assert_array_equal(np.asarray(Image.open(ours)), img)
    theirs = str(tmp_path / "pil.png")
    Image.fromarray(img).save(theirs)
    np.testing.assert_array_equal(native.read_png_batch([theirs])[0], img)


def test_png_read_channel_conversion(tmp_path):
    """Gray source read as RGB (the FID folder reader requests channels=3)."""
    gray = np.arange(64, dtype=np.uint8).reshape(1, 8, 8, 1)
    p = str(tmp_path / "g.png")
    native.write_png_batch(gray, [p])
    rgb = native.read_png_batch([p], channels=3)
    assert rgb.shape == (1, 8, 8, 3)
    np.testing.assert_array_equal(rgb, np.repeat(gray, 3, axis=-1))


def test_png_write_3d_batch(tmp_path):
    imgs = np.random.default_rng(2).integers(0, 256, size=(3, 9, 9), dtype=np.uint8)
    paths = [str(tmp_path / f"g{i}.png") for i in range(3)]
    native.write_png_batch(imgs, paths)  # (N,H,W) -> grayscale
    np.testing.assert_array_equal(native.read_png_batch(paths)[..., 0], imgs)


def test_decode_image_batch_png_and_jpeg():
    """In-memory batch decode: PNG bit-exact round trip; JPEG equal to PIL's
    decode of the same payload (the same libjpeg underneath)."""
    from PIL import Image

    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, size=(4, 12, 14, 3), dtype=np.uint8)
    png_payloads = []
    for im in imgs:
        buf = io.BytesIO()
        Image.fromarray(im).save(buf, format="PNG")
        png_payloads.append(buf.getvalue())
    assert native.image_probe_mem(png_payloads[0]) == (12, 14, 3, "png")
    np.testing.assert_array_equal(native.decode_image_batch(png_payloads, 12, 14, 3), imgs)

    jpg = io.BytesIO()
    Image.fromarray(imgs[0]).save(jpg, format="JPEG", quality=90)
    payload = jpg.getvalue()
    assert native.image_probe_mem(payload) == (12, 14, 3, "jpeg")
    ours = native.decode_image_batch([payload], 12, 14, 3)[0]
    np.testing.assert_array_equal(ours, np.asarray(Image.open(io.BytesIO(payload)).convert("RGB")))
    # a batch of both kinds keeps its order
    both = native.decode_image_batch([png_payloads[1], payload, png_payloads[2]], 12, 14, 3)
    np.testing.assert_array_equal(both, np.stack([imgs[1], ours, imgs[2]]))
    with pytest.raises(IOError):
        native.decode_image_batch([b"not an image"], 4, 4, 3)


def test_tfrecord_index_and_example_walk(tmp_path):
    rng = np.random.default_rng(3)
    raws = [rng.integers(0, 256, rng.integers(5, 200), dtype=np.uint8).tobytes()
            for _ in range(7)]
    payloads = [_example(raw, i) for i, raw in enumerate(raws)]
    p = str(tmp_path / "t.tfrecord")
    _write_tfrecord(p, payloads)
    offs, lens = native.tfrecord_index(p)
    assert len(offs) == 7
    blob = open(p, "rb").read()
    for i, (o, n) in enumerate(zip(offs, lens)):
        rec = blob[o:o + n]
        assert rec == payloads[i]
        assert bytes(native.example_bytes(rec, "image")) == raws[i]
        assert native.example_int64(rec, "label") == i
        # the pure-Python twins agree
        assert bytes(native._example_bytes_py(rec, "image", 0)) == raws[i]
        assert native._example_int64_py(rec, "label") == i
    o2, l2 = native._tfrecord_index_py(p)
    np.testing.assert_array_equal(o2, offs)
    np.testing.assert_array_equal(l2, lens)


def test_tfrecord_corruption_detected(tmp_path):
    p = str(tmp_path / "c.tfrecord")
    _write_tfrecord(p, [_example(b"abc", 0), _example(b"defg", 1)])
    blob = bytearray(open(p, "rb").read())
    offs, _ = native.tfrecord_index(p)
    blob[offs[1] + 1] ^= 0xFF  # flip a payload byte of record 2
    bad = str(tmp_path / "bad.tfrecord")
    open(bad, "wb").write(bytes(blob))
    with pytest.raises(IOError, match="corrupt"):
        native.tfrecord_index(bad)
    # unverified mode still indexes (framing intact)
    assert len(native.tfrecord_index(bad, check_crc=False)[0]) == 2


def test_example_missing_key_raises():
    rec = _example(b"xy", 4)
    with pytest.raises(KeyError):
        native.example_bytes(rec, "nope")
    with pytest.raises(KeyError):
        native.example_int64(rec, "image")  # bytes feature, not int64


def test_tfrecord_dataset_native_raw_format(tmp_path):
    """FFHQ-style pipeline: raw CHW records -> model-space batches,
    determinism by seed."""
    from dpm_solver_tpu_torch.data import tfrecord_dataset_native

    rng = np.random.default_rng(5)
    imgs = [rng.integers(0, 256, size=(3, 8, 8), dtype=np.uint8) for _ in range(6)]
    p = str(tmp_path / "ffhq.tfrecord")
    _write_tfrecord(p, [_raw_example(im) for im in imgs])
    batches = list(tfrecord_dataset_native(p, resolution=0, batch_size=3, centered=True,
                                           shuffle=False, repeat=False))
    assert len(batches) == 2 and batches[0].shape == (3, 8, 8, 3)
    want = np.transpose(imgs[0], (1, 2, 0)).astype(np.float32) / 255.0
    np.testing.assert_allclose(batches[0][0], want * 2.0 - 1.0, atol=1e-6)
    a, b = (next(iter(tfrecord_dataset_native(p, resolution=0, batch_size=6, seed=7)))
            for _ in range(2))
    np.testing.assert_array_equal(a, b)


def test_tfrecord_dataset_native_encoded_format(tmp_path):
    """Prepared-TFDS-style records: encoded PNG + label -> dict batches."""
    from dpm_solver_tpu_torch.data import tfrecord_dataset_native

    imgs = np.random.default_rng(6).integers(0, 256, size=(4, 10, 10, 3), dtype=np.uint8)
    png_paths = [str(tmp_path / f"e{i}.png") for i in range(4)]
    native.write_png_batch(imgs, png_paths)
    p = str(tmp_path / "tfds.tfrecord")
    _write_tfrecord(p, [_example(open(pp, "rb").read(), i) for i, pp in enumerate(png_paths)])
    batch = next(iter(tfrecord_dataset_native(p, resolution=0, batch_size=2, image_key="image",
                                              shape_key=None, label_key="label",
                                              shuffle=False, repeat=False)))
    assert set(batch) == {"image", "label"}
    np.testing.assert_allclose(batch["image"][0], imgs[0].astype(np.float32) / 255.0, atol=1e-6)
    np.testing.assert_array_equal(batch["label"], [0, 1])


def test_prefetch_iterator_propagates_and_preserves_order():
    from dpm_solver_tpu_torch.data import prefetch_iterator

    assert list(prefetch_iterator(iter(range(10)))) == list(range(10))

    def boom():
        yield 1
        raise RuntimeError("worker failed")

    it = prefetch_iterator(boom())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="worker failed"):
        list(it)


def test_save_images_and_fid_folder_path(tmp_path):
    """Samples quantised as the JAX CLI's `_save_images` does, written by the
    native encoder and read by the FID folder route through the native
    reader: pixel-exact, and the statistics those pixels give."""
    from dpm_solver_tpu_torch.eval.fid import compute_statistics_of_path

    arr = np.random.default_rng(9).random((6, 8, 8, 3)).astype(np.float32)
    out = tmp_path / "samples"
    out.mkdir()
    native.write_png_batch((arr * 255).clip(0, 255).astype(np.uint8),
                           [str(out / f"s_{i:05d}.png") for i in range(6)])
    files = sorted(f for f in os.listdir(out) if f.endswith(".png"))
    back = native.read_png_batch([str(out / f) for f in files])
    np.testing.assert_array_equal(back, (arr * 255).clip(0, 255).astype(np.uint8))
    mu, sigma = compute_statistics_of_path(
        str(out), lambda b: (b.reshape(len(b), -1), None), batch_size=4)
    flat = (back.astype(np.float32) / 255.0).reshape(6, -1)
    np.testing.assert_allclose(mu, flat.mean(0), atol=1e-6)
    np.testing.assert_allclose(sigma, np.cov(flat.astype(np.float64), rowvar=False), atol=1e-6)


# ----------------------------------------- the port against the JAX package


def test_tfrecord_index_and_walk_match_jax(jax_native, tmp_path):
    """The same offsets, lengths, Example bytes and ints as the JAX
    package's native core, raw-tensor and encoded layouts in one file."""
    rng = np.random.default_rng(10)
    payloads = [_example(rng.integers(0, 256, rng.integers(1, 3000), dtype=np.uint8).tobytes(),
                         i) for i in range(9)]
    payloads += [_raw_example(rng.integers(0, 256, (3, 5, 7), dtype=np.uint8))
                 for _ in range(4)]
    p = str(tmp_path / "mixed.tfrecord")
    _write_tfrecord(p, payloads)
    for mine, theirs in zip(native.tfrecord_index(p), jax_native.tfrecord_index(p)):
        np.testing.assert_array_equal(mine, theirs)
    assert native.crc32c(open(p, "rb").read()) == jax_native.crc32c(open(p, "rb").read())
    for rec in payloads[:9]:
        assert bytes(native.example_bytes(rec, "image")) == bytes(
            jax_native.example_bytes(rec, "image"))
        assert native.example_int64(rec, "label") == jax_native.example_int64(rec, "label")
    for rec in payloads[9:]:
        assert bytes(native.example_bytes(rec, "data")) == bytes(
            jax_native.example_bytes(rec, "data"))
        assert native.example_int64(rec, "shape") == jax_native.example_int64(rec, "shape")


@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_png_files_read_back_equal_across_packages(jax_native, c, tmp_path):
    """PNGs the port writes, libpng reads back equal (and the reverse), at
    every channel count, every channel count asked."""
    imgs = np.random.default_rng(11 + c).integers(0, 256, size=(3, 17, 29, c), dtype=np.uint8)
    mine = [str(tmp_path / f"p{i}.png") for i in range(3)]
    theirs = [str(tmp_path / f"j{i}.png") for i in range(3)]
    native.write_png_batch(imgs, mine)
    jax_native.write_png_batch(imgs, theirs)
    for paths in (mine, theirs):
        assert native.png_probe(paths[0]) == jax_native.png_probe(paths[0]) == (17, 29, c)
        for asked in (None, 1, 2, 3, 4):
            np.testing.assert_array_equal(native.read_png_batch(paths, channels=asked),
                                          jax_native.read_png_batch(paths, channels=asked))
    np.testing.assert_array_equal(native.read_png_batch(theirs), imgs)


@pytest.mark.parametrize("color,depth", FORMATS, ids=lambda v: str(v))
def test_png_decoder_matches_libpng(jax_native, color, depth):
    """The zlib decoder against libpng under the JAX package's transforms,
    at one colour type and depth: Adam7 or not, tRNS or not, random row
    filters, each channel count asked; equal bytes, or both refuse."""
    rng = np.random.default_rng(100 * color + depth)
    for interlace, use_trns, c in itertools.product((False, True), (False, True), (1, 2, 3, 4)):
        data, h, w = _random_png(color, depth, interlace, use_trns, rng)
        want = _decode_or_error(jax_native, data, h, w, c)
        got = _decode_or_error(native, data, h, w, c)
        assert isinstance(want, str) == isinstance(got, str), (interlace, use_trns, c)
        if not isinstance(want, str):
            np.testing.assert_array_equal(got, want, err_msg=str((interlace, use_trns, c)))
        assert native.image_probe_mem(data) == jax_native.image_probe_mem(data)


def test_png_colorimetry_to_gray_refused(jax_native):
    """With gAMA, libpng's RGB -> gray runs through gamma tables; the port
    refuses that one request, and decodes the same file as RGB equal."""
    rng = np.random.default_rng(12)
    s = rng.integers(0, 256, (5, 6, 3))
    data = png_bytes(s, 2, 8, rng, extra=_chunk(b"gAMA", struct.pack(">I", 45455)))
    np.testing.assert_array_equal(native.decode_image_batch([data], 5, 6, 3),
                                  jax_native.decode_image_batch([data], 5, 6, 3))
    with pytest.raises(IOError, match="gAMA"):
        native.decode_image_batch([data], 5, 6, 1)


def test_png_corrupt_files_refused(jax_native, tmp_path):
    """A wrong chunk CRC, truncated image data, a wrong size: both refuse."""
    rng = np.random.default_rng(13)
    good, h, w = _random_png(2, 8, False, False, rng)
    bad_crc = bytearray(good)
    bad_crc[43] ^= 0x01           # inside the first IDAT's data
    cut = good[:len(good) // 2]
    for data, hh, ww in ((bytes(bad_crc), h, w), (cut, h, w), (good, h + 1, w)):
        for lib in (native, jax_native):
            with pytest.raises(IOError):
                lib.decode_image_batch([data], hh, ww, 3)


# --------------------------------------------------------------- the builds


def test_two_processes_build_into_one_fresh_directory(tmp_path):
    """Two processes build the core and the PNG codec into one empty
    directory at once; each loads what it built and uses it, and only the
    finished libraries are left."""
    code = ("import sys, ctypes; from pathlib import Path; "
            "from dpm_solver_tpu_torch.native import build as b; b.BUILD_ROOT = Path(sys.argv[1]); "
            "io = ctypes.CDLL(str(b.build('io'))); io.dpm_crc32c.restype = ctypes.c_uint32; "
            "assert io.dpm_crc32c(b'123456789', 9) == 0xE3069283; "
            "ctypes.CDLL(str(b.build('png'))).dpm_png_write_batch; print('ok')")
    env = dict(os.environ, PYTHONPATH=str(Path(nbuild.__file__).resolve().parents[2]))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert all(o.strip().endswith("ok") for o in outs)
    left = sorted(f.name for f in (tmp_path / "native").iterdir())
    assert len(left) == 2 and all(f.endswith(".so") for f in left), left


def test_failed_compiler_raises_without_fallback(monkeypatch, tmp_path):
    """No g++, a g++ that fails, a missing header: each build raises with
    what the compiler said, and the binding raises with it (no PIL, no
    Python fallback)."""
    which = shutil.which
    monkeypatch.setattr(nbuild, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(native, "library", native.library.__wrapped__)   # no cached library
    monkeypatch.setattr(nbuild.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g.. not found"):
        nbuild.build("io")
    monkeypatch.setattr(nbuild.shutil, "which", lambda name: "/bin/false")
    with pytest.raises(RuntimeError, match="g.. failed"):
        nbuild.build("png")
    assert not list((tmp_path / "native").iterdir())     # no partial file left
    with pytest.raises(RuntimeError, match="g.. failed"):
        native.write_png_batch(np.zeros((1, 2, 2, 3), np.uint8), [str(tmp_path / "x.png")])
    with pytest.raises(RuntimeError, match="g.. failed"):
        native.tfrecord_index(__file__)
    monkeypatch.setattr(nbuild.shutil, "which", which)
    # a source whose header is missing (the JPEG decoder on a machine
    # without jpeglib.h): g++'s message names it
    src = tmp_path / "src"
    src.mkdir()
    (src / "needs.cpp").write_text("#include <no_such_header_dpm.h>\nint f() { return 0; }\n")
    monkeypatch.setattr(nbuild, "HERE", src)
    monkeypatch.setitem(nbuild.LIBRARIES, "needs", (("needs.cpp",), ()))
    with pytest.raises(RuntimeError, match="no_such_header_dpm.h"):
        nbuild.build("needs")
