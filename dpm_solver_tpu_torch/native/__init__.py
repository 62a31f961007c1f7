"""ctypes bindings for the port's host-IO runtime (C++, built by g++).

Port of `dpm_solver_tpu/native`. The reference's host data plane is
native: tf.data's C++ runtime decodes TFRecords (score_sde_jax/
datasets.py:103-199) and its FID protocol shuttles 50k PNGs per eval
through the runner (runners/diffusion.py:450-457, evaluate/fid_score.py:
146-170). This package is the port's equivalent, in three libraries that
`build.py` compiles at first use: the core (`io.cpp`: the TFRecord index,
CRC32C and the Example walker), the PNG codec (`png.cpp`, on zlib) and the
JPEG decoder (`jpeg.cpp`, on libjpeg). A call whose library does not build
raises with g++'s output; nothing falls back to PIL or to Python. The
pure-Python twins of the TFRecord and Example parsers (`_tfrecord_index_py`,
`_example_bytes_py`, `_example_int64_py` and the wire-format walk beneath
them) are the plain versions the tests hold the C++ to; `data.py` reads
int64 lists through the walk.

Public surface:
  write_png_batch(images, paths)    -> None        (uint8 NHWC batch)
  read_png_batch(paths)             -> uint8 NHWC  (uniform-size folder)
  png_probe(path)                   -> (h, w, c)
  image_probe_mem(data)             -> (h, w, c, kind)   PNG or JPEG bytes
  decode_image_batch(payloads, h, w, c) -> uint8 NHWC
  tfrecord_index(path)              -> (offsets, lengths) int64 arrays
  example_bytes(buf, key, idx=0)    -> memoryview of the feature bytes
  example_int64(buf, key)           -> int
  crc32c(data)                      -> int  (unmasked)
"""

from __future__ import annotations

import ctypes
import functools
import os
import struct
from typing import Optional, Sequence, Tuple

import numpy as np

from dpm_solver_tpu_torch.native import build as _build

_I64 = ctypes.c_int64
_I64P = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_CCP = ctypes.POINTER(ctypes.c_char_p)
_INT = ctypes.c_int
# library -> entry -> (restype, argtypes)
_SIGNATURES = {
    "io": {
        "dpm_tfrecord_index": (_I64, [ctypes.c_char_p, _I64P, _I64P, _I64, _INT]),
        "dpm_example_find_bytes": (_INT, [_U8P, _I64, ctypes.c_char_p, _I64, _I64P, _I64P]),
        "dpm_example_find_int64": (_INT, [_U8P, _I64, ctypes.c_char_p, _I64P]),
        "dpm_crc32c": (ctypes.c_uint32, [_U8P, _I64]),
    },
    "png": {
        "dpm_png_write_batch": (_INT, [_U8P, _I64, _I64, _I64, _I64, _CCP, _INT]),
        "dpm_png_probe": (_INT, [ctypes.c_char_p, _I64P, _I64P, _I64P]),
        "dpm_png_read_batch": (_INT, [_CCP, _I64, _U8P, _I64, _I64, _I64, _INT]),
        "dpm_png_probe_mem": (_INT, [_U8P, _I64, _I64P, _I64P, _I64P]),
        "dpm_png_decode_mem_batch": (_INT, [_U8P, _I64P, _I64P, _I64, _U8P, _I64, _I64, _I64,
                                            _INT]),
    },
    "jpeg": {
        "dpm_jpeg_probe_mem": (_INT, [_U8P, _I64, _I64P, _I64P, _I64P]),
        "dpm_jpeg_decode_mem_batch": (_INT, [_U8P, _I64P, _I64P, _I64, _U8P, _I64, _I64, _I64,
                                             _INT]),
    },
}
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """Host-IO library `name` ("io", "png" or "jpeg"), built at first use."""
    lib = ctypes.CDLL(str(_build.build(name)))
    for entry, (restype, argtypes) in _SIGNATURES[name].items():
        fn = getattr(lib, entry)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def _default_threads() -> int:
    return min(16, os.cpu_count() or 1)


def _paths_array(paths: Sequence[str]):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [p.encode() for p in paths]
    return arr


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


def image_kind(data) -> str:
    """"png", "jpeg" or "unknown", from an encoded image's first bytes."""
    head = bytes(data[:8])
    if head == PNG_SIGNATURE:
        return "png"
    return "jpeg" if head[:2] == b"\xff\xd8" else "unknown"


# ------------------------------------------------------------------ PNG


def write_png_batch(images: np.ndarray, paths: Sequence[str],
                    threads: Optional[int] = None) -> None:
    """uint8 (N,H,W,C) or (N,H,W) batch -> one PNG per path, parallel encode."""
    images = np.ascontiguousarray(images)
    if images.ndim == 3:
        images = images[..., None]
    if images.dtype != np.uint8:
        raise ValueError(f"expected uint8, got {images.dtype}")
    n, h, w, c = images.shape
    if len(paths) != n:
        raise ValueError(f"{n} images but {len(paths)} paths")
    fails = library("png").dpm_png_write_batch(_u8ptr(images), n, h, w, c,
                                               _paths_array(paths), threads or _default_threads())
    if fails:
        raise IOError(f"png write failed for {fails}/{n} images")


def png_probe(path: str) -> Tuple[int, int, int]:
    h, w, c = _I64(), _I64(), _I64()
    if library("png").dpm_png_probe(path.encode(), ctypes.byref(h), ctypes.byref(w),
                                    ctypes.byref(c)):
        raise IOError(f"cannot probe {path}")
    return h.value, w.value, c.value


def read_png_batch(paths: Sequence[str], channels: Optional[int] = None,
                   threads: Optional[int] = None) -> np.ndarray:
    """Decode a uniform-size PNG folder slice into a uint8 (N,H,W,C) batch
    (grayscale sources are expanded / RGB collapsed to match `channels`)."""
    if not paths:
        return np.zeros((0, 0, 0, 0), np.uint8)
    h, w, c0 = png_probe(paths[0])
    c = channels or c0
    out = np.empty((len(paths), h, w, c), np.uint8)
    fails = library("png").dpm_png_read_batch(_paths_array(paths), len(paths), _u8ptr(out),
                                              h, w, c, threads or _default_threads())
    if fails:
        raise IOError(f"png read failed for {fails}/{len(paths)} files "
                      f"(mixed sizes? first file is {h}x{w})")
    return out


# ------------------------------------------------ in-memory PNG / JPEG


def image_probe_mem(data) -> Tuple[int, int, int, str]:
    """(h, w, c, kind) of an in-memory encoded PNG/JPEG payload."""
    kind = image_kind(data)
    if kind == "unknown":
        raise IOError("cannot probe encoded image")
    arr = np.frombuffer(data, np.uint8)
    h, w, c = _I64(), _I64(), _I64()
    probe = (library("png").dpm_png_probe_mem if kind == "png"
             else library("jpeg").dpm_jpeg_probe_mem)
    if probe(_u8ptr(arr), arr.size, ctypes.byref(h), ctypes.byref(w), ctypes.byref(c)):
        raise IOError("cannot probe encoded image")
    return h.value, w.value, c.value, kind


def decode_image_batch(payloads: Sequence[bytes], h: int, w: int, c: int,
                       threads: Optional[int] = None) -> np.ndarray:
    """Decode in-memory PNG/JPEG payloads (all HxW, normalized to c
    channels) into a uint8 (N,H,W,C) batch on a thread pool — the native
    twin of tf.image.decode_image in the reference's input pipeline
    (score_sde_jax/datasets.py:139). JPEG sources require c in {1, 3}."""
    n = len(payloads)
    out = np.empty((n, h, w, c), np.uint8)
    kinds = [image_kind(p) for p in payloads]
    fails = kinds.count("unknown")
    for kind, entry in (("png", "dpm_png_decode_mem_batch"), ("jpeg", "dpm_jpeg_decode_mem_batch")):
        idx = [i for i, k in enumerate(kinds) if k == kind]
        if not idx:
            continue
        lens = np.asarray([len(payloads[i]) for i in idx], np.int64)
        offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
        blob = np.frombuffer(b"".join(bytes(payloads[i]) for i in idx), np.uint8)
        part = out if len(idx) == n else np.empty((len(idx), h, w, c), np.uint8)
        fails += getattr(library(kind), entry)(
            _u8ptr(blob), offs.ctypes.data_as(_I64P), lens.ctypes.data_as(_I64P), len(idx),
            _u8ptr(part), h, w, c, threads or _default_threads())
        if part is not out:
            out[idx] = part
    if fails:
        raise IOError(f"in-memory decode failed for {fails}/{n} payloads "
                      f"(mixed sizes, JPEG with c not in {{1,3}}, or a colour PNG "
                      "carrying gAMA/sRGB/cHRM/iCCP asked for gray?)")
    return out


# ------------------------------------------------------------- TFRecord


def tfrecord_index(path: str, check_crc: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Payload (offsets, lengths) of every record in a TFRecord file,
    CRC32C-verified. Raises on framing/CRC corruption with the byte
    position."""
    size = os.path.getsize(path)
    cap = max(1, size // 16)  # every record costs >= 16 framing+payload bytes
    offsets = np.empty(cap, np.int64)
    lengths = np.empty(cap, np.int64)
    n = library("io").dpm_tfrecord_index(path.encode(), offsets.ctypes.data_as(_I64P),
                                         lengths.ctypes.data_as(_I64P), cap,
                                         1 if check_crc else 0)
    if n < 0:
        raise IOError(f"corrupt TFRecord {path} at byte {-n - 1}")
    return offsets[:n].copy(), lengths[:n].copy()


def example_bytes(buf, key: str, idx: int = 0) -> memoryview:
    """The idx-th bytes value of feature `key` in a serialized
    tf.train.Example (zero-copy view into `buf`)."""
    data = np.frombuffer(buf, np.uint8)
    off, blen = _I64(), _I64()
    if library("io").dpm_example_find_bytes(_u8ptr(data), data.size, key.encode(), idx,
                                            ctypes.byref(off), ctypes.byref(blen)):
        raise KeyError(f"no bytes feature {key!r}[{idx}] in Example")
    return memoryview(buf)[off.value:off.value + blen.value]


def example_int64(buf, key: str) -> int:
    data = np.frombuffer(buf, np.uint8)
    val = _I64()
    if library("io").dpm_example_find_int64(_u8ptr(data), data.size, key.encode(),
                                            ctypes.byref(val)):
        raise KeyError(f"no int64 feature {key!r} in Example")
    return val.value


def crc32c(data: bytes) -> int:
    arr = np.frombuffer(data, np.uint8)
    return int(library("io").dpm_crc32c(_u8ptr(arr), arr.size))


# -------------------------------- the plain Python twins of the core's parsers


def _tfrecord_index_py(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """The framing walk of `tfrecord_index`, without the CRC checks."""
    offsets, lengths = [], []
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        pos = 0
        while pos < size:
            header = f.read(12)
            if len(header) < 12:
                raise IOError(f"corrupt TFRecord {path} at byte {pos}")
            (length,) = struct.unpack("<Q", header[:8])
            offsets.append(pos + 12)
            lengths.append(length)
            f.seek(length + 4, os.SEEK_CUR)
            pos += 12 + length + 4
    return np.asarray(offsets, np.int64), np.asarray(lengths, np.int64)


def _varint(b: bytes, i: int) -> Tuple[int, int]:
    v, shift = 0, 0
    while True:
        byte = b[i]
        v |= (byte & 0x7F) << shift
        i += 1
        if not byte & 0x80:
            return v, i
        shift += 7


def _walk_fields(b: bytes, start: int, end: int):
    i = start
    while i < end:
        tag, i = _varint(b, i)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            v, i = _varint(b, i)
            yield field, wire, v, None, None
        elif wire == 2:
            n, i = _varint(b, i)
            yield field, wire, None, i, i + n
            i += n
        elif wire == 1:
            i += 8
            yield field, wire, None, None, None
        elif wire == 5:
            i += 4
            yield field, wire, None, None, None
        else:
            raise ValueError(f"bad wire type {wire}")


def _find_feature_py(b: bytes, key: str):
    kb = key.encode()
    for f, wire, _, s, e in _walk_fields(b, 0, len(b)):
        if f == 1 and wire == 2:
            for ff, fw, _, es, ee in _walk_fields(b, s, e):
                if ff == 1 and fw == 2:
                    ks = vs = None
                    for ef, ew, _, ps, pe in _walk_fields(b, es, ee):
                        if ef == 1 and ew == 2:
                            ks = b[ps:pe]
                        elif ef == 2 and ew == 2:
                            vs = (ps, pe)
                    if ks == kb and vs:
                        return vs
    return None


def _example_bytes_py(b: bytes, key: str, idx: int) -> memoryview:
    span = _find_feature_py(b, key)
    if span:
        for f, wire, _, s, e in _walk_fields(b, *span):
            if f == 1 and wire == 2:  # BytesList
                seen = 0
                for lf, lw, _, bs, be in _walk_fields(b, s, e):
                    if lf == 1 and lw == 2:
                        if seen == idx:
                            return memoryview(b)[bs:be]
                        seen += 1
    raise KeyError(f"no bytes feature {key!r}[{idx}] in Example")


def _example_int64_py(b: bytes, key: str) -> int:
    span = _find_feature_py(b, key)
    if span:
        for f, wire, _, s, e in _walk_fields(b, *span):
            if f == 3 and wire == 2:  # Int64List
                for lf, lw, v, bs, be in _walk_fields(b, s, e):
                    if lf == 1 and lw == 0:
                        return v
                    if lf == 1 and lw == 2:  # packed
                        val, _ = _varint(b, bs)
                        return val
    raise KeyError(f"no int64 feature {key!r} in Example")
