"""ctypes binding for the native LMDB B+tree walker.

Port of `dpm_solver_tpu/utils/lmdb_native.py`. `native/build.py` compiles
`native/lmdb_walk.cpp` with g++ at first use, into the port's build
directory; a failed build raises with g++'s output. `entry_table` is one C
pass over the mmap that returns every record's (key_off, key_len, val_off,
val_len); `utils/lmdb.py` serves zero-copy iteration from it.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from dpm_solver_tpu_torch.native import build as _build

_ERRORS = {
    -2: "B+tree too deep (cycle?)",
    -3: "corrupt page or truncated file",
    -4: "unexpected page flags",
    -5: "entry table capacity exceeded",
}


@functools.cache
def load_library() -> ctypes.CDLL:
    """The walker, compiled on first call."""
    lib = ctypes.CDLL(str(_build.build("lmdb_walk")))
    lib.lmdb_walk.restype = ctypes.c_longlong
    lib.lmdb_walk.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
                              ctypes.c_uint64, ctypes.c_void_p, ctypes.c_longlong]
    return lib


def entry_table(buf, psize: int, root: int, entries: int) -> np.ndarray:
    """(entries, 4) uint64 table of (key_off, key_len, val_off, val_len) in
    key order. Raises ValueError on a corrupt file (the same condition the
    Python walk raises on)."""
    arr = np.frombuffer(buf, dtype=np.uint8)
    out = np.empty((max(entries, 1), 4), dtype=np.uint64)
    n = load_library().lmdb_walk(arr.ctypes.data_as(ctypes.c_void_p), arr.size, psize, root,
                                 out.ctypes.data_as(ctypes.c_void_p), out.shape[0])
    if n < 0:
        raise ValueError(f"lmdb_walk: {_ERRORS.get(int(n), f'error {n}')}")
    return out[: int(n)]
