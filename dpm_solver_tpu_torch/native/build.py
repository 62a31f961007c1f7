"""Build the host-IO runtime's C++ libraries with g++ at first use.

Four libraries, each from its own source in this directory, bound through
ctypes over a plain C interface:

- "io" (`io.cpp`): TFRecord indexing and the tf.train.Example walker; no
  header outside the C++ standard library and POSIX;
- "png" (`png.cpp`): the PNG codec, on zlib;
- "jpeg" (`jpeg.cpp`): the JPEG decoder, on libjpeg;
- "lmdb_walk" (`lmdb_walk.cpp`): the LMDB B+tree walker.

A library builds the first time it is needed, into
`dpm_solver_tpu_torch/_build/native/` (listed in `.gitignore`), under a name
keyed by a hash of its sources, the shared header and the g++ command; a
later call with the same sources loads the cached file. Each build compiles
to a temporary name of its own (`tempfile.mkstemp` in the target
directory) and then renames it into place, so processes that build at once
never load a partial file. A missing g++ or a failed build raises with
g++'s output: there is no fallback.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
BUILD_ROOT = HERE.parent / "_build"
FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17", "-pthread")
# name -> (sources, link flags)
LIBRARIES = {
    "io": (("io.cpp",), ()),
    "png": (("png.cpp",), ("-lz",)),
    "jpeg": (("jpeg.cpp",), ("-ljpeg",)),
    "lmdb_walk": (("lmdb_walk.cpp",), ()),
}


def find_gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host-IO libraries of dpm_solver_tpu_torch are "
                           "built from source at first use")
    return gxx


def _command(name: str, gxx: str, out: str) -> list:
    sources, libs = LIBRARIES[name]
    return [gxx, *FLAGS, *(str(HERE / s) for s in sources), "-o", out, *libs]


def build(name: str) -> Path:
    """Compile library `name` unless its cached file exists; return its path."""
    gxx = find_gxx()
    h = hashlib.sha256(" ".join(_command(name, gxx, "")).encode())
    for src in sorted((*LIBRARIES[name][0], *(p.name for p in HERE.glob("*.h")))):
        h.update(src.encode())
        h.update((HERE / src).read_bytes())
    lib = Path(BUILD_ROOT) / "native" / f"lib{name}-{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f"lib{name}-", suffix=".tmp", dir=lib.parent)
    os.close(fd)
    cmd = _command(name, gxx, tmp)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed ({proc.returncode}) building the {name!r} host-IO "
                           f"library:\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build never loads a partial file
    return lib


if __name__ == "__main__":
    for lib_name in LIBRARIES:
        print(build(lib_name))
