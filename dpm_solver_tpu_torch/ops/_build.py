"""Build the package's CUDA sources with nvcc and load them through ctypes.

All of `dpm_solver_tpu_torch/csrc/*.cu` compile into one shared library with
a plain C interface, at first use, into `dpm_solver_tpu_torch/_build/<hash>/`
(listed in `.gitignore`), where the hash covers the sources, the headers they
share (`csrc/*.cuh`) and the nvcc command. Each source compiles in its own
nvcc process, all started together, and one more links the objects. The TMA
kernels find `cuTensorMapEncodeTiled` in libcuda with `dlopen` at run time,
so the library links against nothing but the CUDA runtime and `-ldl`.
A later call with the same sources loads the cached library. A missing nvcc
or a failed build raises: there is no fallback.

Every C entry returns the `cudaError_t` of its launch; `check` turns a
non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
LIB_NAME = "libdpm_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signatures of the entries in csrc/*.cu
_SIGNATURES = {
    "dpm_conv3x3_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "dpm_conv3x3_narrow": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "dpm_conv3x3_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "dpm_attention_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _L, _L, _L, _L, _L,
                          _L, _I, _I, _I, _I, _I, _I, _P),
    "dpm_attention_bwd_dq": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F,
                             _L, _L, _L, _L, _L, _L, _I, _P),
    "dpm_attention_bwd_dkv": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F,
                              _L, _L, _L, _L, _L, _L, _I, _P),
    "dpm_ln_linear_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _I, _I, _P),
    "dpm_geglu_fwd": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "dpm_attention_out_fwd": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                              _L, _L, _L, _L, _L, _L, _I, _I, _I, _I, _I, _I, _I, _P),
}


def find_nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set NVCC or CUDA_HOME); the CUDA kernels "
                       "of dpm_solver_tpu_torch are built from source at first use")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def source_hash(nvcc: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join((nvcc,) + NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into the cached shared library; return its path."""
    nvcc = find_nvcc()
    out_dir = BUILD_ROOT / source_hash(nvcc)
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        obj = out_dir / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()), "-c",
               "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    logs = [(cmd, proc.communicate()[0], proc.returncode) for cmd, _, proc in jobs]
    for cmd, out, code in logs:
        if code != 0:
            raise RuntimeError(f"nvcc failed ({code}):\n{' '.join(cmd)}\n{out}")
        if verbose:
            print(out)
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    cmd = [nvcc, "-shared", "-o", str(tmp), *(str(obj) for _, obj, _ in jobs), "-ldl"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    for _, obj, _ in jobs:
        obj.unlink()
    if verbose:
        print(f"nvcc build: {time.perf_counter() - t0:.1f} s -> {lib}")
    os.replace(tmp, lib)  # atomic: a concurrent build never loads a partial file
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {code}")


def device_type(t, what: str) -> str:
    """"cpu" or "cuda", the two devices a kernel wrapper dispatches on."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {t.device}")
    return t.device.type


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
