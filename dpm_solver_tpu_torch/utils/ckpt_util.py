"""Checkpoint path resolution with md5 integrity checks.

Port of `dpm_solver_tpu/utils/ckpt_util.py`, the twin of the reference's
Heidelberg-DDPM checkpoint utility (ddpm_and_guided-diffusion/functions/
ckpt_util.py:5-72). Nothing is downloaded: `get_ckpt_path` resolves the same
on-disk layout, verifies the published md5 when asked, and raises with the
canonical source URL when the file is absent, for the caller to fetch it out
of band. Plain Python (hashlib, os); the tables are the JAX module's.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

# canonical tables (ckpt_util.py:5-35)
URL_MAP = {
    "cifar10": "https://heibox.uni-heidelberg.de/f/869980b53bf5416c8a28/?dl=1",
    "ema_cifar10": "https://heibox.uni-heidelberg.de/f/2e4f01e2d9ee49bab1d5/?dl=1",
    "lsun_bedroom": "https://heibox.uni-heidelberg.de/f/f179d4f21ebc4d43bbfe/?dl=1",
    "ema_lsun_bedroom": "https://heibox.uni-heidelberg.de/f/b95206528f384185889b/?dl=1",
    "lsun_cat": "https://heibox.uni-heidelberg.de/f/fac870bd988348eab88e/?dl=1",
    "ema_lsun_cat": "https://heibox.uni-heidelberg.de/f/0701aac3aa69457bbe34/?dl=1",
    "lsun_church": "https://heibox.uni-heidelberg.de/f/2711a6f712e34b06b9d8/?dl=1",
    "ema_lsun_church": "https://heibox.uni-heidelberg.de/f/44ccb50ef3c6436db52e/?dl=1",
}
CKPT_MAP = {
    "cifar10": "diffusion_cifar10_model/model-790000.ckpt",
    "ema_cifar10": "ema_diffusion_cifar10_model/model-790000.ckpt",
    "lsun_bedroom": "diffusion_lsun_bedroom_model/model-2388000.ckpt",
    "ema_lsun_bedroom": "ema_diffusion_lsun_bedroom_model/model-2388000.ckpt",
    "lsun_cat": "diffusion_lsun_cat_model/model-1761000.ckpt",
    "ema_lsun_cat": "ema_diffusion_lsun_cat_model/model-1761000.ckpt",
    "lsun_church": "diffusion_lsun_church_model/model-4432000.ckpt",
    "ema_lsun_church": "ema_diffusion_lsun_church_model/model-4432000.ckpt",
}
MD5_MAP = {
    "cifar10": "82ed3067fd1002f5cf4c339fb80c4669",
    "ema_cifar10": "1fa350b952534ae442b1d5235cce5cd3",
    "lsun_bedroom": "f70280ac0e08b8e696f42cb8e948ff1c",
    "ema_lsun_bedroom": "1921fa46b66a3665e450e42f36c2720f",
    "lsun_cat": "bbee0e7c3d7abfb6e2539eaf2fb9987b",
    "ema_lsun_cat": "646f23f4821f2459b8bafc57fd824558",
    "lsun_church": "eb619b8a5ab95ef80f94ce8a5488dae3",
    "ema_lsun_church": "fdc68a23938c2397caba4a260bc2445f",
}


def md5_hash(path: str, chunk_size: int = 1 << 20) -> str:
    """Streaming md5 (the reference slurps the whole multi-GB file)."""
    h = hashlib.md5()
    with open(path, "rb") as f:
        while chunk := f.read(chunk_size):
            h.update(chunk)
    return h.hexdigest()


def get_ckpt_path(name: str, root: Optional[str] = None,
                  check: bool = False) -> str:
    """Resolve a named checkpoint under the reference's directory layout.

    Raises FileNotFoundError (with the canonical URL) when the file is not
    on disk, and ValueError when `check=True` and the md5 mismatches."""
    if "church_outdoor" in name:
        name = name.replace("church_outdoor", "church")
    if name not in URL_MAP:
        raise KeyError(f"unknown checkpoint {name!r}; have {sorted(URL_MAP)}")
    cachedir = os.environ.get("XDG_CACHE_HOME",
                              os.path.expanduser("~/ddpm_ckpt"))
    root = root if root is not None else os.path.join(
        cachedir, "diffusion_models_converted")
    path = os.path.join(root, CKPT_MAP[name])
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"checkpoint {name!r} not found at {path}; this environment has "
            f"no egress — fetch it out of band from {URL_MAP[name]} "
            f"(md5 {MD5_MAP[name]})")
    if check:
        md5 = md5_hash(path)
        if md5 != MD5_MAP[name]:
            raise ValueError(
                f"{path}: md5 {md5} != expected {MD5_MAP[name]} "
                f"(corrupt or wrong file)")
    return path
