"""The port's package data ships every source its kernel build reads, and
its package list every subpackage (the training package among them).

`dpm_solver_tpu_torch/ops/_build.py` compiles `csrc/*.cu` and hashes every
`csrc/*.cu*` (the sources and the headers they include), so an installed
copy of the port can build its kernels only if `pyproject.toml`'s
package-data globs take each of those files.
"""

import fnmatch
import re
import tomllib
from pathlib import Path

from dpm_solver_tpu_torch.ops import _build

ROOT = Path(__file__).resolve().parent.parent


def test_package_data_ships_every_kernel_source():
    config = tomllib.loads((ROOT / "pyproject.toml").read_text())
    globs = config["tool"]["setuptools"]["package-data"]["dpm_solver_tpu_torch"]
    pkg = _build.CSRC.parent
    read = sorted(_build.CSRC.glob("*.cu*"))
    included = {m for src in _build.CSRC.glob("*.cu")
                for m in re.findall(r'#include "([^"]+)"', src.read_text())}
    assert read and included <= {f.name for f in read}
    for f in read:
        rel = f.relative_to(pkg).as_posix()
        assert any(fnmatch.fnmatch(rel, g) for g in globs), f"{rel} is not in {globs}"


def test_package_list_ships_every_subpackage():
    """`packages.find`'s include finds each directory of the port that holds
    an `__init__.py` (dpm_solver_tpu_torch.training among them)."""
    from setuptools import find_packages

    config = tomllib.loads((ROOT / "pyproject.toml").read_text())
    found = set(find_packages(str(ROOT), include=config["tool"]["setuptools"]["packages"]
                              ["find"]["include"]))
    pkg = _build.CSRC.parent
    subpackages = {".".join(init.parent.relative_to(ROOT).parts)
                   for init in pkg.rglob("__init__.py")}
    assert "dpm_solver_tpu_torch.training" in subpackages
    assert subpackages <= found, subpackages - found
