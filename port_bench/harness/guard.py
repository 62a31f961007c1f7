"""What the benchmark must not load: JAX, its libraries and the JAX package.

Names are compared by their top-level part (before the first dot) as a
whole, so `dpm_solver_tpu_torch` (the program) is not `dpm_solver_tpu`.
`loaded_forbidden` looks at a process's `sys.modules`; `imports_forbidden`
reads a source file's import statements.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "dpm_solver_tpu"})


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def loaded_forbidden(modules: Iterable[str] = None) -> List[str]:
    names = sys.modules if modules is None else modules
    return sorted({top_level(n) for n in names if top_level(n) in FORBIDDEN})


def imports_forbidden(path: Path) -> List[str]:
    """The forbidden top-level names a Python file imports (absolute imports)."""
    tree = ast.parse(Path(path).read_text("utf-8"), filename=str(path))
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found.update(top_level(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            found.add(top_level(node.module))
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            found.add(top_level(node.args[0].value))
    return sorted(found & FORBIDDEN)
