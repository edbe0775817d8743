"""What no process of a run may hold: JAX, its libraries, or the JAX
package of this repository (``repro``) and its harness (``benchmarks``).
Modules are compared by their whole top-level name, the part before the
first dot, so ``repro_torch`` (the port) is not ``repro``.

A configuration's model module (``model.py``) is part of the yardstick, so
it may import none of those and nothing of the program (``repro_torch``)
either: ``refused_imports`` reads its source before it runs."""
from __future__ import annotations

import ast
import sys
from typing import Iterable, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
PROGRAM = ("repro_torch",)


def forbidden_modules(names: Optional[Iterable[str]] = None) -> List[str]:
    """The forbidden top-level names among ``names`` (default: the loaded
    modules), sorted."""
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def refused_imports(source: str) -> List[str]:
    """What a model module's ``source`` may not do, sorted: each forbidden or
    program top-level name it imports, and ``__import__`` or
    ``import_module`` (an import by a computed name) where it calls them."""
    refused = set(FORBIDDEN + PROGRAM)
    bad = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            bad |= {a.name.split(".")[0] for a in node.names} & refused
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            bad |= {node.module.split(".")[0]} & refused
        elif isinstance(node, ast.Call):
            f = node.func
            name = f.id if isinstance(f, ast.Name) else getattr(f, "attr", "")
            if name in ("__import__", "import_module"):
                bad.add(name)
    return sorted(bad)
