"""What no process of a run may hold: JAX, its libraries, or the JAX
package of this repository (``repro``) and its harness (``benchmarks``).
Modules are compared by their whole top-level name, the part before the
first dot, so ``repro_torch`` (the port) is not ``repro``."""
from __future__ import annotations

import sys
from typing import Iterable, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def forbidden_modules(names: Optional[Iterable[str]] = None) -> List[str]:
    """The forbidden top-level names among ``names`` (default: the loaded
    modules), sorted."""
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))
