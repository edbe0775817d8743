"""Benchmark harness utilities: CSV emission per paper table/figure, and
machine-readable JSON snapshots (``BENCH_<module>.json``).

The port's snapshots land in ``build/bench_json/`` of the checkout (git
ignores ``build/``), never at the repo root, where the committed
``BENCH_*.json`` files belong to the JAX package's benchmarks.
``BENCH_JSON_DIR`` (or ``repro_torch.bench.run --json DIR``) overrides it."""
from __future__ import annotations

import json
import os
from pathlib import Path

DEFAULT_JSON_DIR = Path(__file__).resolve().parents[3] / "build" / "bench_json"


def emit(name: str, us_per_call: float, derived: str = "") -> None:
    print(f"{name},{us_per_call:.3f},{derived}")


def header() -> None:
    print("name,us_per_call,derived")


def json_dir() -> Path:
    """Where BENCH_*.json files land (override with BENCH_JSON_DIR)."""
    return Path(os.environ.get("BENCH_JSON_DIR", DEFAULT_JSON_DIR))


def write_json(module: str, results: dict, *, hardware: str = "",
               policies=(), extra_meta: dict = None) -> Path:
    """Write a benchmark module's results as BENCH_<module>.json.

    ``hardware`` (HardwareModel name) and ``policies`` (the policy kinds the
    module exercised) land under a ``_meta`` key; ``extra_meta`` merges
    additional keys into it (e.g. the cluster benchmark's link topology)."""
    path = json_dir() / f"BENCH_{module}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    out = dict(results)
    out["_meta"] = {"hardware": hardware,
                    "policies": sorted(set(policies)),
                    **(extra_meta or {})}
    path.write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")
    return path
