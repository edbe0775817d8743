#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``) on the card.

    python3 cardbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It serves the cell's traffic with the port's
``ServeEngine`` on one CUDA card, measures for ``--seconds`` after its
set-up and lead-in, checks the served tokens against the plain reference
(``cardbench/lib/reference.py``) and prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device`` and, traced, ``breakdown``, then ``checks``
(each compared number with its limit), which also end standard error.
Without a CUDA card, or with fewer cards than the cell asks for, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
# one process with few threads: the host's work is the engine's Python
for _v in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_v] = "1"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        print("the program (src/repro_torch) is not in this checkout",
              file=sys.stderr)
        return 3
    import torch

    torch.set_num_threads(1)

    from cardbench.lib import bench, guard

    spec = bench.load(ROOT, args.workload)
    chips = int(spec["cell"].get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # build caches stay inside the checkout (the port's kernels build into
    # build/torch_kernels there by themselves)
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    out = bench.run_cell(spec, args.seed, args.seconds, bool(args.trace),
                         T_START, device="cuda",
                         log=lambda s: print(s, flush=True))
    bad = guard.forbidden_modules()  # what the port loaded in this process
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 4
    print(json.dumps(out), flush=True)
    bench.report_checks(out["checks"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
