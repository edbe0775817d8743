#!/usr/bin/env python3
"""The readings the limits of ``correct`` are set from, many seeds in one
process (the benchmark's own runs never run this).

    python3 cardbench/control.py --workload <cell> --seeds 11,12,13 --seconds 40 [--control 0|1] [--fault token]

For each seed it makes one run of the cell as ``run.py`` does (set-up,
lead-in, a window of ``--seconds`` at the cell's own load and sizes), then
judges it and prints every reading of ``check.judge``: the program's
(``served_logit_gap``, ``final_hidden_err`` and its median and 90th
percentile) and, with ``--control 1`` (the default), the control's (the
same reference in TF32, put in the program's place: ``control_logit_gap``,
the fp32 gap of the token TF32 ranks first at each judged position, and
``control_hidden_err``). ``--fault token`` plants a fault where tokens are
produced, for its reading. One JSON line per seed, then a summary: the
largest program readings and the smallest control readings.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
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


def _alter_tokens(seed: int):
    """A fault planted where tokens are produced: every fifth call of the
    model's head, each row's logit of a token drawn from the seed is made
    the largest."""
    import torch

    def prepare(model, eng):
        real, calls = model.logits_out, [0]
        gen = torch.Generator().manual_seed(seed % 2 ** 63)

        def logits_out(x, *a, **kw):
            lg = real(x, *a, **kw)
            calls[0] += 1
            if calls[0] % 5 == 0:
                tok = torch.randint(lg.shape[-1], lg.shape[:-1] + (1,),
                                    generator=gen).to(lg.device)
                lg = lg.scatter(-1, tok, float(lg.max()) + 1.0)
            return lg
        model.logits_out = logits_out
    return prepare


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    ap.add_argument("--fault", choices=("none", "token"), default="none",
                    help="token: every fifth pass that produces tokens "
                    "puts a token drawn from the seed first")
    args = ap.parse_args(argv)
    import torch

    torch.set_num_threads(1)

    from cardbench.lib import bench

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    spec = bench.load(ROOT, args.workload)
    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        prepare = _alter_tokens(seed) if args.fault == "token" else None
        out = bench.run_cell(spec, seed, args.seconds, False, t0,
                             control=bool(args.control), prepare=prepare,
                             readings=True,
                             log=lambda s: print(s, file=sys.stderr))
        row = {"seed": seed, **out["readings"], "correct": out["correct"],
               "metrics": out["metrics"], "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    summary = {"workload": args.workload, "seeds": len(rows)}
    for k in rows[0]:
        if k.startswith(("served_", "final_")):
            summary[k + "_max"] = max(r[k] for r in rows)
        if k.startswith("control_"):
            summary[k + "_min"] = min(r[k] for r in rows)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
