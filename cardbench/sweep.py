#!/usr/bin/env python3
"""The knee of an open-loop cell: the highest request rate the engine
sustains, found once by a sweep on the card (the benchmark's own runs
never sweep; a cell's traffic file holds a fixed rate).

    python3 cardbench/sweep.py --workload <open-loop cell> --seed 5 --seconds 30 --rates 2.5,3,3.5,4,4.5

One process: the weights once, then for each rate a fresh engine, its
warm-up, the traffic file's lead-in and a window of ``--seconds`` at that
rate. For each rate one JSON line: requests due and finished in the
window, requests in the system (waiting or running) at its opening and its
end, those still waiting for a slot at its end, TTFT p50/p90, ITL p95 and
tokens per second. A rate is sustained when the backlog does not grow
over the window.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--lead-in", type=float, default=None,
                    help="seconds of lead-in (default: the traffic file's)")
    args = ap.parse_args(argv)
    import torch

    torch.set_num_threads(1)

    from cardbench.lib import bench, metrics, model, serve, stats, window

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = bench.load(ROOT, args.workload)
    cfg_file = spec["cfg_file"]
    if spec["traffic"]["loop"] != "open":
        print("the sweep is for open-loop cells", file=sys.stderr)
        return 2
    sd = model.make_weights(cfg_file, args.seed, "cuda")
    for rate in [float(r) for r in args.rates.split(",")]:
        traffic = copy.deepcopy(spec["traffic"])
        traffic["arrival"]["rate"] = rate
        if args.lead_in is not None:
            traffic["lead_in_s"] = args.lead_in
        model, eng = serve.build_engine(cfg_file, sd, "cuda")
        serve.warm_up(eng, cfg_file, args.seed,
                      traffic.get("warm_decode_sizes"))
        sess = serve.Session(eng, traffic, args.seed,
                             cfg_file["arch"]["vocab_size"])
        in_sys = {}

        def count(s, at):
            in_sys[at] = len(s.active)

        sess.run(args.seconds, on_open=lambda s: count(s, "open"))
        count(sess, "end")
        waiting = sum(1 for q in sess.active.values() if q.admit_t0 is None)
        view = metrics.RunView(spec["cell"], cfg_file, traffic, sess, 0.0, 0)
        due = sess.due_in_window()
        ttft = window.ttfts_ms(view)
        prefill, gen = window.tokens_in_window(view)
        print(json.dumps({
            "rate": rate, "due": len(due),
            "finished": sum(1 for q in due if q.done_t is not None
                            and q.done_t <= sess.t_end),
            "in_system_open": in_sys["open"], "in_system_end": in_sys["end"],
            "waiting_end": waiting,
            "ttft_p50_ms": stats.percentile(ttft, 50),
            "ttft_p90_ms": stats.percentile(ttft, 90),
            "itl_p95_ms": stats.percentile(window.itls_ms(view), 95),
            "generated_per_s": gen / view.window_s,
            "tokens_per_s": (prefill + gen) / view.window_s}), flush=True)
        sess.eng = None
        del eng, model, sess
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
