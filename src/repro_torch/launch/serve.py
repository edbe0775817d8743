"""Serving launcher: batched paged-KV serving of an --arch model, on the
CUDA card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \\
        --reduced --device cpu --requests 4 --max-new 8

Weights are random, from ``--seed``. ``--umem`` puts the KV pool under the
unified-memory runtime with the charge model's default hardware
(``GRACE_HOPPER``); its times are modeled, not measured.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import UnifiedMemory
from repro_torch.kernels.common import resolve_device
from repro_torch.models import init_params
from repro_torch.serve import ServeEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--umem", action="store_true",
                    help="track the KV pool in the unified-memory runtime")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = init_params(cfg, seed=args.seed, device=dev)
    um = UnifiedMemory() if args.umem else None
    eng = ServeEngine(cfg, params, max_seqs=max(4, args.requests),
                      max_len=args.max_len, page_size=args.page_size, um=um,
                      device=dev)
    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        plen = max(2, args.prompt_len + int(rng.integers(-4, 5)))
        eng.add_request(rng.integers(2, cfg.vocab_size, plen), args.max_new)
    t0 = time.perf_counter()
    out = eng.run_to_completion()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(v) for v in out.values())
    print(f"arch={args.arch} device={dev} requests={len(out)} "
          f"tokens={total_tokens} wall={dt:.2f}s tok/s={total_tokens/dt:.1f}")
    for rid, toks in sorted(out.items()):
        print(f"  req {rid}: {toks}")
    if um is not None:
        print("umem (modeled, GRACE_HOPPER):", um.report()["traffic_total"])


if __name__ == "__main__":
    main()
