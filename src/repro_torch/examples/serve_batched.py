"""Serve a small model with batched requests through the paged-KV engine,
with the pool governed by the unified-memory runtime (the paper's system
policy applied to serving).

The engine is oversubscription-aware: the run below gives it (a) a KV page
pool smaller than the workload's total demand, so the scheduler preempts
the youngest sequences (KV demoted host-side) and resumes them as pages
free up, and (b) a modeled device capacity smaller than the pool, so part
of the KV stays host-resident and decode reads it remotely over the
interconnect — the paper's graceful-oversubscription behavior (§7)
instead of an OOM. The runtime models the Grace Hopper superchip
(``GRACE_HOPPER``); the model runs on ``--device`` (the CUDA card by
default).

    PYTHONPATH=src python -m repro_torch.examples.serve_batched [--device cpu]
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import GRACE_HOPPER, UnifiedMemory
from repro_torch.kernels.common import resolve_device
from repro_torch.models import init_params
from repro_torch.models.cache import kv_head_layout
from repro_torch.serve import PagedKVCache, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of the model; default: the CUDA card")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = get_config("yi-6b").reduced()
    params = init_params(cfg, seed=0, device=dev)

    # 6 requests > 4 slots (continuous batching), a 10-page pool that cannot
    # hold every admitted sequence (preemption), and a device that only fits
    # 2/3 of the pool (remote KV reads under 1.5x oversubscription)
    num_pages, page_size = 10, 16
    page_bytes = PagedKVCache.page_bytes_for(cfg, kv_head_layout(cfg, 1),
                                             page_size)
    hw = dataclasses.replace(
        GRACE_HOPPER, device_capacity=int(num_pages * page_bytes / 1.5))
    um = UnifiedMemory(hw=hw)
    eng = ServeEngine(cfg, params, max_seqs=4, max_len=128,
                      page_size=page_size, num_pages=num_pages, um=um,
                      prefill_chunk=32, device=dev)

    rng = np.random.default_rng(0)
    for i in range(6):
        plen = int(rng.integers(8, 40))
        rid = eng.add_request(rng.integers(2, cfg.vocab_size, plen), 16)
        print(f"request {rid}: prompt_len={plen}")
    t0 = time.perf_counter()
    out = eng.run_to_completion()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    toks = sum(len(v) for v in out.values())
    print(f"\ngenerated {toks} tokens in {dt:.2f}s ({toks/dt:.1f} tok/s on {dev})")
    for rid, t in sorted(out.items()):
        print(f"  req {rid}: {t}")
    s = eng.stats
    print(f"\nscheduler: admitted={s.admitted} preempted={s.preempted} "
          f"resumed={s.resumed} prefill_chunks={s.prefill_chunks} "
          f"decode_batches={s.decode_batches}")
    rep = um.report()
    tr = rep["traffic_total"]
    print(f"umem (modeled Grace Hopper, pool 1.5x HBM): "
          f"remote_share={rep['remote_access_share']:.3f}, "
          f"kv h2d={tr['link_h2d']/2**20:.2f} MiB, "
          f"gpu-first-touch PTEs={tr['pte_inits_gpu']}, "
          f"notifications={tr['notifications']}")


if __name__ == "__main__":
    main()
