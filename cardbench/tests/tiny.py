"""Cells cut to a size the CPU runs in a second or two: the cell's own
configuration file and traffic mix with every width and count made small,
for tests only (the benchmark never runs these sizes)."""
from __future__ import annotations

import copy
import time
from pathlib import Path

import torch

from cardbench.lib import bench

ROOT = Path(__file__).resolve().parents[2]


def spec(workload: str, **traffic) -> dict:
    s = bench.load(ROOT, workload)
    cf = copy.deepcopy(s["cfg_file"])
    a = cf["arch"]
    gqa = a["num_kv_heads"] < a["num_heads"]
    a.update(num_layers=2, d_model=64, d_ff=96, vocab_size=256, num_heads=4,
             num_kv_heads=2 if gqa else 4, head_dim=16)
    if a.get("num_experts"):
        a.update(num_experts=8, top_k=2, d_ff=32)
    cf["engine"].update(max_seqs=8, max_len=160, page_size=8,
                        prefill_chunk=32, num_pages=200)
    t = copy.deepcopy(s["traffic"])
    t["prompt"].update(lo=4, hi=60, mean=20)
    t["output"].update(lo=2, hi=40, mean=12)
    t["block"] = 16
    if t["loop"] == "open":
        t["arrival"]["rate"], t["lead_in_s"] = 40.0, 0.3
    else:
        t["clients"] = min(t["clients"], 8)
    t.update(traffic)
    s.update(cfg_file=cf, traffic=t)
    return s


def run(s: dict, seed: int = 2 ** 31 + 7, seconds: float = 0.6, **kw) -> dict:
    torch.set_num_threads(1)
    return bench.run_cell(s, seed, seconds, False, time.perf_counter(),
                          device="cpu", log=lambda line: None, **kw)
