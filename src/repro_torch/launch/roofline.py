"""Roofline analysis from the dry-run JSON records (the port of
``repro.launch.roofline``), over H100 SXM constants (``core/h100.py``).

Per (arch x shape x mesh), from one rank's traced artifacts:
  compute term    = FLOPs / 989 TFLOP/s (bf16 dense)
  memory term     = bytes / 3.35 TB/s (HBM3)
  collective term = wire bytes / 50 GB/s (NDR InfiniBand a GPU: a 16-rank
                    'model' ring spans two 8-GPU NVLink nodes)
The counts are per device, so each term divides by one card's peak. Train
cells combine accum x micro_grads + opt_update; the data-parallel gradient
reduction is traced in opt_update, once a step, as the port's sharded step
runs it (the JAX package's micro_grads holds it, so its term counts it
accum times). The bytes are unfused
operand + output bytes, an upper bound (``launch/analysis.py``), so the
memory term is one too. These are modeled times, not measurements.

roofline_fraction = compute_term / max(all three): the fraction of peak
FLOPs reachable under the binding resource (1.0 = compute-bound).
mfu_bound = (MODEL_FLOPS/chips/peak) / max(all three): the MFU ceiling
counting only *useful* model FLOPs.

Usage: python -m repro_torch.launch.roofline [--dir experiments/dryrun_torch] [--tag baseline]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Optional

from repro_torch.core.h100 import HBM_BW, HBM_BYTES, IB_NDR_BW, PEAK_BF16_FLOPS

PEAK_FLOPS = PEAK_BF16_FLOPS
LINK_BW = IB_NDR_BW
HBM_PER_CHIP = HBM_BYTES


def cell_terms(rec: Dict) -> Optional[Dict]:
    """Combine artifacts into per-device roofline terms (seconds)."""
    if "skipped" in rec:
        return None
    arts = rec["artifacts"]
    accum = rec.get("meta", {}).get("accum", 1)

    if "micro_grads" in arts:  # train cell
        f = accum * arts["micro_grads"]["cost"]["flops"] \
            + arts.get("opt_update", {}).get("cost", {}).get("flops", 0.0)
        b = accum * arts["micro_grads"]["cost"]["bytes_accessed"] \
            + arts.get("opt_update", {}).get("cost", {}).get("bytes_accessed", 0.0)
        w = accum * arts["micro_grads"]["collectives"]["wire_bytes"] \
            + arts.get("opt_update", {}).get("collectives", {}).get("wire_bytes", 0.0)
        mem_art = "train_memory"
    elif "prefill" in arts:
        f = arts["prefill"]["cost"]["flops"]
        b = arts["prefill"]["cost"]["bytes_accessed"]
        w = arts["prefill"]["collectives"]["wire_bytes"]
        mem_art = "prefill_memory" if "prefill_memory" in arts else "prefill"
    elif "decode" in arts:
        f = arts["decode"]["cost"]["flops"]
        b = arts["decode"]["cost"]["bytes_accessed"]
        w = arts["decode"]["collectives"]["wire_bytes"]
        mem_art = "decode_memory" if "decode_memory" in arts else "decode"
    else:
        return None

    t_c = f / PEAK_FLOPS
    t_m = b / HBM_BW
    t_w = w / LINK_BW
    bound = max(t_c, t_m, t_w)
    if bound <= 0:
        bound, dominant = 1.0, "n/a"
    elif bound == t_m:
        dominant = "memory"
    elif bound == t_c:
        dominant = "compute"
    else:
        dominant = "collective"
    chips = rec["chips"]
    mf_dev = rec["model_flops_global"] / chips
    peak_mem = arts[mem_art]["memory"]["peak_bytes_est"] if mem_art in arts else 0
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "flops_dev": f, "bytes_dev": b, "wire_dev": w,
        "t_compute": t_c, "t_memory": t_m, "t_collective": t_w,
        "dominant": dominant,
        "roofline_fraction": t_c / bound,
        "model_flops_dev": mf_dev,
        "useful_ratio": (mf_dev / f) if f else 0.0,
        "mfu_bound": (mf_dev / PEAK_FLOPS) / bound,
        "peak_mem_gib": peak_mem / 2**30,
        "fits": peak_mem < HBM_PER_CHIP,
        "mem_artifact": mem_art,
    }


def load(dir_: str, tag: str) -> List[Dict]:
    out = []
    for f in sorted(glob.glob(os.path.join(dir_, tag, "*.json"))):
        with open(f) as fh:
            rec = json.load(fh)
        t = cell_terms(rec)
        if t is not None:
            out.append(t)
        elif "skipped" in rec:
            out.append({"arch": rec["arch"], "shape": rec["shape"],
                        "mesh": rec["mesh"], "skipped": rec["skipped"]})
    return out


def fmt_table(rows: List[Dict]) -> str:
    hdr = ("| arch | shape | mesh | t_compute (s) | t_memory (s) | t_coll (s) | "
           "dominant | roofline-frac | useful-ratio | MFU-bound | peak mem | fits |")
    sep = "|" + "---|" * 12
    lines = [hdr, sep]
    for r in rows:
        if "skipped" in r:
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                         f"— skipped: {r['skipped']} |" + " |" * 8)
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['t_compute']:.3e} | {r['t_memory']:.3e} | {r['t_collective']:.3e} "
            f"| {r['dominant']} | {r['roofline_fraction']:.2f} "
            f"| {r['useful_ratio']:.2f} | {r['mfu_bound']:.3f} "
            f"| {r['peak_mem_gib']:.1f} GiB | {'Y' if r['fits'] else 'N'} |")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.roofline")
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    rows = load(args.dir, args.tag)
    print(fmt_table(rows))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
