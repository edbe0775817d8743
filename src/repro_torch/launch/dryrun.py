"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on fake ranks
(the port of ``repro.launch.dryrun``).

Proves the distribution config is coherent without hardware: a process
group of the ``fake`` backend stands in for 256 ranks (16, 16) or 2 pods x
256 = 512 ranks (2, 16, 16). For each cell the artifacts of
``launch/steps.py`` run for one rank (rank 0: every rank's shapes are
equal) on fake tensors, and its FLOPs, bytes, collectives and peak memory
(``launch/analysis.py``) are recorded to JSON with the reference's keys,
read by ``launch/roofline.py``. Nothing is compiled or run on a device:
``lower_s`` is the trace's seconds and ``compile_s`` 0.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out experiments/dryrun_torch]
  python -m repro_torch.launch.dryrun --all --both-meshes
Perf-variant knobs: --attn-block, --seqpar (sequence parallelism of the
residual), --kv-int8, --q8-collectives, --moe-sorted, --tag.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import SHAPES, cells, get_config
from repro_torch.launch.analysis import (
    CollectiveBytes,
    LiveBytes,
    OpBytes,
    cost_summary,
    memory_summary,
    model_flops,
    tensor_bytes,
)
from repro_torch.launch.mesh import end_world, make_production_mesh, start_fake_world
from repro_torch.launch.roofline import HBM_PER_CHIP
from repro_torch.launch.steps import make_artifacts


def _fake_world(world_size: int) -> None:
    if dist.is_initialized():
        if dist.get_world_size() == world_size and dist.get_backend() == "fake":
            return
        end_world()
    start_fake_world(world_size)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, out_dir: str,
             attn_block: int = 4096, seqpar: bool = False,
             tag: str = "baseline",
             artifacts=None, force: bool = False, verbose: bool = True,
             extra_policy=None, layers: int = 0):
    """Trace one cell and write its record (``layers`` > 0 cuts the depth,
    recorded as ``meta['layers']``; ``seqpar`` runs it under sequence
    parallelism, recorded as ``meta['sequence_parallel']``)."""
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    shape = SHAPES[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    os.makedirs(os.path.join(out_dir, tag), exist_ok=True)
    base = f"{arch}__{shape_name}__{mesh_name}"
    path = os.path.join(out_dir, tag, base + ".json")
    if os.path.exists(path) and not force and not artifacts:
        if verbose:
            print(f"[skip] {base} (exists)")
        with open(path) as f:
            return json.load(f)

    if shape.sub_quadratic_only and not cfg.sub_quadratic:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "skipped": "full-attention arch at 500k ctx"}
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        return rec

    _fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "tag": tag,
           "chips": mesh.size, "meta": {},
           "model_flops_global": model_flops(cfg, shape),
           "params": cfg.param_count(), "active_params": cfg.active_param_count(),
           "artifacts": {}}
    if os.path.exists(path) and artifacts:  # merge partial redo into record
        with open(path) as f:
            rec = json.load(f)
        rec["artifacts"] = rec.get("artifacts", {})
    with FakeTensorMode():
        t0 = time.time()
        arts = make_artifacts(cfg, shape, mesh, attn_block=attn_block,
                              sequence_parallel=seqpar,
                              extra_policy=extra_policy)
        build_s = time.time() - t0
        rec["meta"] = dict(arts.pop("__meta__", {}),
                           **({"layers": layers} if layers else {}),
                           **({"sequence_parallel": True} if seqpar else {}))
        mem_name, mem_over = arts.pop("__memory__")
        arg_bytes = arts.pop("__arguments__")
        live = LiveBytes()  # one count over the artifacts of the cell
        done, out_bytes = {}, 0
        for name, fn in arts.items():
            t0 = time.time()
            with FlopCounterMode(display=False) as fc, \
                    CollectiveBytes() as cb, OpBytes(live) as ob:
                result = fn()
            out_bytes += tensor_bytes(result)
            done[name] = {"lower_s": round(time.time() - t0, 2),
                          "compile_s": 0.0,
                          "cost": cost_summary(fc.get_total_flops(), ob),
                          "collectives": cb.summary()}
            del result
        peak = live.peak
    mem = memory_summary(arg_bytes, peak, out_bytes)
    for name, d in done.items():
        d["memory"] = mem
    by_op = {}
    for n in mem_over:
        for op, d in done[n]["collectives"]["by_op"].items():
            acc = by_op.setdefault(op, {"count": 0, "tensor_bytes": 0.0,
                                        "wire_bytes": 0.0})
            for k in acc:
                acc[k] += d[k]
    done[mem_name] = {
        "lower_s": round(sum(done[n]["lower_s"] for n in mem_over) + build_s, 2),
        "compile_s": 0.0, "memory": mem,
        "cost": dict(done[mem_over[0]]["cost"],
                     **{k: sum(done[n]["cost"][k] for n in mem_over)
                        for k in ("flops", "bytes_accessed", "transcendentals")}),
        "collectives": {"by_op": by_op,
                        "wire_bytes": sum(d["wire_bytes"] for d in by_op.values())}}
    for name, d in done.items():
        if artifacts and name not in artifacts:
            continue
        if name in rec["artifacts"] and not force:
            continue  # merged partial redo: keep existing artifact
        rec["artifacts"][name] = d
    if verbose:
        for name in arts:
            c, w = done[name]["cost"], done[name]["collectives"]
            print(f"[ok] {base}/{name}: trace={done[name]['lower_s']:.1f}s "
                  f"flops/dev={c['flops']:.3e} bytes/dev<={c['bytes_accessed']:.3e} "
                  f"wire/dev={w['wire_bytes']:.3e} "
                  f"peak_mem={mem['peak_bytes_est'] / 2**30:.2f}GiB "
                  f"({'FITS' if mem['peak_bytes_est'] < HBM_PER_CHIP else 'OVER'})")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--attn-block", type=int, default=4096)
    ap.add_argument("--seqpar", action="store_true")
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--q8-collectives", action="store_true")
    ap.add_argument("--moe-sorted", action="store_true")
    ap.add_argument("--artifacts", nargs="*", default=None)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut each arch to this many layers (0: all)")
    args = ap.parse_args(argv)

    todo = []
    if args.all:
        for arch, shape_name, _live in cells(include_skipped=True):
            todo.append((arch, shape_name))
    elif args.arch and args.shape:
        todo.append((args.arch, args.shape))
    else:
        ap.error("--arch/--shape or --all")

    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    extra = {}
    if args.kv_int8:
        extra["kv_cache_quant"] = True
    if args.q8_collectives:
        extra["quantize_tp_collectives"] = True
    if args.moe_sorted:
        extra["moe_impl"] = "sorted"
    failures = []
    try:
        for arch, shape_name in todo:
            for mp in meshes:
                try:
                    run_cell(arch, shape_name, multi_pod=mp, out_dir=args.out,
                             attn_block=args.attn_block, seqpar=args.seqpar,
                             tag=args.tag,
                             artifacts=args.artifacts, force=args.force,
                             extra_policy=extra or None, layers=args.layers)
                except Exception:  # noqa: BLE001 -- report the cell, go on
                    failures.append((arch, shape_name, mp))
                    print(f"[FAIL] {arch}/{shape_name}/mp={mp}")
                    traceback.print_exc()
    finally:
        end_world()
    if failures:
        print("FAILURES:", failures)
        return 1
    print("dry-run complete")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
