"""Fig11-style oversubscribed TRAINING — step time vs ratio per policy (the
port of ``benchmarks/train_oversub.py``).

The paper's fig11 sweeps an HPC kernel's working set past device capacity
and plots the slowdown per memory backend. This module is the training
counterpart over the offload subsystem: a train_100m-class residual MLP
(params + grads + AdamW m/v/master + activation stash in UMBuffers, see
``repro_torch/train/offload.py``) is driven through every registered backend
with the device sized to 1.0x / 1.25x / 1.5x / 2.0x oversubscription of
the GPU-touched working set (``device_demand_bytes`` — the optimizer tree
is CPU-resident and pressures the pool, not the device).

Every cell asserts its losses are BIT-IDENTICAL to the in-memory (1.0x)
run — the math is real fp32 with a fixed op order (torch on ``device``, the
CUDA card unless the caller passes ``device="cpu"``); only the modeled step
time and the traffic counters may move with the ratio, and the rows equal
the JAX module's on any device (but ``wall_s`` and, within fp32 rounding,
the losses). Backends that
cannot reach the requested ratio report the capacity they actually ran
with as ``eff_ratio`` (mi300a_unified floors at the full state tree: its
single pool cannot map less than it holds; the staged explicit port's
slab traffic is ratio-insensitive by construction).

    PYTHONPATH=src python -m repro_torch.bench.train_oversub [--device cpu]

Env:
  TRAIN_SMOKE=1  shrink to train_25m x fewer ratios for CI smoke runs
  TRAIN_MODEL    spec name override (train_tiny / train_25m / train_100m)
  TRAIN_FLOOR    'policy/ratio=STEPS_PER_S,...' — fail the run if a cell's
                 modeled throughput drops below its floor, e.g.
                 TRAIN_FLOOR='system/1.5=100,managed/1.5=40'

Writes BENCH_train.json to ``repro_torch.bench.common.json_dir()``.
"""
import argparse
import os
import sys
import time

from repro_torch.bench.common import emit, header, write_json
from repro_torch.kernels.common import resolve_device
from repro_torch.train import UMTrainer, get_train_model

SEED = 0
RATIOS = (1.0, 1.25, 1.5, 2.0)
SMOKE_RATIOS = (1.0, 1.5)
POLICIES = ("system", "managed", "explicit", "mi300a_unified",
            "cluster_system", "cluster_striped")
HW_FOR = {"mi300a_unified": "mi300a", "cluster_system": "gh200_x2",
          "cluster_striped": "gh200_x2"}


def _floors() -> dict:
    spec = os.environ.get("TRAIN_FLOOR", "")
    out = {}
    for item in spec.split(","):
        if item.strip():
            key, floor = item.split("=")
            out[key.strip()] = float(floor)
    return out


def _cell(spec, policy: str, ratio: float, steps: int, ref_losses,
          device) -> dict:
    t0 = time.perf_counter()
    tr = UMTrainer(spec, policy=policy, hw=HW_FOR.get(policy), ratio=ratio,
                   seed=SEED, device=device)
    out = tr.run(steps)
    wall = time.perf_counter() - t0
    if ref_losses is not None:
        assert out["losses"] == ref_losses, \
            f"{policy} x{ratio}: losses diverged from the 1.0x reference " \
            "— the memory system leaked into the math"
    rep = tr.um.prof.report()
    tt = rep["traffic_total"]
    tr.close()
    return {"kind": "train_oversub", "model": spec.name, "policy": policy,
            "ratio": ratio, "eff_ratio": round(out["eff_ratio"], 4),
            "capacity_bytes": out["capacity"],
            "demand_bytes": out["demand_bytes"],
            "state_bytes": out["peak_bytes"],
            "steps": steps, "modeled_s": out["modeled_s"],
            "steps_per_s": out["steps_per_s"],
            "step_time_s": out["modeled_s"] / steps,
            "migrated_out_bytes": tt["migrated_out"],
            "remote_access_share": rep["remote_access_share"],
            "losses": out["losses"], "wall_s": wall}


def run(device=None) -> int:
    """Benchmark-harness entry point (``repro_torch.bench.run``). Takes no
    --policy/--hw overrides: the module grids over every registered
    backend itself, so the harness skips it (with a note) rather than
    mislabeling an override run."""
    device = resolve_device(device)
    smoke = os.environ.get("TRAIN_SMOKE") == "1"
    model = os.environ.get("TRAIN_MODEL",
                           "train_25m" if smoke else "train_100m")
    spec = get_train_model(model)
    ratios = SMOKE_RATIOS if smoke else RATIOS
    steps = 2 if smoke else 3
    floors = _floors()
    rows, failures = [], []

    ref_losses = None
    for policy in POLICIES:
        for ratio in ratios:
            row = _cell(spec, policy, ratio, steps, ref_losses, device)
            if ref_losses is None:
                ref_losses = row["losses"]  # system x1.0 anchors the grid
            rows.append(row)
            key = f"{policy}/{ratio}"
            emit(f"train/{model}/{key}", row["step_time_s"] * 1e6,
                 f"steps_per_s={row['steps_per_s']:.1f},"
                 f"eff_ratio={row['eff_ratio']},"
                 f"migrated_out={row['migrated_out_bytes']}")
            floor = floors.get(key)
            if floor is not None and row["steps_per_s"] < floor:
                failures.append(
                    f"{key}: {row['steps_per_s']:.1f} steps/s "
                    f"< floor {floor:.1f}")

    # the curve must be a curve: oversubscription has to cost modeled time
    # somewhere (the fault-driven backend cannot be flat across the axis)
    managed = {r["ratio"]: r for r in rows if r["policy"] == "managed"}
    assert managed[max(ratios)]["modeled_s"] > managed[1.0]["modeled_s"], \
        "managed showed no slowdown under oversubscription — the ratio " \
        "axis is not applying device pressure"
    assert managed[max(ratios)]["migrated_out_bytes"] > 0, \
        "managed evicted nothing at the deepest ratio"

    if failures:
        raise SystemExit("TRAIN_FLOOR violated:\n  " + "\n  ".join(failures))

    write_json("train", {"rows": rows}, hardware="grace-hopper",
               policies=POLICIES,
               extra_meta={"model": model, "ratios": list(ratios),
                           "steps": steps, "seed": SEED, "smoke": smoke,
                           "hw_overrides": HW_FOR})
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of the math; default: the CUDA card")
    device = ap.parse_args(argv).device
    header()
    return run(device=device)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
