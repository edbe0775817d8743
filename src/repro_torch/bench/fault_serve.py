"""Fault-tolerant serving under injected node/lane/spill failures (the
port of ``benchmarks/fault_serve.py``).

Grid over the traffic scenarios x fault kinds x cluster policies, every
cell driven by a seeded :class:`repro_torch.runtime.FaultPlan` against the
TP-2 gh200_x2 serve stack (plus a single-node spill-failure cell on the
preemption-heavy burst scenario):

* **node_loss**    — one superchip dies mid-run: its KV pages are
                     poisoned, the TP group shrinks to the survivor, and
                     affected sequences replay from their prompts.
* **lane_degrade** — the inter-node NVLink/fabric lanes run at 25% of
                     nominal bandwidth for a window of steps.
* **spill_fail**   — host-spill (preemption demote) fails for the whole
                     run; preemptions fall back to drop-and-recompute.

Every faulted cell asserts its generated tokens are BIT-IDENTICAL to the
fault-free run of the same configuration for dense archs. MoE archs are
held to completion + identical stream lengths instead: capacity-bounded
routing drops tokens as a function of the batch/chunk shape (GShard
semantics), and a replay changes batch composition. The rows report the
recovery SLOs (modeled: equal to the JAX module's on any device).

    PYTHONPATH=src python -m repro_torch.bench.fault_serve [--device cpu]

Env:
  FAULT_SMOKE=1  shrink the workload (scale 0.25)
  FAULT_FLOOR    'scenario/fault/policy=TOKS_PER_S,...': fail the run if
                 a faulted cell's modeled goodput drops below its floor

Writes BENCH_fault.json to ``repro_torch.bench.common.json_dir()``.
"""
import argparse
import os
import sys
import time

from repro_torch.bench.common import emit, header, write_json
from repro_torch.configs import get_config
from repro_torch.kernels.common import resolve_device
from repro_torch.runtime import FaultPlan
from repro_torch.serve import TrafficSim, get_scenario

SEED = 0
POLICIES = ("cluster_system", "cluster_striped")
SCENARIOS = ("steady", "burst")
# the dead node is the one holding KV pages at the fault step: locality
# places on the serving superchip (kill rank 1), striping fills node 0's
# first stripe at these pool sizes (kill rank 0)
DEAD_NODE = {"cluster_system": 1, "cluster_striped": 0}
NODE_LOSS_STEP = 6
LANE_WINDOW = (2, 24, 0.25)  # (start step, duration, bandwidth factor)


def _floors() -> dict:
    spec = os.environ.get("FAULT_FLOOR", "")
    out = {}
    for item in spec.split(","):
        if item.strip():
            key, floor = item.split("=")
            out[key.strip()] = float(floor)
    return out


def _plan(fault: str, policy: str) -> FaultPlan:
    if fault == "node_loss":
        return FaultPlan.node_loss([(NODE_LOSS_STEP, DEAD_NODE[policy])])
    if fault == "lane_degrade":
        s, d, f = LANE_WINDOW
        return FaultPlan.lane_degrade(s, d, nvlink_factor=f, fabric_factor=f)
    assert fault == "spill_fail"
    return FaultPlan.spill_failure(0, 10_000)


def _stats(res) -> dict:
    agg = {}
    for pe in res.per_engine.values():
        for k, v in pe["stats"].items():
            agg[k] = agg.get(k, 0) + v
    return agg


def _extra(res, key: str) -> int:
    out = 0
    for pe in res.per_engine.values():
        rep = pe["um_report"]
        if rep is not None:
            out += int(rep["traffic_extra"].get(key, 0))
    return out


def _cell(scenario: str, sc, fault: str, policy: str, clean, *,
          hw, tp, device) -> dict:
    """One faulted run, pinned bit-identical to its clean twin."""
    t0 = time.perf_counter()
    res = TrafficSim(sc, policy=policy, hw=hw, seed=SEED, tp=tp,
                     fault_plan=_plan(fault, policy), device=device).run()
    wall = time.perf_counter() - t0
    key = f"{scenario}/{fault}/{policy}"
    bit_identical = 0
    for rk, stream in clean.tokens.items():
        if get_config(rk.split("/")[0]).is_moe:
            # capacity routing is batch-shape-dependent: a replay changes
            # batch composition, so MoE pins length + completion only
            assert len(res.tokens[rk]) == len(stream), \
                f"{key}: {rk} stream length changed across the fault"
        else:
            assert res.tokens[rk] == stream, \
                f"{key}: {rk} tokens diverged from the fault-free run"
            bit_identical += 1
    assert all(r.done for r in res.records), \
        f"{key}: a request never completed after the fault"
    st = _stats(res)
    m, mc = res.metrics, clean.metrics
    ttft_inflation = (m["ttft"]["p99"] / mc["ttft"]["p99"]
                      if mc["ttft"]["p99"] > 0 else 1.0)
    return {"kind": "fault_serve", "scenario": scenario, "fault": fault,
            "policy": policy, "tp": tp,
            "goodput_tok_s": m["goodput_tok_s"],
            "goodput_clean_tok_s": mc["goodput_tok_s"],
            "ttft_p99": m["ttft"]["p99"],
            "ttft_p99_inflation": ttft_inflation,
            "completed": m["completed"],
            "recovered_requests": st.get("recovered_requests", 0),
            "replayed_tokens": st.get("replayed_tokens", 0),
            "spill_failures": st.get("spill_failures", 0),
            "node_losses": st.get("node_losses", 0),
            "lane_degraded_steps": st.get("lane_degraded_steps", 0),
            "admission_retries": st.get("admission_retries", 0),
            "lost_pages": _extra(res, "lost_pages"),
            "lost_bytes": _extra(res, "lost_bytes"),
            "degraded_nvlink_bytes": _extra(res, "degraded_nvlink_bytes"),
            "degraded_fabric_bytes": _extra(res, "degraded_fabric_bytes"),
            "bit_identical_requests": bit_identical,
            "total_requests": len(clean.tokens), "wall_s": wall}


def run(device=None):
    """The fault grid on ``device`` (the CUDA card by default)."""
    device = resolve_device(device)
    smoke = os.environ.get("FAULT_SMOKE") == "1"
    scale = 0.25 if smoke else 1.0
    floors = _floors()
    rows, failures = [], []

    for scenario in SCENARIOS:
        sc = get_scenario(scenario, scale)
        for policy in POLICIES:
            clean = TrafficSim(sc, policy=policy, hw="gh200_x2", seed=SEED,
                               tp=2, device=device).run()
            for fault in ("node_loss", "lane_degrade"):
                row = _cell(scenario, sc, fault, policy, clean,
                            hw="gh200_x2", tp=2, device=device)
                rows.append(row)
                key = f"{scenario}/{fault}/{policy}"
                emit(f"fault/{key}", row["ttft_p99"] * 1e6,
                     f"goodput_tok_s={row['goodput_tok_s']:.0f},"
                     f"recovered={row['recovered_requests']},"
                     f"replayed={row['replayed_tokens']}")
                floor = floors.get(key)
                if floor is not None and row["goodput_tok_s"] < floor:
                    failures.append(
                        f"{key}: goodput {row['goodput_tok_s']:.0f} tok/s "
                        f"< floor {floor:.0f}")

    # single-node spill-failure cell on the preemption-heavy burst shape
    sc = get_scenario("burst", scale)
    clean = TrafficSim(sc, policy="system", seed=SEED, device=device).run()
    row = _cell("burst", sc, "spill_fail", "system", clean, hw=None, tp=1,
                device=device)
    rows.append(row)
    emit("fault/burst/spill_fail/system", row["ttft_p99"] * 1e6,
         f"goodput_tok_s={row['goodput_tok_s']:.0f},"
         f"spill_failures={row['spill_failures']},"
         f"replayed={row['replayed_tokens']}")
    floor = floors.get("burst/spill_fail/system")
    if floor is not None and row["goodput_tok_s"] < floor:
        failures.append(f"burst/spill_fail/system: goodput "
                        f"{row['goodput_tok_s']:.0f} tok/s < floor {floor:.0f}")

    # the artifact must prove the faults really hit
    assert sum(r["replayed_tokens"] for r in rows) > 0, \
        "no cell replayed any tokens — the node losses never hit live KV"
    assert sum(r["degraded_nvlink_bytes"] + r["degraded_fabric_bytes"]
               for r in rows) > 0, \
        "no cell counted degraded-lane bytes — the windows never overlapped traffic"

    if failures:
        raise SystemExit("FAULT_FLOOR violated:\n  " + "\n  ".join(failures))

    write_json("fault", {"rows": rows}, hardware="gh200_x2",
               policies=POLICIES + ("system",),
               extra_meta={"scenarios": list(SCENARIOS),
                           "node_loss_step": NODE_LOSS_STEP,
                           "lane_window": list(LANE_WINDOW),
                           "seed": SEED, "smoke": smoke})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)
    header()
    run(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
