"""Multi-superchip scaling of the distributed unified pool (the port of
``benchmarks/cluster_scaling.py``).

Two experiment families over the cluster subsystem
(``src/repro_torch/cluster/``):

* **Oversubscription sweep** (fig. 11 style, scaled out): each app's
  device working set is squeezed to ``peak / ratio`` across N = 1/2/4
  superchips (``gh200_cluster(n).with_device_capacity``, keeping the
  per-node split consistent), under both node-aware backends. Reported
  per cell: modeled time, remote-access share and the inter-node
  NVLink/fabric byte totals.
* **TP serving** (the traffic harness): the ``steady`` scenario served
  with tensor parallelism over 2 and 4 superchips. Each TP run asserts
  its generated tokens equal the single-node run of the same schedule
  (the cluster plan only adds modeled time), then reports goodput, TTFT
  and the all-reduce/inter-node byte counters.

The rows are modeled charges: equal to the JAX module's on any device.

    PYTHONPATH=src python -m repro_torch.bench.cluster_scaling [--device cpu]
    PYTHONPATH=src python -m repro_torch.bench.cluster_scaling --apps srad,bfs

Env:
  CLUSTER_SMOKE=1  shrink the workload (small preset, scale 0.25, TP 2)
  CLUSTER_FLOOR    'scenario/tpN/policy=TOKS_PER_S,...': fail the run if
                   a TP-serving cell's modeled goodput drops below its floor

Writes BENCH_cluster.json to ``repro_torch.bench.common.json_dir()`` with
the link topology under ``_meta``.
"""
import argparse
import os
import sys
import time

from repro_torch.apps import run_app
from repro_torch.bench.common import emit, header, write_json
from repro_torch.cluster import ClusterTopology, gh200_cluster
from repro_torch.kernels.common import resolve_device
from repro_torch.serve import TrafficSim, get_scenario

KB = 1024

SEED = 0
POLICIES = ("cluster_system", "cluster_striped")
NODE_COUNTS = (1, 2, 4)
RATIOS = (1.0, 1.5, 2.0)


def _floors() -> dict:
    spec = os.environ.get("CLUSTER_FLOOR", "")
    out = {}
    for item in spec.split(","):
        if item.strip():
            key, floor = item.split("=")
            out[key.strip()] = float(floor)
    return out


def _lanes(report: dict) -> dict:
    extra = report.get("traffic_extra", {})
    return {"internode_nvlink_bytes": int(extra.get("internode_nvlink_bytes", 0)),
            "internode_fabric_bytes": int(extra.get("internode_fabric_bytes", 0))}


# ------------------------------------------------------ oversubscription sweep
def sweep(apps, preset: str, ratios, device) -> list:
    rows = []
    for app in apps:
        # roomy measuring run: the app's allocation footprint (every
        # non-harness buffer it ever created) sets the squeeze
        roomy = run_app(app, "cluster_system", preset=preset,
                        page_size=4 * KB, hw=gh200_cluster(1), device=device)
        peak = sum(a["nbytes"]
                   for name, a in roomy.report["allocations"].items()
                   if not name.startswith("__"))
        for nodes in NODE_COUNTS:
            for ratio in ratios:
                hw = gh200_cluster(nodes).with_device_capacity(
                    int(peak / ratio))
                for policy in POLICIES:
                    r = run_app(app, policy, preset=preset,
                                page_size=4 * KB, hw=hw, device=device)
                    t = r.time_excluding_cpu_init()
                    row = {"kind": "sweep", "app": app, "nodes": nodes,
                           "ratio": ratio, "policy": policy, "time_s": t,
                           "remote_share": r.report["remote_access_share"],
                           **_lanes(r.report)}
                    rows.append(row)
                    emit(f"cluster/{app}/x{nodes}/oversub{ratio}/{policy}",
                         t * 1e6,
                         f"remote_share={row['remote_share']:.3f},"
                         f"nvlink_mb={row['internode_nvlink_bytes'] / 1e6:.1f}")
    return rows


# ------------------------------------------------------------------ TP serving
def tp_serve(scale: float, tps, floors: dict, device) -> list:
    rows, failures = [], []
    sc = get_scenario("steady", scale)
    base = TrafficSim(sc, policy="system", seed=SEED, device=device).run()
    for tp in tps:
        hw = f"gh200_x{tp}"
        for policy in POLICIES:
            t0 = time.perf_counter()
            res = TrafficSim(sc, policy=policy, hw=hw, seed=SEED,
                             tp=tp, device=device).run()
            wall = time.perf_counter() - t0
            assert res.tokens == base.tokens, \
                f"steady/tp{tp}/{policy}: TP tokens diverged from the " \
                "single-node run of the same schedule"
            m = res.metrics
            lanes = {}
            allreduce = 0
            for pe in res.per_engine.values():
                rep = pe["um_report"]
                if rep is not None:
                    for k, v in _lanes(rep).items():
                        lanes[k] = lanes.get(k, 0) + v
                    allreduce += int(rep["traffic_extra"].get(
                        "tp_allreduce_bytes", 0))
            row = {"kind": "tp_serve", "scenario": "steady", "tp": tp,
                   "policy": policy, "goodput_tok_s": m["goodput_tok_s"],
                   "ttft_p50": m["ttft"]["p50"],
                   "tokens_match_single_node": True,
                   "tp_allreduce_bytes": allreduce, "wall_s": wall, **lanes}
            rows.append(row)
            key = f"steady/tp{tp}/{policy}"
            emit(f"cluster/{key}", m["ttft"]["p50"] * 1e6,
                 f"goodput_tok_s={m['goodput_tok_s']:.0f},"
                 f"allreduce_mb={allreduce / 1e6:.1f}")
            floor = floors.get(key)
            if floor is not None and m["goodput_tok_s"] < floor:
                failures.append(f"{key}: goodput {m['goodput_tok_s']:.0f} "
                                f"tok/s < floor {floor:.0f}")
    if failures:
        raise SystemExit("CLUSTER_FLOOR violated:\n  " + "\n  ".join(failures))
    return rows


def run(apps="srad,qiskit", device=None):
    """Both experiment families on ``device`` (the CUDA card by default)."""
    device = resolve_device(device)
    smoke = os.environ.get("CLUSTER_SMOKE") == "1"
    preset = "small" if smoke else "fig11"
    ratios = (1.5,) if smoke else RATIOS
    scale = 0.25 if smoke else 1.0
    tps = (2,) if smoke else (2, 4)

    rows = sweep([a.strip() for a in apps.split(",") if a.strip()],
                 preset, ratios, device)
    rows += tp_serve(scale, tps, _floors(), device)

    topo = ClusterTopology()
    write_json("cluster", {"rows": rows},
               hardware=",".join(f"gh200_x{n}" for n in NODE_COUNTS),
               policies=POLICIES,
               extra_meta={"topology": {
                   "node_counts": list(NODE_COUNTS),
                   "nvlink_bw": topo.nvlink_bw,
                   "nvlink_latency": topo.nvlink_latency,
                   "fabric_bw": topo.fabric_bw,
                   "fabric_latency": topo.fabric_latency}})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--apps", default="srad,qiskit",
                    help="comma list of apps for the oversubscription sweep "
                         "(GPU-init apps show the device-pool squeeze; "
                         "CPU-init apps live on host either way)")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)
    header()
    run(args.apps, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
