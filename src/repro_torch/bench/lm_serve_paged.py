"""Production traffic through the UM-backed serve engine (the port of
``benchmarks/lm_serve_paged.py``).

The scenario presets of ``repro_torch.serve.traffic`` (seeded
Poisson/bursty arrivals, heavy-tail prompt/output lengths, multi-tenant
mixes over yi-6b / qwen2.5-32b / olmoe-1b-7b, reduced) run under every
registered memory-policy backend that can back the KV pool. Per (scenario,
policy, tenant) it reports the SLO metrics of ``repro_torch.serve.metrics``
(p50/p99 TTFT, TPOT, goodput under preemption) and the remote-access share
of KV reads. These are modeled times: the rows equal the JAX module's
(but ``wall_s``) on any device.

The ``oversubscribed`` scenario also asserts that its tokens equal an
in-memory (1.0x) run of the same schedule.

    PYTHONPATH=src python -m repro_torch.bench.lm_serve_paged [--device cpu]
        [--scenario NAME] [--policies system,managed]

Env:
  LM_SERVE_SMOKE=1   shrink the workload (scale 0.5)
  LM_SERVE_FLOOR     'scenario/policy=TOKS_PER_S,...': fail the run if a
                     cell's modeled goodput drops below its floor

Writes BENCH_lmserve.json to ``repro_torch.bench.common.json_dir()``.
"""
import argparse
import dataclasses
import os
import sys
import time

from repro_torch.bench.common import emit, header, write_json
from repro_torch.core import available_policies, get_hardware
from repro_torch.kernels.common import resolve_device
from repro_torch.serve import SCENARIOS, TrafficSim, get_scenario, policy_supports

SEED = 0


def _floors() -> dict:
    spec = os.environ.get("LM_SERVE_FLOOR", "")
    out = {}
    for item in spec.split(","):
        if item.strip():
            key, floor = item.split("=")
            out[key.strip()] = float(floor)
    return out


def _run_cell(scenario_name: str, policy: str, scale: float, hw,
              device) -> dict:
    """One (scenario, policy) traffic run -> JSON-able result row."""
    sc = get_scenario(scenario_name, scale)
    sim = TrafficSim(sc, policy=policy, hw=hw, seed=SEED, device=device)
    t0 = time.perf_counter()
    res = sim.run()
    wall = time.perf_counter() - t0

    if sc.oversub > 1.0:
        # token identity vs the in-memory run of the SAME schedule
        flat = dataclasses.replace(sc, oversub=1.0)
        base = TrafficSim(flat, policy=policy, hw=hw, seed=SEED,
                          device=device).run()
        assert res.tokens == base.tokens, \
            f"{scenario_name}/{policy}: oversubscribed tokens diverged " \
            "from the in-memory run"

    m = res.metrics
    remote = 0.0
    preempted = 0
    for pe in res.per_engine.values():
        preempted += pe["stats"]["preempted"]
        if pe["um_report"] is not None:
            remote = max(remote, pe["um_report"]["remote_access_share"])
    row = {
        "tokens": m["tokens"],
        "completed": m["completed"],
        "goodput_tok_s": m["goodput_tok_s"],
        "ttft_p50": m["ttft"]["p50"],
        "ttft_p99": m["ttft"]["p99"],
        "tpot_p50": m["tpot"]["p50"],
        "tpot_p99": m["tpot"]["p99"],
        "preempted": preempted,
        "remote_share_max": remote,
        "wall_s": wall,
        "tenants": {t: {"ttft_p50": tm["ttft"]["p50"],
                        "ttft_p99": tm["ttft"]["p99"],
                        "tpot_p50": tm["tpot"]["p50"],
                        "goodput_tok_s": tm["goodput_tok_s"],
                        "tokens": tm["tokens"]}
                    for t, tm in m["tenants"].items()},
    }
    emit(f"lm_serve/{scenario_name}/{policy}",
         m["ttft"]["p99"] * 1e6,
         f"tokens={m['tokens']};goodput_tok_s={m['goodput_tok_s']:.0f};"
         f"ttft_p50_us={m['ttft']['p50'] * 1e6:.2f};"
         f"tpot_p99_us={m['tpot']['p99'] * 1e6:.2f};"
         f"preempted={preempted};remote_share={remote:.3f};"
         f"wall_s={wall:.2f}")
    for t, tm in m["tenants"].items():
        emit(f"lm_serve/{scenario_name}/{policy}/{t}",
             tm["ttft"]["p99"] * 1e6,
             f"tokens={tm['tokens']};goodput_tok_s={tm['goodput_tok_s']:.0f};"
             f"ttft_p50_us={tm['ttft']['p50'] * 1e6:.2f}")
    return row


def run(scenarios=None, policies=None, *, policy=None, hw=None, device=None):
    """Run the scenario x policy grid on ``device`` (the CUDA card by
    default). ``policy``/``hw`` are the runner's single-backend overrides
    (--policy/--hw)."""
    device = resolve_device(device)
    smoke = bool(os.environ.get("LM_SERVE_SMOKE"))
    scale = 0.5 if smoke else 1.0
    scenarios = list(scenarios or sorted(SCENARIOS))
    if policy is not None:
        policies = [policy]
    if policies is None:
        policies = [p for p in available_policies()
                    if policy_supports(p, get_scenario("steady"))]

    results, failures = {}, []
    floors = _floors()
    for name in scenarios:
        sc = get_scenario(name)
        for pol in policies:
            if not policy_supports(pol, sc):
                print(f"# lm_serve: skipping {name}/{pol} "
                      f"(backend cannot run this scenario)")
                continue
            key = f"{name}/{pol}"
            results[key] = _run_cell(name, pol, scale, hw, device)
            floor = floors.get(key)
            if floor is not None and results[key]["goodput_tok_s"] < floor:
                failures.append(
                    f"{key}: {results[key]['goodput_tok_s']:.0f} modeled "
                    f"tok/s < floor {floor:.0f}")
    write_json("lmserve", results,
               hardware=get_hardware(hw).name, policies=policies)
    if failures:
        for f in failures:
            print(f"FLOOR VIOLATION: {f}", file=sys.stderr)
        raise RuntimeError("lm_serve goodput floor violated")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scenario", action="append", default=None,
                    metavar="NAME", choices=sorted(SCENARIOS),
                    help="scenario preset(s) to run (default: all); "
                         "repeatable")
    ap.add_argument("--policies", default=None,
                    help="comma-separated registry backends (default: every "
                         "backend that can back the KV pool)")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)
    policies = args.policies.split(",") if args.policies else None
    header()
    run(args.scenario, policies, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
