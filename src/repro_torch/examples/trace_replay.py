"""Trace capture/replay: record one app, re-charge it under other backends.

Records a small srad run under the system policy, then

  1. replays the trace with no overrides and checks the charges are
     bit-identical to the recorded run (the round-trip guarantee), and
  2. replays the same trace with ``--policy`` overrides (default:
     mi300a_unified) and diffs the re-charged totals against a native run
     of the app under that backend — trace-replay "what-if" without
     re-running the application math.

The app's math runs on ``--device`` (the CUDA card by default); the charges
do not depend on it. Exits non-zero on any charge mismatch.

    PYTHONPATH=src python -m repro_torch.examples.trace_replay
        [--device cpu] [--trace PATH] [--policy KIND ...]
"""
import argparse
import os
import sys
import tempfile

from repro_torch.apps import APPS, charge_snapshot
from repro_torch.core.trace import record_app, replay
from repro_torch.kernels.common import resolve_device


def fingerprint(um) -> dict:
    """charge_snapshot's sections, computed from a replayed runtime."""
    rep = um.report()
    return {
        "phase_times": {k: float(v).hex()
                        for k, v in sorted(um.prof.phase_times.items())},
        "traffic_total": {k: int(v)
                          for k, v in sorted(rep["traffic_total"].items())},
        "traffic_phases": {ph: {k: int(v) for k, v in sorted(tr.items())}
                           for ph, tr in sorted(rep["traffic"].items())},
    }


def diff(got: dict, want: dict, label: str) -> int:
    bad = 0
    for section in want:
        if got[section] != want[section]:
            print(f"MISMATCH {label}: {section}")
            print(f"  replayed: {got[section]}")
            print(f"  native:   {want[section]}")
            bad += 1
    if not bad:
        print(f"OK {label}: charges bit-identical")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default=os.path.join(tempfile.gettempdir(),
                                                    "srad_fig3.trace.gz"))
    ap.add_argument("--policy", nargs="*", default=["mi300a_unified"],
                    help="override backends to re-charge the trace under")
    ap.add_argument("--device", default=None,
                    help="torch device of the app's math; default: the CUDA card")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    kw = dict(APPS["srad"].sizes["small"])
    print(f"recording srad/system {kw} -> {args.trace}")
    native = record_app("srad", "system", args.trace, device=dev, **kw)

    failures = diff(fingerprint(replay(args.trace)), charge_snapshot(native),
                    "replay (no override) vs recorded run")
    for kind in args.policy:
        want = charge_snapshot(APPS["srad"].run(kind, device=dev, **kw))
        got = fingerprint(replay(args.trace, policy=kind))
        failures += diff(got, want, f"replay --policy {kind} vs native {kind}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
