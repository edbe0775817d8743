"""One run of one cell: set-up, the measured window, the check, the
result line.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration file and traffic file (the paths the cell's config and
traffic name), the model module its configuration file names
(``model.py``), its limits in ``limits/<cell>.json`` and each metric's
reader in ``metrics/<name>.py``.
"""
from __future__ import annotations

import gc
import json
import sys
import time
from pathlib import Path
from typing import Callable, Optional

import torch

from cardbench.lib import check, metrics, model as models, serve, stats, trace
from cardbench.lib import window as wnd

HERE = Path(__file__).resolve().parent.parent
TRACE_A_SECONDS = 6.0  # stretch A (device only), the window's last seconds
TRACE_B_SECONDS = 2.0  # stretch B (host and device), after the window


def load(root: Path, workload: str) -> dict:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: "
                         f"{', '.join(sorted(cells))}")
    cell = cells[workload]
    cfgs = {c["name"]: c for c in bench["configs"]}
    cfg_file = json.loads((root / cfgs[cell["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    lim = HERE / "limits" / f"{workload}.json"
    limits = json.loads(lim.read_text()) if lim.exists() else {}
    return {"bench": bench, "cell": cell, "cfg_file": cfg_file,
            "traffic": traffic, "limits": limits}


def run_cell(spec: dict, seed: int, seconds: float, traced: bool,
             t_start: float, device="cuda",
             prepare: Optional[Callable] = None, control: bool = False,
             readings: bool = False, log=print) -> dict:
    """The run; returns the result line's dict (``checks`` last).
    ``prepare(model, engine)`` may change the program before the load (the
    tests plant faults with it); ``readings`` adds every number the check
    read, ``control`` the control's too."""
    cfg_file, traffic, cell = spec["cfg_file"], spec["traffic"], spec["cell"]
    cuda = torch.device(device).type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg_file.get("tf32", False))
    torch.backends.cudnn.allow_tf32 = bool(cfg_file.get("tf32", False))

    marks = {"imports": time.perf_counter() - t_start}
    sd = models.make_weights(cfg_file, seed, device)
    _sync(cuda)
    marks["weights"] = time.perf_counter() - t_start
    model, eng = serve.build_engine(cfg_file, sd, device)
    del sd
    _sync(cuda)
    marks["engine"] = time.perf_counter() - t_start
    if prepare is not None:
        prepare(model, eng)
    serve.warm_up(eng, cfg_file, seed, traffic.get("warm_decode_sizes"))
    marks["warm_up"] = time.perf_counter() - t_start
    sess = serve.Session(eng, traffic, seed, cfg_file["arch"]["vocab_size"])
    tracer = None
    if traced:
        trace.prime()
        tracer = trace.Tracer(model, min(TRACE_A_SECONDS, seconds),
                              TRACE_B_SECONDS)
        sess.on_step, sess.step_ctx = tracer.on_step, tracer.step_ctx
        sess.hold = tracer.busy
    sess.capture(model)
    marks["capture"] = time.perf_counter() - t_start
    opened = {}
    sess.run(seconds, on_open=lambda s: opened.setdefault(
        "setup_s", time.perf_counter() - t_start))
    sess.release()
    summary = None
    if tracer is not None:
        tracer.stop(sess)
        summary = tracer.read()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    um = eng.um.report()
    log(json.dumps({"modeled": {
        "hardware": "GRACE_HOPPER charge model", "clock_s": eng.um.clock,
        "traffic_total": um.get("traffic_total"),
        "remote_access_share": um.get("remote_access_share")}}, default=str))
    served = {rid: list(r.generated) for rid, r in eng.requests.items()
              if rid in sess.reqs}
    # the program's state goes before the reference runs
    sess.eng = None
    del eng, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    view = metrics.RunView(cell, cfg_file, traffic, sess, opened["setup_s"],
                           peak, summary)
    ours = metrics.for_cell(spec["bench"], cell["name"], traced)
    result_metrics = metrics.compute(ours, view)
    info = metrics.compute(metrics.for_cell(spec["bench"], cell["name"], False),
                           view) if traced else {}
    t_ref = time.perf_counter()
    verdict = check.judge(cfg_file, sess, served, seed, device,
                          spec["limits"], control=control)
    marks["reference_s"] = time.perf_counter() - t_ref
    due = sess.due_in_window()
    failed = sum(1 for q in due if q.done_t is not None
                 and len(served[q.rid]) != q.max_new)
    log(json.dumps({"window": {
        "seconds": view.window_s, "setup_marks_s": marks,
        "steps": len(
            [s for s in sess.steps if s.t0 >= sess.t_open]),
        "requests_due": len(due), "setup_s": view.setup_s,
        # how late the generator handed a request to the engine
        "generator_late_ms_max": max(
            [(q.added - q.due) * 1e3 for q in due], default=None),
        # read, not judged: the open loop's queueing (PERF.md section 2)
        "ttft_p90_ms": stats.percentile(wnd.ttfts_ms(view), 90),
        "queue_wait_p50_ms": stats.percentile(wnd.queue_waits_ms(view), 50),
        "pages_in_use_max": sess.pages_max,
        "pool_pages": cfg_file["engine"]["num_pages"],
        "preempted": sum(st.stats["preempted"] for st in wnd.window_steps(view)),
        "capture_host_s": sess.capture_host_s, "gc_s": sess.gc_s,
        "judged_requests": verdict["judged_requests"],
        "judged_tokens": verdict["judged_tokens"],
        "readings": verdict["readings"],
        "finished_per_s": sum(1 for q in sess.reqs.values() if q.done_t
                              and sess.t_open < q.done_t <= sess.t_end)
        / view.window_s,
        "untraced_metrics_of_traced_run": info,
        "trace_read_s": summary.read_s if summary else None,
        "trace": None if summary is None else {
            k: {"events": st.events, "notes": st.notes, "window_s": st.window_s,
                "busy_s": st.busy_s, "steps": st.steps, "ranges": st.ranges}
            for k, st in (("a", summary.a), ("b", summary.b)) if st is not None}}}))
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(cell.get("chips", 1)),
           "memory_peak_bytes": int(peak)}
    out = {"correct": verdict["correct"], "attempted": len(due),
           "failed": failed, "metrics": result_metrics, "device": dev}
    if summary is not None:
        dev["busy_s"], dev["window_s"] = summary.busy_s, summary.window_s
        out["breakdown"] = trace.breakdown(summary)
    if control or readings:
        out["readings"] = verdict["readings"]
    out["checks"] = verdict["checks"]
    return out


def _sync(cuda: bool) -> None:
    if cuda:
        torch.cuda.synchronize()


def report_checks(checks: dict, stream=sys.stderr) -> None:
    """Each compared number beside its limit, as the last lines (after why
    the states could not be compared, where they could not)."""
    if checks.get("state_uncaptured", {}).get("value"):
        print(check.UNCAPTURED, file=stream)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=stream)
