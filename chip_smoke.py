#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``. It builds the CUDA kernels from
``src/repro_torch/csrc``, holds each against its plain PyTorch version on the
card, drives hotspot, srad and qiskit at full size through the kernels
(counting each kernel's launches), holds the apps' card results against the
CPU on small shared inputs and their charges against the parity fixture,
times each kernel at its main-path shape, and prints:

* one JSON line per phase;
* ``{"kernels": [...]}``: each kernel's launches on the main path, largest
  error against its plain version at the main path's size, time, plain time,
  library time (where one PyTorch call computes the same) and least possible
  time;
* the card's name and power limit, as ``nvidia-smi`` gives them;
* last, ``{"ok": true, "device": {...}}``.

A phase that fails raises, and the script exits non-zero without the last
line. Without a CUDA card it exits non-zero at once.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 non-tensor flop/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

HOTSPOT = dict(rows=16384, cols=16384, iters=8)
SRAD = dict(rows=16384, cols=16384, iters=12)
QISKIT = dict(n_qubits=31)  # default depth 7: 105 gates on 16 GiB

STENCIL_SHAPES = [(16384, 16384), (1000, 777), (1, 513), (513, 1)]
STENCIL_TOL = 1e-5  # abs, unit-normal input; the kernel keeps the plain order
QV_N = 24
QV_PAIRS = [(0, 1), (1, 0), (23, 0), (5, 17), (17, 5)]
QV_TOL = 1e-5       # abs on a unit-norm state, and on the norm itself
# the main path's size, pairs that touch the top bit; error relative to the
# largest amplitude (a typical one is 2^-15.5 here), norm change absolute
QV_MAIN_PAIRS = [(30, 0), (0, 30), (5, 17), (17, 5), (0, 1)]
QV_MAIN_RTOL = 1e-5
QISKIT_NORM_TOL = 1e-3
SMALL_RTOL = 1e-5   # card vs CPU checksums on shared small inputs

PARITY_FIXTURE = ROOT / "tests" / "fixtures" / "parity.json"


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def median_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of ``fn()`` over ``reps`` runs, from CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def random_state(n: int, gen: torch.Generator) -> torch.Tensor:
    st = torch.randn(1 << n, dtype=torch.complex64, device="cuda",
                     generator=gen)
    return st.div_(torch.linalg.vector_norm(st))


def phase_build():
    from repro_torch.kernels.common import library

    lib = library()
    report = [ln.strip() for ln in lib.ptxas_report.splitlines()
              if "Compiling entry" in ln or "Used" in ln]
    emit("build", seconds=lib.build_seconds,
         libraries=[p.name for p in lib.paths], ptxas=report)


def phase_kernels_vs_plain() -> dict:
    from repro_torch.apps.qsim import _random_su4
    from repro_torch.kernels.qv_gate import (
        apply_two_qubit_gate,
        apply_two_qubit_gate_ref,
    )
    from repro_torch.kernels.stencil5 import stencil5, stencil5_ref

    gen = torch.Generator("cuda").manual_seed(0)
    errs = {"stencil5": 0.0, "qv_gate": 0.0}
    rows = []
    for shape in STENCIL_SHAPES:
        g = torch.randn(shape, device="cuda", generator=gen)
        out = stencil5(g, 0.1)
        torch.cuda.synchronize()
        err = float((out - stencil5_ref(g, 0.1)).abs().max())
        check(err <= STENCIL_TOL, f"stencil5 {shape} err {err}")
        errs["stencil5"] = max(errs["stencil5"], err)
        rows.append(dict(kernel="stencil5", shape=list(shape),
                         max_abs_err=err, tol=STENCIL_TOL))
        del g, out
    rng = np.random.default_rng(0)
    st = random_state(QV_N, gen)
    for q1, q2 in QV_PAIRS:
        gate = _random_su4(rng)
        out = apply_two_qubit_gate(st.clone(), gate, q1, q2, QV_N)
        torch.cuda.synchronize()
        err = float((out - apply_two_qubit_gate_ref(st, gate, q1, q2, QV_N))
                    .abs().max())
        norm_err = abs(float(torch.linalg.vector_norm(out)) - 1.0)
        check(err <= QV_TOL, f"qv_gate {(q1, q2)} err {err}")
        check(norm_err <= QV_TOL, f"qv_gate {(q1, q2)} norm err {norm_err}")
        rows.append(dict(kernel="qv_gate", n_qubits=QV_N, pair=[q1, q2],
                         max_abs_err=err, norm_err=norm_err, tol=QV_TOL))
    del st, out

    # the main path's size: the plain result first, then the kernel in place
    # on the same state, so the card holds two statevectors and temporaries
    n = QISKIT["n_qubits"]
    st = random_state(n, gen)
    for q1, q2 in QV_MAIN_PAIRS:
        gate = _random_su4(rng)
        want = apply_two_qubit_gate_ref(st, gate, q1, q2, n)
        tol = QV_MAIN_RTOL * float(want.abs().max())
        norm0 = float(torch.linalg.vector_norm(st))
        apply_two_qubit_gate(st, gate, q1, q2, n)
        torch.cuda.synchronize()
        err = float(want.sub_(st).abs().max())
        norm_err = abs(float(torch.linalg.vector_norm(st)) - norm0)
        del want
        check(err <= tol, f"qv_gate n={n} {(q1, q2)} err {err} > {tol}")
        check(norm_err <= QV_TOL,
              f"qv_gate n={n} {(q1, q2)} norm err {norm_err}")
        errs["qv_gate"] = max(errs["qv_gate"], err)
        rows.append(dict(kernel="qv_gate", n_qubits=n, pair=[q1, q2],
                         max_abs_err=err, tol=tol, norm_err=norm_err,
                         norm_tol=QV_TOL))
    del st
    torch.cuda.empty_cache()
    emit("kernel_vs_plain", checks=rows)
    return errs


def phase_apps() -> dict:
    """The main path: each app at full size on the card, with every launch
    counter set to 0 just before it and read just after."""
    from repro_torch.apps import run_hotspot, run_qsim, run_srad
    from repro_torch.kernels.qv_gate import apply_two_qubit_gate
    from repro_torch.kernels.stencil5 import stencil5

    counters = {"stencil5": stencil5, "qv_gate": apply_two_qubit_gate}
    total = dict.fromkeys(counters, 0)
    rows = []
    runs = [("hotspot", run_hotspot, HOTSPOT, "stencil5"),
            ("srad", run_srad, SRAD, "stencil5"),
            ("qiskit", run_qsim, QISKIT, "qv_gate")]
    for name, run, kw, kernel in runs:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        r = run("system", device="cuda", **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        check(launches[kernel] > 0, f"{name} never launched {kernel}")
        check(math.isfinite(r.checksum), f"{name} checksum {r.checksum}")
        if name == "qiskit":
            check(abs(r.checksum - 1.0) <= QISKIT_NORM_TOL,
                  f"qiskit norm {r.checksum}")
        for k, n in launches.items():
            total[k] += n
        rows.append(dict(app=name, sizes=kw, policy="system",
                         compute_ms_on_card=r.extra["compute_ms"], wall_s=wall,
                         modeled_phase_s=r.phase_times, checksum=r.checksum,
                         launches=launches,
                         peak_device_bytes=torch.cuda.max_memory_allocated()))
        del r
    emit("apps", runs=rows)
    return total


def phase_small_vs_cpu() -> None:
    """The same small inputs through the card and the CPU (plain versions)."""
    from repro_torch.apps import APPS

    rng = np.random.default_rng(1)
    rows = []
    for name, spec in APPS.items():
        kw = dict(spec.sizes["small"])
        if name == "hotspot":
            shape = (kw["rows"], kw["cols"])
            kw.update(temp0=300.0 + 50.0 * rng.random(shape, np.float32),
                      power=rng.random(shape, np.float32))
        elif name == "srad":
            kw.update(img=rng.random((kw["rows"], kw["cols"]), np.float32))
        card = spec.run("system", device="cuda", **kw).checksum
        cpu = spec.run("system", device="cpu", **kw).checksum
        check(math.isclose(card, cpu, rel_tol=SMALL_RTOL),
              f"{name} card {card} vs cpu {cpu}")
        rows.append(dict(app=name, card=card, cpu=cpu, rtol=SMALL_RTOL))
    emit("small_vs_cpu", checks=rows)


def phase_parity() -> None:
    from repro_torch.apps import APPS, charge_snapshot

    fixture = json.loads(PARITY_FIXTURE.read_text())
    keys = []
    for name in ("hotspot", "srad", "qiskit"):
        for pol in ("explicit", "managed", "system"):
            key = f"fig3/{name}/{pol}"
            got = charge_snapshot(APPS[name].run(pol, device="cuda",
                                                 **APPS[name].sizes["fig3"]))
            check(got == fixture[key], f"{key} charges differ from fixture")
            keys.append(key)
    emit("parity", configs=keys, bit_identical=True)


def phase_timing() -> dict:
    """Each kernel and its plain version at the main path's shape."""
    from repro_torch.apps.qsim import _random_su4
    from repro_torch.kernels.qv_gate import (
        apply_two_qubit_gate,
        apply_two_qubit_gate_ref,
    )
    from repro_torch.kernels.stencil5 import stencil5, stencil5_ref

    gen = torch.Generator("cuda").manual_seed(1)
    out = {}
    H, W = HOTSPOT["rows"], HOTSPOT["cols"]
    g = torch.randn((H, W), device="cuda", generator=gen)
    b, by = bound_ms(8.0 * H * W, 7.0 * H * W)
    # no single PyTorch call does a 5-point stencil with replicated edges
    out["stencil5"] = dict(
        shape=[H, W], ms=median_ms(lambda: stencil5(g, 0.1), 20),
        plain_ms=median_ms(lambda: stencil5_ref(g, 0.1), 5),
        bound_ms=b, bound_by=by, library_ms=None)
    del g
    torch.cuda.empty_cache()

    n = QISKIT["n_qubits"]
    st = random_state(n, gen)
    gate = _random_su4(np.random.default_rng(1))
    b, by = bound_ms(16.0 * (1 << n), 32.0 * (1 << n))
    # the library call: the plain version's one einsum over views of the
    # state as (A, 2, B, 2, C) and of the gate as (2, 2, 2, 2), q1 = 5 < q2
    psi = st.view(1 << (n - 18), 2, 1 << 11, 2, 1 << 5)
    g4 = gate.to("cuda", torch.complex64).reshape(2, 2, 2, 2)
    out["qv_gate"] = dict(
        shape=[1 << n],
        ms=median_ms(lambda: apply_two_qubit_gate(st, gate, 5, 17, n), 10),
        plain_ms=median_ms(
            lambda: apply_two_qubit_gate_ref(st, gate, 5, 17, n), 3, warmup=1),
        bound_ms=b, bound_by=by,
        library_ms=median_ms(
            lambda: torch.einsum("jilk,akblc->aibjc", g4, psi), 3, warmup=1))
    del st, psi
    torch.cuda.empty_cache()
    emit("timing", kernels=out)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    phase_build()
    errs = phase_kernels_vs_plain()
    launches = phase_apps()
    phase_small_vs_cpu()
    phase_parity()
    times = phase_timing()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    meta = {
        "stencil5": ("src/repro_torch/csrc/stencil5.cu",
                     "src/repro/kernels/stencil5/stencil5.py:33"),
        "qv_gate": ("src/repro_torch/csrc/qv_gate.cu",
                    "src/repro/kernels/qv_gate/qv_gate.py:35"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": t["shape"], "card": smi})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
