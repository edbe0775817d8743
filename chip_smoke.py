#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``. It builds the CUDA kernels from
``src/repro_torch/csrc`` (and fails unless the bf16 flash kernels hold
``HGMMA`` tensor-core instructions and spill nothing), holds each against its
plain PyTorch version on the card (flash attention in bf16 on the tensor
cores, paged attention also at its chunk boundaries and at the MoE archs'
decode shapes), drives the port's main paths through the kernels, counting
each kernel's launches: the six paper apps at full size (hotspot, srad and
qiskit through their kernels; pathfinder, needle and bfs in plain torch),
paged-KV serving of full-width yi-6b and of full-width olmoe-1b-7b (8
requests each through ``ServeEngine``), the traffic harness (the burst
preset over the reduced configs, and a node loss on the two-superchip
cluster pool), and the benchmark harness (``repro_torch.bench.run``, whose
``kernels_micro`` launches every kernel, flash attention among them, with
the serving benchmarks at their smoke sizes). It holds the apps' card
results against the CPU on small shared inputs and their charges against
the parity fixture, the paged engine's tokens against the dense decode path
at full width (yi-6b and olmoe-1b-7b) and against the CPU on reduced yi-6b,
the traffic records and tokens against the CPU and the node-loss tokens
against the fault-free run, the harness's rows against the same modules on
the CPU, times each kernel at its main-path shape, and prints:

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
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 non-tensor and
# dense bf16 tensor-core flop/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12

HOTSPOT = dict(rows=16384, cols=16384, iters=8)
SRAD = dict(rows=16384, cols=16384, iters=12)
QISKIT = dict(n_qubits=31)  # default depth 7: 105 gates on 16 GiB
PATHFINDER = dict(rows=8192, cols=131072)  # 4 GiB int32 wall, 8191 DP rows
NEEDLE = dict(n=16384)                     # 1 GiB int32 similarity matrix
BFS = dict(n_nodes=1 << 24, deg=8)         # 512 MiB of edges

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

# paged attention: the three shapes of tests/test_kernels.py as
# (B, H, Hkv, D, P, PS, NP), then yi-6b's decode shape over the serve
# phase's 1025-page pool; fp32 and bf16 tolerances as that test's
PAGED_SHAPES = [(2, 8, 2, 64, 16, 16, 4), (3, 4, 4, 128, 32, 8, 6),
                (1, 16, 1, 64, 8, 32, 3)]
PAGED_MAIN = (8, 32, 4, 128, 1025, 16, 128)
PAGED_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# the split kernel's chunk boundaries at yi-6b's decode widths: one sequence
# each of 1, C - 1, C, C + 1 and NP * PS tokens (C = 64 tokens a chunk)
PAGED_SPLIT = (5, 32, 4, 128, 1025, 16, 128)
PAGED_MIN_BLOCKS = 132  # pass 1 at the decode shape fills the H100's SMs
# the MoE archs' decode shapes over the same pool: olmoe-1b-7b (MHA, 16 heads
# over 16, a group of 1, D 128) and granite-moe-3b-a800m (24 over 8, D 64)
PAGED_MOE = {"olmoe-1b-7b": (8, 16, 16, 128, 1025, 16, 128),
             "granite-moe-3b-a800m": (8, 24, 8, 64, 1025, 16, 128)}
# flash attention: the 16 cases of tests/test_kernels.py as
# (B, Sq, Sk, H, Hkv, D) x dtype x window, causal; Sq != Sk both ways; the
# non-causal cases of tests/test_torch_flash_attention.py as
# ((B, Sq, Sk, H, Hkv, D), window); then the full-width prefill shapes:
# yi-6b (causal) and recurrentgemma-2b's local attention (causal, window
# 2048), fp32 and bf16; tolerances as that test's. The harness's main path
# is kernels_micro's (1, 256, 256, 8, 2, 64).
FLASH_SHAPES = [(2, 256, 256, 8, 2, 64), (1, 512, 512, 4, 4, 128),
                (2, 128, 128, 16, 1, 64), (1, 256, 256, 6, 2, 128)]
FLASH_UNEVEN = [(1, 128, 256, 4, 2, 64), (1, 256, 128, 4, 2, 64),
                (1, 100, 77, 4, 1, 32), (1, 300, 300, 2, 1, 256)]
FLASH_WINDOWS = (0, 64)
FLASH_NONCAUSAL = [((2, 64, 192, 2, 1, 32), 0), ((1, 128, 256, 4, 2, 64), 64),
                   ((1, 256, 128, 4, 1, 128), 0)]
# rows i >= Sk + window - 1 see no key (the kernel gives them zeros), in a
# 64-row block whose other rows do see keys: (shape, window)
FLASH_MASKED = ((1, 300, 100, 4, 1, 64), 64)
FLASH_MICRO = (1, 256, 256, 8, 2, 64)
FLASH_FULL = {"yi-6b": ((1, 4096, 4096, 32, 4, 128), 0),
              "recurrentgemma-2b": ((1, 8192, 8192, 10, 1, 256), 2048)}
FLASH_TOL = PAGED_TOL
FLASH_BLOCK = 512  # q and kv block of the _blocked_causal cross-check
# the serving main path: full-width yi-6b, fp32, random weights from a seed
SERVE = dict(arch="yi-6b", max_seqs=8, max_len=2048, page_size=16,
             prefill_chunk=128, requests=8, prompt_lens=(200, 1000),
             new_tokens=32)
DENSE_CHECK = dict(prompt_len=64, new_tokens=8, max_len=128)
# the MoE serving main path: full-width olmoe-1b-7b (16 layers, d 2048, 64
# experts of d_ff 1024, top-8), fp32, random weights from a seed, under the
# same engine settings and prompts as yi-6b's
SERVE_MOE = dict(SERVE, arch="olmoe-1b-7b")
# one prompt that fits one prefill chunk: the paged engine and model.prefill
# then route the same T tokens, so their capacity drops are the same
MOE_DENSE_CHECK = dict(prompt_len=100, new_tokens=8, max_len=128)
# the traffic harness: the burst preset (preempt/swap churn) over the
# reduced configs, on the card and on the CPU with the same weights; then a
# node loss under cluster_system on gh200_x2 (tests/test_fault_serve.py's
# micro schedule) against its fault-free run on the card
TRAFFIC = dict(scenario="burst", seed=0, weights_seed=4)
FAULT = dict(seed=3, policy="cluster_system", hw="gh200_x2", tp=2,
             node_loss=[(4, 1)])
# a MoE token may also differ where a routing decision it depends on was
# within this much router probability of the next expert (a near-tie)
ROUTE_GAP_TOL = 1e-5
# the serving benchmarks run in the bench phase at their smoke sizes
BENCH_SMOKE = {"LM_SERVE_SMOKE": "1", "FAULT_SMOKE": "1", "CLUSTER_SMOKE": "1"}
BENCH_BY_NAME = ["repro_torch.bench.fault_serve",
                 "repro_torch.bench.cluster_scaling"]
# a token of the paged engine may differ from the dense path's only where
# the dense path's top-2 logit margin is below this share of max |logit|
MARGIN_RTOL = 1e-4
L2_FLUSH_BYTES = 256 << 20  # > the H100's 50 MB L2
WALL_FIELD = re.compile(r";?wall_s=[0-9.]+")  # host seconds in a CSV row

PARITY_FIXTURE = ROOT / "tests" / "fixtures" / "parity.json"


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def median_ms(fn, reps: int, warmup: int = 2, before=None,
              burst: int = 5) -> float:
    """Median device time of one ``fn()`` over ``reps`` timed runs, from
    CUDA events. A timed run is ``burst`` calls back to back, so the host's
    launch of one call overlaps the card's work on the one before; with
    ``before`` it is one call, and ``before()`` runs ahead of it, outside
    the events."""
    n = 1 if before is not None else burst
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if before is not None:
            before()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(n):
            fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / n)
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float,
             flop_per_s: float = FP32_FLOP_PER_S) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_inputs(shape, dtype, gen):
    """Random q (B,Sq,H,D) and k, v (B,Sk,Hkv,D) on the card."""
    B, Sq, Sk, H, Hkv, D = shape
    return (torch.randn(B, Sq, H, D, device="cuda", generator=gen).to(dtype),
            torch.randn(B, Sk, Hkv, D, device="cuda", generator=gen).to(dtype),
            torch.randn(B, Sk, Hkv, D, device="cuda", generator=gen).to(dtype))


def flash_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """The visible (query row, key) pairs of one head: the work the mask
    leaves."""
    qpos = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(qpos, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(qpos - window + 1, 0) if window > 0 else np.zeros(Sq, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def random_state(n: int, gen: torch.Generator) -> torch.Tensor:
    st = torch.randn(1 << n, dtype=torch.complex64, device="cuda",
                     generator=gen)
    return st.div_(torch.linalg.vector_norm(st))


def ptxas_entries(report: str, needle: str) -> dict:
    """{kernel: (registers, spill store bytes, spill load bytes)} of the
    entry functions whose mangled name holds ``needle``, from ptxas -v."""
    out, name = {}, None
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if needle in ln else None
            if name:
                out[name] = [None, None, None]
        elif name and "Used" in ln and "registers" in ln:
            out[name][0] = int(ln.split("Used")[1].split()[0])
        elif name and "spill stores" in ln:
            parts = ln.split(",")
            out[name][1] = int(parts[1].split()[0])
            out[name][2] = int(parts[2].split()[0])
    return {k: tuple(v) for k, v in out.items()}


def sass_counts(lib_path, needle: str, opcode: str) -> dict:
    """{kernel: count of ``opcode``} in the SASS of the entry functions of
    ``lib_path`` whose name holds ``needle`` (cuobjdump -sass)."""
    from repro_torch.kernels.common import _nvcc

    cuobjdump = Path(_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    out, name = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :")[1].strip()
            name = name if needle in name else None
            if name:
                out[name] = 0
        elif name and opcode in ln:
            out[name] += 1
    return out


def phase_build():
    """Build every kernel; the bf16 flash kernel must hold tensor-core
    instructions (HGMMA, Hopper's wgmma) and spill nothing."""
    from repro_torch.kernels.common import library
    from repro_torch.kernels.flash_attention.ops import SM90_HEAD_DIMS

    lib = library()
    report = [ln.strip() for ln in lib.ptxas_report.splitlines()
              if "Compiling entry" in ln or "Used" in ln]
    so = next(p for p in lib.paths if p.name.startswith("libflash_attention_sm90_"))
    hgmma = sass_counts(so, "flash_attention_sm90_kernel", "HGMMA")
    regs = ptxas_entries(lib.ptxas_report, "flash_attention_sm90_kernel")
    check(len(hgmma) == len(SM90_HEAD_DIMS)
          and all(n > 0 for n in hgmma.values()),
          f"HGMMA instructions in the bf16 flash kernels: {hgmma}")
    # an empty report means the libraries were loaded from an earlier build
    check(not regs or all(r[1] == 0 and r[2] == 0 for r in regs.values()),
          f"the bf16 flash kernels spill: {regs}")
    emit("build", seconds=lib.build_seconds,
         libraries=[p.name for p in lib.paths], ptxas=report,
         flash_bf16_hgmma=hgmma,
         flash_bf16_registers_spill_store_load=regs)


def paged_inputs(shape, dtype, gen, engine_like: bool, lengths=None):
    """Random q and pools of ``shape`` on the card. ``engine_like``: lengths
    drawn from 1 .. NP * PS with a partial last page (or ``lengths``), page
    ids scattered over the non-null pages, zeros past each sequence's
    pages, as the engine's table holds them; else tests/test_kernels.py's
    lengths and table."""
    B, H, Hkv, D, P, PS, NP = shape
    q = torch.randn(B, H, D, device="cuda", generator=gen).to(dtype)
    kp = torch.randn(P, PS, Hkv, D, device="cuda", generator=gen).to(dtype)
    vp = torch.randn(P, PS, Hkv, D, device="cuda", generator=gen).to(dtype)
    if engine_like:
        pt = (torch.randperm(P - 1, device="cuda", generator=gen)[:B * NP]
              + 1).reshape(B, NP)
        if lengths is not None:
            ln = torch.tensor(lengths, device="cuda")
        else:
            ln = torch.randint(1, NP * PS + 1, (B,), device="cuda",
                               generator=gen)
            if not bool((ln % PS).any()):
                ln[0] -= 1
        live = -(-ln // PS)
        pt = torch.where(torch.arange(NP, device="cuda")[None] < live[:, None],
                         pt, 0)
    else:
        pt = torch.randperm(P, device="cuda", generator=gen)[:B * NP]
        pt = pt.reshape(B, NP)
        ln = torch.tensor([NP * PS - 3] + [max(1, (NP - 1) * PS)] * (B - 1),
                          device="cuda")
    return q, kp, vp, pt.int(), ln.int()


def phase_kernels_vs_plain() -> dict:
    from repro_torch.apps.qsim import _random_su4
    from repro_torch.kernels.paged_attention import (
        paged_attention,
        paged_attention_ref,
    )
    from repro_torch.kernels.qv_gate import (
        apply_two_qubit_gate,
        apply_two_qubit_gate_ref,
    )
    from repro_torch.kernels.stencil5 import stencil5, stencil5_ref

    gen = torch.Generator("cuda").manual_seed(0)
    errs = {"stencil5": 0.0, "qv_gate": 0.0, "paged_attention": 0.0,
            "flash_attention": 0.0}
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

    # the test's three shapes, then yi-6b's decode shape, in both dtypes
    for shape in PAGED_SHAPES + [PAGED_MAIN]:
        main = shape == PAGED_MAIN
        for dtype, tol in PAGED_TOL.items():
            args = paged_inputs(shape, dtype, gen, engine_like=main)
            out = paged_attention(*args)
            torch.cuda.synchronize()
            err = float((out.float() - paged_attention_ref(*args).float())
                        .abs().max())
            check(err <= tol, f"paged_attention {shape} {dtype} err {err}")
            if main and dtype == torch.float32:  # the serve path's dtype
                errs["paged_attention"] = err
            rows.append(dict(kernel="paged_attention", shape=list(shape),
                             dtype=str(dtype), lengths=args[4].tolist(),
                             max_abs_err=err, tol=tol))
            del args, out
    rows += check_flash(gen, errs)
    # their own generators: the flash checks draw what they drew before
    rows += check_paged_splits(torch.Generator("cuda").manual_seed(2))
    rows += check_paged_moe(torch.Generator("cuda").manual_seed(3), errs)
    emit("kernel_vs_plain", checks=rows)
    return errs


def check_paged_moe(gen, errs) -> list:
    """paged_attention at the MoE archs' decode shapes, engine-like, fp32
    and bf16; ``errs["paged_attention"]`` also takes olmoe's fp32 error."""
    from repro_torch.kernels.paged_attention import (
        paged_attention,
        paged_attention_ref,
    )

    rows = []
    for arch, shape in PAGED_MOE.items():
        for dtype, tol in PAGED_TOL.items():
            args = paged_inputs(shape, dtype, gen, engine_like=True)
            out = paged_attention(*args)
            torch.cuda.synchronize()
            err = float((out.float() - paged_attention_ref(*args).float())
                        .abs().max())
            check(err <= tol, f"paged_attention {arch} {shape} {dtype} "
                  f"err {err}")
            if arch == SERVE_MOE["arch"] and dtype == torch.float32:
                errs["paged_attention"] = max(errs["paged_attention"], err)
            rows.append(dict(kernel="paged_attention", case=arch,
                             shape=list(shape), dtype=str(dtype),
                             lengths=args[4].tolist(), max_abs_err=err,
                             tol=tol))
            del args, out
    return rows


def check_paged_splits(gen) -> list:
    """paged_attention at lengths on and next to the chunk boundaries, with
    engine-like scattered pages, fp32 and bf16; and the size of pass 1's
    grid at the decode shape."""
    from repro_torch.kernels.paged_attention import (
        paged_attention,
        paged_attention_ref,
    )
    from repro_torch.kernels.paged_attention.ops import CHUNK, split_plan

    NP, PS = PAGED_SPLIT[6], PAGED_SPLIT[5]
    lengths = [1, CHUNK - 1, CHUNK, CHUNK + 1, NP * PS]
    rows = []
    for dtype, tol in PAGED_TOL.items():
        args = paged_inputs(PAGED_SPLIT, dtype, gen, engine_like=True,
                            lengths=lengths)
        out = paged_attention(*args)
        torch.cuda.synchronize()
        err = float((out.float() - paged_attention_ref(*args).float())
                    .abs().max())
        check(err <= tol, f"paged_attention split boundaries {dtype} err {err}")
        rows.append(dict(kernel="paged_attention", case="split boundaries",
                         shape=list(PAGED_SPLIT), dtype=str(dtype),
                         lengths=lengths, chunk=CHUNK, max_abs_err=err,
                         tol=tol))
        del args, out
    B, H, Hkv, D, P, PS, NP = PAGED_MAIN
    splits, _ = split_plan(B, H, D, PS, NP)
    blocks = B * Hkv * splits
    check(blocks >= PAGED_MIN_BLOCKS,
          f"pass 1's grid at the decode shape is {blocks} blocks")
    rows.append(dict(kernel="paged_attention", case="pass-1 grid",
                     shape=list(PAGED_MAIN), grid=[B * Hkv, splits],
                     blocks=blocks, min_blocks=PAGED_MIN_BLOCKS))
    return rows


def check_flash(gen, errs) -> list:
    """flash_attention against its plain version at the test's cases, at
    uneven lengths, without the causal mask, at the harness's shape and at
    the full-width prefill shapes; its zeros for rows that see no key; and
    against the model's blocked attention at yi-6b's shape.
    ``errs["flash_attention"]`` gets the largest fp32 error at the harness's
    and the full-width shapes."""
    from repro_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_ref,
    )
    from repro_torch.kernels.flash_attention.ops import _entry
    from repro_torch.models.attention import _blocked_causal

    cases = [(s, w, True, "test") for s in FLASH_SHAPES for w in FLASH_WINDOWS]
    cases += [(s, w, True, "uneven") for s in FLASH_UNEVEN
              for w in FLASH_WINDOWS
              if not (w and s[1] > s[2] + w - 1)]  # every row sees a key
    cases += [(s, w, False, "non-causal") for s, w in FLASH_NONCAUSAL]
    cases += [(FLASH_MICRO, 0, True, "main")]
    cases += [(s, w, True, name) for name, (s, w) in FLASH_FULL.items()]
    rows = []
    for shape, window, causal, kind in cases:
        for dtype, tol in FLASH_TOL.items():
            q, k, v = flash_inputs(shape, dtype, gen)
            out = flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            want = flash_attention_ref(q, k, v, causal=causal, window=window)
            err = float((out.float() - want.float()).abs().max())
            del q, k, v, out, want
            check(err <= tol, f"flash_attention {shape} w={window} "
                  f"causal={causal} {dtype} err {err}")
            if kind in ("main", *FLASH_FULL) and dtype == torch.float32:
                errs["flash_attention"] = max(errs["flash_attention"], err)
            if kind in FLASH_FULL and dtype == torch.bfloat16:
                errs["flash_attention_bf16"] = max(
                    errs.get("flash_attention_bf16", 0.0), err)
            rows.append(dict(kernel="flash_attention", case=kind,
                             route=_entry(dtype, shape[5]),
                             shape=list(shape), window=window, causal=causal,
                             dtype=str(dtype), max_abs_err=err, tol=tol))
        torch.cuda.empty_cache()
    # rows with no visible key: zeros from the kernel, the rest as the plain
    # version's, causal or not
    shape, window = FLASH_MASKED
    dead = shape[2] + window - 1  # the first row that sees no key
    for causal in (True, False):
        for dtype, tol in FLASH_TOL.items():
            q, k, v = flash_inputs(shape, dtype, gen)
            out = flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            want = flash_attention_ref(q, k, v, causal=causal, window=window)
            err = float((out[:, :dead].float()
                         - want[:, :dead].float()).abs().max())
            nonzero = int(out[:, dead:].count_nonzero())
            check(err <= tol and nonzero == 0,
                  f"flash_attention rows without a key: {shape} w={window} "
                  f"causal={causal} {dtype} err {err}, {nonzero} nonzero")
            rows.append(dict(kernel="flash_attention", case="no-key rows",
                             route=_entry(dtype, shape[5]),
                             shape=list(shape), window=window, causal=causal,
                             dtype=str(dtype), max_abs_err=err, tol=tol,
                             dead_rows_nonzero=nonzero))
    # the model's blocked path at yi-6b's shape, heads grouped (B,S,N,P,D)
    B, S, _, H, Hkv, D = FLASH_FULL["yi-6b"][0]
    q, k, v = flash_inputs((B, S, S, H, Hkv, D), torch.float32, gen)
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    blocked = _blocked_causal(q.reshape(B, S, Hkv, H // Hkv, D), k, v,
                              FLASH_BLOCK, FLASH_BLOCK, 0).reshape(B, S, H, D)
    err = float((out - blocked).abs().max())
    del q, k, v, out, blocked
    torch.cuda.empty_cache()
    tol = FLASH_TOL[torch.float32]
    check(err <= tol, f"flash_attention vs _blocked_causal err {err}")
    rows.append(dict(kernel="flash_attention", case="vs _blocked_causal",
                     shape=[B, S, S, H, Hkv, D], blocks=FLASH_BLOCK,
                     dtype="torch.float32", max_abs_err=err, tol=tol))
    return rows


def kernel_counters() -> dict:
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.qv_gate import apply_two_qubit_gate
    from repro_torch.kernels.stencil5 import stencil5

    return {"stencil5": stencil5, "qv_gate": apply_two_qubit_gate,
            "paged_attention": paged_attention,
            "flash_attention": flash_attention}


def zero_counters() -> dict:
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    return counters


def phase_apps() -> dict:
    """The main path: each app at full size on the card, with every launch
    counter set to 0 just before it and read just after."""
    from repro_torch.apps import (
        run_bfs,
        run_hotspot,
        run_needle,
        run_pathfinder,
        run_qsim,
        run_srad,
    )

    total = dict.fromkeys(kernel_counters(), 0)
    rows = []
    # pathfinder, needle and bfs have no TPU kernel: plain torch
    runs = [("hotspot", run_hotspot, HOTSPOT, "stencil5"),
            ("srad", run_srad, SRAD, "stencil5"),
            ("qiskit", run_qsim, QISKIT, "qv_gate"),
            ("pathfinder", run_pathfinder, PATHFINDER, None),
            ("needle", run_needle, NEEDLE, None),
            ("bfs", run_bfs, BFS, None)]
    for name, run, kw, kernel in runs:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        counters = zero_counters()
        t0 = time.perf_counter()
        r = run("system", device="cuda", **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        check(kernel is None or launches[kernel] > 0,
              f"{name} never launched {kernel}")
        check(math.isfinite(r.checksum), f"{name} checksum {r.checksum}")
        if name == "bfs":  # a random graph of out-degree 8 reaches nearly all
            check(0.99 * kw["n_nodes"] <= r.checksum <= kw["n_nodes"],
                  f"bfs visited {r.checksum} of {kw['n_nodes']}")
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
        elif name == "pathfinder":
            kw.update(data=rng.integers(0, 10, (kw["rows"], kw["cols"]),
                                        dtype=np.int32))
        elif name == "needle":
            kw.update(sim=rng.integers(-2, 3, (kw["n"], kw["n"]),
                                       dtype=np.int32))
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
    for name in APPS:
        for pol in ("explicit", "managed", "system"):
            key = f"fig3/{name}/{pol}"
            got = charge_snapshot(APPS[name].run(pol, device="cuda",
                                                 **APPS[name].sizes["fig3"]))
            check(got == fixture[key], f"{key} charges differ from fixture")
            keys.append(key)
    emit("parity", configs=keys, bit_identical=True)


def run_serve(cfg, model, settings, time_ffn: bool = False):
    """Requests through ServeEngine over a KV pool under the unified-memory
    runtime, every launch counter set to 0 just before the run and read just
    after. Times prefill chunks and decode batches apart (each ends
    synchronized), each paged_attention launch with CUDA events and, with
    ``time_ffn``, each block's ffn in the decode batches. Returns the phase's
    row, the launches and the last paged_attention call's inputs."""
    import dataclasses

    import repro_torch.serve.engine as engine_mod
    from repro_torch.core import UnifiedMemory
    from repro_torch.serve import ServeEngine

    um = UnifiedMemory()  # the charge model's default hardware, GRACE_HOPPER
    eng = ServeEngine(cfg, model, max_seqs=settings["max_seqs"],
                      max_len=settings["max_len"],
                      page_size=settings["page_size"],
                      prefill_chunk=settings["prefill_chunk"], um=um,
                      device="cuda")
    rng = np.random.default_rng(0)
    lo, hi = settings["prompt_lens"]
    prompts = [rng.integers(2, cfg.vocab_size, int(rng.integers(lo, hi + 1)))
               for _ in range(settings["requests"])]
    rids = [eng.add_request(p, settings["new_tokens"]) for p in prompts]

    spent = {"prefill": 0.0, "decode": 0.0}
    last, events, ffn_events, in_decode = {}, [], [], [False]

    def timed(fn, key):
        def run(*a):
            in_decode[0] = key == "decode"
            t = time.perf_counter()
            fn(*a)
            torch.cuda.synchronize()
            spent[key] += time.perf_counter() - t
            in_decode[0] = False
        return run

    def recording(*args):
        last["args"] = args
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = real(*args)
        ev[1].record()
        events.append(ev)
        return out

    def ffn_timed(fwd):
        def run(x, policy):
            if not in_decode[0]:
                return fwd(x, policy)
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            y = fwd(x, policy)
            ev[1].record()
            ffn_events.append(ev)
            return y
        return run

    eng._prefill_chunk_run = timed(eng._prefill_chunk_run, "prefill")
    eng._decode_batch = timed(eng._decode_batch, "decode")
    if time_ffn:
        for blk in model.layers:
            blk.ffn.forward = ffn_timed(blk.ffn.forward)
    real = engine_mod.paged_attention
    engine_mod.paged_attention = recording
    try:
        counters = zero_counters()
        t0 = time.perf_counter()
        out = eng.run_to_completion()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
    finally:
        engine_mod.paged_attention = real
        # the wrappers hold the engine, and the engine holds the model: drop
        # the cycle, so the model's memory goes when the caller drops it
        del eng._prefill_chunk_run, eng._decode_batch
        if time_ffn:
            for blk in model.layers:
                del blk.ffn.forward
    st = eng.stats
    check(st.decode_batches > 0 and launches["paged_attention"]
          == st.decode_batches * cfg.num_layers,
          f"paged_attention launched {launches['paged_attention']} times "
          f"for {st.decode_batches} decode batches x {cfg.num_layers} layers")
    for rid in rids:
        check(eng.requests[rid].done
              and len(out[rid]) == settings["new_tokens"],
              f"request {rid} ended with {len(out[rid])} tokens")
    prefill_tokens = int(sum(len(p) for p in prompts))
    kernel_ms = sum(a.elapsed_time(b) for a, b in events)
    decode_ms = 1e3 * spent["decode"]
    rep = um.report()
    row = dict(
        arch=cfg.name, params=cfg.param_count(), dtype="float32",
        config={k: v for k, v in settings.items() if k != "arch"},
        prompt_lens=[len(p) for p in prompts], wall_s=wall,
        prefill_tokens=prefill_tokens, prefill_s=spent["prefill"],
        prefill_tok_per_s=prefill_tokens / spent["prefill"],
        decode_tokens=st.decode_tokens, decode_s=spent["decode"],
        decode_tok_per_s=st.decode_tokens / spent["decode"],
        # each sequence of a decode batch gets one token from it
        per_token_latency_ms=decode_ms / st.decode_batches,
        paged_attention_ms=kernel_ms,
        paged_attention_share_of_decode=kernel_ms / decode_ms,
        peak_device_bytes=torch.cuda.max_memory_allocated(),
        launches=launches, stats=dataclasses.asdict(st),
        umem_modeled=dict(hardware="GRACE_HOPPER", clock_s=um.clock,
                          traffic_total=rep["traffic_total"],
                          remote_access_share=rep["remote_access_share"]),
        tokens={rid: out[rid] for rid in rids})
    if time_ffn:
        ffn_ms = sum(a.elapsed_time(b) for a, b in ffn_events)
        row.update(decode_ffn_ms=ffn_ms, decode_ffn_calls=len(ffn_events),
                   decode_ffn_share_of_decode=ffn_ms / decode_ms)
    del eng, um
    return row, launches, last["args"]


def phase_serve():
    """The serving main path: full-width yi-6b with random fp32 weights made
    on the card, 8 requests. Returns the launches, the model (for the dense
    check) and the last decode batch's paged_attention inputs (for timing)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(SERVE["arch"])
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator("cuda").manual_seed(0),
                        device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    row, launches, args = run_serve(cfg, model, SERVE)
    emit("serve", init_s=init_s, **row)
    return launches, model, args


def phase_serve_moe():
    """The MoE serving main path: full-width olmoe-1b-7b with random fp32
    weights made on the card, the same 8 requests' settings, each MoE
    block's device time in the decode batches measured with CUDA events.
    Returns the launches and the model (for the dense check)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.moe import MoE

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()  # what earlier phases still hold
    cfg = get_config(SERVE_MOE["arch"])
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator("cuda").manual_seed(0),
                        device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check(all(isinstance(blk.ffn, MoE) for blk in model.layers),
          f"{cfg.name} built without MoE blocks")
    row, launches, _ = run_serve(cfg, model, SERVE_MOE, time_ffn=True)
    emit("serve_moe", init_s=init_s, num_experts=cfg.num_experts,
         top_k=cfg.top_k, device_bytes_before_init=before, **row)
    return launches, model


def phase_dense_check(model) -> None:
    """One request at full width through the paged engine and through the
    dense decode_step path: the greedy tokens must agree, or differ first
    where the dense path's top-2 logit margin is within rounding."""
    from repro_torch.models import init_cache
    from repro_torch.serve import ServeEngine

    cfg = model.cfg
    n, new, max_len = (DENSE_CHECK[k] for k in
                       ("prompt_len", "new_tokens", "max_len"))
    prompt = np.random.default_rng(2).integers(2, cfg.vocab_size, n)
    eng = ServeEngine(cfg, model, max_seqs=1, max_len=max_len, page_size=16,
                      device="cuda")
    rid = eng.add_request(prompt, new)
    paged = eng.run_to_completion()[rid]
    del eng
    cache = init_cache(cfg, 1, max_len, dtype=torch.float32, device="cuda")
    dense, margins = [], []
    for i in range(n + new - 1):
        tok = int(prompt[i]) if i < n else dense[-1]
        lg, cache = model.decode_step(
            torch.tensor([[tok]], dtype=torch.int32, device="cuda"),
            torch.tensor([i], dtype=torch.int32, device="cuda"), cache)
        if i >= n - 1:
            top = torch.topk(lg[0, 0], 2).values
            dense.append(int(torch.argmax(lg[0, 0])))
            margins.append((float(top[0] - top[1]),
                            float(lg[0, 0].abs().max())))
    del cache
    first = next((i for i, (a, b) in enumerate(zip(paged, dense)) if a != b),
                 None)
    row = dict(paged=paged, dense=dense, first_difference=first,
               top2_margins=[m for m, _ in margins])
    if first is not None:
        margin, scale = margins[first]
        row.update(margin=margin, margin_tol=MARGIN_RTOL * scale)
    emit("dense_check", **row)
    if first is not None:
        check(row["margin"] < row["margin_tol"],
              f"paged token {paged[first]} != dense {dense[first]} at "
              f"{first} with top-2 margin {row['margin']}")


def phase_moe_dense_check(model) -> None:
    """One request whose prompt fits one prefill chunk, at full width,
    through the paged engine and through model.prefill + decode_step: both
    route the prompt's T tokens together and then one token at a time, so
    their capacity drops are the same. The greedy tokens must agree, or
    differ first where the dense path's top-2 logit margin is within
    rounding."""
    from repro_torch.models import init_cache
    from repro_torch.serve import ServeEngine

    cfg = model.cfg
    n, new, max_len = (MOE_DENSE_CHECK[k] for k in
                       ("prompt_len", "new_tokens", "max_len"))
    check(n <= SERVE_MOE["prefill_chunk"], "the prompt must fit one chunk")
    prompt = np.random.default_rng(2).integers(2, cfg.vocab_size, n)
    eng = ServeEngine(cfg, model, max_seqs=1, max_len=max_len, page_size=16,
                      prefill_chunk=SERVE_MOE["prefill_chunk"], device="cuda")
    rid = eng.add_request(prompt, new)
    paged = eng.run_to_completion()[rid]
    check(eng.stats.prefill_chunks == 1, "the prompt took more than a chunk")
    del eng
    lg, kv = model.prefill(torch.as_tensor(prompt, device="cuda")[None])
    cache = init_cache(cfg, 1, max_len, dtype=torch.float32, device="cuda")
    for c, layer in zip(cache, kv):
        c["k"][:, :n] = layer["k"]
        c["v"][:, :n] = layer["v"]
    del kv
    dense, margins = [], []
    for i in range(new):
        if i:
            lg, cache = model.decode_step(
                torch.tensor([[dense[-1]]], dtype=torch.int32, device="cuda"),
                torch.tensor([n + i - 1], dtype=torch.int32, device="cuda"),
                cache)
        top = torch.topk(lg[0, -1], 2).values
        dense.append(int(torch.argmax(lg[0, -1])))
        margins.append((float(top[0] - top[1]), float(lg[0, -1].abs().max())))
    del cache
    first = next((i for i, (a, b) in enumerate(zip(paged, dense)) if a != b),
                 None)
    row = dict(arch=cfg.name, prompt_len=n, paged=paged, dense=dense,
               first_difference=first, top2_margins=[m for m, _ in margins])
    if first is not None:
        margin, scale = margins[first]
        row.update(margin=margin, margin_tol=MARGIN_RTOL * scale)
    emit("moe_dense_check", **row)
    if first is not None:
        check(row["margin"] < row["margin_tol"],
              f"paged token {paged[first]} != dense {dense[first]} at "
              f"{first} with top-2 margin {row['margin']}")


def phase_serve_card_vs_cpu() -> None:
    """Reduced yi-6b with the same weights (a numpy tree from a seed) on the
    card and on the CPU: the same schedule gives the same greedy tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import load_jax_params, numpy_params
    from repro_torch.serve import ServeEngine

    cfg = get_config(SERVE["arch"]).reduced()
    tree = numpy_params(cfg, seed=3)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(2, cfg.vocab_size, int(rng.integers(8, 60)))
               for _ in range(6)]
    toks = {}
    for dev in ("cuda", "cpu"):
        eng = ServeEngine(cfg, load_jax_params(cfg, tree, dev), max_seqs=4,
                          max_len=128, page_size=16, prefill_chunk=32,
                          device=dev)
        rids = [eng.add_request(p, 12) for p in prompts]
        out = eng.run_to_completion()
        toks[dev] = [out[r] for r in rids]
    check(toks["cuda"] == toks["cpu"],
          f"card tokens {toks['cuda']} != cpu tokens {toks['cpu']}")
    emit("serve_card_vs_cpu", arch=cfg.name, requests=len(prompts),
         tokens_equal=True, tokens=toks["cuda"])


def record_margins(sim) -> tuple:
    """Wrap every engine of ``sim`` so that it records, for the i-th token
    of each request, (top-2 logit margin, max |logit|, least router gap):
    the router gap is the distance between a routing's k-th and (k+1)-th
    expert probability in the call that produced the token (inf for dense
    archs). Also the least router gap of each request's prefill chunks.
    Returns (per-token dict keyed (arch, rid, i), prefill dict keyed (arch,
    rid), undo)."""
    import repro_torch.models.moe as moe_mod

    tokens, prefill, gaps, logits = {}, {}, [], []
    real_route = moe_mod._route

    def route(cfg, p, xt, E):
        probs, gate_vals, idx = real_route(cfg, p, xt, E)
        top = torch.topk(probs, cfg.top_k + 1, dim=-1).values
        gaps.append(top[:, -2] - top[:, -1])
        return probs, gate_vals, idx

    def margins(lg):
        top = torch.topk(lg, 2, dim=-1).values
        return ((top[:, 0] - top[:, 1]).tolist(),
                lg.abs().amax(dim=-1).tolist())

    def wrap(arch, eng):
        model = eng.params
        real_logits = model.logits_out
        real_pre, real_dec = eng._prefill_chunk_run, eng._decode_batch

        def logits_out(x):
            lg = real_logits(x)
            logits.append(lg[:, -1])
            return lg

        def pre(req, chunk):
            gaps.clear()
            logits.clear()
            i = len(req.generated)
            real_pre(req, chunk)
            g = float(torch.cat(gaps).min()) if gaps else math.inf
            key = (arch, req.rid)
            prefill[key] = min(prefill.get(key, math.inf), g)
            if logits:
                (m,), (sc,) = margins(logits[-1])
                tokens[(arch, req.rid, i)] = (m, sc, g)

        def dec(reqs):
            gaps.clear()
            logits.clear()
            at = [(r.rid, len(r.generated)) for r in reqs]
            real_dec(reqs)
            g = (torch.stack(gaps).amin(dim=0).tolist() if gaps
                 else [math.inf] * len(reqs))
            ms, scs = margins(logits[-1])
            for (rid, i), m, sc, gj in zip(at, ms, scs, g):
                tokens[(arch, rid, i)] = (m, sc, gj)

        model.logits_out = logits_out
        eng._prefill_chunk_run, eng._decode_batch = pre, dec
        return model

    models = [wrap(arch, eng) for arch, eng in sim.engines.items()]
    moe_mod._route = route

    def undo():
        moe_mod._route = real_route
        for model in models:
            del model.logits_out

    return tokens, prefill, undo


def phase_traffic() -> dict:
    """The traffic harness on the card: the burst preset over the reduced
    configs with the same weights (numpy trees made on the CPU, loaded on
    each device) on the card and on the CPU, whose records must be equal
    field for field and tokens equal but where a token's logit margin or a
    routing it depends on is a near-tie; then a node loss on gh200_x2 whose
    tokens must equal the fault-free run's on the card. Every launch counter
    is set to 0 just before the card's runs and read just after."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models import load_jax_params, numpy_params
    from repro_torch.runtime import FaultPlan
    from repro_torch.serve import (
        ArrivalProcess,
        LengthDist,
        Scenario,
        TenantSpec,
        TrafficSim,
        get_scenario,
    )

    sc = get_scenario(TRAFFIC["scenario"])
    trees = {}
    for arch in sorted({t.arch for t in sc.tenants}):
        cfg = get_config(arch).reduced()
        trees[arch] = (cfg, numpy_params(cfg, TRAFFIC["weights_seed"]))

    def sim(device):
        models = {a: (cfg, load_jax_params(cfg, tree, device))
                  for a, (cfg, tree) in trees.items()}
        return TrafficSim(sc, policy="system", seed=TRAFFIC["seed"],
                          models=models, device=device)

    micro = ArchConfig(name="micro", family="dense", source="test",
                       num_layers=1, d_model=32, num_heads=2, num_kv_heads=2,
                       head_dim=16, d_ff=64, vocab_size=64)
    micro_models = {"micro": (micro, load_jax_params(
        micro, numpy_params(micro, 0), "cuda"))}
    fault_sc = Scenario(
        name="micro",
        tenants=tuple(TenantSpec(
            name=f"t{i}", arch="micro", num_requests=5,
            arrival=ArrivalProcess("poisson", rate=2e5),
            prompt=LengthDist("lognormal", lo=4, hi=24, mean=10.0),
            output=LengthDist("lognormal", lo=1, hi=8, mean=4.0))
            for i in range(2)),
        page_size=4, max_seqs=4, max_len=48, prefill_chunk=12)

    def fault_run(plan):
        return TrafficSim(fault_sc, policy=FAULT["policy"], hw=FAULT["hw"],
                          seed=FAULT["seed"], models=micro_models,
                          tp=FAULT["tp"], fault_plan=plan,
                          device="cuda").run()

    card_sim = sim("cuda")
    counters = zero_counters()
    t0 = time.perf_counter()
    card = card_sim.run()
    clean = fault_run(None)
    faulted = fault_run(FaultPlan.node_loss(FAULT["node_loss"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    check(launches["paged_attention"] > 0, "the traffic runs never launched "
          "paged_attention")
    del card_sim

    cpu_sim = sim("cpu")
    rec, prefill, undo = record_margins(cpu_sim)
    try:
        cpu = cpu_sim.run()
    finally:
        undo()
    check([dataclasses.asdict(r) for r in card.records]
          == [dataclasses.asdict(r) for r in cpu.records],
          "traffic records differ between card and cpu")
    for arch, pe in cpu.per_engine.items():
        check(card.per_engine[arch]["clock"] == pe["clock"]
              and card.per_engine[arch]["stats"] == pe["stats"],
              f"{arch}: clock or stats differ between card and cpu")
    flips = []
    for key, want in cpu.tokens.items():
        got = card.tokens[key]
        check(len(got) == len(want), f"{key}: {len(got)} tokens on the card, "
              f"{len(want)} on the cpu")
        first = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                     None)
        if first is None:
            continue
        arch, rid = key.split("/")
        margin, scale, _ = rec[(arch, int(rid), first)]
        gap = min([prefill.get((arch, int(rid)), math.inf)]
                  + [rec[(arch, int(rid), i)][2] for i in range(first + 1)])
        flips.append(dict(request=key, index=first, card=got[first],
                          cpu=want[first], logit_margin=margin,
                          margin_tol=MARGIN_RTOL * scale, router_gap=gap,
                          router_gap_tol=ROUTE_GAP_TOL))
    for f in flips:
        print(f"chip_smoke: traffic token flip {json.dumps(f)}", flush=True)
        check(f["logit_margin"] < f["margin_tol"]
              or f["router_gap"] < f["router_gap_tol"],
              f"traffic token differs without a near-tie: {f}")

    stats = faulted.per_engine["micro"]["stats"]
    check(faulted.tokens == clean.tokens, "node-loss tokens differ from the "
          "fault-free run on the card")
    check(stats["node_losses"] == 1 and stats["replayed_tokens"] > 0,
          f"the node loss replayed nothing: {stats}")
    m = card.metrics
    emit("traffic", scenario=sc.name, policy="system", archs=sorted(trees),
         wall_s=wall, requests=m["n"], completed=m["completed"],
         tokens=m["tokens"], goodput_tok_s_modeled=m["goodput_tok_s"],
         preempted=sum(pe["stats"]["preempted"]
                       for pe in card.per_engine.values()),
         records_equal_cpu=True, token_flips=flips,
         fault=dict(FAULT, tokens_equal_fault_free=True,
                    node_losses=stats["node_losses"],
                    recovered_requests=stats["recovered_requests"],
                    replayed_tokens=stats["replayed_tokens"]),
         launches=launches)
    return launches


def run_harness(argv) -> tuple:
    """``python -m repro_torch.bench.run`` in this process: its exit code
    and its CSV rows as {name: (us_per_call, derived)}, in order."""
    import contextlib
    import io

    from repro_torch.bench import run as bench_run

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench_run.main(argv)
    lines = buf.getvalue().splitlines()
    check(lines and lines[0] == "name,us_per_call,derived",
          f"harness {argv} printed no CSV header")
    rows = {}
    for ln in lines[1:]:
        if ln.startswith("#"):  # a module's note, e.g. a skipped cell
            continue
        name, us, derived = ln.split(",", 2)
        rows[name] = (us, WALL_FIELD.sub("", derived))
    return rc, rows


def phase_bench() -> dict:
    """The harness's main path: every module of repro_torch.bench.run on the
    card, and the serving benchmarks it runs by name, every launch counter
    set to 0 just before and read just after; kernels_micro launches each
    kernel. The figure and serving modules print modeled charges and counts,
    so their rows (but ``wall_s``) must equal the same modules' rows on the
    CPU. Their JSON snapshots go to build/, never to the repo root."""
    import os

    from repro_torch.bench.run import MODULES

    torch.cuda.empty_cache()
    json_dir = ROOT / "build" / "chip_smoke_bench_json"
    os.environ.update(BENCH_SMOKE)
    counters = zero_counters()
    t0 = time.perf_counter()
    rc, card = run_harness(["--json", str(json_dir / "card")] + MODULES
                           + BENCH_BY_NAME)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    check(rc == 0, f"repro_torch.bench.run exited {rc} on the card")
    for k, n in launches.items():
        check(n > 0, f"repro_torch.bench.run never launched {k}")
    micro = {k: v for k, v in card.items() if k.startswith("kernel/")}
    check(len(micro) == 4, f"kernels_micro printed {sorted(micro)}")
    figures = {k: v for k, v in card.items() if not k.startswith("kernel/")}
    rc, cpu = run_harness(["--device", "cpu", "--json", str(json_dir / "cpu")]
                          + [m for m in MODULES if "kernels_micro" not in m]
                          + BENCH_BY_NAME)
    check(rc == 0, f"repro_torch.bench.run --device cpu exited {rc}")
    check(list(figures) == list(cpu), "the card's figure rows differ in "
          "name or order from the CPU's")
    differ = [k for k in figures if figures[k] != cpu[k]]
    check(not differ, f"figure rows differ between card and cpu: {differ}")
    serving = [k for k in figures
               if k.split("/")[0] in ("lm_serve", "fault", "cluster")]
    check(serving, "the serving benchmarks printed no rows")
    snapshots = sorted(p.name for p in (json_dir / "card").glob("*.json"))
    check(snapshots == ["BENCH_cluster.json", "BENCH_fault.json",
                        "BENCH_lmserve.json"],
          f"the serving benchmarks wrote {snapshots}")
    emit("bench", modules=MODULES + BENCH_BY_NAME, env=BENCH_SMOKE,
         wall_s=wall, figure_rows=len(figures), serving_rows=len(serving),
         rows_equal_cpu=True, json=snapshots, launches=launches,
         kernels_micro_us_on_card={k: (float(us), d)
                                   for k, (us, d) in micro.items()})
    return launches


def device_kernels(fn, calls: int = 3) -> list:
    """The device kernels ``calls`` runs of ``fn`` launch, from a
    torch.profiler trace: [name, count, device microseconds in all], the
    longest first; empty where the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        if us > 0 and e.key and not e.key.startswith(("cuda", "aten::")):
            rows.append([e.key[:120], e.count, float(us)])
    return sorted(rows, key=lambda r: -r[2])[:4]


def time_flash(shape, window, dtype, gen) -> dict:
    """flash_attention, its plain version and one SDPA call (the library
    yardstick, never used on the port's path) on the same inputs."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_ref,
    )

    B, Sq, Sk, H, Hkv, D = shape
    q, k, v = flash_inputs(shape, dtype, gen)
    size = q.element_size()
    flops = 4.0 * D * B * H * flash_pairs(Sq, Sk, True, window)
    b, by = bound_ms(size * (2 * B * Sq * H * D + 2 * B * Sk * Hkv * D), flops,
                     FP32_FLOP_PER_S if dtype == torch.float32
                     else BF16_FLOP_PER_S)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # (B, heads, S, D)
    if window:
        qpos = torch.arange(Sq, device="cuda")[:, None]
        kpos = torch.arange(Sk, device="cuda")[None, :]
        band = (kpos <= qpos) & (kpos > qpos - window)

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band,
                                                  enable_gqa=True)
    else:
        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)
    row = dict(
        shape=list(shape), window=window, dtype=str(dtype),
        ms=median_ms(lambda: flash_attention(q, k, v, window=window), 10),
        trace=(device_kernels(lambda: flash_attention(q, k, v, window=window))
               if dtype == torch.bfloat16 else None),
        library_trace=(device_kernels(library)
                       if dtype == torch.bfloat16 else None),
        plain_ms=median_ms(lambda: flash_attention_ref(q, k, v, window=window),
                           3, warmup=1),
        bound_ms=b, bound_by=by, flops=flops,
        library_ms=median_ms(library, 10))
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return row


def phase_timing(paged_args) -> dict:
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

    # paged attention at the serve phase's last decode batch (its last
    # layer), with L2 flushed before each run, as the engine's other
    # layers leave it; also at yi-6b's decode shape with 8 sequences
    from repro_torch.kernels.paged_attention import (
        paged_attention,
        paged_attention_ref,
    )

    scratch = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")

    def flush():
        scratch.zero_()

    def paged_timing(args):
        q, kp, vp, pt, ln = args
        B, H, D = q.shape
        Hkv, size = kp.shape[2], q.element_size()
        live = int(ln.sum())
        b, by = bound_ms(live * Hkv * D * 2 * size + 2 * B * H * D * size
                         + 4 * (pt.numel() + B), 4.0 * live * H * D)
        # no one PyTorch call attends over a paged pool: library_ms is null
        return dict(shape=[B, H, Hkv, D, kp.shape[0], kp.shape[1],
                           pt.shape[1]],
                    lengths=ln.tolist(),
                    ms=median_ms(lambda: paged_attention(*args), 50,
                                 before=flush),
                    plain_ms=median_ms(lambda: paged_attention_ref(*args), 10,
                                       before=flush),
                    bound_ms=b, bound_by=by, library_ms=None)

    out["paged_attention"] = paged_timing(paged_args)
    out["paged_attention_decode_shape"] = paged_timing(paged_inputs(
        PAGED_MAIN, torch.float32, gen, engine_like=True))
    # olmoe's decode shape (MHA, a group of 1) from its own generator, so
    # the flash inputs below are drawn as before
    out["paged_attention_olmoe_decode_shape"] = paged_timing(paged_inputs(
        PAGED_MOE[SERVE_MOE["arch"]], torch.float32,
        torch.Generator("cuda").manual_seed(4), engine_like=True))
    del scratch
    torch.cuda.empty_cache()

    # flash attention at the full-width prefill shapes; yi-6b's fp32 row
    # stands for the kernel in the kernels line
    for name, (shape, window) in FLASH_FULL.items():
        for dtype in (torch.float32, torch.bfloat16):
            key = f"flash_attention_{name}_{str(dtype)[6:]}"
            out[key] = time_flash(shape, window, dtype, gen)
    out["flash_attention"] = out["flash_attention_yi-6b_float32"]
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
    serve_launches, model, paged_args = phase_serve()
    launches["paged_attention"] = serve_launches["paged_attention"]
    phase_dense_check(model)
    del model
    torch.cuda.empty_cache()
    moe_launches, model = phase_serve_moe()
    launches["paged_attention"] += moe_launches["paged_attention"]
    phase_moe_dense_check(model)
    del model
    torch.cuda.empty_cache()
    phase_serve_card_vs_cpu()
    launches["paged_attention"] += phase_traffic()["paged_attention"]
    launches["flash_attention"] = phase_bench()["flash_attention"]
    times = phase_timing(paged_args)
    del paged_args

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    meta = {
        "stencil5": ("src/repro_torch/csrc/stencil5.cu",
                     "src/repro/kernels/stencil5/stencil5.py:33"),
        "qv_gate": ("src/repro_torch/csrc/qv_gate.cu",
                    "src/repro/kernels/qv_gate/qv_gate.py:35"),
        "paged_attention": (
            "src/repro_torch/csrc/paged_attention.cu",
            "src/repro/kernels/paged_attention/paged_attention.py:68"),
        "flash_attention": (
            "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/flash_attention.py:86"),
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
    # paged attention at olmoe's decode shape (MHA) beside yi-6b's last batch
    t = times["paged_attention_olmoe_decode_shape"]
    paged = next(k for k in kernels if k["name"] == "paged_attention")
    paged["olmoe_decode_shape"] = {
        k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                          "library_ms", "shape", "lengths")}
    # the main path (kernels_micro) runs flash in fp32; its bf16 kernel, on
    # the tensor cores, at yi-6b's prefill beside it
    t = times["flash_attention_yi-6b_bfloat16"]
    kernels[-1]["bf16"] = {
        "source": "src/repro_torch/csrc/flash_attention_sm90.cu",
        "max_abs_err": errs["flash_attention_bf16"],
        **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms", "shape")}}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
