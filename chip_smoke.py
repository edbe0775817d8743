#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``. It builds the CUDA kernels from
``src/repro_torch/csrc`` (and fails unless every flash kernel holds
tensor-core instructions, ``HGMMA`` in bf16 and ``HMMA`` in fp32, and
spills nothing), holds each against its plain PyTorch version on the card
(flash attention in fp32 and bf16 on the tensor cores, paged attention also
at its chunk boundaries and at the MoE archs' decode shapes), drives the
port's main paths through the kernels, counting
each kernel's launches: the six paper apps at full size (hotspot, srad and
qiskit through their kernels; pathfinder, needle and bfs in plain torch),
paged-KV serving of full-width yi-6b and of full-width olmoe-1b-7b (8
requests each through ``ServeEngine``), full-width rwkv6-1.6b and
recurrentgemma-2b (8 prompts of 2304 tokens each through ``prefill`` and
32 greedy ``decode_step``s, in plain torch), training (full-width yi-6b cut
to 12 layers through ``make_train_step``/``Trainer``; the
``train_100m`` example through a failure and its restore; the UM-backed
``UMTrainer`` at the paper-scale spec; none of them launches a kernel), the
launch layer (``repro_torch.launch.train`` on an NCCL world of one rank
against ``make_train_step``; a data 2 x model 2 world of four processes
sharing the card over gloo against the one-rank step, with and without
sequence parallelism of the residual, and the int8 TP all-reduce;
full-width yi-6b cut to 4 layers on a model 2 world of two processes,
trained and prefilled with sequence parallelism against the same steps
without it; full-width yi-6b decode from an int8 KV cache against the fp
cache; no kernel either), the serve engine's decode graphs against eager
passes on reduced yi-6b and olmoe-1b-7b, the traffic harness (the burst
preset over the reduced configs, and a node loss on the two-superchip
cluster pool), and the benchmark harness (``repro_torch.bench.run``, whose
``kernels_micro`` launches every kernel, flash attention among them, with
the serving benchmarks at their smoke sizes). It holds the apps' card
results against the CPU on small shared inputs and their charges against
the parity fixture, the paged engine's tokens against the dense decode path
at full width (yi-6b and olmoe-1b-7b) and against the CPU on reduced yi-6b,
the recurrent archs' forward against prefill and decode at full width, their
tokens against the CPU's on reduced configs and their sequence mixers against
the per-token forms, the first training step's loss against the plain
no-grad loss, reduced archs' training steps against the CPU's, the replayed
steps' losses against the uninterrupted run's, the UM-backed trainer's
charges and losses against the CPU's, the traffic records and tokens against the CPU and the
node-loss tokens against the fault-free run, the harness's rows against the
same modules on the CPU, times each kernel at its main-path shape, and
prints:

* one JSON line per phase;
* ``{"kernels": [...]}``: each kernel's launches on the main path (for
  paged_attention the wrapper's calls: a decode graph's capture records its
  calls once and its replays make none; the serve phases' rows give the
  launches on the card, replays included), largest
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

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 non-tensor, dense
# TF32 and dense bf16 tensor-core flop/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
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
# decode graphs against eager passes, reduced configs: each phase adds
# requests of 4-token prompts (their prefill ends in the step that admits
# them), then runs 3 steps, so the decode batch is 1, 3, 8, then 64
# sequences, each size new mid-run; no request finishes before the last step
DECODE_GRAPHS = dict(archs=("yi-6b", "olmoe-1b-7b"),
                     phases=((1, 3), (2, 3), (5, 3), (56, 3)), prompt_len=4,
                     new_tokens=16, max_seqs=64, max_len=128, page_size=16,
                     rtol=1e-5)  # final-norm rows, of each pass's max
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
# the recurrent archs at full width, fp32, random weights from a seed: 8
# prompts of 2304 tokens (> recurrentgemma's 2048-token window, so prefill
# rolls the local layers' rings; 18 of rwkv6's 128-token chunks), then 32
# greedy decode steps from prefill's caches
RECURRENT = dict(archs=("rwkv6-1.6b", "recurrentgemma-2b"), batch=8,
                 prompt_len=2304, new_tokens=32)
RECURRENT_FWD_EXTRA = 16   # check (i): forward over 2304 + 16 tokens, B = 1
RECURRENT_FWD_RTOL = 1e-3  # of max |logit|, fp32 without TF32
RECURRENT_SMALL = dict(batch=2, prompt_len=40, new_tokens=12)  # check (ii)
WKV_SHAPE = (2, 512, 32, 64)  # check (iii): rwkv6's heads, B 2, S 512
SCAN_SHAPE = (2, 512, 2560)   # check (iii): recurrentgemma's lru width
RECURRENT_SCAN_TOL = 1e-4     # abs
HELD_BYTES_MAX = 1 << 30  # what earlier phases may still hold before weights
# training at full width: yi-6b (d 4096, 32 over 4 heads of 128, d_ff
# 11008, vocab 64000) cut from 32 to 12 layers, fp32 weights from a seed,
# SyntheticLM batches of 2 x 2048 tokens in two microbatches, remat on, six
# steps through Trainer (no checkpoint: checkpoints are held by the fault
# check below)
TRAIN = dict(arch="yi-6b", layers=12, params=2_600_570_880, seq_len=2048,
             global_batch=2, seed=0, steps=6, lr=3e-4, warmup_steps=2,
             total_steps=6, grad_accum=2)
TRAIN_REF_RTOL = 1e-5   # step 1's loss vs a no-grad loss_fn, relative
# the card against the CPU on reduced archs: the attention, MoE dispatch,
# wkv and rglru-scan backward passes, 3 steps, two microbatches, remat
TRAIN_CPU = dict(archs=("yi-6b", "olmoe-1b-7b", "rwkv6-1.6b",
                        "recurrentgemma-2b"), steps=3, batch=4, seq_len=32,
                 grad_accum=2, weights_seed=3)
TRAIN_CPU_RTOL = 1e-4   # losses and grad norms relative; params of max |param|
# where the CPU's sqrt(v_hat) >= 100 eps at every step (below it AdamW's
# g / (|g| + eps) divides rounding, and a weight may move by up to lr)
ADAMW_ILL = 1e-6
# fault recovery: the train_100m example, a checkpoint every 25 steps and a
# failure at step 40 (one restore from step 25, 15 steps replayed)
TRAIN_FAULT = dict(steps=60, fail_at=40)
# the UM-backed trainer at the paper-scale spec (103.8 M params)
UMTRAIN = dict(spec="train_100m", cells=(("system", 1.0), ("system", 1.5),
                                         ("managed", 1.5)), steps=3)
UMTRAIN_LOSS_RTOL = 1e-5  # card vs CPU
# the launch layer: (i) python -m repro_torch.launch.train in-process on an
# NCCL world of one rank (mesh 1 x 1) at phase train's width, depth and
# batch, against make_train_step on the same state and batches; (ii) a
# data 2 x model 2 world of 4 processes sharing the card over gloo (reduced
# archs, two microbatches) against the one-rank card step, and the int8 TP
# all-reduce on CUDA tensors against the CPU's, each arch with and without
# sequence parallelism (seq_len 32 splits over the 2 model ranks); (iii)
# full-width yi-6b decode from an int8 KV cache against the fp cache,
# teacher-forced on the fp run's greedy tokens; (iv) launch_seqpar:
# full-width yi-6b cut to 4 layers (1.22 B parameters, half on each rank) on
# a data 1 x model 2 world of two processes on cuda:0 over gloo, two train
# steps with remat and a prefill without and then with sequence parallelism
# from the same weights and batches
LAUNCH_FULL = dict(steps=2, batch=2, accum=2, seq=2048, layers=12, seed=0)
LAUNCH_RANKS = dict(data=2, model=2, archs=TRAIN_CPU["archs"], steps=2,
                    batch=4, seq_len=32, grad_accum=2, weights_seed=3)
LAUNCH_RTOL = TRAIN_CPU_RTOL  # losses, grad norms relative; params of max |param|
LAUNCH_SEQPAR = dict(arch="yi-6b", layers=4, data=1, model=2, steps=2,
                     batch=2, seq=2048, seed=0)
SEQPAR_PREFILL_RTOL = 1e-4  # last logits, caches: of their max |value|
KV_INT8 = dict(arch="yi-6b", batch=8, prompt_len=922, new_tokens=32, seed=0)
KV_INT8_SOFTMAX_ATOL = 0.05  # tests/test_model_consistency.py's tolerance
# At full width and random weights no probability is far above 1/vocab, so
# the softmax bound alone passes any cache short of a blow-up. The logits
# must also stay within four int8 steps (4/127) of max |logit| of the fp
# cache's (the int8 cache reads 2.0 steps on the H100, corrupted caches
# 77-97), and the greedy tokens agree at this share or more (0.977; the
# corrupted 0.16-0.33); a cache with each token's scales taken from its
# neighbour, or K's and V's scales swapped, must fail one of the three.
KV_INT8_LOGIT_RTOL = 4.0 / 127
KV_INT8_AGREE_MIN = 0.9
# the serving and training benchmarks run in the bench phase at smoke sizes
BENCH_SMOKE = {"LM_SERVE_SMOKE": "1", "FAULT_SMOKE": "1", "CLUSTER_SMOKE": "1",
               "TRAIN_SMOKE": "1"}
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


def tensor_core_kernels(lib, stem: str, needle: str, opcode: str,
                        count: int) -> tuple:
    """({kernel: count of ``opcode``}, {kernel: (registers, spill stores,
    spill loads)}) of the entry functions named ``needle`` in the library
    built from ``csrc/<stem>.cu``; fails unless there are ``count`` of them,
    each with the opcode, and none spills."""
    so = next(p for p in lib.paths
              if re.fullmatch(rf"lib{stem}_[0-9a-f]+\.so", p.name))
    ops = sass_counts(so, needle, opcode)
    regs = ptxas_entries(lib.ptxas_report, needle)
    check(len(ops) == count and all(n > 0 for n in ops.values()),
          f"{opcode} instructions in the kernels of {stem}.cu: {ops}")
    # an empty report means the libraries were loaded from an earlier build
    check(not regs or (len(regs) == count and all(
        r[1] == 0 and r[2] == 0 for r in regs.values())),
          f"the kernels of {stem}.cu spill: {regs}")
    return ops, regs


def phase_build():
    """Build every kernel; the flash kernels must hold tensor-core
    instructions and spill nothing: HGMMA (Hopper's wgmma) in each bf16
    kernel of ``flash_attention_sm90.cu``, HMMA (``mma.sync``) in each
    instance of ``flash_attention.cu`` (fp32 at every head dim, bf16 at
    D = 32)."""
    from repro_torch.kernels.common import library
    from repro_torch.kernels.flash_attention.ops import (
        HEAD_DIMS,
        SM90_HEAD_DIMS,
    )

    lib = library()
    report = [ln.strip() for ln in lib.ptxas_report.splitlines()
              if "Compiling entry" in ln or "Used" in ln]
    hgmma, regs = tensor_core_kernels(lib, "flash_attention_sm90",
                                      "flash_attention_sm90_kernel", "HGMMA",
                                      len(SM90_HEAD_DIMS))
    hmma, regs_tc = tensor_core_kernels(lib, "flash_attention",
                                        "flash_attention_kernel", "HMMA",
                                        len(HEAD_DIMS) + 1)
    emit("build", seconds=lib.build_seconds,
         libraries=[p.name for p in lib.paths], ptxas=report,
         flash_bf16_hgmma=hgmma,
         flash_bf16_registers_spill_store_load=regs,
         flash_hmma=hmma, flash_registers_spill_store_load=regs_tc)


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


class GraphLaunches:
    """A serve engine's paged_attention launches on the card, replays of its
    decode graphs included. The kernel's wrapper counts the calls made to it:
    those of eager passes, and those a decode graph's capture records, which
    run nothing. A shim over the engine's name counts the calls each graph's
    capture records, and each replay of the graph for B launches as many.
    ``undo()`` takes the shim and the engine's wrappers off."""

    def __init__(self, eng):
        import repro_torch.serve.engine as engine_mod

        self._mod, self._eng = engine_mod, eng
        self._inner = inner = engine_mod.paged_attention
        self.held = {}  # B -> the calls recorded in the graph for B
        self.eager = self.captured = self.replayed = 0
        capture, decode_pass = eng._capture, eng._decode_pass

        def shim(*args):
            if torch.cuda.is_current_stream_capturing():
                self.captured += 1
            else:
                self.eager += 1
            return inner(*args)

        def counted_capture(B):
            n0 = self.captured
            capture(B)
            self.held[B] = self.captured - n0

        def counted_pass(B):
            n0 = eng.stats.decode_graph_replays
            out = decode_pass(B)
            if eng.stats.decode_graph_replays > n0:
                self.replayed += self.held[B]
            return out

        engine_mod.paged_attention = shim
        eng._capture, eng._decode_pass = counted_capture, counted_pass

    @property
    def on_card(self) -> int:
        """Launches that ran on the card: eager calls and replayed ones."""
        return self.eager + self.replayed

    def undo(self) -> None:
        self._mod.paged_attention = self._inner
        del self._eng._capture, self._eng._decode_pass


def run_serve(cfg, model, settings, time_ffn: bool = False):
    """Requests through ServeEngine over a KV pool under the unified-memory
    runtime, every launch counter set to 0 just before the run and read just
    after. Times prefill chunks and decode batches apart (each ends
    synchronized) and, in the decode batches that ran eagerly (a size's first
    batch), each paged_attention launch with CUDA events and, with
    ``time_ffn``, each block's ffn: a replayed decode graph calls neither, so
    their shares are of the eager batches' decode time. Checks the kernel
    wrapper's calls and the launches on the card (:class:`GraphLaunches`)
    against the engine's eager, captured and replayed passes. Returns the
    phase's row, the wrapper's calls and the last decode batch's
    paged_attention inputs (its last layer's pools, page-table rows and
    lengths; a query of its shape drawn from a seed, since a replayed graph's
    query lives inside the graph and its values do not change the kernel's
    time)."""
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

    spent = {"prefill": 0.0, "decode": 0.0, "eager": 0.0}
    last, events, ffn_events, in_decode = {}, [], [], [False]
    batch_events, batch_ffn = [], []  # the current decode batch's

    def timed(fn, key):
        def run(*a):
            in_decode[0] = key == "decode"
            replays = eng.stats.decode_graph_replays
            t = time.perf_counter()
            fn(*a)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            spent[key] += dt
            in_decode[0] = False
            if key == "decode":
                last["B"] = len(a[0])
                if eng.stats.decode_graph_replays == replays:  # eager
                    spent["eager"] += dt
                    events.extend(batch_events)
                    ffn_events.extend(batch_ffn)
                # a capturing batch's eager pass before the capture: dropped
                batch_events.clear()
                batch_ffn.clear()
        return run

    def recording(*args):
        if torch.cuda.is_current_stream_capturing():
            return real(*args)  # a decode graph's capture runs nothing
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = real(*args)
        ev[1].record()
        batch_events.append(ev)
        return out

    def ffn_timed(fwd):
        def run(x, policy):
            if not in_decode[0] or torch.cuda.is_current_stream_capturing():
                return fwd(x, policy)
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            y = fwd(x, policy)
            ev[1].record()
            batch_ffn.append(ev)
            return y
        return run

    eng._prefill_chunk_run = timed(eng._prefill_chunk_run, "prefill")
    eng._decode_batch = timed(eng._decode_batch, "decode")
    if time_ffn:
        for blk in model.layers:
            blk.ffn.forward = ffn_timed(blk.ffn.forward)
    real = engine_mod.paged_attention
    engine_mod.paged_attention = recording
    graph_launches = GraphLaunches(eng)
    try:
        counters = zero_counters()
        t0 = time.perf_counter()
        out = eng.run_to_completion()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
    finally:
        graph_launches.undo()
        engine_mod.paged_attention = real
        # the wrappers hold the engine, and the engine holds the model: drop
        # the cycle, so the model's memory goes when the caller drops it
        del eng._prefill_chunk_run, eng._decode_batch
        if time_ffn:
            for blk in model.layers:
                del blk.ffn.forward
    st, n_layers = eng.stats, cfg.num_layers
    eager = st.decode_batches - st.decode_graph_replays
    before_first = min(st.decode_graph_captures, 1)  # the eager pass
    calls = n_layers * (eager + before_first + st.decode_graph_captures)
    check(st.decode_batches > 0 and launches["paged_attention"] == calls,
          f"paged_attention called {launches['paged_attention']} times for "
          f"{eager} eager passes, {before_first} before the first capture "
          f"and {st.decode_graph_captures} captures x {n_layers} layers")
    on_card = n_layers * (st.decode_batches + before_first)
    check(graph_launches.on_card == on_card
          and len(graph_launches.held) == st.decode_graph_captures,
          f"paged_attention launched {graph_launches.on_card} times on the "
          f"card ({graph_launches.replayed} in {st.decode_graph_replays} "
          f"replays of graphs holding {graph_launches.held}), not {on_card}")
    for rid in rids:
        check(eng.requests[rid].done
              and len(out[rid]) == settings["new_tokens"],
              f"request {rid} ended with {len(out[rid])} tokens")
    prefill_tokens = int(sum(len(p) for p in prompts))
    kernel_ms = sum(a.elapsed_time(b) for a, b in events)
    decode_ms, eager_ms = 1e3 * spent["decode"], 1e3 * spent["eager"]
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
        decode_eager_batches=eager, decode_eager_s=spent["eager"],
        paged_attention_ms=kernel_ms, paged_attention_timed_calls=len(events),
        paged_attention_share_of_eager_decode=kernel_ms / eager_ms,
        peak_device_bytes=torch.cuda.max_memory_allocated(),
        launches=launches, paged_attention_on_card=graph_launches.on_card,
        paged_attention_held_by_graph=graph_launches.held,
        stats=dataclasses.asdict(st),
        umem_modeled=dict(hardware="GRACE_HOPPER", clock_s=um.clock,
                          traffic_total=rep["traffic_total"],
                          remote_access_share=rep["remote_access_share"]),
        tokens={rid: out[rid] for rid in rids})
    if time_ffn:
        ffn_ms = sum(a.elapsed_time(b) for a, b in ffn_events)
        row.update(decode_ffn_ms=ffn_ms, decode_ffn_calls=len(ffn_events),
                   decode_ffn_share_of_eager_decode=ffn_ms / eager_ms)
    B = last["B"]
    inputs = eng._inputs.views(B)
    kp, vp = eng.cache.k_pools[-1], eng.cache.v_pools[-1]
    q = torch.randn((B, eng.layout.n_q_eff, cfg.head_dim), dtype=kp.dtype,
                    device="cuda",
                    generator=torch.Generator("cuda").manual_seed(5))
    args = (q, kp, vp, inputs["page_table"].clone(), inputs["lengths"].clone())
    del eng, um, inputs
    return row, launches, args


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
    check(before <= HELD_BYTES_MAX,
          f"{before} bytes still held before olmoe's weights are made")
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


def phase_decode_graphs() -> None:
    """The serve engine's decode graphs against eager passes
    (``DECODE_GRAPHS``): on each reduced config one engine replays a graph a
    batch size, one runs every pass eagerly (its ``_decode_pass`` the layer
    loop itself). Tokens must be equal and the final norm's rows within
    ``rtol`` (whether they are bitwise equal is reported), the final norm
    called once a pass; each size captured once, at its second batch, and
    replayed from then; every step's wrapper calls and launches on the card
    (:class:`GraphLaunches`) as its eager, captured and replayed passes
    say."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine

    s = DECODE_GRAPHS
    sizes = np.cumsum([added for added, _ in s["phases"]]).tolist()
    for arch in s["archs"]:
        cfg = get_config(arch).reduced()
        n_layers = cfg.num_layers
        model = init_params(cfg, torch.Generator("cuda").manual_seed(0),
                            device="cuda")
        runs = {}
        for mode in ("graphs", "eager"):
            eng = ServeEngine(cfg, model, max_seqs=s["max_seqs"],
                              max_len=s["max_len"], page_size=s["page_size"],
                              prefill_chunk=512, device="cuda")
            if mode == "eager":
                eng._decode_pass = eng._decode_layers
            launches = GraphLaunches(eng)
            rows = []
            hook = model.final_norm.register_forward_hook(
                lambda m, a, out, rows=rows: rows.append(out.detach().clone()))
            rng = np.random.default_rng(0)
            steps = []  # (stats delta, wrapper calls, launches on the card)
            try:
                for added, n_steps in s["phases"]:
                    for _ in range(added):
                        eng.add_request(
                            rng.integers(2, cfg.vocab_size, s["prompt_len"]),
                            s["new_tokens"])
                    for _ in range(n_steps):
                        st0 = dataclasses.replace(eng.stats)
                        calls0 = paged_attention.launches
                        card0 = launches.on_card
                        eng.step()
                        st = eng.stats
                        steps.append((
                            (st.decode_batches - st0.decode_batches,
                             st.decode_graph_captures
                             - st0.decode_graph_captures,
                             st.decode_graph_replays
                             - st0.decode_graph_replays),
                            paged_attention.launches - calls0,
                            launches.on_card - card0))
                torch.cuda.synchronize()
            finally:
                hook.remove()
                launches.undo()
            runs[mode] = (eng, rows, steps, launches.held)
        (graphs, g_rows, g_steps, held), (eager, e_rows, e_steps, _) = \
            runs["graphs"], runs["eager"]
        toks = {rid: r.generated for rid, r in graphs.requests.items()}
        check(toks == {rid: r.generated for rid, r in eager.requests.items()},
              f"{arch}: graph replays' tokens differ from eager passes'")
        check(len(g_rows) == len(e_rows)
              == graphs.stats.decode_batches + len(graphs.requests),
              f"{arch}: {len(g_rows)} and {len(e_rows)} final-norm calls for "
              f"{graphs.stats.decode_batches} decode batches and "
              f"{len(graphs.requests)} prompts")
        worst, bitwise = 0.0, True
        for a, b in zip(g_rows, e_rows):
            check(a.shape == b.shape, f"{arch}: final-norm shapes differ")
            worst = max(worst, float((a - b).abs().max() / b.abs().max()))
            bitwise &= torch.equal(a, b)
        check(worst <= s["rtol"],
              f"{arch}: final-norm rows differ by {worst} of their max")
        # each step decodes one batch; a size's second batch captures it
        per_size = [(1, 0, 0), (1, 1, 1), (1, 0, 1)] * len(sizes)
        check([d for d, _, _ in g_steps] == per_size,
              f"{arch}: (batches, captures, replays) a step "
              f"{[d for d, _, _ in g_steps]}, not {per_size}")
        check([d for d, _, _ in e_steps] == [(1, 0, 0)] * len(per_size),
              f"{arch}: the eager engine captured or replayed")
        check(held == {b: n_layers for b in sizes},
              f"{arch}: the graphs hold {held} paged_attention calls")
        # wrapper calls: eager passes, the eager pass before the engine's
        # first capture, captures; on the card: a pass a batch, and that one
        captured = 0
        for d, calls, card in g_steps:
            batches, captures, replays = d
            pre = int(captures > 0 and not captured)
            captured += captures
            want = n_layers * (batches - replays + pre + captures)
            check(calls == want and card == n_layers * (batches + pre),
                  f"{arch}: a step of {d} made {calls} calls and {card} "
                  f"launches, not {want} and {n_layers * (batches + pre)}")
        check([(calls, card) for _, calls, card in e_steps]
              == [(n_layers, n_layers)] * len(e_steps),
              f"{arch}: eager steps' calls and launches {e_steps}")
        emit("decode_graphs", arch=cfg.name, batch_sizes=sizes,
             tokens_equal=True, final_norm_bitwise_equal=bitwise,
             final_norm_widest_rel_diff=worst,
             captures=graphs.stats.decode_graph_captures,
             replays=graphs.stats.decode_graph_replays,
             decode_batches=graphs.stats.decode_batches,
             calls=[c for _, c, _ in g_steps],
             launches_on_card=[k for _, _, k in g_steps])
        del runs, graphs, eager, g_rows, e_rows, model
        torch.cuda.empty_cache()


def greedy(model, toks, new: int):
    """Prefill toks (B,S), then ``new`` greedy decode steps from prefill's
    caches. Returns the tokens (B, new) as lists and, for each, the top-2
    logit margin and max |logit| of the logits it was taken from."""
    B, S = toks.shape
    dev = toks.device
    logits, caches = model.prefill(toks)
    out, margins = [], []
    for i in range(new):
        lg = logits[:, -1]
        top = torch.topk(lg, 2, dim=-1).values
        margins.append(torch.stack([top[:, 0] - top[:, 1],
                                    lg.abs().amax(dim=-1)], -1))
        tok = torch.argmax(lg, dim=-1)
        out.append(tok)
        if i + 1 < new:
            logits, caches = model.decode_step(
                tok[:, None].int(), torch.full((B,), S + i, dtype=torch.int32,
                                               device=dev), caches)
    return (torch.stack(out, 1).tolist(),
            torch.stack(margins, 1).cpu().tolist())


def recurrent_card_vs_cpu(arch: str) -> dict:
    """Check (ii): the reduced arch with the same weights (a numpy tree from
    a seed) on the card and on the CPU gives the same greedy tokens, or
    differs first where the CPU's top-2 logit margin is within rounding."""
    from repro_torch.configs import get_config
    from repro_torch.models import load_jax_params, numpy_params

    cfg = get_config(arch).reduced()
    tree = numpy_params(cfg, seed=3)
    B, S, new = (RECURRENT_SMALL[k] for k in ("batch", "prompt_len",
                                               "new_tokens"))
    toks = np.random.default_rng(3).integers(2, cfg.vocab_size, (B, S))
    got = {dev: greedy(load_jax_params(cfg, tree, dev),
                       torch.as_tensor(toks, device=dev), new)
           for dev in ("cuda", "cpu")}
    (card, _), (cpu, margins) = got["cuda"], got["cpu"]
    flips = []
    for b in range(B):
        i = next((i for i, (x, y) in enumerate(zip(card[b], cpu[b]))
                  if x != y), None)
        if i is not None:
            margin, scale = margins[b][i]
            check(margin < MARGIN_RTOL * scale,
                  f"{cfg.name}: card token {card[b][i]} != cpu {cpu[b][i]} "
                  f"at {i} with top-2 margin {margin}")
            flips.append(dict(seq=b, step=i, margin=margin,
                              margin_tol=MARGIN_RTOL * scale))
    return dict(arch=cfg.name, batch=B, prompt_len=S, new_tokens=new,
                tokens_equal=not flips, flips=flips, tokens=card)


def recurrent_scan_check(arch: str, gen) -> dict:
    """Check (iii) on the card: rwkv6's chunked wkv against its per-token
    oracle at rwkv6's head shape, or the rglru log-depth scan against the
    per-token recurrence at recurrentgemma's width."""
    from repro_torch.models import linear_scan, wkv6_chunked, wkv6_ref

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, device="cuda", generator=gen)

    if arch.startswith("rwkv6"):
        B, S, H, K = WKV_SHAPE
        r, k, v = (randn(B, S, H, K, scale=0.5) for _ in range(3))
        wlog = -torch.exp(randn(B, S, H, K) - 2.0)
        args = (r, k, v, wlog, randn(H, K, scale=0.3),
                torch.zeros(B, H, K, K, device="cuda"))
        y, sT = wkv6_chunked(*args, 128)
        y_ref, sT_ref = wkv6_ref(*args)
        err = max(float((y - y_ref).abs().max()),
                  float((sT - sT_ref).abs().max()))
        row = dict(what="wkv6_chunked vs wkv6_ref", shape=WKV_SHAPE, chunk=128)
    else:
        B, S, w = SCAN_SHAPE
        a = 0.5 + 0.5 * torch.rand((B, S, w), device="cuda", generator=gen)
        b = randn(B, S, w)
        h = linear_scan(a, b)
        h_ref, state = torch.empty_like(b), torch.zeros_like(b[:, 0])
        for t in range(S):
            state = a[:, t] * state + b[:, t]
            h_ref[:, t] = state
        err = float((h - h_ref).abs().max())
        row = dict(what="linear_scan vs the per-token recurrence",
                   shape=SCAN_SHAPE)
    check(err <= RECURRENT_SCAN_TOL, f"{row['what']}: error {err}")
    return dict(row, max_abs_err=err, tol=RECURRENT_SCAN_TOL)


class MixerTimer:
    """CUDA events around each mixer call of ``model`` by layer kind and
    around ``wkv6_chunked`` and the rglru scan, apart for prefill and
    decode; ``close()`` undoes the wrapping."""

    def __init__(self, model):
        import repro_torch.models.rglru as rglru_mod
        import repro_torch.models.rwkv as rwkv_mod

        self.stage, self.events = "prefill", {}
        self.model = model
        self.undo = [(rwkv_mod, "wkv6_chunked", rwkv_mod.wkv6_chunked),
                     (rglru_mod, "linear_scan", rglru_mod.linear_scan)]
        rwkv_mod.wkv6_chunked = self.wrap(rwkv_mod.wkv6_chunked, "wkv6_chunked")
        rglru_mod.linear_scan = self.wrap(rglru_mod.linear_scan, "rglru_scan")
        for blk in model.layers:
            name = "local_attention" if blk.kind == "local" else blk.kind
            blk.mixer.forward = self.wrap(blk.mixer.forward, name)
            if hasattr(blk.mixer, "decode"):
                blk.mixer.decode = self.wrap(blk.mixer.decode, name)

    def wrap(self, fn, name):
        def run(*a, **kw):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = fn(*a, **kw)
            ev[1].record()
            self.events.setdefault((self.stage, name), []).append(ev)
            return out
        return run

    def ms(self) -> dict:
        torch.cuda.synchronize()
        out = {}
        for (stage, name), evs in sorted(self.events.items()):
            out.setdefault(stage, {})[name] = dict(
                calls=len(evs), ms=sum(a.elapsed_time(b) for a, b in evs))
        return out

    def close(self) -> None:
        for mod, attr, fn in self.undo:
            setattr(mod, attr, fn)
        for blk in self.model.layers:
            for attr in ("forward", "decode"):
                blk.mixer.__dict__.pop(attr, None)
        self.model = None


def phase_recurrent() -> None:
    """The recurrent archs at full width on the card (fp32 random weights
    made there from a seed; nothing held from earlier phases above 1 GiB):
    8 prompts of 2304 tokens through ``prefill``, 32 greedy ``decode_step``s
    from its caches, each mixer kind's CUDA-event time; then check (i)
    forward vs prefill + teacher-forced decode at B = 1, (ii) the reduced
    arch's greedy tokens vs the CPU's, (iii) the sequence mixer against its
    per-token form on the card. One line per arch."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    B, S, new = (RECURRENT[k] for k in ("batch", "prompt_len", "new_tokens"))
    for n, arch in enumerate(RECURRENT["archs"]):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        check(before <= HELD_BYTES_MAX,
              f"{before} bytes still held before {arch}'s weights are made")
        cfg = get_config(arch)
        gen = torch.Generator("cuda").manual_seed(n)
        t0 = time.perf_counter()
        model = init_params(cfg, gen, device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        weight_bytes = sum(p.numel() * p.element_size()
                           for p in model.parameters())
        toks = torch.as_tensor(
            np.random.default_rng(n).integers(2, cfg.vocab_size, (B, S)),
            device="cuda")
        counters = zero_counters()
        timer = MixerTimer(model)
        try:
            t0 = time.perf_counter()
            logits, caches = model.prefill(toks)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            check(tuple(logits.shape) == (B, 1, cfg.vocab_size)
                  and bool(torch.isfinite(logits).all()),
                  f"{arch}: prefill logits {tuple(logits.shape)} not finite")
            timer.stage = "decode"
            out, step_s = [], []
            for i in range(new):
                tok = torch.argmax(logits[:, -1], dim=-1)
                out.append(tok)
                t0 = time.perf_counter()
                logits, caches = model.decode_step(
                    tok[:, None].int(),
                    torch.full((B,), S + i, dtype=torch.int32, device="cuda"),
                    caches)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
            check(bool(torch.isfinite(logits).all()),
                  f"{arch}: decode logits not finite")
            mixer_ms = timer.ms()
        finally:
            timer.close()
        launches = {k: fn.launches for k, fn in counters.items()}
        del caches, logits
        peak = torch.cuda.max_memory_allocated()

        # (i) forward over S + extra tokens vs prefill(S) + teacher-forced
        # decode of the extra tokens, B = 1
        x = torch.as_tensor(np.random.default_rng(10 + n).integers(
            2, cfg.vocab_size, (1, S + RECURRENT_FWD_EXTRA)), device="cuda")
        full = model(x)
        lg, caches = model.prefill(x[:, :S])
        errs = [float((lg[:, 0] - full[:, S - 1]).abs().max())]
        for i in range(S, S + RECURRENT_FWD_EXTRA):
            lg, caches = model.decode_step(
                x[:, i:i + 1].int(), torch.tensor([i], dtype=torch.int32,
                                                  device="cuda"), caches)
            errs.append(float((lg[:, 0] - full[:, i]).abs().max()))
        scale = float(full.abs().max())
        del full, lg, caches, x
        fwd_err = max(errs)
        check(fwd_err <= RECURRENT_FWD_RTOL * scale,
              f"{arch}: forward vs prefill + decode differ by {fwd_err} "
              f"(max |logit| {scale})")
        del model
        torch.cuda.empty_cache()
        decode_ms = statistics.median(step_s) * 1e3
        bound = weight_bytes / HBM_BYTES_PER_S * 1e3
        emit("recurrent", arch=arch, params=cfg.param_count(), dtype="float32",
             batch=B, prompt_len=S, new_tokens=new,
             device_bytes_before_init=before, init_s=init_s,
             weight_bytes=weight_bytes, decode_weight_bound_ms=bound,
             prefill_s=prefill_s, prefill_tok_per_s=B * S / prefill_s,
             decode_ms_per_step=decode_ms,
             decode_ms_per_step_mean=sum(step_s) / len(step_s) * 1e3,
             decode_share_of_bound=bound / decode_ms,
             peak_device_bytes=peak, mixer_ms=mixer_ms, launches=launches,
             tokens=torch.stack(out, 1)[:, :8].tolist(),
             tf32=torch.backends.cuda.matmul.allow_tf32,
             check_forward=dict(tokens=S + RECURRENT_FWD_EXTRA,
                                max_abs_err=fwd_err, max_abs_logit=scale,
                                tol=RECURRENT_FWD_RTOL * scale),
             check_card_vs_cpu=recurrent_card_vs_cpu(arch),
             check_scan=recurrent_scan_check(arch, gen))


def held_bytes_ok(what: str) -> int:
    """Fail when earlier phases still hold over ``HELD_BYTES_MAX`` of device
    memory; reset the peak. Returns the bytes held."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    check(before <= HELD_BYTES_MAX,
          f"{before} bytes still held before {what}")
    return before


def train_flops(cfg, tokens: int, seq_len: int) -> float:
    """Model FLOPs of one training step without the remat re-forward: 6 N T
    over the matmul parameters (the embedding gather is not a product) plus
    the attention products over the full S x S square the einsums compute
    (QK^T and PV, forward and twice backward)."""
    d, hd = cfg.d_model, cfg.head_dim
    per_layer = (d * cfg.num_heads * hd * 2 + d * cfg.num_kv_heads * hd * 2
                 + 3 * d * cfg.d_ff)
    n_matmul = cfg.num_layers * per_layer + d * cfg.vocab_size
    attn = 3 * 2 * 2 * seq_len * seq_len * cfg.num_heads * hd \
        * cfg.num_layers * (tokens // seq_len)
    return 6.0 * n_matmul * tokens + attn, n_matmul


def phase_train() -> None:
    """The LM trainer at full width: yi-6b cut to 12 layers, fp32 (TF32 off),
    six steps through ``Trainer`` with two microbatches and remat; per step
    the loss, grad norm, host-clock ms (the loss's read waits for the whole
    step), tokens/s and model FLOP/s against the fp32 peak; the AdamW
    update's CUDA-event ms against its byte bound; the peak device memory.
    Checks: finite losses and grad norms, params that move, and step 1's
    loss equal to a no-grad ``loss_fn`` over the same batch (the remat pass
    against the plain one)."""
    import dataclasses

    import repro_torch.train.trainer as trainer_mod
    from repro_torch.configs import get_config
    from repro_torch.data import DataLoader, SyntheticLM
    from repro_torch.models import RunPolicy, init_params
    from repro_torch.models.transformer import loss_fn
    from repro_torch.train import (Trainer, TrainerConfig, make_train_state,
                                   make_train_step)

    before = held_bytes_ok("the full-width train state is made")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(TRAIN["arch"]),
                              num_layers=TRAIN["layers"])
    B, S = TRAIN["global_batch"], TRAIN["seq_len"]
    t0 = time.perf_counter()
    model = init_params(cfg, seed=TRAIN["seed"], device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == TRAIN["params"], f"yi-6b at 12 layers has {n_params}")
    state = make_train_state(cfg, model)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ds = SyntheticLM(cfg.vocab_size, S, B, seed=TRAIN["seed"])

    # the step's loss on batch 0 by the plain pass: the mean of its two
    # microbatches' losses, no grad, no remat
    toks, labels = (torch.from_numpy(a).to("cuda") for a in ds.batch(0))
    n = B // TRAIN["grad_accum"]
    with torch.no_grad():
        ref = sum(float(loss_fn(model, {"tokens": toks[i:i + n],
                                        "labels": labels[i:i + n]})[0])
                  for i in range(0, B, n)) / TRAIN["grad_accum"]
    del toks, labels
    watch = {name: p.detach()[:4].clone() for name, p in (
        ("embed.w", model.embed.w), ("head.w", model.head.w),
        ("layers.0.mixer.wq", model.layers[0].mixer.wq))}

    tc = TrainerConfig(lr=TRAIN["lr"], warmup_steps=TRAIN["warmup_steps"],
                       total_steps=TRAIN["total_steps"],
                       grad_accum=TRAIN["grad_accum"])
    step_fn = make_train_step(cfg, RunPolicy(remat=True), tc)
    norms, adamw_events = [], []
    adamw = trainer_mod.adamw_update

    def timed_adamw(*a, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = adamw(*a, **kw)
        e1.record()
        adamw_events.append((e0, e1))
        return out

    def recording_step(st, batch):
        st, m = step_fn(st, batch)
        norms.append(m["grad_norm"])
        return st, m

    loader = DataLoader(ds, device="cuda")
    trainer_mod.adamw_update = timed_adamw
    try:
        torch.cuda.synchronize()
        out = Trainer(cfg, state, recording_step, loader).run(TRAIN["steps"])
        torch.cuda.synchronize()
    finally:
        trainer_mod.adamw_update = adamw
        loader.close()
    peak = torch.cuda.max_memory_allocated()
    norms = [float(g) for g in norms]
    adamw_ms = [e0.elapsed_time(e1) for e0, e1 in adamw_events]
    moved = {k: float((p.detach()[:4] - watch[k]).abs().max())
             for k, p in (("embed.w", model.embed.w), ("head.w", model.head.w),
                          ("layers.0.mixer.wq", model.layers[0].mixer.wq))}
    del state, model

    losses = [h["loss"] for h in out["history"]]
    check(all(math.isfinite(x) for x in losses + norms),
          f"train: losses {losses} or grad norms {norms} not finite")
    check(all(v > 0 for v in moved.values()), f"train: params did not move {moved}")
    err = abs(losses[0] - ref) / abs(ref)
    check(err <= TRAIN_REF_RTOL,
          f"train: step 1 loss {losses[0]} vs no-grad loss_fn {ref}")
    tokens = B * S
    flops, n_matmul = train_flops(cfg, tokens, S)
    adamw_bytes = n_params * (16 + 12)  # read g, m, v, w; write m, v, w
    steps = [{"step": h["step"], "loss": h["loss"], "grad_norm": g,
              "ms": h["dt"] * 1e3, "tokens_per_s": tokens / h["dt"],
              "model_tflop_per_s": flops / h["dt"] / 1e12,
              "fp32_peak_share": flops / h["dt"] / FP32_FLOP_PER_S}
             for h, g in zip(out["history"], norms)]
    later = [x["ms"] for x in steps[1:]]
    emit("train", arch=cfg.name, layers=cfg.num_layers, params=n_params,
         matmul_params=n_matmul, dtype="float32",
         tf32=torch.backends.cuda.matmul.allow_tf32, batch=B, seq_len=S,
         grad_accum=TRAIN["grad_accum"], remat=True,
         device_bytes_before_init=before, init_s=init_s,
         model_tflop_per_step=flops / 1e12,
         fp32_bound_ms=flops / FP32_FLOP_PER_S * 1e3, steps=steps,
         step_ms_median_after_first=statistics.median(later),
         adamw=dict(ms=adamw_ms, ms_median=statistics.median(adamw_ms),
                    bytes=adamw_bytes, master_aliased=True,
                    bound_ms=adamw_bytes / HBM_BYTES_PER_S * 1e3),
         peak_device_bytes=peak, params_moved=moved,
         check_step1=dict(loss=losses[0], no_grad_loss=ref, rel_err=err,
                          tol=TRAIN_REF_RTOL))


def _adamw_states_close(what: str, ref_states, states, lrs, b2=0.95,
                        wd=0.1) -> dict:
    """Two runs' per-step train states (numpy trees, the reference first):
    every param within TRAIN_CPU_RTOL of max |param| where the reference's
    sqrt(v_hat) >= ADAMW_ILL at every step so far, and within the AdamW
    bound 2 (1 + wd) * sum(lr) elsewhere. Returns the largest errors and
    the share of weights under the bound."""
    from repro_torch.tree import flatten

    ill, worst, worst_ill = {}, 0.0, 0.0
    for t, (rs, st) in enumerate(zip(ref_states, states), 1):
        rf, sf = flatten(rs), flatten(st)
        scale = max(float(np.abs(v).max()) for k, v in rf.items()
                    if k.startswith("params/"))
        tol = TRAIN_CPU_RTOL * scale
        for k, want in rf.items():
            if not k.startswith("params/"):
                continue
            v_hat = rf["opt/v/" + k[7:]] / (1 - b2 ** t)
            ill[k] = ill.get(k, False) | (np.sqrt(v_hat) < ADAMW_ILL)
            d = np.abs(sf[k] - want)
            worst = max(worst, float(d[~ill[k]].max(initial=0)) / scale)
            worst_ill = max(worst_ill, float(d[ill[k]].max(initial=0)))
            check(d[~ill[k]].max(initial=0) <= tol,
                  f"{what}: step {t} {k} differs by "
                  f"{d[~ill[k]].max(initial=0)} > {tol}")
            check(d[ill[k]].max(initial=0) <= 2 * (1 + wd) * sum(lrs[:t]) + tol,
                  f"{what}: step {t} {k} differs past the AdamW bound")
    n_ill = sum(int(m.sum()) for m in ill.values())
    n = sum(m.size for m in ill.values())
    check(n_ill < 0.2 * n, f"{what}: {n_ill} of {n} weights ill-conditioned")
    return dict(max_err_of_max_param=worst, max_err_ill=worst_ill,
                ill_share=n_ill / n)


def phase_train_card_vs_cpu() -> None:
    """Reduced yi-6b, olmoe-1b-7b, rwkv6-1.6b and recurrentgemma-2b: one
    numpy weight tree loaded on the card and on the CPU, the same
    SyntheticLM batches, 3 steps of two microbatches with remat; losses and
    grad norms within TRAIN_CPU_RTOL, params as ``_adamw_states_close``."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import RunPolicy, load_jax_params, numpy_params
    from repro_torch.models.convert import numpy_train_state
    from repro_torch.train import TrainerConfig, make_train_state, make_train_step

    held_bytes_ok("the reduced archs' weights are made")
    out = {}
    for arch in TRAIN_CPU["archs"]:
        cfg = get_config(arch).reduced()
        tree = numpy_params(cfg, TRAIN_CPU["weights_seed"])
        ds = SyntheticLM(cfg.vocab_size, TRAIN_CPU["seq_len"],
                         TRAIN_CPU["batch"], seed=1, mean_doc_len=8)
        runs = {}
        for dev in ("cpu", "cuda"):
            state = make_train_state(cfg, load_jax_params(cfg, tree, dev))
            step = make_train_step(cfg, RunPolicy(remat=True), TrainerConfig(
                total_steps=10, warmup_steps=2,
                grad_accum=TRAIN_CPU["grad_accum"]))
            metrics, states = [], []
            for i in range(TRAIN_CPU["steps"]):
                toks, labels = (torch.from_numpy(a).to(dev)
                                for a in ds.batch(i))
                state, m = step(state, {"tokens": toks, "labels": labels})
                metrics.append((float(m["loss"]), float(m["grad_norm"]),
                                float(m["lr"])))
                states.append(numpy_train_state(state))
            runs[dev] = (metrics, states)
        (cm, cs), (gm, gs) = runs["cpu"], runs["cuda"]
        for (cl, cg, _), (gl, gg, _) in zip(cm, gm):
            check(abs(gl - cl) <= TRAIN_CPU_RTOL * abs(cl)
                  and abs(gg - cg) <= TRAIN_CPU_RTOL * abs(cg),
                  f"{arch}: card loss/grad norm {gl}/{gg} vs cpu {cl}/{cg}")
        out[arch] = dict(losses_card=[m[0] for m in gm],
                         losses_cpu=[m[0] for m in cm],
                         grad_norms_card=[m[1] for m in gm],
                         grad_norms_cpu=[m[1] for m in cm],
                         **_adamw_states_close(arch, cs, gs,
                                               [m[2] for m in cm]))
    emit("train_card_vs_cpu", steps=TRAIN_CPU["steps"],
         grad_accum=TRAIN_CPU["grad_accum"], remat=True, rtol=TRAIN_CPU_RTOL,
         archs=out)


def phase_train_fault() -> None:
    """``python -m repro_torch.examples.train_100m`` on the card, without and
    with a failure (checkpoints to a temporary directory): one restart, and
    every replayed step's loss equal, bit for bit, to its first run and to
    the uninterrupted run's; the example asserts that the loss improves."""
    import contextlib
    import io
    import tempfile

    from repro_torch.examples import train_100m

    held_bytes_ok("train_100m's weights are made")
    runs, t_run = {}, {}
    for name, extra in (("plain", []),
                        ("fail", ["--fail-at", str(TRAIN_FAULT["fail_at"])])):
        with tempfile.TemporaryDirectory() as tmp:
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                runs[name] = train_100m.main(
                    ["--steps", str(TRAIN_FAULT["steps"]), "--ckpt-dir", tmp]
                    + extra)
            t_run[name] = time.perf_counter() - t0
    plain = {h["step"]: h["loss"] for h in runs["plain"]["history"]}
    check(runs["fail"]["restarts"] == 1,
          f"train_100m restarted {runs['fail']['restarts']} times")
    seen, replayed = {}, 0
    for h in runs["fail"]["history"]:
        if h["step"] in seen:
            replayed += 1
            check(h["loss"] == seen[h["step"]],
                  f"train_100m: replayed step {h['step']} loss {h['loss']} "
                  f"!= {seen[h['step']]}")
        seen[h["step"]] = h["loss"]
    # the failed run spends part of its step budget on the replay, so it
    # ends earlier: compare the steps both ran
    differ = [k for k in seen if seen[k] != plain[k]]
    check(not differ and max(seen) >= TRAIN_FAULT["fail_at"],
          f"train_100m: the failed run's losses at steps {differ} differ "
          "from the uninterrupted run's")
    losses = [h["loss"] for h in runs["plain"]["history"]]
    emit("train_fault", steps=TRAIN_FAULT["steps"], fail_at=TRAIN_FAULT["fail_at"],
         ckpt_every=train_100m.CKPT_EVERY, restarts=runs["fail"]["restarts"],
         replayed_steps=replayed, replay_bit_equal=True,
         first_loss=losses[0], last_loss=losses[-1], wall_s=t_run,
         deterministic_algorithms=torch.are_deterministic_algorithms_enabled())


def phase_umtrain() -> None:
    """``UMTrainer("train_100m")`` on the card under system x1.0, system x1.5
    and managed x1.5, 3 steps each, and the same on the CPU: the card's
    losses bit-identical across the three; the modeled clock, traffic and
    eff_ratio equal the CPU's bit for bit; the losses within
    UMTRAIN_LOSS_RTOL of the CPU's. Wall ms a step on the card."""
    from repro_torch.train import UMTrainer

    held_bytes_ok("the UM-backed trainer's state is made")
    rows = []
    for policy, ratio in UMTRAIN["cells"]:
        res = {}
        for dev in ("cuda", "cpu"):
            tr = UMTrainer(UMTRAIN["spec"], policy=policy, ratio=ratio,
                           device=dev)
            if dev == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = tr.run(UMTRAIN["steps"])
            if dev == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            rep = tr.um.prof.report()
            res[dev] = dict(losses=out["losses"], clock=tr.um.clock,
                            traffic=rep["traffic_total"],
                            eff_ratio=out["eff_ratio"],
                            wall_ms_per_step=wall / UMTRAIN["steps"] * 1e3)
            tr.close()
        card, cpu = res["cuda"], res["cpu"]
        for k in ("clock", "traffic", "eff_ratio"):
            check(card[k] == cpu[k], f"umtrain {policy} x{ratio}: {k} "
                  f"{card[k]} on the card != {cpu[k]} on the cpu")
        check(all(abs(a - b) <= UMTRAIN_LOSS_RTOL * abs(b)
                  for a, b in zip(card["losses"], cpu["losses"])),
              f"umtrain {policy} x{ratio}: losses {card['losses']} vs "
              f"{cpu['losses']}")
        rows.append(dict(policy=policy, ratio=ratio, losses=card["losses"],
                         losses_cpu=cpu["losses"], modeled_clock_s=card["clock"],
                         eff_ratio=card["eff_ratio"],
                         migrated_out=card["traffic"]["migrated_out"],
                         wall_ms_per_step=card["wall_ms_per_step"],
                         wall_ms_per_step_cpu=cpu["wall_ms_per_step"]))
    check(all(r["losses"] == rows[0]["losses"] for r in rows),
          "umtrain: the card's losses differ across policies and ratios")
    emit("umtrain", spec=UMTRAIN["spec"], steps=UMTRAIN["steps"],
         charges_equal_cpu=True, losses_equal_across_cells=True, cells=rows)


def _launch_ranks_worker(rank: int, port: int, out: str) -> None:
    """One rank of phase launch's data 2 x model 2 world on the card."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.mesh import end_world, make_host_mesh, start_world
    from repro_torch.launch.sharding import (gather_tree, make_run_policy,
                                             shard_model_)
    from repro_torch.models import load_jax_params, numpy_params
    from repro_torch.models.parallel import HOST_STAGED, Axis
    from repro_torch.models.qcomm import quantized_allreduce
    from repro_torch.train import TrainerConfig, make_train_state, make_train_step
    from repro_torch.tree import flatten

    L = LAUNCH_RANKS
    torch.cuda.set_device(0)
    start_world(rank, L["data"] * L["model"], backend="gloo", port=port)
    try:
        mesh = make_host_mesh(L["data"], L["model"])
        res, staged = {}, {}
        for sp in (False, True):
            HOST_STAGED.clear()
            for arch in L["archs"]:
                cfg = get_config(arch).reduced()
                model = load_jax_params(cfg, numpy_params(
                    cfg, L["weights_seed"], tp=L["model"]), "cuda", tp=L["model"])
                shard_model_(model, mesh)
                state = make_train_state(cfg, model)
                step = make_train_step(
                    cfg, make_run_policy(mesh, remat=True, sequence_parallel=sp),
                    TrainerConfig(total_steps=10, warmup_steps=2,
                                  grad_accum=L["grad_accum"], tp=L["model"]))
                ds = SyntheticLM(cfg.vocab_size, L["seq_len"], L["batch"], seed=1,
                                 mean_doc_len=8)
                metrics, params = [], []
                for i in range(L["steps"]):
                    toks, labels = (torch.from_numpy(a).cuda() for a in ds.batch(i))
                    state, m = step(state, {"tokens": toks, "labels": labels})
                    metrics.append((float(m["loss"]), float(m["grad_norm"])))
                    full = gather_tree(state["params"], model.param_specs, mesh)
                    params.append({k: v.cpu().numpy().copy()
                                   for k, v in flatten(full).items()})
                res[(arch, sp)] = (metrics, params)
            staged["seqpar" if sp else "unsplit"] = dict(HOST_STAGED)
        HOST_STAGED.clear()
        # the int8 TP all-reduce over the world, on the card and on the CPU
        n = dist.get_world_size()
        y = np.random.default_rng(7).standard_normal(
            (n, 2, 16, 1024)).astype(np.float32)[rank]
        ax = Axis(dist.group.WORLD, n, rank)
        q_card = quantized_allreduce(torch.from_numpy(y).cuda(), ax).cpu().numpy()
        q_cpu = quantized_allreduce(torch.from_numpy(y), ax).numpy()
        staged["q8_allreduce"] = dict(HOST_STAGED)
        if rank == 0:
            torch.save({"archs": res, "q_card": q_card, "q_cpu": q_cpu,
                        "host_staged": staged}, out)
    finally:
        end_world()


def phase_launch() -> None:
    """The launch layer on the card: launch_full, launch_ranks,
    launch_seqpar and kv_int8 (see LAUNCH_FULL, LAUNCH_RANKS, LAUNCH_SEQPAR
    and KV_INT8). Every number is printed
    with the card's name and power limit."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    launch_full(smi)
    launch_ranks(smi)
    launch_seqpar(smi)
    kv_int8(smi)


def launch_full(smi: str) -> None:
    """``repro_torch.launch.train.main`` in-process (NCCL, one rank, mesh
    1 x 1) against ``make_train_step`` with the same TrainerConfig on the
    same initial state and batches: step 1's loss bit-equal, step 2's loss
    within LAUNCH_RTOL and the params as phase train_card_vs_cpu holds them
    (LAUNCH_RTOL of max |param| where the reference's sqrt(v_hat) >=
    ADAMW_ILL at both steps, the AdamW bound elsewhere)."""
    import contextlib
    import dataclasses
    import io

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train as launch_train
    from repro_torch.models import RunPolicy, init_params
    from repro_torch.train import TrainerConfig, make_train_state, make_train_step
    from repro_torch.tree import flatten

    F_ = LAUNCH_FULL
    torch.backends.cuda.matmul.allow_tf32 = False
    held_bytes_ok("launch_full's reference state is made")
    cfg = dataclasses.replace(get_config("yi-6b"), num_layers=F_["layers"])
    model = init_params(cfg, seed=F_["seed"], dtype=torch.float32, device="cuda")
    state = make_train_state(cfg, model)
    tc = TrainerConfig(lr=3e-4, total_steps=F_["steps"],
                       warmup_steps=max(1, F_["steps"] // 10),
                       grad_accum=F_["accum"])
    step = make_train_step(cfg, RunPolicy(remat=True), tc)
    ds = SyntheticLM(cfg.vocab_size, F_["seq"], F_["batch"], seed=F_["seed"])
    ref_losses, ref_ms, ill, lrs = [], [], {}, []
    b2 = 0.95
    for i in range(F_["steps"]):
        toks, labels = (torch.from_numpy(a).cuda() for a in ds.batch(i))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, {"tokens": toks, "labels": labels})
        ref_losses.append(float(m["loss"]))
        ref_ms.append((time.perf_counter() - t0) * 1e3)
        lrs.append(float(m["lr"]))
        with torch.no_grad():
            for k, v in flatten(state["opt"]["v"]).items():
                bad = (v / (1 - b2 ** (i + 1))).sqrt_() < ADAMW_ILL
                ill[k] = bad if k not in ill else ill[k] | bad
    ref_peak = torch.cuda.max_memory_allocated()
    ref_params = {k: p.detach().cpu() for k, p in flatten(state["params"]).items()}
    ill = {k: v.cpu() for k, v in ill.items()}
    del state, model, step, m, toks, labels
    held_bytes_ok("launch.train's state is made")

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = launch_train.main(
            ["--arch", "yi-6b", "--layers", str(F_["layers"]),
             "--steps", str(F_["steps"]), "--batch", str(F_["batch"]),
             "--accum", str(F_["accum"]), "--seq", str(F_["seq"]),
             "--seed", str(F_["seed"]), "--device", "cuda"])
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in out["history"]]
    check(losses[0] == ref_losses[0],
          f"launch_full: step 1 loss {losses[0]} != make_train_step's "
          f"{ref_losses[0]}")
    check(abs(losses[1] - ref_losses[1]) <= LAUNCH_RTOL * abs(ref_losses[1]),
          f"launch_full: step 2 loss {losses[1]} vs {ref_losses[1]}")
    got = flatten(out["state"]["params"])
    scale = max(float(p.abs().max()) for p in ref_params.values())
    worst = worst_ill = 0.0
    n_ill = n = 0
    for k, want in ref_params.items():
        d = (got[k].detach() - want.cuda()).abs()
        bad = ill[k].cuda()
        ok_err = float(d[~bad].max()) if (~bad).any() else 0.0
        ill_err = float(d[bad].max()) if bad.any() else 0.0
        check(ok_err <= LAUNCH_RTOL * scale,
              f"launch_full: {k} differs by {ok_err} > {LAUNCH_RTOL * scale}")
        check(ill_err <= 2 * 1.1 * sum(lrs) + LAUNCH_RTOL * scale,
              f"launch_full: {k} differs past the AdamW bound")
        worst, worst_ill = max(worst, ok_err / scale), max(worst_ill, ill_err)
        n_ill, n = n_ill + int(bad.sum()), n + bad.numel()
    # no bound on the ill share here: at full width most embedding rows see
    # no token in 4096 and keep v = 0 (both runs move them by decay alone)
    emit("launch_full", card=smi, arch="yi-6b", layers=F_["layers"],
         backend=out["backend"], world=1, mesh="1x1", batch=F_["batch"],
         grad_accum=F_["accum"], seq_len=F_["seq"], losses=losses,
         losses_make_train_step=ref_losses, step1_bit_equal=True,
         step_ms=[h["dt"] * 1e3 for h in out["history"]],
         step_ms_make_train_step=ref_ms, peak_device_gb=peak / 1e9,
         peak_device_gb_make_train_step=ref_peak / 1e9,
         max_param_err_of_max_param=worst, max_err_ill=worst_ill,
         ill_share=n_ill / n, summary=buf.getvalue().strip())
    del out, got


def launch_ranks(smi: str) -> None:
    """A data 2 x model 2 world of 4 processes on cuda:0 over gloo (every
    collective's CUDA tensors staged through the host): each reduced arch
    two steps of two microbatches, without and with sequence parallelism,
    against the one-rank card step on the same weights and batches (losses
    and grad norms within LAUNCH_RTOL, params as ``_adamw_states_close`` at
    LAUNCH_RTOL); the int8 TP all-reduce on CUDA tensors within one
    quantization step of the CPU's."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.mesh import free_port
    from repro_torch.models import RunPolicy, load_jax_params, numpy_params
    from repro_torch.models.convert import numpy_train_state
    from repro_torch.train import TrainerConfig, make_train_state, make_train_step

    L = LAUNCH_RANKS
    held_bytes_ok("launch_ranks' world starts")
    world = L["data"] * L["model"]
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "ranks.pt")
        t0 = time.perf_counter()
        torch.multiprocessing.spawn(_launch_ranks_worker, nprocs=world,
                                    args=(free_port(), path))
        wall = time.perf_counter() - t0
        res = torch.load(path, weights_only=False)
    rows = {}
    for arch in L["archs"]:
        cfg = get_config(arch).reduced()
        tree = numpy_params(cfg, L["weights_seed"], tp=L["model"])
        state = make_train_state(cfg, load_jax_params(cfg, tree, "cuda",
                                                      tp=L["model"]))
        step = make_train_step(cfg, RunPolicy(remat=True), TrainerConfig(
            total_steps=10, warmup_steps=2, grad_accum=L["grad_accum"],
            tp=L["model"]))
        ds = SyntheticLM(cfg.vocab_size, L["seq_len"], L["batch"], seed=1,
                         mean_doc_len=8)
        ref_m, ref_states, lrs = [], [], []
        for i in range(L["steps"]):
            toks, labels = (torch.from_numpy(a).cuda() for a in ds.batch(i))
            state, m = step(state, {"tokens": toks, "labels": labels})
            ref_m.append((float(m["loss"]), float(m["grad_norm"])))
            lrs.append(float(m["lr"]))
            ref_states.append(numpy_train_state(state))
        for sp in (False, True):
            what = f"launch_ranks {arch}{' seqpar' if sp else ''}"
            metrics, params = res["archs"][(arch, sp)]
            for (gl, gg), (rl, rg) in zip(metrics, ref_m):
                check(abs(gl - rl) <= LAUNCH_RTOL * abs(rl)
                      and abs(gg - rg) <= LAUNCH_RTOL * abs(rg),
                      f"{what}: loss/grad norm {gl}/{gg} vs one rank's {rl}/{rg}")
            states = [{"params/" + k: v for k, v in p.items()} for p in params]
            rows[f"{arch}{'/seqpar' if sp else ''}"] = dict(
                losses=[m[0] for m in metrics],
                losses_one_rank=[m[0] for m in ref_m],
                grad_norms=[m[1] for m in metrics],
                grad_norms_one_rank=[m[1] for m in ref_m],
                **_adamw_states_close(what, ref_states, states, lrs))
    q_card, q_cpu = res["q_card"], res["q_cpu"]
    B, S, d = q_cpu.shape
    step_q = np.abs(q_cpu.reshape(B, S, world, d // world)).max(-1, keepdims=True) / 127
    step_q = np.broadcast_to(step_q, (B, S, world, d // world)).reshape(B, S, d)
    q_err = float(np.abs(q_card - q_cpu).max())
    check(bool(np.all(np.abs(q_card - q_cpu) <= step_q * (1 + 1e-6))),
          f"launch_ranks: the card's int8 all-reduce is off the CPU's by {q_err}")
    emit("launch_ranks", card=smi, world=world, mesh="2x2", backend="gloo",
         device="cuda:0 for every rank",
         host_staged_collectives=res["host_staged"], wall_s=wall,
         steps=L["steps"], grad_accum=L["grad_accum"], rtol=LAUNCH_RTOL,
         archs=rows, q8_allreduce=dict(shape=[B, S, d], max_abs_err=q_err,
                                       max_step=float(step_q.max())))


def _launch_seqpar_worker(rank: int, port: int, out: str) -> None:
    """One rank of launch_seqpar's data 1 x model 2 world on cuda:0: the
    same weights and batches trained without, then with, sequence
    parallelism (each run's step ms, peak memory and host-staged
    collectives), the second run's params held to the first's on this
    rank's shards at each step, then a prefill of the trained model with
    and without it. Every check compares the world's largest error, so
    both ranks pass or fail together. Writes ``out``.rank<r>.json."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.mesh import end_world, make_host_mesh, start_world
    from repro_torch.launch.sharding import make_run_policy, shard_model_
    from repro_torch.models import init_params
    from repro_torch.models.parallel import HOST_STAGED, Axis, all_reduce_
    from repro_torch.train import TrainerConfig, make_train_state, make_train_step
    from repro_torch.tree import flatten

    L = LAUNCH_SEQPAR
    b2, wd = 0.95, 0.1
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    # cuBLAS keeps its workspace (64 MiB on the H100) once it has run a
    # product: make it before the first run, so both runs start alike
    torch.ones((8, 8), device="cuda") @ torch.ones((8, 8), device="cuda")
    start_world(rank, L["data"] * L["model"], backend="gloo", port=port)
    try:
        mesh = make_host_mesh(L["data"], L["model"])
        world = Axis(dist.group.WORLD, L["data"] * L["model"], rank)

        def world_max(x: float) -> float:
            t = torch.tensor([x], dtype=torch.float64)
            return float(all_reduce_(t, world, dist.ReduceOp.MAX))

        cfg = dataclasses.replace(get_config(L["arch"]), num_layers=L["layers"])
        ds = SyntheticLM(cfg.vocab_size, L["seq"], L["batch"], seed=L["seed"])
        batches = [ds.batch(i) for i in range(L["steps"])]
        tc = TrainerConfig(lr=3e-4, total_steps=L["steps"], warmup_steps=1,
                           weight_decay=wd, tp=L["model"])
        runs, ref, ill = {}, [], []
        for sp in (False, True):
            model = init_params(cfg, seed=L["seed"], tp=L["model"], device="cuda")
            shard_model_(model, mesh)
            torch.cuda.empty_cache()
            state = make_train_state(cfg, model)
            step = make_train_step(
                cfg, make_run_policy(mesh, remat=True, sequence_parallel=sp), tc)
            HOST_STAGED.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.memory_allocated()
            metrics, step_ms, lrs, errs = [], [], [], []
            for i, (toks, labels) in enumerate(batches):
                batch = {"tokens": torch.from_numpy(toks).cuda(),
                         "labels": torch.from_numpy(labels).cuda()}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step(state, batch)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
                step_ms.append((time.perf_counter() - t0) * 1e3)
                lrs.append(float(m["lr"]))
                params = flatten(state["params"])
                with torch.no_grad():
                    if not sp:  # the reference: params and ill-conditioned weights
                        ref.append({k: p.to("cpu", copy=True)
                                    for k, p in params.items()})
                        v = flatten(state["opt"]["v"])
                        ill.append({k: ((v[k] / (1 - b2 ** (i + 1))).sqrt()
                                        < ADAMW_ILL).cpu() | (ill[-1][k] if ill
                                                              else False)
                                    for k in params})
                        continue
                    worst = worst_ill = 0.0
                    for k, p in params.items():
                        d = (p - ref[i][k].cuda()).abs()
                        bad = ill[i][k].cuda()
                        worst = max(worst, float(d[~bad].max())
                                    if (~bad).any() else 0.0)
                        worst_ill = max(worst_ill, float(d[bad].max())
                                        if bad.any() else 0.0)
                    scale = world_max(max(float(t.abs().max())
                                          for t in ref[i].values()))
                    worst, worst_ill = world_max(worst), world_max(worst_ill)
                    check(worst <= LAUNCH_RTOL * scale,
                          f"launch_seqpar: step {i + 1} params differ by "
                          f"{worst} > {LAUNCH_RTOL * scale}")
                    check(worst_ill <= 2 * (1 + wd) * sum(lrs) + LAUNCH_RTOL * scale,
                          f"launch_seqpar: step {i + 1} params past the AdamW bound")
                    errs.append(dict(max_err_of_max_param=worst / scale,
                                     max_err_ill=worst_ill))
            runs["seqpar" if sp else "unsplit"] = dict(
                losses=[m[0] for m in metrics], grad_norms=[m[1] for m in metrics],
                step_ms=step_ms, peak_device_gb=torch.cuda.max_memory_allocated() / 1e9,
                start_device_gb=start / 1e9, host_staged=dict(HOST_STAGED),
                param_errs=errs)
            if not sp:  # nothing of the first run stays on the card
                del state, step, model, params, v, m
                torch.cuda.empty_cache()
        # the trained model's prefill without and with sequence parallelism
        toks = torch.from_numpy(batches[0][0]).cuda()
        outs, prefill = [], {}
        for sp in (False, True):
            HOST_STAGED.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(model.prefill(toks, make_run_policy(mesh, sequence_parallel=sp)))
            torch.cuda.synchronize()
            prefill["seqpar" if sp else "unsplit"] = dict(
                ms=(time.perf_counter() - t0) * 1e3, host_staged=dict(HOST_STAGED))
        (la, ca), (lb, cb) = outs
        pairs = [(ca[i][k], cb[i][k]) for i in range(len(ca)) for k in ca[i]]
        got = dict(logit_err=world_max(float((la - lb).abs().max())),
                   logit_scale=world_max(float(la.abs().max())),
                   cache_err=world_max(max(float((a - b).abs().max())
                                           for a, b in pairs)),
                   cache_scale=world_max(max(float(a.abs().max()) for a, _ in pairs)))
        check(got["logit_err"] <= SEQPAR_PREFILL_RTOL * got["logit_scale"]
              and got["cache_err"] <= SEQPAR_PREFILL_RTOL * got["cache_scale"],
              f"launch_seqpar: the seqpar prefill differs: {got}")
        prefill.update(got)
        with open(f"{out}.rank{rank}.json", "w") as f:
            json.dump({"runs": runs, "prefill": prefill}, f)
    finally:
        end_world()


def launch_seqpar(smi: str) -> None:
    """Full-width yi-6b cut to 4 layers on a data 1 x model 2 world of two
    processes on cuda:0 over gloo: two train steps with remat, then a
    prefill, without and with sequence parallelism from the same weights and
    batches. Losses and grad norms within LAUNCH_RTOL, params within
    LAUNCH_RTOL of max |param| (the AdamW bound where the first run's update
    is ill-conditioned), last logits and caches within SEQPAR_PREFILL_RTOL of
    their max |value|; step ms, each rank's peak memory and the collectives
    staged through the host printed for each run."""
    import dataclasses
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import free_port

    L = LAUNCH_SEQPAR
    held_bytes_ok("launch_seqpar's world starts")
    world = L["data"] * L["model"]
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "seqpar")
        t0 = time.perf_counter()
        torch.multiprocessing.spawn(_launch_seqpar_worker, nprocs=world,
                                    args=(free_port(), path))
        wall = time.perf_counter() - t0
        ranks = [json.loads(Path(f"{path}.rank{r}.json").read_text())
                 for r in range(world)]
    runs = ranks[0]["runs"]
    a, b = runs["unsplit"], runs["seqpar"]
    for t, pair in enumerate(zip(b["losses"], a["losses"], b["grad_norms"],
                                 a["grad_norms"]), 1):
        gl, rl, gg, rg = pair
        check(abs(gl - rl) <= LAUNCH_RTOL * abs(rl)
              and abs(gg - rg) <= LAUNCH_RTOL * abs(rg),
              f"launch_seqpar: step {t} loss/grad norm {gl}/{gg} vs {rl}/{rg} "
              f"without sequence parallelism")
    for name, run in runs.items():
        for key in ("peak_device_gb", "start_device_gb"):
            run[key] = [r["runs"][name][key] for r in ranks]
        run["peak_over_start_gb"] = [p - s for p, s in zip(run["peak_device_gb"],
                                                          run["start_device_gb"])]
    cfg = dataclasses.replace(get_config(L["arch"]), num_layers=L["layers"])
    emit("launch_seqpar", card=smi, arch=L["arch"], layers=L["layers"],
         params=cfg.param_count(), world=world, mesh="1x2", backend="gloo",
         device="cuda:0 for both ranks", batch=L["batch"], seq_len=L["seq"],
         steps=L["steps"], remat=True, rtol=LAUNCH_RTOL, wall_s=wall,
         runs=runs, prefill=ranks[0]["prefill"],
         prefill_rtol=SEQPAR_PREFILL_RTOL)


def kv_int8(smi: str) -> None:
    """Full-width yi-6b: prefill 8 x 922 tokens, then 32 decode steps from a
    dense fp cache and from its int8 copy, both fed the fp run's greedy
    tokens: at each step the softmax within KV_INT8_SOFTMAX_ATOL and the
    logits within KV_INT8_LOGIT_RTOL of max |logit|, and the greedy tokens
    agree at KV_INT8_AGREE_MIN or more. Two corrupted int8 caches (each
    prompt token's scales from the token before it; K's and V's scales
    swapped) run the same steps, and each must fail one of these checks.
    Prints the readings, both caches' bytes and CUDA-event ms a step of
    both."""
    from repro_torch.configs import get_config
    from repro_torch.models import RunPolicy, init_cache, init_params
    from repro_torch.models.attention import quantize_cache

    K = KV_INT8
    held_bytes_ok("kv_int8's weights are made")
    cfg = get_config(K["arch"])
    model = init_params(cfg, seed=K["seed"], device="cuda")
    B, P, N = K["batch"], K["prompt_len"], K["new_tokens"]
    gen = torch.Generator("cuda").manual_seed(K["seed"])
    toks = torch.randint(2, cfg.vocab_size, (B, P), generator=gen,
                         device="cuda", dtype=torch.int32)
    logits, pre = model.prefill(toks)
    corrupt = {"int8_scales_of_the_token_before":
               lambda q: dict(q, ks=q["ks"].roll(1, 1), vs=q["vs"].roll(1, 1)),
               "int8_k_and_v_scales_swapped":
               lambda q: dict(q, ks=q["vs"], vs=q["ks"])}
    caches = {"fp": init_cache(cfg, B, P + N, dtype=torch.float32, device="cuda")}
    for name in ("int8", *corrupt):
        caches[name] = init_cache(cfg, B, P + N, dtype=torch.float32,
                                  kv_quant=True, device="cuda")
    for i, c in enumerate(pre):
        for k in ("k", "v"):
            caches["fp"][i][k][:, :P] = c[k]
        q = quantize_cache(c)
        for name, fn in (("int8", dict), *corrupt.items()):
            for k, t in fn(q).items():
                caches[name][i][k][:, :P] = t
    del pre
    nbytes = {name: sum(t.numel() * t.element_size() for c in caches[name]
                        for t in c.values()) for name in ("fp", "int8")}
    tok = torch.argmax(logits[:, -1], -1)
    events = {"fp": [], "int8": []}
    read = {name: {"softmax": [], "logit_rel": [], "agree": []}
            for name in caches if name != "fp"}
    for i in range(N):
        pos = torch.full((B,), P + i, dtype=torch.int32, device="cuda")
        lgs = {}
        for name in caches:
            pol = RunPolicy(kv_cache_quant=name != "fp")
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            lg, caches[name] = model.decode_step(tok[:, None].int(), pos,
                                                 caches[name], pol)
            e1.record()
            lgs[name] = lg[:, 0].float()
            if name in events:
                events[name].append((e0, e1))
        torch.cuda.synchronize()
        ref, p_ref = lgs["fp"], torch.softmax(lgs["fp"], -1)
        top = float(ref.abs().max())
        for name, r in read.items():
            r["softmax"].append(float((torch.softmax(lgs[name], -1)
                                       - p_ref).abs().max()))
            r["logit_rel"].append(float((lgs[name] - ref).abs().max()) / top)
            r["agree"].append(float((lgs[name].argmax(-1)
                                     == ref.argmax(-1)).float().mean()))
        tok = ref.argmax(-1)  # teacher forcing on the fp run
    summary = {name: {"softmax_max_err": max(r["softmax"]),
                      "logit_max_rel_err": max(r["logit_rel"]),
                      "greedy_agreement_share": statistics.mean(r["agree"])}
               for name, r in read.items()}

    def passes(x):
        return (x["softmax_max_err"] <= KV_INT8_SOFTMAX_ATOL
                and x["logit_max_rel_err"] <= KV_INT8_LOGIT_RTOL
                and x["greedy_agreement_share"] >= KV_INT8_AGREE_MIN)

    step_ms = {name: [e0.elapsed_time(e1) for e0, e1 in ev]
               for name, ev in events.items()}
    emit("kv_int8", card=smi, arch=K["arch"], batch=B, prompt_len=P,
         new_tokens=N, softmax_atol=KV_INT8_SOFTMAX_ATOL,
         logit_rtol=KV_INT8_LOGIT_RTOL, agreement_min=KV_INT8_AGREE_MIN,
         readings=summary,
         cache_bytes=nbytes, step_ms_median={k: statistics.median(v[1:])
                                             for k, v in step_ms.items()},
         step_ms=step_ms)
    x = summary["int8"]
    check(x["softmax_max_err"] <= KV_INT8_SOFTMAX_ATOL,
          f"kv_int8: softmax off the fp cache's by {x['softmax_max_err']}")
    check(x["logit_max_rel_err"] <= KV_INT8_LOGIT_RTOL,
          f"kv_int8: logits off the fp cache's by {x['logit_max_rel_err']} "
          "of max |logit|")
    check(x["greedy_agreement_share"] >= KV_INT8_AGREE_MIN,
          f"kv_int8: greedy tokens agree at {x['greedy_agreement_share']}")
    for name in corrupt:
        check(not passes(summary[name]),
              f"kv_int8: the checks pass a corrupted cache ({name})")
    del model, caches


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

    def route(cfg, p, xt, E, policy=None):
        probs, gate_vals, idx = real_route(cfg, p, xt, E, policy)
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
    training = [k for k in figures if k.startswith("train/")]
    check(len(training) == 12, f"train_oversub printed {training}")
    snapshots = sorted(p.name for p in (json_dir / "card").glob("*.json"))
    check(snapshots == ["BENCH_cluster.json", "BENCH_fault.json",
                        "BENCH_lmserve.json", "BENCH_train.json"],
          f"the serving benchmarks wrote {snapshots}")
    emit("bench", modules=MODULES + BENCH_BY_NAME, env=BENCH_SMOKE,
         wall_s=wall, figure_rows=len(figures), serving_rows=len(serving),
         training_rows=len(training),
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
    nbytes = size * (2 * B * Sq * H * D + 2 * B * Sk * Hkv * D)
    if dtype == torch.float32:
        # fp32 accuracy on the tensor cores takes three TF32 products a
        # product (3xTF32); the fp32 FMA rate's bound stands beside it
        b, by = bound_ms(nbytes, 3 * flops, TF32_FLOP_PER_S)
        fma_b = flops / FP32_FLOP_PER_S * 1e3
    else:
        b, by = bound_ms(nbytes, flops, BF16_FLOP_PER_S)
        fma_b = None
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
        trace=device_kernels(lambda: flash_attention(q, k, v, window=window)),
        library_trace=device_kernels(library),
        plain_ms=median_ms(lambda: flash_attention_ref(q, k, v, window=window),
                           3, warmup=1),
        bound_ms=b, bound_by=by, fma_bound_ms=fma_b, flops=flops,
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

    # flash attention at the full-width prefill shapes, and in fp32 at the
    # harness's shape (kernels_micro's launches); yi-6b's fp32 row stands
    # for the kernel in the kernels line
    for name, (shape, window) in FLASH_FULL.items():
        for dtype in (torch.float32, torch.bfloat16):
            key = f"flash_attention_{name}_{str(dtype)[6:]}"
            out[key] = time_flash(shape, window, dtype, gen)
    out["flash_attention_micro_float32"] = time_flash(
        FLASH_MICRO, 0, torch.float32, gen)
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
    phase_decode_graphs()
    phase_recurrent()
    counters = zero_counters()  # the training paths launch none of the four
    phase_train()
    phase_train_card_vs_cpu()
    phase_train_fault()
    phase_umtrain()
    phase_launch()
    launches_in_training = {k: fn.launches for k, fn in counters.items()}
    check(not any(launches_in_training.values()),
          f"the training and launch phases launched {launches_in_training}")
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
    # the main path (kernels_micro) runs flash in fp32: its bound is three
    # TF32 products at the tensor cores' rate, the FMA rate's beside it, and
    # its time at the harness's own shape; the bf16 kernel (wgmma) at yi-6b's
    # prefill beside it
    flash = kernels[-1]
    flash["fma_bound_ms"] = times["flash_attention"]["fma_bound_ms"]
    t = times["flash_attention_micro_float32"]
    flash["micro"] = {k: t[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "fma_bound_ms",
                                        "library_ms", "shape")}
    t = times["flash_attention_yi-6b_bfloat16"]
    flash["bf16"] = {
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
