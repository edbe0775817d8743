"""Needleman-Wunsch sequence alignment (Rodinia). Irregular, CPU-init.

Anti-diagonal wavefront DP in its row-associative form: each row is one
max-plus prefix, computed with a cummax instead of a serial column loop
(see :func:`nw_step`)."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.apps.common import (
    KB,
    AppResult,
    AppSpec,
    DeviceTimer,
    finish,
    make_um,
)
from repro_torch.core import Actor, KernelLaunch
from repro_torch.kernels.common import resolve_device


def nw_step(prev: torch.Tensor, srow: torch.Tensor, jdx: torch.Tensor,
            penalty: int) -> torch.Tensor:
    """F[i,j] = max(F[i-1,j-1]+sim, F[i-1,j]-p, F[i,j-1]-p) for one row.

    A[j] = max(F[i-1,j-1]+sim[i,j], F[i-1,j]-p);
    F[i,j] = cummax_j(A[j] + p*j) - p*j   (max-plus prefix identity);
    ``jdx`` is p * arange(n)."""
    shifted = torch.cat([prev.new_full((1,), -penalty), prev[:-1]])
    A = torch.maximum(shifted + srow, prev - penalty)
    return torch.cummax(A + jdx, dim=0).values - jdx


def _nw_rows(sim: torch.Tensor, penalty: int) -> torch.Tensor:
    """The last DP row after every row of ``sim`` (n, n) int32."""
    n = sim.shape[1]
    jdx = torch.arange(n, dtype=torch.int32, device=sim.device) * penalty
    prev = -jdx
    for i in range(sim.shape[0]):
        prev = nw_step(prev, sim[i], jdx, penalty)
    return prev


def run_needle(policy_kind: str = "system", *, n: int = 2048, penalty: int = 1,
               page_size: int = 64 * KB, waves_per_kernel: int = 64,
               oversub_ratio: float = 0.0, auto_migrate: bool = True,
               hw=None, sim: Optional[np.ndarray] = None,
               device=None) -> AppResult:
    """``sim`` (an int32 (n, n) array) replaces the similarity matrix drawn
    in [-2, 3) from a generator seeded 11; ``device=None`` is the CUDA card."""
    device = resolve_device(device)
    nbytes = n * n * 4
    um, pol = make_um(policy_kind, page_size=page_size, hw=hw,
                      oversub_ratio=oversub_ratio,
                      app_peak_bytes=2 * nbytes, auto_migrate=auto_migrate)

    with um.phase("alloc"):
        ref = um.from_host("reference", (n, n), np.int32, pol)
        mat = um.from_host("matrix", (n, n), np.int32, pol)

    with um.phase("cpu_init"):
        if sim is not None:
            sim_t = torch.tensor(np.asarray(sim), dtype=torch.int32,
                                 device=device)
        else:
            gen = torch.Generator(device).manual_seed(11)
            sim_t = torch.randint(-2, 3, (n, n), generator=gen,
                                  dtype=torch.int32, device=device)
        um.launch("init", writes=[ref[:], mat[:]], actor=Actor.CPU)

    timer = DeviceTimer(device)
    with um.staged(h2d=[ref, mat], d2h=[mat]):
        with um.phase("compute"):
            timer.start()
            last_row = _nw_rows(sim_t, penalty)
            timer.stop()
            # wavefront sweeps touch growing/shrinking diagonal bands: model as
            # strided sub-range kernels (irregular pattern)
            waves = 2 * n - 1
            for w0 in range(0, waves, waves_per_kernel):
                w1 = min(w0 + waves_per_kernel, waves)
                frac0, frac1 = w0 / waves, w1 / waves
                lo = int(frac0 * nbytes) // 4096 * 4096
                hi = max(lo + 4096, int(frac1 * nbytes) // 4096 * 4096)
                hi = min(hi, nbytes)
                um.launch_batch([KernelLaunch(
                    f"wave{w0}",
                    reads=[ref.byterange(lo, hi), mat.byterange(lo, hi)],
                    writes=[mat.byterange(lo, hi)],
                    flops=10.0 * (hi - lo) / 4, actor=Actor.GPU)])
                um.sync()

    with um.phase("dealloc"):
        um.free_live()

    return finish(um, "needle", policy_kind, page_size,
                  float(last_row[-1]), n=n, device=str(device),
                  compute_ms=timer.ms())


SPEC = AppSpec(
    name="needle", run=run_needle, init_actor="cpu",
    sizes={"fig3": dict(n=1024),
           "fig11": dict(n=1024),
           "small": dict(n=512)})
