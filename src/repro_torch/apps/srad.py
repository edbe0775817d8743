"""SRAD: speckle-reducing anisotropic diffusion (Rodinia). Irregular, GPU-init.

Paper roles: Fig. 3 (managed > system in-memory: GPU-first-touch PTE cost),
Fig. 10 (access-counter migration warm-up: 3 phases, crossover ~iter 5),
Fig. 11 (worst oversubscription sensitivity).
"""
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
    host_input,
    make_um,
    uniform,
)
from repro_torch.core import Actor, KernelBatch
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.stencil5 import stencil5


def _srad_iter(J: torch.Tensor, lam: float) -> torch.Tensor:
    # diffusion coefficient from local statistics (wrapping at the edges, as
    # torch.roll does), then the diffusion sweep (clamping at the edges)
    dN = torch.roll(J, 1, 0) - J
    dS = torch.roll(J, -1, 0) - J
    dW = torch.roll(J, 1, 1) - J
    dE = torch.roll(J, -1, 1) - J
    g2 = (dN**2 + dS**2 + dW**2 + dE**2) / torch.clamp(J * J, min=1e-9)
    c = 1.0 / (1.0 + g2)
    J = J + 0.25 * lam * (c * (dN + dS + dW + dE))
    return stencil5(J, 0.02)


def run_srad(policy_kind: str = "system", *, rows: int = 1024, cols: int = 1024,
             iters: int = 12, page_size: int = 64 * KB, lam: float = 0.5,
             oversub_ratio: float = 0.0, auto_migrate: bool = True,
             threshold: int = 256, hw=None, img: Optional[np.ndarray] = None,
             device=None) -> AppResult:
    """``img`` (a float32 (rows, cols) array) replaces the image drawn from a
    generator seeded 7; ``device=None`` is the CUDA card."""
    device = resolve_device(device)
    um, pol = make_um(policy_kind, page_size=page_size, hw=hw,
                      oversub_ratio=oversub_ratio,
                      app_peak_bytes=2 * rows * cols * 4,
                      auto_migrate=auto_migrate, threshold=threshold)

    with um.phase("alloc"):
        J_m = um.array("J", (rows, cols), np.float32, pol)
        c_m = um.array("c", (rows, cols), np.float32, pol)

    # GPU-side initialization (the paper's srad/qiskit pattern, §5.1.2):
    # data is first-touched by device kernels.
    with um.phase("gpu_init"):
        img_t = (host_input(img, device) if img is not None
                 else uniform((rows, cols), 7, device))
        J = torch.exp(img_t / 255.0)
        um.launch("extract", writes=[J_m[:]], flops=2.0 * rows * cols,
                  actor=Actor.GPU)

    per_iter = []
    timer = DeviceTimer(device)
    with um.phase("compute"):
        timer.start()
        for it in range(iters):
            J = _srad_iter(J, lam)
            # both sweeps of one iteration go down in a single batched
            # engine step (charges identical to two sequential launches)
            t = sum(um.launch_batch(
                KernelBatch()
                .launch(f"grad{it}", reads=[J_m[:]], writes=[c_m[:]],
                        flops=12.0 * rows * cols, actor=Actor.GPU)
                .launch(f"diff{it}", reads=[J_m[:], c_m[:]], writes=[J_m[:]],
                        flops=8.0 * rows * cols, actor=Actor.GPU)))
            t += um.sync()
            tr = um.prof.traffic()
            per_iter.append({
                "iter": it, "seconds": t,
                "link_h2d": tr.link_h2d, "device_local": tr.device_local,
            })
        timer.stop()

    with um.phase("dealloc"):
        um.free_live()

    # per-iteration deltas for the Fig. 10 plot
    for i in range(len(per_iter) - 1, 0, -1):
        per_iter[i]["link_h2d"] -= per_iter[i - 1]["link_h2d"]
        per_iter[i]["device_local"] -= per_iter[i - 1]["device_local"]
    return finish(um, "srad", policy_kind, page_size, float(J.mean()),
                  per_iter=per_iter, iters=iters, device=str(device),
                  compute_ms=timer.ms())


SPEC = AppSpec(
    name="srad", run=run_srad, init_actor="gpu",
    sizes={"fig3": dict(rows=512, cols=512, iters=12),
           "fig11": dict(rows=512, cols=512, iters=8),
           "small": dict(rows=256, cols=256, iters=8)})
