"""Hotspot: thermal-simulation stencil (Rodinia). Regular access, CPU-init.

Paper roles: Fig. 3 (system > managed in-memory), Fig. 4 timeline shape,
Fig. 6/7 page-size sensitivity, Fig. 11 oversubscription robustness.
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
from repro_torch.core import Actor, KernelLaunch
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.stencil5 import stencil5

COEFF = 0.1


def hotspot_step(temp: torch.Tensor, power: torch.Tensor) -> torch.Tensor:
    """One thermal iteration: a stencil sweep plus the power term."""
    return stencil5(temp, COEFF) + 0.001 * power


def run_hotspot(policy_kind: str = "system", *, rows: int = 1024, cols: int = 1024,
                iters: int = 8, page_size: int = 64 * KB,
                oversub_ratio: float = 0.0, auto_migrate: bool = True,
                hw=None, temp0: Optional[np.ndarray] = None,
                power: Optional[np.ndarray] = None, device=None) -> AppResult:
    """``temp0``/``power`` (float32 (rows, cols) arrays) replace the inputs
    drawn from generators seeded 0 and 1; ``device=None`` is the CUDA card."""
    device = resolve_device(device)
    nbytes = rows * cols * 4
    um, pol = make_um(policy_kind, page_size=page_size, hw=hw,
                      oversub_ratio=oversub_ratio,
                      app_peak_bytes=3 * nbytes, auto_migrate=auto_migrate)

    with um.phase("alloc"):
        temp_m = um.from_host("temp", (rows, cols), np.float32, pol)
        power_m = um.from_host("power", (rows, cols), np.float32, pol)
        out_m = um.array("temp_out", (rows, cols), np.float32, pol)  # GPU scratch

    with um.phase("cpu_init"):
        temp = (host_input(temp0, device) if temp0 is not None
                else 300.0 + 50.0 * uniform((rows, cols), 0, device))
        power_t = (host_input(power, device) if power is not None
                   else uniform((rows, cols), 1, device))
        um.launch("init", writes=[temp_m[:], power_m[:]], actor=Actor.CPU)

    timer = DeviceTimer(device)
    with um.staged(h2d=[temp_m, power_m], d2h=[temp_m]):
        with um.phase("compute"):
            timer.start()
            src, dst = temp_m, out_m
            for it in range(iters):
                temp = hotspot_step(temp, power_t)
                # submitted through the batched engine (sync-per-iteration
                # keeps the batch at one launch; charges are identical)
                um.launch_batch([KernelLaunch(
                    f"sweep{it}", reads=[src[:], power_m[:]],
                    writes=[dst[:]],
                    flops=7.0 * rows * cols, actor=Actor.GPU)])
                um.sync()
                src, dst = dst, src
            timer.stop()

    with um.phase("dealloc"):
        um.free_live()

    return finish(um, "hotspot", policy_kind, page_size, float(temp.mean()),
                  iters=iters, rows=rows, cols=cols, device=str(device),
                  compute_ms=timer.ms())


SPEC = AppSpec(
    name="hotspot", run=run_hotspot, init_actor="cpu",
    sizes={"fig3": dict(rows=1024, cols=1024, iters=8),
           "fig11": dict(rows=1024, cols=1024, iters=6),
           "small": dict(rows=256, cols=256, iters=6)})
