"""Pathfinder: 2-D grid dynamic programming (Rodinia). Regular, CPU-init."""
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


def dp_step(prev: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """One DP row: cost[j] = row[j] + min(prev[j-1], prev[j], prev[j+1]),
    with the edges replicated."""
    left = torch.cat([prev[:1], prev[:-1]])
    right = torch.cat([prev[1:], prev[-1:]])
    return row + torch.minimum(prev, torch.minimum(left, right))


def _dp_all_rows(data: torch.Tensor) -> torch.Tensor:
    """The min-path DP over every row of ``data`` (rows, cols) int32."""
    prev = data[0]
    for i in range(1, data.shape[0]):
        prev = dp_step(prev, data[i])
    return prev


def run_pathfinder(policy_kind: str = "system", *, rows: int = 4096,
                   cols: int = 1024, page_size: int = 64 * KB,
                   rows_per_kernel: int = 512, oversub_ratio: float = 0.0,
                   auto_migrate: bool = True, hw=None,
                   data: Optional[np.ndarray] = None,
                   device=None) -> AppResult:
    """``data`` (an int32 (rows, cols) array) replaces the wall drawn in
    [0, 10) from a generator seeded 3; ``device=None`` is the CUDA card."""
    device = resolve_device(device)
    row_bytes = cols * 4
    um, pol = make_um(policy_kind, page_size=page_size, hw=hw,
                      oversub_ratio=oversub_ratio,
                      app_peak_bytes=rows * row_bytes + 2 * row_bytes,
                      auto_migrate=auto_migrate)

    with um.phase("alloc"):
        wall = um.from_host("wall", (rows, cols), np.int32, pol)
        res = um.array("result", (2, cols), np.int32, pol)  # prev/cur row pair

    with um.phase("cpu_init"):
        if data is not None:
            wall_t = torch.tensor(np.asarray(data), dtype=torch.int32,
                                  device=device)
        else:
            gen = torch.Generator(device).manual_seed(3)
            wall_t = torch.randint(0, 10, (rows, cols), generator=gen,
                                   dtype=torch.int32, device=device)
        um.launch("init", writes=[wall[:]], actor=Actor.CPU)

    timer = DeviceTimer(device)
    with um.staged(h2d=[wall], d2h=[res.rows(0, 1)]):
        with um.phase("compute"):
            timer.start()
            result = _dp_all_rows(wall_t)
            timer.stop()
            # model the row-sweep: one kernel per block of rows, streaming the wall
            for r0 in range(0, rows, rows_per_kernel):
                r1 = min(r0 + rows_per_kernel, rows)
                um.launch_batch([KernelLaunch(
                    f"rows{r0}",
                    reads=[wall.rows(r0, r1), res.rows(0, 1)],
                    writes=[res.rows(1, 2)],
                    flops=5.0 * (r1 - r0) * cols, actor=Actor.GPU)])
                um.sync()

    with um.phase("dealloc"):
        um.free_live()

    return finish(um, "pathfinder", policy_kind, page_size,
                  float(int(result.sum()) % 1_000_003), rows=rows, cols=cols,
                  device=str(device), compute_ms=timer.ms())


SPEC = AppSpec(
    name="pathfinder", run=run_pathfinder, init_actor="cpu",
    sizes={"fig3": dict(rows=2048, cols=512),
           "fig11": dict(rows=2048, cols=512),
           "small": dict(rows=1024, cols=256)})
