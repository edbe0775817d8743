"""BFS: level-synchronous breadth-first search on a CSR graph (Rodinia).

Mixed access pattern, CPU-init (graph construction). Frontier expansion
touches scattered col_idx ranges — by default modeled as a per-level
partial-range read sized by a hand-estimated frontier fraction (the paper's
coarse model). With ``sparse_access=True`` the level kernels instead read
exactly the ``col_idx`` extents the frontier's adjacency gathers touch
(page-coalesced ``buf[...]`` slices). Off by default so the default-config
charges stay those of the coarse model.
"""
from __future__ import annotations

from typing import List

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
from repro_torch.core import Actor, KernelLaunch, UMBuffer, coalesce_runs
from repro_torch.kernels.common import resolve_device


def _random_graph(n_nodes: int, deg: int, device: torch.device, seed: int = 0):
    """col_idx (int32) of a graph with ``deg`` random out-edges per node, as
    a CSR whose row_ptr is ``deg * arange``: drawn with numpy from ``seed``,
    the JAX app's graph edge for edge."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, n_nodes, size=n_nodes * deg, dtype=np.int32)
    return torch.from_numpy(cols).to(device)


def expand(frontier: torch.Tensor, neigh: torch.Tensor) -> torch.Tensor:
    """The nodes one edge away from ``frontier`` (n,) bool, over ``neigh``
    (n, deg): a scatter-max of the frontier mask onto its neighbours, with
    the non-frontier entries sent to node 0 with value 0."""
    n, deg = neigh.shape
    mask = frontier[:, None].expand(n, deg)
    idx = torch.where(mask, neigh, 0).reshape(-1).long()
    touched = torch.zeros(n, dtype=torch.int32, device=neigh.device)
    touched.scatter_reduce_(0, idx, mask.reshape(-1).to(torch.int32), "amax")
    return touched > 0


def _bfs_levels(cols: torch.Tensor, n_nodes: int, deg: int, src: int = 0,
                max_levels: int = 32, collect_frontiers: bool = False):
    """Returns (levels tensor, per-level frontier sizes[, expanded frontiers]).

    With collect_frontiers=True also returns, for each modeled level kernel,
    the node ids whose adjacency lists that kernel gathers (the frontier
    *being expanded*, driving sparse_access extent resolution)."""
    device = cols.device
    level = torch.full((n_nodes,), -1, dtype=torch.int32, device=device)
    level[src] = 0
    frontier = torch.zeros((n_nodes,), dtype=torch.bool, device=device)
    frontier[src] = True
    sizes = []
    fronts: List[np.ndarray] = []
    neigh = cols.reshape(n_nodes, deg)
    for lv in range(1, max_levels):
        expanding = (np.flatnonzero(frontier.cpu().numpy())
                     if collect_frontiers else None)
        new = expand(frontier, neigh) & (level < 0)
        n_new = int(new.sum())
        if n_new == 0:
            break
        level = torch.where(new, lv, level)
        sizes.append(n_new)
        if collect_frontiers:
            fronts.append(expanding)
        frontier = new
    if collect_frontiers:
        return level, sizes, fronts
    return level, sizes


def _frontier_views(edges: UMBuffer, nodes: np.ndarray, deg: int,
                    page_size: int):
    """The col_idx extents a frontier gather touches, as buffer slices.

    Each frontier node v reads its adjacency block — elements
    [v*deg, (v+1)*deg) — so the touched element set is the union of those
    blocks, coalesced to page granularity (pages are what the memory system
    moves/charges) and merged into maximal runs. Node runs are coalesced
    *before* the page conversion so a block spanning many pages contributes
    its full page range, interior pages included."""
    if len(nodes) == 0:
        return []
    per_page = max(1, page_size // edges.itemsize)
    views = []
    for v0, v1 in coalesce_runs(np.unique(nodes)):
        p0 = (v0 * deg) // per_page
        p1 = (v1 * deg - 1) // per_page + 1
        if views and p0 <= views[-1][1]:  # touches/overlaps the previous run
            views[-1][1] = max(views[-1][1], p1)
        else:
            views.append([p0, p1])
    return [edges[s * per_page:e * per_page] for s, e in views]


def run_bfs(policy_kind: str = "system", *, n_nodes: int = 1 << 16, deg: int = 8,
            page_size: int = 64 * KB, oversub_ratio: float = 0.0,
            auto_migrate: bool = True, sparse_access: bool = False,
            hw=None, device=None) -> AppResult:
    """``device=None`` is the CUDA card. The graph is drawn with numpy from
    seed 0, as the JAX app draws it."""
    device = resolve_device(device)
    edge_bytes = n_nodes * deg * 4
    node_bytes = n_nodes * 4
    um, pol = make_um(policy_kind, page_size=page_size, hw=hw,
                      oversub_ratio=oversub_ratio,
                      app_peak_bytes=edge_bytes + 3 * node_bytes,
                      auto_migrate=auto_migrate)

    with um.phase("alloc"):
        edges = um.from_host("col_idx", (n_nodes * deg,), np.int32, pol)
        rowp = um.from_host("row_ptr", (n_nodes,), np.int32, pol)
        cost = um.array("cost", (n_nodes,), np.int32, pol)

    with um.phase("cpu_init"):
        cols = _random_graph(n_nodes, deg, device)
        um.launch("build", writes=[edges[:], rowp[:]], actor=Actor.CPU)

    fronts: List[np.ndarray] = []
    timer = DeviceTimer(device)
    with um.staged(h2d=[edges, rowp], d2h=[cost]):
        with um.phase("compute"):
            timer.start()
            if sparse_access:
                level, sizes, fronts = _bfs_levels(
                    cols, n_nodes, deg, collect_frontiers=True)
            else:
                level, sizes = _bfs_levels(cols, n_nodes, deg)
            timer.stop()
            total = max(1, n_nodes)
            for lv, fsize in enumerate(sizes):
                if sparse_access:
                    # exactly the adjacency extents this level gathers
                    reads = _frontier_views(edges, fronts[lv], deg,
                                            pol.page_size)
                else:
                    # frontier covers fsize/n of nodes: estimate the touched
                    # fraction of the whole edge array (scattered pages)
                    frac = min(1.0, fsize * 4.0 / total)
                    hi = max(4096, int(frac * edge_bytes) // 4096 * 4096)
                    reads = [edges.byterange(0, min(hi, edge_bytes))]
                um.launch_batch([KernelLaunch(
                    f"level{lv}", reads=reads + [rowp[:]],
                    writes=[cost[:]],
                    flops=2.0 * fsize * deg, actor=Actor.GPU)])
                um.sync()

    with um.phase("dealloc"):
        um.free_live()

    visited = int((level >= 0).sum())
    return finish(um, "bfs", policy_kind, page_size, float(visited),
                  n_nodes=n_nodes, levels=len(sizes), sparse=sparse_access,
                  device=str(device), compute_ms=timer.ms())


SPEC = AppSpec(
    name="bfs", run=run_bfs, init_actor="cpu",
    sizes={"fig3": dict(n_nodes=1 << 14),
           "fig11": dict(n_nodes=1 << 14),
           "small": dict(n_nodes=1 << 12)})
