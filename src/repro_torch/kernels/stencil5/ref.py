"""Plain PyTorch version of the 5-point stencil (hotspot/SRAD compute phase)."""
from __future__ import annotations

import torch


def stencil5_ref(grid: torch.Tensor, coeff: float) -> torch.Tensor:
    """out = c + coeff*(N + S + E + W - 4c), replicated (clamped) boundaries."""
    g = grid.to(torch.float32)
    n = torch.cat([g[:1], g[:-1]], dim=0)
    s = torch.cat([g[1:], g[-1:]], dim=0)
    w = torch.cat([g[:, :1], g[:, :-1]], dim=1)
    e = torch.cat([g[:, 1:], g[:, -1:]], dim=1)
    return (g + coeff * (n + s + e + w - 4.0 * g)).to(grid.dtype)
