"""The 5-point stencil: CUDA kernel (csrc/stencil5.cu) on the card, plain
PyTorch on the CPU."""
from __future__ import annotations

import torch

from repro_torch.kernels.common import (
    check_launch,
    library,
    require_cuda_tensor,
    stream_of,
)
from repro_torch.kernels.stencil5.ref import stencil5_ref


def stencil5(grid: torch.Tensor, coeff: float) -> torch.Tensor:
    """One 5-point sweep with replicated boundaries. grid: (H, W).

    A CPU tensor runs :func:`stencil5_ref`. A CUDA tensor must be contiguous
    fp32; the kernel writes a new tensor on the current stream, without
    synchronizing, and ``stencil5.launches`` counts the launch."""
    if grid.device.type == "cpu":
        return stencil5_ref(grid, coeff)
    require_cuda_tensor(grid, "grid", torch.float32, ndim=2)
    out = torch.empty_like(grid)
    H, W = grid.shape
    if H and W:
        with torch.cuda.device(grid.device):
            err = library().fns["stencil5_f32"](
                grid.data_ptr(), out.data_ptr(), H, W, float(coeff),
                stream_of(grid))
        check_launch("stencil5", err)
        stencil5.launches += 1
    return out


stencil5.launches = 0
