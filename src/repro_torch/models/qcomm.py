"""Quantized tensor-parallel collectives (the port of
``repro.models.qcomm``).

Megatron row-parallel projections end in an all-reduce of full
activations. This module replaces that all-reduce with an int8 two-phase
reduce over the model axis:

  partial (B,S,d) --quantize--> int8 + per-(token, shard-block) scales
    --all_to_all--> dequant-sum of my d-shard --quantize-->
    --all_gather--> dequant -> full (B,S,d)

Wire bytes a rank: ~2 (n-1)/n * E * 1 B against 2 (n-1)/n * E * 2 B for a
bf16 all-reduce (plus fp32 scales). Inference only, like the reference: it
runs without autograd (the rounding is not differentiated).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.parallel import Axis, all_gather, all_to_all


def _quant_blocks(y) -> Tuple[torch.Tensor, torch.Tensor]:
    """y (..., m) fp32 -> int8 codes and fp32 scales (..., 1), one per block
    of the last dim; rounding half to even, as ``jnp.round``."""
    scale = (y.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-12)
    q = torch.clamp(torch.round(y / scale), -127, 127).to(torch.int8)
    return q, scale.float()


@torch.no_grad()
def quantized_allreduce(y, axis: Axis) -> torch.Tensor:
    """int8 two-phase all-reduce of the partial sums y (B,S,d) over
    ``axis``; d must divide by its size. Returns the fp32 sum (B,S,d)."""
    n = axis.size
    B, S, d = y.shape
    if d % n:
        raise ValueError(f"d={d} does not split over {n} ranks")
    q, s = _quant_blocks(y.float().reshape(B, S, n, d // n))
    # piece j of every rank lands on rank j (pieces along dim 0)
    q = all_to_all(q.permute(2, 0, 1, 3), axis)  # (n,B,S,m): piece from rank i
    s = all_to_all(s.permute(2, 0, 1, 3), axis)
    part = (q.float() * s).sum(dim=0)  # (B,S,m): my shard, reduced
    q2, s2 = _quant_blocks(part)
    qg = all_gather(q2, 2, axis)  # (B,S,n*m), rank-major
    sg = all_gather(s2, 2, axis)  # (B,S,n)
    return (qg.float().reshape(B, S, n, d // n) * sg[..., None]).reshape(B, S, d)


def rowparallel_matmul_q8(x_local, w_local, axis: Axis, out_dtype) -> torch.Tensor:
    """Row-parallel projection with the quantized all-reduce: x (B,S,K/n)
    and w (K/n, d) are this rank's shards of the contraction; returns
    (B,S,d), the same on every rank of ``axis``."""
    y_part = torch.einsum("bsk,kd->bsd", x_local.float(), w_local.float())
    return quantized_allreduce(y_part, axis).to(out_dtype)
