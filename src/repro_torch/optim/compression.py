"""Gradient compression: blockwise int8 quantization with error feedback.

Each block of ``BLOCK`` values is scaled by its max |x| / 127 and rounded
half to even (``torch.round``, as ``jnp.round``), so the codes equal the
JAX package's. Error feedback (EF21) carries the residual x - D(Q(x)) into
the next step.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

BLOCK = 256


def int8_quant(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: any shape -> (int8 codes (blocks, BLOCK), fp32 scales (blocks, 1))."""
    flat = x.float().reshape(-1)
    blocks = F.pad(flat, (0, (-flat.numel()) % BLOCK)).reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_dequant(q, scale, shape) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


def ef_int8_roundtrip(g, err) -> Tuple[torch.Tensor, torch.Tensor]:
    """One error-feedback step: (what crosses the wire, decompressed; the
    new residual)."""
    acc = g.float() + err
    q, s = int8_quant(acc)
    deq = int8_dequant(q, s, tuple(g.shape))
    return deq, acc - deq
