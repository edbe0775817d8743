"""The dense decode cache (the port of ``repro.models.cache`` for attention
layers).

The paged KV cache that serving uses is ``repro_torch.serve.paged`` with
``repro_torch.kernels.paged_attention``; this dense layout is what
:meth:`TransformerLM.decode_step` reads, and the card uses it to check the
paged engine.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.kernels.common import resolve_device
from repro_torch.models.layout import HeadLayout


def kv_head_layout(cfg, tp: int) -> HeadLayout:
    return HeadLayout.make(cfg.num_heads, cfg.num_kv_heads, tp)


def init_cache(cfg, B: int, S: int, *, tp: int = 1,
               dtype: torch.dtype = torch.bfloat16,
               device=None) -> List[Dict[str, torch.Tensor]]:
    """One {'k', 'v'} pair of zeros (B, S, Hkv_eff, D) per layer. Only
    global attention layers exist in the port so far; the ring buffer of
    local attention and the recurrent states come with their slices."""
    dev = resolve_device(device)
    kinds = set(cfg.layer_kinds())
    if kinds != {"attention"}:
        raise NotImplementedError(
            f"decode caches for {sorted(kinds - {'attention'})} layers come "
            "with the recurrent-arch slice of the port")
    lay = kv_head_layout(cfg, tp)
    shape = (B, S, lay.n_kv_eff, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=dtype, device=dev),
             "v": torch.zeros(shape, dtype=dtype, device=dev)}
            for _ in range(cfg.num_layers)]
