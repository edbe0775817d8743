"""Decode caches: dense KV, the ring buffer of sliding-window layers, and
the recurrent states (the port of ``repro.models.cache``).

The paged KV cache that serving uses is ``repro_torch.serve.paged`` with
``repro_torch.kernels.paged_attention``; these dense layouts are what
:meth:`TransformerLM.decode_step` reads, and the card uses them to check
the paged engine.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.kernels.common import resolve_device
from repro_torch.models.layout import HeadLayout


def kv_head_layout(cfg, tp: int) -> HeadLayout:
    return HeadLayout.make(cfg.num_heads, cfg.num_kv_heads, tp)


def init_cache(cfg, B: int, S: int, *, tp: int = 1,
               dtype: torch.dtype = torch.bfloat16, kv_quant: bool = False,
               device=None) -> List[Dict[str, torch.Tensor]]:
    """One cache of zeros per layer, on ``device`` (the CUDA card unless the
    caller passes ``device="cpu"``; ``"meta"`` for shape stand-ins), by the
    layer's kind:

    * ``attention``: {'k', 'v'} (B, S, Hkv_eff, D); with ``kv_quant`` int8
      codes plus {'ks', 'vs'} (B, S, Hkv_eff, 1) fp32 per-(token, head)
      scales;
    * ``local``: {'k', 'v'} (B, min(W, S), Hkv_eff, D), a ring of the last
      W tokens when S >= W;
    * ``rglru``: {'h'} (B, w) fp32 and {'conv'} (B, conv_width - 1, w);
    * ``rwkv6``: {'s'} (B, H, hs, hs) fp32 and the token-shift inputs
      {'xa'}, {'xf'} (B, d).
    """
    dev = resolve_device(device)

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    if cfg.mixer in ("attention", "rglru_hybrid"):
        lay = kv_head_layout(cfg, tp)
    caches: List[Dict[str, torch.Tensor]] = []
    for kind in cfg.layer_kinds():
        if kind == "attention" and kv_quant:
            kv = (B, S, lay.n_kv_eff, cfg.head_dim)
            caches.append({"k": zeros(*kv, dt=torch.int8),
                           "v": zeros(*kv, dt=torch.int8),
                           "ks": zeros(*kv[:3], 1, dt=torch.float32),
                           "vs": zeros(*kv[:3], 1, dt=torch.float32)})
        elif kind in ("attention", "local"):
            n = S if kind == "attention" else min(cfg.local_window, S)
            caches.append({"k": zeros(B, n, lay.n_kv_eff, cfg.head_dim),
                           "v": zeros(B, n, lay.n_kv_eff, cfg.head_dim)})
        elif kind == "rglru":
            w = cfg.lru_width or cfg.d_model
            caches.append({"h": zeros(B, w, dt=torch.float32),
                           "conv": zeros(B, cfg.conv_width - 1, w)})
        elif kind == "rwkv6":
            hs = cfg.rwkv_head_size
            caches.append({"s": zeros(B, cfg.d_model // hs, hs, hs,
                                      dt=torch.float32),
                           "xa": zeros(B, cfg.d_model),
                           "xf": zeros(B, cfg.d_model)})
        else:
            raise ValueError(kind)
    return caches
