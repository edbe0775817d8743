"""Operations and bytes the served work needs, computed from shapes.

A copy of the count of ``chip_smoke.train_flops`` (2 N a token over the
matmul parameters, plus the attention products), extended from a training
step to served tokens: each token processed costs 2 x its layers' matmul
parameters (for a MoE layer the router and the ``top_k`` experts the token
is routed to, not the dense dispatch's slots) plus QK^T and PV over the
keys it attends (its position + 1, causal), and each token produced costs
the output head (2 d V). The embedding lookup is not a product.

``paged_attention_bytes`` is the byte count of one call of the decode
kernel: q, the K and V of the tokens each sequence attends, each read
once, and the output.
"""
from __future__ import annotations

from typing import Iterable


def layer_matmul_params(cfg: dict) -> int:
    """Matmul parameters one token meets in one layer (active experts
    only)."""
    d, hd = cfg["d_model"], cfg["head_dim"]
    attn = d * cfg["num_heads"] * hd * 2 + d * cfg["num_kv_heads"] * hd * 2
    if cfg.get("num_experts", 0):
        ffn = d * cfg["num_experts"] + cfg["top_k"] * 3 * d * cfg["d_ff"]
    else:
        ffn = 3 * d * cfg["d_ff"]
    return attn + ffn


def token_flops(cfg: dict, position: int) -> float:
    """FLOPs of one token at 0-based ``position`` through every layer
    (without the output head)."""
    L = cfg["num_layers"]
    attn = 4.0 * (position + 1) * cfg["num_heads"] * cfg["head_dim"]
    return L * (2.0 * layer_matmul_params(cfg) + attn)


def span_flops(cfg: dict, start: int, end: int) -> float:
    """FLOPs of the tokens at positions [start, end) of one sequence
    (without the head): the closed form of summing ``token_flops``."""
    n = end - start
    if n <= 0:
        return 0.0
    L = cfg["num_layers"]
    ctx = (start + 1 + end) * n / 2.0  # sum of (p + 1) over the span
    return L * (2.0 * layer_matmul_params(cfg) * n
                + 4.0 * ctx * cfg["num_heads"] * cfg["head_dim"])


def head_flops(cfg: dict) -> float:
    """FLOPs of the output head for one produced token."""
    return 2.0 * cfg["d_model"] * cfg["vocab_size"]


def paged_attention_bytes(cfg: dict, lengths: Iterable[int],
                          itemsize: int = 4) -> float:
    """Bytes of one paged-attention call over sequences attending
    ``lengths`` tokens each (the new token included)."""
    lengths = list(lengths)
    B, H, Hkv, D = (len(lengths), cfg["num_heads"], cfg["num_kv_heads"],
                    cfg["head_dim"])
    qo = 2 * B * H * D * itemsize
    kv = 2 * sum(lengths) * Hkv * D * itemsize
    return float(qo + kv)
