"""Weights made from the seed, on the device, in a few large calls.

The state dict is named and shaped as the port's ``TransformerLM`` names
its parameters (the JAX tree's keys, at a tensor-parallel degree of 1), but
it is built here from the configuration alone: the benchmark makes the
weights and hands the same tensors to the program (``load_state_dict(...,
assign=True)``) and, made again from the same seed after the window, to
the plain reference. Matrices are N(0, 1/fan_in) in fp32, norm scales
ones. All matrices are views of one flat buffer filled by ``torch.randn``
in chunks of 2**30 values from a ``torch.Generator`` on the device.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

CHUNK = 1 << 30


def layout(cfg: dict) -> List[Tuple[str, tuple, int]]:
    """(name, shape, fan_in) of every parameter, fan_in 0 for a norm
    scale (ones)."""
    d, V, L = cfg["d_model"], cfg["vocab_size"], cfg["num_layers"]
    H, Hkv, D, f = (cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"],
                    cfg["d_ff"])
    E = cfg.get("num_experts", 0)
    out = [("embed.w", (V, d), d)]
    for i in range(L):
        p = f"layers.{i}."
        out += [(p + "norm1.scale", (d,), 0),
                (p + "mixer.wq", (d, H, D), d),
                (p + "mixer.wk", (d, Hkv, D), d),
                (p + "mixer.wv", (d, Hkv, D), d),
                (p + "mixer.wo", (H, D, d), H * D)]
        if cfg.get("qk_norm"):
            out += [(p + "mixer.q_norm", (D,), 0), (p + "mixer.k_norm", (D,), 0)]
        out.append((p + "norm2.scale", (d,), 0))
        if E:
            out += [(p + "ffn.router", (d, E), d),
                    (p + "ffn.w_gate", (E, d, f), d),
                    (p + "ffn.w_up", (E, d, f), d),
                    (p + "ffn.w_down", (E, f, d), f)]
        else:
            out += [(p + "ffn.w_gate", (d, f), d), (p + "ffn.w_up", (d, f), d),
                    (p + "ffn.w_down", (f, d), f)]
    out += [("final_norm.scale", (d,), 0), ("head.w", (d, V), d)]
    return out


def param_count(cfg: dict) -> int:
    return sum(math.prod(shape) for _, shape, _ in layout(cfg))


def make(cfg: dict, seed: int, device,
         spec: Optional[List[Tuple[str, tuple, int]]] = None
         ) -> Dict[str, torch.Tensor]:
    """The state dict for ``seed`` on ``device``, fp32, of ``spec`` (a
    model module's layout; default ``layout(cfg)``)."""
    spec = layout(cfg) if spec is None else spec
    n_mat = sum(math.prod(s) for _, s, fan in spec if fan)
    n_norm = sum(math.prod(s) for _, s, fan in spec if not fan)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    flat = torch.empty(n_mat, dtype=torch.float32, device=device)
    for lo in range(0, n_mat, CHUNK):
        torch.randn(min(CHUNK, n_mat - lo), generator=gen,
                    out=flat[lo:lo + CHUNK])
    ones = torch.ones(n_norm, dtype=torch.float32, device=device)
    sd, mo, no = {}, 0, 0
    for name, shape, fan in spec:
        n = math.prod(shape)
        if fan:
            t = flat[mo:mo + n].view(shape)
            t.mul_(1.0 / math.sqrt(fan))
            mo += n
        else:
            t = ones[no:no + n].view(shape)
            no += n
        sd[name] = t
    return sd
