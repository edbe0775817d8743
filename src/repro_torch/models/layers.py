"""Shared layer primitives: run policy, inits, norms, RoPE, MLPs
(the port of ``repro.models.layers``)."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


@dataclass
class RunPolicy:
    """Execution knobs of a forward.

    ``attn_q_block`` > 0 runs full-sequence attention block-causally
    (:func:`repro_torch.models.attention._blocked_causal`) with
    ``attn_kv_block`` (default: the q block) keys per block. The int8 TP
    all-reduce (``quantize_tp_collectives``) needs a device mesh; it comes
    with the launch slice of the port and raises until then. MoE layers
    route with ``moe_capacity_factor`` through ``moe_impl``: ``"dense"``
    (GShard dispatch einsums) or ``"sorted"`` (scatter dispatch). rwkv6's
    wkv runs in chunks of ``rwkv_chunk`` tokens (halved until it divides the
    sequence). ``remat`` recomputes each block's activations in the
    backward pass of a training forward (``torch.utils.checkpoint``, the
    JAX package's ``jax.checkpoint``) instead of keeping them."""

    remat: bool = False
    attn_q_block: int = 0  # 0 => unblocked attention
    attn_kv_block: int = 0
    rwkv_chunk: int = 128
    moe_capacity_factor: float = 1.25
    quantize_tp_collectives: bool = False
    moe_impl: str = "dense"  # dense (GShard einsum) | sorted (scatter)


def require_no_mesh_options(policy: RunPolicy) -> None:
    if policy.quantize_tp_collectives:
        raise NotImplementedError(
            "int8 TP collectives need a device mesh; they come with the "
            "launch slice of the port")


# ---------------------------------------------------------------------------
# Inits
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, dtype: torch.dtype,
               in_axis_size: Optional[int] = None) -> torch.Tensor:
    """N(0, 1/fan_in) in fp32 on the generator's device, cast to ``dtype``."""
    fan_in = in_axis_size if in_axis_size is not None else shape[0]
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return w.mul_(1.0 / math.sqrt(max(1, fan_in))).to(dtype)


# ---------------------------------------------------------------------------
# Norms (compute in fp32, cast back)
# ---------------------------------------------------------------------------


def rmsnorm(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def layernorm(x, scale, bias, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def head_rmsnorm(x, scale, eps: float = 1e-6):
    """Per-head qk-norm over head_dim. Affine scale only (keeps zero heads zero)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


class Norm(nn.Module):
    """rmsnorm (``scale``) or layernorm (``scale``, ``bias``)."""

    def __init__(self, kind: str, d: int, dtype: torch.dtype, device):
        super().__init__()
        if kind not in ("rmsnorm", "layernorm"):
            raise ValueError(f"unknown norm {kind!r}")
        self.kind = kind
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device),
                                  requires_grad=False)
        if kind == "layernorm":
            self.bias = nn.Parameter(torch.zeros(d, dtype=dtype, device=device),
                                     requires_grad=False)

    def forward(self, x):
        if self.kind == "rmsnorm":
            return rmsnorm(x, self.scale)
        return layernorm(x, self.scale, self.bias)


# ---------------------------------------------------------------------------
# Positional embeddings
# ---------------------------------------------------------------------------


def _freqs(half: int, theta: float, device) -> torch.Tensor:
    return (1.0 / theta) ** (torch.arange(half, dtype=torch.float32,
                                          device=device) / half)


def rope_apply(x, positions, theta: float):
    """x: (..., S, H, D); positions broadcastable to (..., S)."""
    half = x.shape[-1] // 2
    ang = positions.float()[..., None] * _freqs(half, theta, x.device)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_table(positions, d: int):
    """positions: (...,) int -> (..., d) sinusoidal embedding."""
    ang = positions.float()[..., None] * _freqs(d // 2, 10_000.0,
                                                positions.device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Dense MLPs
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    """swiglu / geglu (``w_gate``, ``w_up``, ``w_down``) or gelu (``w_up``,
    ``b_up``, ``w_down``, ``b_down``); weights are (in, out)."""

    def __init__(self, cfg, dtype: torch.dtype, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        if cfg.mlp_act not in ("swiglu", "geglu", "gelu"):
            raise ValueError(f"unknown mlp_act {cfg.mlp_act!r}")
        self.act = cfg.mlp_act

        def param(*shape, fill=None):
            t = torch.empty(shape, dtype=dtype, device=device)
            if fill is not None:
                t.fill_(fill)
            return nn.Parameter(t, requires_grad=False)

        if self.act in ("swiglu", "geglu"):
            self.w_gate = param(d, f)
            self.w_up = param(d, f)
        else:
            self.w_up = param(d, f)
            self.b_up = param(f, fill=0.0)
            self.b_down = param(d, fill=0.0)
        self.w_down = param(f, d)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for name in ("w_gate", "w_up", "w_down"):
            w = getattr(self, name, None)
            if w is not None:
                w.copy_(dense_init(gen, tuple(w.shape), w.dtype))

    def forward(self, x, policy: RunPolicy):
        require_no_mesh_options(policy)
        if self.act == "swiglu":
            return (F.silu(x @ self.w_gate) * (x @ self.w_up)) @ self.w_down
        if self.act == "geglu":
            g = F.gelu(x @ self.w_gate, approximate="tanh")
            return (g * (x @ self.w_up)) @ self.w_down
        h = F.gelu(x @ self.w_up + self.b_up, approximate="tanh")
        return h @ self.w_down + self.b_down
