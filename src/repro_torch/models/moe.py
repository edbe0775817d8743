"""Token-choice top-k MoE with capacity-bounded dispatch (GShard-style), the
port of ``repro.models.moe``.

Experts are padded to a multiple of the tensor-parallel degree (granite:
40 -> 48) with ``NEG_INF`` router logits on the pads, so pads are never
routed to. Each expert has a capacity of ``cap`` tokens, computed on the
host from the logical expert count; routings past it are dropped (their
token passes through the residual). Slot 0 routings of every token queue
before any slot 1 routing, in token order.

The einsums run in fp32 for fp32 and bf16 inputs (the JAX package's
``preferred_element_type=jnp.float32``) and cast back; TF32 is not enabled.
Expert parallelism over a device mesh comes with the launch slice of the
port: the port's ``RunPolicy`` has no mesh, so the local path always runs.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.common import NEG_INF
from repro_torch.models.layers import RunPolicy, dense_init, require_no_mesh_options


def num_experts_eff(cfg, tp: int) -> int:
    return int(math.ceil(cfg.num_experts / tp) * tp)


def capacity(cfg, tokens: int, policy: RunPolicy) -> int:
    """Per-expert capacity for ``tokens`` tokens (a host int: no sync)."""
    cap = int(max(4, math.ceil(tokens * cfg.top_k / cfg.num_experts
                               * policy.moe_capacity_factor)))
    return min(cap, tokens)


def _einsum(eq: str, a, b):
    return torch.einsum(eq, a.float(), b.float())


def _route(cfg, p, xt, E: int):
    """Router probabilities (T, E) in fp32, pads masked, and the top-k gates
    (renormalized) and expert ids, highest first."""
    logits = xt.float() @ p["router"].float()
    if E != cfg.num_experts:
        pad = torch.arange(E, device=xt.device) >= cfg.num_experts
        logits = logits.masked_fill(pad[None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = torch.topk(probs, cfg.top_k, dim=-1, sorted=True)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_vals, idx


def _aux(cfg, probs, idx, E: int):
    """Switch-style load-balance loss over the real experts."""
    me = probs[:, :cfg.num_experts].mean(dim=0)
    ce = F.one_hot(idx, E).float().sum(dim=1)[:, :cfg.num_experts].mean(dim=0)
    return cfg.num_experts * torch.sum(me * ce)


def _experts(p, xe, dtype):
    """The expert FFN (swiglu) over (E, cap, d) -> (E, cap, d)."""
    g = F.silu(_einsum("ecd,edf->ecf", xe, p["w_gate"]))
    u = _einsum("ecd,edf->ecf", xe, p["w_up"])
    h = (g * u).to(dtype)
    return _einsum("ecf,efd->ecd", h, p["w_down"]).to(dtype)


def moe_apply(cfg, p, x, policy: RunPolicy, tp: int = 1
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,d) -> (y, aux) through ``policy.moe_impl``."""
    require_no_mesh_options(policy)
    if policy.moe_impl == "sorted":
        return moe_apply_sorted(cfg, p, x, policy, tp=tp)
    return moe_apply_dense(cfg, p, x, policy, tp=tp)


def moe_apply_sorted(cfg, p, x, policy: RunPolicy, tp: int = 1
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort/scatter dispatch: the same drops and priority as the dense path,
    without its (T, E, cap) dispatch einsums. On CUDA ``index_add_`` adds a
    token's expert outputs in atomic order, so this path is not bitwise
    repeatable there (the dense path is)."""
    B, S, d = x.shape
    E, K = num_experts_eff(cfg, tp), cfg.top_k
    T = B * S
    xt = x.reshape(T, d)
    probs, gate_vals, idx = _route(cfg, p, xt, E)
    cap = capacity(cfg, T, policy)

    # slot-major flattening: every slot-0 routing queues before any slot 1
    expert_flat = idx.t().reshape(-1)  # (K*T,)
    token_flat = torch.arange(T, device=x.device).repeat(K)
    gate_flat = gate_vals.t().reshape(-1)
    order = torch.argsort(expert_flat, stable=True)
    e_sorted = expert_flat[order]
    t_sorted = token_flat[order]
    g_sorted = gate_flat[order]
    counts = torch.bincount(expert_flat, minlength=E)
    starts = torch.cumsum(counts, 0) - counts  # exclusive
    pos_in_e = torch.arange(T * K, device=x.device) - starts[e_sorted]
    keep = pos_in_e < cap
    slot = torch.where(keep, e_sorted * cap + pos_in_e,
                       torch.full_like(pos_in_e, E * cap))  # E*cap = trash

    xe = torch.zeros((E * cap + 1, d), dtype=x.dtype, device=x.device)
    xe[slot] = xt[t_sorted]
    ye = _experts(p, xe[:-1].reshape(E, cap, d), x.dtype).reshape(E * cap, d)
    contrib = (torch.where(keep, g_sorted, 0.0)[:, None].to(x.dtype)
               * ye[slot.clamp(max=E * cap - 1)])
    y = torch.zeros((T, d), dtype=x.dtype, device=x.device)
    y.index_add_(0, t_sorted, contrib)
    return y.reshape(B, S, d), _aux(cfg, probs, idx, E)


def moe_apply_dense(cfg, p, x, policy: RunPolicy, tp: int = 1
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,d) -> (y, aux) by dense GShard dispatch and combine einsums.
    Capacity-dropped routings pass through (residual)."""
    B, S, d = x.shape
    E, K = num_experts_eff(cfg, tp), cfg.top_k
    T = B * S
    xt = x.reshape(T, d)
    probs, gate_vals, idx = _route(cfg, p, xt, E)
    cap = capacity(cfg, T, policy)

    onehot = F.one_hot(idx, E).float()  # (T,K,E)
    # each (t,k) routing's position in its expert's queue, slot 0 first, in
    # float32 as the JAX package counts; top-k ids are distinct, so the
    # per-slot maps sum into single (T,E) maps
    pos_te = torch.zeros((T, E), device=x.device)
    gate_te = torch.zeros((T, E), device=x.device)
    hit_te = torch.zeros((T, E), device=x.device)
    prior = torch.zeros((E,), device=x.device)
    for s in range(K):
        m = onehot[:, s, :]
        pos_s = torch.cumsum(m, dim=0) - m + prior[None, :]
        prior = prior + m.sum(dim=0)
        pos_te = pos_te + pos_s * m
        gate_te = gate_te + gate_vals[:, s, None] * m
        hit_te = hit_te + m
    within = hit_te * (pos_te < cap).float()
    slot = F.one_hot(pos_te.clamp(max=cap - 1).long(), cap).float()  # (T,E,cap)
    combine = (gate_te * within)[:, :, None] * slot
    dispatch = (within[:, :, None] * slot).to(x.dtype)

    xe = _einsum("tec,td->ecd", dispatch, xt).to(x.dtype)
    ye = _experts(p, xe, x.dtype)
    y = _einsum("tec,ecd->td", combine.to(x.dtype), ye).to(x.dtype)
    return y.reshape(B, S, d), _aux(cfg, probs, idx, E)


class MoE(nn.Module):
    """The expert FFN of a block: ``router`` (d, E), ``w_gate``/``w_up``
    (E, d, f) and ``w_down`` (E, f, d), E = ``num_experts_eff(cfg, tp)``,
    named as the JAX tree's ``ffn`` keys."""

    def __init__(self, cfg, dtype: torch.dtype, device, tp: int = 1):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        E = num_experts_eff(cfg, tp)
        self.cfg, self.tp = cfg, tp

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                                requires_grad=False)

        self.router = param(d, E)
        self.w_gate = param(E, d, f)
        self.w_up = param(E, d, f)
        self.w_down = param(E, f, d)

    def params(self) -> Dict[str, torch.Tensor]:
        return {"router": self.router, "w_gate": self.w_gate,
                "w_up": self.w_up, "w_down": self.w_down}

    def reset_parameters(self, gen: torch.Generator) -> None:
        """Draw the logical experts, then zero the pads (as ``moe_init``: the
        padded init is the unpadded one)."""
        d, f, E0 = self.cfg.d_model, self.cfg.d_ff, self.cfg.num_experts
        for name, shape, fan_in in (("router", (d, E0), d),
                                    ("w_gate", (E0, d, f), d),
                                    ("w_up", (E0, d, f), d),
                                    ("w_down", (E0, f, d), f)):
            w = getattr(self, name)
            w.zero_()
            part = w[:, :E0] if name == "router" else w[:E0]
            part.copy_(dense_init(gen, shape, w.dtype, in_axis_size=fan_in))

    def forward(self, x, policy: RunPolicy, with_aux: bool = False):
        """y, or (y, the load-balance loss) with ``with_aux``."""
        y, aux = moe_apply(self.cfg, self.params(), x, policy, tp=self.tp)
        return (y, aux) if with_aux else y
