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

Under a mesh (``RunPolicy.mesh``) the experts split over the model axis
(expert parallelism): every model rank routes the same tokens (the router,
sharded on its expert dim, is gathered), runs its E / tp experts, and the
partial outputs are all-reduced. The dense path routes as the JAX package's
GSPMD lowering does, over the global batch: capacity from the global token
count, and each routing's queue position counting the earlier data ranks'
routings of its slot and all ranks' of earlier slots (one all-gather of the
per-(slot, expert) counts), so the drops are those of one device. The
sorted path under tensor parallelism is the reference's shard_map expert
parallelism (``_moe_sorted_ep``): capacity and positions per data shard.
Under sequence parallelism the layer gathers its input's sequence before it
routes (capacity counts the tokens routed together, so routing the local
positions alone would change the drops) and reduce-scatters its output on
the sequence in place of the all-reduce.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.common import NEG_INF
from repro_torch.models.layers import RunPolicy, dense_init, require_no_mesh_options
from repro_torch.models.parallel import (
    all_gather,
    all_reduce_,
    copy_to,
    dp_axis,
    gather_from,
    local_slice,
    reduce_out,
    tp_axis,
)
from repro_torch.spans import SPANS


def num_experts_eff(cfg, tp: int) -> int:
    return int(math.ceil(cfg.num_experts / tp) * tp)


def capacity(cfg, tokens: int, policy: RunPolicy) -> int:
    """Per-expert capacity for ``tokens`` tokens (a host int: no sync)."""
    cap = int(max(4, math.ceil(tokens * cfg.top_k / cfg.num_experts
                               * policy.moe_capacity_factor)))
    return min(cap, tokens)


def _einsum(eq: str, a, b):
    return torch.einsum(eq, a.float(), b.float())


def _route(cfg, p, xt, E: int, policy: RunPolicy = None):
    """Router probabilities (T, E) in fp32, pads masked, and the top-k gates
    (renormalized) and expert ids, highest first. Under a mesh the router
    is gathered whole: every model rank routes the same."""
    router = p["router"]
    if router.shape[1] != E:
        router = gather_from(router, 1, tp_axis(policy))
    logits = xt.float() @ router.float()
    if E != cfg.num_experts:
        pad = torch.arange(E, device=xt.device) >= cfg.num_experts
        logits = logits.masked_fill(pad[None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = torch.topk(probs, cfg.top_k, dim=-1, sorted=True)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_vals, idx


def _aux(cfg, probs, idx, E: int, policy: RunPolicy):
    """Switch-style load-balance loss over the real experts. Under data
    parallelism the means run over the global batch and this rank returns
    its share (the shares sum to the loss): its tokens' mean probabilities
    against the global routing fractions."""
    E0 = cfg.num_experts
    counts = F.one_hot(idx, E).float().sum(dim=1)[:, :E0]
    ax = dp_axis(policy)
    if ax is None:
        return E0 * torch.sum(probs[:, :E0].mean(dim=0) * counts.mean(dim=0))
    T = probs.shape[0] * ax.size
    ce = all_reduce_(counts.sum(dim=0), ax) / T
    return E0 * torch.sum(probs[:, :E0].sum(dim=0) / T * ce)


def _slot_offsets(onehot, policy: RunPolicy):
    """(offsets (K, E), global token count). A routing of slot s to expert
    e queues after ``offsets[s, e]`` others from outside its rank's slot-s
    cumsum: every slot before s over the whole batch, and slot s of the
    data ranks before this one."""
    local = onehot.sum(dim=0)  # (K, E), whole numbers in fp32
    ax = dp_axis(policy)
    if ax is None:
        return torch.cumsum(local, 0) - local, onehot.shape[0]
    counts = all_gather(local[None], 0, ax)  # (n_dp, K, E)
    total = counts.sum(dim=0)
    return (torch.cumsum(total, 0) - total + counts[:ax.rank].sum(dim=0),
            onehot.shape[0] * ax.size)


def _experts(p, xe, dtype):
    """The expert FFN (swiglu) over (E, cap, d) -> (E, cap, d)."""
    g = F.silu(_einsum("ecd,edf->ecf", xe, p["w_gate"]))
    u = _einsum("ecd,edf->ecf", xe, p["w_up"])
    h = (g * u).to(dtype)
    return _einsum("ecf,efd->ecd", h, p["w_down"]).to(dtype)


def moe_apply(cfg, p, x, policy: RunPolicy, tp: int = 1, seq=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,d) -> (y, aux) through ``policy.moe_impl``; with ``seq`` x
    and y are this rank's positions of the sequence, gathered over it to
    route."""
    require_no_mesh_options(policy)
    if seq is not None:
        x = gather_from(x, 1, seq)
    if policy.moe_impl == "sorted":
        if tp_axis(policy) is not None:
            return _moe_sorted_ep(cfg, p, x, policy, tp, seq)
        return moe_apply_sorted(cfg, p, x, policy, tp=tp)
    return moe_apply_dense(cfg, p, x, policy, tp=tp, seq=seq)


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
    probs, gate_vals, idx = _route(cfg, p, xt, E, policy)
    e_sorted, t_sorted, g_sorted, pos_in_e, k_sorted = _sorted_queue(
        idx, gate_vals, E)
    if dp_axis(policy) is None:
        cap = capacity(cfg, T, policy)
    else:  # global positions, as the dense path's
        onehot = F.one_hot(idx, E).float()
        offsets, T_glob = _slot_offsets(onehot, policy)
        cap = capacity(cfg, T_glob, policy)
        local = onehot.sum(dim=0)
        shift = offsets - (torch.cumsum(local, 0) - local)
        pos_in_e = pos_in_e + shift[k_sorted, e_sorted].long()
    y = _sorted_experts(p, xt, e_sorted, t_sorted, g_sorted, pos_in_e, 0, E,
                        cap, x.dtype)
    return y.reshape(B, S, d), _aux(cfg, probs, idx, E, policy)


def _sorted_queue(idx, gate_vals, E: int):
    """Slot-major flattening (every slot-0 routing queues before any slot
    1), stably sorted by expert: (expert, token, gate, position in its
    expert's queue, slot) per routing."""
    T, K = idx.shape
    expert_flat = idx.t().reshape(-1)  # (K*T,)
    token_flat = torch.arange(T, device=idx.device).repeat(K)
    gate_flat = gate_vals.t().reshape(-1)
    order = torch.argsort(expert_flat, stable=True)
    e_sorted = expert_flat[order]
    counts = torch.zeros(E, dtype=expert_flat.dtype, device=idx.device)
    counts = counts.index_add(0, expert_flat, torch.ones_like(expert_flat))
    starts = torch.cumsum(counts, 0) - counts  # exclusive
    pos_in_e = torch.arange(T * K, device=idx.device) - starts[e_sorted]
    return (e_sorted, token_flat[order], gate_flat[order], pos_in_e,
            torch.div(order, T, rounding_mode="floor"))


def _sorted_experts(p, xt, e_sorted, t_sorted, g_sorted, pos_in_e, e_lo: int,
                    E_loc: int, cap: int, dtype):
    """Scatter the kept routings to experts [e_lo, e_lo + E_loc), run them,
    and add each token's gated outputs: (T, d)."""
    T, d = xt.shape
    local = (e_sorted >= e_lo) & (e_sorted < e_lo + E_loc)
    keep = (pos_in_e < cap) & local
    slot = torch.where(keep, (e_sorted - e_lo) * cap + pos_in_e,
                       torch.full_like(pos_in_e, E_loc * cap))  # trash row
    xe = torch.zeros((E_loc * cap + 1, d), dtype=xt.dtype, device=xt.device)
    xe = xe.index_put((slot,), xt[t_sorted])
    ye = _experts(p, xe[:-1].reshape(E_loc, cap, d), dtype).reshape(E_loc * cap, d)
    contrib = (torch.where(keep, g_sorted, 0.0)[:, None].to(dtype)
               * ye[slot.clamp(max=E_loc * cap - 1)])
    y = torch.zeros((T, d), dtype=dtype, device=xt.device)
    return y.index_add(0, t_sorted, contrib)


def _moe_sorted_ep(cfg, p, x, policy: RunPolicy, tp: int, seq=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert parallelism for the sorted dispatch (the reference's
    shard_map): each model rank routes its data shard's tokens with the
    capacity of that shard (T_loc) to its local experts; the partial
    outputs are all-reduced over the model axis. The aux loss is the mean
    of the data shards' (this rank returns its share)."""
    ax = tp_axis(policy)
    B, S, d = x.shape
    E = num_experts_eff(cfg, tp)
    E_loc = E // ax.size
    T = B * S
    xt = x.reshape(T, d)
    probs, gate_vals, idx = _route(cfg, p, xt, E, policy)
    e_sorted, t_sorted, g_sorted, pos_in_e, _ = _sorted_queue(idx, gate_vals, E)
    cap = capacity(cfg, T, policy)
    y = _sorted_experts(_local_experts(p, E, ax), copy_to(xt, ax), e_sorted,
                        t_sorted, copy_to(g_sorted, ax), pos_in_e,
                        ax.rank * E_loc, E_loc, cap, x.dtype)
    y = reduce_out(y.reshape(B, S, d), ax, seq)
    dp = dp_axis(policy)
    aux = _aux(cfg, probs, idx, E, RunPolicy())
    return y, aux / (dp.size if dp is not None else 1)


def _local_experts(p, E: int, ax):
    """This rank's experts' weights (held sharded over the model axis)."""
    if p["w_gate"].shape[0] != E:
        return p
    return {k: (local_slice(copy_to(v, ax), 0, ax) if k != "router" else v)
            for k, v in p.items()}


def moe_apply_dense(cfg, p, x, policy: RunPolicy, tp: int = 1, seq=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,d) -> (y, aux) by dense GShard dispatch and combine einsums.
    Capacity-dropped routings pass through (residual). With ``seq`` y is
    this rank's positions."""
    B, S, d = x.shape
    E = num_experts_eff(cfg, tp)
    T = B * S
    xt = x.reshape(T, d)
    probs, gate_vals, idx = _route(cfg, p, xt, E, policy)
    gate_te, within, pos_te, cap = _dense_plan(idx, gate_vals, E, cfg, policy)
    ax = tp_axis(policy)
    if ax is not None:  # this rank's experts
        E_loc = E // ax.size
        lo = ax.rank * E_loc
        p = _local_experts(p, E, ax)
        xt = copy_to(xt, ax)
        gate_te = copy_to(gate_te, ax)
        gate_te, within, pos_te = (t[:, lo:lo + E_loc]
                                   for t in (gate_te, within, pos_te))
    slot = F.one_hot(pos_te.clamp(max=cap - 1).long(), cap).float()  # (T,E,cap)
    combine = (gate_te * within)[:, :, None] * slot
    dispatch = (within[:, :, None] * slot).to(x.dtype)
    xe = _einsum("tec,td->ecd", dispatch, xt).to(x.dtype)
    ye = _experts(p, xe, x.dtype)
    y = _einsum("tec,ecd->td", combine.to(x.dtype), ye).to(x.dtype)
    y = reduce_out(y.reshape(B, S, d), ax, seq)
    return y, _aux(cfg, probs, idx, E, policy)


def _dense_plan(idx, gate_vals, E: int, cfg, policy: RunPolicy):
    """(gate (T,E), kept routings (T,E) 0/1, queue position (T,E), cap):
    each (t,k) routing's position in its expert's queue, slot 0 first, in
    float32 as the JAX package counts; top-k ids are distinct, so the
    per-slot maps sum into single (T,E) maps."""
    T, K = idx.shape
    onehot = F.one_hot(idx, E).float()  # (T,K,E)
    offsets, T_glob = _slot_offsets(onehot, policy)
    cap = capacity(cfg, T_glob, policy)
    pos_te = torch.zeros((T, E), device=idx.device)
    gate_te = torch.zeros((T, E), device=idx.device)
    hit_te = torch.zeros((T, E), device=idx.device)
    for s in range(K):
        m = onehot[:, s, :]
        pos_s = torch.cumsum(m, dim=0) - m + offsets[s][None, :]
        pos_te = pos_te + pos_s * m
        gate_te = gate_te + gate_vals[:, s, None] * m
        hit_te = hit_te + m
    return gate_te, hit_te * (pos_te < cap).float(), pos_te, cap


def moe_kept(cfg, p, x, policy: RunPolicy, tp: int = 1, seq=None
             ) -> torch.Tensor:
    """The dense path's drops: a bool (T, K) of the routings (token, slot,
    highest gate first) that fit their expert's capacity. With ``seq`` x
    is this rank's positions, gathered to route as :func:`moe_apply`
    gathers them (T counts the whole sequence)."""
    E = num_experts_eff(cfg, tp)
    if seq is not None:
        x = gather_from(x, 1, seq)
    xt = x.reshape(-1, x.shape[-1])
    _, gate_vals, idx = _route(cfg, p, xt, E, policy)
    _, within, _, _ = _dense_plan(idx, gate_vals, E, cfg, policy)
    return torch.gather(within, 1, idx) > 0


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

    def forward(self, x, policy: RunPolicy, with_aux: bool = False, seq=None):
        """y, or (y, the load-balance loss) with ``with_aux``; ``seq`` as
        :func:`moe_apply`'s."""
        with SPANS.span("moe.block", x.shape[0] * x.shape[1]):
            y, aux = moe_apply(self.cfg, self.params(), x, policy, tp=self.tp,
                               seq=seq)
        return (y, aux) if with_aux else y
