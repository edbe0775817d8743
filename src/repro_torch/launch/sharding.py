"""Sharding rules: param/optimizer/batch/cache specs for any arch (the port
of ``repro.launch.sharding``), and the explicit shards that follow them.

Megatron TP over 'model' (QKV/up column-parallel; O/down row-parallel; vocab
sharded embedding + logits; MoE experts = EP over 'model'), DP over
('pod','data'), ZeRO-1 optimizer-state sharding over the DP axes. Rules are
path-pattern based with divisibility guards: a dim is sharded only if
divisible by the axis size (the exact TP head layout in models/layout.py
guarantees divisibility for head dims; anything else falls back to
replication rather than failing).

A spec is a tuple with one entry per dim, as a JAX ``PartitionSpec`` reads:
None (replicated), an axis name, or a tuple of axis names (the dim split
over their product, the first axis major); ``()`` replicates everything.
The port holds each tensor as this rank's chunk of it
(``models.parallel.local_chunk``), where the JAX package hands the specs to
GSPMD. The JAX package's
``stacked_param_specs`` / ``stacked_params_sds`` serve only its ``lax.scan``
memory lowerings, which a torch trace does not need (``launch/steps.py``).
"""
from __future__ import annotations

import math
import re
from typing import Any, Dict, Tuple

import torch
from torch import nn

from repro_torch.launch.mesh import dp_axes, dp_size, tp_size
from repro_torch.models.layers import RunPolicy
from repro_torch.models.parallel import (
    Spec,
    flat_specs,
    gather_full,
    local_chunk,
    spec_axes,
)

# (path regex, spec template) — template entries name mesh axes or None;
# 'MODEL' is replaced by 'model', 'DP' by the dp axes tuple.
_PARAM_RULES = [
    (r"embed/w$", ("MODEL", None)),
    (r"head/w$", (None, "MODEL")),
    # attention
    (r"mixer/wq$", (None, "MODEL", None)),
    (r"mixer/wk$", (None, "MODEL", None)),
    (r"mixer/wv$", (None, "MODEL", None)),
    (r"mixer/wo$", ("MODEL", None, None)),
    (r"mixer/b[qkv]$", ("MODEL", None)),
    # dense mlp
    (r"ffn/w_gate$", (None, "MODEL")),
    (r"ffn/w_up$", (None, "MODEL")),
    (r"ffn/w_down$", ("MODEL", None)),
    (r"ffn/b_up$", ("MODEL",)),
    # moe (expert parallelism; 3D expert weights)
    (r"ffn/router$", (None, "MODEL")),
    (r"ffn/w_gate$", ("MODEL", None, None)),
    (r"ffn/w_up$", ("MODEL", None, None)),
    (r"ffn/w_down$", ("MODEL", None, None)),
    # rg-lru
    (r"mixer/w_y$", (None, "MODEL")),
    (r"mixer/w_gate$", (None, "MODEL")),
    (r"mixer/conv_w$", (None, "MODEL")),
    (r"mixer/conv_b$", ("MODEL",)),
    (r"mixer/gate_[ir]$", ("MODEL", None, None)),
    (r"mixer/bias_[ir]$", ("MODEL",)),
    (r"mixer/lambda$", ("MODEL",)),
    (r"mixer/w_out$", ("MODEL", None)),
    # rwkv6
    (r"mixer/w[rkvg]$", (None, "MODEL")),
    (r"mixer/wo$", ("MODEL", None)),
    (r"mixer/u$", ("MODEL", None)),
    (r"mixer/w0$", ("MODEL",)),
    (r"mixer/ln_scale$", ("MODEL",)),
    (r"mixer/ln_bias$", ("MODEL",)),
    (r"ffn/wk$", (None, "MODEL")),
    (r"ffn/wv$", ("MODEL", None)),
    (r"ffn/wr$", (None, "MODEL")),
]


def _flat_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat_paths(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat_paths(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _rebuild(tree, flat, prefix=""):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], flat, f"{prefix}{k}/") for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            _rebuild(v, flat, f"{prefix}{i}/") for i, v in enumerate(tree))
    return flat[prefix[:-1]]


def _guard(spec_t, shape, mesh) -> Spec:
    """Drop shardings on non-divisible dims."""
    parts = []
    for dim, ax in zip(shape, spec_t + (None,) * (len(shape) - len(spec_t))):
        if ax is None:
            parts.append(None)
            continue
        size = math.prod(mesh.shape[a] for a in spec_axes(ax))
        parts.append(ax if dim % size == 0 else None)
    return tuple(parts)


def _resolve(template, mesh):
    out = []
    for e in template:
        if e == "MODEL":
            out.append("model")
        elif e == "DP":
            dp = dp_axes(mesh)
            out.append(dp if len(dp) > 1 else dp[0])
        else:
            out.append(e)
    return tuple(out)


def param_specs(params_shape, mesh):
    """Tree of specs matching the param tree (leaves need only ``.shape``)."""

    def spec_for(path: str, leaf) -> Spec:
        shape = tuple(leaf.shape)
        for pat, template in _PARAM_RULES:
            if re.search(pat, path):
                t = _resolve(template, mesh)
                if len(t) != len(shape):
                    continue  # e.g. mlp-vs-moe w_gate rules differ in rank
                return _guard(t, shape, mesh)
        return ()

    flat = {p: spec_for(p, l) for p, l in _flat_paths(params_shape)}
    return _rebuild(params_shape, flat)


def _map_specs(fn, specs, shapes):
    """fn(spec, leaf) over a spec tree and the tree of ``shapes`` (same
    structure; spec tuples are leaves)."""
    flat_s = dict(flat_specs(specs))
    return _rebuild(shapes, {p: fn(flat_s[p], l)
                             for p, l in _flat_paths(shapes)})


def zero1_specs(p_specs, params_shape, mesh):
    """Optimizer-state specs: param spec + extra shard over the DP axes on the
    first replicated, divisible dim (ZeRO-1)."""
    dp = dp_axes(mesh)
    dsz = dp_size(mesh)
    dp_entry = dp if len(dp) > 1 else dp[0]

    def add_dp(spec: Spec, leaf) -> Spec:
        parts = list(spec) + [None] * (len(leaf.shape) - len(spec))
        for i, (dim, cur) in enumerate(zip(leaf.shape, parts)):
            if cur is None and dim % dsz == 0:
                parts[i] = dp_entry
                return tuple(parts)
        return tuple(parts)

    return _map_specs(add_dp, p_specs, params_shape)


def opt_specs(p_specs, params_shape, mesh):
    z = zero1_specs(p_specs, params_shape, mesh)
    return {"m": z, "v": z, "master": z, "count": ()}


def batch_spec(mesh, *, ndim: int, batch_size: int) -> Spec:
    dp = dp_axes(mesh)
    entry = dp if len(dp) > 1 else dp[0]
    if batch_size % dp_size(mesh) != 0:
        entry = None  # e.g. long_500k batch=1: replicate
    return (entry,) + (None,) * (ndim - 1)


def cache_specs_tree(cache_shape, mesh, batch_size: int, *, stacked: bool = False):
    """Decode-cache specs: batch over DP; head/state dims over 'model'.

    Head/state dims are addressed from the right so the same rules serve the
    per-layer-list and stacked (L, ...) layouts."""
    dp = dp_axes(mesh)
    entry = dp if len(dp) > 1 else dp[0]
    if batch_size % dp_size(mesh) != 0:
        entry = None
    tsz = tp_size(mesh)
    b_idx = 1 if stacked else 0

    def spec(path: str, leaf) -> Spec:
        shp = leaf.shape
        nd = len(shp)
        parts = [None] * nd
        parts[b_idx] = entry
        tail = None  # (negative) index of the model-sharded dim
        base = path.split("/")[-1]
        if base in ("k", "v", "ks", "vs"):
            tail = -2  # n_kv_eff
        elif base in ("h", "conv"):
            tail = -1  # lru width
        elif base == "s":
            tail = -3  # rwkv heads
        if tail is not None and shp[tail] % tsz == 0:
            parts[nd + tail] = "model"
        return tuple(parts)

    flat = {p: spec(p, l) for p, l in _flat_paths(cache_shape)}
    return _rebuild(cache_shape, flat)


def tp_shard_nodes(tp: int, nodes: int) -> Tuple[int, ...]:
    """Superchip index per tensor-parallel rank when ``tp`` ranks spread
    over ``nodes`` superchips: consecutive ranks pack onto a node
    (ceil(tp/nodes) per node), so intra-node ranks share the fast C2C/
    NVLink domain and only the inter-node boundary crosses the fabric.
    Pure integers — the cluster serve plan and cluster benchmarks place
    TP shards through this one mapping."""
    if tp < 1 or nodes < 1:
        raise ValueError(f"tp={tp} and nodes={nodes} must be >= 1")
    per = -(-tp // nodes)
    return tuple(min(r // per, nodes - 1) for r in range(tp))


def make_run_policy(mesh, *, remat: bool = False,
                    attn_q_block: int = 0, attn_kv_block: int = 0,
                    sequence_parallel: bool = False,
                    quantize_tp_collectives: bool = False,
                    kv_cache_quant: bool = False,
                    moe_impl: str = "dense") -> RunPolicy:
    """The run policy of a step on ``mesh`` (None: one device). Under a
    mesh every step splits its batch over the DP axes, and with
    ``sequence_parallel`` the residual of a sequence that the model axis
    divides over its positions (the reference's ``make_constrain``)."""
    from repro_torch.models.transformer import set_policy_tp

    pol = RunPolicy(
        remat=remat,
        attn_q_block=attn_q_block,
        attn_kv_block=attn_kv_block,
        sequence_parallel=sequence_parallel and mesh is not None,
        quantize_tp_collectives=quantize_tp_collectives and mesh is not None,
        kv_cache_quant=kv_cache_quant,
        moe_impl=moe_impl,
        mesh=mesh,
    )
    return set_policy_tp(pol, tp_size(mesh) if mesh is not None else 1)


# ---------------------------------------------------------------------------
# Explicit shards
# ---------------------------------------------------------------------------


def gather_tree(tree, specs, mesh):
    """:func:`gather_full` over a tree and its spec tree."""
    return _map_specs(lambda s, t: gather_full(t, s, mesh), specs, tree)


@torch.no_grad()
def shard_model_(model: nn.Module, mesh) -> Dict[str, Any]:
    """Replace every parameter of ``model`` (full, as ``init_params`` or a
    loader made it at the mesh's tp) by this rank's chunk under
    :func:`param_specs`; records ``model.mesh``, ``model.param_specs`` and
    ``model.zero_specs`` (:func:`zero1_specs`, for the optimizer state) and
    returns the param specs."""
    full = model.params_tree()
    specs = param_specs(full, mesh)
    model.zero_specs = zero1_specs(specs, full, mesh)
    flat = dict(flat_specs(specs))
    for name, p in list(model.named_parameters()):
        path = name.replace(".", "/")
        local = local_chunk(p.data, flat[path], mesh)
        if local.shape == p.shape:
            continue
        owner, _, attr = name.rpartition(".")
        setattr(model.get_submodule(owner), attr,
                nn.Parameter(local.clone(), requires_grad=p.requires_grad))
    model.mesh = mesh
    model.param_specs = specs
    return specs
