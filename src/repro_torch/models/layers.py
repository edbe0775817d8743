"""Shared layer primitives: run policy, inits, norms, RoPE, MLPs
(the port of ``repro.models.layers``)."""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.parallel import (
    copy_in,
    copy_to,
    local_slice,
    param_local,
    reduce_from,
    reduce_scatter_from,
    split_local,
    tp_axis,
)


@dataclass
class RunPolicy:
    """Execution knobs of a forward.

    ``attn_q_block`` > 0 runs full-sequence attention block-causally
    (:func:`repro_torch.models.attention._blocked_causal`) with
    ``attn_kv_block`` (default: the q block) keys per block. MoE layers
    route with ``moe_capacity_factor`` through ``moe_impl``: ``"dense"``
    (GShard dispatch einsums) or ``"sorted"`` (scatter dispatch). rwkv6's
    wkv runs in chunks of ``rwkv_chunk`` tokens (halved until it divides the
    sequence). ``remat`` recomputes each block's activations in the
    backward pass of a training forward (``torch.utils.checkpoint``, the
    JAX package's ``jax.checkpoint``) instead of keeping them.

    ``mesh`` (a ``repro_torch.launch.mesh.Mesh``, set by
    ``launch.sharding.make_run_policy``) makes the blocks run on this
    rank's shards and call the collectives of ``models/parallel.py``.
    ``quantize_tp_collectives`` replaces the row-parallel all-reduces by the
    int8 two-phase reduce (``models/qcomm.py``) and needs a mesh.
    ``kv_cache_quant`` asks for int8 KV caches (``init_cache(kv_quant=True)``;
    decode follows the cache it is given). ``sequence_parallel`` splits the
    residual of a sequence that the model axis divides on its positions
    (``models/parallel.py``): the JAX package's ``constrain`` of the
    ``"residual"`` activation to ``P(dp, "model", None)``, as explicit
    collectives. The JAX package's ``onehot_embed`` and its other
    ``constrain`` names have no counterpart: the embedding's shape shows
    whether its vocab is sharded, and explicit shards fix every other
    activation layout in the blocks."""

    remat: bool = False
    attn_q_block: int = 0  # 0 => unblocked attention
    attn_kv_block: int = 0
    rwkv_chunk: int = 128
    moe_capacity_factor: float = 1.25
    quantize_tp_collectives: bool = False  # int8 two-phase TP all-reduce
    kv_cache_quant: bool = False  # int8 KV cache (decode memory term)
    moe_impl: str = "dense"  # dense (GShard einsum) | sorted (scatter)
    sequence_parallel: bool = False  # residual split on S over 'model'
    mesh: Any = None


def require_no_mesh_options(policy: RunPolicy) -> None:
    if policy.quantize_tp_collectives and policy.mesh is None:
        raise NotImplementedError(
            "int8 TP collectives need a device mesh "
            "(launch.sharding.make_run_policy)")


def row_parallel(h, w, policy: RunPolicy, axis, seq=None):
    """h (B, S, K_local) @ w (K_local, d), summed over ``axis`` when the
    contraction is split over it: by all-reduce, or by the int8 two-phase
    reduce under ``policy.quantize_tp_collectives`` -- an inference lever:
    a pass that records grads keeps the exact all-reduce. With ``seq`` (the
    residual seq-split over it) this rank's positions of the sum: by
    reduce-scatter, or the int8 reduce's local positions."""
    if axis is None:
        return h @ w
    if policy.quantize_tp_collectives and not torch.is_grad_enabled():
        from repro_torch.models.qcomm import rowparallel_matmul_q8

        y = rowparallel_matmul_q8(h, w, axis, h.dtype)
        return y if seq is None else local_slice(y, 1, seq)
    if seq is not None:
        return reduce_scatter_from(h @ w, 1, seq)
    return reduce_from(h @ w, axis)


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

    def forward(self, x, seq=None):
        """Over the positions of x; with ``seq`` (x seq-split over it) the
        replicated scale and bias sum their grads over it."""
        if self.kind == "rmsnorm":
            return rmsnorm(x, copy_to(self.scale, seq))
        return layernorm(x, copy_to(self.scale, seq), copy_to(self.bias, seq))


# ---------------------------------------------------------------------------
# Positional embeddings
# ---------------------------------------------------------------------------


def _freqs(half: int, theta: float, device) -> torch.Tensor:
    return (1.0 / theta) ** (torch.arange(half, dtype=torch.float32,
                                          device=device) / half)


def _yarn_inv(D: int, theta: float, factor: float, original: int,
              beta_fast: float, beta_slow: float) -> torch.Tensor:
    """YaRN's inverse frequencies (D // 2,) in fp32 on the host, as Hugging
    Face's ``_compute_yarn_parameters`` computes them with truncated bounds:
    the extrapolated (1 / theta^(2i/D)) and interpolated (÷ factor)
    frequencies blended by a linear ramp between the correction dims of
    ``beta_fast`` and ``beta_slow`` rotations over the original length."""
    def corr_dim(rot):
        return (D * math.log(original / (rot * 2 * math.pi))) \
            / (2 * math.log(theta))

    low = max(math.floor(corr_dim(beta_fast)), 0)
    high = min(math.ceil(corr_dim(beta_slow)), D - 1)
    pos_freqs = theta ** (torch.arange(0, D, 2, dtype=torch.float32) / D)
    extra, inter = 1.0 / pos_freqs, 1.0 / (factor * pos_freqs)
    ramp = torch.clamp((torch.arange(D // 2, dtype=torch.float32) - low)
                       / ((high + 0.001 if high == low else high) - low), 0, 1)
    keep = 1 - ramp  # the extrapolated share
    return inter * (1 - keep) + extra * keep


@functools.lru_cache(maxsize=None)
def yarn_freqs(cfg, device) -> torch.Tensor:
    """``cfg``'s YaRN inverse frequencies on ``device``, made once a
    config and device (a normal tensor even under inference mode); a CUDA
    graph reads it."""
    with torch.inference_mode(False):
        return _yarn_inv(cfg.head_dim, float(cfg.rope_theta),
                         float(cfg.yarn_factor), cfg.yarn_original_max_len,
                         cfg.yarn_beta_fast, cfg.yarn_beta_slow).to(device)


def rope_apply(x, positions, theta: float, freqs=None, scale: float = 1.0):
    """x: (..., S, H, D); positions broadcastable to (..., S). ``freqs``
    (D // 2,) replaces the inverse frequencies of ``theta`` (YaRN's) and
    ``scale`` multiplies cos and sin (YaRN's attention factor)."""
    half = x.shape[-1] // 2
    inv = _freqs(half, theta, x.device) if freqs is None else freqs
    ang = positions.float()[..., None] * inv
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    if scale != 1.0:
        cos, sin = cos * scale, sin * scale
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
        self.cfg_d_ff = f

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

    def forward(self, x, policy: RunPolicy, seq=None):
        """Column-parallel up/gate and row-parallel down projection over the
        model axis where it divides d_ff; replicated otherwise. With ``seq``
        (x seq-split over it) the split MLP reads the whole sequence and
        gives this rank's positions; the replicated one runs on them."""
        require_no_mesh_options(policy)
        ax = tp_axis(policy)
        ax = ax if split_local(self.cfg_d_ff, ax) else None
        if ax is not None:
            x = copy_in(x, ax, seq)

        def part(w, dim):  # replicated weights on local positions: copy_to
            if ax is None:
                return copy_to(w, seq)
            return param_local(w, dim, self.cfg_d_ff, ax)

        def col(w):
            return x @ part(w, -1)

        if self.act in ("swiglu", "geglu"):
            g = col(self.w_gate)
            g = F.silu(g) if self.act == "swiglu" else F.gelu(g, approximate="tanh")
            h = g * col(self.w_up)
        else:
            h = F.gelu(col(self.w_up) + part(self.b_up, 0), approximate="tanh")
        y = row_parallel(h, part(self.w_down, 0), policy, ax, seq)
        return y if self.act != "gelu" else y + copy_to(self.b_down, seq)
