"""Attention: GQA with the exact TP head layout; full, blocked and decode paths
(the port of ``repro.models.attention``).

Full path:    one (Sq x Sk) logits tensor per kv group
Blocked path: block-causal online softmax over (q block, kv block) pairs;
              only blocks inside the causal band are computed
Decode path:  one query token against a dense KV cache

Sliding-window (local) attention runs all three with a window mask, and
decodes against a ring buffer of the window's last W tokens.

Under a mesh (``RunPolicy.mesh``) the heads split over the model axis as
the exact TP layout (``HeadLayout``) lets them: this rank computes its
``n_q_eff / tp`` q heads over its ``n_kv_eff / tp`` kv heads, and the output
projection is row-parallel (an all-reduce, or the int8 two-phase reduce
under ``quantize_tp_collectives``). Under sequence parallelism the input
is all-gathered on the sequence and the output reduce-scattered on it. A
dense ``attention`` cache may be int8 (``init_cache(kv_quant=True)``): each
new token's k and v are quantized per (token, head) on write, and the cache
is dequantized on read.

The projections and ``_sdpa`` are plain large products (``torch.einsum``),
as the JAX package leaves them to XLA. Paged decode attention, the serve
path's kernel, is ``repro_torch.kernels.paged_attention``.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.kernels.common import NEG_INF
from repro_torch.models.layers import (
    RunPolicy,
    dense_init,
    head_rmsnorm,
    require_no_mesh_options,
    rope_apply,
    row_parallel,
    yarn_freqs,
)
from repro_torch.models.layout import HeadLayout
from repro_torch.models.parallel import copy_in, copy_to, param_local, tp_axis


def _einsum_f32(spec: str, a, b):
    """einsum accumulated and returned in fp32 (JAX's
    ``preferred_element_type=jnp.float32``); free for fp32 inputs."""
    return torch.einsum(spec, a.float(), b.float())


class Attention(nn.Module):
    """Parameters as in the JAX tree: ``wq`` (d, Hq_eff, D), ``wk``/``wv``
    (d, Hkv_eff, D), ``wo`` (Hq_eff, D, d); ``bq``/``bk``/``bv`` with
    ``qkv_bias``; ``q_norm``/``k_norm`` (D,) with ``qk_norm``."""

    def __init__(self, cfg, layout: HeadLayout, dtype: torch.dtype, device,
                 kind: str = "attention"):
        super().__init__()
        self.cfg = cfg
        self.layout = layout
        # YaRN rope on the global layers of a config that asks for it
        self.yarn = cfg.yarn_factor > 0 and kind == "attention"
        d, hd = cfg.d_model, cfg.head_dim
        nq, nkv = layout.n_q_eff, layout.n_kv_eff

        def param(*shape, fill=None):
            t = torch.empty(shape, dtype=dtype, device=device)
            if fill is not None:
                t.fill_(fill)
            return nn.Parameter(t, requires_grad=False)

        self.wq = param(d, nq, hd)
        self.wk = param(d, nkv, hd)
        self.wv = param(d, nkv, hd)
        self.wo = param(nq, hd, d)
        if cfg.qkv_bias:
            self.bq = param(nq, hd, fill=0.0)
            self.bk = param(nkv, hd, fill=0.0)
            self.bv = param(nkv, hd, fill=0.0)
        if cfg.qk_norm:
            self.q_norm = param(hd, fill=1.0)
            self.k_norm = param(hd, fill=1.0)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """``attn_init``: N(0, 1/fan_in) over the logical heads, expanded to
        the effective layout (replicated kv heads, zero padded q heads)."""
        cfg, lay = self.cfg, self.layout
        d, hd, dt = cfg.d_model, cfg.head_dim, self.wq.dtype
        wq = dense_init(gen, (d, lay.n_q, hd), dt, in_axis_size=d)
        wk = dense_init(gen, (d, lay.n_kv, hd), dt, in_axis_size=d)
        wv = dense_init(gen, (d, lay.n_kv, hd), dt, in_axis_size=d)
        wo = dense_init(gen, (lay.n_q, hd, d), dt, in_axis_size=lay.n_q * hd)
        if not lay.identity:
            wq, wo = lay.expand_q(wq, 1), lay.expand_q(wo, 0)
            wk, wv = lay.expand_kv(wk, 1), lay.expand_kv(wv, 1)
        for p, w in ((self.wq, wq), (self.wk, wk), (self.wv, wv), (self.wo, wo)):
            p.copy_(w)

    def project_qkv(self, x, positions, policy: RunPolicy = None, seq=None):
        """``_project_qkv``: x (B,S,d) -> q (B,S,N,P,D), k, v (B,S,N,D);
        RoPE applied at ``positions`` (S,). Under a mesh N is this rank's kv
        heads; with ``seq`` x is this rank's positions, gathered over it."""
        cfg, lay = self.cfg, self.layout
        ax = tp_axis(policy)
        x = copy_in(x, ax, seq)
        B, S, _ = x.shape
        nq, nkv = lay.n_q_eff, lay.n_kv_eff

        def heads(p, full, dim=1):
            return param_local(p, dim, full, ax)

        q = _einsum_f32("bsd,dhe->bshe", x, heads(self.wq, nq)).to(x.dtype)
        k = _einsum_f32("bsd,dhe->bshe", x, heads(self.wk, nkv)).to(x.dtype)
        v = _einsum_f32("bsd,dhe->bshe", x, heads(self.wv, nkv)).to(x.dtype)
        if cfg.qkv_bias:
            q = q + heads(self.bq, nq, 0)
            k = k + heads(self.bk, nkv, 0)
            v = v + heads(self.bv, nkv, 0)
        if cfg.qk_norm:  # replicated scales used on local heads
            q = head_rmsnorm(q, copy_to(self.q_norm, ax))
            k = head_rmsnorm(k, copy_to(self.k_norm, ax))
        if cfg.pos_emb == "rope":
            yarn = ((yarn_freqs(cfg, x.device), cfg.yarn_attention_factor)
                    if self.yarn else ())
            q = rope_apply(q, positions, cfg.rope_theta, *yarn)
            k = rope_apply(k, positions, cfg.rope_theta, *yarn)
        return q.reshape(B, S, k.shape[2], lay.p, cfg.head_dim), k, v

    def out_proj(self, o, policy: RunPolicy, seq=None):
        """``_out_proj``: o (B,S,...,D) with n_q_eff heads (this rank's,
        under a mesh) -> (B,S,d); with ``seq``, this rank's positions."""
        require_no_mesh_options(policy)
        B, S = o.shape[:2]
        D = self.cfg.head_dim
        ax = tp_axis(policy)
        if ax is None:
            o = o.reshape(B, S, self.layout.n_q_eff, D)
            return torch.einsum("bshe,hed->bsd", o, self.wo)
        wo = param_local(self.wo, 0, self.layout.n_q_eff, ax)
        return row_parallel(o.reshape(B, S, -1), wo.reshape(-1, wo.shape[-1]),
                            policy, ax, seq)

    def forward(self, x, policy: RunPolicy, positions, window: int = 0,
                seq=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``attn_apply``: causal self-attention over x (B,S,d) at
        ``positions`` (S,), over the last ``window`` keys when window > 0;
        returns the output and the sequence's {'k', 'v'} (B,S,N,D). With
        ``seq`` x and the output are this rank's positions of the sequence
        (the caches stay whole)."""
        q, k, v = self.project_qkv(x, positions, policy, seq)
        S = q.shape[1]
        qb = policy.attn_q_block
        if qb and S > qb:
            o = _blocked_causal(q, k, v, qb, policy.attn_kv_block or qb, window)
        else:
            ar = torch.arange(S, device=x.device)
            o = _sdpa(q, k, v, _causal_bias(ar, ar, window))
        return self.out_proj(o, policy, seq), {"k": k, "v": v}

    def decode(self, x, pos, cache: Dict[str, torch.Tensor], policy: RunPolicy,
               window: int = 0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``attn_decode``: x (B,1,d); pos (B,) absolute position of the new
        token; cache {'k','v'} (B,Sc,N,D), written in place. With window > 0
        and Sc == window the cache is a ring: the token goes to slot
        pos % W, and slot s holds position pos - ((pos - s) mod W), unwritten
        where that is negative. Otherwise it is dense and the token goes to
        row pos; the caller keeps pos < Sc (``TransformerLM.decode_step``
        checks it). An int8 cache (with 'ks', 'vs' (B,Sc,N,1) fp32 scales)
        takes the token's codes and scales and is dequantized to k's dtype
        for the attention."""
        B = x.shape[0]
        q, k_new, v_new = self.project_qkv(x, pos[:, None], policy)
        quant = "ks" in cache
        if quant:
            k_w, ks_w = _quant_heads(k_new)
            v_w, vs_w = _quant_heads(v_new)
        else:
            k_w, v_w = k_new, v_new
        ck, cv = cache["k"], cache["v"]
        Sc = ck.shape[1]
        bidx = torch.arange(B, device=x.device)
        pos = pos.long()
        if window > 0 and Sc == window:  # ring buffer
            idx = pos % window
            s = torch.arange(window, device=x.device)[None, :]
            kpos = pos[:, None] - torch.remainder(pos[:, None] - s, window)
        else:
            idx = pos
            kpos = torch.arange(Sc, device=x.device)[None, :].expand(B, Sc)
        ck[bidx, idx] = k_w[:, 0]
        cv[bidx, idx] = v_w[:, 0]
        if quant:
            cache["ks"][bidx, idx] = ks_w[:, 0]
            cache["vs"][bidx, idx] = vs_w[:, 0]
            ck = (ck.float() * cache["ks"]).to(k_new.dtype)
            cv = (cv.float() * cache["vs"]).to(v_new.dtype)
        o = _sdpa(q, ck, cv, _causal_bias(pos[:, None], kpos, window))
        return self.out_proj(o, policy), cache


def _quant_heads(t):
    """t (B,1,N,D) -> int8 codes and fp32 scales (B,1,N,1): one scale per
    (token, head), max |t| / 127, rounding half to even."""
    tf = t.float()
    s = (tf.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-12)
    q = torch.clamp(torch.round(tf / s), -127, 127).to(torch.int8)
    return q, s


def quantize_cache(cache: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """An fp {'k', 'v'} (B,S,N,D) attention cache (``prefill``'s) as the
    int8 cache of ``init_cache(kv_quant=True)``: codes and per-(token, head)
    scales, quantized as decode quantizes each token."""
    k, ks = _quant_heads(cache["k"])
    v, vs = _quant_heads(cache["v"])
    return {"k": k, "v": v, "ks": ks, "vs": vs}


# ---------------------------------------------------------------------------
# Scaled dot product over grouped heads, masks, blocked causal attention
# ---------------------------------------------------------------------------


def _sdpa(q, k, v, bias):
    """q (B,Sq,N,P,D); k,v (B,Sk,N,D); bias broadcastable to (B,N,P,Sq,Sk)."""
    D = q.shape[-1]
    logits = _einsum_f32("bqnpd,bknd->bnpqk", q, k)
    logits = logits * (1.0 / math.sqrt(D)) + bias
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bnpqk,bknd->bqnpd", probs.to(v.dtype), v)


def _causal_bias(qpos, kpos, window: int):
    """Additive mask from absolute positions: 0 where key kpos is visible
    from query qpos, NEG_INF (-1e30, not -inf) elsewhere.
    qpos (Sq,)|(B,Sq); kpos (Sk,)|(B,Sk)."""
    if qpos.dim() == 1:
        qpos, kpos = qpos[:, None], kpos[None, :]
    else:
        qpos, kpos = qpos[:, :, None], kpos[:, None, :]
    ok = kpos <= qpos
    if window > 0:
        ok &= kpos > qpos - window
    ok &= kpos >= 0  # ring-buffer slots not yet written
    bias = torch.where(ok, 0.0, NEG_INF).to(torch.float32)
    if bias.dim() == 2:
        return bias[None, None, None]  # (1,1,1,Sq,Sk)
    return bias[:, None, None]  # (B,1,1,Sq,Sk)


def _blocked_causal(q, k, v, QB: int, KB: int, window: int):
    """Block-causal online-softmax attention. q (B,S,N,P,D); k,v (B,S,N,D).

    Only (q block, kv block) pairs that intersect the causal (and window)
    band are computed, head-major, with fp32 running max, sum and
    accumulator."""
    B, S, N, P, D = q.shape
    if S % QB or S % KB:
        raise ValueError(f"S={S} must be a multiple of the blocks {QB}, {KB}")
    scale = 1.0 / math.sqrt(D)
    qh = q.movedim(1, 3)  # (B,N,P,S,D)
    kh = k.movedim(1, 2)  # (B,N,S,D)
    vh = v.movedim(1, 2)
    outs = []
    for i in range(S // QB):
        qi = qh[:, :, :, i * QB:(i + 1) * QB]
        m = torch.full((B, N, P, QB), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, N, P, QB), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, N, P, QB, D), dtype=torch.float32,
                          device=q.device)
        q_lo, q_hi = i * QB, (i + 1) * QB - 1
        for j in range(S // KB):
            k_lo, k_hi = j * KB, (j + 1) * KB - 1
            if k_lo > q_hi:  # fully future
                continue
            if window > 0 and k_hi <= q_lo - window:  # fully out of window
                continue
            kj = kh[:, :, k_lo:k_lo + KB]
            vj = vh[:, :, k_lo:k_lo + KB]
            logits = _einsum_f32("bnpqd,bnkd->bnpqk", qi, kj) * scale
            full_inside = k_hi <= q_lo and (window == 0 or k_lo > q_hi - window)
            if not full_inside:
                qpos = torch.arange(q_lo, q_hi + 1, device=q.device)
                kpos = torch.arange(k_lo, k_hi + 1, device=q.device)
                logits = logits + _causal_bias(qpos, kpos, window)[0]
            m_new = torch.maximum(m, logits.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            pr = torch.exp(logits - m_new[..., None])
            l = l * alpha + pr.sum(dim=-1)
            acc = acc * alpha[..., None] + _einsum_f32(
                "bnpqk,bnkd->bnpqd", pr.to(v.dtype), vj)
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(o.to(q.dtype))
    return torch.cat(outs, dim=3).movedim(3, 1)  # (B,S,N,P,D)
