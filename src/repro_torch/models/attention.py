"""Attention: GQA with the exact TP head layout; full, blocked and decode paths
(the port of ``repro.models.attention``).

Full path:    one (Sq x Sk) logits tensor per kv group
Blocked path: block-causal online softmax over (q block, kv block) pairs;
              only blocks inside the causal band are computed
Decode path:  one query token against a dense KV cache

Sliding-window (local) attention runs all three with a window mask, and
decodes against a ring buffer of the window's last W tokens.

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
)
from repro_torch.models.layout import HeadLayout


def _einsum_f32(spec: str, a, b):
    """einsum accumulated and returned in fp32 (JAX's
    ``preferred_element_type=jnp.float32``); free for fp32 inputs."""
    return torch.einsum(spec, a.float(), b.float())


class Attention(nn.Module):
    """Parameters as in the JAX tree: ``wq`` (d, Hq_eff, D), ``wk``/``wv``
    (d, Hkv_eff, D), ``wo`` (Hq_eff, D, d); ``bq``/``bk``/``bv`` with
    ``qkv_bias``; ``q_norm``/``k_norm`` (D,) with ``qk_norm``."""

    def __init__(self, cfg, layout: HeadLayout, dtype: torch.dtype, device):
        super().__init__()
        self.cfg = cfg
        self.layout = layout
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

    def project_qkv(self, x, positions):
        """``_project_qkv``: x (B,S,d) -> q (B,S,N,P,D), k, v (B,S,N,D);
        RoPE applied."""
        cfg, lay = self.cfg, self.layout
        B, S, _ = x.shape
        q = _einsum_f32("bsd,dhe->bshe", x, self.wq).to(x.dtype)
        k = _einsum_f32("bsd,dhe->bshe", x, self.wk).to(x.dtype)
        v = _einsum_f32("bsd,dhe->bshe", x, self.wv).to(x.dtype)
        if cfg.qkv_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        if cfg.qk_norm:
            q = head_rmsnorm(q, self.q_norm)
            k = head_rmsnorm(k, self.k_norm)
        if cfg.pos_emb == "rope":
            q = rope_apply(q, positions, cfg.rope_theta)
            k = rope_apply(k, positions, cfg.rope_theta)
        return q.reshape(B, S, lay.n_kv_eff, lay.p, cfg.head_dim), k, v

    def out_proj(self, o, policy: RunPolicy):
        """``_out_proj``: o (B,S,...,D) with n_q_eff heads -> (B,S,d)."""
        require_no_mesh_options(policy)
        B, S = o.shape[:2]
        o = o.reshape(B, S, self.layout.n_q_eff, self.cfg.head_dim)
        return torch.einsum("bshe,hed->bsd", o, self.wo)

    def forward(self, x, policy: RunPolicy, positions, window: int = 0
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``attn_apply``: causal self-attention over x (B,S,d) at
        ``positions`` (S,), over the last ``window`` keys when window > 0;
        returns the output and the sequence's {'k', 'v'} (B,S,N,D)."""
        S = x.shape[1]
        q, k, v = self.project_qkv(x, positions)
        qb = policy.attn_q_block
        if qb and S > qb:
            o = _blocked_causal(q, k, v, qb, policy.attn_kv_block or qb, window)
        else:
            ar = torch.arange(S, device=x.device)
            o = _sdpa(q, k, v, _causal_bias(ar, ar, window))
        return self.out_proj(o, policy), {"k": k, "v": v}

    def decode(self, x, pos, cache: Dict[str, torch.Tensor], policy: RunPolicy,
               window: int = 0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``attn_decode``: x (B,1,d); pos (B,) absolute position of the new
        token; cache {'k','v'} (B,Sc,N,D), written in place. With window > 0
        and Sc == window the cache is a ring: the token goes to slot
        pos % W, and slot s holds position pos - ((pos - s) mod W), unwritten
        where that is negative. Otherwise it is dense and the token goes to
        row pos; the caller keeps pos < Sc (``TransformerLM.decode_step``
        checks it)."""
        B = x.shape[0]
        q, k_new, v_new = self.project_qkv(x, pos[:, None])
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
        ck[bidx, idx] = k_new[:, 0]
        cv[bidx, idx] = v_new[:, 0]
        o = _sdpa(q, ck, cv, _causal_bias(pos[:, None], kpos, window))
        return self.out_proj(o, policy), cache


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
