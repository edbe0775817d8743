"""RWKV6 (Finch): attention-free time mix with data-dependent decay, and the
channel mix (the port of ``repro.models.rwkv``).

wkv6 recurrence per head (K = V = head_size):
    out_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t   = diag(exp(wlog_t)) S_{t-1} + k_t v_t^T ,   wlog_t = -exp(w0 + lora(x_t)) < 0

``wkv6_ref`` is the per-token scan oracle; ``wkv6_chunked`` is the
chunkwise-parallel form the model runs. Every pairwise decay exponent is a
difference of cumulative sums with s <= t, hence <= 0, so ``exp`` never
overflows. Chunks advance one at a time in a Python loop, as ``lax.scan``
advances them in the JAX package: a chunk's (B, H, C, C, K) decay tensor
is 1.07 GB at rwkv6-1.6b's width for B = 8, C = 128, so only one is live
(built in place, except where autograd records the pass).
The reference has no Pallas kernel here; this is plain torch, as the JAX
package computes it outside any ``pallas_call``.

Under a mesh the heads split over the model axis (``wr``/``wk``/``wv``/
``wg`` column-parallel, ``wo`` row-parallel, ``u``, ``w0`` and the group
norm per head); the channel mix splits d_ff (``wk`` column, ``wv`` row)
and gathers the receptance, whose ``wr`` is column-sharded over d. Under
sequence parallelism both mixes gather their input's sequence (the token
shift reads the previous position, which may sit on the previous rank),
run as above, and reduce-scatter their output on the sequence.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import RunPolicy, dense_init
from repro_torch.models.parallel import (
    copy_to,
    gather_from,
    param_local,
    reduce_out,
    scatter_to,
    split_local,
    tp_axis,
)

_COMPONENTS = 5  # w, k, v, r, g


def w0_init(d: int) -> np.ndarray:
    """The per-channel base decay, slow to fast (``rwkv_att_init``)."""
    return (-6.0 + 5.0 * (np.arange(d) / max(1, d - 1)) ** 0.7).astype(
        np.float32)


# ---------------------------------------------------------------------------
# wkv6 core
# ---------------------------------------------------------------------------


def wkv6_ref(r, k, v, wlog, u, s0):
    """Per-token scan oracle. r, k, v, wlog: (B,S,H,K); u: (H,K); s0:
    (B,H,K,K). Returns (y (B,S,H,K) in r's dtype, final state fp32)."""
    rf, kf, vf, wf = (a.float() for a in (r, k, v, wlog))
    uf = u.float()
    state = s0.float()
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = rf[:, t], kf[:, t], vf[:, t], wf[:, t]  # (B,H,K)
        bonus = (rt * uf * kt).sum(-1)
        ys.append(torch.einsum("bhk,bhkv->bhv", rt, state)
                  + bonus[..., None] * vt)
        state = torch.exp(wt)[..., None] * state + kt[..., None] * vt[..., None, :]
    return torch.stack(ys, 1).to(r.dtype), state


def wkv6_chunked(r, k, v, wlog, u, s0, chunk: int):
    """Chunkwise-parallel wkv6; exact (all decay exponents <= 0). The chunk
    is halved until it divides S (S = 33 ends at 1)."""
    B, S, H, K = r.shape
    C = min(chunk, S)
    while S % C:
        C //= 2
    n = S // C

    def to_chunks(a):  # (B,S,H,K) -> (B,n,H,C,K)
        return a.float().reshape(B, n, C, H, K).transpose(2, 3)

    rc, kc, vc, wc = map(to_chunks, (r, k, v, wlog))
    lcum = torch.cumsum(wc, dim=3)
    pexc = lcum - wc  # exclusive cumsum = Lcum_{t-1}
    dev = r.device
    tri = torch.tril(torch.ones((C, C), dtype=torch.float32, device=dev), -1)
    eye = torch.eye(C, dtype=torch.float32, device=dev)
    uf = u.float()
    state = s0.float()
    ys = []
    for i in range(n):
        rt, kt, vt = rc[:, i], kc[:, i], vc[:, i]  # (B,H,C,K)
        lc, pe = lcum[:, i], pexc[:, i]
        # intra-chunk pairwise decay exp(P[t] - Lcum[s]) for s < t, <= 0
        E = pe[:, :, :, None, :] - lc[:, :, None, :, :]  # (B,H,C,C,K)
        if torch.is_grad_enabled():  # autograd keeps exp's output
            E = torch.exp(E) * rt[:, :, :, None, :] * kt[:, :, None, :, :]
        else:  # one (B,H,C,C,K) tensor live, not three
            E.exp_().mul_(rt[:, :, :, None, :]).mul_(kt[:, :, None, :, :])
        A = E.sum(-1) * tri
        del E
        bonus = (rt * uf[None, :, None, :] * kt).sum(-1)  # (B,H,C)
        A = A + eye * bonus[..., None]
        y = torch.matmul(A, vt)
        # inter-chunk: r_t decayed back to the chunk's start, applied to S0
        y = y + torch.matmul(rt * torch.exp(pe), state)
        # the state carried to the chunk's end
        decay_end = torch.exp(lc[:, :, -1:, :] - lc)  # (B,H,C,K), <= 0
        state = (torch.exp(lc[:, :, -1, :])[..., None] * state
                 + torch.matmul((kt * decay_end).transpose(-1, -2), vt))
        ys.append(y)
    y = torch.stack(ys, 1).transpose(2, 3).reshape(B, S, H, K)
    return y.to(r.dtype), state


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _param(shape, dtype, device, fill=None) -> nn.Parameter:
    t = torch.empty(shape, dtype=dtype, device=device)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t, requires_grad=False)


def _token_shift(x, x_prev):
    """(previous token - token) for each position; x_prev (B,d) is the last
    token of the previous segment (zeros at the start)."""
    if x_prev is None:
        x_prev = torch.zeros_like(x[:, 0])
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1) - x


def _ddlerp(p, x, sx):
    """Data-dependent token-shift mixes -> per-component mixed inputs
    (5, B, S, d)."""
    xx = x + sx * p.mu_x
    r = p.lora_B.shape[1]
    lo = torch.tanh(xx @ p.lora_A)  # (B,S,5r)
    lo = lo.reshape(lo.shape[:-1] + (_COMPONENTS, r))
    lo = torch.einsum("bscr,crd->cbsd", lo, p.lora_B)
    mixes = p.mu[:, None, None, :] + lo  # (5,B,S,d)
    return x[None] + sx[None] * mixes


def _head_groupnorm(y, scale, bias, H: int, eps: float = 64e-5):
    """Per-head layernorm of y (B,S,d) over its H heads, in fp32."""
    B, S, d = y.shape
    yf = y.float().reshape(B, S, H, d // H)
    mu = yf.mean(-1, keepdim=True)
    var = ((yf - mu) ** 2).mean(-1, keepdim=True)
    yn = ((yf - mu) * torch.rsqrt(var + eps)).reshape(B, S, d)
    return (yn * scale.float() + bias.float()).to(y.dtype)


class RwkvTimeMix(nn.Module):
    """``rwkv_att_init`` / ``rwkv_att_apply``. Parameters under the JAX
    tree's names: ``mu_x`` (d), ``mu`` (5,d), ``lora_A`` (d,5r), ``lora_B``
    (5,r,d), ``w0`` (d) fp32, ``w_lora_A`` (d,2r), ``w_lora_B`` (2r,d),
    ``wr``/``wk``/``wv``/``wg``/``wo`` (d,d), ``u`` (H,hs) fp32,
    ``ln_scale``/``ln_bias`` (d)."""

    def __init__(self, cfg, dtype: torch.dtype, device):
        super().__init__()
        d, hs, r = cfg.d_model, cfg.rwkv_head_size, cfg.rwkv_lora_rank
        self.cfg = cfg
        self.mu_x = _param((d,), dtype, device, 0.5)
        self.mu = _param((_COMPONENTS, d), dtype, device, 0.5)
        self.lora_A = _param((d, _COMPONENTS * r), dtype, device)
        self.lora_B = _param((_COMPONENTS, r, d), dtype, device, 0.0)
        self.w0 = _param((d,), torch.float32, device)
        self.w_lora_A = _param((d, 2 * r), dtype, device)
        self.w_lora_B = _param((2 * r, d), dtype, device, 0.0)
        for name in ("wr", "wk", "wv", "wg", "wo"):
            setattr(self, name, _param((d, d), dtype, device))
        self.u = _param((d // hs, hs), torch.float32, device)
        self.ln_scale = _param((d,), dtype, device, 1.0)
        self.ln_bias = _param((d,), dtype, device, 0.0)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """N(0, 1/fan_in) matrices; ``lora_B`` and ``w_lora_B`` stay zero,
        ``w0`` is the fixed slow-to-fast ramp, ``u`` is 0.1 N(0, 1)."""
        for name in ("lora_A", "w_lora_A", "wr", "wk", "wv", "wg", "wo"):
            w = getattr(self, name)
            w.copy_(dense_init(gen, tuple(w.shape), w.dtype))
        self.w0.copy_(torch.from_numpy(w0_init(self.cfg.d_model)))
        self.u.copy_(0.1 * dense_init(gen, tuple(self.u.shape), torch.float32,
                                      in_axis_size=1))

    def forward(self, x, policy: RunPolicy, x_prev: Optional[torch.Tensor] = None,
                s0: Optional[torch.Tensor] = None, seq=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """x (B,S,d); ``x_prev`` (B,d) the previous segment's last token and
        ``s0`` (B,H,hs,hs) fp32 its state (zeros when None). Returns the
        output and {'s': the state after x, 'x_prev': x's last token}. With
        ``seq`` x and the output are this rank's positions of a sequence
        from its start."""
        if seq is not None:
            x = gather_from(x, 1, seq)
        B, S, d = x.shape
        hs = self.cfg.rwkv_head_size
        H = d // hs
        ax = tp_axis(policy)
        ax = ax if split_local(d, ax) else None
        if ax is not None and H % ax.size:
            raise NotImplementedError(
                f"rwkv6: {H} heads do not split over {ax.size} ranks")
        Hl = H // (ax.size if ax is not None else 1)
        if s0 is None:
            s0 = torch.zeros((B, Hl, hs, hs), dtype=torch.float32,
                             device=x.device)
        sx = _token_shift(x, x_prev)
        xw, xk, xv, xr, xg = _ddlerp(self, x, sx)

        def cols(xx, w):  # column-parallel over the heads
            return copy_to(xx, ax) @ param_local(w, 1, d, ax)

        r = cols(xr, self.wr).reshape(B, S, Hl, hs)
        k = cols(xk, self.wk).reshape(B, S, Hl, hs)
        v = cols(xv, self.wv).reshape(B, S, Hl, hs)
        g = F.silu(cols(xg, self.wg))
        lora = cols(torch.tanh(xw @ self.w_lora_A), self.w_lora_B)
        wlog = -torch.exp(param_local(self.w0, 0, d, ax) + lora)
        y, sT = wkv6_chunked(r, k, v, wlog.reshape(B, S, Hl, hs),
                             param_local(self.u, 0, H, ax), s0,
                             policy.rwkv_chunk)
        y = _head_groupnorm(y.reshape(B, S, Hl * hs),
                            param_local(self.ln_scale, 0, d, ax),
                            param_local(self.ln_bias, 0, d, ax), Hl)
        out = reduce_out((y * g) @ param_local(self.wo, 0, d, ax), ax, seq)
        return out, {"s": sT, "x_prev": x[:, -1]}


class RwkvChannelMix(nn.Module):
    """``rwkv_ffn_init`` / ``rwkv_ffn_apply``: ``mu_k``, ``mu_r`` (d),
    ``wk`` (d,f), ``wv`` (f,d), ``wr`` (d,d)."""

    def __init__(self, cfg, dtype: torch.dtype, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.cfg_d_ff = f
        self.mu_k = _param((d,), dtype, device, 0.5)
        self.mu_r = _param((d,), dtype, device, 0.5)
        self.wk = _param((d, f), dtype, device)
        self.wv = _param((f, d), dtype, device)
        self.wr = _param((d, d), dtype, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for w in (self.wk, self.wv, self.wr):
            w.copy_(dense_init(gen, tuple(w.shape), w.dtype))

    def forward(self, x, x_prev: Optional[torch.Tensor] = None,
                policy: Optional[RunPolicy] = None, seq=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B,S,d) -> (output, x's last token (B,d)); ``seq`` as the time
        mix's."""
        if seq is not None:
            x = gather_from(x, 1, seq)
        d, f = self.wr.shape[0], self.cfg_d_ff
        ax = tp_axis(policy)
        axf = ax if split_local(f, ax) else None
        axd = ax if split_local(d, ax) else None
        sx = _token_shift(x, x_prev)
        xk = x + sx * self.mu_k
        xr = x + sx * self.mu_r
        h = torch.square(F.relu(copy_to(xk, axf) @ param_local(self.wk, 1, f, axf)))
        kv = reduce_out(h @ param_local(self.wv, 0, f, axf), axf, seq)
        r = torch.sigmoid(copy_to(xr, axd) @ param_local(self.wr, 1, d, axd))
        r = gather_from(r, -1, axd)
        if seq is not None:
            r = scatter_to(r, 1, seq)
        return r * kv, x[:, -1]
