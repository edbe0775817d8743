"""The plain reference of the served models, in PyTorch, fp32.

It follows the published equations of the two configurations (a
pre-norm decoder: RMSNorm, grouped-query attention with RoPE in the
rotate-half form, SwiGLU MLP or a token-choice top-k mixture of SwiGLU
experts), with these departures, each the port's and stated in the
configuration file: RMSNorm eps 1e-6 (published 1e-5); for olmoe-1b-7b a
qk-norm per head over head_dim (OLMoE normalizes over all heads), top-k
gates renormalized to sum 1 (OLMoE's ``norm_topk_prob`` is false) and
capacity-bounded dispatch with drops (OLMoE is dropless). It imports
nothing of the program, of JAX or of the JAX package: its weights are the
benchmark's own state dict (``weights.make``), made again from the seed,
and it reads the program's outputs (the served tokens, and which requests
were batched together in each step) only to judge them.

A dense model is run once over each sampled request's prompt and served
tokens (``Reference.sequence``). A MoE layer's capacity drops depend on
which tokens were routed together, so for a MoE model the reference
replays the served schedule (``Reference.replay``): every prefill chunk and
every decode batch, in the program's order and with its composition, its
own KV kept per request in flat per-layer buffers. Attention of a decode
batch is computed over the exact keys of each sequence (a segmented
softmax over their concatenation), of a prefill chunk over its prefix.

The caller sets ``torch.backends.cuda.matmul.allow_tf32`` (False for the
reference, True for the TF32 control).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-6
Q_BLOCK = 1024  # query rows per attention block of a long chunk


def rmsnorm(x, w):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + EPS) * w


def rope_angles(pos, half: int, theta: float):
    """(cos, sin), each (T, 1, half), of positions pos (T,) int."""
    inv = (1.0 / theta) ** (torch.arange(half, dtype=torch.float32,
                                         device=pos.device) / half)
    ang = pos.float()[:, None] * inv[None, :]
    return torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]


def rope(x, cs):
    """x (T, H, D) rotated by ``rope_angles`` (rotate-half form)."""
    cos, sin = cs
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def moe(cfg: dict, W: Dict[str, torch.Tensor], p: str, h, capacity_factor):
    """Token-choice top-k over the T rows of h routed together, with the
    capacity of ``max(4, ceil(T k / E * factor))`` (at most T) per expert:
    every token's first choice queues before any second choice, in token
    order, and a routing past its expert's capacity is dropped (sent to a
    spare row that nothing reads)."""
    T, d = h.shape
    E, k = cfg["num_experts"], cfg["top_k"]
    probs = torch.softmax(h @ W[p + "ffn.router"], dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1, sorted=True)
    gates = gates / gates.sum(-1, keepdim=True)
    cap = min(max(4, math.ceil(T * k / E * capacity_factor)), T)
    e_flat = idx.t().reshape(-1)                       # slot-major order
    t_flat = torch.arange(T, device=h.device).repeat(k)
    oh = F.one_hot(e_flat, E)
    pos = ((torch.cumsum(oh, 0) - oh) * oh).sum(-1)    # earlier same-expert
    keep = pos < cap
    slot = torch.where(keep, e_flat * cap + pos, E * cap)
    xe = torch.zeros(E * cap + 1, d, dtype=h.dtype, device=h.device)
    xe[slot] = h[t_flat]
    xe = xe[:-1].view(E, cap, d)
    g = torch.bmm(xe, W[p + "ffn.w_gate"])
    u = torch.bmm(xe, W[p + "ffn.w_up"])
    ye = torch.bmm(F.silu(g) * u, W[p + "ffn.w_down"]).view(E * cap, d)
    ye = torch.cat([ye, ye.new_zeros(1, d)])
    g_flat = torch.where(keep, gates.t().reshape(-1), 0.0)
    y = torch.zeros_like(h)
    y.index_add_(0, t_flat, g_flat[:, None] * ye[slot])
    return y


def mlp(W, p, h):
    return (F.silu(h @ W[p + "ffn.w_gate"]) * (h @ W[p + "ffn.w_up"])) \
        @ W[p + "ffn.w_down"]


class Reference:
    """The model over a state dict ``W`` (``weights.make``)."""

    def __init__(self, cfg: dict, W: Dict[str, torch.Tensor],
                 capacity_factor: float = 1.25):
        self.cfg, self.W = cfg, W
        self.cf = capacity_factor
        self.L = cfg["num_layers"]
        self.H, self.Hkv, self.D = (cfg["num_heads"], cfg["num_kv_heads"],
                                    cfg["head_dim"])
        self.P = self.H // self.Hkv
        self.theta = float(cfg["rope_theta"])
        self.device = W["embed.w"].device

    # ------------------------------------------------------------ pieces
    def _angles(self, pos):
        return rope_angles(pos, self.D // 2, self.theta)

    def _qkv(self, p, h, cs):
        W, cfg = self.W, self.cfg
        q = torch.einsum("td,dhe->the", h, W[p + "mixer.wq"])
        k = torch.einsum("td,dhe->the", h, W[p + "mixer.wk"])
        v = torch.einsum("td,dhe->the", h, W[p + "mixer.wv"])
        if cfg.get("qk_norm"):
            q = rmsnorm(q, W[p + "mixer.q_norm"])
            k = rmsnorm(k, W[p + "mixer.k_norm"])
        return rope(q, cs), rope(k, cs), v

    def _out(self, p, o):
        return torch.einsum("the,hed->td", o, self.W[p + "mixer.wo"])

    def _ffn(self, p, h):
        if self.cfg.get("num_experts", 0):
            return moe(self.cfg, self.W, p, h, self.cf)
        return mlp(self.W, p, h)

    def _causal(self, q, K, V, start: int):
        """q (T, H, D) at positions start..start+T-1 over K, V (S, Hkv, D)
        of positions 0..S-1 (S = start + T), in query blocks."""
        T, S = q.shape[0], K.shape[0]
        qg = q.view(T, self.Hkv, self.P, self.D)
        outs = []
        for lo in range(0, T, Q_BLOCK):
            hi = min(T, lo + Q_BLOCK)
            lg = torch.einsum("tgpd,sgd->gpts", qg[lo:hi], K) / math.sqrt(self.D)
            qpos = torch.arange(start + lo, start + hi, device=q.device)
            mask = torch.arange(S, device=q.device)[None, :] > qpos[:, None]
            lg = lg.masked_fill(mask, float("-inf"))
            pr = torch.softmax(lg, dim=-1)
            outs.append(torch.einsum("gpts,sgd->tgpd", pr, V))
        return torch.cat(outs).reshape(T, self.H, self.D)

    def final(self, x):
        """(the final norm's output, the logits) of residuals x."""
        h = rmsnorm(x, self.W["final_norm.scale"])
        return h, h @ self.W["head.w"]

    # ------------------------------------------------- one whole sequence
    @torch.no_grad()
    def sequence(self, tokens: Sequence[int], rows: slice):
        """(final norm output, logits) at ``rows`` of one causal pass over
        ``tokens``."""
        dev = self.device
        ids = torch.as_tensor(list(tokens), dtype=torch.long, device=dev)
        cs = self._angles(torch.arange(len(ids), device=dev))
        x = self.W["embed.w"][ids]
        for i in range(self.L):
            p = f"layers.{i}."
            q, k, v = self._qkv(p, rmsnorm(x, self.W[p + "norm1.scale"]), cs)
            x = x + self._out(p, self._causal(q, k, v, 0))
            x = x + self._ffn(p, rmsnorm(x, self.W[p + "norm2.scale"]))
        return self.final(x[rows])

    # ------------------------------------------------------------ replay
    @torch.no_grad()
    def replay(self, steps: List[dict], seqs: Dict[int, Tuple[Sequence[int],
                                                               Sequence[int]]],
               judged: Sequence[int], last_step: Optional[int] = None):
        """Replay the served schedule. ``steps`` are the program's steps in
        order, each {"chunks": [(rid, start, end), ...] in the order they
        ran, "decode": [rid, ...] in batch order}; ``seqs`` maps a rid to
        (prompt ids, served ids). Yields (rid, j, final norm output,
        logits) for each served token j of a ``judged`` request, from the
        prefix that gave it."""
        dev, judged = self.device, set(judged)
        last_step = len(steps) - 1 if last_step is None else last_step
        rids = sorted({r for s in steps[:last_step + 1]
                       for r in [c[0] for c in s["chunks"]] + list(s["decode"])})
        off, n = {}, 0
        for r in rids:
            off[r] = n
            n += len(seqs[r][0]) + len(seqs[r][1])
        shape = (n, self.Hkv, self.D)
        Kb = [torch.empty(shape, device=dev) for _ in range(self.L)]
        Vb = [torch.empty(shape, device=dev) for _ in range(self.L)]
        produced = {r: 0 for r in rids}
        for s in steps[:last_step + 1]:
            for rid, a, b in s["chunks"]:
                x = self._chunk(rid, a, b, seqs[rid][0], off[rid], Kb, Vb)
                if b == len(seqs[rid][0]):
                    if rid in judged:
                        h, lg = self.final(x[-1:])
                        yield rid, 0, h[0], lg[0]
                    produced[rid] = 1
            if s["decode"]:
                batch = list(s["decode"])
                toks, poss = [], []
                for r in batch:
                    j = produced[r]
                    toks.append(seqs[r][1][j - 1])
                    poss.append(len(seqs[r][0]) + j - 1)
                x = self._decode(batch, toks, poss, off, Kb, Vb)
                want = [i for i, r in enumerate(batch) if r in judged]
                if want:
                    h, lg = self.final(x[want])
                    for row, i in enumerate(want):
                        yield batch[i], produced[batch[i]], h[row], lg[row]
                for r in batch:
                    produced[r] += 1

    def _chunk(self, rid, a, b, prompt, base, Kb, Vb):
        dev = self.device
        ids = torch.as_tensor(list(prompt[a:b]), dtype=torch.long, device=dev)
        cs = self._angles(torch.arange(a, b, device=dev))
        x = self.W["embed.w"][ids]
        for i in range(self.L):
            p = f"layers.{i}."
            q, k, v = self._qkv(p, rmsnorm(x, self.W[p + "norm1.scale"]), cs)
            Kb[i][base + a:base + b] = k
            Vb[i][base + a:base + b] = v
            o = self._causal(q, Kb[i][base:base + b], Vb[i][base:base + b], a)
            x = x + self._out(p, o)
            x = x + self._ffn(p, rmsnorm(x, self.W[p + "norm2.scale"]))
        return x

    def _decode(self, batch, toks, poss, off, Kb, Vb):
        dev = self.device
        B = len(batch)
        lens = np.asarray(poss) + 1
        seg_h = np.repeat(np.arange(B), lens)
        within = np.arange(lens.sum()) - np.repeat(np.cumsum(lens) - lens, lens)
        base = np.asarray([off[r] for r in batch])
        ids, pos, seg, rows, write = (
            torch.as_tensor(a, dtype=torch.long).to(dev) for a in (
                toks, poss, seg_h, base[seg_h] + within, base + np.asarray(poss)))
        cs = self._angles(pos)
        x = self.W["embed.w"][ids]
        scale = 1.0 / math.sqrt(self.D)
        for i in range(self.L):
            p = f"layers.{i}."
            q, k, v = self._qkv(p, rmsnorm(x, self.W[p + "norm1.scale"]), cs)
            Kb[i][write] = k
            Vb[i][write] = v
            Kg, Vg = Kb[i][rows], Vb[i][rows]              # (N, Hkv, D)
            qg = q.view(B, self.Hkv, self.P, self.D)[seg]  # (N, Hkv, P, D)
            lg = (qg * Kg[:, :, None, :]).sum(-1) * scale  # (N, Hkv, P)
            mx = torch.full((B, self.Hkv, self.P), float("-inf"), device=dev)
            mx = mx.scatter_reduce(0, seg[:, None, None].expand_as(lg), lg,
                                   "amax")
            w = torch.exp(lg - mx[seg])
            den = torch.zeros_like(mx).index_add_(0, seg, w)
            o = torch.zeros(B, self.Hkv, self.P, self.D, device=dev)
            o.index_add_(0, seg, w[..., None] * Vg[:, :, None, :])
            o = (o / den[..., None]).reshape(B, self.H, self.D)
            x = x + self._out(p, o)
            x = x + self._ffn(p, rmsnorm(x, self.W[p + "norm2.scale"]))
        return x
