"""The model module of ``mellum2-12b-a2.5b`` (``cardbench/lib/model.py``):
Mellum2-12B-A2.5B's decoder, plain ``torch`` in fp32.

Each layer is pre-norm (RMSNorm), grouped-query attention and a top-k
mixture of SwiGLU experts with renormalized gates, as ``models/decoder.py``;
the layers differ only in their attention. Layer kinds cycle through the
configuration's ``layer_pattern``:

- ``local`` (the published ``sliding_attention``): a query at position p
  attends keys k with p - k < ``local_window``, and rope is plain at
  ``rope_theta``;
- ``attention`` (``full_attention``): every earlier key, and YaRN rope at
  the same base: the inverse frequencies of Hugging Face's
  ``_compute_yarn_parameters`` (truncated correction bounds, a linear ramp
  between the interpolated and extrapolated frequencies), cos and sin
  times ``yarn_attention_factor``.

The weights are ``weights.layout``'s (the same names and shapes; there is
no qk-norm). Capacity drops couple the tokens routed together, so ``walk``
replays the served schedule as ``decoder.py`` does for a MoE model. It
keeps each request's keys and values only from its first to its last step,
in a buffer of its own, so that the replay of a long-context cell fits
beside the weights.
"""
from __future__ import annotations

import gc
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from cardbench.lib import counts, reference, weights
from cardbench.lib.counts import head_flops
from cardbench.lib.weights import layout

__all__ = ["layout", "walk", "span_flops", "token_flops", "head_flops",
           "paged_bytes"]


def kinds(cfg: dict) -> List[str]:
    pat = list(cfg["layer_pattern"])
    return [pat[i % len(pat)] for i in range(cfg["num_layers"])]


# ------------------------------------------------------------------ counts
def _keys(a: int, b: int, window: int) -> float:
    """Sum over v = a .. b of min(v, window) (window 0: of v): the keys
    the queries of positions a - 1 .. b - 1 attend."""
    if b < a:
        return 0.0
    if not window:
        return (a + b) * (b - a + 1) / 2.0
    hi = min(b, window)
    below = (a + hi) * (hi - a + 1) / 2.0 if hi >= a else 0.0
    return below + window * max(0, b - max(a - 1, window))


def _attn_keys(cfg: dict, a: int, b: int) -> float:
    """Keys attended over every layer by the queries of positions a - 1 ..
    b - 1."""
    return sum(_keys(a, b, cfg["local_window"] if k == "local" else 0)
               for k in kinds(cfg))


def token_flops(cfg: dict, position: int) -> float:
    """FLOPs of one token at 0-based ``position`` through every layer
    (without the output head): a window layer attends min(position + 1, W)
    keys."""
    L = cfg["num_layers"]
    return (2.0 * L * counts.layer_matmul_params(cfg)
            + 4.0 * _attn_keys(cfg, position + 1, position + 1)
            * cfg["num_heads"] * cfg["head_dim"])


def span_flops(cfg: dict, start: int, end: int) -> float:
    """FLOPs of the tokens at positions [start, end) of one sequence
    (without the head): the sum of ``token_flops`` in closed form."""
    n = end - start
    if n <= 0:
        return 0.0
    return (2.0 * cfg["num_layers"] * counts.layer_matmul_params(cfg) * n
            + 4.0 * _attn_keys(cfg, start + 1, end)
            * cfg["num_heads"] * cfg["head_dim"])


def paged_bytes(cfg: dict, decode_len) -> float:
    """Bytes of one decode pass's paged-attention calls: a window layer
    reads at most ``local_window`` keys of each sequence."""
    lens, W = list(decode_len), cfg["local_window"]
    ks = kinds(cfg)
    n_local = ks.count("local")
    return ((len(ks) - n_local) * counts.paged_attention_bytes(cfg, lens)
            + n_local * counts.paged_attention_bytes(
                cfg, [min(n, W) for n in lens]))


# --------------------------------------------------------------- reference
def yarn_inv_freq(cfg: dict) -> torch.Tensor:
    """YaRN's inverse frequencies (head_dim // 2,), fp32, on the host, as
    Hugging Face computes them (``truncate`` true)."""
    D, base = cfg["head_dim"], float(cfg["rope_theta"])
    factor, orig = float(cfg["yarn_factor"]), cfg["yarn_original_max_len"]

    def dim(rotations):
        return (D * math.log(orig / (rotations * 2 * math.pi))
                / (2 * math.log(base)))

    low = max(math.floor(dim(cfg["yarn_beta_fast"])), 0)
    high = min(math.ceil(dim(cfg["yarn_beta_slow"])), D - 1)
    pos_freqs = base ** (torch.arange(0, D, 2, dtype=torch.float32) / D)
    if high == low:
        high += 0.001
    ramp = torch.clamp((torch.arange(D // 2, dtype=torch.float32) - low)
                       / (high - low), 0, 1)
    extra = 1 - ramp  # the share of the extrapolated frequency
    return (1.0 / (factor * pos_freqs)) * (1 - extra) + (1.0 / pos_freqs) * extra


class Mellum(reference.Reference):
    """``reference.Reference`` with window layers and the two rope kinds."""

    def __init__(self, cfg: dict, W: Dict[str, torch.Tensor],
                 capacity_factor: float = 1.25):
        super().__init__(cfg, W, capacity_factor)
        self.kinds = kinds(cfg)
        self.window = cfg["local_window"]
        self.inv = yarn_inv_freq(cfg).to(self.device)
        self.af = float(cfg["yarn_attention_factor"])

    def _angles_of(self, pos) -> dict:
        """(cos, sin) of positions ``pos`` for each layer kind."""
        ang = pos.float()[:, None] * self.inv[None, :]
        return {"local": self._angles(pos),
                "attention": (torch.cos(ang)[:, None, :] * self.af,
                              torch.sin(ang)[:, None, :] * self.af)}

    def _attend(self, q, K, V, qpos, kpos, window: int):
        """q (T, H, D) at positions qpos over K, V (S, Hkv, D) at kpos:
        keys at or before each query and, with a window, less than
        ``window`` before it."""
        T = q.shape[0]
        qg = q.view(T, self.Hkv, self.P, self.D)
        lg = torch.einsum("tgpd,sgd->gpts", qg, K) / math.sqrt(self.D)
        gap = qpos[:, None] - kpos[None, :]
        hide = gap < 0
        if window:
            hide |= gap >= window
        pr = torch.softmax(lg.masked_fill(hide, float("-inf")), dim=-1)
        return torch.einsum("gpts,sgd->tgpd", pr, V).reshape(T, self.H, self.D)

    def _window(self, kind: str) -> int:
        return self.window if kind == "local" else 0

    def _prefill(self, rid, a, b, prompt, kv):
        """Prompt positions [a, b) of rid: its k and v into ``kv[rid]``;
        the residuals out."""
        dev = self.device
        ids = torch.as_tensor(list(prompt[a:b]), dtype=torch.long, device=dev)
        pos = torch.arange(a, b, device=dev)
        cs = self._angles_of(pos)
        x = self.W["embed.w"][ids]
        for i, kind in enumerate(self.kinds):
            p, W = f"layers.{i}.", self._window(kind)
            q, k, v = self._qkv(p, reference.rmsnorm(
                x, self.W[p + "norm1.scale"]), cs[kind])
            K, V = kv[rid][0, i], kv[rid][1, i]
            K[a:b], V[a:b] = k, v
            lo = max(0, a - W + 1) if W else 0
            o = self._attend(q, K[lo:b], V[lo:b], pos,
                             torch.arange(lo, b, device=dev), W)
            x = x + self._out(p, o)
            x = x + self._ffn(p, reference.rmsnorm(x, self.W[p + "norm2.scale"]))
        return x

    def _decode_kv(self, batch, toks, poss, kv):
        """One token a sequence of ``batch`` at ``poss``: each attends its
        kind's keys (a segmented softmax over their concatenation)."""
        dev, B = self.device, len(batch)
        ids = torch.as_tensor(toks, dtype=torch.long, device=dev)
        cs = self._angles_of(torch.as_tensor(poss, device=dev))
        los, segs = {}, {}
        for kind in set(self.kinds):
            W = self._window(kind)
            lo = [max(0, p - W + 1) if W else 0 for p in poss]
            los[kind] = lo
            segs[kind] = torch.as_tensor(np.repeat(
                np.arange(B), np.asarray(poss) + 1 - np.asarray(lo)), device=dev)
        x = self.W["embed.w"][ids]
        scale = 1.0 / math.sqrt(self.D)
        for i, kind in enumerate(self.kinds):
            p = f"layers.{i}."
            q, k, v = self._qkv(p, reference.rmsnorm(
                x, self.W[p + "norm1.scale"]), cs[kind])
            for n, (r, at) in enumerate(zip(batch, poss)):
                kv[r][0, i, at] = k[n]
                kv[r][1, i, at] = v[n]
            spans = list(zip(batch, los[kind], poss))
            Kg = torch.cat([kv[r][0, i, lo:at + 1] for r, lo, at in spans])
            Vg = torch.cat([kv[r][1, i, lo:at + 1] for r, lo, at in spans])
            seg = segs[kind]
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
            x = x + self._ffn(p, reference.rmsnorm(x, self.W[p + "norm2.scale"]))
        return x

    @torch.no_grad()
    def replay(self, steps: List[dict],
               seqs: Dict[int, Tuple[Sequence[int], Sequence[int]]],
               judged: Sequence[int], last_step: int):
        """As ``Reference.replay``: (rid, j, final norm output, logits) for
        each served token j of a ``judged`` request, from the served
        schedule's steps 0 .. ``last_step``."""
        judged = set(judged)
        steps = steps[:last_step + 1]
        end = {}  # rid -> the last step it appears in
        for n, s in enumerate(steps):
            for r in [c[0] for c in s["chunks"]] + list(s["decode"]):
                end[r] = n
        kv: Dict[int, torch.Tensor] = {}
        produced: Dict[int, int] = {}
        for n, s in enumerate(steps):
            for rid, a, b in s["chunks"]:
                prompt, served = seqs[rid]
                if rid not in kv:
                    kv[rid] = torch.empty(
                        (2, self.L, len(prompt) + len(served), self.Hkv,
                         self.D), device=self.device)
                x = self._prefill(rid, a, b, prompt, kv)
                if b == len(prompt):
                    if rid in judged:
                        h, lg = self.final(x[-1:])
                        yield rid, 0, h[0], lg[0]
                    produced[rid] = 1
            if s["decode"]:
                batch = list(s["decode"])
                toks = [seqs[r][1][produced[r] - 1] for r in batch]
                poss = [len(seqs[r][0]) + produced[r] - 1 for r in batch]
                x = self._decode_kv(batch, toks, poss, kv)
                want = [i for i, r in enumerate(batch) if r in judged]
                if want:
                    h, lg = self.final(x[want])
                    for row, i in enumerate(want):
                        yield batch[i], produced[batch[i]], h[row], lg[row]
                for r in batch:
                    produced[r] += 1
            for r in [r for r, e in end.items() if e == n]:
                kv.pop(r, None)


def release_traced_program(sess) -> None:
    """Let go of the program before the reference's weights are made. In a
    traced run the tracer (the owner of ``sess.on_step``) still holds the
    program's model while the check runs, and the reference's 45.3 GiB of
    fp32 weights do not fit beside the program's on one 80 GB card. The
    run's metrics are read before the check, so nothing reads the program
    any more; an untraced run has no tracer and nothing changes."""
    tracer = getattr(getattr(sess, "on_step", None), "__self__", None)
    if tracer is None or getattr(tracer, "model", None) is None:
        return
    tracer.model = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def walk(cfg_file, sess, served, judged, seed, device, visit) -> None:
    """The replay of the served schedule up to the last step that served a
    judged request, ``visit(rid, j, final norm output, logits)`` for each
    judged token."""
    cfg = cfg_file["arch"]
    release_traced_program(sess)
    ref = Mellum(cfg, weights.make(cfg, seed, device), cfg_file.get(
        "policy", {}).get("moe_capacity_factor", 1.25))
    seqs = {q.rid: (q.prompt, served[q.rid]) for q in sess.reqs.values()}
    need = set(judged)
    last = max(i for i, s in enumerate(sess.steps)
               if need & ({c[0] for c in s.chunks} | set(s.decode)))
    for rid, j, h, lg in ref.replay(
            [{"chunks": s.chunks, "decode": s.decode} for s in sess.steps],
            seqs, judged, last):
        visit(rid, j, h, lg)
    del ref
