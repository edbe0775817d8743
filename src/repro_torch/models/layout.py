"""Exact TP head layout: KV-head replication + Q-head zero-padding (a copy of
``repro.models.layout`` whose tensor methods take torch tensors).

Tensor parallelism over a model axis of size ``tp`` requires head counts
divisible by ``tp``. Real archs rarely satisfy this (qwen2.5: 40q/8kv, tp=16),
so the effective layout is built exactly:

  rep   = smallest r >= 1 with (n_kv * r) % tp == 0     (KV replication)
  p     = ceil(g / rep), g = n_q / n_kv                 (Q heads per eff KV head)
  n_kv_eff = n_kv * rep ;  n_q_eff = n_kv_eff * p       (both divisible by tp)

KV replication is the GQA repeat-kv identity transform. Q padding is exact
because padded heads have zero W_o columns. MHA (g == 1) pads (q, kv) pairs
instead. With tp=1 the layout is the identity.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class HeadLayout:
    n_q: int
    n_kv: int
    tp: int
    rep: int
    p: int
    pad: int = 0  # MHA: extra padded (q,kv) pairs instead of replication

    @staticmethod
    def make(n_q: int, n_kv: int, tp: int) -> "HeadLayout":
        if n_q % n_kv != 0:
            raise ValueError(f"n_q={n_q} is not a multiple of n_kv={n_kv}")
        g = n_q // n_kv
        if g == 1:
            # MHA: pad (q,kv) pairs to a multiple of tp; fake q heads attend
            # only fake kv heads and have zero W_o rows
            n_eff = math.ceil(n_q / tp) * tp
            return HeadLayout(n_q=n_q, n_kv=n_kv, tp=tp, rep=1, p=1,
                              pad=n_eff - n_q)
        rep = 1
        while (n_kv * rep) % tp != 0:
            rep += 1
        p = math.ceil(g / rep)
        return HeadLayout(n_q=n_q, n_kv=n_kv, tp=tp, rep=rep, p=p)

    @property
    def g(self) -> int:
        return self.n_q // self.n_kv

    @property
    def n_kv_eff(self) -> int:
        return self.n_kv * self.rep + self.pad

    @property
    def n_q_eff(self) -> int:
        return self.n_kv_eff * self.p

    @property
    def identity(self) -> bool:
        return self.n_q_eff == self.n_q and self.n_kv_eff == self.n_kv

    # -- index maps ---------------------------------------------------------
    def q_src(self) -> np.ndarray:
        """eff q index -> original q index, or -1 for structural padding."""
        out = np.full(self.n_q_eff, -1, dtype=np.int64)
        if self.pad:
            out[: self.n_q] = np.arange(self.n_q)
            return out
        for j in range(self.n_kv):
            for c in range(self.rep):
                for s in range(self.p):
                    l = c * self.p + s  # local q index within the kv group
                    if l < self.g:
                        out[(j * self.rep + c) * self.p + s] = j * self.g + l
        return out

    def kv_src(self) -> np.ndarray:
        """eff kv index -> original kv index (replicas share a source; MHA
        pads borrow head 0, which no real q head reads)."""
        if self.pad:
            src = np.concatenate([np.arange(self.n_kv), np.zeros(self.pad)])
            return src.astype(np.int64)
        return np.repeat(np.arange(self.n_kv, dtype=np.int64), self.rep)

    def q_pad_mask(self) -> np.ndarray:
        """bool (n_q_eff,): True where the eff q head is structural padding."""
        return self.q_src() < 0

    def kv_pad_mask(self) -> np.ndarray:
        """bool (n_kv_eff,): True for padded MHA kv heads (grads masked)."""
        out = np.zeros(self.n_kv_eff, bool)
        if self.pad:
            out[self.n_kv:] = True
        return out

    # -- weight expansion -----------------------------------------------------
    def expand_q(self, w: torch.Tensor, head_axis: int) -> torch.Tensor:
        """Expand an (..., n_q, ...) tensor to eff layout, zero-filling pads."""
        src = self.q_src()
        idx = torch.as_tensor(np.where(src < 0, 0, src), device=w.device)
        taken = torch.index_select(w, head_axis, idx)
        mask_shape = [1] * w.dim()
        mask_shape[head_axis] = self.n_q_eff
        mask = torch.as_tensor((src >= 0).reshape(mask_shape), dtype=w.dtype,
                               device=w.device)
        return taken * mask

    def expand_kv(self, w: torch.Tensor, head_axis: int) -> torch.Tensor:
        """Expand an (..., n_kv, ...) tensor to eff layout (replication)."""
        idx = torch.as_tensor(self.kv_src(), device=w.device)
        return torch.index_select(w, head_axis, idx)

    def reduce_kv_grad(self, g: torch.Tensor, head_axis: int) -> torch.Tensor:
        """Sum replica grads and broadcast back (keeps replicas identical)."""
        shp = list(g.shape)
        new = shp[:head_axis] + [self.n_kv, self.rep] + shp[head_axis + 1:]
        gr = g.reshape(new)
        s = gr.sum(dim=head_axis + 1, keepdim=True)
        return s.expand(new).reshape(shp)
