"""Paged KV cache: a software page table for serving, under the
unified-memory runtime (the port of ``repro.serve.paged``).

The k and v pools are preallocated tensors (num_pages, page_size, Hkv_eff,
D), one pair per layer, on the engine's device; page 0 is the null page.
Writes are in place (``index_put_``). The page table, the lengths and the
free stack stay numpy, so page ids, and the charges they drive, come out
exactly as in the JAX package. The pool is also one allocation of the
unified-memory runtime, ``um.array("kv_pool", (num_pages, page_bytes),
np.uint8)``: page residency (HBM vs host), access counters and migrations
follow the paper's system policy by default (``mem_policy`` swaps in any
registered paged backend). The pool may be larger than the modeled device
capacity (``num_pages``): first touch then maps the overflow host-side and
decode reads it remotely, the paper's graceful oversubscription (§7).
Preempted sequences leave the pool through ``swap_out`` (host numpy copies)
and come back through ``swap_in``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import (Actor, BufferView, KernelBatch, MemPolicy,
                              UnifiedMemory, coalesce_runs, make_policy,
                              system_policy)
from repro_torch.models.layout import HeadLayout
from repro_torch.spans import SPANS


class PagedKVCache:
    @staticmethod
    def page_bytes_for(cfg, layout: HeadLayout, page_size: int,
                       dtype: torch.dtype = torch.float32) -> int:
        """Bytes of one pool page (k+v, all layers), without building the
        pools, e.g. to size a modeled device capacity."""
        return (2 * cfg.num_layers * page_size * layout.n_kv_eff
                * cfg.head_dim * dtype.itemsize)

    def __init__(self, cfg, layout: HeadLayout, *, max_seqs: int, max_len: int,
                 page_size: int = 64, num_pages: Optional[int] = None,
                 dtype: torch.dtype = torch.float32, device=None,
                 um: Optional[UnifiedMemory] = None,
                 counter_threshold: int = 16,
                 mem_policy: "MemPolicy | str | None" = None,
                 seq_node=None):
        self.cfg = cfg
        self.layout = layout
        # sid -> issuing superchip for node-aware pools (None: ambient node)
        self.seq_node = seq_node
        self.page_size = page_size
        self.max_seqs = max_seqs
        self.pages_per_seq = -(-max_len // page_size)
        self.num_pages = num_pages or (max_seqs * self.pages_per_seq + 1)
        self.device = torch.device(device or "cpu")
        shape = (self.num_pages, page_size, layout.n_kv_eff, cfg.head_dim)
        self.k_pools = [torch.zeros(shape, dtype=dtype, device=self.device)
                        for _ in range(cfg.num_layers)]
        self.v_pools = [torch.zeros(shape, dtype=dtype, device=self.device)
                        for _ in range(cfg.num_layers)]
        self.page_table = np.zeros((max_seqs, self.pages_per_seq), np.int32)
        self.lengths = np.zeros((max_seqs,), np.int32)
        self.active = np.zeros((max_seqs,), bool)
        self._free: List[int] = list(range(self.num_pages - 1, 0, -1))  # 0 = null

        self.um = um
        self.page_bytes = self.page_bytes_for(cfg, layout, page_size, dtype)
        if um is not None:
            # one umem page per pool page; a low counter threshold keeps the
            # access-counter path responsive to these large pages. A
            # MemPolicy instance is used as it is (its page_size must equal
            # page_bytes); a registry name is built at pool-page granularity
            if mem_policy is None:
                mem_policy = system_policy(page_size=self.page_bytes,
                                           threshold=counter_threshold)
            elif isinstance(mem_policy, str):
                mem_policy = make_policy(mem_policy, page_size=self.page_bytes,
                                         threshold=counter_threshold)
            if not mem_policy.paged:
                raise ValueError(
                    f"KV pool needs a paged backend; {mem_policy.kind!r} has "
                    "no page table")
            if mem_policy.page_size != self.page_bytes:
                raise ValueError(
                    f"pool policy must be paged at one umem page per KV pool "
                    f"page: {mem_policy.kind!r} has page_size="
                    f"{mem_policy.page_size}, pool pages are "
                    f"{self.page_bytes} B")
            self.buf = um.array("kv_pool", (self.num_pages, self.page_bytes),
                                np.uint8, mem_policy)
            self.alloc = self.buf.alloc

    # ------------------------------------------------------------- slots
    def free_slots(self) -> int:
        return int(np.count_nonzero(~self.active))

    def free_pages(self) -> int:
        return len(self._free)

    def pages_for(self, ntok: int) -> int:
        return -(-ntok // self.page_size)

    def new_seq(self) -> int:
        sid = int(np.nonzero(~self.active)[0][0])
        self.active[sid] = True
        self.lengths[sid] = 0
        self.page_table[sid] = 0
        return sid

    def release(self, sid: int) -> None:
        row = self.page_table[sid]
        self._free.extend(int(p) for p in row[row != 0])
        self.active[sid] = False
        self.page_table[sid] = 0
        self.lengths[sid] = 0

    # ------------------------------------------------------- page accounting
    def alloc_range(self, sid: int, start: int, end: int) -> None:
        """Ensure pages backing positions [start, end) are allocated. All
        holes fill from the free stack at once, in the order sequential
        pop() calls would use (so pool page ids are unchanged)."""
        j0, j1 = start // self.page_size, -(-end // self.page_size)
        row = self.page_table[sid, j0:j1]
        holes = np.flatnonzero(row == 0)
        if len(holes):
            if len(self._free) < len(holes):
                raise RuntimeError("page pool exhausted")
            row[holes] = self._free[:-len(holes) - 1:-1]
            del self._free[-len(holes):]

    def missing_pages(self, sid: int, end: int) -> int:
        """Pages still unallocated among those backing positions [0, end)."""
        j1 = min(self.pages_per_seq, -(-end // self.page_size))
        return int(np.count_nonzero(self.page_table[sid, :j1] == 0))

    def allocated_until(self, sid: int) -> int:
        """First position not covered by an already-allocated page."""
        row = self.page_table[sid]
        holes = np.flatnonzero(row == 0)
        j = int(holes[0]) if len(holes) else self.pages_per_seq
        return j * self.page_size

    @staticmethod
    def _check_allocated(pids: np.ndarray) -> None:
        if not (pids != 0).all():
            raise RuntimeError("write into or read of an unallocated page")

    def _index(self, pids: np.ndarray, slots: np.ndarray):
        self._check_allocated(pids)
        return (torch.from_numpy(pids.astype(np.int64)).to(self.device),
                torch.from_numpy(slots.astype(np.int64)).to(self.device))

    def _flat_idx(self, sid: int, start: int, n: int):
        pos = start + np.arange(n)
        return self._index(self.page_table[sid, pos // self.page_size],
                           pos % self.page_size)

    # ------------------------------------------------------------- writes
    def write_at(self, sid: int, layer: int, k, v, start: int) -> None:
        """Write S tokens' KV at positions [start, start+S) of sequence sid.

        k, v: (S, N, D) tensors. One in-place scatter per pool covers
        exactly S slots (a partial tail page is never zero-padded)."""
        idx = self._flat_idx(sid, start, k.shape[0])
        self.k_pools[layer].index_put_(idx, k)
        self.v_pools[layer].index_put_(idx, v)

    def commit_prefill(self, sid: int, new_len: int) -> None:
        self.lengths[sid] = new_len
        self._touch(sid)

    def token_slots(self, sid_list, pos_list):
        """Host (page, slot) arrays of one new token per sequence, checked
        against writes into an unallocated page (once per decode batch)."""
        pos = np.asarray(pos_list)
        pids = self.page_table[np.asarray(sid_list), pos // self.page_size]
        self._check_allocated(pids)
        return pids, pos % self.page_size

    def write_token(self, index, layer: int, k, v) -> None:
        """k, v: (B, N, D) new-token KV at ``index``, a pair of (B,) int64
        device tensors (the pages and slots of :meth:`token_slots`)."""
        self.k_pools[layer].index_put_(index, k)
        self.v_pools[layer].index_put_(index, v)

    def commit_token(self, sid_list, pos_list) -> None:
        # lengths first, then one batched engine step over every decoded
        # sequence's pool pages: sids are unique within a decode batch, so
        # each kv_seq launch sees the views a touch per sequence would
        for s, p in zip(sid_list, pos_list):
            self.lengths[s] = p + 1
        if self.um is None:
            return
        with SPANS.span("um.charge") as sp:
            batch = KernelBatch()
            for s in sid_list:
                views = self.seq_views(s)
                if views:
                    batch.launch(f"kv_seq{s}", reads=views, actor=Actor.GPU,
                                 node=self._node_of(s))
            sp.tag = len(batch)
            if len(batch):
                self.um.launch_batch(batch)

    # ------------------------------------------------------------- reads
    def gather_kv(self, sid: int, layer: int, length: int):
        """Positions [0, length) of sequence sid -> (length, N, D) pair."""
        idx = self._flat_idx(sid, 0, length)
        return self.k_pools[layer][idx], self.v_pools[layer][idx]

    # ------------------------------------------------------------- swap
    def swap_out(self, sid: int) -> Dict[str, object]:
        """Demote a sequence host-side: copy its KV out of the pool as numpy
        arrays and release every pool page. Returns the state for swap_in."""
        L = int(self.lengths[sid])
        pairs = [self.gather_kv(sid, layer, L)
                 for layer in range(self.cfg.num_layers)]
        self.release(sid)
        return {"len": L, "k": [k.cpu().numpy() for k, _ in pairs],
                "v": [v.cpu().numpy() for _, v in pairs]}

    def swap_in(self, saved: Dict[str, object]) -> int:
        """Re-admit a swapped-out sequence: allocate fresh pages and write
        the saved KV back into the pool. Returns the new sid."""
        sid = self.new_seq()
        L = int(saved["len"])
        self.alloc_range(sid, 0, L)
        for layer in range(self.cfg.num_layers):
            self.write_at(sid, layer,
                          torch.from_numpy(saved["k"][layer]).to(self.device),
                          torch.from_numpy(saved["v"][layer]).to(self.device),
                          0)
        self.lengths[sid] = L
        return sid

    # ------------------------------------------------------------- umem
    def close(self) -> None:
        """Free the pool's UnifiedMemory allocation; residency returns to
        its pre-pool baseline."""
        if self.um is not None:
            self.um.free(self.alloc)

    def _seq_page_runs(self, sid: int) -> List[Tuple[int, int]]:
        """[lo, hi) pool-page runs of the sequence, consecutive pages
        coalesced."""
        npages = -(-int(self.lengths[sid]) // self.page_size)
        pids = np.sort(self.page_table[sid, :npages].astype(np.int64))
        return coalesce_runs(pids[pids != 0])

    def seq_views(self, sid: int) -> List[BufferView]:
        """The sequence's pool pages as buffer row bands, for um.demote /
        um.prefetch_async and the tracked launches."""
        return [self.buf.rows(s, e) for s, e in self._seq_page_runs(sid)]

    def seqs_touching_pages(self, runs) -> List[int]:
        """Active sequence ids whose pool pages intersect the given [lo, hi)
        pool-page runs (what ``um.fail_node`` reports lost)."""
        if not runs:
            return []
        dead = np.zeros(self.num_pages, bool)
        for s, e in runs:
            dead[int(s):int(e)] = True
        out = []
        for sid in np.flatnonzero(self.active):
            row = self.page_table[sid]
            pids = row[row != 0]
            if len(pids) and dead[pids].any():
                out.append(int(sid))
        return out

    def _node_of(self, sid: int):
        return None if self.seq_node is None else self.seq_node(sid)

    def _touch(self, sid: int) -> None:
        if self.um is None:
            return
        # every resident page of the sequence in ONE tracked launch
        with SPANS.span("um.charge") as sp:
            views = self.seq_views(sid)
            sp.tag = int(bool(views))
            if views:
                self.um.launch(f"kv_seq{sid}", reads=views, actor=Actor.GPU,
                               node=self._node_of(sid))
