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

A pool may hold a subset of the model's layers (``layers``). A pool of
sliding-window layers (``window`` W > 0) keeps its own pages, page table and
``um.array`` ("kv_window"): a sequence's query at position p reads keys
p - W + 1 .. p only, so :meth:`trim` returns to the free stack every page
that lies wholly before the window of the sequence's next query, and a
sequence holds at most :func:`window_pages` pages (W - 1 earlier keys and
the tokens in flight). Its page table stays full width, zero (the null page)
before the window; allocation, the count of missing pages, ``swap_out``
and ``swap_in`` start at the first live page. With ``window`` 0 every
method does what it did before windows.
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


def window_pages(window: int, inflight: int, page_size: int) -> int:
    """Most pages a sequence of a window pool holds at once with
    ``inflight`` new tokens (a prefill chunk, or 1 in decode): the
    ``window`` - 1 keys before them and the new ones, over page bounds."""
    return (window + inflight + page_size - 3) // page_size + 1


class PagedKVCache:
    @staticmethod
    def page_bytes_for(cfg, layout: HeadLayout, page_size: int,
                       dtype: torch.dtype = torch.float32,
                       num_layers: Optional[int] = None) -> int:
        """Bytes of one pool page (k+v, all layers or ``num_layers``),
        without building the pools, e.g. to size a modeled device
        capacity."""
        L = cfg.num_layers if num_layers is None else num_layers
        return (2 * L * page_size * layout.n_kv_eff
                * cfg.head_dim * dtype.itemsize)

    def __init__(self, cfg, layout: HeadLayout, *, max_seqs: int, max_len: int,
                 page_size: int = 64, num_pages: Optional[int] = None,
                 dtype: torch.dtype = torch.float32, device=None,
                 um: Optional[UnifiedMemory] = None,
                 counter_threshold: int = 16,
                 mem_policy: "MemPolicy | str | None" = None,
                 seq_node=None, layers: Optional[List[int]] = None,
                 window: int = 0):
        """``layers``: the model layers this pool holds (default all; the
        pool's own layer index j is the position in this list); ``window``:
        the keys a query of these layers attends (0: every key)."""
        self.cfg = cfg
        self.layout = layout
        self.layers = (list(range(cfg.num_layers)) if layers is None
                       else list(layers))
        self.window = window
        # its um.array, and the label of the launches that charge it
        name, self._label = (("kv_window", "kv_window_seq") if window
                             else ("kv_pool", "kv_seq"))
        # sid -> issuing superchip for node-aware pools (None: ambient node)
        self.seq_node = seq_node
        self.page_size = page_size
        self.max_seqs = max_seqs
        self.pages_per_seq = -(-max_len // page_size)
        self.num_pages = num_pages or (max_seqs * self.pages_per_seq + 1)
        self.device = torch.device(device or "cpu")
        shape = (self.num_pages, page_size, layout.n_kv_eff, cfg.head_dim)
        self.k_pools = [torch.zeros(shape, dtype=dtype, device=self.device)
                        for _ in self.layers]
        self.v_pools = [torch.zeros(shape, dtype=dtype, device=self.device)
                        for _ in self.layers]
        self.page_table = np.zeros((max_seqs, self.pages_per_seq), np.int32)
        self.lengths = np.zeros((max_seqs,), np.int32)
        self.active = np.zeros((max_seqs,), bool)
        self._free: List[int] = list(range(self.num_pages - 1, 0, -1))  # 0 = null

        self.um = um
        self.page_bytes = self.page_bytes_for(cfg, layout, page_size, dtype,
                                              len(self.layers))
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
            self.buf = um.array(name, (self.num_pages, self.page_bytes),
                                np.uint8, mem_policy)
            self.alloc = self.buf.alloc

    # ------------------------------------------------------------- slots
    def free_slots(self) -> int:
        return int(np.count_nonzero(~self.active))

    def free_pages(self) -> int:
        return len(self._free)

    def pages_for(self, ntok: int) -> int:
        return -(-ntok // self.page_size)

    def new_seq(self, sid: Optional[int] = None) -> int:
        """The lowest free slot, or ``sid`` (a second pool follows the
        first's slots)."""
        if sid is None:
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

    # ------------------------------------------------------------ window
    def cap_pages(self, pages: int, inflight: int = 1) -> int:
        """``pages`` of a sequence's whole extent, as this pool holds them
        with ``inflight`` new tokens at once."""
        if not self.window:
            return pages
        return min(pages, window_pages(self.window, inflight, self.page_size))

    def live_from(self, sid: int) -> int:
        """First position of sequence sid that its next query (at position
        ``lengths[sid]``) attends: 0 without a window."""
        if not self.window:
            return 0
        return max(0, int(self.lengths[sid]) - self.window + 1)

    def trim(self) -> int:
        """Return every page wholly before its sequence's window (positions
        below ``live_from``) to the free stack; the pages released."""
        if not self.window:
            return 0
        live = np.maximum(0, self.lengths.astype(np.int64) - self.window + 1)
        dead = (np.arange(self.pages_per_seq)[None, :]
                < (live // self.page_size)[:, None]) & (self.page_table != 0)
        pids = self.page_table[dead]
        if len(pids):
            self._free.extend(pids.tolist())
            self.page_table[dead] = 0
        return len(pids)

    def usage(self):
        """(pages held, pages every key would take, most pages one sequence
        holds): over the active sequences, the last as the allocated extent
        from position 0."""
        rows = self.page_table[self.active]
        held = np.count_nonzero(rows, axis=1)
        if not len(held):
            return 0, 0, 0
        live = rows != 0
        extent = np.where(live.any(1), self.pages_per_seq
                          - np.argmax(live[:, ::-1], axis=1), 0)
        return int(held.sum()), int(extent.sum()), int(held.max())

    # ------------------------------------------------------- page accounting
    def alloc_range(self, sid: int, start: int, end: int) -> None:
        """Ensure pages backing positions [start, end) are allocated (from
        the first live page on, in a window pool). All holes fill from the
        free stack at once, in the order sequential pop() calls would use
        (so pool page ids are unchanged)."""
        j0 = max(start, self.live_from(sid)) // self.page_size
        j1 = -(-end // self.page_size)
        row = self.page_table[sid, j0:j1]
        holes = np.flatnonzero(row == 0)
        if len(holes):
            if len(self._free) < len(holes):
                raise RuntimeError("page pool exhausted")
            row[holes] = self._free[:-len(holes) - 1:-1]
            del self._free[-len(holes):]

    def missing_pages(self, sid: int, end: int) -> int:
        """Pages still unallocated among those backing positions [0, end)
        (from the first live page, in a window pool)."""
        j0 = self.live_from(sid) // self.page_size
        j1 = min(self.pages_per_seq, -(-end // self.page_size))
        return int(np.count_nonzero(self.page_table[sid, j0:j1] == 0))

    def allocated_until(self, sid: int) -> int:
        """First position, from the first live one, not covered by an
        already-allocated page."""
        j0 = self.live_from(sid) // self.page_size
        holes = np.flatnonzero(self.page_table[sid, j0:] == 0)
        j = j0 + int(holes[0]) if len(holes) else self.pages_per_seq
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
        """Write S tokens' KV at positions [start, start+S) of sequence sid
        into the pool's layer ``layer`` (its index in ``layers``).

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
                    batch.launch(f"{self._label}{s}", reads=views,
                                 actor=Actor.GPU,
                                 node=self._node_of(s))
            sp.tag = len(batch)
            if len(batch):
                self.um.launch_batch(batch)

    # ------------------------------------------------------------- reads
    def gather_kv(self, sid: int, layer: int, length: int, start: int = 0):
        """Positions [start, length) of sequence sid -> (length - start, N,
        D) pair."""
        idx = self._flat_idx(sid, start, length - start)
        return self.k_pools[layer][idx], self.v_pools[layer][idx]

    # ------------------------------------------------------------- swap
    def swap_out(self, sid: int) -> Dict[str, object]:
        """Demote a sequence host-side: copy its KV (a window pool: the keys
        its next query attends) out of the pool as numpy arrays and release
        every pool page. Returns the state for swap_in."""
        L, start = int(self.lengths[sid]), self.live_from(sid)
        pairs = [self.gather_kv(sid, j, L, start)
                 for j in range(len(self.layers))]
        self.release(sid)
        out = {"len": L, "k": [k.cpu().numpy() for k, _ in pairs],
               "v": [v.cpu().numpy() for _, v in pairs]}
        if start:
            out["start"] = start
        return out

    def swap_in(self, saved: Dict[str, object], sid: Optional[int] = None
                ) -> int:
        """Re-admit a swapped-out sequence (at slot ``sid``, or the lowest
        free one): allocate fresh pages and write the saved KV back into the
        pool. Returns the new sid."""
        sid = self.new_seq(sid)
        L, start = int(saved["len"]), int(saved.get("start", 0))
        self.lengths[sid] = L
        self.alloc_range(sid, start, L)
        for j in range(len(self.layers)):
            self.write_at(sid, j,
                          torch.from_numpy(saved["k"][j]).to(self.device),
                          torch.from_numpy(saved["v"][j]).to(self.device),
                          start)
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
                self.um.launch(f"{self._label}{sid}", reads=views,
                               actor=Actor.GPU, node=self._node_of(sid))
