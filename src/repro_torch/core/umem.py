"""UnifiedMemory: the Grace Hopper unified-memory system as a composable runtime.

Models (and on real TPU backends, drives — see serve/paged.py and
optim/offload) a two-tier HBM/host memory system with:

  * lazy PTE creation + first-touch placement (system & managed),
  * direct remote access at fine granularity over the interconnect (system),
  * fault-driven on-demand migration + speculative prefetch (managed),
  * access-counter-based delayed migration with threshold notifications
    (system, §2.2.1), applied batch-wise at sync points,
  * LRU eviction under device-capacity pressure (managed) vs graceful remote
    access (system), reproducing the paper's oversubscription behavior (§7).

Applications interact through the typed buffer front-end — array() /
from_host() return UMBuffers whose numpy-style slices feed launch(),
staged(), prefetch() and demote() (see core/buffer.py and docs/memspace.md)
— while alloc/free, phase(), kernel() and copy() remain the raw runtime
surface the front-end lowers onto. Time is *modeled* via the HardwareModel
(this container has no GPU/TPU); correctness of the application math is
real JAX executed on CPU.

The hot path is *run-compressed*: kernel() resolves each byte range to a
(lo_page, hi_page) extent once, and every page-table operation under it —
first-touch mapping, LRU-epoch touches, fault/granule counting, speculative
prefetch expansion, access-counter bumps, LRU victim selection, sync-point
notification draining — works on run intersections of the extent with the
table's interval metadata (see core/pagetable.py and core/runs.py). Cost is
O(runs overlapping the extent), never O(pages in extent): a uniform 16M-page
working set is one run. Residency totals are cached (updated incrementally
on every map/move), so profiler sampling is O(1) per op. The charge math is
unchanged from the dense per-page implementation — modeled times and
traffic are bit-identical (enforced by scripts/check_parity.py).

Policy behavior is *pluggable*: the runtime never branches on a policy
name. Every policy-dependent decision — allocation shape, first-touch
placement, pre-access migration, access-charge classification, eviction
participation, sync-point draining, staging routing — dispatches to the
allocation's :class:`~repro_torch.core.policy.MemPolicy` hooks, so a new memory
system (see ``Mi300aUnifiedPolicy``) plugs in through
``repro_torch.core.registry`` without touching this file."""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.buffer import BufferView, UMBuffer, as_view
from repro_torch.core.hardware import GRACE_HOPPER, HardwareModel
from repro_torch.core.pagetable import Actor, BlockTable, Tier
from repro_torch.core.policy import (  # noqa: F401  (Allocation/OOM re-exported)
    Allocation,
    HostSpillError,
    MemPolicy,
    OutOfDeviceMemory,
    PolicyConfig,
)
from repro_torch.core.profiler import MemoryProfiler

Range = Tuple[Allocation, int, int]  # (alloc, lo, hi) byte range


def _as_range(r, actor: Actor) -> Range:
    """Launch/prefetch argument -> raw Range: BufferViews and UMBuffers
    resolve against the actor (CPU actors hit a staged buffer's host side);
    raw (alloc, lo, hi) tuples pass through untouched."""
    if isinstance(r, (BufferView, UMBuffer)):
        return as_view(r).resolve(actor)
    return r


def _operand_names(items: Sequence) -> List[str]:
    """Unique buffer/allocation names of launch operands, in operand order."""
    names = []
    for r in items:
        name = (as_view(r).buf.name if isinstance(r, (BufferView, UMBuffer))
                else r[0].name)
        if name not in names:
            names.append(name)
    return names


def _derived_label(reads: Sequence, writes: Sequence) -> str:
    """Default launch label derived from the operand buffer names, so the
    profiler's per-kernel report distinguishes unnamed kernels by what they
    touch instead of collapsing them all into one "kernel" bucket."""
    rd, wr = _operand_names(reads), _operand_names(writes)
    if rd and wr:
        return "+".join(rd) + "->" + "+".join(wr)
    return "+".join(rd or wr) or "kernel"


@dataclass(slots=True)
class KernelLaunch:
    """One deferred launch inside a :class:`KernelBatch` — the same
    arguments :meth:`UnifiedMemory.launch` takes, held until the batch is
    submitted. reads/writes accept BufferViews, UMBuffers or raw Ranges.
    ``node`` pins the issuing superchip for node-aware backends (None:
    the runtime's ambient node at submission)."""
    name: Optional[str] = None
    reads: Sequence = ()
    writes: Sequence = ()
    flops: float = 0.0
    actor: Actor = Actor.GPU
    node: Optional[int] = None


class KernelBatch:
    """Builder for :meth:`UnifiedMemory.launch_batch`: accumulate launches,
    submit once. ``batch.launch(...)`` mirrors ``um.launch(...)`` and
    returns the builder for chaining."""

    __slots__ = ("items",)

    def __init__(self, items: Optional[List[KernelLaunch]] = None):
        self.items: List[KernelLaunch] = list(items) if items else []

    def launch(self, name: Optional[str] = None, *, reads: Sequence = (),
               writes: Sequence = (), flops: float = 0.0,
               actor: Actor = Actor.GPU,
               node: Optional[int] = None) -> "KernelBatch":
        self.items.append(KernelLaunch(name, reads, writes, flops, actor,
                                       node))
        return self

    def __len__(self) -> int:
        return len(self.items)


class UnifiedMemory:
    def __init__(self, hw: HardwareModel = GRACE_HOPPER,
                 profiler: Optional[MemoryProfiler] = None,
                 staging_page_size: int = 64 * 1024):
        self.hw = hw
        self.prof = profiler or MemoryProfiler()
        self.clock = 0.0
        self.allocs: Dict[str, Allocation] = {}
        self.epoch = 0
        self._pending_overlap = 0.0  # async-prefetch seconds hidden under compute
        # page size of from_host() staging buffers under the explicit policy
        # (the host side of the cudaMalloc+malloc pair uses the *application's*
        # system page size, not a hard-wired default)
        self.staging_page_size = staging_page_size
        # cached residency over live allocations (kept in lockstep with every
        # BlockTable mutation; makes _sample O(1) per op)
        self._host_bytes = 0
        self._device_bytes = 0
        # ambient superchip for node-aware backends: first-touch placement
        # and charge classification happen "as seen from" this node. Plain
        # single-node runs never move it off 0.
        self._node = 0
        # optional TraceRecorder (core/trace.py): every public runtime op
        # appends one event when set; None costs a single identity check
        self._trace = None
        # fault-injection state (runtime/fault.py FaultPlan delivers through
        # fail_node / set_lane_degradation / set_spill_failure). All of it
        # defaults to "no fault" at zero per-op cost: the hot paths test a
        # None/emptiness once, exactly like _trace, so fault-free runs stay
        # bit-identical (the parity fixture pins this)
        self._dead_nodes: set = set()
        self._capacity_lost = 0  # device bytes gone with dead nodes
        self._lane_degrade: Optional[Tuple[float, float]] = None
        self._spill_fail = False

    # ------------------------------------------------------------------ util
    def _charge(self, seconds: float) -> None:
        self.clock += seconds
        self.prof.charge(seconds)

    def _sample(self) -> None:
        self.prof.sample(self.clock, self._host_bytes, self._device_bytes)

    def _apply_delta(self, delta: Tuple[int, int]) -> None:
        self._host_bytes += delta[0]
        self._device_bytes += delta[1]

    def host_bytes(self) -> int:
        return self._host_bytes

    def device_bytes(self) -> int:
        return self._device_bytes

    def device_free(self) -> int:
        return self.hw.device_capacity - self._capacity_lost \
            - self._device_bytes

    def _recompute_residency(self) -> Tuple[int, int]:
        """Slow-path recount (tests assert it matches the cached totals):
        re-derives each table's residency from its run structure."""
        host = dev = 0
        for a in self.allocs.values():
            if a.freed:
                continue
            dev += a.device_bytes_explicit
            if a.table is not None:
                _, nbytes = a.table.recount()
                # host slots sit at odd counter indices, device at even
                # (index = encoded location + 1); single-node tables reduce
                # to the classic HOST/DEVICE pair
                host += int(nbytes[1::2].sum())
                dev += int(nbytes[2::2].sum())
        return host, dev

    @contextlib.contextmanager
    def on_node(self, node: int):
        """Pin the ambient superchip: kernels, prefetches and first touches
        inside the block act as issued from ``node`` (node-aware backends
        place and charge accordingly; single-node backends ignore it)."""
        prev, self._node = self._node, int(node)
        try:
            yield self
        finally:
            self._node = prev

    # ---------------------------------------------------------------- faults
    def fail_node(self, node: int) -> Dict[str, List[Tuple[int, int]]]:
        """A superchip drops out of the pool: its device capacity is gone
        and every page resident on it — host or device side — is lost.
        Each live allocation's policy drains the dead location through the
        ``on_node_loss`` lifecycle hook (placement maps, residency counters
        and pending notifications all updated); the poisoned page runs are
        returned per allocation so consumers (the serve engine) can map
        them back to sequences and replay. Idempotent per node."""
        node = int(node)
        if node in self._dead_nodes:
            return {}
        self._dead_nodes.add(node)
        self._capacity_lost += int(
            getattr(self.hw, "node_device_capacity", 0)
            or self.hw.device_capacity)
        lost: Dict[str, List[Tuple[int, int]]] = {}
        pages = nbytes = 0
        for a in self.allocs.values():
            if a.freed:
                continue
            runs = a.policy.on_node_loss(self, a, node)
            if runs:
                lost[a.name] = runs
                pages += sum(e - s for s, e in runs)
                if a.table is not None:
                    nbytes += sum(e - s for s, e in runs) * a.table.page_size
        self.prof.extra["node_losses"] += 1
        self.prof.extra["lost_pages"] += pages
        self.prof.extra["lost_bytes"] += nbytes
        self._sample()
        return lost

    def set_lane_degradation(
            self, factors: Optional[Tuple[float, float]]) -> None:
        """Enter/leave a degraded-lane window: ``(nvlink_factor,
        fabric_factor)`` multiply the nominal inter-node bandwidths (<1 =
        slower) until cleared with ``None``. Node-aware charge paths read
        :attr:`lane_degradation`; ``None`` keeps them bit-identical to a
        fault-free run."""
        self._lane_degrade = (
            None if factors is None
            else (float(factors[0]), float(factors[1])))

    @property
    def lane_degradation(self) -> Optional[Tuple[float, float]]:
        return self._lane_degrade

    def set_spill_failure(self, flag: bool) -> None:
        """Enter/leave a host-spill failure window: while set, ``demote``
        of a migratable allocation raises :class:`HostSpillError` instead
        of spilling (the serve engine falls back to drop-and-recompute)."""
        self._spill_fail = bool(flag)

    def charge_transfer(self, nbytes: int, bw: float, *, latency: float = 0.0,
                        counter: Optional[str] = None) -> float:
        """Charge a modeled bulk transfer: ``nbytes`` at ``bw`` bytes/s plus
        a fixed ``latency``. Bytes are attributed to the open-ended
        ``prof.extra[counter]`` side counter (never TrafficCounters, whose
        field set the parity fixture pins). The cluster TP-serving layer
        charges per-token all-reduce traffic through this."""
        dt = nbytes / bw + latency
        self._charge(dt)
        if counter:
            self.prof.extra[counter] += int(nbytes)
        self._sample()
        return dt

    @contextlib.contextmanager
    def phase(self, name: str):
        prev = self.prof.phase
        self.prof.set_phase(name)
        if self._trace is not None:
            self._trace.on_phase(name)
        try:
            yield
        finally:
            self.prof.set_phase(prev)
            if self._trace is not None:
                self._trace.on_phase(prev)

    # ----------------------------------------------------------------- alloc
    def alloc(self, name: str, nbytes: int, policy: MemPolicy) -> Allocation:
        assert name not in self.allocs, f"duplicate alloc {name!r}"
        a = policy.on_alloc(self, name, nbytes)
        self.allocs[name] = a
        if self._trace is not None:
            self._trace.on_alloc(a)
        self._sample()
        return a

    def free(self, a: Allocation) -> None:
        assert not a.freed
        if self._trace is not None:
            self._trace.on_free(a.name)
        a.policy.on_free(self, a)
        a.freed = True
        self._sample()

    def free_live(self, *, keep_reserved: bool = True) -> None:
        """Free every live allocation in allocation order. Names starting
        with ``__`` (harness-reserved, e.g. the oversubscription ballast)
        are kept unless keep_reserved=False."""
        for a in list(self.allocs.values()):
            if a.freed:
                continue
            if keep_reserved and a.name.startswith("__"):
                continue
            self.free(a)

    # -------------------------------------------------------------- buffers
    def array(self, name: str, shape, dtype, policy: MemPolicy) -> UMBuffer:
        """Allocate a typed buffer: shape x dtype under `policy`.

        The buffer-centric analogue of alloc(): slices of the returned
        UMBuffer feed launch()/prefetch()/demote() instead of raw byte
        ranges. Device-only scratch and GPU-initialized data use this; data
        that originates host-side should use from_host()."""
        shape = (shape,) if isinstance(shape, (int, np.integer)) else tuple(shape)
        nbytes = int(np.prod(np.asarray(shape, np.int64))) * np.dtype(dtype).itemsize
        a = self.alloc(name, nbytes, policy)
        return UMBuffer(self, a, shape, dtype)

    def from_host(self, name: str, shape, dtype,
                  policy: MemPolicy) -> UMBuffer:
        """A buffer whose contents originate on the host (CPU init).

        Under policies whose memory is CPU-accessible (managed/system/
        mi300a_unified) this is exactly array(): first-touch placement
        follows the CPU writer. A policy with staged transfers (explicit)
        materializes the cudaMalloc + malloc pair via its ``make_staging``
        hook — a device buffer plus a ``<name>__host`` staging buffer (at
        ``staging_page_size``, the application's system page size) — and
        launch() routes CPU-actor accesses to the staging side through
        ``resolve_actor_side``. um.staged() charges the h2d/d2h copies at
        phase boundaries."""
        buf = self.array(name, shape, dtype, policy)
        buf.host = policy.make_staging(self, buf)
        return buf

    def launch(self, name: Optional[str] = None, *, reads: Sequence = (),
               writes: Sequence = (), flops: float = 0.0,
               actor: Actor = Actor.GPU, node: Optional[int] = None) -> float:
        """Buffer-level kernel launch: the tracked, policy-agnostic front
        door of kernel(). reads/writes take BufferViews (``buf[i:j]``,
        ``buf.rows(lo, hi)``) or whole UMBuffers; each resolves to exactly
        the byte extent the raw Range API would have used, so charges are
        bit-identical. CPU-actor accesses to from_host() buffers land in
        their staging allocation. When ``name`` is omitted, the label is
        derived from the operand buffer names (reads->writes order, e.g.
        ``"temp+power->temp_out"``), so per-kernel profiler reports stay
        unambiguous when an app launches many unnamed kernels."""
        if name is None:
            name = _derived_label(reads, writes)
        return self.kernel(
            reads=[_as_range(r, actor) for r in reads],
            writes=[_as_range(w, actor) for w in writes],
            flops=flops, actor=actor, name=name, node=node)

    def launch_batch(self, batch) -> List[float]:
        """Submit a whole batch of launches in one engine step.

        ``batch`` is a :class:`KernelBatch` or any iterable of
        :class:`KernelLaunch`. Charges are bit-identical to issuing the
        same launches through :meth:`launch` one by one — the batched
        engine (see :meth:`kernel_batch`) is a pure dispatch optimization,
        certified per policy and falling back to the sequential path
        whenever a launch could mutate placement mid-batch. Returns the
        per-launch modeled seconds, in submission order."""
        items = batch.items if isinstance(batch, KernelBatch) else list(batch)
        resolved = []
        ap = resolved.append
        amb = self._node
        for it in items:
            actor = it.actor
            name = it.name
            # raw-tuple fast path: _as_range passes tuples through, so only
            # buffer views pay the resolve call
            ap((name if name is not None
                else _derived_label(it.reads, it.writes),
                [r if type(r) is tuple else _as_range(r, actor)
                 for r in it.reads],
                [w if type(w) is tuple else _as_range(w, actor)
                 for w in it.writes],
                it.flops, actor,
                amb if it.node is None else it.node))
        return self.kernel_batch(resolved)

    @contextlib.contextmanager
    def staged(self, h2d: Sequence = (), d2h: Sequence = (), *,
               h2d_phase: str = "h2d", d2h_phase: str = "d2h"):
        """Staging boundary around a compute region.

        For every listed buffer/view whose policy declares
        ``staged_transfers`` (the explicit backend), charges the cudaMemcpy
        h2d copies on entry (phase `h2d_phase`) and the d2h copies on exit
        (phase `d2h_phase`), in list order. Buffers under directly-
        accessible policies pass through untouched — the same `with` block
        is the single code path for every memory-management version."""
        up = [as_view(v) for v in h2d]
        down = [as_view(v) for v in d2h]
        todo = [v for v in up if v.buf.policy.staged_transfers]
        if todo:
            with self.phase(h2d_phase):
                for v in todo:
                    self.copy(v.buf.alloc, v.lo, v.hi, "h2d")
        try:
            yield self
        finally:
            todo = [v for v in down if v.buf.policy.staged_transfers]
            if todo:
                with self.phase(d2h_phase):
                    for v in todo:
                        self.copy(v.buf.alloc, v.lo, v.hi, "d2h")

    # ------------------------------------------------------- page-level ops
    def _first_touch(self, a: Allocation, p0: int, p1: int, actor: Actor) -> None:
        """Lazily map the unmapped pages of extent [p0, p1): the policy
        charges PTE creation and picks the tier (spilling/evicting under
        device pressure as its memory system dictates)."""
        t = a.table
        if t.resident_pages(Tier.UNMAPPED) == 0:
            return  # O(1) steady-state exit: the whole table is mapped
        n_unmapped, need = t.unmapped_stats(p0, p1)
        if n_unmapped == 0:
            return
        tier = a.policy.on_first_touch(self, a, p0, p1, actor, n_unmapped, need)
        self._apply_delta(t.map_unmapped(p0, p1, tier))

    def _evict_lru(self, need_bytes: int, exclude: Optional[Allocation] = None) -> None:
        """Evict LRU managed device-resident pages until need_bytes freed.

        Victim selection is run-based: each candidate contributes its
        (device-tier run ∩ LRU-epoch run) pieces — O(runs), not O(pages) —
        and a stable sort of the pieces by epoch reproduces the dense
        per-page LRU order exactly (pages inside a piece are consecutive and
        share an epoch; ties keep (alloc, page) insertion order). The
        boundary piece is split at the page where the freed-bytes cumsum
        crosses `need_bytes`.

        `exclude` shields the faulting allocation's *current-step* working set
        (pages with last_access_epoch == the in-flight kernel's epoch) from
        eviction — the faulting allocation never self-evicts pages the same
        kernel step just touched. Colder pages of the same allocation stay
        evictable: real UVM evicts an oversubscribed allocation's own LRU
        pages (the paper's §7 streaming window), so excluding the whole
        allocation would be wrong. Known trade-off: a kernel touching several
        managed allocations under pressure may still evict *another*
        allocation's same-step pages (LRU order makes them last-resort
        victims); widening the epoch shield to every allocation is semantically
        attractive but shifts the reproduced fig11 oversubscription curves
        further from the paper baseline, so it is deliberately not done here.
        """
        cands: List[Allocation] = [
            a for a in self.allocs.values()
            if not a.freed and a.table is not None and a.policy.evictable]
        # cached-counter early-out: no evictable allocation has device-resident
        # pages -> nothing to evict, no run/array work at all
        if not any(a.table.resident_pages(Tier.DEVICE) for a in cands):
            return
        piece_s, piece_e, piece_ep, piece_ai = [], [], [], []
        for i, a in enumerate(cands):
            t = a.table
            if t.resident_pages(Tier.DEVICE) == 0:
                continue
            ds, de = t.runs_of(Tier.DEVICE)
            for s0, e0 in zip(ds, de):
                es, ee, ev = t.epoch_runs(int(s0), int(e0))
                if a is exclude:
                    m = ev < self.epoch
                    es, ee, ev = es[m], ee[m], ev[m]
                if len(es):
                    piece_s.append(es)
                    piece_e.append(ee)
                    piece_ep.append(ev)
                    piece_ai.append(np.full(len(es), i, np.int64))
        if not piece_s:
            return
        S = np.concatenate(piece_s)
        E = np.concatenate(piece_e)
        EP = np.concatenate(piece_ep)
        AI = np.concatenate(piece_ai)
        # stable sort of epoch-uniform pieces == the dense per-page stable
        # argsort (pieces were built in (alloc, page) insertion order)
        order = np.argsort(EP, kind="stable")
        S, E, AI = S[order], E[order], AI[order]
        ps_of = np.array([c.table.page_size for c in cands], np.int64)
        np_of = np.array([c.table.num_pages for c in cands], np.int64)
        tb_of = np.array([c.table.tail_bytes for c in cands], np.int64)
        sizes = (E - S) * ps_of[AI]
        tailm = E == np_of[AI]
        sizes[tailm] += tb_of[AI[tailm]] - ps_of[AI[tailm]]
        csum = np.cumsum(sizes)
        before = csum - sizes
        take = before < need_bytes
        S, E, AI = S[take], E[take], AI[take]
        if len(S) == 0:
            return
        # boundary piece: victims are taken while the bytes freed *before*
        # each page is < need — a page-count prefix of the piece
        room = need_bytes - int(before[np.flatnonzero(take)[-1]])
        psz = int(ps_of[AI[-1]])
        k = min(int(E[-1] - S[-1]), -(-room // psz))
        E[-1] = S[-1] + k
        tr = self.prof.traffic()
        uniq, first = np.unique(AI, return_index=True)
        for ai in uniq[np.argsort(first)]:  # first-appearance (charge) order
            a = cands[int(ai)]
            m = AI == ai
            s_list, e_list = S[m], E[m]
            npages = int((e_list - s_list).sum())
            # clean pages are just unmapped; only dirty pages copy back
            nbytes = a.table.dirty_bytes(s_list, e_list)
            self._apply_delta(a.table.move_runs(s_list, e_list, Tier.HOST))
            a.table.clear_dirty(s_list, e_list)
            self._charge(nbytes / self.hw.link_d2h + self.hw.migrate_per_page * npages)
            tr.migrated_out += nbytes
            tr.link_d2h += nbytes

    def _prefix_fit_runs(self, t: BlockTable, starts: np.ndarray,
                         ends: np.ndarray, budget: int):
        """Largest page-prefix of the runs whose per-page byte cumsum stays
        <= budget (the run analogue of ``pages[cumsum(sizes) <= budget]``)."""
        sizes = t.span_bytes(starts, ends)
        csum = np.cumsum(sizes)
        nfull = int(np.searchsorted(csum, budget, "right"))
        if nfull == len(starts):
            return starts, ends
        cb = int(csum[nfull - 1]) if nfull else 0
        k = max(0, (budget - cb) // t.page_size)
        if k == 0:
            return starts[:nfull], ends[:nfull]
        s = starts[:nfull + 1].copy()
        e = ends[:nfull + 1].copy()
        e[-1] = s[-1] + k
        return s, e

    def _migrate_in_runs(self, a: Allocation, starts, ends) -> int:
        """Move the host-resident pages of the given ascending [s, e) spans
        to the device, evicting if the policy reclaims under pressure.
        Returns bytes migrated. Placement no-op for policies whose memory
        system has no migration (a single physical pool)."""
        if not a.policy.migratable:
            return 0
        handled = a.policy.on_migrate_in(self, a, starts, ends)
        if handled is not None:  # node-aware backends promote node-locally
            return handled
        t = a.table
        hs, he = [], []
        for s0, e0 in zip(starts, ends):
            rs, re_ = t.runs_of(Tier.HOST, int(s0), int(e0))
            hs.append(rs)
            he.append(re_)
        if not hs:
            return 0
        hs = np.concatenate(hs)
        he = np.concatenate(he)
        if len(hs) == 0:
            return 0
        need = int(t.span_bytes(hs, he).sum())
        if need > self.device_free():
            a.policy.on_pressure(self, a, need)
            if need > self.device_free():
                hs, he = self._prefix_fit_runs(t, hs, he, self.device_free())
                if len(hs) == 0:
                    return 0
                need = int(t.span_bytes(hs, he).sum())
                if need == 0:
                    return 0
        self._apply_delta(t.move_runs(hs, he, Tier.DEVICE))
        tr = self.prof.traffic()
        tr.migrated_in += need
        tr.link_h2d += need
        npages = int((he - hs).sum())
        self._charge(need / self.hw.link_h2d + self.hw.migrate_per_page * npages)
        return need

    def _counter_bump(self, a: Allocation, p0: int, p1: int, txn: int) -> None:
        """Bump the GPU access counter by `txn` for every page of [p0, p1);
        pages crossing the policy threshold go notification-pending."""
        thr = a.policy.counter_threshold
        cs, ce, cv = a.table.bump_counter(p0, p1, txn)
        crossed = (cv < thr) & (cv + txn >= thr)
        if crossed.any():
            n_newly = int((ce[crossed] - cs[crossed]).sum())
            for s0, e0 in zip(cs[crossed], ce[crossed]):
                a.pending.set_range(int(s0), int(e0), 1)
            a.pending_count += n_newly
            self.prof.traffic().notifications += n_newly

    # ---------------------------------------------------------------- kernel
    def kernel(self, *, reads: Sequence[Range] = (), writes: Sequence[Range] = (),
               flops: float = 0.0, actor: Actor = Actor.GPU,
               name: str = "kernel", node: Optional[int] = None) -> float:
        """Model one kernel/loop-step. Returns modeled seconds. ``node``
        pins the issuing superchip for node-aware backends; None uses the
        ambient :meth:`on_node` node (0 outside any block)."""
        nd = self._node if node is None else int(node)
        if self._trace is not None:
            self._trace.on_kernel(name, reads, writes, flops, actor, nd)
        if nd != self._node:
            prev, self._node = self._node, nd
            try:
                return self._kernel_seq(reads, writes, flops, actor, name)
            finally:
                self._node = prev
        return self._kernel_seq(reads, writes, flops, actor, name)

    def _kernel_seq(self, reads, writes, flops, actor, name) -> float:
        self.epoch += 1
        t0 = self.clock
        tr = self.prof.traffic()
        local_bytes = 0.0
        remote_h2d = 0.0
        remote_d2h = 0.0
        remote_slow = 0.0  # managed thrash-mode remote reads (low bandwidth)
        # inter-node lanes (node-aware backends): exact integer byte/run
        # accumulators, converted to seconds once at the end of the launch
        lane_nvl_b = lane_nvl_n = lane_fab_b = lane_fab_n = 0
        lane_pol = None

        for is_write, ranges in ((False, reads), (True, writes)):
            for a, lo, hi in ranges:
                assert not a.freed, a.name
                if a.table is None:  # explicit: device-local always
                    local_bytes += hi - lo
                    tr.device_local += hi - lo
                    continue
                t = a.table
                p0, p1 = t.page_range(lo, hi)
                if p1 <= p0:
                    continue
                # stamp the access BEFORE first-touch: an eviction triggered
                # while mapping this extent's unmapped tail must see the
                # already-resident head as part of the current step's working
                # set (else a single coalesced range can self-evict its head)
                t.touch_range(p0, p1, self.epoch, is_write)
                self._first_touch(a, p0, p1, actor)

                # pre-access migration (fault-driven paths); the returned
                # context (e.g. managed's thrash-mode flag) feeds the charge
                # classification below
                ctx = a.policy.on_access(self, a, p0, p1, actor)

                # account access traffic against current residency: per-run
                # clipped bytes (boundary pages clip to [lo, hi); exact ints,
                # so the float sum is order-independent and bit-identical to
                # the dense per-page path)
                rs, re_, rv = t.tier_runs(p0, p1)
                if a.policy.node_aware:
                    # (node, tier)-encoded locations: hand the policy the
                    # exact per-run clipped integer bytes and let it route
                    # local / C2C / inter-node lanes through the topology
                    rb = t.span_bytes(rs, re_)
                    rb[0] = t.clipped_extent_bytes(
                        int(rs[0]), int(re_[0]), lo, hi)
                    rb[-1] = t.clipped_extent_bytes(
                        int(rs[-1]), int(re_[-1]), lo, hi)
                    l_b, h2d_b, d2h_b, slow_b, lanes = \
                        a.policy.charge_access_runs(
                            self, a, actor, is_write, ctx, rs, re_, rv, rb,
                            self._node)
                    lane_nvl_b += lanes[0]
                    lane_nvl_n += lanes[1]
                    lane_fab_b += lanes[2]
                    lane_fab_n += lanes[3]
                    lane_pol = a.policy
                else:
                    dm = rv == int(Tier.DEVICE)
                    if len(rs) == 1:  # extent fully resident on one tier
                        tot = float(t.clipped_extent_bytes(p0, p1, lo, hi))
                        dev_b, host_b = (tot, 0.0) if dm[0] else (0.0, tot)
                    else:
                        rb = t.span_bytes(rs, re_).astype(np.float64)
                        rb[0] = t.clipped_extent_bytes(int(rs[0]), int(re_[0]), lo, hi)
                        rb[-1] = t.clipped_extent_bytes(int(rs[-1]), int(re_[-1]), lo, hi)
                        dev_b = float(rb[dm].sum())
                        host_b = float(rb[~dm].sum())
                    l_b, h2d_b, d2h_b, slow_b = a.policy.charge_access(
                        self, a, actor, is_write, ctx, rs, re_, dm, dev_b, host_b)
                local_bytes += l_b
                remote_h2d += h2d_b
                remote_d2h += d2h_b
                remote_slow += slow_b

        bw = self.hw.device_bw if actor is Actor.GPU else self.hw.host_bw
        t_local = local_bytes / bw
        eff = self.hw.remote_efficiency
        t_remote = (remote_h2d / (self.hw.link_h2d * eff)
                    + remote_d2h / (self.hw.link_d2h * eff)
                    + remote_slow / (self.hw.link_h2d
                                     * self.hw.managed_thrash_efficiency))
        if lane_pol is not None:
            # one conversion per launch over the exact integer lane totals
            # — the batched engine applies the identical expression per item
            t_remote += lane_pol.lanes_time(
                self, (lane_nvl_b, lane_nvl_n, lane_fab_b, lane_fab_n))
        t_compute = flops / self.hw.flops_rate
        # async prefetch issued before this kernel overlaps with it
        t_kernel = max(t_local, t_remote, t_compute, self._pending_overlap)
        self._pending_overlap = 0.0
        self._charge(t_kernel + self.hw.kernel_launch)
        self._sample()
        dt = self.clock - t0
        self.prof.record_kernel(name, dt)
        return dt

    # --------------------------------------------------------- batched kernel
    def kernel_batch(self, items: Sequence) -> List[float]:
        """Model a batch of kernel steps in one engine pass.

        ``items`` are ``(name, reads, writes, flops, actor[, node])`` tuples
        with raw Ranges (launch_batch resolves buffer views down to this;
        a missing node defaults to the ambient on_node() node). The
        batch is charged in one vectorized sweep over run intersections —
        per-launch Python dispatch (range walks, per-extent tier_runs,
        profiler calls) is hoisted into array math over all extents at
        once. Semantics are bit-identical to looping :meth:`kernel`:

        * every touched (allocation, actor) hull must be certified by the
          policy's ``batch_ready`` hook — placement provably frozen for the
          whole batch (no first touch, no faults/migrations/evictions, no
          counter-threshold *drains* — bumps still accrue) — else the whole
          batch falls back to the sequential loop, which is identical by
          construction;
        * byte math reproduces the boundary-page clip quirks of
          ``clipped_extent_bytes`` exactly (all values exact integers, so
          float accumulation order cannot diverge);
        * LRU epochs land as max-over-covering-extents (== last writer),
          counter bumps collapse k identical bumps into one k-fold bump
          (same crossings, same pending set, same notifications);
        * the profiler finalization loop replays _charge/_sample/
          record_kernel float-op for float-op per item.
        """
        amb = self._node
        items = [it if len(it) == 6 else (*it, amb) for it in items]
        if self._trace is not None:
            # one batch event; suppress inner recording (the fallback loops
            # kernel(), which would otherwise double-record every launch)
            self._trace.on_batch(items)
            saved, self._trace = self._trace, None
            try:
                return self._kernel_batch(items)
            finally:
                self._trace = saved
        return self._kernel_batch(items)

    @staticmethod
    def _batch_loc_bytes(t: BlockTable, rs, re_, rv, p0s, p1s, los, his, h1):
        """Per-(extent, location) clipped bytes + overlapping-run counts over
        the frozen tier runs — the node-aware generalization of the two-tier
        device-prefix math in _kernel_batch. Columns are keyed by the sorted
        distinct location values ``uloc``. Every entry is an exact integer
        with span_bytes/clipped_extent_bytes semantics (tail-page and
        boundary-clip quirks included), so downstream accumulation order
        cannot diverge from the sequential engine."""
        uloc = np.unique(rv)
        col = np.searchsorted(uloc, rv)
        K = len(uloc)
        E = len(p0s)
        ps = t.page_size
        ar = np.arange(E)
        # per-location prefix sums of full-run bytes; two searchsorteds per
        # extent + boundary partials give bytes per (extent, location)
        M1 = np.zeros((len(rs), K), np.int64)
        M1[np.arange(len(rs)), col] = (re_ - rs) * ps
        cum = np.vstack((np.zeros((1, K), np.int64),
                         np.cumsum(M1, axis=0)))
        ja = np.searchsorted(rs, p0s, "right") - 1
        jb = np.searchsorted(rs, p1s, "right") - 1
        nb = cum[jb] - cum[ja]
        np.add.at(nb, (ar, col[jb]), (p1s - rs[jb]) * ps)
        np.subtract.at(nb, (ar, col[ja]), (p0s - rs[ja]) * ps)
        j1 = np.searchsorted(rs, p1s - 1, "right") - 1  # run of last page
        if h1 == t.num_pages:
            tm = p1s == t.num_pages
            if tm.any():
                np.add.at(nb, (ar[tm], col[j1][tm]), t.tail_bytes - ps)
        # boundary clips charge against the location owning the boundary page
        np.subtract.at(nb, (ar, col[ja]), los - p0s * ps)
        np.subtract.at(nb, (ar, col[j1]), p1s * ps - his)
        # overlapping-run counts per (extent, location): inter-node lanes
        # pay a per-contiguous-transfer latency, so the policy needs counts
        nr = np.empty((E, K), np.int64)
        for c in range(K):
            m = col == c
            nr[:, c] = (np.searchsorted(rs[m], p1s, "left")
                        - np.searchsorted(re_[m], p0s, "right"))
        return nb, nr, uloc

    def _kernel_batch(self, items: Sequence) -> List[float]:
        n = len(items)
        if n == 0:
            return []
        # ---- pass 1: flatten to per-allocation extent rows ----------------
        # side-effect-free: the fallback below must start from clean state
        groups: Dict[int, Tuple[Allocation, list]] = {}
        explicit_loc = [0] * n
        explicit_tot = 0
        GPU = Actor.GPU
        item_gpu = np.empty(n, bool)
        flops_arr = np.empty(n, np.float64)
        for i, (name, reads, writes, flops, actor, nd) in enumerate(items):
            gpu = 1 if actor is GPU else 0
            item_gpu[i] = gpu
            flops_arr[i] = flops
            for is_write, ranges in ((0, reads), (1, writes)):
                for a, lo, hi in ranges:
                    assert not a.freed, a.name
                    t = a.table
                    if t is None:  # explicit: device-local always
                        explicit_loc[i] += hi - lo
                        explicit_tot += hi - lo
                        continue
                    # page_range inlined (hot): Actor.GPU == 1, so the gpu
                    # flag doubles as the actor id in the row
                    assert 0 <= lo <= hi <= t.nbytes, (lo, hi, t.nbytes)
                    if lo == hi:
                        continue
                    ps = t.page_size
                    g = groups.get(id(a))
                    if g is None:
                        groups[id(a)] = g = (a, [])
                    g[1].append((lo // ps, -(-hi // ps), lo, hi, i,
                                 is_write, gpu, nd))
        # ---- pass 2: certify every (allocation, actor) hull ---------------
        certified = True
        prepped = []
        for a, rows in groups.values():
            M = np.asarray(rows, np.int64)
            acs = M[:, 6]
            for ac in (1, 0):
                m = acs == ac
                if not m.any():
                    continue
                h0 = int(M[m, 0].min())
                h1 = int(M[m, 1].max())
                if not a.policy.batch_ready(self, a, h0, h1, Actor(ac)):
                    certified = False
                    break
            if not certified:
                break
            prepped.append((a, M))
        if not certified:  # conformance fallback: the sequential engine
            return [self.kernel(reads=r, writes=w, flops=f, actor=ac,
                                name=nm, node=nd)
                    for nm, r, w, f, ac, nd in items]
        # ---- fast path: one vectorized charge pass per allocation ---------
        E0 = self.epoch
        loc_item = np.zeros(n, np.float64)
        h2d_item = np.zeros(n, np.float64)
        d2h_item = np.zeros(n, np.float64)
        slow_item = np.zeros(n, np.float64)
        lane_item = None  # (n, 4) exact-int lane accumulators, on demand
        lane_pol = None
        for a, M in prepped:
            t = a.table
            p0s, p1s = M[:, 0], M[:, 1]
            los, his = M[:, 2], M[:, 3]
            idx = M[:, 4]
            wr = M[:, 5].astype(bool)
            gpu = M[:, 6].astype(bool)
            h0, h1 = int(p0s.min()), int(p1s.max())
            rs, re_, rv = t.tier_runs(h0, h1)
            ps = t.page_size
            if a.policy.node_aware:
                nb, nr, uloc = self._batch_loc_bytes(t, rs, re_, rv, p0s,
                                                     p1s, los, his, h1)
                l_b, h2d_b, d2h_b, slow_b, lanes = \
                    a.policy.charge_access_batch_runs(
                        self, a, gpu, wr, M[:, 7], uloc, nb, nr)
                if lane_item is None:
                    lane_item = np.zeros((n, 4), np.float64)
                lane_pol = a.policy
                for c in range(4):
                    lane_item[:, c] += np.bincount(idx, weights=lanes[:, c],
                                                   minlength=n)
                loc_item += np.bincount(idx, weights=l_b, minlength=n)
                h2d_item += np.bincount(idx, weights=h2d_b, minlength=n)
                d2h_item += np.bincount(idx, weights=d2h_b, minlength=n)
                slow_item += np.bincount(idx, weights=slow_b, minlength=n)
                t.touch_batch(p0s, p1s, E0 + 1 + idx, wr)
                continue
            dev = rv == int(Tier.DEVICE)
            # device-byte prefix over the frozen tier runs: two searchsorteds
            # per extent replace a per-extent tier_runs walk
            cum = np.concatenate(([0], np.cumsum(
                np.where(dev, (re_ - rs) * ps, 0))))
            ja = np.searchsorted(rs, p0s, "right") - 1
            jb = np.searchsorted(rs, p1s, "right") - 1
            devb = (cum[jb] + np.where(dev[jb], (p1s - rs[jb]) * ps, 0)
                    - cum[ja] - np.where(dev[ja], (p0s - rs[ja]) * ps, 0))
            totb = (p1s - p0s) * ps
            j1 = np.searchsorted(rs, p1s - 1, "right") - 1  # run of last page
            if h1 == t.num_pages:
                # span_bytes/range_bytes semantics: extents reaching the
                # final (possibly partial) page count tail_bytes for it
                tadj = t.tail_bytes - ps
                tm = p1s == t.num_pages
                totb = totb + np.where(tm, tadj, 0)
                devb = devb + np.where(tm & dev[j1], tadj, 0)
            # boundary-page clips charge against the tier that owns the
            # boundary page — including clipped_extent_bytes' pinned quirk
            # (the tail clip uses the full-page overhang even on a partial
            # final page, possibly driving that side negative)
            headclip = los - p0s * ps
            tailclip = p1s * ps - his
            d0, d1 = dev[ja], dev[j1]
            dev_b = (devb - np.where(d0, headclip, 0)
                     - np.where(d1, tailclip, 0))
            host_b = (totb - devb - np.where(~d0, headclip, 0)
                      - np.where(~d1, tailclip, 0))
            l_b, h2d_b, d2h_b, slow_b = a.policy.charge_access_batch(
                self, a, gpu, wr, p0s, p1s, dev_b, host_b)
            loc_item += np.bincount(idx, weights=l_b, minlength=n)
            h2d_item += np.bincount(idx, weights=h2d_b, minlength=n)
            d2h_item += np.bincount(idx, weights=d2h_b, minlength=n)
            slow_item += np.bincount(idx, weights=slow_b, minlength=n)
            t.touch_batch(p0s, p1s, E0 + 1 + idx, wr)
        if explicit_tot:
            self.prof.traffic().device_local += explicit_tot
            loc_item += np.asarray(explicit_loc, np.float64)
        self.epoch = E0 + n
        # ---- per-item times (same float expressions as kernel()) ----------
        hw = self.hw
        t_local = loc_item / np.where(item_gpu, hw.device_bw, hw.host_bw)
        eff = hw.remote_efficiency
        t_remote = (h2d_item / (hw.link_h2d * eff)
                    + d2h_item / (hw.link_d2h * eff)
                    + slow_item / (hw.link_h2d * hw.managed_thrash_efficiency))
        if lane_pol is not None:
            # same fixed-association expression as the sequential engine's
            # per-launch lanes_time, applied per item
            t_remote = t_remote + lane_pol.lanes_time_batch(self, lane_item)
        t_kern = np.maximum(np.maximum(t_local, t_remote),
                            flops_arr / hw.flops_rate)
        # ---- finalization: replay _charge/_sample/record_kernel exactly ---
        # residency is frozen across a certified batch, so every sample
        # carries the same totals and the peaks update once
        prof = self.prof
        hb = self._host_bytes
        devtot = self._device_bytes + prof.driver_baseline
        if hb > prof._peak_host:
            prof._peak_host = hb
        if devtot > prof._peak_device:
            prof._peak_device = devtot
        timeline = prof.timeline
        ktimes, kcounts = prof.kernel_times, prof.kernel_counts
        pt, phase = prof.phase_times, prof.phase
        acc = pt[phase]
        kl = hw.kernel_launch
        ov = self._pending_overlap
        self._pending_overlap = 0.0
        clock = self.clock
        tk = t_kern.tolist()
        dts = []
        for i, it in enumerate(items):
            tki = tk[i]
            if i == 0 and ov > tki:  # async prefetch overlaps the first item
                tki = ov
            s = tki + kl
            c1 = clock + s
            dt = c1 - clock
            clock = c1
            acc += s
            timeline.append((c1, hb, devtot))
            name = it[0]
            ktimes[name] += dt
            kcounts[name] += 1
            dts.append(dt)
        self.clock = clock
        pt[phase] = acc
        return dts

    def drain_dirty(self, ranges: Sequence) -> int:
        """Checkpoint-style writeback: charge a d2h drain of every *dirty*
        device-resident byte covered by ``ranges`` (BufferViews, UMBuffers
        or raw Ranges) WITHOUT moving pages or clearing dirty state — the
        snapshot reads the live copy, so placement and every subsequent
        charge are exactly what they would have been without the save
        (CheckpointManager.save of UM-backed state goes through this).
        Table-less explicit blobs are skipped: their authoritative copy is
        the host staging side. Returns the bytes charged."""
        total = 0
        for r in ranges:
            a, lo, hi = _as_range(r, Actor.GPU)
            assert not a.freed, a.name
            t = a.table
            if t is None or hi <= lo:
                continue
            p0, p1 = t.page_range(lo, hi)
            rs, re_, rv = t.tier_runs(p0, p1)
            # device side: odd (node, tier) location encodings; plain
            # tables reduce to Tier.DEVICE == 1
            m = (rv > 0) & (rv % 2 == 1)
            if not m.any():
                continue
            nb = t.dirty_bytes(rs[m], re_[m])
            if nb:
                self._charge(nb / self.hw.link_d2h)
                self.prof.traffic().link_d2h += nb
                total += nb
        self._sample()
        return total

    # ------------------------------------------------------------- sync/misc
    def sync(self) -> float:
        """cudaDeviceSynchronize analogue: each live paged allocation's
        policy drains whatever it batches to sync points (the system
        backend's notification-pending delayed migrations, under its
        per-sync budget — O(runs), never O(pages))."""
        if self._trace is not None:
            self._trace.on_sync()
        t0 = self.clock
        if self._pending_overlap:  # flush un-overlapped async prefetches
            self._charge(self._pending_overlap)
            self._pending_overlap = 0.0
        for a in self.allocs.values():
            if a.freed or a.table is None:
                continue
            a.policy.on_sync(self, a)
        self._sample()
        return self.clock - t0

    def copy(self, a: Allocation, lo: int, hi: int, direction: str) -> float:
        """Explicit cudaMemcpy. direction: 'h2d' | 'd2h'."""
        if self._trace is not None:
            self._trace.on_copy(a.name, lo, hi, direction)
        nbytes = hi - lo
        bw = self.hw.link_h2d if direction == "h2d" else self.hw.link_d2h
        self._charge(nbytes / bw)
        tr = self.prof.traffic()
        if direction == "h2d":
            tr.link_h2d += nbytes
        else:
            tr.link_d2h += nbytes
        self._sample()
        return nbytes / bw

    def prefetch(self, a, lo: Optional[int] = None, hi: Optional[int] = None,
                 overlap: bool = False) -> float:
        """cudaMemPrefetchAsync analogue: migrate range to device.

        `a` is an Allocation with byte bounds lo/hi, or a BufferView/UMBuffer
        (bounds taken from the view). overlap=True models the async stream:
        the migration cost hides under the next kernel (charged as
        max(kernel, prefetch))."""
        if lo is None:
            a, lo, hi = _as_range(a, Actor.GPU)
        if self._trace is not None:
            self._trace.on_prefetch(a.name, lo, hi, overlap)
        t0 = self.clock
        assert a.table is not None, "prefetch needs a paged allocation"
        p0, p1 = a.table.page_range(lo, hi)
        self._first_touch(a, p0, p1, Actor.CPU)
        if overlap:
            saved = self.clock
            self._migrate_in_runs(a, (p0,), (p1,))
            self._pending_overlap += self.clock - saved
            # roll the clock back: the cost is deferred to the next kernel
            dt = self.clock - saved
            self.clock = saved
            self.prof.charge(-dt)
        else:
            self._migrate_in_runs(a, (p0,), (p1,))
        self._sample()
        return self.clock - t0

    def prefetch_async(self, ranges: Sequence) -> float:
        """Async multi-extent prefetch: promote each item — a raw
        (alloc, lo, hi) range or a BufferView — to the device ahead of the
        kernel that will read it. The migration cost accrues to
        ``_pending_overlap`` and hides under the next kernel (serve/engine.py
        promotes a resumed sequence's extents ahead of its decode turn
        through this). Returns the hidden seconds."""
        before = self._pending_overlap
        for r in ranges:
            a, lo, hi = _as_range(r, Actor.GPU)
            self.prefetch(a, lo, hi, overlap=True)
        return self._pending_overlap - before

    def demote(self, a, lo: Optional[int] = None,
               hi: Optional[int] = None) -> float:
        """Demote a range host-side (cudaMemPrefetchAsync-to-cpuDeviceId
        analogue): device-resident pages of [lo, hi) move to host memory,
        charged at the d2h link. Unmapped pages stay unmapped. The serve
        scheduler uses this to push a preempted sequence's KV pages out of
        HBM before its pool pages are handed to another sequence. Accepts a
        BufferView in place of (Allocation, lo, hi)."""
        if lo is None:
            a, lo, hi = _as_range(a, Actor.GPU)
        if self._spill_fail and a.policy.migratable:
            # all-or-nothing: raise before any charge or table mutation so
            # the caller's fallback starts from an untouched range
            raise HostSpillError(
                f"host spill of '{a.name}' [{lo}, {hi}) rejected: "
                "spill-failure window active")
        if self._trace is not None:
            self._trace.on_demote(a.name, lo, hi)
        t0 = self.clock
        assert a.table is not None, "demote needs a paged allocation"
        t = a.table
        p0, p1 = t.page_range(lo, hi)
        if a.pending is not None:
            # the caller is explicitly cold-marking this range: drop any
            # pending migration notifications so the next sync() doesn't
            # promote the just-demoted pages straight back to the device
            a.pending_count -= a.pending.count_nonzero(p0, p1)
            a.pending.set_range(p0, p1, 0)
        if a.policy.migratable:
            handled = a.policy.on_demote(self, a, p0, p1)
            if handled is not None:  # node-aware spill (possibly cross-node)
                self._sample()
                return self.clock - t0
        ds_, de_ = t.runs_of(Tier.DEVICE, p0, p1)
        if len(ds_) and a.policy.migratable:
            nbytes = int(t.span_bytes(ds_, de_).sum())
            npages = int((de_ - ds_).sum())
            self._apply_delta(t.move_runs(ds_, de_, Tier.HOST))
            t.clear_dirty(ds_, de_)
            tr = self.prof.traffic()
            tr.migrated_out += nbytes
            tr.link_d2h += nbytes
            self._charge(nbytes / self.hw.link_d2h
                         + self.hw.migrate_per_page * npages)
        self._sample()
        return self.clock - t0

    # ---------------------------------------------------------------- report
    def report(self) -> Dict[str, object]:
        rep = self.prof.report()
        rep["allocations"] = {
            name: {
                "nbytes": a.nbytes,
                "policy": a.policy.kind,
                "page_size": a.policy.page_size,
                "device_bytes": (a.device_bytes_explicit if a.table is None
                                 else a.table.residency_by_side()[1]),
                "host_bytes": (0 if a.table is None
                               else a.table.residency_by_side()[0]),
                "extents": (0 if a.table is None
                            else len(a.table.tier_runs()[0])),
                "freed": a.freed,
            }
            for name, a in self.allocs.items()
        }
        return rep
