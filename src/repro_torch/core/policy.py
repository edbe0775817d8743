"""Memory-policy backends: pluggable strategies for the unified-memory runtime.

The paper's three allocation strategies — and any new memory system — are
:class:`MemPolicy` objects. ``UnifiedMemory`` never branches on a policy
name: every policy-dependent decision goes through an explicit lifecycle
hook on the allocation's policy object.

Built-in backends (the paper's comparison axis):

system   -> :class:`SystemPolicy` (malloc): single system page table,
            direct remote access at fine granularity, access-counter-based
            *delayed* migration (threshold notifications, §2.2.1).
managed  -> :class:`ManagedPolicy` (cudaMallocManaged): fault-driven
            on-demand migration at 2 MB granularity + speculative prefetch,
            LRU eviction under device-capacity pressure (§2.3).
explicit -> :class:`ExplicitPolicy` (cudaMalloc + cudaMemcpy):
            device-resident, explicit staged copies, OOM on oversubscription.

plus one backend for a different memory system entirely:

mi300a_unified -> :class:`Mi300aUnifiedPolicy`: AMD MI300A's single
            *physical* pool (CPU and GPU share one HBM3 memory and one page
            table). First touch maps, nothing ever migrates, nothing is
            evicted, and access latency is uniform — oversubscribing the
            pool is a genuine OOM. Pair with the ``MI300A`` HardwareModel.

Hook reference (``um`` is the calling :class:`~repro_torch.core.umem.UnifiedMemory`):

==========================  ==================================================
hook                        called when / must do
==========================  ==================================================
``on_alloc(um, name, n)``   build and charge the Allocation record
``on_free(um, a)``          release residency, charge deallocation
``make_staging(um, buf)``   from_host(): return a host staging Allocation
                            (or None) for the cudaMalloc+malloc pair
``on_first_touch(...)``     charge PTE creation for the unmapped pages of an
                            extent and return the Tier they map to
``on_access(...)``          pre-access migration (fault-driven paths); the
                            return value is handed to charge_access as ctx
``charge_access(...)``      classify the extent's resident bytes into
                            (local, remote_h2d, remote_d2h, remote_slow)
                            contributions and update traffic counters
``on_pressure(um, a, n)``   a migration into a full device: evict (or not)
``on_sync(um, a)``          sync point: drain batched/delayed migrations
``resolve_actor_side(...)`` route a BufferView to the allocation an actor
                            actually touches (explicit staging pairs)
==========================  ==================================================

Charge-accounting invariants every backend must keep (enforced for the
built-ins by scripts/check_parity.py, and for every registered backend by
tests/policy_contract.py):

* alloc/free symmetry — freeing returns host/device residency to its
  pre-alloc values;
* the runtime's cached residency totals equal a full recount after any
  op sequence (``UnifiedMemory._recompute_residency``);
* freed allocations are never charged (kernel access asserts).

``system_policy`` / ``managed_policy`` / ``explicit_policy`` remain as thin
compatibility constructors; new code should go through
``repro_torch.core.registry`` (``register_policy`` / ``make_policy``).

The serving stack allocates its paged KV pool under the *system* policy
(one umem page per KV pool page): the scheduler in serve/engine.py moves
requests through pending -> prefill -> decoding -> preempted -> done,
admitting against device-memory pressure, demoting preempted sequences'
pages host-side, and relying on this policy's graceful remote access +
counter-based delayed migration when the pool exceeds device capacity.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.pagetable import Actor, BlockTable, Tier
from repro_torch.core.runs import RunMap, union_runs

KB = 1024
MB = 1024 * 1024


class OutOfDeviceMemory(RuntimeError):
    pass


class HostSpillError(RuntimeError):
    """An injected host-spill failure window is active: the demote target's
    memory cannot accept the spill (runtime/fault.py FaultPlan 'spill_fail'
    events). Callers fall back — the serve engine drops the KV instead of
    saving it and recomputes the sequence from its prompt."""


@dataclass
class Allocation:
    name: str
    nbytes: int
    policy: "MemPolicy"
    table: Optional[BlockTable]  # None for explicit (device-resident, no PTEs)
    device_bytes_explicit: int = 0
    pending: Optional[RunMap] = None  # system: notification-pending page runs
    pending_count: int = 0  # fast-path: #pending pages ever set minus cleared
    freed: bool = False


@dataclass(frozen=True)
class MemPolicy:
    """Abstract memory-policy backend: config knobs + lifecycle hooks.

    Subclasses set ``kind`` (the registry/reporting name) and override the
    hooks whose behavior differs from the paged defaults below. Config
    fields a backend does not use are simply ignored by its hooks.
    """

    page_size: int = 64 * KB  # PTE granularity
    migration_granule: int = 64 * KB  # bytes moved per migration decision
    counter_threshold: int = 256  # remote accesses before a notification
    auto_migrate: bool = True  # system: enable counter-based migration
    speculative_prefetch: int = 4  # managed: granules prefetched per fault
    max_migration_bytes_per_sync: int = 512 * MB  # driver batch per sync point

    # capability flags (class attributes, not config fields)
    kind = "abstract"  # registry / reporting name
    paged = True  # allocations carry a BlockTable (False: device-resident blob)
    migratable = True  # pages can move between tiers after first touch
    evictable = False  # pages are LRU-eviction victims under device pressure
    staged_transfers = False  # um.staged() charges h2d/d2h copies for this policy
    batched_charge = False  # opt-in: charge_access folds into kernel_batch's
    # array-wide pass (see batch_ready / charge_access_batch); backends that
    # never opt in are looped through single launches, bit-identically
    node_aware = False  # opt-in: page locations are (node, tier) encodings
    # (see pagetable.node_tier_loc) and the runtime charges through the
    # *_runs hooks + integer lane accounting below instead of the two-tier
    # charge_access hooks. Single-node backends never see any of it.

    # ------------------------------------------------------------ lifecycle
    def on_alloc(self, um, name: str, nbytes: int) -> Allocation:
        """Build the Allocation record and charge allocation bookkeeping.

        Paged default: a lazy page table — allocation itself only creates
        VMA bookkeeping (no PTEs, no residency)."""
        table = BlockTable(name, nbytes, self.page_size)
        a = Allocation(name, nbytes, self, table=table,
                       pending=RunMap(table.num_pages, 0, np.int8))
        um._charge(um.hw.alloc_per_page * min(table.num_pages, 64))
        return a

    def on_free(self, um, a: Allocation) -> None:
        """Release residency and charge per-page deallocation."""
        t = a.table
        mapped = t.num_pages - t.resident_pages(Tier.UNMAPPED)
        hb, db = t.residency_by_side()
        um._host_bytes -= hb
        um._device_bytes -= db
        um._charge(um.hw.dealloc_per_page * mapped)

    def make_staging(self, um, buf) -> Optional[Allocation]:
        """from_host(): the host staging Allocation for the cudaMalloc+malloc
        pair, or None when the policy's memory is CPU-accessible already."""
        return None

    # ------------------------------------------------------------ placement
    def on_first_touch(self, um, a: Allocation, p0: int, p1: int,
                       actor: Actor, n_unmapped: int, need_bytes: int) -> Tier:
        """Charge PTE creation for the ``n_unmapped`` unmapped pages of
        extent [p0, p1) and return the tier they map to. ``need_bytes`` is
        what device residency would grow by if they map device-side."""
        raise NotImplementedError(self.kind)

    # --------------------------------------------------------------- access
    def on_access(self, um, a: Allocation, p0: int, p1: int, actor: Actor):
        """Pre-access migration hook, called after first-touch mapping and
        before residency is read for charging. Returns an opaque context
        value handed to :meth:`charge_access` (the managed backend returns
        its thrash-mode flag). Default: no migration, falsy context."""
        return None

    def charge_access(self, um, a: Allocation, actor: Actor, is_write: bool,
                      ctx, rs: np.ndarray, re_: np.ndarray, dm: np.ndarray,
                      dev_b: float, host_b: float
                      ) -> Tuple[float, float, float, float]:
        """Classify one extent's resident bytes into charge-model buckets.

        ``rs/re_`` are the extent's tier-run spans, ``dm`` the device-tier
        mask, ``dev_b/host_b`` the (boundary-clipped) bytes per side. Must
        update the traffic counters and return the
        ``(local, remote_h2d, remote_d2h, remote_slow)`` contributions the
        kernel accumulates. The default models a generic two-tier system:
        the actor's home side is local, the far side crosses the link."""
        tr = um.prof.traffic()
        if actor is Actor.GPU:
            tr.device_local += int(dev_b)
            if ctx:  # thrash mode: remote reads at degraded link efficiency
                tr.link_h2d += int(host_b)
                tr.remote_h2d += int(host_b)
                return dev_b, 0.0, 0.0, host_b
            if is_write:
                tr.link_d2h += int(host_b)
                tr.remote_d2h += int(host_b)
                return dev_b, 0.0, host_b, 0.0
            tr.link_h2d += int(host_b)
            tr.remote_h2d += int(host_b)
            return dev_b, host_b, 0.0, 0.0
        tr.host_local += int(host_b)
        tr.link_d2h += int(dev_b)
        return host_b, 0.0, dev_b, 0.0

    # ------------------------------------------------------ batched access
    def batch_ready(self, um, a: Allocation, p0: int, p1: int,
                    actor: Actor) -> bool:
        """Certify extent [p0, p1) — the hull of one allocation's extents in
        a kernel batch — for the batched charge pass. Return True only when,
        with tier state frozen, this policy's sequential per-launch hooks
        reduce to :meth:`charge_access_batch`: no first-touch mapping and no
        in-kernel migration/fault/thrash work from :meth:`on_access`.
        ``kernel_batch`` falls back to looping single launches whenever any
        touched policy answers False (or never opted in via
        ``batched_charge``), so backends that don't implement batching stay
        bit-identical automatically. The default certifies any fully-mapped
        hull, which is exact for policies whose ``on_access`` is the
        inherited no-op."""
        if not self.batched_charge:
            return False
        t = a.table
        return (t.resident_pages(Tier.UNMAPPED) == 0
                or t.unmapped_stats(p0, p1)[0] == 0)

    def charge_access_batch(self, um, a: Allocation, gpu: np.ndarray,
                            wr: np.ndarray, p0s: np.ndarray, p1s: np.ndarray,
                            dev_b: np.ndarray, host_b: np.ndarray):
        """Array-wide :meth:`charge_access` over one allocation's certified
        batch extents. ``gpu``/``wr`` are per-extent actor/write masks,
        ``p0s``/``p1s`` the page extents, ``dev_b``/``host_b`` the
        boundary-clipped int64 bytes per side. Must update the traffic
        counters and return per-extent ``(local, remote_h2d, remote_d2h,
        remote_slow)`` int64 arrays for the batch engine to accumulate
        per item. Every value is an exact integer, so the downstream float
        conversions are order-independent and bit-identical to the
        sequential path. Only called on extents :meth:`batch_ready`
        certified (``ctx`` is falsy by construction — no thrash mode)."""
        tr = um.prof.traffic()
        zero = np.zeros_like(dev_b)
        loc = np.where(gpu, dev_b, host_b)
        h2d = np.where(gpu & ~wr, host_b, zero)
        d2h = np.where(gpu & wr, host_b, zero) + np.where(~gpu, dev_b, zero)
        tr.device_local += int(dev_b[gpu].sum())
        rem_h2d = int(h2d.sum())
        tr.link_h2d += rem_h2d
        tr.remote_h2d += rem_h2d
        rem_d2h = int(host_b[gpu & wr].sum())
        tr.remote_d2h += rem_d2h
        tr.link_d2h += rem_d2h + int(dev_b[~gpu].sum())
        tr.host_local += int(host_b[~gpu].sum())
        return loc, h2d, d2h, zero

    # --------------------------------------------------- node-aware access
    # Only consulted for policies with ``node_aware = True`` (the cluster
    # backends). Locations in the page table are (node, tier) encodings;
    # the runtime hands the *_runs hooks the run structure plus exact
    # per-run clipped integer bytes, and the hooks return the classic
    # (local, h2d, d2h, slow) buckets PLUS an integer lane tuple
    # ``(nvlink_bytes, nvlink_runs, fabric_bytes, fabric_runs)`` for
    # inter-node traffic. Lanes stay exact integers all the way through
    # accumulation — the float conversion happens exactly once per
    # launch/item via lanes_time / lanes_time_batch, so the sequential and
    # batched engines stay bit-identical.
    def charge_access_runs(self, um, a: Allocation, actor: Actor,
                           is_write: bool, ctx, rs: np.ndarray,
                           re_: np.ndarray, rv: np.ndarray, rb: np.ndarray,
                           node: int):
        """Classify one extent's per-run clipped bytes (``rb``, exact ints)
        against the (node, tier) locations ``rv``, as seen from ``node``.
        Returns ``(local, h2d, d2h, slow, lanes)``."""
        raise NotImplementedError(self.kind)

    def charge_access_batch_runs(self, um, a: Allocation, gpu: np.ndarray,
                                 wr: np.ndarray, nodes: np.ndarray,
                                 uloc: np.ndarray, nb: np.ndarray,
                                 nr: np.ndarray):
        """Array-wide charge_access_runs: ``nb``/``nr`` are per-(extent,
        location) clipped bytes / overlapping-run counts, columns keyed by
        ``uloc``. Returns per-extent ``(local, h2d, d2h, slow, lanes)``
        int64 arrays, ``lanes`` of shape (extents, 4)."""
        raise NotImplementedError(self.kind)

    def lanes_time(self, um, lanes) -> float:
        """Seconds for one launch's accumulated integer lane tuple."""
        return 0.0

    def lanes_time_batch(self, um, lanes):
        """Per-item seconds for the batch's accumulated lane matrix."""
        return 0.0

    # -------------------------------------------------- placement dispatch
    def on_demote(self, um, a: Allocation, p0: int, p1: int):
        """Demotion dispatch: return None to use the runtime's built-in
        device->host demotion; node-aware backends retier/charge here
        (e.g. spilling to a remote node's host memory) and return the
        modeled seconds they charged."""
        return None

    def on_migrate_in(self, um, a: Allocation, starts, ends):
        """Promotion dispatch for _migrate_in_runs: return None to use the
        built-in host->device path; node-aware backends promote toward the
        accessing node here and return the bytes they migrated."""
        return None

    def on_node_loss(self, um, a: Allocation, node: int):
        """Superchip ``node``'s physical memory vanished (um.fail_node):
        poison — unmap — every page of this allocation resident on its
        host or device side and return the lost [p0, p1) page runs. The
        data is unrecoverable; callers re-materialize contents (the serve
        engine replays affected sequences from their prompts, mirroring
        the trainer's checkpoint-restore). The default covers any paged
        backend through the (node, tier) encoding — a single-node table
        simply has no locations for ``node > 0``; table-less backends
        lose nothing here (their device blobs are modeled node-0-pinned
        and a node-0 loss of an explicit blob is not modeled)."""
        t = a.table
        if t is None:
            return []
        out = []
        for loc in (2 * node, 2 * node + 1):  # (node, HOST), (node, DEVICE)
            s, e = t.runs_of(loc)
            if len(s) == 0:
                continue
            if a.pending is not None:
                # pending migration notifications over lost pages are
                # meaningless — the next sync must not promote ghosts
                for r0, r1 in zip(s, e):
                    a.pending_count -= a.pending.count_nonzero(int(r0),
                                                               int(r1))
                    a.pending.set_range(int(r0), int(r1), 0)
            um._apply_delta(t.move_runs(s, e, Tier.UNMAPPED))
            t.clear_dirty(s, e)
            out.extend((int(r0), int(r1)) for r0, r1 in zip(s, e))
        out.sort()
        return out

    # ------------------------------------------------------- pressure/sync
    def on_pressure(self, um, a: Allocation, need_bytes: int) -> None:
        """Device memory is short ``need_bytes`` for a migration into it.
        Backends that participate in eviction reclaim here; the default
        reclaims nothing (the migration prefix-fits what free space allows)."""

    def on_sync(self, um, a: Allocation) -> None:
        """Sync point (cudaDeviceSynchronize): drain any batched/delayed
        migration state. Default: nothing pending."""

    # -------------------------------------------------------------- routing
    def resolve_actor_side(self, view, actor: Actor):
        """Lower a BufferView to the raw Range the given actor touches.
        Default: CPU actors land in the staging side whenever
        ``make_staging`` created one, so a backend that stages does not
        also have to reimplement the routing."""
        if actor is Actor.CPU and view.buf.host is not None:
            return (view.buf.host, view.lo, view.hi)
        return (view.buf.alloc, view.lo, view.hi)


@dataclass(frozen=True)
class SystemPolicy(MemPolicy):
    """System-allocated memory (malloc): one OS page table for both actors.

    GPU first-touch pays the SMMU->OS round trip (§5.1.2); device-capacity
    pressure maps host-side instead of evicting (graceful oversubscription);
    remote GPU reads bump per-page access counters whose threshold
    crossings queue notifications that sync() drains as batched migrations
    (§2.2.1)."""

    kind = "system"
    batched_charge = True  # on_access is the inherited no-op; the counter
    # bumps fold into charge_access_batch below

    def on_first_touch(self, um, a, p0, p1, actor, n_unmapped, need_bytes):
        tr = um.prof.traffic()
        if actor is Actor.GPU:
            # GPU first-touch of system memory: SMMU fault -> OS on the CPU
            # creates the PTE (the §5.1.2 init bottleneck)
            um._charge(um.hw.pte_init_gpu * n_unmapped)
            tr.pte_inits_gpu += n_unmapped
        else:
            um._charge(um.hw.pte_init_cpu * n_unmapped)
            tr.pte_inits_cpu += n_unmapped
        tier = actor.home_tier
        if tier is Tier.DEVICE and need_bytes > um.device_free():
            tier = Tier.HOST  # system memory: map host-side instead
        return tier

    def charge_access(self, um, a, actor, is_write, ctx, rs, re_, dm,
                      dev_b, host_b):
        out = super().charge_access(um, a, actor, is_write, ctx, rs, re_, dm,
                                    dev_b, host_b)
        if actor is Actor.GPU and self.auto_migrate and host_b:
            # remote-access counters: one bump per host run; the (possibly
            # partial) tail page has its own txn count
            t = a.table
            grain = um.hw.remote_access_grain
            txn_full = max(1, t.page_size // grain)
            txn_tail = max(1, t.tail_bytes // grain)
            for s0, e0 in zip(rs[~dm], re_[~dm]):
                s0, e0 = int(s0), int(e0)
                if e0 == t.num_pages and txn_tail != txn_full:
                    if e0 - 1 > s0:
                        um._counter_bump(a, s0, e0 - 1, txn_full)
                    um._counter_bump(a, e0 - 1, e0, txn_tail)
                else:
                    um._counter_bump(a, s0, e0, txn_full)
        return out

    def charge_access_batch(self, um, a, gpu, wr, p0s, p1s, dev_b, host_b):
        out = super().charge_access_batch(um, a, gpu, wr, p0s, p1s,
                                          dev_b, host_b)
        m = gpu & (host_b != 0)
        if self.auto_migrate and m.any():
            # The sequential path bumps each page once per covering extent's
            # host run. With tier state frozen across the certified batch,
            # k bumps of txn collapse to one bump of k*txn: increments are
            # monotone, so the threshold crossing (old < thr <= old + total),
            # the final counter values and the pending/notification state
            # are all identical.
            t = a.table
            lo, hi = int(p0s[m].min()), int(p1s[m].max())
            hs, he = t.runs_of(Tier.HOST, lo, hi)
            if len(hs):
                # intersect every host-carrying extent with the host runs
                # (vectorized runs_of(HOST, p0, p1) over all extents at once)
                ia = np.searchsorted(he, p0s[m], "right")
                ib = np.searchsorted(hs, p1s[m], "left")
                cnt = ib - ia
                rep = np.repeat(np.arange(len(cnt)), cnt)
                ridx = (np.repeat(ia, cnt)
                        + np.arange(int(cnt.sum()))
                        - np.repeat(np.cumsum(cnt) - cnt, cnt))
                cs = np.maximum(hs[ridx], p0s[m][rep])
                ce = np.minimum(he[ridx], p1s[m][rep])
                if len(cs):
                    grain = um.hw.remote_access_grain
                    txn_full = max(1, t.page_size // grain)
                    txn_tail = max(1, t.tail_bytes // grain)
                    # coverage sweep: how many extents' host runs cover each
                    # elementary segment -> one collapsed bump per segment
                    bp = np.unique(np.concatenate((cs, ce)))
                    cov = np.zeros(len(bp), np.int64)
                    np.add.at(cov, np.searchsorted(bp, cs), 1)
                    np.add.at(cov, np.searchsorted(bp, ce), -1)
                    cov = np.cumsum(cov[:-1])
                    for s0, e0, k in zip(bp[:-1].tolist(), bp[1:].tolist(),
                                         cov.tolist()):
                        if k == 0:
                            continue
                        if e0 == t.num_pages and txn_tail != txn_full:
                            if e0 - 1 > s0:
                                um._counter_bump(a, s0, e0 - 1, txn_full * k)
                            um._counter_bump(a, e0 - 1, e0, txn_tail * k)
                        else:
                            um._counter_bump(a, s0, e0, txn_full * k)
        return out

    def on_sync(self, um, a):
        """Drain notification-pending pages as (pending ∩ host) runs under
        the per-sync migration budget — O(runs), never O(pages)."""
        if not self.auto_migrate or a.pending is None:
            return
        if a.pending_count == 0:  # invariant: count 0 <=> no pending runs
            return
        t = a.table
        ps_, pe_ = a.pending.nonzero_runs()
        hs, he = [], []
        for s0, e0 in zip(ps_, pe_):
            rs, re_ = t.runs_of(Tier.HOST, int(s0), int(e0))
            hs.append(rs)
            he.append(re_)
        hs = np.concatenate(hs) if hs else np.empty(0, np.int64)
        he = np.concatenate(he) if he else np.empty(0, np.int64)
        if len(hs) == 0:
            a.pending.clear()
            a.pending_count = 0
            return
        budget = self.max_migration_bytes_per_sync
        ks, ke = um._prefix_fit_runs(t, hs, he, budget)
        um._migrate_in_runs(a, ks, ke)
        for s0, e0 in zip(ks, ke):
            a.pending.set_range(int(s0), int(e0), 0)
        a.pending_count -= int((ke - ks).sum())


@dataclass(frozen=True)
class ManagedPolicy(MemPolicy):
    """CUDA managed memory (cudaMallocManaged): fault-driven on-demand
    migration at ``migration_granule`` + speculative prefetch, LRU eviction
    under device pressure, thrash-mode remote reads when the touched working
    set cannot fit even after evicting every other managed page (§7)."""

    kind = "managed"
    evictable = True
    batched_charge = True  # only for extents batch_ready below certifies

    def batch_ready(self, um, a, p0, p1, actor):
        # ready only when on_access would be a no-op over the hull: no
        # far-tier pages to fault/migrate (GPU: host pages; CPU: device
        # pages), hence no thrash-mode check and no speculative prefetch
        if not super().batch_ready(um, a, p0, p1, actor):
            return False
        t = a.table
        far = Tier.HOST if actor is Actor.GPU else Tier.DEVICE
        if t.resident_pages(far) == 0:
            return True
        s, _ = t.runs_of(far, p0, p1)
        return len(s) == 0

    def on_first_touch(self, um, a, p0, p1, actor, n_unmapped, need_bytes):
        tr = um.prof.traffic()
        if actor is Actor.GPU:
            # managed: first-touch maps straight into the GPU page table
            granules = max(1, n_unmapped * a.table.page_size
                           // self.migration_granule)
            um._charge(um.hw.pte_init_cpu * granules)
            tr.pte_inits_gpu += n_unmapped
        else:
            um._charge(um.hw.pte_init_cpu * n_unmapped)
            tr.pte_inits_cpu += n_unmapped
        tier = actor.home_tier
        if tier is Tier.DEVICE and need_bytes > um.device_free():
            um._evict_lru(need_bytes - um.device_free(), exclude=a)
            if need_bytes > um.device_free():
                tier = Tier.HOST  # spill the remainder
        return tier

    def on_access(self, um, a, p0, p1, actor):
        t = a.table
        if actor is Actor.GPU:
            # fault-driven on-demand migration (+ speculative prefetch);
            # when the touched working set cannot fit even after evicting
            # every other managed page, the driver stops migrating and
            # serves remote reads (paper §7 Fig. 12)
            thrashing = False
            hs, he = t.runs_of(Tier.HOST, p0, p1)
            if len(hs):
                ws = int(t.span_bytes(hs, he).sum())
                evictable = sum(
                    o.table.resident_bytes(Tier.DEVICE)
                    for o in um.allocs.values()
                    if o is not a and not o.freed and o.table is not None
                    and o.policy.evictable)
                thrashing = ws > um.device_free() + evictable
            if len(hs) and not thrashing:
                tr = um.prof.traffic()
                gran_pages = max(1, self.migration_granule // t.page_size)
                # faulting granules: the host runs projected onto granule
                # space (overlaps/adjacency merged)
                gs, ge = union_runs(hs // gran_pages,
                                    (he - 1) // gran_pages + 1)
                nfaults = int((ge - gs).sum())
                tr.faults += nfaults
                um._charge(um.hw.page_fault_cost * nfaults)
                # speculative prefetch: each faulting granule drags in the
                # next `pf` granules — expand the granule runs and clip
                pf = self.speculative_prefetch
                if pf > 0:
                    gs, ge = union_runs(gs, ge + pf - 1)
                    gmax = t.num_pages // gran_pages + 1
                    ge = np.minimum(ge, gmax)
                    keep = gs < ge
                    ms = gs[keep] * gran_pages
                    me = np.minimum(ge[keep] * gran_pages, t.num_pages)
                    um._migrate_in_runs(a, ms, me)
            return thrashing
        # CPU touch of device-resident managed pages faults them back host
        ds_, de_ = t.runs_of(Tier.DEVICE, p0, p1)
        if len(ds_):
            tr = um.prof.traffic()
            n_dev = int((de_ - ds_).sum())
            gran_pages = max(1, self.migration_granule // t.page_size)
            gs, ge = union_runs(ds_ // gran_pages,
                                (de_ - 1) // gran_pages + 1)
            nfaults = int((ge - gs).sum())
            tr.faults += nfaults
            um._charge(um.hw.page_fault_cost * nfaults)
            nbytes = int(t.span_bytes(ds_, de_).sum())
            um._apply_delta(t.move_runs(ds_, de_, Tier.HOST))
            tr.migrated_out += nbytes
            tr.link_d2h += nbytes
            um._charge(nbytes / um.hw.link_d2h
                       + um.hw.migrate_per_page * n_dev)
        return False

    def on_pressure(self, um, a, need_bytes):
        um._evict_lru(need_bytes - um.device_free(), exclude=a)


@dataclass(frozen=True)
class ExplicitPolicy(MemPolicy):
    """cudaMalloc + cudaMemcpy: device-resident, no page table, explicit
    staged copies through a malloc'd host pair, OOM on oversubscription."""

    kind = "explicit"
    paged = False
    staged_transfers = True

    def on_alloc(self, um, name, nbytes):
        if nbytes > um.device_free():
            raise OutOfDeviceMemory(
                f"cudaMalloc({name}): {nbytes} > free {um.device_free()}")
        a = Allocation(name, nbytes, self, table=None,
                       device_bytes_explicit=nbytes)
        um._device_bytes += nbytes
        um._charge(um.hw.alloc_per_page * -(-nbytes // self.page_size))
        return a

    def on_free(self, um, a):
        um._device_bytes -= a.device_bytes_explicit
        um._charge(um.hw.dealloc_per_page *
                   -(-a.nbytes // self.migration_granule))

    def make_staging(self, um, buf):
        # the malloc half of the pair: paged like the application's system-
        # memory version (um.staging_page_size), never counter-migrated;
        # the base resolve_actor_side routes CPU actors to it
        return um.alloc(buf.name + "__host", buf.nbytes,
                        system_policy(um.staging_page_size,
                                      auto_migrate=False))


@dataclass(frozen=True)
class Mi300aUnifiedPolicy(MemPolicy):
    """AMD MI300A unified physical memory: CPU and GPU share one HBM3 pool
    and one page table. First touch maps (cheaply — no SMMU->OS round trip),
    nothing migrates, nothing is evicted, and access latency is uniform;
    exceeding the pool is a genuine OOM rather than graceful remote access.
    Pair with the ``MI300A`` :class:`~repro_torch.core.hardware.HardwareModel`,
    whose equal device/host/link bandwidths make the generic charge
    classification cost the same on either "side" of the single pool.
    ``migratable = False`` also turns the runtime's explicit migration
    APIs (prefetch/prefetch_async/demote) into placement no-ops: there is
    nowhere to move a page to."""

    kind = "mi300a_unified"
    migratable = False
    batched_charge = True  # on_access is the inherited no-op; batch_ready's
    # fully-mapped-hull check means the OOM-raising first touch cannot fire

    def on_first_touch(self, um, a, p0, p1, actor, n_unmapped, need_bytes):
        # OOM before any charge: a caller probing capacity must not record
        # PTE-init time/counters for pages that were never mapped
        if need_bytes > um.device_free():
            raise OutOfDeviceMemory(
                f"MI300A unified pool exhausted mapping {a.name}: "
                f"{need_bytes} > free {um.device_free()} "
                "(a single physical pool cannot oversubscribe)")
        # one shared OS page table: GPU and CPU first touch cost the same
        tr = um.prof.traffic()
        um._charge(um.hw.pte_init_cpu * n_unmapped)
        if actor is Actor.GPU:
            tr.pte_inits_gpu += n_unmapped
        else:
            tr.pte_inits_cpu += n_unmapped
        return Tier.DEVICE  # the one pool; tiers exist only as bookkeeping


def system_policy(page_size: int = 64 * KB, *, threshold: int = 256,
                  auto_migrate: bool = True,
                  max_migration_bytes_per_sync: int = 512 * MB) -> SystemPolicy:
    return SystemPolicy(
        page_size=page_size,
        migration_granule=max(page_size, 64 * KB),
        counter_threshold=threshold,
        auto_migrate=auto_migrate,
        max_migration_bytes_per_sync=max_migration_bytes_per_sync,
    )


def managed_policy(page_size: int = 64 * KB, *,
                   speculative_prefetch: int = 4) -> ManagedPolicy:
    # device-side pages are 2 MB (GPU-exclusive page table); host-side PTEs
    # use the system page size (alloc/dealloc/eviction costs)
    return ManagedPolicy(
        page_size=page_size,
        migration_granule=2 * MB,
        speculative_prefetch=speculative_prefetch,
    )


def explicit_policy() -> ExplicitPolicy:
    return ExplicitPolicy(page_size=2 * MB, migration_granule=2 * MB)


def mi300a_unified_policy(page_size: int = 64 * KB) -> Mi300aUnifiedPolicy:
    return Mi300aUnifiedPolicy(page_size=page_size,
                               migration_granule=page_size)


# legacy alias: PolicyConfig was the frozen config record the runtime
# branched on; the strategy base class subsumes it
PolicyConfig = MemPolicy
