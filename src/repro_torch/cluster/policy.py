"""Cluster memory policies: node-aware placement over the distributed pool.

Two backends, both :class:`~repro_torch.core.policy.MemPolicy` strategy objects
registered through the standard registry (so ``--policy cluster_system``
works everywhere a policy name is accepted):

cluster_system  -> locality-first: first touch maps onto the toucher's own
                   superchip (device if that node has room, else its host
                   memory), like the single-node system backend seen from
                   each node. At N=1 this is placement-identical to a
                   single superchip.
cluster_striped -> capacity-first: GPU first touch stripes pages round-robin
                   across every node's device memory at ``stripe_pages``
                   granularity, trading inter-node NVLink traffic for an
                   N-times larger effective device pool (the "one logical
                   GPU" view of the cluster).

Page locations are ``(node, tier)`` encodings (pagetable.node_tier_loc).
Access charges classify every resident run as seen from the issuing node:

* same node, same side          -> local bytes (device_bw / host_bw)
* same node, far side           -> the NVLink-C2C link, exactly like the
                                   single-node remote path (h2d/d2h + the
                                   remote_* counters)
* other node's device memory    -> the inter-node NVLink lane
* other node's host memory      -> the inter-node fabric lane

Inter-node traffic is accumulated as exact integer ``(bytes, runs)`` lanes
and converted to seconds once per launch/item (lanes_time), so the
sequential and batched engines stay bit-identical; the byte totals land in
``prof.extra["internode_nvlink_bytes"/"internode_fabric_bytes"]`` — the
open-ended side-counter table — never in TrafficCounters, whose field set
the single-node parity fixture pins.

Neither backend uses access counters or fault-driven migration: placement
moves only through the explicit prefetch/demote APIs. ``on_demote`` spills
a node's device pages to the *next* node's host memory (the serve engine
preempts through this, keeping spilled KV pages one NVLink hop away), and
``on_migrate_in`` promotes toward the accessing node, paying the fabric
for cross-node sources. Both degenerate to the built-in single-node paths
when the table has one node, preserving N=1 bit-identity.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.pagetable import Actor, BlockTable, Tier, node_tier_loc
from repro_torch.core.policy import KB, Allocation, MemPolicy
from repro_torch.core.registry import register_policy
from repro_torch.core.runs import RunMap


def node_capacity(um) -> int:
    """Device bytes one superchip holds (single-node models: the device)."""
    return getattr(um.hw, "node_device_capacity", 0) or um.hw.device_capacity


def device_used_on(um, node: int) -> int:
    """Device bytes resident on ``node`` across live allocations (explicit
    device-resident blobs are pinned to node 0)."""
    k = 2 * node + 2  # counter index of (node, DEVICE)
    used = 0
    for a in um.allocs.values():
        if a.freed:
            continue
        if node == 0:
            used += a.device_bytes_explicit
        t = a.table
        if t is not None and k < t._nlocs:
            used += int(t._tier_bytes[k])
    return used


def device_free_on(um, node: int) -> int:
    if node in um._dead_nodes:  # lost capacity: nothing places here again
        return 0
    return node_capacity(um) - device_used_on(um, node)


def _lane_bw(um, topo):
    """Effective (nvlink_bw, fabric_bw) for the inter-node lanes. A
    fault-plan lane-degradation window multiplies the nominal numbers;
    the ``None`` fast path leaves the charge expressions untouched so
    fault-free runs stay bit-identical."""
    deg = um._lane_degrade
    if deg is None:
        return topo.nvlink_bw, topo.fabric_bw
    return topo.nvlink_bw * deg[0], topo.fabric_bw * deg[1]


@dataclass(frozen=True)
class ClusterPolicy(MemPolicy):
    """Shared node-aware machinery; subclasses pick the placement rule."""

    stripe_pages: int = 16  # striped backend: pages per round-robin stripe

    kind = "cluster"
    node_aware = True
    batched_charge = True  # on_access is the inherited no-op, so the
    # default fully-mapped-hull certification is exact
    migratable = True
    evictable = False

    # ------------------------------------------------------------ lifecycle
    def on_alloc(self, um, name: str, nbytes: int) -> Allocation:
        table = BlockTable(name, nbytes, self.page_size,
                           num_nodes=getattr(um.hw, "nodes", 1))
        a = Allocation(name, nbytes, self, table=table,
                       pending=RunMap(table.num_pages, 0, np.int8))
        um._charge(um.hw.alloc_per_page * min(table.num_pages, 64))
        return a

    def _charge_pte(self, um, actor: Actor, n_unmapped: int) -> None:
        tr = um.prof.traffic()
        if actor is Actor.GPU:
            um._charge(um.hw.pte_init_gpu * n_unmapped)
            tr.pte_inits_gpu += n_unmapped
        else:
            um._charge(um.hw.pte_init_cpu * n_unmapped)
            tr.pte_inits_cpu += n_unmapped

    # --------------------------------------------------------------- access
    def charge_access_runs(self, um, a, actor, is_write, ctx, rs, re_, rv,
                           rb, node):
        nlocs = a.table._nlocs
        lv = rv.astype(np.int64)
        bl = np.bincount(lv, weights=rb, minlength=nlocs).astype(np.int64)
        cl = np.bincount(lv, minlength=nlocs)
        tr = um.prof.traffic()
        dloc = 2 * node + 1
        hloc = 2 * node
        gpu = actor is Actor.GPU
        local = h2d = d2h = 0
        nvl_b = nvl_n = fab_b = fab_n = 0
        for L in range(nlocs - 1):  # every mapped (node, tier) location
            b = int(bl[L])
            r = int(cl[L])
            if r == 0:
                continue
            if L & 1:  # device-side location
                if L == dloc:
                    if gpu:
                        local += b
                        tr.device_local += b
                    else:  # CPU pulling its own GPU's memory over C2C
                        d2h += b
                        tr.link_d2h += b
                else:  # another node's device memory: inter-node NVLink
                    nvl_b += b
                    nvl_n += r
            else:  # host-side location
                if L == hloc:
                    if not gpu:
                        local += b
                        tr.host_local += b
                    elif is_write:
                        d2h += b
                        tr.link_d2h += b
                        tr.remote_d2h += b
                    else:
                        h2d += b
                        tr.link_h2d += b
                        tr.remote_h2d += b
                else:  # another node's host memory: inter-node fabric
                    fab_b += b
                    fab_n += r
        um.prof.extra["internode_nvlink_bytes"] += nvl_b
        um.prof.extra["internode_fabric_bytes"] += fab_b
        return local, h2d, d2h, 0, (nvl_b, nvl_n, fab_b, fab_n)

    def charge_access_batch_runs(self, um, a, gpu, wr, nodes, uloc, nb, nr):
        E = len(gpu)
        local = np.zeros(E, np.int64)
        h2d = np.zeros(E, np.int64)
        d2h = np.zeros(E, np.int64)
        lanes = np.zeros((E, 4), np.int64)
        tr = um.prof.traffic()
        dloc = 2 * nodes + 1
        hloc = 2 * nodes
        for c, L in enumerate(uloc.tolist()):
            b = nb[:, c]
            r = nr[:, c]
            if L & 1:  # device-side location
                mine = dloc == L
                m = mine & gpu
                local += np.where(m, b, 0)
                tr.device_local += int(b[m].sum())
                mc = mine & ~gpu
                d2h += np.where(mc, b, 0)
                tr.link_d2h += int(b[mc].sum())
                far = ~mine
                lanes[:, 0] += np.where(far, b, 0)
                lanes[:, 1] += np.where(far, r, 0)
            else:  # host-side location
                mine = hloc == L
                m = mine & ~gpu
                local += np.where(m, b, 0)
                tr.host_local += int(b[m].sum())
                mw = mine & gpu & wr
                d2h += np.where(mw, b, 0)
                s = int(b[mw].sum())
                tr.link_d2h += s
                tr.remote_d2h += s
                mr = mine & gpu & ~wr
                h2d += np.where(mr, b, 0)
                s = int(b[mr].sum())
                tr.link_h2d += s
                tr.remote_h2d += s
                far = ~mine
                lanes[:, 2] += np.where(far, b, 0)
                lanes[:, 3] += np.where(far, r, 0)
        um.prof.extra["internode_nvlink_bytes"] += int(lanes[:, 0].sum())
        um.prof.extra["internode_fabric_bytes"] += int(lanes[:, 2].sum())
        return local, h2d, d2h, np.zeros(E, np.int64), lanes

    def lanes_time(self, um, lanes) -> float:
        nvl_b, nvl_n, fab_b, fab_n = lanes
        if not (nvl_b or nvl_n or fab_b or fab_n):
            return 0.0
        topo = um.hw.topology
        if um._lane_degrade is None:
            # fixed association; lanes_time_batch applies the same expression
            return (nvl_b / topo.nvlink_bw + topo.nvlink_latency * nvl_n
                    + fab_b / topo.fabric_bw + topo.fabric_latency * fab_n)
        nvl_bw, fab_bw = _lane_bw(um, topo)
        um.prof.extra["degraded_nvlink_bytes"] += int(nvl_b)
        um.prof.extra["degraded_fabric_bytes"] += int(fab_b)
        return (nvl_b / nvl_bw + topo.nvlink_latency * nvl_n
                + fab_b / fab_bw + topo.fabric_latency * fab_n)

    def lanes_time_batch(self, um, lanes):
        topo = getattr(um.hw, "topology", None)
        if topo is None:  # N=1 run on a single-node model: lanes are zero
            return 0.0
        if um._lane_degrade is None:
            return (lanes[:, 0] / topo.nvlink_bw
                    + topo.nvlink_latency * lanes[:, 1]
                    + lanes[:, 2] / topo.fabric_bw
                    + topo.fabric_latency * lanes[:, 3])
        nvl_bw, fab_bw = _lane_bw(um, topo)
        um.prof.extra["degraded_nvlink_bytes"] += int(lanes[:, 0].sum())
        um.prof.extra["degraded_fabric_bytes"] += int(lanes[:, 2].sum())
        return (lanes[:, 0] / nvl_bw
                + topo.nvlink_latency * lanes[:, 1]
                + lanes[:, 2] / fab_bw
                + topo.fabric_latency * lanes[:, 3])

    # -------------------------------------------------- placement dispatch
    def on_demote(self, um, a, p0, p1):
        """Spill device-resident pages of [p0, p1) to host memory. On one
        node the built-in path already does exactly that; on a cluster each
        node's pages spill to the *next* node's host memory (ring order),
        so a preempting node frees its HBM without loading its own LPDDR."""
        t = a.table
        if t.num_nodes == 1:
            return None
        topo = um.hw.topology
        tr = um.prof.traffic()
        for k in range(t.num_nodes):
            ds_, de_ = t.runs_of(2 * k + 1, p0, p1)
            if len(ds_) == 0:
                continue
            nbytes = int(t.span_bytes(ds_, de_).sum())
            npages = int((de_ - ds_).sum())
            dst = (k + 1) % t.num_nodes
            while dst != k and dst in um._dead_nodes:
                dst = (dst + 1) % t.num_nodes  # ring-skip lost nodes
            um._apply_delta(t.move_runs(ds_, de_, 2 * dst))
            t.clear_dirty(ds_, de_)
            tr.migrated_out += nbytes
            tr.link_d2h += nbytes
            um._charge(nbytes / um.hw.link_d2h
                       + um.hw.migrate_per_page * npages)
            # the cross-node hop rides the fabric on top of the C2C push
            fab_bw = _lane_bw(um, topo)[1]
            um._charge(nbytes / fab_bw
                       + topo.fabric_latency * len(ds_))
            um.prof.extra["internode_fabric_bytes"] += nbytes
            if um._lane_degrade is not None:
                um.prof.extra["degraded_fabric_bytes"] += nbytes
        return 0.0

    def on_migrate_in(self, um, a, starts, ends):
        """Promote host-resident pages of the spans toward the accessing
        node's device memory, paying the fabric for cross-node sources."""
        t = a.table
        if t.num_nodes == 1:
            return None
        d = int(um._node)
        topo = um.hw.topology
        tr = um.prof.traffic()
        migrated = 0
        free = device_free_on(um, d)
        for k in range(t.num_nodes):
            hs, he = [], []
            for s0, e0 in zip(starts, ends):
                rs, re_ = t.runs_of(2 * k, int(s0), int(e0))
                hs.append(rs)
                he.append(re_)
            hs = np.concatenate(hs) if hs else np.empty(0, np.int64)
            he = np.concatenate(he) if he else np.empty(0, np.int64)
            if len(hs) == 0:
                continue
            need = int(t.span_bytes(hs, he).sum())
            if need > free:  # no eviction: prefix-fit what the node holds
                hs, he = um._prefix_fit_runs(t, hs, he, free)
                if len(hs) == 0:
                    continue
                need = int(t.span_bytes(hs, he).sum())
                if need == 0:
                    continue
            um._apply_delta(t.move_runs(hs, he, 2 * d + 1))
            free -= need
            npages = int((he - hs).sum())
            tr.migrated_in += need
            tr.link_h2d += need
            um._charge(need / um.hw.link_h2d
                       + um.hw.migrate_per_page * npages)
            if k != d:  # source host memory sits on another node
                fab_bw = _lane_bw(um, topo)[1]
                um._charge(need / fab_bw
                           + topo.fabric_latency * len(hs))
                um.prof.extra["internode_fabric_bytes"] += need
                if um._lane_degrade is not None:
                    um.prof.extra["degraded_fabric_bytes"] += need
            migrated += need
        return migrated


@dataclass(frozen=True)
class ClusterSystemPolicy(ClusterPolicy):
    """Locality-first: each node first-touches into its own superchip."""

    kind = "cluster_system"

    def on_first_touch(self, um, a, p0, p1, actor, n_unmapped, need_bytes):
        self._charge_pte(um, actor, n_unmapped)
        d = um._node
        if actor is Actor.GPU and need_bytes <= device_free_on(um, d):
            return node_tier_loc(d, Tier.DEVICE)
        return node_tier_loc(d, Tier.HOST)


@dataclass(frozen=True)
class ClusterStripedPolicy(ClusterPolicy):
    """Capacity-first: GPU first touch stripes pages round-robin across
    every node's device memory (``stripe_pages`` pages per stripe), falling
    back per node to that node's host memory when its device is full. CPU
    first touch stays node-local host, like the locality backend."""

    kind = "cluster_striped"

    def on_first_touch(self, um, a, p0, p1, actor, n_unmapped, need_bytes):
        self._charge_pte(um, actor, n_unmapped)
        t = a.table
        d = um._node
        if actor is not Actor.GPU:
            return node_tier_loc(d, Tier.HOST)
        nn = t.num_nodes
        if nn == 1:
            if need_bytes <= device_free_on(um, d):
                return node_tier_loc(d, Tier.DEVICE)
            return node_tier_loc(d, Tier.HOST)
        sp = max(1, self.stripe_pages)
        free = {k: device_free_on(um, k) for k in range(nn)}
        # stripe only over surviving nodes; with none dead this reduces to
        # the original (b // sp) % nn round-robin
        alive = [k for k in range(nn) if k not in um._dead_nodes]
        us, ue = t.runs_of(Tier.UNMAPPED, p0, p1)
        for s0, e0 in zip(us, ue):
            b = int(s0)
            e0 = int(e0)
            while b < e0:
                nxt = min(e0, (b // sp + 1) * sp)
                k = alive[(b // sp) % len(alive)]
                nbytes = t.range_bytes(b, nxt)
                if nbytes <= free[k]:
                    um._apply_delta(
                        t.map_unmapped(b, nxt, node_tier_loc(k, Tier.DEVICE)))
                    free[k] -= nbytes
                else:
                    um._apply_delta(
                        t.map_unmapped(b, nxt, node_tier_loc(k, Tier.HOST)))
                b = nxt
        # everything in [p0, p1) is mapped now; the caller's map_unmapped
        # with this return value is a no-op
        return node_tier_loc(d, Tier.HOST)


def cluster_system_policy(page_size: int = 64 * KB) -> ClusterSystemPolicy:
    return ClusterSystemPolicy(
        page_size=page_size,
        migration_granule=max(page_size, 64 * KB),
        auto_migrate=False,  # no access counters: placement moves only
        # through the explicit prefetch/demote APIs
    )


def cluster_striped_policy(page_size: int = 64 * KB, *,
                           stripe_pages: int = 16) -> ClusterStripedPolicy:
    return ClusterStripedPolicy(
        page_size=page_size,
        migration_granule=max(page_size, 64 * KB),
        auto_migrate=False,
        stripe_pages=stripe_pages,
    )


register_policy("cluster_system", cluster_system_policy)
register_policy("cluster_striped", cluster_striped_policy)
