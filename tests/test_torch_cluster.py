"""The port's cluster subsystem (src/repro_torch/cluster/, a copy of
src/repro/cluster/): the cases of tests/test_cluster.py on the port, and
the TP serving cases held against the JAX sim on the micro model with the
JAX weights injected.

* **(node, tier) encoding**, **node-aware placement**, **ring spill /
  promote**, **striped capacity**, **batch == sequential**: as in
  tests/test_cluster.py, on the port's copy of the charge model, with each
  charge also equal to the JAX package's on the same op stream.
* **TP serving acceptance**: a TP-2 serve run on gh200_x2 gives the tokens
  of the single-node run of the same schedule, with nonzero inter-node
  traffic, and the JAX sim's records, clock and counters.

Trace replay under a cluster backend waits for the port's ``core/trace.py``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.cluster as jax_cluster
import repro.core as jax_core
import repro.serve as jax_serve
import repro_torch.serve as port_serve
from repro.configs.base import ArchConfig as JaxArchConfig
from repro.models import init_params as jax_init_params
from repro_torch.cluster import (
    GH200_X2,
    GH200_X4,
    ClusterTPPlan,
    device_free_on,
    device_used_on,
    gh200_cluster,
)
from repro_torch.configs.base import ArchConfig
from repro_torch.core import (
    GRACE_HOPPER,
    Actor,
    Tier,
    UnifiedMemory,
    available_hardware,
    available_policies,
    get_hardware,
    make_policy,
)
from repro_torch.core.pagetable import loc_node, loc_tier, node_tier_loc
from repro_torch.models import load_jax_params
from repro_torch.serve import TrafficSim

KB = 1024
MB = 1024 * KB
NBYTES = 512 * KB

CLUSTER_POLICIES = ("cluster_system", "cluster_striped")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The models here are tiny: one intra-op thread per process keeps
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pol(name, **kw):
    return make_policy(name, page_size=4 * KB, **kw)


def test_registry_matches_jax():
    """Importing the port's core registers the cluster backends and
    hardware, as the JAX package's does."""
    assert available_policies() == jax_core.available_policies()
    # the port registers one model more: the H100 SXM of its roofline
    assert available_hardware() == tuple(sorted(
        jax_core.available_hardware() + ("h100-sxm",)))
    for name in ("gh200_x2", "gh200_x4"):
        assert dataclasses.asdict(get_hardware(name)) == \
            dataclasses.asdict(jax_core.get_hardware(name))
    for name in CLUSTER_POLICIES:
        assert dataclasses.asdict(_pol(name)) == dataclasses.asdict(
            jax_core.make_policy(name, page_size=4 * KB))
    assert dataclasses.asdict(gh200_cluster(3, node_device_capacity=64 * MB)) \
        == dataclasses.asdict(jax_cluster.gh200_cluster(
            3, node_device_capacity=64 * MB))


# ----------------------------------------------------------- (node, tier)
def test_node_tier_encoding_roundtrip():
    for node in range(8):
        for tier in (Tier.HOST, Tier.DEVICE):
            loc = node_tier_loc(node, tier)
            assert loc_node(loc) == node
            assert loc_tier(loc) is tier
    # N=1 degeneracy: node-0 encodings ARE the plain Tier ints, so every
    # single-node table, trace and parity snapshot is unchanged
    assert node_tier_loc(0, Tier.HOST) == int(Tier.HOST)
    assert node_tier_loc(0, Tier.DEVICE) == int(Tier.DEVICE)


def test_cluster_hardware_models():
    assert GH200_X2.nodes == 2 and GH200_X4.nodes == 4
    assert GH200_X2.name == "gh200_x2"
    assert GH200_X2.node_device_capacity == GRACE_HOPPER.device_capacity
    assert GH200_X2.device_capacity == 2 * GRACE_HOPPER.device_capacity
    # registered like any other hardware model
    assert {"gh200_x2", "gh200_x4"} <= set(available_hardware())
    assert get_hardware("gh200_x4").nodes == 4
    # capacity override keeps the per-node split consistent (oversub
    # harnesses shrink capacity through this)
    hw = GH200_X4.with_device_capacity(10 * MB)
    assert hw.device_capacity == hw.nodes * hw.node_device_capacity
    assert hw.device_capacity >= 10 * MB
    custom = gh200_cluster(3, node_device_capacity=64 * MB)
    assert custom.nodes == 3 and custom.device_capacity == 3 * 64 * MB


# ------------------------------------------------------ placement + lanes
def test_first_touch_lands_on_touching_node():
    um = UnifiedMemory(hw=GH200_X2)
    a = um.alloc("x", NBYTES, _pol("cluster_system"))
    with um.on_node(1):
        um.kernel(writes=[(a, 0, NBYTES)], actor=Actor.GPU, name="init")
    t = a.table
    assert int(t._tier_bytes[node_tier_loc(1, Tier.DEVICE) + 1]) == NBYTES
    assert device_used_on(um, 1) == NBYTES and device_used_on(um, 0) == 0
    assert device_free_on(um, 1) == GRACE_HOPPER.device_capacity - NBYTES


def test_cross_node_read_charges_nvlink_lane():
    um = UnifiedMemory(hw=GH200_X2)
    a = um.alloc("x", NBYTES, _pol("cluster_system"))
    with um.on_node(1):
        um.kernel(writes=[(a, 0, NBYTES)], actor=Actor.GPU, name="init")
    t_local = um.kernel(reads=[(a, 0, NBYTES)], actor=Actor.GPU, node=1,
                        name="local")
    t_far = um.kernel(reads=[(a, 0, NBYTES)], actor=Actor.GPU, node=0,
                      name="far")
    assert um.prof.extra["internode_nvlink_bytes"] == NBYTES
    assert um.prof.extra["internode_fabric_bytes"] == 0
    # the remote read swaps local HBM streaming for the inter-node link
    # (same fixed launch overhead, so the delta is exactly the lane cost)
    assert t_far > t_local
    topo = um.hw.topology
    assert t_far == pytest.approx(
        t_local - NBYTES / um.hw.device_bw
        + NBYTES / topo.nvlink_bw + topo.nvlink_latency, rel=1e-9)


def test_remote_host_read_charges_fabric_lane():
    um = UnifiedMemory(hw=GH200_X2)
    a = um.alloc("x", NBYTES, _pol("cluster_system"))
    with um.on_node(1):
        um.kernel(writes=[(a, 0, NBYTES)], actor=Actor.CPU, name="init")
    assert int(a.table._tier_bytes[node_tier_loc(1, Tier.HOST) + 1]) == NBYTES
    um.kernel(reads=[(a, 0, NBYTES)], actor=Actor.GPU, node=0, name="far")
    assert um.prof.extra["internode_fabric_bytes"] == NBYTES
    assert um.prof.extra["internode_nvlink_bytes"] == 0


def test_demote_spills_to_next_nodes_host_over_fabric():
    um = UnifiedMemory(hw=GH200_X2)
    a = um.alloc("x", NBYTES, _pol("cluster_system"))
    with um.on_node(1):
        um.kernel(writes=[(a, 0, NBYTES)], actor=Actor.GPU, name="init")
    um.demote(a, 0, NBYTES)
    t = a.table
    # ring order: node 1's device pages land in node 0's host memory,
    # one NVLink-C2C push plus a fabric hop
    assert int(t._tier_bytes[node_tier_loc(0, Tier.HOST) + 1]) == NBYTES
    assert device_used_on(um, 1) == 0
    assert um.prof.extra["internode_fabric_bytes"] == NBYTES
    assert um.report()["traffic_total"]["migrated_out"] == NBYTES
    # promote back toward the accessing node: node 1 pulls it home
    with um.on_node(1):
        um.prefetch(a, 0, NBYTES)
    assert int(t._tier_bytes[node_tier_loc(1, Tier.DEVICE) + 1]) == NBYTES
    assert um.prof.extra["internode_fabric_bytes"] == 2 * NBYTES
    assert um.report()["traffic_total"]["migrated_in"] == NBYTES


def test_striped_backend_distributes_device_pages():
    um = UnifiedMemory(hw=GH200_X4)
    total = 16 * MB
    a = um.alloc("big", total, _pol("cluster_striped"))
    um.kernel(writes=[(a, 0, total)], actor=Actor.GPU, name="init")
    per_node = [device_used_on(um, k) for k in range(4)]
    assert per_node == [total // 4] * 4, per_node
    # the striping write itself already pushed 3/4 of the bytes to other
    # nodes' devices over NVLink...
    assert um.prof.extra["internode_nvlink_bytes"] == 3 * total // 4
    # ...and reading it all back from node 0 pulls the same 3/4 again
    um.kernel(reads=[(a, 0, total)], actor=Actor.GPU, node=0, name="r")
    assert um.prof.extra["internode_nvlink_bytes"] == 2 * (3 * total // 4)


def test_cluster_policies_have_no_access_counters():
    for name in CLUSTER_POLICIES:
        p = _pol(name)
        assert p.node_aware and p.migratable and not p.auto_migrate


# ------------------------------------------------------ batch == sequential
@pytest.mark.parametrize("policy", CLUSTER_POLICIES)
@pytest.mark.parametrize("hw", ["gh200_x2", "gh200_x4"])
def test_batch_matches_sequential(policy, hw):
    """The vectorized launch engine charges cluster runs bit-identically
    to the one-kernel-at-a-time loop — per-launch seconds, the clock, the
    traffic report and the inter-node side counters."""

    def ops(n_nodes):
        rng = np.random.default_rng(7)
        out = []
        for i in range(24):
            lo = int(rng.integers(0, NBYTES - 1)) & ~0xFFF
            hi = min(NBYTES, lo + int(rng.integers(1, NBYTES // 3)))
            actor = Actor.GPU if rng.integers(2) else Actor.CPU
            rd, wr = ([], [(lo, hi)]) if rng.integers(2) else ([(lo, hi)], [])
            out.append((f"k{i}", rd, wr, 0.0, actor,
                        int(rng.integers(n_nodes))))
        return out

    def build(h):
        um = UnifiedMemory(hw=get_hardware(h))
        a = um.alloc("x", NBYTES, _pol(policy))
        # established placement: every node touched its own slice first
        nn = um.hw.nodes
        for k in range(nn):
            um.kernel(writes=[(a, k * (NBYTES // nn),
                               (k + 1) * (NBYTES // nn))],
                      actor=Actor.GPU, node=k, name=f"init{k}")
        um.sync()
        return um, a

    um_s, a_s = build(hw)
    seq = [um_s.kernel(reads=[(a_s, lo, hi) for lo, hi in rd],
                       writes=[(a_s, lo, hi) for lo, hi in wr],
                       flops=fl, actor=ac, node=nd, name=nm)
           for nm, rd, wr, fl, ac, nd in ops(um_s.hw.nodes)]

    um_b, a_b = build(hw)
    bat = um_b.kernel_batch([
        (nm, [(a_b, lo, hi) for lo, hi in rd],
         [(a_b, lo, hi) for lo, hi in wr], fl, ac, nd)
        for nm, rd, wr, fl, ac, nd in ops(um_b.hw.nodes)])

    assert seq == list(bat)  # bit-identical, not approx
    assert um_s.clock == um_b.clock
    assert dict(um_s.prof.extra) == dict(um_b.prof.extra)
    assert um_s.report()["traffic_total"] == um_b.report()["traffic_total"]

    # the JAX package's charge model, on the same op stream
    jum = jax_core.UnifiedMemory(hw=jax_core.get_hardware(hw))
    ja = jum.alloc("x", NBYTES, jax_core.make_policy(policy, page_size=4 * KB))
    nn = jum.hw.nodes
    for k in range(nn):
        jum.kernel(writes=[(ja, k * (NBYTES // nn), (k + 1) * (NBYTES // nn))],
                   actor=jax_core.Actor.GPU, node=k, name=f"init{k}")
    jum.sync()
    jseq = [jum.kernel(reads=[(ja, lo, hi) for lo, hi in rd],
                       writes=[(ja, lo, hi) for lo, hi in wr], flops=fl,
                       actor=jax_core.Actor(int(ac)), node=nd, name=nm)
            for nm, rd, wr, fl, ac, nd in ops(nn)]
    assert seq == jseq and um_s.clock == jum.clock
    assert dict(um_s.prof.extra) == dict(jum.prof.extra)
    assert um_s.report()["traffic_total"] == jum.report()["traffic_total"]


# --------------------------------------------------------------- TP plan
def test_tp_plan_allreduce_bytes():
    class Cfg:
        num_layers = 4
        d_model = 128

    assert ClusterTPPlan(1).allreduce_bytes_per_token(Cfg()) == 0
    b2 = ClusterTPPlan(2).allreduce_bytes_per_token(Cfg())
    # 2 all-reduces/layer * 4 layers * (2*(N-1)/N = 1) * 128 * 4B
    assert b2 == 2 * 4 * 128 * 4
    b4 = ClusterTPPlan(4).allreduce_bytes_per_token(Cfg())
    assert b4 == int(2 * 4 * 1.5 * 128 * 4)
    assert ClusterTPPlan(4).node_of_seq(6) == 2
    for tp in (1, 2, 4):
        mine, theirs = ClusterTPPlan(tp), jax_cluster.ClusterTPPlan(tp)
        assert mine.ranks() == theirs.ranks()
        assert [mine.node_of_seq(s) for s in range(8)] == \
            [theirs.node_of_seq(s) for s in range(8)]
    assert ClusterTPPlan(4).without_node(2).ranks() == \
        jax_cluster.ClusterTPPlan(4).without_node(2).ranks()


# ------------------------------------------------- TP serving (acceptance)
MICRO_KW = dict(name="micro", family="dense", source="test", num_layers=1,
                d_model=32, num_heads=2, num_kv_heads=2, head_dim=16, d_ff=64,
                vocab_size=64)


@pytest.fixture(scope="module")
def micro_pair():
    jcfg, cfg = JaxArchConfig(**MICRO_KW), ArchConfig(**MICRO_KW)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    model = load_jax_params(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    return {"micro": (jcfg, jparams)}, {"micro": (cfg, model)}


@pytest.fixture(scope="module")
def micro_model(micro_pair):
    return micro_pair[1]


def _micro_scenario(oversub=1.0, mod=port_serve):
    """tests/test_cluster.py's micro scenario, built from ``mod`` (the
    port's or the JAX serve package)."""
    return mod.Scenario(
        name="micro",
        tenants=tuple(mod.TenantSpec(
            name=f"t{i}", arch="micro", num_requests=5,
            arrival=mod.ArrivalProcess("poisson", rate=2e5),
            prompt=mod.LengthDist("lognormal", lo=4, hi=24, mean=10.0),
            output=mod.LengthDist("lognormal", lo=1, hi=8, mean=4.0))
            for i in range(2)),
        oversub=oversub, page_size=4, max_seqs=4, max_len=48,
        prefill_chunk=12, num_pages=None, admit_device_fraction=0.5)


@pytest.fixture(scope="module")
def jax_tp_runs(micro_pair):
    jmodels = micro_pair[0]
    sc = _micro_scenario(mod=jax_serve)
    runs = {"base": jax_serve.TrafficSim(sc, policy="system", seed=3,
                                         models=jmodels).run()}
    for policy in CLUSTER_POLICIES:
        runs[policy] = jax_serve.TrafficSim(sc, policy=policy, hw="gh200_x2",
                                            seed=3, models=jmodels,
                                            tp=2).run()
    return runs


@pytest.mark.parametrize("policy", CLUSTER_POLICIES)
def test_tp_serve_tokens_match_single_node(micro_model, jax_tp_runs, policy):
    """A TP-2 serve run on the two-superchip model generates the tokens of
    the single-node run of the same schedule, with real inter-node traffic;
    its records, clock and counters are the JAX sim's."""
    sc = _micro_scenario()
    base = TrafficSim(sc, policy="system", seed=3, models=micro_model,
                      device="cpu").run()
    tp2 = TrafficSim(sc, policy=policy, hw="gh200_x2", seed=3,
                     models=micro_model, tp=2, device="cpu").run()
    assert tp2.tokens == base.tokens
    extra = tp2.per_engine["micro"]["um_report"]["traffic_extra"]
    assert extra["tp_allreduce_bytes"] > 0
    assert extra["internode_nvlink_bytes"] > 0
    assert tp2.per_engine["micro"]["clock"] > base.per_engine["micro"]["clock"]
    for got, want in ((base, jax_tp_runs["base"]),
                      (tp2, jax_tp_runs[policy])):
        assert got.tokens == want.tokens
        assert [dataclasses.asdict(r) for r in got.records] == \
            [dataclasses.asdict(r) for r in want.records]
        pe, jpe = got.per_engine["micro"], want.per_engine["micro"]
        assert pe["clock"] == jpe["clock"] and pe["stats"] == jpe["stats"]
        assert (pe["um_report"]["traffic_extra"]
                == jpe["um_report"]["traffic_extra"])


def test_tp_serve_is_deterministic(micro_model):
    runs = [TrafficSim(_micro_scenario(1.5), policy="cluster_system",
                       hw="gh200_x2", seed=5, models=micro_model, tp=2,
                       device="cpu").run() for _ in range(2)]
    assert runs[0].tokens == runs[1].tokens
    assert (runs[0].per_engine["micro"]["clock"]
            == runs[1].per_engine["micro"]["clock"])
