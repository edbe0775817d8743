"""Fault-tolerant serving on the port (repro_torch.runtime.FaultPlan through
repro_torch.serve.TrafficSim and the cluster pool): the cases of
tests/test_fault_serve.py, node loss, lane degradation and spill failure,
each pinned to its fault-free run on the port and held against the JAX
sim's records, tokens, stats and clock on the micro model with the JAX
weights injected."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.runtime as jax_runtime
import repro.serve as jax_serve
import repro_torch.runtime as port_runtime
import repro_torch.serve as port_serve
from repro.configs.base import ArchConfig as JaxArchConfig
from repro.models import init_params as jax_init_params
from repro_torch.cluster import GH200_X2, device_free_on
from repro_torch.configs.base import ArchConfig
from repro_torch.core import Actor, UnifiedMemory, make_policy
from repro_torch.models import load_jax_params
from repro_torch.runtime import FailureInjector, FaultPlan, poisson_steps
from repro_torch.serve import (
    ArrivalProcess,
    LengthDist,
    Scenario,
    TenantSpec,
    TrafficSim,
)

KB = 1024
NBYTES = 512 * KB
CLUSTER_POLICIES = ("cluster_system", "cluster_striped")
MICRO_KW = dict(name="micro", family="dense", source="test", num_layers=1,
                d_model=32, num_heads=2, num_kv_heads=2, head_dim=16, d_ff=64,
                vocab_size=64)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The models here are tiny: one intra-op thread per process keeps
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def micro_pair():
    jcfg, cfg = JaxArchConfig(**MICRO_KW), ArchConfig(**MICRO_KW)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    model = load_jax_params(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    return {"micro": (jcfg, jparams)}, {"micro": (cfg, model)}


@pytest.fixture(scope="module")
def micro_model(micro_pair):
    return micro_pair[1]


def _scenario(mod, tight=False):
    """tests/test_fault_serve.py's micro scenario, or its preempting tight
    one, built from ``mod`` (the JAX or the port's serve package)."""
    if tight:
        tenant = dict(num_requests=8,
                      arrival=mod.ArrivalProcess("bursty", rate=4e5,
                                                 burst_size=8),
                      prompt=mod.LengthDist("pareto", lo=8, hi=20, alpha=1.4),
                      output=mod.LengthDist("lognormal", lo=4, hi=8, mean=6.0))
        shape = dict(max_seqs=3, num_pages=8)
    else:
        tenant = dict(num_requests=5,
                      arrival=mod.ArrivalProcess("poisson", rate=2e5),
                      prompt=mod.LengthDist("lognormal", lo=4, hi=24,
                                            mean=10.0),
                      output=mod.LengthDist("lognormal", lo=1, hi=8, mean=4.0))
        shape = dict(max_seqs=4, num_pages=None)
    return mod.Scenario(
        name="tight" if tight else "micro",
        tenants=tuple(mod.TenantSpec(name=f"t{i}", arch="micro", **tenant)
                      for i in range(2)),
        oversub=1.0, page_size=4, max_len=48, prefill_chunk=12,
        admit_device_fraction=0.5, **shape)


def _plan(mod, kind):
    return {"none": None,
            "empty": mod.FaultPlan(),
            "loss1": mod.FaultPlan.node_loss([(4, 1)]),
            "loss0": mod.FaultPlan.node_loss([(4, 0)]),
            "lane": mod.FaultPlan.lane_degrade(1, 8, nvlink_factor=0.1,
                                               fabric_factor=0.1),
            "spill": mod.FaultPlan.spill_failure(0, 10_000)}[kind]


# name -> (tight, seed, policy, hw, tp, plan): every run of the tests below
RUNS = {
    "base": (False, 3, "system", None, 1, "none"),
    "empty": (False, 3, "system", None, 1, "empty"),
    "clean-cluster_system": (False, 3, "cluster_system", "gh200_x2", 2, "none"),
    "clean-cluster_striped": (False, 3, "cluster_striped", "gh200_x2", 2,
                              "none"),
    "loss-cluster_system": (False, 3, "cluster_system", "gh200_x2", 2, "loss1"),
    "loss-cluster_striped": (False, 3, "cluster_striped", "gh200_x2", 2,
                             "loss0"),
    "lane": (False, 3, "cluster_system", "gh200_x2", 2, "lane"),
    "tight-clean": (True, 2, "system", None, 1, "none"),
    "tight-spill": (True, 2, "system", None, 1, "spill"),
}


def _sim(mod, runtime, models, name, **kw):
    tight, seed, policy, hw, tp, plan = RUNS[name]
    return mod.TrafficSim(_scenario(mod, tight), policy=policy, hw=hw,
                          seed=seed, models=models, tp=tp,
                          fault_plan=_plan(runtime, plan), **kw).run()


@pytest.fixture(scope="module")
def port_runs(micro_model):
    return {name: _sim(port_serve, port_runtime, micro_model, name,
                       device="cpu") for name in RUNS}


@pytest.fixture(scope="module")
def jax_runs(micro_pair):
    return {name: _sim(jax_serve, jax_runtime, micro_pair[0], name)
            for name in RUNS}


# -------------------------------------------------------------- the plan
def test_fault_plan_builders_sorted_and_deterministic():
    plan = FaultPlan.node_loss([(9, 1), (3, 0)]) \
        + FaultPlan.lane_degrade(5, 4, nvlink_factor=0.5) \
        + FaultPlan.spill_failure(1, 2)
    assert [e.step for e in plan.events] == [1, 3, 5, 9]
    assert bool(plan) and not bool(FaultPlan())
    p1 = FaultPlan.poisson(rate=0.05, seed=11, num_nodes=4, horizon=100)
    p2 = FaultPlan.poisson(rate=0.05, seed=11, num_nodes=4, horizon=100)
    assert p1.events == p2.events
    assert 1 <= len(p1.events) <= 3
    nodes = [e.node for e in p1.events]
    assert len(set(nodes)) == len(nodes)
    assert all(e.kind == "node_loss" for e in p1.events)
    steps = poisson_steps(rate=0.05, seed=11, horizon=100)
    assert [e.step for e in p1.events] == steps[:3]
    assert FailureInjector.poisson(rate=0.05, seed=11,
                                   horizon=100).fail_at_steps == set(steps)
    # the same schedules as the JAX package's
    jp = jax_runtime.FaultPlan.poisson(rate=0.05, seed=11, num_nodes=4,
                                       horizon=100)
    assert [dataclasses.asdict(e) for e in p1.events] == \
        [dataclasses.asdict(e) for e in jp.events]
    assert steps == jax_runtime.poisson_steps(rate=0.05, seed=11, horizon=100)


# ------------------------------------------------------------ runtime unit
@pytest.mark.parametrize("policy", CLUSTER_POLICIES)
def test_fail_node_poisons_pages_and_capacity(policy):
    um = UnifiedMemory(hw=GH200_X2)
    pol = make_policy(policy, page_size=4 * KB)
    a = um.alloc("x", NBYTES, pol)
    half = NBYTES // 2
    for k in (0, 1):
        with um.on_node(k):
            um.kernel(writes=[(a, k * half, (k + 1) * half)],
                      actor=Actor.GPU, name=f"init_n{k}")
    um.sync()
    free0 = um.device_free()
    lost = um.fail_node(1)
    assert "x" in lost and lost["x"]
    t = a.table
    assert int(t._tier_bytes[2 * 1 + 0 + 1]) == 0  # (1, HOST)
    assert int(t._tier_bytes[2 * 1 + 1 + 1]) == 0  # (1, DEVICE)
    assert device_free_on(um, 1) == 0
    assert um.device_free() < free0
    assert um.prof.extra["node_losses"] == 1
    assert um.prof.extra["lost_pages"] > 0
    assert um.prof.extra["lost_bytes"] > 0
    assert um._recompute_residency() == (um.host_bytes(), um.device_bytes())
    assert um.fail_node(1) == {}
    assert um.prof.extra["node_losses"] == 1
    um.free(a)


def test_lane_degradation_scales_charges():
    um = UnifiedMemory(hw=GH200_X2)
    pol = make_policy("cluster_system", page_size=4 * KB)
    a = um.alloc("x", NBYTES, pol)
    with um.on_node(1):
        um.kernel(writes=[(a, 0, NBYTES)], actor=Actor.GPU, name="init")
    t_clean = um.kernel(reads=[(a, 0, NBYTES)], actor=Actor.GPU, node=0,
                        name="far_clean")
    um.set_lane_degradation((0.25, 0.25))
    t_deg = um.kernel(reads=[(a, 0, NBYTES)], actor=Actor.GPU, node=0,
                      name="far_degraded")
    um.set_lane_degradation(None)
    t_back = um.kernel(reads=[(a, 0, NBYTES)], actor=Actor.GPU, node=0,
                       name="far_recovered")
    topo = um.hw.topology
    assert t_deg == pytest.approx(
        t_clean + NBYTES / (topo.nvlink_bw * 0.25) - NBYTES / topo.nvlink_bw,
        rel=1e-9)
    assert t_back == pytest.approx(t_clean, rel=1e-12)
    assert um.prof.extra["degraded_nvlink_bytes"] == NBYTES
    um.free(a)


# ------------------------------------------------------- port vs JAX sim
@pytest.mark.parametrize("name", sorted(RUNS))
def test_run_matches_jax_sim(port_runs, jax_runs, name):
    got, want = port_runs[name], jax_runs[name]
    assert got.tokens == want.tokens
    assert ([dataclasses.asdict(r) for r in got.records]
            == [dataclasses.asdict(r) for r in want.records])
    assert got.metrics == want.metrics
    pe, jpe = got.per_engine["micro"], want.per_engine["micro"]
    assert pe["clock"] == jpe["clock"]
    assert pe["stats"] == jpe["stats"]
    assert (pe["um_report"]["traffic_total"]
            == jpe["um_report"]["traffic_total"])
    assert (pe["um_report"]["traffic_extra"]
            == jpe["um_report"]["traffic_extra"])


# -------------------------------------------------- serve recovery (gate)
@pytest.mark.parametrize("policy", CLUSTER_POLICIES)
def test_node_loss_mid_decode_tokens_bit_identical(port_runs, policy):
    """A single-node loss mid-decode on gh200_x2 under TP-2: every request
    completes with the fault-free run's tokens, with replayed tokens and
    lost pages counted."""
    base, clean = port_runs["base"], port_runs[f"clean-{policy}"]
    faulted = port_runs[f"loss-{policy}"]
    assert faulted.tokens == base.tokens == clean.tokens
    assert all(r.done for r in faulted.records)
    stats = faulted.per_engine["micro"]["stats"]
    assert stats["node_losses"] == 1
    assert stats["recovered_requests"] > 0
    assert stats["replayed_tokens"] > 0
    extra = faulted.per_engine["micro"]["um_report"]["traffic_extra"]
    assert extra["lost_pages"] > 0 and extra["lost_bytes"] > 0
    assert stats["decode_tokens"] \
        > clean.per_engine["micro"]["stats"]["decode_tokens"]
    assert sum(r.recoveries for r in faulted.records) \
        == stats["recovered_requests"]


def test_lane_degrade_window_slows_but_preserves_tokens(port_runs):
    clean, deg = port_runs["clean-cluster_system"], port_runs["lane"]
    assert deg.tokens == clean.tokens
    assert all(r.done for r in deg.records)
    stats = deg.per_engine["micro"]["stats"]
    assert stats["lane_degraded_steps"] > 0
    assert stats["recovered_requests"] == 0
    extra = deg.per_engine["micro"]["um_report"]["traffic_extra"]
    assert extra["degraded_nvlink_bytes"] > 0
    assert deg.per_engine["micro"]["clock"] \
        > clean.per_engine["micro"]["clock"]


def test_spill_failure_window_recovers_by_recompute(port_runs):
    clean, spilled = port_runs["tight-clean"], port_runs["tight-spill"]
    assert clean.per_engine["micro"]["stats"]["preempted"] > 0
    assert spilled.tokens == clean.tokens
    assert all(r.done for r in spilled.records)
    stats = spilled.per_engine["micro"]["stats"]
    assert stats["spill_failures"] > 0
    assert stats["recovered_requests"] >= stats["spill_failures"]
    assert stats["replayed_tokens"] > 0


def test_fault_free_run_with_empty_plan_is_bit_identical(port_runs):
    a, b = port_runs["base"], port_runs["empty"]
    assert a.tokens == b.tokens
    assert a.per_engine["micro"]["clock"] == b.per_engine["micro"]["clock"]
    assert a.per_engine["micro"]["stats"] == b.per_engine["micro"]["stats"]


def test_fault_plan_needs_a_unified_memory(micro_model):
    """The engine refuses a plan it cannot deliver (no UnifiedMemory); the
    sim then passes none."""
    from repro_torch.serve import ServeEngine

    cfg, model = micro_model["micro"]
    with pytest.raises(ValueError, match="fault_plan needs"):
        ServeEngine(cfg, model, fault_plan=FaultPlan.node_loss([(1, 0)]),
                    device="cpu")
    res = TrafficSim(Scenario(name="s", tenants=(TenantSpec(
        name="t", arch="micro", num_requests=2,
        arrival=ArrivalProcess("poisson", rate=2e5),
        prompt=LengthDist("fixed", lo=4, hi=8, mean=6.0),
        output=LengthDist("fixed", lo=1, hi=4, mean=3.0)),), page_size=4,
        max_len=32), models=micro_model, use_um=False,
        fault_plan=FaultPlan.node_loss([(1, 0)]), device="cpu").run()
    assert res.metrics["completed"] == 2


# ------------------------------------------------------------- drain mode
def test_drain_mode_finishes_admitted_work_only(micro_model):
    from repro_torch.serve.engine import SeqState, ServeEngine

    cfg, params = micro_model["micro"]
    eng = ServeEngine(cfg, params, max_seqs=4, max_len=48, page_size=4,
                      um=UnifiedMemory(), prefill_chunk=12, device="cpu")
    rng = np.random.default_rng(0)
    first = [eng.add_request(rng.integers(1, 64, size=6), max_new_tokens=4)
             for _ in range(2)]
    eng.step()
    eng.start_drain()
    late = [eng.add_request(rng.integers(1, 64, size=6), max_new_tokens=4)
            for _ in range(2)]
    eng.run_to_completion()
    for rid in first:
        assert eng.requests[rid].done
        assert len(eng.requests[rid].generated) == 4
    for rid in late:
        r = eng.requests[rid]
        assert r.state is SeqState.PENDING and r.admit_time is None
