"""Production traffic harness: arrival processes, tenants, scenario presets
(the port of ``repro.serve.traffic``).

Drives the port's model stack (chunked prefill + the hand-written CUDA
paged-attention decode kernel) through :class:`ServeEngine` over the
UM-backed KV pool under *realistic* load instead of a fixed sweep, on the
CUDA card unless the caller passes ``device="cpu"``:

* **Arrival processes** — seeded Poisson, bursty (Poisson burst starts,
  near-simultaneous arrivals within a burst) and uniform spacing, all in
  modeled seconds against the engine clock (``engine.now()``).
* **Heavy-tail lengths** — lognormal / bounded-Pareto prompt and output
  length distributions (the paper-adjacent serving reality: most requests
  short, a fat tail of long ones).
* **Multi-tenant mixes** — each :class:`TenantSpec` names a model config
  from ``repro_torch.configs``; tenants sharing a config share one engine
  (continuous batching across tenants), different configs get independent
  engines over the same virtual timebase. SLO metrics come back per
  tenant (serve/metrics.py).
* **Scenario presets** — ``steady`` / ``burst`` / ``oversubscribed``
  (:data:`SCENARIOS`), each runnable under any registered memory-policy
  backend (the policy registry) via ``TrafficSim(scenario, policy=...)``.

Everything is seeded: the schedule (arrival times, prompt token ids,
output lengths) is generated up front from ``np.random.default_rng([seed,
tenant_index])``, and the engine charges are a deterministic function of
the schedule — so a same-seed run reproduces token streams AND SLO
metrics bit-for-bit (tests/test_torch_traffic.py pins this).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import UnifiedMemory, get_hardware, make_policy
from repro_torch.kernels.common import resolve_device
from repro_torch.models.cache import kv_head_layout
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.metrics import RequestRecord, collect, summarize
from repro_torch.serve.paged import PagedKVCache


# --------------------------------------------------------------- arrivals
@dataclass(frozen=True)
class ArrivalProcess:
    """Seeded arrival-time generator (modeled seconds).

    kind='poisson': exponential inter-arrivals at ``rate`` req/s.
    kind='bursty' : burst *starts* are Poisson at ``rate / burst_size``;
                    each burst delivers ``burst_size`` requests spread by
                    exponential jitter at scale ``burst_spread`` — the
                    near-simultaneous arrival spikes that force queueing
                    and preemption however generous the mean rate is.
    kind='uniform': deterministic spacing ``1 / rate``.
    """
    kind: str = "poisson"
    rate: float = 100.0
    burst_size: int = 8
    burst_spread: float = 1e-6

    def times(self, rng: np.random.Generator, n: int) -> np.ndarray:
        if self.kind == "poisson":
            return np.cumsum(rng.exponential(1.0 / self.rate, n))
        if self.kind == "uniform":
            return (1.0 + np.arange(n, dtype=np.float64)) / self.rate
        if self.kind == "bursty":
            nb = -(-n // self.burst_size)
            starts = np.cumsum(
                rng.exponential(self.burst_size / self.rate, nb))
            jitter = np.cumsum(
                rng.exponential(self.burst_spread, (nb, self.burst_size)),
                axis=1)
            return (starts[:, None] + jitter).reshape(-1)[:n]
        raise ValueError(f"unknown arrival kind {self.kind!r}")


# ---------------------------------------------------------------- lengths
@dataclass(frozen=True)
class LengthDist:
    """Heavy-tail (or fixed) integer length sampler, clipped to [lo, hi].

    kind='lognormal': mean ``mean`` (pre-clip), shape ``sigma``.
    kind='pareto'   : bounded Pareto starting at ``lo``, tail ``alpha``.
    kind='fixed'    : every sample is ``mean``.
    """
    kind: str = "lognormal"
    lo: int = 1
    hi: int = 64
    mean: float = 16.0
    sigma: float = 0.8
    alpha: float = 1.5

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        if self.kind == "lognormal":
            mu = np.log(self.mean) - 0.5 * self.sigma ** 2
            raw = rng.lognormal(mu, self.sigma, n)
        elif self.kind == "pareto":
            raw = self.lo * (1.0 + rng.pareto(self.alpha, n))
        elif self.kind == "fixed":
            raw = np.full(n, float(self.mean))
        else:
            raise ValueError(f"unknown length kind {self.kind!r}")
        return np.clip(np.rint(raw).astype(np.int64), self.lo, self.hi)


# ---------------------------------------------------------------- tenants
@dataclass(frozen=True)
class TenantSpec:
    """One traffic class: which model it hits, how it arrives, how long
    its prompts/outputs are. Tenants with the same ``arch`` share an
    engine (continuous batching across tenants)."""
    name: str
    arch: str
    num_requests: int
    arrival: ArrivalProcess = ArrivalProcess()
    prompt: LengthDist = LengthDist(lo=4, hi=48, mean=14.0)
    output: LengthDist = LengthDist(lo=1, hi=16, mean=6.0)


@dataclass(frozen=True)
class Scenario:
    """A named preset: tenant mix + engine/pool shape + oversubscription.

    ``oversub`` > 1 shrinks the modeled device capacity to ``pool_bytes /
    oversub`` (the fig11 methodology applied to serving); the overflow KV
    lives host-side under migratable backends.
    """
    name: str
    tenants: Tuple[TenantSpec, ...]
    oversub: float = 1.0
    page_size: int = 8
    max_seqs: int = 8
    max_len: int = 96
    prefill_chunk: int = 32
    num_pages: Optional[int] = None  # per-engine pool override
    # device-pressure admission gate (engine admit_device_fraction); 0
    # disables it — the oversubscribed preset does, so admitted KV really
    # exceeds capacity and first-touch spills host-side (fig11 style)
    # instead of the gate serializing the engine into an in-memory run
    admit_device_fraction: float = 0.5
    description: str = ""


# ---------------------------------------------------------------- presets
# Tuned against the reduced() configs' modeled charge scale: a KV pool page
# is KBs and the modeled link streams GB/s, so an engine step is ~us of
# modeled time — rates are accordingly high to create genuine contention.
_ARCHS = ("yi-6b", "qwen2.5-32b", "olmoe-1b-7b")


def steady(scale: float = 1.0) -> Scenario:
    n = max(2, int(8 * scale))
    return Scenario(
        name="steady",
        description="Poisson arrivals at moderate load, three model "
                    "configs (dense GQA, dense, MoE), heavy-tail lengths",
        tenants=tuple(
            TenantSpec(name=f"t{i}_{arch}", arch=arch, num_requests=n,
                       arrival=ArrivalProcess("poisson", rate=2e5),
                       prompt=LengthDist("lognormal", lo=4, hi=40, mean=12.0),
                       output=LengthDist("lognormal", lo=1, hi=12, mean=5.0))
            for i, arch in enumerate(_ARCHS)),
        max_seqs=6, max_len=64, prefill_chunk=24)


def burst(scale: float = 1.0) -> Scenario:
    n = max(6, int(12 * scale))
    return Scenario(
        name="burst",
        description="On/off bursts (8 near-simultaneous arrivals) against "
                    "a slot- and pool-limited engine: queueing delay plus "
                    "preempt/swap churn under the spikes",
        tenants=tuple(
            TenantSpec(name=f"t{i}_{arch}", arch=arch, num_requests=n,
                       arrival=ArrivalProcess("bursty", rate=4e5,
                                              burst_size=8),
                       prompt=LengthDist("pareto", lo=16, hi=40, alpha=1.4),
                       output=LengthDist("lognormal", lo=6, hi=12,
                                         mean=10.0))
            for i, arch in enumerate(_ARCHS)),
        # 10 pages backs the longest single sequence (40+12 tokens = 7
        # pages) but NOT a burst-load batch of them: admission lazily
        # overcommits the pool, so the decode batch outgrows it and the
        # youngest sequences preempt/swap and resume to drain the burst
        max_seqs=4, max_len=64, prefill_chunk=16, num_pages=10)


def oversubscribed(scale: float = 1.0) -> Scenario:
    n = max(6, int(12 * scale))
    return Scenario(
        name="oversubscribed",
        description="KV pool 1.5x the modeled device capacity with the "
                    "pressure gate off: decode reads remote KV pages, "
                    "migratable backends keep serving",
        tenants=tuple(
            TenantSpec(name=f"t{i}_{arch}", arch=arch, num_requests=n,
                       arrival=ArrivalProcess("poisson", rate=4e5),
                       prompt=LengthDist("lognormal", lo=16, hi=56,
                                         mean=32.0, sigma=0.5),
                       output=LengthDist("lognormal", lo=4, hi=12, mean=8.0))
            for i, arch in enumerate(_ARCHS)),
        # pool sized near the peak concurrent demand (~5 pages per running
        # seq x 6 slots) so a 1.5x capacity shrink really strands KV
        # host-side instead of hiding inside a roomy default pool
        oversub=1.5, max_seqs=6, max_len=64, prefill_chunk=24,
        num_pages=30, admit_device_fraction=0.0)


SCENARIOS = {"steady": steady, "burst": burst,
             "oversubscribed": oversubscribed}


def get_scenario(name: str, scale: float = 1.0) -> Scenario:
    try:
        return SCENARIOS[name](scale)
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; presets: "
                       f"{', '.join(sorted(SCENARIOS))}") from None


# -------------------------------------------------------------- simulator
@dataclass(frozen=True)
class _Arrival:
    t: float
    tenant: str
    prompt: np.ndarray
    max_new: int


@dataclass
class TrafficResult:
    scenario: str
    policy: str
    seed: int
    records: List[RequestRecord]
    tokens: Dict[str, List[int]]  # "<arch>/<rid>" -> generated token stream
    metrics: Dict[str, object]
    per_engine: Dict[str, Dict[str, object]] = field(default_factory=dict)


class TrafficSim:
    """Drive a :class:`Scenario` through one ServeEngine per model config.

    ``policy`` is a registry name — the KV pool of every engine is
    placed under that backend (at pool-page granularity). ``models`` maps
    arch name -> (cfg, TransformerLM) to inject prebuilt models on
    ``device`` (tests use tiny 1-layer configs); unlisted archs resolve via
    ``get_config(arch).reduced()`` with random weights from ``seed``.
    Every engine runs on ``device``: the CUDA card unless the caller passes
    ``device="cpu"``.
    """

    def __init__(self, scenario: Scenario, *, policy: str = "system",
                 hw=None, seed: int = 0, models: Optional[dict] = None,
                 use_um: bool = True, counter_threshold: int = 4,
                 tp: int = 1, fault_plan=None, device=None):
        self.device = resolve_device(device)
        self.scenario = scenario
        self.policy = policy
        self.seed = seed
        self.tp = tp
        # one frozen FaultPlan shared by every engine (each keeps its own
        # cursor), so the same schedule hits each arch's engine at the same
        # engine-step offsets — deterministic across runs
        self.fault_plan = fault_plan
        self.engines: Dict[str, ServeEngine] = {}
        self._arrivals: Dict[str, List[_Arrival]] = {}
        self.pool_bytes: Dict[str, int] = {}

        by_arch: Dict[str, List[Tuple[int, TenantSpec]]] = {}
        for ti, ten in enumerate(scenario.tenants):
            by_arch.setdefault(ten.arch, []).append((ti, ten))

        for arch, tenants in by_arch.items():
            cfg, params = self._model(arch, models, seed, self.device)
            lay = kv_head_layout(cfg, 1)
            page_bytes = PagedKVCache.page_bytes_for(cfg, lay,
                                                     scenario.page_size)
            pages_per_seq = -(-scenario.max_len // scenario.page_size)
            num_pages = (scenario.num_pages
                         or scenario.max_seqs * pages_per_seq + 1)
            pool_bytes = num_pages * page_bytes
            self.pool_bytes[arch] = pool_bytes
            um = None
            tp_plan = None
            if use_um:
                hw_model = get_hardware(hw)
                if scenario.oversub > 1.0:
                    # with_device_capacity (not dataclasses.replace): multi-
                    # node models keep their per-node split consistent
                    hw_model = hw_model.with_device_capacity(
                        int(pool_bytes / scenario.oversub))
                um = UnifiedMemory(hw=hw_model)
                if tp > 1:
                    from repro_torch.cluster.serve import ClusterTPPlan
                    tp_plan = ClusterTPPlan(tp)
            self.engines[arch] = ServeEngine(
                cfg, params, max_seqs=scenario.max_seqs,
                max_len=scenario.max_len, page_size=scenario.page_size,
                num_pages=num_pages, um=um,
                prefill_chunk=scenario.prefill_chunk,
                counter_threshold=counter_threshold,
                admit_device_fraction=scenario.admit_device_fraction,
                mem_policy=policy if um is not None else None,
                tp_plan=tp_plan,
                fault_plan=fault_plan if um is not None else None,
                device=self.device)
            self._arrivals[arch] = self._schedule(cfg, tenants, seed)

    @staticmethod
    def _model(arch: str, models: Optional[dict], seed: int, device):
        if models and arch in models:
            return models[arch]
        from repro_torch.configs import get_config
        from repro_torch.models import init_params
        cfg = get_config(arch).reduced()
        return cfg, init_params(cfg, seed=seed, device=device)

    def _schedule(self, cfg, tenants, seed: int) -> List[_Arrival]:
        """The full arrival list for one engine, generated up front from
        per-tenant seeded streams and merged in (time, tenant_index, i)
        order — the deterministic spine of the whole simulation."""
        out: List[Tuple[float, int, int, _Arrival]] = []
        for ti, ten in tenants:
            rng = np.random.default_rng([self.seed, ti])
            n = ten.num_requests
            times = ten.arrival.times(rng, n)
            plens = np.minimum(ten.prompt.sample(rng, n),
                               self.scenario.max_len - 2)
            outs = ten.output.sample(rng, n)
            for i in range(n):
                prompt = rng.integers(2, cfg.vocab_size, int(plens[i]))
                out.append((float(times[i]), ti, i,
                            _Arrival(float(times[i]), ten.name, prompt,
                                     int(outs[i]))))
        out.sort(key=lambda x: (x[0], x[1], x[2]))
        return [a for *_, a in out]

    # ------------------------------------------------------------------ run
    def _drive(self, eng: ServeEngine, arrivals: List[_Arrival],
               max_steps: int) -> None:
        """Arrival-driven event loop for one engine: deliver due requests,
        fast-forward idle gaps to the next arrival, step while busy."""
        i, steps = 0, 0
        while True:
            in_flight = any(not r.done for r in eng.requests.values())
            if not in_flight and i < len(arrivals):
                eng.advance_to(arrivals[i].t)
            while i < len(arrivals) and arrivals[i].t <= eng.now():
                a = arrivals[i]
                eng.add_request(a.prompt, a.max_new, arrival_time=a.t,
                                tenant=a.tenant)
                i += 1
                in_flight = True
            if not in_flight and i >= len(arrivals):
                return
            eng.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"traffic sim did not converge in {max_steps} steps "
                    f"({i}/{len(arrivals)} arrivals delivered)")

    def run(self, *, max_steps: int = 100_000,
            slo_ttft: Optional[float] = None) -> TrafficResult:
        records: List[RequestRecord] = []
        tokens: Dict[str, List[int]] = {}
        per_engine: Dict[str, Dict[str, object]] = {}
        for arch in sorted(self.engines):
            eng = self.engines[arch]
            self._drive(eng, self._arrivals[arch], max_steps)
            records.extend(collect(eng))
            for rid, r in sorted(eng.requests.items()):
                tokens[f"{arch}/{rid}"] = list(r.generated)
            per_engine[arch] = {
                "clock": eng.now(),
                "stats": eng.stats.modeled(),
                "pool_bytes": self.pool_bytes[arch],
                "um_report": (eng.um.report() if eng.um is not None
                              else None),
            }
        return TrafficResult(scenario=self.scenario.name, policy=self.policy,
                             seed=self.seed, records=records, tokens=tokens,
                             metrics=summarize(records, slo_ttft=slo_ttft),
                             per_engine=per_engine)


def policy_supports(policy: str, scenario: Scenario) -> bool:
    """Whether a registry backend can run a scenario at all: the KV pool
    needs a paged backend, and oversubscription needs migratable pages
    (a single-pool backend like mi300a_unified has nowhere to spill)."""
    pol = make_policy(policy, page_size=4096)
    if not pol.paged:
        return False
    if scenario.oversub > 1.0 and not pol.migratable:
        return False
    return True
