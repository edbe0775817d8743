"""Oversubscription-aware continuous-batching LM serving on the card.

`ServeEngine` (engine.py) schedules requests through the states
pending -> prefill -> decoding -> preempted -> done; `PagedKVCache`
(paged.py) is the page pool underneath, governed by the unified-memory
runtime, and decode attends over it through the hand-written CUDA
paged-attention kernel. The traffic harness (traffic.py: arrival
processes, multi-tenant scenario presets, fault plans and the cluster TP
plan) drives the engines under realistic load; metrics.py turns the
requests' modeled timestamps into SLO reports.
"""
from repro_torch.serve.engine import EngineStats, Request, SeqState, ServeEngine  # noqa: F401
from repro_torch.serve.metrics import RequestRecord, collect, summarize  # noqa: F401
from repro_torch.serve.paged import PagedKVCache  # noqa: F401
from repro_torch.serve.traffic import (  # noqa: F401
    SCENARIOS,
    ArrivalProcess,
    LengthDist,
    Scenario,
    TenantSpec,
    TrafficResult,
    TrafficSim,
    get_scenario,
    policy_supports,
)
