"""Serving SLO metrics: per-request timing records + percentile summaries.

Every :class:`~repro_torch.serve.engine.Request` carries modeled-clock
timestamps (``engine.now()``): ``arrival_time`` at enqueue,
``admit_time``, ``first_token_time`` and ``finish_time``.
:func:`collect` snapshots them into immutable :class:`RequestRecord`\\ s
and :func:`summarize` aggregates those into the SLO report the traffic
harness emits — overall and per tenant.

Metric definitions (all in modeled seconds — or engine steps when no
UnifiedMemory governs the pool):

* **TTFT** — ``first_token_time - arrival_time``. Anchored at *arrival*
  (the enqueue instant), never at admission: queueing delay before the
  admission gate is part of the latency a user sees, and measuring from
  admission would understate exactly the p99 tail.
* **queue delay** — ``admit_time - arrival_time`` (the pre-admission
  component of TTFT).
* **TPOT** (time per output token) — ``(finish_time - first_token_time)
  / (new_tokens - 1)`` for multi-token requests; 0 for single-token ones.
* **goodput** — completed tokens per modeled second of makespan
  (first arrival -> last finish). Preempted-and-resumed requests count
  only once, so goodput genuinely degrades when preemption churns.
* **SLO attainment** — fraction of completed requests with
  ``TTFT <= slo_ttft`` (when a deadline is given).

Everything here is a pure function of the modeled timestamps, so a
same-seed traffic run reproduces the report bit-for-bit
(the JAX package's tests/test_traffic.py pins this for its copy).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional

import numpy as np


@dataclass(frozen=True)
class RequestRecord:
    """Immutable timing snapshot of one served request."""
    rid: int
    tenant: str
    prompt_len: int
    new_tokens: int
    arrival_time: float
    admit_time: Optional[float]
    first_token_time: Optional[float]
    finish_time: Optional[float]
    preemptions: int
    recoveries: int = 0  # fault replays (KV lost, recomputed from prompt)

    @property
    def done(self) -> bool:
        return self.finish_time is not None

    @property
    def ttft(self) -> float:
        assert self.first_token_time is not None, "request never produced a token"
        return self.first_token_time - self.arrival_time

    @property
    def queue_delay(self) -> float:
        assert self.admit_time is not None, "request was never admitted"
        return self.admit_time - self.arrival_time

    @property
    def tpot(self) -> float:
        if self.new_tokens <= 1:
            return 0.0
        return (self.finish_time - self.first_token_time) / (self.new_tokens - 1)

    @property
    def e2e(self) -> float:
        return self.finish_time - self.arrival_time


def collect(engine) -> List[RequestRecord]:
    """Snapshot an engine's requests (any state) as records, rid order."""
    return [RequestRecord(rid=r.rid, tenant=r.tenant,
                          prompt_len=len(r.prompt),
                          new_tokens=len(r.generated),
                          arrival_time=r.arrival_time,
                          admit_time=r.admit_time,
                          first_token_time=r.first_token_time,
                          finish_time=r.finish_time,
                          preemptions=r.preemptions,
                          recoveries=r.recoveries)
            for rid, r in sorted(engine.requests.items())]


def _dist(values: Iterable[float]) -> Dict[str, float]:
    a = np.asarray(list(values), dtype=np.float64)
    if a.size == 0:
        return {"p50": 0.0, "p99": 0.0, "mean": 0.0, "max": 0.0}
    return {"p50": float(np.percentile(a, 50)),
            "p99": float(np.percentile(a, 99)),
            "mean": float(a.mean()),
            "max": float(a.max())}


def _summary_one(records: List[RequestRecord],
                 slo_ttft: Optional[float]) -> Dict[str, object]:
    done = [r for r in records if r.done]
    out: Dict[str, object] = {
        "n": len(records),
        "completed": len(done),
        "tokens": sum(r.new_tokens for r in done),
        "preemptions": sum(r.preemptions for r in records),
        "recoveries": sum(r.recoveries for r in records),
        "ttft": _dist(r.ttft for r in done),
        "queue_delay": _dist(r.queue_delay for r in done),
        "tpot": _dist(r.tpot for r in done if r.new_tokens > 1),
        "e2e": _dist(r.e2e for r in done),
    }
    if done:
        makespan = (max(r.finish_time for r in done)
                    - min(r.arrival_time for r in done))
        out["goodput_tok_s"] = (out["tokens"] / makespan if makespan > 0
                                else float(out["tokens"]))
    else:
        out["goodput_tok_s"] = 0.0
    if slo_ttft is not None:
        out["slo_attainment"] = (
            sum(1 for r in done if r.ttft <= slo_ttft) / len(done)
            if done else 0.0)
    return out


def summarize(records: List[RequestRecord], *,
              slo_ttft: Optional[float] = None) -> Dict[str, object]:
    """Aggregate records into the SLO report: the overall numbers plus a
    ``tenants`` sub-report keyed by tenant name. JSON-serializable and a
    pure function of the modeled timestamps (bit-deterministic per seed)."""
    out = _summary_one(records, slo_ttft)
    tenants = sorted({r.tenant for r in records})
    out["tenants"] = {t: _summary_one([r for r in records if r.tenant == t],
                                      slo_ttft)
                      for t in tenants}
    return out
