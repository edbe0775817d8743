"""Failure injection + recovery policy, for training AND serving.

At 1000+ nodes, MTBF of the *job* is hours; every layer must treat
failure as a normal event. Two consumers share the machinery here:

* **Trainer** — :class:`FailureInjector` raises :class:`SimulatedFailure`
  at scheduled steps; the trainer catches, restores the last committed
  checkpoint, replays the data stream (deterministic pipeline) and
  continues. tests/test_fault_tolerance.py asserts bitwise-identical
  losses vs an uninterrupted run.
* **Serve/cluster stack** — :class:`FaultPlan` is an immutable, sorted
  schedule of :class:`FaultEvent`\\ s (node loss, transient lane
  degradation, host-spill failure) keyed by engine step.
  ``ServeEngine(fault_plan=...)`` drains the due events each step and
  delivers them to the UnifiedMemory runtime / cluster policy through
  the lifecycle-hook seam (``um.fail_node``, ``um.set_lane_degradation``,
  ``um.set_spill_failure``); tests/test_fault_serve.py asserts recovered
  token streams are bit-identical to a fault-free run.

Both schedules are seeded-deterministic: the fixed-step mode pins exact
steps, the Poisson (MTBF) mode samples exponential inter-failure gaps
from ``np.random.default_rng(seed)`` — same seed, same schedule.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, List, Sequence, Set, Tuple

import numpy as np


class SimulatedFailure(RuntimeError):
    """Stands in for a node loss / ICI timeout / preemption."""


def poisson_steps(rate: float, seed: int, horizon: int = 10_000) -> List[int]:
    """Integer failure steps of a seeded Poisson process: exponential
    inter-arrival gaps with mean ``1/rate`` steps (MTBF), cumulative-summed,
    floored and deduplicated — deterministic per seed. Shared by
    :meth:`FailureInjector.poisson` and :meth:`FaultPlan.poisson` so the
    trainer and the serve fault plan draw from the same schedule family."""
    assert rate > 0, "MTBF mode needs a positive failure rate"
    rng = np.random.default_rng(seed)
    t, out = 0.0, []
    while True:
        t += float(rng.exponential(1.0 / rate))
        s = int(t)
        if s >= horizon:
            return sorted(set(out))
        if s >= 1:
            out.append(s)


@dataclass
class FailureInjector:
    fail_at_steps: Set[int] = field(default_factory=set)
    fired: Set[int] = field(default_factory=set)

    @classmethod
    def at(cls, steps: Iterable[int]) -> "FailureInjector":
        return cls(fail_at_steps=set(steps))

    @classmethod
    def poisson(cls, rate: float, seed: int, *,
                horizon: int = 10_000) -> "FailureInjector":
        """Seeded MTBF mode: failures at the steps of a Poisson process
        with ``rate`` failures per step (MTBF = 1/rate), deterministic per
        seed — the same injector twice replays the same schedule."""
        return cls(fail_at_steps=set(poisson_steps(rate, seed, horizon)))

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at_steps and step not in self.fired:
            self.fired.add(step)
            raise SimulatedFailure(f"injected failure at step {step}")


# --------------------------------------------------------------- fault plan
@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault, keyed by the consumer's step counter.

    kind='node_loss'    -> superchip ``node`` drops out: its resident pages
                           are poisoned (``um.fail_node``) and the serve
                           engine replays the affected sequences.
    kind='lane_degrade' -> for ``duration`` steps the inter-node links run
                           at ``nvlink_factor`` / ``fabric_factor`` of
                           nominal bandwidth (<1 = slower); the cluster
                           charge model measures the degraded-mode time.
    kind='spill_fail'   -> for ``duration`` steps host-spill (demote)
                           raises; preemption falls back to dropping the
                           KV and recomputing from the prompt.
    """
    step: int
    kind: str
    node: int = 0
    duration: int = 1
    nvlink_factor: float = 1.0
    fabric_factor: float = 1.0


@dataclass(frozen=True)
class FaultPlan:
    """An immutable, sorted schedule of :class:`FaultEvent`\\ s.

    The plan itself is shareable — consumers (one per engine) keep their
    own cursor into ``events``, so a single plan can drive every engine of
    a traffic simulation deterministically."""

    events: Tuple[FaultEvent, ...] = ()

    def __post_init__(self):
        object.__setattr__(
            self, "events",
            tuple(sorted(self.events,
                         key=lambda e: (e.step, e.kind, e.node))))

    def __bool__(self) -> bool:
        return bool(self.events)

    def __add__(self, other: "FaultPlan") -> "FaultPlan":
        return FaultPlan(events=self.events + tuple(other.events))

    # ------------------------------------------------------------- builders
    @classmethod
    def node_loss(cls, losses: Sequence[Tuple[int, int]]) -> "FaultPlan":
        """Fixed-step node losses: ``[(step, node), ...]``."""
        return cls(events=tuple(FaultEvent(step=int(s), kind="node_loss",
                                           node=int(n)) for s, n in losses))

    @classmethod
    def lane_degrade(cls, step: int, duration: int, *,
                     nvlink_factor: float = 1.0,
                     fabric_factor: float = 1.0) -> "FaultPlan":
        """A transient lane-degradation window starting at ``step``."""
        return cls(events=(FaultEvent(step=int(step), kind="lane_degrade",
                                      duration=int(duration),
                                      nvlink_factor=float(nvlink_factor),
                                      fabric_factor=float(fabric_factor)),))

    @classmethod
    def spill_failure(cls, step: int, duration: int) -> "FaultPlan":
        """A window during which host-spill (demote) fails."""
        return cls(events=(FaultEvent(step=int(step), kind="spill_fail",
                                      duration=int(duration)),))

    @classmethod
    def poisson(cls, rate: float, seed: int, *, num_nodes: int,
                horizon: int = 10_000) -> "FaultPlan":
        """Seeded-MTBF node losses: steps from :func:`poisson_steps`, the
        dying node drawn (without replacement) from the same seed. Capped
        at ``num_nodes - 1`` losses — a cluster cannot lose its last
        serving node and still drain."""
        steps = poisson_steps(rate, seed, horizon)[:max(0, num_nodes - 1)]
        rng = np.random.default_rng([seed, 1])
        alive = list(range(num_nodes))
        events = []
        for s in steps:
            node = alive.pop(int(rng.integers(len(alive))))
            events.append(FaultEvent(step=s, kind="node_loss", node=node))
        return cls(events=tuple(events))
