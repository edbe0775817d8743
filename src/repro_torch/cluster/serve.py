"""Tensor-parallel serving across superchips: the cluster serve plan.

A :class:`ClusterTPPlan` plugs into ``ServeEngine(tp_plan=...)`` and does
two things:

* **Sequence placement** — ``node_of_seq`` maps every KV-pool sequence
  slot to a serving superchip (round-robin over slots). The engine pins
  each sequence's tracked launches, demotes and resume-prefetches to that
  node, so a node-aware pool policy first-touches the sequence's KV pages
  on its serving node and spills/promotes as seen from it.
* **Collective traffic** — after every prefill chunk and decode batch it
  charges the per-token tensor-parallel all-reduce bytes over the
  inter-node NVLink lane (``um.charge_transfer``). Per transformer layer a
  TP-N forward pass all-reduces twice (attention out-proj + MLP down-proj),
  and a ring all-reduce moves ``2*(N-1)/N`` of the activation through
  every rank's links — the standard collective cost model.

The plan only ADDS modeled time and side-counter bytes: it never touches
the model math or the scheduler's decisions, so the generated tokens of a
TP-N run are bit-identical to the single-node engine driving the same
schedule. (Engine decisions read the pool and ``um.device_free()``, both
policy-governed — the acceptance test in tests/test_cluster.py pins token
identity against the single-node run.)

Fault tolerance: ``without_node`` produces the post-loss plan — the dead
rank leaves ``ranks()``, sequence placement re-pins round-robin over the
survivors, and the all-reduce ring shrinks to the surviving rank count.
The engine swaps plans when a fault-plan ``node_loss`` event fires.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

ACT_BYTES = 4  # fp32 activations, matching the app/serve compute dtype


@dataclass(frozen=True)
class ClusterTPPlan:
    """Tensor parallelism over ``nodes`` superchips, one TP rank per node.

    ``alive`` (None = everyone) lists the surviving ranks after node
    losses; placement and the collective cost model run over survivors.
    """

    nodes: int
    alive: Optional[Tuple[int, ...]] = None

    def ranks(self) -> Tuple[int, ...]:
        return self.alive if self.alive is not None \
            else tuple(range(self.nodes))

    def node_of_seq(self, sid: int) -> int:
        r = self.ranks()
        return int(r[int(sid) % len(r)])

    def without_node(self, node: int) -> "ClusterTPPlan":
        """The plan after ``node`` drops out of the serving group."""
        survivors = tuple(k for k in self.ranks() if k != int(node))
        assert survivors, "cannot lose the last serving node"
        return dataclasses.replace(self, alive=survivors)

    def allreduce_bytes_per_token(self, cfg) -> int:
        """Ring all-reduce bytes one token moves per rank: two all-reduces
        of the d_model activation per layer, 2*(N-1)/N of it on the wire."""
        n = len(self.ranks())
        if n <= 1:
            return 0
        ring = 2 * (n - 1) / n
        return int(2 * cfg.num_layers * ring * cfg.d_model * ACT_BYTES)

    # ------------------------------------------------------- engine hooks
    def on_prefill(self, engine, ntokens: int) -> None:
        self._charge(engine, ntokens)

    def on_decode(self, engine, ntokens: int) -> None:
        self._charge(engine, ntokens)

    def _charge(self, engine, ntokens: int) -> None:
        um = engine.um
        topo = getattr(um.hw, "topology", None) if um is not None else None
        if topo is None or len(self.ranks()) <= 1 or ntokens <= 0:
            return
        nbytes = ntokens * self.allreduce_bytes_per_token(engine.cfg)
        bw = topo.nvlink_bw
        deg = um.lane_degradation
        if deg is not None:  # all-reduce rides the degraded NVLink lane
            bw = bw * deg[0]
            um.prof.extra["degraded_nvlink_bytes"] += int(nbytes)
        # one latency per all-reduce (2 per layer), paid once per step
        um.charge_transfer(nbytes, bw,
                           latency=2 * engine.cfg.num_layers
                           * topo.nvlink_latency,
                           counter="tp_allreduce_bytes")
