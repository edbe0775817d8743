"""Training offload plan: the UM-backed state tree of an oversubscribed run.

A training step owns five long-lived tensor groups per layer — params, grad
accumulators, AdamW first/second moments, fp32 master weights — plus a
per-layer activation stash written by the forward pass and re-read by the
backward pass. :class:`TrainMemPlan` maps that tree onto
:class:`~repro_torch.core.buffer.UMBuffer` allocations under one registered memory
policy and owns every *placement* decision, so the trainer
(train/umtrain.py) stays a single code path over all backends:

* **Resident mode** (every paged backend: system / managed / mi300a_unified /
  cluster_*): each group is a per-layer buffer under the training policy.
  Oversubscription comes from sizing the device via
  ``HardwareModel.with_device_capacity`` (see :func:`capacity_for`), and the
  policy's own pressure behavior — graceful host mapping, LRU eviction,
  single-pool OOM — produces the fig11-style degradation curve.
* **Staged mode** (the table-less explicit backend): the ZeRO-offload-style
  port. Full state lives in host buffers (the malloc side, a
  non-auto-migrating system-policy table); the device holds fixed slabs
  sized to ONE layer's params / grads / activations plus the residual
  stream, and the plan charges the per-layer h2d/d2h slab traffic that a
  hand-written double-buffered port would issue.

Placement hints (:class:`TrainHints`) are the paper's "practical
optimization strategies" applied to training: ``prefetch_async`` the next
layer's params ahead of its forward launch, ``demote`` the cold optimizer
moments right after the update consumed them. Hints are capability-gated —
a non-migratable pool (mi300a_unified) turns them into no-ops, exactly as
``cudaMemPrefetchAsync`` degenerates on a single physical pool.

Node-aware backends (``policy.node_aware``) get layers round-robined over
the superchips: layer ``l`` issues from node ``l % nodes`` via
``KernelLaunch(node=...)`` / ``um.on_node`` — no topology access outside
the cluster seam.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import Actor, UnifiedMemory, system_policy
from repro_torch.core.policy import MemPolicy

__all__ = [
    "TRAIN_MODELS",
    "TrainHints",
    "TrainMemPlan",
    "TrainModelSpec",
    "capacity_for",
    "device_demand_bytes",
    "get_train_model",
    "state_bytes",
]

F32 = np.dtype(np.float32)


# ----------------------------------------------------------------- model spec
@dataclass(frozen=True)
class TrainModelSpec:
    """A residual-MLP training workload: ``n_layers`` blocks of
    ``h <- h + tanh(h @ W1) @ W2`` over a ``rows x d_model`` residual
    stream, trained with AdamW against a random regression target. The
    math is real (numpy fp32, fixed op order — losses cannot depend on the
    memory backend), the memory system is modeled."""
    name: str
    d_model: int
    d_ff: int
    n_layers: int
    rows: int  # residual-stream rows per step (kept small: state, not
    #           batch, is what oversubscribes)

    @property
    def layer_params(self) -> int:
        return 2 * self.d_model * self.d_ff  # W1 (d,f) + W2 (f,d)

    @property
    def n_params(self) -> int:
        return self.n_layers * self.layer_params

    @property
    def act_elems(self) -> int:
        # per-layer stash: z (rows, d_ff) + the layer's input h (rows, d_model)
        return self.rows * (self.d_ff + self.d_model)


TRAIN_MODELS: Dict[str, TrainModelSpec] = {
    # tier-1 test scale: whole state ~260 KB, runs in milliseconds
    "train_tiny": TrainModelSpec("train_tiny", d_model=32, d_ff=64,
                                 n_layers=3, rows=4),
    # CI smoke scale: ~25M params, ~500 MB of training state
    "train_25m": TrainModelSpec("train_25m", d_model=512, d_ff=2048,
                                n_layers=12, rows=8),
    # the paper-scale config: ~104M params -> ~2.1 GB of fp32 training state
    # (params + grads + m + v + master), the fig11-curve workload
    "train_100m": TrainModelSpec("train_100m", d_model=768, d_ff=3072,
                                 n_layers=22, rows=16),
}


def get_train_model(name: str) -> TrainModelSpec:
    try:
        return TRAIN_MODELS[name]
    except KeyError:
        raise KeyError(f"unknown training model {name!r}; available: "
                       f"{', '.join(sorted(TRAIN_MODELS))}") from None


def state_bytes(spec: TrainModelSpec) -> int:
    """Total training state: the five per-layer tensor groups, the
    activation stash, the residual stream, the io batch and the backward
    scratch — everything the plan allocates. A non-migratable single pool
    (mi300a_unified) must hold all of it."""
    trees = 5 * spec.n_params  # params, grads, m, v, master
    acts = spec.n_layers * spec.act_elems
    io = 3 * spec.rows * spec.d_model  # residual stream h, x, y
    scratch = spec.rows * (spec.d_model + spec.d_ff)  # dh / da
    return F32.itemsize * (trees + acts + io + scratch) + F32.itemsize  # +loss


def device_demand_bytes(spec: TrainModelSpec) -> int:
    """What the GPU actually touches every step — params, grad
    accumulators, the activation stash, the residual stream, io and
    scratch. This is the ``1.0x`` point of the oversubscription axis: the
    optimizer tree (m/v/master) is CPU-updated and host-resident by first
    touch, so it pressures the *pool*, not the device, and sizing the
    device against it would never make the forward/backward working set
    spill."""
    gpu = 2 * spec.n_params + spec.n_layers * spec.act_elems
    res = (3 * spec.rows * spec.d_model
           + spec.rows * (spec.d_model + spec.d_ff))
    return F32.itemsize * (gpu + res) + F32.itemsize  # +loss


def _staged_min_bytes(spec: TrainModelSpec) -> int:
    """Device-resident floor of the staged (explicit) port: one layer's
    param/grad/act slabs + the residual stream, io and scratch blobs."""
    slabs = 2 * spec.layer_params + spec.act_elems
    resident = (spec.rows * spec.d_model  # residual stream h
                + 2 * spec.rows * spec.d_model  # x, y
                + spec.rows * (spec.d_model + spec.d_ff))  # scratch
    return F32.itemsize * (slabs + resident) + F32.itemsize  # +loss


def capacity_for(spec: TrainModelSpec, policy: MemPolicy,
                 ratio: float) -> int:
    """Device capacity that puts ``spec``'s GPU working set
    (:func:`device_demand_bytes`) at ``ratio``-fold oversubscription,
    floored at what the backend can physically run with:

    * migratable paged backends shrink all the way (pressure spills host);
    * the staged explicit port needs its fixed slab set on device;
    * a non-migratable single pool (mi300a_unified) cannot hold less than
      the *whole* state tree — the floor keeps the run feasible and the
      recorded ``eff_ratio`` reports the capacity actually modeled."""
    cap = int(math.ceil(device_demand_bytes(spec) / float(ratio)))
    if not policy.paged:
        return max(cap, _staged_min_bytes(spec))
    if not policy.migratable:
        return max(cap, state_bytes(spec))
    return cap


# ------------------------------------------------------------ placement hints
@dataclass(frozen=True)
class TrainHints:
    """Per-group placement hints — the paper's practical optimization
    strategies, applied to the training state tree. Every hint is
    capability-gated on ``policy.migratable`` (a single physical pool has
    nowhere to move a page) and ignored by the staged port (whose
    placement is the explicit slab schedule itself)."""
    prefetch_params: bool = True  # prefetch_async layer l+1's params ahead
    #                               of layer l's forward launches
    demote_opt: bool = True  # demote m/v/master right after the update —
    #                          cold until the next step's opt phase
    demote_acts: bool = False  # demote a layer's stash once bwd consumed it


# ------------------------------------------------------------------- the plan
class TrainMemPlan:
    """Maps the training state tree of ``spec`` onto UMBuffers under
    ``policy`` and owns placement: views for every launch operand, the
    hint-driven prefetch/demote calls, the staged port's slab copies, and
    the node round-robin for node-aware backends."""

    def __init__(self, um: UnifiedMemory, spec: TrainModelSpec,
                 policy: MemPolicy, *,
                 hints: Optional[TrainHints] = None):
        self.um = um
        self.spec = spec
        self.policy = policy
        self.hints = hints or TrainHints()
        self.staged = not policy.paged
        self.nodes = int(getattr(um.hw, "nodes", 1)) if policy.node_aware else 1
        self.peak_bytes = state_bytes(spec)
        self.demand_bytes = device_demand_bytes(spec)
        self._bufs: List = []  # free() in allocation order

        d, f, R, L = spec.d_model, spec.d_ff, spec.rows, spec.n_layers
        isz = F32.itemsize
        self._w1_bytes = d * f * isz
        self._z_bytes = R * f * isz
        self._layer_bytes = spec.layer_params * isz
        self._act_bytes = spec.act_elems * isz

        def mk(name, elems, pol):
            buf = um.array(name, (int(elems),), F32, pol)
            self._bufs.append(buf)
            return buf

        if self.staged:
            # ZeRO-offload-style port: full state host-side (the malloc
            # half of the pair, a plain non-auto-migrating system table at
            # the app's system page size), fixed per-layer slabs device-side
            host = system_policy(page_size=um.staging_page_size,
                                 auto_migrate=False)
            self.host_policy = host
            self._slab_w = mk("slab_w", spec.layer_params, policy)
            self._slab_g = mk("slab_g", spec.layer_params, policy)
            self._slab_a = mk("slab_a", spec.act_elems, policy)
            self._params = [mk(f"p{l}", spec.layer_params, host)
                            for l in range(L)]
            self._grads = [mk(f"g{l}", spec.layer_params, host)
                           for l in range(L)]
            self._m = [mk(f"m{l}", spec.layer_params, host) for l in range(L)]
            self._v = [mk(f"v{l}", spec.layer_params, host) for l in range(L)]
            self._master = [mk(f"w{l}", spec.layer_params, host)
                            for l in range(L)]
            self._acts = [mk(f"a{l}", spec.act_elems, host) for l in range(L)]
        else:
            self.host_policy = policy
            self._params = [mk(f"p{l}", spec.layer_params, policy)
                            for l in range(L)]
            self._grads = [mk(f"g{l}", spec.layer_params, policy)
                           for l in range(L)]
            self._m = [mk(f"m{l}", spec.layer_params, policy)
                       for l in range(L)]
            self._v = [mk(f"v{l}", spec.layer_params, policy)
                       for l in range(L)]
            self._master = [mk(f"w{l}", spec.layer_params, policy)
                            for l in range(L)]
            self._acts = [mk(f"a{l}", spec.act_elems, policy)
                          for l in range(L)]
        # io + scratch + loss live under the training policy in both modes
        # (the staged port keeps them device-resident; they are part of the
        # explicit floor in _staged_min_bytes). x/y originate host-side
        # every step, so they go through from_host: under the explicit
        # policy that materializes the cudaMalloc+malloc staging pair and
        # um.staged() charges the upload; resident backends first-touch.
        self._h = mk("hres", R * d, policy)  # residual stream
        self._x = um.from_host("xin", (R * d,), F32, policy)
        self._bufs.append(self._x)
        self._y = um.from_host("ytgt", (R * d,), F32, policy)
        self._bufs.append(self._y)
        self._scratch = mk("scratch", R * (d + f), policy)
        self._loss = mk("lossv", 1, policy)

    # ------------------------------------------------------------- geometry
    def node_of(self, layer: int) -> Optional[int]:
        """Issuing superchip for layer ``layer`` (round-robin), or None on
        single-node / non-node-aware backends."""
        if self.nodes <= 1:
            return None
        return layer % self.nodes

    def on_layer_node(self, layer: int):
        """Context manager pinning the ambient node to ``node_of(layer)``
        (a no-op nullcontext off the cluster backends)."""
        nd = self.node_of(layer)
        if nd is None:
            return contextlib.nullcontext(self.um)
        return self.um.on_node(nd)

    # ------------------------------------------------- launch-operand views
    # compute views: what GPU launches read/write. In staged mode these
    # resolve to the device slabs; host-side state is reached through the
    # *_state views below.
    def _wbuf(self, l):
        return self._slab_w if self.staged else self._params[l]

    def _gbuf(self, l):
        return self._slab_g if self.staged else self._grads[l]

    def _abuf(self, l):
        return self._slab_a if self.staged else self._acts[l]

    def w1(self, l):
        return self._wbuf(l).byterange(0, self._w1_bytes)

    def w2(self, l):
        return self._wbuf(l).byterange(self._w1_bytes, self._layer_bytes)

    def params(self, l):
        return self._wbuf(l)[...]

    def grads(self, l):
        return self._gbuf(l)[...]

    def z(self, l):
        return self._abuf(l).byterange(0, self._z_bytes)

    def h_in(self, l):
        return self._abuf(l).byterange(self._z_bytes, self._act_bytes)

    def acts(self, l):
        return self._abuf(l)[...]

    # optimizer-state views: always the authoritative (host-side in staged
    # mode) buffers — the CPU-actor update touches these directly
    def m_state(self, l):
        return self._m[l][...]

    def v_state(self, l):
        return self._v[l][...]

    def master_state(self, l):
        return self._master[l][...]

    def grads_state(self, l):
        return self._grads[l][...] if self.staged else self.grads(l)

    def params_state(self, l):
        return self._params[l][...] if self.staged else self.params(l)

    def x(self):
        return self._x[...]

    def y(self):
        return self._y[...]

    def h_res(self):
        return self._h[...]

    def scratch(self):
        return self._scratch[...]

    def loss_out(self):
        return self._loss[...]

    # ------------------------------------------------------- phase placement
    # The trainer calls these at the phase boundaries; each one is a no-op
    # wherever the backend has no corresponding action, so the step loop in
    # umtrain.py is one code path for every registered policy.
    def _migratory(self) -> bool:
        return not self.staged and self.policy.migratable

    def pre_fwd(self, l: int) -> None:
        """Ahead of layer ``l``'s forward launches: staged mode uploads the
        layer's params slab; resident migratable backends prefetch the
        *next* layer's params so the migration hides under this layer's
        compute (the async-prefetch overlap model)."""
        if self.staged:
            self.um.copy(self._slab_w.alloc, 0, self._layer_bytes, "h2d")
            return
        if self.hints.prefetch_params and self._migratory() \
                and l + 1 < self.spec.n_layers:
            with self.on_layer_node(l + 1):
                self.um.prefetch_async([self.params(l + 1)])

    def post_fwd(self, l: int) -> None:
        """After layer ``l``'s forward: staged mode writes the activation
        stash back to its host buffer (device slab is reused next layer)."""
        if self.staged:
            self.um.copy(self._slab_a.alloc, 0, self._act_bytes, "d2h")

    def pre_bwd(self, l: int) -> None:
        """Ahead of layer ``l``'s backward: staged mode re-uploads the
        layer's params and its stashed activations."""
        if self.staged:
            self.um.copy(self._slab_w.alloc, 0, self._layer_bytes, "h2d")
            self.um.copy(self._slab_a.alloc, 0, self._act_bytes, "h2d")

    def post_bwd(self, l: int) -> None:
        """After layer ``l``'s backward: staged mode drains the grad slab to
        its host accumulator; resident backends optionally demote the
        consumed stash (it is cold until the next step's forward)."""
        if self.staged:
            self.um.copy(self._slab_g.alloc, 0, self._layer_bytes, "d2h")
            return
        if self.hints.demote_acts and self._migratory():
            with self.on_layer_node(l):
                self.um.demote(self.acts(l))

    def post_opt(self, l: int) -> None:
        """After layer ``l``'s optimizer update: demote the cold moments
        and master weights — nothing reads them again until the next step's
        opt phase (the paper's 'keep cold state out of HBM' strategy)."""
        if self.hints.demote_opt and self._migratory():
            with self.on_layer_node(l):
                self.um.demote(self.m_state(l))
                self.um.demote(self.v_state(l))
                self.um.demote(self.master_state(l))

    # ---------------------------------------------------------- checkpointing
    def checkpoint_ranges(self):
        """The durable state a checkpoint snapshots: params + optimizer
        tree. These are what CheckpointManager.save drains — dirty
        device-resident runs charge a d2h writeback; host-resident (and
        staged-port host) state drains nothing."""
        out = []
        for l in range(self.spec.n_layers):
            out.append(self.params_state(l))
            out.append(self.m_state(l))
            out.append(self.v_state(l))
            out.append(self.master_state(l))
        return out

    # -------------------------------------------------------------- lifecycle
    def close(self) -> None:
        """Free every plan allocation (staging pairs included), returning
        the runtime's residency to its pre-plan baseline."""
        for buf in self._bufs:
            if not buf.freed:
                buf.free()
        self._bufs.clear()

    def init_launches(self):
        """The cpu_init first-touch launches that place the state tree:
        CPU writes params/master/m/v (host-side first touch under paged
        backends, host buffers of the staged port)."""
        from repro_torch.core.umem import KernelBatch

        kb = KernelBatch()
        for l in range(self.spec.n_layers):
            nd = self.node_of(l)
            kb.launch("init_state", writes=[
                self.params_state(l), self.master_state(l),
                self.m_state(l), self.v_state(l)],
                actor=Actor.CPU, node=nd)
        return kb
