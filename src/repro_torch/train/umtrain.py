"""UM-backed training: the oversubscribed training loop over the charge model
(the port of ``repro.train.umtrain``; the math runs in torch on the
trainer's device, the charges are the JAX package's, launch for launch).

Training has a phase
structure — forward over the layers, backward re-reading the activation
stash, an optimizer update over state that is cold the rest of the step —
that stresses a shared-memory design very differently from the inference
and HPC apps. :class:`UMTrainer` drives exactly that structure through
:class:`~repro_torch.core.umem.UnifiedMemory`:

* the state tree (params, grad accumulators, AdamW m/v/master, per-layer
  activation stash) lives in UMBuffers mapped by a
  :class:`~repro_torch.train.offload.TrainMemPlan` under any registered policy;
* every phase issues per-layer :class:`~repro_torch.core.umem.KernelBatch`
  launches (the batched engine charges a whole layer's train of
  kernels in one pass), with the plan's placement hints — prefetch the
  next layer's params, demote the cold moments — at the phase boundaries;
* checkpoint saves are UM pressure events (``CheckpointManager.save``
  syncs and charges the dirty-device d2h drain) and elastic resizes go
  through ``runtime.elastic.resize_um_capacity`` mid-run.

The *math* is real fp32 with a fixed op order (torch on ``device``, the CUDA
card unless the caller passes ``device="cpu"``; weights and batches drawn
with numpy from the JAX package's seeds), entirely independent of the
memory model — so losses are bit-identical across every policy,
oversubscription ratio, checkpoint cadence and resize schedule, and the
tests assert exactly that. The *memory system* is modeled: step times come
from ``um.clock`` (the same modeled clock the serve stack reports), which
is what produces the fig11-style step-time-vs-ratio curves in
``repro_torch.bench.train_oversub``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.core import Actor, UnifiedMemory, get_hardware, make_policy
from repro_torch.core.policy import MemPolicy
from repro_torch.core.umem import KernelBatch
from repro_torch.kernels.common import resolve_device
from repro_torch.train.offload import (
    TrainHints,
    TrainMemPlan,
    TrainModelSpec,
    capacity_for,
    get_train_model,
)

__all__ = ["UMTrainer"]

KB = 1024
F32 = np.float32


class UMTrainer:
    """Training loop over the charge model.

    ``policy`` is a registered backend name or a MemPolicy instance. With
    ``um=None`` the trainer builds its own runtime on ``hw`` with the
    device sized for ``ratio``-fold oversubscription of the working set
    (see :func:`~repro_torch.train.offload.capacity_for`); passing ``um``
    (e.g. the contract suite's default-capacity runtime) uses it as-is.
    """

    def __init__(self, spec: Union[TrainModelSpec, str],
                 policy: Union[str, MemPolicy] = "system", *,
                 hw=None, ratio: float = 1.0, page_size: int = 64 * KB,
                 hints: Optional[TrainHints] = None,
                 um: Optional[UnifiedMemory] = None,
                 lr: float = 1e-3, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.spec = get_train_model(spec) if isinstance(spec, str) else spec
        pol = (make_policy(policy, page_size=page_size)
               if isinstance(policy, str) else policy)
        self.policy = pol
        self.ratio = float(ratio)
        if um is None:
            hwm = get_hardware(hw)
            self.capacity = capacity_for(self.spec, pol, self.ratio)
            um = UnifiedMemory(hw=hwm.with_device_capacity(self.capacity))
        else:
            self.capacity = um.hw.device_capacity
        self.um = um
        self.plan = TrainMemPlan(um, self.spec, pol, hints=hints)
        self.lr, self.b1, self.b2 = F32(lr), F32(b1), F32(b2)
        self.eps, self.wd = F32(eps), F32(weight_decay)
        self._seed = int(seed)
        self._step = 0  # completed steps (== AdamW bias-correction count)
        self.history: List[Dict[str, Any]] = []
        self.events: List[Dict[str, Any]] = []
        self._init_state()

    # -------------------------------------------------------------- numerics
    def _init_state(self) -> None:
        s = self.spec
        rng = np.random.default_rng([self._seed])
        s1, s2 = F32(1.0 / math.sqrt(s.d_model)), F32(1.0 / math.sqrt(s.d_ff))
        W1 = [rng.standard_normal((s.d_model, s.d_ff), F32) * s1
              for _ in range(s.n_layers)]
        W2 = [rng.standard_normal((s.d_ff, s.d_model), F32) * s2
              for _ in range(s.n_layers)]
        dev = self.device
        self.W1 = [torch.from_numpy(w).to(dev) for w in W1]
        self.W2 = [torch.from_numpy(w).to(dev) for w in W2]
        self.MW1 = [w.clone() for w in self.W1]  # fp32 master weights
        self.MW2 = [w.clone() for w in self.W2]
        self.M1 = [torch.zeros_like(w) for w in self.W1]
        self.V1 = [torch.zeros_like(w) for w in self.W1]
        self.M2 = [torch.zeros_like(w) for w in self.W2]
        self.V2 = [torch.zeros_like(w) for w in self.W2]
        self.G1 = [None] * s.n_layers
        self.G2 = [None] * s.n_layers
        # charge the host-side first touch of the durable state tree
        with self.um.phase("init"):
            self.um.launch_batch(self.plan.init_launches())
            self.um.sync()

    def now(self) -> float:
        """The modeled clock (same convention as ``ServeEngine.now()``)."""
        return self.um.clock

    @property
    def losses(self) -> List[float]:
        return [h["loss"] for h in self.history]

    # ------------------------------------------------------------------ step
    def step(self) -> Dict[str, Any]:
        s, um, plan = self.spec, self.um, self.plan
        R, d, f, L = s.rows, s.d_model, s.d_ff, s.n_layers
        rng = np.random.default_rng([self._seed, 1000 + self._step])
        X = torch.from_numpy(rng.standard_normal((R, d), F32)).to(self.device)
        Y = torch.from_numpy(rng.standard_normal((R, d), F32)).to(self.device)
        t0 = um.clock

        with um.phase("load"):
            um.launch("load_batch", writes=[plan.x(), plan.y()],
                      actor=Actor.CPU)

        # x/y upload is a staging boundary: charged only under the
        # explicit port, pass-through everywhere else
        with um.staged(h2d=[plan.x(), plan.y()]):
            # ----------------------------------------------------- forward
            h = X
            hins, zs = [], []
            with um.phase("fwd"):
                um.launch("seed_h", reads=[plan.x()], writes=[plan.h_res()])
                for l in range(L):
                    plan.pre_fwd(l)
                    a = h @ self.W1[l]
                    z = torch.tanh(a)
                    hins.append(h)
                    zs.append(z)
                    h = h + z @ self.W2[l]
                    nd = plan.node_of(l)
                    kb = KernelBatch()
                    kb.launch("fwd_w1", reads=[plan.w1(l), plan.h_res()],
                              writes=[plan.z(l), plan.h_in(l)],
                              flops=2.0 * R * d * f, node=nd)
                    kb.launch("fwd_w2",
                              reads=[plan.w2(l), plan.z(l), plan.h_res()],
                              writes=[plan.h_res()],
                              flops=2.0 * R * f * d, node=nd)
                    um.launch_batch(kb)
                    plan.post_fwd(l)
                diff = h - Y
                loss = float(torch.mean(diff * diff))
                um.launch("loss", reads=[plan.h_res(), plan.y()],
                          writes=[plan.loss_out()], flops=3.0 * R * d)

            # ---------------------------------------------------- backward
            dh = float(F32(2.0) / F32(R * d)) * diff
            with um.phase("bwd"):
                um.launch("bwd_seed", reads=[plan.h_res(), plan.y()],
                          writes=[plan.scratch()], flops=2.0 * R * d)
                for l in reversed(range(L)):
                    plan.pre_bwd(l)
                    z, hin = zs[l], hins[l]
                    dz = dh @ self.W2[l].T
                    da = dz * (F32(1.0) - z * z)
                    self.G1[l] = hin.T @ da
                    self.G2[l] = z.T @ dh
                    dh = dh + da @ self.W1[l].T
                    nd = plan.node_of(l)
                    kb = KernelBatch()
                    kb.launch("bwd_dz",
                              reads=[plan.w2(l), plan.z(l), plan.scratch()],
                              writes=[plan.scratch()],
                              flops=2.0 * R * d * f, node=nd)
                    kb.launch("bwd_grad",
                              reads=[plan.h_in(l), plan.z(l), plan.scratch()],
                              writes=[plan.grads(l)],
                              flops=4.0 * R * d * f, node=nd)
                    kb.launch("bwd_dh", reads=[plan.w1(l), plan.scratch()],
                              writes=[plan.scratch()],
                              flops=2.0 * R * d * f, node=nd)
                    um.launch_batch(kb)
                    plan.post_bwd(l)

        # ---------------------------------------------------------- update
        self._step += 1
        t = self._step
        # fp32 scalars on the host, as Python floats: exact in a torch op
        bc1 = float(F32(1.0) - self.b1 ** t)  # fp32 bias corrections
        bc2 = float(F32(1.0) - self.b2 ** t)
        b1, b2 = float(self.b1), float(self.b2)
        a1, a2 = float(F32(1.0) - self.b1), float(F32(1.0) - self.b2)
        lr, wd, eps = float(self.lr), float(self.wd), float(self.eps)
        with um.phase("opt"):
            for l in range(L):
                for W, MW, M, V, G in (
                        (self.W1[l], self.MW1[l], self.M1[l], self.V1[l],
                         self.G1[l]),
                        (self.W2[l], self.MW2[l], self.M2[l], self.V2[l],
                         self.G2[l])):
                    M *= b1  # each op rounds once, in numpy's order
                    M += a1 * G
                    V *= b2
                    V += a2 * (G * G)
                    upd = (M / bc1) / (torch.sqrt(V / bc2) + eps)
                    MW -= lr * (upd + wd * MW)
                    W.copy_(MW)
                n = float(s.layer_params)
                nd = plan.node_of(l)
                kb = KernelBatch()
                kb.launch("adamw",
                          reads=[plan.grads_state(l), plan.m_state(l),
                                 plan.v_state(l), plan.master_state(l)],
                          writes=[plan.m_state(l), plan.v_state(l),
                                  plan.master_state(l)],
                          actor=Actor.CPU, flops=12.0 * n, node=nd)
                # push the fresh weights back into the compute copy: GPU
                # pulls them under resident backends, the staged port keeps
                # params host-side and re-uploads per layer next step
                kb.launch("refresh", reads=[plan.master_state(l)],
                          writes=[plan.params_state(l)],
                          actor=Actor.CPU if plan.staged else Actor.GPU,
                          flops=n, node=nd)
                um.launch_batch(kb)
                plan.post_opt(l)
            um.sync()

        rec = {"step": self._step, "loss": loss, "dt": um.clock - t0}
        self.history.append(rec)
        return rec

    # ------------------------------------------------------------------- run
    def run(self, num_steps: int, *, ckpt=None, ckpt_every: int = 0,
            resize_at: Optional[Dict[int, int]] = None) -> Dict[str, Any]:
        """Drive ``num_steps`` steps. ``ckpt``/``ckpt_every`` snapshot the
        durable state through :meth:`save_checkpoint` at the step
        boundary; ``resize_at`` maps *completed-step counts* to new device
        capacities applied before the next step (an elastic pressure
        event — never a math event)."""
        resize = dict(resize_at or {})
        for _ in range(num_steps):
            if self._step in resize:
                self.resize_device_capacity(resize.pop(self._step))
            self.step()
            if ckpt is not None and ckpt_every \
                    and self._step % ckpt_every == 0:
                self.save_checkpoint(ckpt)
        if ckpt is not None:
            ckpt.wait()
        dts = [h["dt"] for h in self.history]
        total = sum(dts)
        return {
            "history": self.history,
            "losses": self.losses,
            "modeled_s": total,
            "steps_per_s": (len(dts) / total) if total else 0.0,
            "capacity": self.capacity,
            "peak_bytes": self.plan.peak_bytes,
            "demand_bytes": self.plan.demand_bytes,
            "eff_ratio": self.plan.demand_bytes / self.capacity,
            "events": self.events,
        }

    # ----------------------------------------------------------- checkpoints
    def state_tree(self) -> Dict[str, Any]:
        """The durable state a checkpoint carries (params + optimizer tree
        + the AdamW step count), path-keyed per layer."""
        L = self.spec.n_layers
        return {
            "params": {f"l{l}": {"W1": self.W1[l], "W2": self.W2[l]}
                       for l in range(L)},
            "opt": {f"l{l}": {"m1": self.M1[l], "v1": self.V1[l],
                              "m2": self.M2[l], "v2": self.V2[l],
                              "w1": self.MW1[l], "w2": self.MW2[l]}
                    for l in range(L)},
            "step": np.int64(self._step),
        }

    def save_checkpoint(self, ckpt) -> None:
        """Snapshot through CheckpointManager as a UM pressure event: the
        runtime syncs and the dirty device-resident runs of the durable
        state charge their d2h drain before the host copy is taken."""
        ckpt.save(self._step, self.state_tree(), um=self.um,
                  drain=self.plan.checkpoint_ranges())
        self.events.append({"kind": "checkpoint", "step": self._step,
                            "clock": self.um.clock})

    def restore_checkpoint(self, ckpt, step: Optional[int] = None) -> int:
        """Load a snapshot back into the live tensors (in place, so the
        UMBuffer mapping is untouched) and charge the host-side rewrite of
        the restored state."""
        got, tree = ckpt.restore(self.state_tree(), step=step)
        for l in range(self.spec.n_layers):
            p, o = tree["params"][f"l{l}"], tree["opt"][f"l{l}"]
            self.W1[l].copy_(p["W1"])
            self.W2[l].copy_(p["W2"])
            self.M1[l].copy_(o["m1"])
            self.V1[l].copy_(o["v1"])
            self.M2[l].copy_(o["m2"])
            self.V2[l].copy_(o["v2"])
            self.MW1[l].copy_(o["w1"])
            self.MW2[l].copy_(o["w2"])
        self._step = int(tree["step"])
        with self.um.phase("restore"):
            self.um.launch_batch(self.plan.init_launches())
            self.um.sync()
        self.events.append({"kind": "restore", "step": self._step,
                            "clock": self.um.clock})
        return got

    # --------------------------------------------------------------- elastic
    def resize_device_capacity(self, nbytes: int) -> None:
        """Elastic resize mid-run: shrink/grow the modeled device through
        ``runtime.elastic.resize_um_capacity``. Purely a pressure event —
        the next launches see the new headroom and the policy evicts or
        spills; losses cannot change."""
        from repro_torch.runtime import resize_um_capacity

        resize_um_capacity(self.um, nbytes)
        self.capacity = int(nbytes)
        self.events.append({"kind": "resize", "step": self._step,
                            "capacity": int(nbytes), "clock": self.um.clock})

    # ------------------------------------------------------------- lifecycle
    def close(self) -> None:
        """Free the plan's allocations (residency returns to the pre-plan
        baseline) and drop the tensors."""
        self.plan.close()
        for attr in ("W1", "W2", "MW1", "MW2", "M1", "V1", "M2", "V2",
                     "G1", "G2"):
            setattr(self, attr, [])
