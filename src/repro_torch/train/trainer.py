"""Training loop: the microbatched train step and the fault-tolerant loop
(the port of ``repro.train.trainer``).

:func:`make_train_step` builds the step:
  * gradient accumulation over contiguous microbatches, the grads summed in
    fp32 by autograd and divided by the microbatch count, the loss the mean
    of the microbatch losses (``lax.scan`` in the JAX package);
  * the exactness hooks of a padded TP head layout (grad mask + KV-replica
    grad sync, models/transformer.py);
  * optional int8 + error-feedback compression of the accumulated grads;
  * AdamW with fp32 master weights, in place (optim/adamw.py).

The train state is the JAX package's tree, ``{'params', 'opt': {'m', 'v',
'master', 'count'}, 'step'}`` with ``count`` and ``step`` int32 scalars, so a
checkpoint of either package restores into the other; its ``params`` leaves
are the model's own parameters. :class:`Trainer` drives the loop:
checkpoint cadence, failure recovery (restore + deterministic data replay),
straggler monitoring.

On a mesh (a model sharded by ``launch.sharding.shard_model_`` and a policy
from ``make_run_policy``) the step is the sharded one: each rank takes its
data rank's rows of every microbatch, the gradients are summed over the
data-parallel axes, the padded-TP hooks and int8 compression see the whole
(gathered) tensors, and AdamW runs ZeRO-1: ``m``, ``v`` and ``master`` are
this rank's slices per ``zero1_specs``, each rank updates its slice and the
params are all-gathered over the data axes. (The fp32 master cannot alias a
parameter whose state is sliced; it does where a leaf has no ZeRO dim.) The
state's trees then hold this rank's shards.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.models.layers import RunPolicy
from repro_torch.models.parallel import (
    all_gather,
    all_reduce_,
    gather_full,
    local_chunk,
    local_slice,
    spec_leaves,
    zero_dim,
)
from repro_torch.models.transformer import (
    TransformerLM,
    grad_mask,
    loss_fn,
    sync_replica_grads,
)
from repro_torch.optim import adamw_init, adamw_update, ef_int8_roundtrip
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.runtime import FailureInjector, SimulatedFailure, StragglerMonitor
from repro_torch.tree import flatten, leaves, tree_map, unflatten_into


@dataclass
class TrainerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    grad_accum: int = 1
    ckpt_every: int = 50
    compress_grads: bool = False  # int8 + error feedback on the accumulated grads
    tp: int = 1


class TrainState(dict):
    """The train state tree; ``model`` is the module whose parameters are
    the leaves under ``'params'``."""

    def __init__(self, model: TransformerLM, tree: Dict[str, Any]):
        super().__init__(tree)
        self.model = model


def make_train_state(cfg, model: TransformerLM) -> TrainState:
    """Zero AdamW state and step 0 for ``model``, whose parameters now take
    grads. For a sharded model the moments and master weights are this
    rank's ZeRO-1 slices."""
    model.requires_grad_(True)
    params = model.params_tree()
    mesh = getattr(model, "mesh", None)
    if mesh is None:
        opt = adamw_init(params)
    else:
        opt = _zero1_init(params, _zero_dims(model), mesh.dp)
    return TrainState(model, {
        "params": params, "opt": opt,
        "step": torch.zeros((), dtype=torch.int32, device=model.device)})


def _check_sharded(model, mesh) -> None:
    """``model`` must have been cut to its shards on ``mesh`` (by
    ``launch.sharding.shard_model_``, which records ``model.mesh``,
    ``model.param_specs`` and ``model.zero_specs``)."""
    if getattr(model, "mesh", None) is not mesh:
        raise ValueError("the model is not sharded on the policy's mesh: "
                         "call launch.sharding.shard_model_(model, mesh) "
                         "before make_train_state")


def _zero_dims(model) -> list:
    """Per param leaf, the dim its optimizer state is sliced on over the
    data-parallel axes, or None (ZeRO-1, ``launch.sharding.zero1_specs``)."""
    return [zero_dim(p, z) if model.mesh.dp.size > 1 else None
            for p, z in zip(spec_leaves(model.param_specs),
                            spec_leaves(model.zero_specs))]


def _zero1_init(params, zdims, dp):
    """AdamW state over this rank's ZeRO-1 slices (the fp32 master aliases
    a parameter that has no slice, as ``adamw_init`` does)."""
    paths = list(flatten(params))
    flat = leaves(params)
    parts = [p.detach() if zd is None else local_slice(p.detach(), zd, dp)
             for p, zd in zip(flat, zdims)]

    def tree(xs):
        return unflatten_into(params, dict(zip(paths, xs)))

    return {
        "m": tree([torch.zeros_like(q, dtype=torch.float32) for q in parts]),
        "v": tree([torch.zeros_like(q, dtype=torch.float32) for q in parts]),
        "master": tree([p if zd is None and p.dtype == torch.float32
                        else q.float().clone()
                        for p, q, zd in zip(flat, parts, zdims)]),
        "count": torch.zeros((), dtype=torch.int32, device=flat[0].device)}


@torch.no_grad()
def load_state_(state, tree) -> None:
    """Copy a tree of ``state``'s structure (a restored checkpoint) into the
    live state, leaf by leaf."""
    for dst, src in zip(leaves(state), leaves(tree)):
        if not isinstance(src, torch.Tensor):  # numpy, maybe read-only
            src = torch.from_numpy(np.array(src))
        dst.copy_(src)


def make_train_step(cfg, policy: RunPolicy, tc: TrainerConfig):
    """Returns step(state, batch, [err]) -> (state, metrics[, err]).

    The state is updated in place and returned; ``metrics`` holds the loss,
    the grad norm before the clip and the learning rate as 0-d tensors.
    With ``tc.compress_grads`` and an ``err`` tree (fp32 zeros of the
    params' structure to start) the grads go through int8 error feedback
    and the new residuals come back as the third value."""
    lr_fn = warmup_cosine(tc.lr, tc.warmup_steps, tc.total_steps)
    if policy.mesh is not None:
        return _make_sharded_step(cfg, policy, tc, lr_fn)

    def step(state, batch, err=None):
        model, params = state.model, state["params"]
        B = batch["labels"].shape[0]
        accum = tc.grad_accum
        if B % accum:
            raise ValueError(f"batch {B} does not split into {accum} microbatches")
        plist = leaves(params)
        for p in plist:
            p.grad = None
        n = B // accum
        loss_sum = 0.0
        for i in range(accum):
            mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            loss, _ = loss_fn(model, mb, policy)
            loss.backward()
            loss_sum = loss_sum + loss.detach()
        with torch.no_grad():
            for p in plist:
                if p.grad is None:  # a parameter the pass never reached
                    p.grad = torch.zeros_like(p)
                elif accum > 1:
                    p.grad.div_(accum)
        loss = loss_sum / accum if accum > 1 else loss_sum
        grads = tree_map(lambda p: p.grad, params)

        # exact padded-TP hooks
        sync_replica_grads(cfg, grads, tc.tp)
        with torch.no_grad():
            for g, m in zip(leaves(grads), leaves(grad_mask(cfg, params, tc.tp))):
                if m is not None:
                    g.mul_(m)
            if tc.compress_grads and err is not None:
                for g, e in zip(leaves(grads), leaves(err)):
                    deq, new_e = ef_int8_roundtrip(g, e)
                    g.copy_(deq)
                    e.copy_(new_e)

        lr = lr_fn(state["step"])
        gnorm = adamw_update(grads, state["opt"], params, lr=lr,
                             weight_decay=tc.weight_decay,
                             clip_norm=tc.clip_norm)
        for p in plist:
            p.grad = None
        state["step"].add_(1)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        if tc.compress_grads and err is not None:
            return state, metrics, err
        return state, metrics

    return step


def _make_sharded_step(cfg, policy: RunPolicy, tc: TrainerConfig, lr_fn):
    """The step on ``policy.mesh`` (see the module docstring), for a model
    sharded on that mesh (checked at each call). The batch is the global
    batch; ``err`` trees are full-shape (as the gathered grads)."""
    mesh = policy.mesh
    dp = mesh.dp

    def step(state, batch, err=None):
        model = state.model
        _check_sharded(model, mesh)
        B = batch["labels"].shape[0]
        accum = tc.grad_accum
        if B % accum or (B // accum) % dp.size:
            raise ValueError(f"batch {B} does not split into {accum} "
                             f"microbatches over {dp.size} data ranks")
        plist = leaves(state["params"])
        for p in plist:
            p.grad = None
        n = B // accum
        nl = n // dp.size
        loss_sum = 0.0
        for i in range(accum):
            lo = i * n + dp.rank * nl
            mb = {k: v[lo:lo + nl] for k, v in batch.items()}
            loss, _ = loss_fn(model, mb, policy)  # this rank's share
            loss.backward()
            loss_sum = loss_sum + loss.detach()
        with torch.no_grad():
            loss = all_reduce_(loss_sum / accum if accum > 1 else loss_sum, dp)
        reduce_grads(plist, dp, accum)
        lr = lr_fn(state["step"])
        gnorm = sharded_update(cfg, tc, state, mesh, lr, err)
        for p in plist:
            p.grad = None
        state["step"].add_(1)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        if tc.compress_grads and err is not None:
            return state, metrics, err
        return state, metrics

    return step


@torch.no_grad()
def reduce_grads(plist, dp, accum: int = 1) -> None:
    """Sum the parameters' ``.grad`` over the data-parallel axis ``dp`` and
    divide by the microbatch count, in place (zeros for a parameter the
    pass never reached)."""
    for p in plist:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        all_reduce_(p.grad, dp)
        if accum > 1:
            p.grad.div_(accum)


@torch.no_grad()
def sharded_update(cfg, tc: TrainerConfig, state, mesh, lr,
                   err=None) -> torch.Tensor:
    """The update of a sharded step on ``mesh`` from the reduced ``.grad``
    of the state's parameters: the padded-TP hooks and the int8 compression
    on the whole (gathered) tensors, the global grad norm, AdamW on this
    rank's ZeRO-1 slices, and the params all-gathered over the data axes.
    Returns the grad norm before the clip."""
    model, params = state.model, state["params"]
    _check_sharded(model, mesh)
    dp, tp = mesh.dp, mesh.tp
    pspecs = spec_leaves(model.param_specs)
    zdims = _zero_dims(model)
    plist = leaves(params)
    grads = tree_map(lambda p: p.grad, params)
    sync_replica_grads(cfg, grads, tc.tp, axis=tp)
    for g, m, spec in zip(leaves(grads), leaves(grad_mask(cfg, params, tc.tp)),
                          pspecs):
        if m is not None:  # the mask's dims that broadcast stay whole
            g.mul_(local_chunk(m, tuple(e if m.shape[i] > 1 else None
                                        for i, e in enumerate(spec)), mesh))
    if tc.compress_grads and err is not None:
        for g, e, spec in zip(leaves(grads), leaves(err), pspecs):
            deq, new_e = ef_int8_roundtrip(gather_full(g, spec, mesh), e)
            g.copy_(local_chunk(deq, spec, mesh))
            e.copy_(new_e)

    # the global norm: the squares of leaves sharded over 'model' summed
    sq = [n * n for n in torch._foreach_norm([g.float() for g in leaves(grads)])]
    sharded = [i for i, s in enumerate(pspecs) if "model" in s]
    if sharded and tp.size > 1:
        red = all_reduce_(torch.stack([sq[i] for i in sharded]), tp)
        for j, i in enumerate(sharded):
            sq[i] = red[j]
    gnorm = torch.sqrt(sum(sq))

    def part(t, zd):
        return t if zd is None else local_slice(t, zd, dp)

    adamw_update([part(g, zd) for g, zd in zip(leaves(grads), zdims)],
                 state["opt"], [part(p.data, zd) for p, zd in zip(plist, zdims)],
                 lr=lr, weight_decay=tc.weight_decay, clip_norm=tc.clip_norm,
                 grad_norm=gnorm)
    for p, zd in zip(plist, zdims):
        if zd is not None:
            p.data.copy_(all_gather(local_slice(p.data, zd, dp), zd, dp))
    return gnorm


class Trainer:
    """Fault-tolerant training loop (single-controller)."""

    def __init__(self, cfg, state, step_fn, loader, *,
                 ckpt: Optional[CheckpointManager] = None,
                 injector: Optional[FailureInjector] = None,
                 monitor: Optional[StragglerMonitor] = None,
                 ckpt_every: int = 50,
                 clock: Optional[Callable[[], float]] = None):
        """``clock`` is the time source for per-step durations (history
        ``dt`` and the straggler monitor). Default is wall clock; a run
        whose memory system goes through UnifiedMemory should pass the
        modeled clock — ``clock=lambda: um.clock`` — so training metrics
        are directly comparable to the serve stack's ``ServeEngine.now()``
        timings instead of mixing modeled and wall seconds. Each step's
        loss is read to the host (one sync a step), so a wall-clock ``dt``
        covers the step's device work."""
        self.cfg = cfg
        self.state = state
        self.step_fn = step_fn
        self.loader = loader
        self.ckpt = ckpt
        self.injector = injector
        self.monitor = monitor or StragglerMonitor()
        self.ckpt_every = ckpt_every
        self.clock = clock or time.perf_counter
        self.history: list = []
        self.restarts = 0

    def run(self, num_steps: int) -> Dict[str, Any]:
        done = 0
        while done < num_steps:
            try:
                step_idx, batch = next(self.loader)
                t0 = self.clock()
                if self.injector is not None:
                    self.injector.maybe_fail(step_idx)
                self.state, metrics = self.step_fn(self.state, batch)
                loss = float(metrics["loss"])
                dt = self.clock() - t0
                self.monitor.record("worker0", dt)
                self.history.append({"step": step_idx, "loss": loss, "dt": dt})
                done += 1
                if self.ckpt is not None and (step_idx + 1) % self.ckpt_every == 0:
                    self.ckpt.save(step_idx + 1, self.state)
            except SimulatedFailure:
                # restore-and-replay: deterministic pipeline guarantees the
                # same batches stream again from the restored step
                self.restarts += 1
                assert self.ckpt is not None, "failure without checkpointing"
                self.ckpt.wait()
                step, tree = self.ckpt.restore(self.state)
                load_state_(self.state, tree)
                self.loader.seek(step)
        if self.ckpt is not None:
            self.ckpt.wait()
        return {"history": self.history, "restarts": self.restarts,
                "stragglers": self.monitor.stragglers()}
