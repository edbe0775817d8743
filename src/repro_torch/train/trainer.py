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
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.models.layers import RunPolicy
from repro_torch.models.transformer import (
    TransformerLM,
    grad_mask,
    loss_fn,
    sync_replica_grads,
)
from repro_torch.optim import adamw_init, adamw_update, ef_int8_roundtrip
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.runtime import FailureInjector, SimulatedFailure, StragglerMonitor
from repro_torch.tree import leaves, tree_map


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
    grads."""
    model.requires_grad_(True)
    params = model.params_tree()
    return TrainState(model, {
        "params": params, "opt": adamw_init(params),
        "step": torch.zeros((), dtype=torch.int32, device=model.device)})


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
