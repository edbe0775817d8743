"""Step functions of the dry-run: one rank's work per cell, on fake tensors
(the port of ``repro.launch.steps``).

``make_artifacts`` runs under ``FakeTensorMode`` on a started world (the
``fake`` backend's 256 or 512 ranks): it builds the model at the mesh's
tensor-parallel layout, cuts it to this rank's shards, makes this rank's
local inputs, and returns the artifacts of the cell's kind as callables:

  train   -> 'micro_grads' (one microbatch fwd+bwd with remat),
             'opt_update' (the grads reduced over the data axes, once a
             step as the port's sharded step reduces them, and the ZeRO-1
             update)
  prefill -> 'prefill' (block-causal attention beyond ``attn_block``)
  decode  -> 'decode'  (one token against a dense cache)

each under ``sequence_parallel`` where asked (the residual split on the
sequence over the model axis; decode, at one token, runs as without it),
plus ``__meta__`` (``accum``, ``micro``: the microbatch loop of a train cell)
and ``__memory__`` ('train_memory', 'prefill_memory' or 'decode_memory':
the artifacts whose one trace gives the cell's peak memory). A torch trace
runs every layer, so the JAX package's unrolled-vs-scanned variants (XLA's
cost analysis visits a while body once) are unnecessary: the ``*_memory``
artifacts are the same trace's peak.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig, RunShape
from repro_torch.launch.analysis import tensor_bytes
from repro_torch.launch.mesh import dp_size, tp_size
from repro_torch.launch.sharding import (
    batch_spec,
    cache_specs_tree,
    make_run_policy,
    shard_model_,
)
from repro_torch.models.cache import init_cache
from repro_torch.models.parallel import local_chunk
from repro_torch.models.transformer import TransformerLM, loss_fn
from repro_torch.train.trainer import (
    TrainerConfig,
    make_train_state,
    reduce_grads,
    sharded_update,
)
from repro_torch.tree import leaves


def _tokens(cfg: ArchConfig, B: int, S: int, dtype):
    if cfg.input_kind == "embeddings":
        return torch.empty((B, S, cfg.d_model), dtype=dtype)
    return torch.empty((B, S), dtype=torch.int32)


def _local_rows(mesh, B: int) -> int:
    """This rank's rows of a batch of B (``batch_spec``: split over the DP
    axes where they divide it, else replicated)."""
    return B // dp_size(mesh) if batch_spec(mesh, ndim=1, batch_size=B)[0] else B


def make_artifacts(cfg: ArchConfig, shape: RunShape, mesh, *,
                   dtype=torch.bfloat16, attn_block: int = 4096,
                   sequence_parallel: bool = False,
                   extra_policy: Optional[Dict[str, Any]] = None
                   ) -> Dict[str, Any]:
    """{artifact: callable, '__meta__': {...}, '__memory__': (name,
    [artifacts]), '__arguments__': bytes of this rank's inputs}. Call under
    ``FakeTensorMode``."""
    tp = tp_size(mesh)
    B, S = shape.global_batch, shape.seq_len
    blk = min(attn_block, S)
    pol_kw = dict(remat=False,
                  attn_q_block=blk if S > attn_block else 0,
                  attn_kv_block=blk if S > attn_block else 0,
                  sequence_parallel=sequence_parallel)
    if extra_policy:
        pol_kw.update(extra_policy)
    model = TransformerLM(cfg, tp=tp, dtype=dtype, device="cpu")
    shard_model_(model, mesh)
    params = leaves(model.params_tree())
    out: Dict[str, Any] = {}

    if shape.kind == "train":
        micro = min(max(dp_size(mesh), B // shape.grad_accum), B)
        accum = B // micro
        rows = _local_rows(mesh, micro)
        batch = {"tokens": _tokens(cfg, rows, S, dtype),
                 "labels": torch.empty((rows, S), dtype=torch.int32)}
        state = make_train_state(cfg, model)
        tc = TrainerConfig(lr=3e-4, warmup_steps=100, total_steps=10_000, tp=tp)
        policy = make_run_policy(mesh, **dict(pol_kw, remat=True))

        def micro_grads():
            loss, _ = loss_fn(model, batch, policy)
            loss.backward()
            return loss

        def opt_update():
            reduce_grads(params, mesh.dp, accum)
            return sharded_update(cfg, tc, state, mesh, tc.lr)

        out["micro_grads"] = micro_grads
        out["opt_update"] = opt_update
        out["__meta__"] = {"accum": accum, "micro": micro}
        out["__memory__"] = ("train_memory", ["micro_grads", "opt_update"])
        args = params + leaves(state["opt"]) + list(batch.values())
    elif shape.kind == "prefill":
        tokens = _tokens(cfg, _local_rows(mesh, B), S, dtype)
        policy = make_run_policy(mesh, **pol_kw)

        def prefill():
            with torch.no_grad():
                return model._run(tokens, policy, last_only=True)

        out["prefill"] = prefill
        out["__memory__"] = ("prefill_memory", ["prefill"])
        args = params + [tokens]
    elif shape.kind == "decode":
        rows = _local_rows(mesh, B)
        policy = make_run_policy(mesh, **pol_kw)
        full = init_cache(cfg, B, S, tp=tp, dtype=dtype,
                          kv_quant=policy.kv_cache_quant, device="cpu")
        specs = cache_specs_tree(full, mesh, B)
        cache = [{k: local_chunk(v, specs[i][k], mesh).clone()
                  for k, v in c.items()} for i, c in enumerate(full)]
        del full
        tokens = _tokens(cfg, rows, 1, dtype)
        pos = torch.empty((rows,), dtype=torch.int32)

        def decode():
            return model.decode_step(tokens, pos, cache, policy)

        out["decode"] = decode
        out["__memory__"] = ("decode_memory", ["decode"])
        args = params + leaves(cache) + [tokens, pos]
    else:
        raise ValueError(shape.kind)
    out["__arguments__"] = tensor_bytes(args)
    return out
