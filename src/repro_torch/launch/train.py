"""Training launcher: --arch <id> over a data x model mesh of ranks (the port
of ``repro.launch.train``), on the CUDA card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --reduced \\
        --steps 50 --batch 4 --seq 64 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --reduced \\
        --steps 4 --batch 4 --seq 32 --data 2 --model 2 --device cpu

``main(argv)`` runs one rank. With ``--data D --model M`` and no world
started yet, it starts D x M ranks itself (``torch.multiprocessing.spawn``,
rendezvous on a free localhost port); under ``torchrun`` each process is a
rank of the world that RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT
describe. A single rank joins a world of one. The backend is NCCL when each
rank has a card of its own, gloo on the CPU or when ranks share a card.
Weights are random from ``--seed``, made whole on every rank and cut to its
shards; each rank loads the global batch and trains on its data rank's
rows. Rank 0 prints the reference's summary line. ``--layers`` cuts the
depth of the arch.
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import DataLoader, SyntheticLM
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.mesh import (
    end_world,
    free_port,
    make_host_mesh,
    set_rank_device,
    start_world,
    world_from_env,
)
from repro_torch.launch.sharding import make_run_policy, shard_model_
from repro_torch.models import init_params
from repro_torch.runtime import FailureInjector
from repro_torch.train import Trainer, TrainerConfig, make_train_state, make_train_step


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the arch to this many layers (0: all)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data", type=int, default=1, help="data-parallel axis")
    ap.add_argument("--model", type=int, default=1, help="tensor-parallel axis")
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    return ap


def _backend(device: torch.device, world: int) -> str:
    if device.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def _rank_main(rank: int, argv, world: int, port: int, backend: str) -> None:
    """One spawned rank."""
    torch.set_num_threads(1)
    start_world(rank, world, backend=backend, port=port)
    try:
        _run(_parser().parse_args(argv))
    finally:
        end_world()


def main(argv=None) -> dict:
    """Run this process's rank (spawning the world first where none is
    started and it has more than one rank). Returns {'history', 'restarts',
    'state', 'mesh', 'backend'} of this rank; {} in a parent that spawned
    the ranks."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    world = args.data * args.model
    started = False
    if not dist.is_initialized():
        if world_from_env():
            dist.init_process_group(_backend(device, world))
            started = True
        elif world > 1:
            torch.multiprocessing.spawn(
                _rank_main, nprocs=world,
                args=(argv, world, free_port(), _backend(device, world)))
            return {}
        else:
            start_world(0, 1, backend=_backend(device, 1), port=free_port())
            started = True
    try:
        return _run(args)
    finally:
        if started:
            end_world()


def _run(args) -> dict:
    rank = dist.get_rank()
    device = set_rank_device(resolve_device(args.device),
                             int(os.environ.get("LOCAL_RANK", rank)))
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    mesh = make_host_mesh(data=args.data, model=args.model)
    tp = args.model
    model = init_params(cfg, seed=args.seed, dtype=torch.float32, tp=tp,
                        device=device)
    shard_model_(model, mesh)
    policy = make_run_policy(mesh, remat=True)
    state = make_train_state(cfg, model)
    tc = TrainerConfig(lr=args.lr, total_steps=args.steps,
                       warmup_steps=max(1, args.steps // 10),
                       grad_accum=args.accum, tp=tp,
                       compress_grads=args.compress_grads)
    step = make_train_step(cfg, policy, tc)
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq,
                     global_batch=args.batch, seed=args.seed,
                     emb_dim=cfg.d_model if cfg.input_kind == "embeddings" else 0)
    loader = DataLoader(ds, device=device)
    ckpt = None
    if args.ckpt_dir:  # each rank checkpoints its own shards
        ckpt = CheckpointManager(args.ckpt_dir if mesh.size == 1 else
                                 os.path.join(args.ckpt_dir, f"rank{rank}"))
    injector = FailureInjector.at(args.fail_at) if args.fail_at else None
    trainer = Trainer(cfg, state, step, loader, ckpt=ckpt,
                      injector=injector, ckpt_every=args.ckpt_every)
    try:
        out = trainer.run(args.steps)
    finally:
        loader.close()
    losses = [h["loss"] for h in out["history"]]
    if rank == 0:
        print(f"arch={args.arch} steps={len(losses)} restarts={out['restarts']} "
              f"first_loss={losses[0]:.4f} last_loss={losses[-1]:.4f} "
              f"mean_dt={np.mean([h['dt'] for h in out['history']]):.3f}s",
              flush=True)
    return {"history": out["history"], "restarts": out["restarts"],
            "state": trainer.state, "mesh": mesh, "backend": dist.get_backend()}


if __name__ == "__main__":
    main()
