"""End to end: train a ~100M-param llama-style LM for a few hundred
steps on the synthetic pipeline, with checkpointing and failure recovery.
The model trains on ``--device`` (the CUDA card by default).

    PYTHONPATH=src python -m repro_torch.examples.train_100m [--steps 200]
        [--fail-at 60] [--ckpt-dir DIR] [--device cpu]
"""
import argparse
import dataclasses
import tempfile

import numpy as np

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import DataLoader, SyntheticLM
from repro_torch.kernels.common import resolve_device
from repro_torch.models import RunPolicy, init_params
from repro_torch.runtime import FailureInjector
from repro_torch.train import Trainer, TrainerConfig, make_train_state, make_train_step

CKPT_EVERY = 25


def config():
    """~100M params: 12L d768 swiglu, vocab 8192 (llama/yi family)."""
    return dataclasses.replace(
        get_config("yi-6b"),
        name="yi-100m", num_layers=12, d_model=768, num_heads=12,
        num_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=8192)


def main(argv=None):
    """Train; returns the Trainer's output (history, restarts, stragglers)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device of the model; default: the CUDA card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = config()
    print(f"params: {cfg.param_count()/1e6:.1f}M")

    state = make_train_state(cfg, init_params(cfg, seed=0, device=dev))
    tc = TrainerConfig(lr=6e-4, grad_accum=1, total_steps=args.steps,
                       warmup_steps=max(2, args.steps // 20))
    step = make_train_step(cfg, RunPolicy(remat=False), tc)
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq,
                     global_batch=args.batch, seed=0)
    loader = DataLoader(ds, device=dev)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="ckpt100m-")
    cm = CheckpointManager(ckpt_dir, keep_last=2)
    inj = FailureInjector.at(args.fail_at) if args.fail_at else None
    tr = Trainer(cfg, state, step, loader, ckpt=cm, ckpt_every=CKPT_EVERY,
                 injector=inj)
    try:
        out = tr.run(args.steps)
    finally:
        loader.close()
    losses = [h["loss"] for h in out["history"]]
    k = max(1, len(losses) // 10)
    print(f"steps={len(losses)} restarts={out['restarts']} "
          f"loss {np.mean(losses[:k]):.4f} -> {np.mean(losses[-k:]):.4f} "
          f"(ckpt: {ckpt_dir})")
    assert np.mean(losses[-k:]) < np.mean(losses[:k]), "loss did not improve"
    return out


if __name__ == "__main__":
    main()
