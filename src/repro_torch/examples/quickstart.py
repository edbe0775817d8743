"""Quickstart: one forward, one train step, one decode — any assigned arch,
reduced, on ``--device`` (the CUDA card by default).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [arch] [--device cpu]
"""
import argparse

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.kernels.common import resolve_device
from repro_torch.models import RunPolicy, init_cache, init_params
from repro_torch.train import TrainerConfig, make_train_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("arch", nargs="?", default="yi-6b")
    ap.add_argument("--device", default=None,
                    help="torch device of the model; default: the CUDA card")
    args = ap.parse_args(argv)
    arch, dev = args.arch, resolve_device(args.device)
    print(f"archs available: {list_archs()}")
    cfg = get_config(arch).reduced()  # same family, CPU-sized
    print(f"\n== {arch} (reduced: {cfg.num_layers}L d={cfg.d_model}) ==")
    gen = torch.Generator(dev).manual_seed(0)
    model = init_params(cfg, gen, device=dev)
    pol = RunPolicy()

    B, S = 2, 32
    if cfg.input_kind == "embeddings":
        tokens = torch.randn(B, S, cfg.d_model, generator=gen, device=dev)
    else:
        tokens = torch.randint(2, cfg.vocab_size, (B, S), generator=gen,
                               device=dev)
    logits = model(tokens, pol)
    print("forward:", tuple(logits.shape), "->", float(logits.mean()))

    # one train step, two microbatches
    state = make_train_state(cfg, model)
    tc = TrainerConfig(grad_accum=2, total_steps=10, warmup_steps=2)
    step = make_train_step(cfg, pol, tc)
    labels = torch.randint(2, cfg.vocab_size, (B, S), generator=gen,
                           device=dev)
    state, metrics = step(state, {"tokens": tokens, "labels": labels})
    print(f"train step: loss={float(metrics['loss']):.4f} "
          f"grad_norm={float(metrics['grad_norm']):.3f}")

    # prefill, then decode three tokens from an empty cache
    model.prefill(tokens, pol)
    cache = init_cache(cfg, B, S + 8, dtype=torch.float32, device=dev)
    tok = tokens[:, :1]
    for i in range(3):
        lg, cache = model.decode_step(
            tok, torch.full((B,), i, dtype=torch.int32, device=dev), cache, pol)
        nxt = torch.argmax(lg[:, 0], -1)
        print(f"decode step {i}: next={nxt.tolist()}")
        if cfg.input_kind != "embeddings":
            tok = nxt[:, None]


if __name__ == "__main__":
    main()
