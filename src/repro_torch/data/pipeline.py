"""Data pipeline: deterministic synthetic LM stream + prefetching loader (the
port of ``repro.data.pipeline``; ``SyntheticLM`` draws with numpy exactly as
the JAX package's does, so the batches are equal bit for bit).

Deterministic per (seed, step): restart-safe — resuming from a checkpoint at
step k reproduces the exact batch sequence, which the fault-tolerance tests
rely on. Documents are sampled with power-law lengths and packed into fixed
seq_len rows with EOS separators (realistic label masking at pack joints).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device

EOS = 1
PAD_LABEL = -1


@dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: int = 512
    emb_dim: int = 0  # >0: emit embeddings (vlm/audio backbone stubs)

    def batch(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (tokens, labels); tokens (B,S) int32 or (B,S,E) f32."""
        rng = np.random.default_rng((self.seed << 20) ^ step)
        B, S = self.global_batch, self.seq_len
        toks = np.empty((B, S), np.int32)
        labels = np.empty((B, S), np.int32)
        for b in range(B):
            row = []
            while len(row) < S + 1:
                ln = max(8, int(rng.pareto(2.0) * self.mean_doc_len))
                doc = rng.integers(2, self.vocab_size, size=ln)
                row.extend(doc.tolist())
                row.append(EOS)
            row = np.asarray(row[: S + 1], np.int32)
            toks[b] = row[:-1]
            labels[b] = row[1:]
            labels[b][row[:-1] == EOS] = PAD_LABEL  # don't predict across joints
        if self.emb_dim:
            emb = rng.standard_normal((B, S, self.emb_dim), np.float32)
            return emb, labels
        return toks, labels


class DataLoader:
    """Background-thread prefetching iterator with explicit step state.
    Batches come out as tensors on ``device`` (the CUDA card unless the
    caller passes ``device="cpu"``), or through ``shard_fn`` when given."""

    def __init__(self, ds: SyntheticLM, start_step: int = 0, prefetch: int = 2,
                 shard_fn=None, device=None):
        self.ds = ds
        self.step = start_step
        if shard_fn is None:
            dev = resolve_device(device)
            shard_fn = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
        self.shard_fn = shard_fn
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            batch = self.ds.batch(step)
            try:
                self._q.put((step, batch), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __next__(self):
        step, (tokens, labels) = self._q.get()
        self.step = step + 1
        return step, {"tokens": self.shard_fn(tokens), "labels": self.shard_fn(labels)}

    def seek(self, step: int) -> None:
        """Rewind/advance the stream to `step` (checkpoint restore path)."""
        self._stop.set()
        self._thread.join(timeout=2)
        while not self._q.empty():
            self._q.get_nowait()
        self.step = step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def __iter__(self) -> Iterator:
        return self

    def close(self):
        self._stop.set()
        while not self._q.empty():
            self._q.get_nowait()
        self._thread.join(timeout=2)
