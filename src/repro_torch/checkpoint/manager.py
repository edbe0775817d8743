"""Checkpointing: atomic, async, logically-addressed (the port of
``repro.checkpoint.manager``, in its on-disk format: each package restores
the other's checkpoints).

Tensors are stored *logically* (full arrays in a npz keyed by their tree
paths, ``params/layers/0/mixer/wq``) with a JSON manifest, so a checkpoint
written on one device restores onto any other — the restore path places
each tensor on the target device. Writes go
to a tmp dir + os.replace (atomic on POSIX); an async writer thread keeps the
training loop off the I/O path with single-slot backpressure; `keep_last`
prunes old steps after a successful commit.

Integrity: the manifest records a crc32 per tensor at save time; restore
recomputes and rejects any mismatch (or a truncated/unreadable archive,
or a shape/dtype drift) with :class:`CheckpointCorruptError` — a corrupted
checkpoint must fail loudly at restore, never resume training on garbage.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zipfile
import zlib
from typing import Optional

import numpy as np
import torch

from repro_torch.tree import flatten as _flatten
from repro_torch.tree import tree_map
from repro_torch.tree import unflatten_into as _unflatten_into


class CheckpointCorruptError(RuntimeError):
    """The checkpoint on disk fails its integrity checks (truncated
    archive, missing tensor, shape/dtype drift, or crc32 mismatch)."""


def _crc32(v) -> int:
    return zlib.crc32(np.ascontiguousarray(v).tobytes()) & 0xFFFFFFFF


def _to_host(a) -> np.ndarray:
    """A host copy of a leaf (tensor, numpy array or scalar): the live state
    may change in place while the async writer runs."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", copy=True).numpy()
    return np.array(a)


def _like(template_leaf, value: np.ndarray, device):
    """``value`` as the template's kind of leaf: a tensor (on ``device``,
    else on the CPU) for a tensor, the numpy array otherwise."""
    if isinstance(template_leaf, torch.Tensor):
        t = torch.from_numpy(value)
        return t.to(device) if device is not None else t
    return value


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep_last = keep_last
        self.async_save = async_save
        os.makedirs(directory, exist_ok=True)
        self._inflight: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, state, *, um=None, drain=()) -> None:
        """Snapshot ``state`` (async unless configured otherwise).

        For UM-backed state pass the runtime as ``um`` and the durable
        buffers/views as ``drain``: the save then behaves as a memory
        pressure event at the step boundary — ``um.sync()`` first (policy-
        deferred migrations land before the snapshot is consistent), then
        the dirty device-resident runs of ``drain`` charge their d2h
        writeback via :meth:`~repro.core.umem.UnifiedMemory.drain_dirty`.
        The drain moves no pages and clears no dirty bits, so a save mid-
        oversubscription neither leaks residency nor perturbs any later
        step's charges."""
        if um is not None:
            um.sync()
            um.drain_dirty(drain)
        host = tree_map(_to_host, state)
        self.wait()
        if self.async_save:
            self._inflight = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._inflight.start()
        else:
            self._write(step, host)

    def wait(self) -> None:
        if self._inflight is not None:
            self._inflight.join()
            self._inflight = None

    def _write(self, step: int, host_state) -> None:
        flat = _flatten(host_state)
        tmp = os.path.join(self.dir, f".tmp-{step}")
        final = os.path.join(self.dir, f"step-{step:09d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "tensors.npz"),
                 **{k: v for k, v in flat.items()})
        manifest = {
            "step": step,
            "keys": {k: {"shape": list(np.shape(v)),
                         "dtype": str(np.asarray(v).dtype),
                         "crc32": _crc32(v)} for k, v in flat.items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic commit
        self._prune()

    def _prune(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep_last] if self.keep_last else []:
            shutil.rmtree(os.path.join(self.dir, f"step-{s:09d}"), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step-"):
                out.append(int(d.split("-")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None, device=None):
        """``(step, tree)``: the checkpoint at ``step`` (the latest when None)
        in ``template``'s structure, a tensor (on ``device``, else on the
        CPU) where the template holds a tensor and a numpy array elsewhere.
        The template's own leaves are not touched."""
        if step is None:
            step = self.latest_step()
        assert step is not None, "no checkpoint found"
        path = os.path.join(self.dir, f"step-{step:09d}")
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
            with np.load(os.path.join(path, "tensors.npz")) as z:
                flat = {k: z[k] for k in z.files}
        except (OSError, ValueError, json.JSONDecodeError,
                zipfile.BadZipFile, zlib.error) as e:
            raise CheckpointCorruptError(
                f"checkpoint step {step} unreadable: {e}") from e
        for k, meta in manifest.get("keys", {}).items():
            if k not in flat:
                raise CheckpointCorruptError(
                    f"checkpoint step {step}: tensor {k!r} missing from "
                    "archive")
            v = flat[k]
            if (list(np.shape(v)) != list(meta["shape"])
                    or str(v.dtype) != meta["dtype"]):
                raise CheckpointCorruptError(
                    f"checkpoint step {step}: tensor {k!r} is "
                    f"{v.dtype}{np.shape(v)}, manifest says "
                    f"{meta['dtype']}{tuple(meta['shape'])}")
            # crc32 absent = checkpoint from an older writer: shape/dtype
            # checks still apply, content check is skipped
            if "crc32" in meta and _crc32(v) != meta["crc32"]:
                raise CheckpointCorruptError(
                    f"checkpoint step {step}: tensor {k!r} fails its crc32 "
                    "content check — the file was corrupted after save")
        tree = tree_map(lambda t, v: _like(t, v, device), template,
                        _unflatten_into(template, flat))
        return step, tree
