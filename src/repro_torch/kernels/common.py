"""Device resolution and the build of the port's CUDA kernels.

The kernels are CUDA C++ for ``sm_90a`` under ``src/repro_torch/csrc/``.
:func:`library` builds each source with its own ``nvcc`` (all at once) into
``build/torch_kernels/lib<source>_<hash of source and flags>.so`` at the root
of the checkout, and loads them with ``ctypes``. The build runs at first use
and is reused while the sources are unchanged. A missing ``nvcc`` or a failed
build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import torch

NEG_INF = -1e30

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I32, _I64, _F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                        ctypes.c_float)
# C entry points of each source: name -> argtypes; each returns
# cudaGetLastError() as an int
SIGNATURES = {
    "stencil5": {"stencil5_f32": (_P, _P, _I64, _I64, _F32, _P)},
    "qv_gate": {"qv_gate_c64": (_P, _I64, _I32, _I32, _P, _P)},
}


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card, and raises when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device; pass device='cpu' to run the plain versions")
        return torch.device("cuda")
    return torch.device(device)


@dataclass(frozen=True)
class KernelLibrary:
    fns: dict             # entry point name -> ctypes function
    paths: tuple          # one shared library per source
    build_seconds: float  # 0.0 when earlier builds were loaded
    ptxas_report: str     # nvcc -Xptxas -v output; empty when loaded


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode() + src.read_bytes())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


@functools.cache
def library() -> KernelLibrary:
    """Build what is missing, one ``nvcc`` per source started together, and
    load every kernel's shared library. A build is written under a temporary
    name and renamed, so concurrent builds stay atomic."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {stem: _target(CSRC / f"{stem}.cu") for stem in SIGNATURES}
    todo = [stem for stem, so in targets.items() if not so.exists()]
    t0 = time.perf_counter()
    procs = {stem: subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, str(CSRC / f"{stem}.cu"), "-o",
         f"{targets[stem]}.{os.getpid()}.tmp"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for stem in todo}
    report = {stem: p.communicate()[0] for stem, p in procs.items()}
    for stem, p in procs.items():
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {stem}.cu:\n{report[stem]}")
        os.replace(f"{targets[stem]}.{os.getpid()}.tmp", targets[stem])
    seconds = time.perf_counter() - t0 if todo else 0.0
    fns = {}
    for stem, entries in SIGNATURES.items():
        lib = ctypes.CDLL(str(targets[stem]))
        for name, argtypes in entries.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[name] = fn
    return KernelLibrary(fns, tuple(targets.values()), seconds,
                         "".join(report.values()))


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                        ndim: int) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype``."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be on a CUDA device, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
