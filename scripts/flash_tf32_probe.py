#!/usr/bin/env python3
"""Where the time of the fp32 flash attention kernel goes, on the card.

    python3 scripts/flash_tf32_probe.py

Needs one CUDA card and ``nvcc``. It measures

1. the rate of ``mma.sync`` on the tensor cores with nothing else to do:
   TF32 m16n8k8 and bf16 m16n8k16, eight independent accumulators a warp,
   operands in registers, 2, 4 and 8 blocks of four warps an SM;
2. ``src/repro_torch/csrc/flash_attention.cu`` in fp32 at yi-6b's and
   recurrentgemma-2b's prefill (``chip_smoke.FLASH_FULL``) beside three
   variants built from its text: ``cvt_rna`` rounds to TF32 with the
   ``cvt.rna.tf32.f32`` instruction instead of on the bit pattern (the same
   values); ``no_split`` hands each fp32 value to the tensor cores as its
   own hi and lo piece, so the rounding arithmetic is gone and the three
   products stay; ``one_product`` keeps the arithmetic and takes hi x hi
   alone, a third of the products. The last two give wrong results and
   exist only to be timed: the kernel's time less ``no_split``'s is what
   the splits cost, less ``one_product``'s what two of every three products
   cost. They are timed in turns (each once forward, then once backward)
   by CUDA events.

It prints one JSON line per measurement, then the card's name, power limit
and SM clock as ``nvidia-smi`` gives them. The builds go to
``build/flash_tf32_probe/``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from chip_smoke import FLASH_FULL, flash_inputs, median_ms  # noqa: E402
from repro_torch.kernels.common import (  # noqa: E402
    CSRC,
    NVCC_FLAGS,
    SIGNATURES,
    _nvcc,
)

OUT = ROOT / "build" / "flash_tf32_probe"

MMA_SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>
// iters rounds of eight independent mma.sync a warp on register operands
template <bool TF32>
__global__ void __launch_bounds__(128) mma_loop(float* out, int iters) {
  float c[8][4] = {};
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(threadIdx.x * 1e-3f + i);
  b[0] = a[0];
  b[1] = a[1];
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if constexpr (TF32)
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(c[k][0]), "+f"(c[k][1]), "+f"(c[k][2]), "+f"(c[k][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      else
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(c[k][0]), "+f"(c[k][1]), "+f"(c[k][2]), "+f"(c[k][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
  }
  float s = 0.0f;
  for (int k = 0; k < 8; ++k) s += c[k][0] + c[k][1] + c[k][2] + c[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_loop_run(int tf32, float* out, int blocks, int iters) {
  if (tf32) mma_loop<true><<<blocks, 128>>>(out, iters);
  else mma_loop<false><<<blocks, 128>>>(out, iters);
  return (int)cudaGetLastError();
}
"""

# text substitutions that make the timing variants of flash_attention.cu
VARIANTS = {
    "kernel": [],
    "cvt_rna": [("  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n",
                 "  uint32_t r;\n"
                 "  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(r) : \"f\"(x));\n"
                 "  return r;\n")],
    "no_split": [("    hi = to_tf32(x);\n    lo = to_tf32(x - __uint_as_float(hi));\n",
                  "    hi = __float_as_uint(x);\n    lo = hi;\n")],
    "one_product": [("  if constexpr (A_LO) mma(small, al, bh);\n"
                     "  if constexpr (B_LO) mma(small, ah, bl);\n", "")],
}


def build(name: str, source: str) -> ctypes.CDLL:
    src = OUT / f"{name}.cu"
    src.write_text(source)
    so = OUT / f"lib{name}.so"
    subprocess.run([_nvcc(), *NVCC_FLAGS, str(src), "-o", str(so)],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(so))


def mma_rates() -> None:
    lib = build("mma_loop", MMA_SOURCE)
    lib.mma_loop_run.argtypes = (ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_int)
    iters = 4096
    for tf32, flop in ((1, 2 * 16 * 8 * 8), (0, 2 * 16 * 8 * 16)):
        for per_sm in (2, 4, 8):
            blocks = 132 * per_sm
            out = torch.empty(blocks * 128, device="cuda")

            def run():
                check(lib.mma_loop_run(tf32, out.data_ptr(), blocks, iters))
            ms = median_ms(run, 5, burst=1)
            total = flop * 8 * iters * blocks * 4  # 8 a round, 4 warps a block
            print(json.dumps({
                "probe": "mma.sync",
                "type": "tf32 m16n8k8" if tf32 else "bf16 m16n8k16",
                "blocks_per_sm": per_sm, "ms": ms,
                "tflop_per_s": total / ms / 1e9}), flush=True)


def check(err: int) -> None:
    if err != 0:
        raise RuntimeError(f"launch failed with cudaError {err}")


def flash_variants() -> None:
    text = (CSRC / "flash_attention.cu").read_text()
    fns = {}
    for name, subs in VARIANTS.items():
        src = text
        for old, new in subs:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: the kernel's text changed; "
                                   f"update VARIANTS")
            src = src.replace(old, new)
        fn = build(f"flash_{name}", src).flash_attention_f32
        fn.argtypes = SIGNATURES["flash_attention"]["flash_attention_f32"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    gen = torch.Generator("cuda").manual_seed(0)
    order = list(VARIANTS) + list(VARIANTS)[::-1]
    for arch, (shape, window) in FLASH_FULL.items():
        B, Sq, Sk, H, Hkv, D = shape
        q, k, v = flash_inputs(shape, torch.float32, gen)
        out = torch.empty_like(q)
        times = {name: [] for name in VARIANTS}
        for name in order:
            def run(fn=fns[name]):
                check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), B, Sq, Sk, H, Hkv, D, 1, window,
                         torch.cuda.current_stream().cuda_stream))
            times[name].append(median_ms(run, 10))
        print(json.dumps({"probe": "flash_attention_f32", "arch": arch,
                          "shape": list(shape), "window": window,
                          "ms": times}), flush=True)
        del q, k, v, out
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_tf32_probe: no CUDA device", file=sys.stderr)
        return 1
    OUT.mkdir(parents=True, exist_ok=True)
    mma_rates()
    flash_variants()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
