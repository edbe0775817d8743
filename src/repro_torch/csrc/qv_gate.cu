// psi' = G psi for a 4 x 4 complex gate on qubits (q1, q2) of a complex64
// statevector of 2^n amplitudes, updated in place. Qubit q is bit q of the
// flat index, and gate row r = 2 * bit(q1) + bit(q2) addresses amplitude
// base | b1 << q1 | b2 << q2 (src/repro/kernels/qv_gate/ref.py).
//
// Replaces the Pallas TPU kernel `qv_gate_panel`
// (src/repro/kernels/qv_gate/qv_gate.py) and its wrapper's permutes
// (src/repro/kernels/qv_gate/ops.py): the TPU version copied the statevector
// into a (4, M) panel with the two target qubits leading, ran four real
// matmuls on split re/im planes and copied back. Here there are no copies.
//
// Bound on an H100 SXM (3.35 TB/s HBM): memory. A gate must read and write
// every amplitude once, 16 * 2^n bytes against 32 flops per amplitude, so at
// n = 31 it moves 34.4 GB and can take no less than 10.3 ms.
//
// Design: one thread per amplitude quadruple, 2^(n-2) threads. A thread builds
// its base index by inserting zero bits at min(q1, q2) and max(q1, q2), loads
// its four amplitudes, does the 4 x 4 complex product with fp32 FMAs and
// stores the four results over them. No two threads share an amplitude, so the
// update is in place and needs no second buffer. The gate travels by value as
// a 128-byte kernel argument, so nothing is allocated on the device for it.
// Indices are 64-bit: from n = 31 the amplitude count passes 2^31.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;

struct Gate {
  float2 m[16];  // row-major 4 x 4
};

__device__ __forceinline__ int64_t insert_zero_bit(int64_t i, int bit) {
  const int64_t low = i & ((int64_t(1) << bit) - 1);
  return ((i >> bit) << (bit + 1)) | low;
}

__global__ void __launch_bounds__(BLOCK)
qv_gate_kernel(float2* __restrict__ psi, int64_t n_quads, int lo, int hi,
               int64_t m1, int64_t m2, Gate g) {
  const int64_t t = (int64_t)blockIdx.x * BLOCK + threadIdx.x;
  if (t >= n_quads) return;
  const int64_t base = insert_zero_bit(insert_zero_bit(t, lo), hi);
  const int64_t idx[4] = {base, base | m2, base | m1, base | m1 | m2};
  float2 x[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) x[c] = psi[idx[c]];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float re = 0.0f, im = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float2 a = g.m[4 * r + c];
      re = fmaf(a.x, x[c].x, re);
      re = fmaf(-a.y, x[c].y, re);
      im = fmaf(a.x, x[c].y, im);
      im = fmaf(a.y, x[c].x, im);
    }
    psi[idx[r]] = make_float2(re, im);
  }
}

}  // namespace

// Applies `gate` (host pointer to 16 complex64 values, row-major) to qubits
// (q1, q2) of `state` (2^n_qubits complex64 on the device) on `stream`, on
// the caller's current device. Returns cudaGetLastError() after the launch.
extern "C" int qv_gate_c64(void* state, int64_t n_qubits, int q1, int q2,
                           const void* gate, void* stream) {
  Gate g;
  const float2* src = (const float2*)gate;
  for (int i = 0; i < 16; ++i) g.m[i] = src[i];
  const int64_t n_quads = int64_t(1) << (n_qubits - 2);
  const int64_t blocks = (n_quads + BLOCK - 1) / BLOCK;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  const int lo = q1 < q2 ? q1 : q2;
  const int hi = q1 < q2 ? q2 : q1;
  qv_gate_kernel<<<(unsigned)blocks, BLOCK, 0, (cudaStream_t)stream>>>(
      (float2*)state, n_quads, lo, hi, int64_t(1) << q1, int64_t(1) << q2, g);
  return (int)cudaGetLastError();
}
