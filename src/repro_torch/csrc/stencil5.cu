// One explicit 5-point sweep, out = c + coeff * (N + S + E + W - 4c), with
// replicated (clamped) edges, in fp32. Used by hotspot and srad.
//
// Replaces the Pallas TPU kernel `stencil5_fwd`
// (src/repro/kernels/stencil5/stencil5.py). That kernel tiled rows into
// (TH, W) stripes and passed the input three times so each grid step had its
// neighbour stripes in VMEM; it also needed H % TH == 0. Both were BlockSpec
// workarounds. Here any H and W work and the ragged edge is masked.
//
// Bound on an H100 SXM (3.35 TB/s HBM): memory. A sweep must read 4*H*W bytes
// and write 4*H*W bytes against 7 flops per cell, so at 16384 x 16384 it moves
// 2.15 GB and can take no less than 0.64 ms.
//
// Design: a 32 x 8 thread block computes a 32 x 32 output tile, four rows per
// thread. The tile plus its one-cell halo (34 x 34 floats) is staged in shared
// memory once, with clamped global indices, so each input cell comes from
// device memory about 1.13 times instead of five, and the threads of a warp
// read and write neighbouring addresses. The sum is taken in the plain
// version's order with rounded adds and multiplies (no FMA contraction), so
// the result equals the plain PyTorch version bit for bit.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE_X = 32;
constexpr int TILE_Y = 32;
constexpr int BLOCK_Y = 8;

__device__ __forceinline__ int64_t clamp_index(int64_t i, int64_t n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__global__ void __launch_bounds__(TILE_X * BLOCK_Y)
stencil5_kernel(const float* __restrict__ in, float* __restrict__ out,
                int64_t H, int64_t W, int64_t tiles_x, float coeff) {
  __shared__ float tile[TILE_Y + 2][TILE_X + 2];
  const int64_t x0 = (int64_t)(blockIdx.x % tiles_x) * TILE_X;
  const int64_t y0 = (int64_t)(blockIdx.x / tiles_x) * TILE_Y;

  // stage tile + halo; row r of `tile` holds global row clamp(y0 + r - 1)
  for (int i = threadIdx.y * TILE_X + threadIdx.x; i < (TILE_Y + 2) * (TILE_X + 2);
       i += TILE_X * BLOCK_Y) {
    const int ty = i / (TILE_X + 2);
    const int tx = i % (TILE_X + 2);
    const int64_t gy = clamp_index(y0 + ty - 1, H);
    const int64_t gx = clamp_index(x0 + tx - 1, W);
    tile[ty][tx] = in[gy * W + gx];
  }
  __syncthreads();

  const int tx = threadIdx.x + 1;
  const int64_t gx = x0 + threadIdx.x;
  if (gx >= W) return;
  for (int r = threadIdx.y; r < TILE_Y; r += BLOCK_Y) {
    const int64_t gy = y0 + r;
    if (gy >= H) return;
    const float c = tile[r + 1][tx];
    float s = __fadd_rn(tile[r][tx], tile[r + 2][tx]);  // north + south
    s = __fadd_rn(s, tile[r + 1][tx + 1]);               // + east
    s = __fadd_rn(s, tile[r + 1][tx - 1]);               // + west
    s = __fsub_rn(s, __fmul_rn(4.0f, c));
    out[gy * W + gx] = __fadd_rn(c, __fmul_rn(coeff, s));
  }
}

}  // namespace

// Launches one sweep of `in` (H x W, row-major fp32) into `out` on `stream`,
// on the caller's current device. Returns cudaGetLastError() after the launch.
extern "C" int stencil5_f32(const void* in, void* out, int64_t H, int64_t W,
                            float coeff, void* stream) {
  const int64_t tiles_x = (W + TILE_X - 1) / TILE_X;
  const int64_t tiles = tiles_x * ((H + TILE_Y - 1) / TILE_Y);
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  stencil5_kernel<<<(unsigned)tiles, dim3(TILE_X, BLOCK_Y), 0,
                    (cudaStream_t)stream>>>(
      (const float*)in, (float*)out, H, W, tiles_x, coeff);
  return (int)cudaGetLastError();
}
