// Decode attention over a paged KV pool: one query token per sequence, with
// grouped-query heads. For sequence b and query head h (kv head
// h / (H / Hkv)):
//   out[b, h] = softmax_j(q[b, h] . k_j / sqrt(D)) v_j,  j < lengths[b],
// where token j of sequence b lives at slot j % PS of pool page
// page_table[b, j / PS] (src/repro/kernels/paged_attention/ref.py).
//
// Replaces the Pallas TPU kernel `paged_attention_fwd`
// (src/repro/kernels/paged_attention/paged_attention.py). That kernel walks a
// (B, Hkv, NP) grid in order, one page per step, with the page table in
// scalar-prefetch memory and the online-softmax state carried in VMEM scratch
// from one page to the next. On the card blocks run in parallel and carry
// nothing, so the page loop moves inside the block.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s fp32 without tensor cores):
// memory. Each live token's K and V rows of its kv head are read once
// (2 * D * 4 bytes in fp32) against 4 * D flops per query head reading them,
// so a group of 8 query heads does 4 flops per byte, far below the card's
// 20 flops per byte.
//
// Design, simple first: one block of 128 threads per (sequence, kv head)
// handles that kv head's `group` query heads. It loops over the live tokens
// only (j < min(length, NP * PS)) in tiles of 32, so it reads no page past the
// length, and never the null page 0 of an unallocated block. For each tile
// it stages the K and V rows in shared memory as fp32 (K rows padded by one
// float, so that the 32 lanes of a warp, one token each, hit distinct banks),
// computes the group x 32 scores with fp32 FMAs, one per thread, updates the
// running max m, sum l and accumulator (fp32, in shared memory) with one warp
// per query head, lane = token, and adds P V. Positions past the length score
// NEG_INF = -1e30 as in the Pallas kernel; l is clamped at 1e-30, so length 0
// gives zeros. Pool offsets are 64-bit. No tensor cores and no TF32.
//
// Known limit: B * Hkv blocks, 32 at yi-6b's 8 sequences x 4 kv heads, on 132
// SMs, and each block's tiles run one after another.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TOK = 32;  // tokens per tile: one per lane of a warp
constexpr float NEG_INF = -1e30f;
constexpr int MAX_SMEM = 232448;  // bytes a block can use on sm_90

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

int smem_bytes(int group, int D) {
  // q, acc: group x D; K tile: TOK x (D + 1); V tile: TOK x D;
  // P: group x TOK; m, l, alpha: group
  return 4 * (2 * group * D + TOK * (D + 1) + TOK * D + group * TOK + 3 * group);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int* __restrict__ page_table,
                       const int* __restrict__ lengths, T* __restrict__ out,
                       int H, int Hkv, int D, int PS, int NP, float scale) {
  const int b = blockIdx.x / Hkv;
  const int kvh = blockIdx.x - b * Hkv;
  const int group = H / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ float smem[];
  float* qs = smem;                 // group x D
  float* acc = qs + group * D;      // group x D
  float* ks = acc + group * D;      // TOK x (D + 1)
  float* vs = ks + TOK * (D + 1);   // TOK x D
  float* ps = vs + TOK * D;         // group x TOK
  float* m = ps + group * TOK;      // group
  float* l = m + group;             // group
  float* alpha = l + group;         // group

  // q[b, kvh * group + g, :] and out at the same place
  const int64_t qo = ((int64_t)b * H + (int64_t)kvh * group) * D;
  for (int i = tid; i < group * D; i += THREADS) {
    qs[i] = to_f32(q[qo + i]);
    acc[i] = 0.0f;
  }
  for (int g = tid; g < group; g += THREADS) {
    m[g] = NEG_INF;
    l[g] = 0.0f;
  }
  const int length = min(lengths[b], NP * PS);
  const int* row = page_table + (int64_t)b * NP;
  const int64_t slot_stride = (int64_t)Hkv * D;
  const int64_t head_off = (int64_t)kvh * D;
  __syncthreads();

  for (int t0 = 0; t0 < length; t0 += TOK) {
    const int ntok = min(TOK, length - t0);
    // stage this tile's K and V rows; rows past the length are zeros
    for (int i = tid; i < TOK * D; i += THREADS) {
      const int t = i / D, d = i - t * D;
      float kx = 0.0f, vx = 0.0f;
      if (t < ntok) {
        const int pos = t0 + t;
        const int64_t page = row[pos / PS];
        const int64_t off =
            (page * PS + pos % PS) * slot_stride + head_off + d;
        kx = to_f32(k_pool[off]);
        vx = to_f32(v_pool[off]);
      }
      ks[t * (D + 1) + d] = kx;
      vs[t * D + d] = vx;
    }
    __syncthreads();
    // scores, one (query head, token) pair per thread
    for (int i = tid; i < group * TOK; i += THREADS) {
      const int g = i / TOK, t = i - g * TOK;
      float s = NEG_INF;
      if (t < ntok) {
        const float* qr = qs + g * D;
        const float* kr = ks + t * (D + 1);
        float dot = 0.0f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * scale;
      }
      ps[i] = s;
    }
    __syncthreads();
    // online softmax, one warp per query head, lane = token
    for (int g = warp; g < group; g += WARPS) {
      const float s = ps[g * TOK + lane];
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m[g];
      const float m_new = fmaxf(m_prev, mx);
      const float p = expf(s - m_new);
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      ps[g * TOK + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        alpha[g] = a;
        l[g] = l[g] * a + sum;
        m[g] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * alpha + P V
    for (int i = tid; i < group * D; i += THREADS) {
      const int g = i / D, d = i - g * D;
      const float* pr = ps + g * TOK;
      float a = acc[i] * alpha[g];
      for (int t = 0; t < ntok; ++t) a = fmaf(pr[t], vs[t * D + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }
  for (int i = tid; i < group * D; i += THREADS)
    store(out + qo + i, acc[i] / fmaxf(l[i / D], 1e-30f));
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* page_table, const void* lengths, void* out, int B,
           int H, int Hkv, int D, int PS, int NP, void* stream) {
  if (B < 0 || H <= 0 || Hkv <= 0 || H % Hkv || D <= 0 || PS <= 0 || NP < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const int bytes = smem_bytes(H / Hkv, D);
  if (bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const float scale = 1.0f / sqrtf((float)D);
  paged_attention_kernel<T><<<(unsigned)B * Hkv, THREADS, bytes,
                              (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k_pool, (const T*)v_pool,
      (const int*)page_table, (const int*)lengths, (T*)out, H, Hkv, D, PS, NP,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: (B, H, D); k_pool, v_pool: (P, PS, Hkv, D), all contiguous on the
// caller's current device, in fp32 (f32) or bf16 (bf16); page_table: (B, NP)
// int32; lengths: (B,) int32. Launches on `stream` and returns
// cudaGetLastError() after the launch.
extern "C" int paged_attention_f32(const void* q, const void* k_pool,
                                   const void* v_pool, const void* page_table,
                                   const void* lengths, void* out, int B,
                                   int H, int Hkv, int D, int PS, int NP,
                                   void* stream) {
  return launch<float>(q, k_pool, v_pool, page_table, lengths, out, B, H, Hkv,
                       D, PS, NP, stream);
}

extern "C" int paged_attention_bf16(const void* q, const void* k_pool,
                                    const void* v_pool, const void* page_table,
                                    const void* lengths, void* out, int B,
                                    int H, int Hkv, int D, int PS, int NP,
                                    void* stream) {
  return launch<__nv_bfloat16>(q, k_pool, v_pool, page_table, lengths, out, B,
                               H, Hkv, D, PS, NP, stream);
}
