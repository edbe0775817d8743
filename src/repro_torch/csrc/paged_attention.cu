// Decode attention over a paged KV pool: one query token per sequence, with
// grouped-query heads. For sequence b and query head h (kv head
// h / (H / Hkv)):
//   out[b, h] = softmax_j(q[b, h] . k_j / sqrt(D)) v_j,  lo_b <= j < lengths[b],
// with lo_b = max(0, lengths[b] - window) for a sliding window of `window`
// keys and lo_b = 0 for window 0 (every key), where token j of sequence b
// lives at slot j % PS of pool page page_table[b, j / PS]
// (src/repro/kernels/paged_attention/ref.py).
//
// Replaces the Pallas TPU kernel `paged_attention_fwd`
// (src/repro/kernels/paged_attention/paged_attention.py). That kernel walks a
// (B, Hkv, NP) grid in order, one page per step, with the page table in
// scalar-prefetch memory and the online-softmax state carried in VMEM scratch
// from one page to the next. On the card blocks run in parallel and carry
// nothing, so the sequence is split over blocks and a second pass combines
// their partial softmax states.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s fp32 without tensor cores):
// memory. Each live token's K and V rows of its kv head are read once
// (2 * D * 4 bytes in fp32) against 4 * D flops per query head reading them,
// so a group of 8 query heads does 4 flops per byte, far below the card's
// 20 flops per byte. At yi-6b's decode shape (8 sequences of up to 2048
// tokens, 4 kv heads, D 128, fp32) that is about 10 us.
//
// Design, split-sequence decode in two passes:
// - Pass 1, grid (B * Hkv, S) with S = ceil(NP * PS / CHUNK), CHUNK = 64
//   tokens (four pages at the engine's PS = 16; any PS works). S is known on
//   the host, so the launch needs no device-to-host sync. A block whose chunk
//   starts at or past the length, or ends at or before lo_b, exits at once;
//   the first live chunk of a window skips its tokens before lo_b (no copy,
//   no score, no P V), so the pages that have left the window, which the
//   engine has returned to its pool, are never read. A live block serves the
//   kv head's `group` query heads over its chunk: it reads each page id once
//   into a table of token row offsets (no division in a loop), stages q in
//   fp32, and copies the chunk's K and V rows into shared memory with 16-byte
//   cp.async, all of a thread's copies in flight before the first wait (the
//   trip counts are compile-time constants) and V still landing while the
//   scores are taken. K rows are padded by 16 bytes, so the 16-byte reads of
//   8 lanes on 8 tokens fall on distinct banks. One warp per query head takes
//   its scores (two tokens per lane, fp32 FMAs in the order d = 0 .. D-1,
//   then * scale), the chunk's max m and sum l by shuffles; then the block
//   takes the unnormalised P V, VEC columns per thread, all in fp32. Three
//   __syncthreads per chunk: the offset table and q, K landed, V landed
//   with every P written. The partial (acc[D], m, l) of each
//   (sequence, query head, chunk) goes to fp32 scratch that the wrapper
//   allocates; the kernel allocates nothing.
// - Pass 2, grid (B * H): over the live chunks lo_b / CHUNK <= s <
//   ceil(length / CHUNK),
//   M = max m_s, L = sum l_s e^(m_s - M), out = sum acc_s e^(m_s - M) /
//   max(L, 1e-30) in q's dtype. Empty chunks are never read, so M is finite
//   wherever a chunk is live, and length 0 gives zeros, as in the Pallas
//   kernel. With one live chunk this is the one-pass result up to
//   summation order.
// It reads no page past the length or before lo_b, and never the null page 0
// of an unallocated block; at window 0 (lo_b = 0) every key is live, as
// before windows. Pool offsets are 64-bit. No tensor cores and no TF32.
//
// Known limits: D in {16, 32, 64, 128, 256}; the pools must start on a
// 16-byte boundary; q . k of a group's heads is scalar FMAs from shared
// memory, not tensor cores (4 flops per byte leaves the card memory-bound
// either way); a chunk of a short sequence still costs a block's fixed
// set-up.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 64;  // tokens per pass-1 block
constexpr int COMBINE_THREADS = 128;
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

// 16 bytes of T as fp32 values: 4 fp32 or 8 bf16 (the low half first)
__device__ __forceinline__ void unpack(uint4 x, float* f, float) {
  f[0] = __uint_as_float(x.x); f[1] = __uint_as_float(x.y);
  f[2] = __uint_as_float(x.z); f[3] = __uint_as_float(x.w);
}
__device__ __forceinline__ void unpack(uint4 x, float* f, __nv_bfloat16) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T, int D>
struct Cfg {
  static constexpr int VEC = 16 / (int)sizeof(T);   // values per 16 bytes
  static constexpr int VPR = D / VEC;               // vectors per row
  static constexpr int KP = D * (int)sizeof(T) + 16;  // K row pitch, bytes
  static constexpr int VP = D * (int)sizeof(T);       // V row pitch, bytes
  static constexpr int ITERS = CHUNK * VPR / THREADS; // copies per thread
  static_assert(CHUNK * VPR % THREADS == 0, "whole copies per thread");
  static_assert(VPR <= THREADS, "a row's vectors fit the block");
};

template <typename T, int D>
int smem_bytes(int group) {
  using G = Cfg<T, D>;
  return CHUNK * (G::KP + G::VP) + CHUNK * 8 + 4 * (group * D + group * CHUNK);
}

// Pass 1: the partial softmax state of one (sequence, kv head, chunk) for
// each of the kv head's query heads. part: acc (B*H, S, D), then (m, l)
// (B*H, S, 2).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
paged_partial_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                     const T* __restrict__ v_pool,
                     const int* __restrict__ page_table,
                     const int* __restrict__ lengths, float* __restrict__ part,
                     int B, int H, int Hkv, int PS, int NP, int S,
                     int window, float scale) {
  using G = Cfg<T, D>;
  constexpr int VEC = G::VEC, VPR = G::VPR;
  const int b = blockIdx.x / Hkv;
  const int kvh = blockIdx.x - b * Hkv;
  const int t0 = blockIdx.y * CHUNK;
  const int length = min(lengths[b], NP * PS);
  const int lo = window > 0 ? max(0, length - window) : 0;
  // pass 2 reads only the live chunks
  if (t0 >= length || t0 + CHUNK <= lo) return;
  const int ntok = min(CHUNK, length - t0);
  const int ts = max(0, lo - t0);  // the chunk's first key in the window
  const int group = H / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ks = smem;                         // CHUNK x KP bytes
  unsigned char* vs = ks + CHUNK * G::KP;           // CHUNK x VP bytes
  int64_t* tok = reinterpret_cast<int64_t*>(vs + CHUNK * G::VP);  // CHUNK
  float* qs = reinterpret_cast<float*>(tok + CHUNK);  // group x D
  float* ps = qs + group * D;                          // group x CHUNK

  // each chunk token's row offset in the pool, one page-table read per page
  const int64_t slot_stride = (int64_t)Hkv * D;
  const int* row = page_table + (int64_t)b * NP;
  const int p_first = (t0 + ts) / PS, p_last = (t0 + ntok - 1) / PS;
  for (int p = p_first + warp; p <= p_last; p += WARPS) {
    const int64_t page = row[p];
    const int base = p * PS - t0;  // chunk index of the page's slot 0
    for (int s = lane; s < PS; s += 32) {
      const int t = base + s;
      if (t >= ts && t < ntok)
        tok[t] = (page * PS + s) * slot_stride + (int64_t)kvh * D;
    }
  }
  const int64_t qo = ((int64_t)b * H + (int64_t)kvh * group) * D;
  for (int i = tid; i < group * D; i += THREADS) qs[i] = to_f32(q[qo + i]);
  __syncthreads();

  // K, then V: every copy of the chunk in flight before the first wait
#pragma unroll
  for (int it = 0; it < G::ITERS; ++it) {
    const int i = tid + it * THREADS;
    const int t = i / VPR, c = i % VPR;
    if (t >= ts && t < ntok)
      cp_async16(ks + t * G::KP + c * 16, k_pool + tok[t] + c * VEC);
  }
  cp_async_commit();
#pragma unroll
  for (int it = 0; it < G::ITERS; ++it) {
    const int i = tid + it * THREADS;
    const int t = i / VPR, c = i % VPR;
    if (t >= ts && t < ntok)
      cp_async16(vs + t * G::VP + c * 16, v_pool + tok[t] + c * VEC);
  }
  cp_async_commit();
  cp_async_wait<1>();  // K has landed; V may still be in flight
  __syncthreads();

  // scores, max and sum, one warp per query head, two tokens per lane
  const int64_t bh0 = (int64_t)b * H + (int64_t)kvh * group;
  float* part_ml = part + (int64_t)B * H * S * D;
  for (int g = warp; g < group; g += WARPS) {
    const float* qr = qs + g * D;
    float sv[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int t = lane + 32 * x;
      sv[x] = NEG_INF;
      if (t >= ts && t < ntok) {
        const unsigned char* kr = ks + t * G::KP;
        float dot = 0.0f;
#pragma unroll
        for (int c = 0; c < VPR; ++c) {
          float kv[VEC];
          unpack(*reinterpret_cast<const uint4*>(kr + c * 16), kv, T());
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            dot = fmaf(qr[c * VEC + e], kv[e], dot);
        }
        sv[x] = dot * scale;
      }
    }
    float mx = fmaxf(sv[0], sv[1]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    // mx is finite: the chunk holds at least one key in the window
    const float p0 = expf(sv[0] - mx), p1 = expf(sv[1] - mx);
    float sum = p0 + p1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    ps[g * CHUNK + lane] = p0;
    ps[g * CHUNK + lane + 32] = p1;
    if (lane == 0) {
      float* ml = part_ml + ((bh0 + g) * S + blockIdx.y) * 2;
      ml[0] = mx;
      ml[1] = sum;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // V has landed, and every P is written

  // acc = P V over the chunk's live tokens, VEC columns per thread
  constexpr int ROWS = THREADS / VPR;  // query heads at once
  const int cv = tid % VPR;
  for (int g = tid / VPR; g < group; g += ROWS) {
    const float* pr = ps + g * CHUNK;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
    for (int t = ts; t < ntok; ++t) {
      const float p = pr[t];
      float vv[VEC];
      unpack(*reinterpret_cast<const uint4*>(vs + t * G::VP + cv * 16), vv,
             T());
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = fmaf(p, vv[e], acc[e]);
    }
    float* dst = part + ((bh0 + g) * S + blockIdx.y) * D + cv * VEC;
#pragma unroll
    for (int e = 0; e < VEC; e += 4)
      *reinterpret_cast<float4*>(dst + e) =
          make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
  }
}

// Pass 2: combine the live chunks of one (sequence, query head).
template <typename T>
__global__ void __launch_bounds__(COMBINE_THREADS)
paged_combine_kernel(const float* __restrict__ part,
                     const int* __restrict__ lengths, T* __restrict__ out,
                     int B, int H, int D, int PS, int NP, int S,
                     int window) {
  const int64_t bh = blockIdx.x;
  const int b = blockIdx.x / H;
  const int length = min(lengths[b], NP * PS);
  const int n = (length + CHUNK - 1) / CHUNK;  // live chunks, <= S
  const int s0 = window > 0 ? max(0, length - window) / CHUNK : 0;
  const float* acc = part + bh * S * D;
  const float* ml = part + (int64_t)B * H * S * D + bh * S * 2;
  float M = NEG_INF;
  for (int s = s0; s < n; ++s) M = fmaxf(M, ml[2 * s]);
  float L = 0.0f;
  for (int s = s0; s < n; ++s) L += ml[2 * s + 1] * expf(ml[2 * s] - M);
  const float inv = 1.0f / fmaxf(L, 1e-30f);
  for (int d = threadIdx.x; d < D; d += COMBINE_THREADS) {
    float o = 0.0f;
    for (int s = s0; s < n; ++s)
      o = fmaf(acc[s * D + d], expf(ml[2 * s] - M), o);
    store(out + bh * D + d, o * inv);
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k_pool, const void* v_pool,
             const void* page_table, const void* lengths, void* out,
             void* part, int B, int H, int Hkv, int PS, int NP, int S,
             int window, cudaStream_t stream) {
  const int bytes = smem_bytes<T, D>(H / Hkv);
  if (bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  // the largest size set so far on each device: the attribute call costs
  // host time, and the engine launches this kernel 32 times a decode batch
  static int attribute_bytes[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (bytes > 48 * 1024 && (dev >= 64 || bytes > attribute_bytes[dev])) {
    e = cudaFuncSetAttribute(paged_partial_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) attribute_bytes[dev] = bytes;
  }
  const float scale = 1.0f / sqrtf((float)D);
  paged_partial_kernel<T, D><<<dim3((unsigned)(B * Hkv), (unsigned)S),
                               THREADS, bytes, stream>>>(
      (const T*)q, (const T*)k_pool, (const T*)v_pool, (const int*)page_table,
      (const int*)lengths, (float*)part, B, H, Hkv, PS, NP, S, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  paged_combine_kernel<T><<<(unsigned)(B * H), COMBINE_THREADS, 0, stream>>>(
      (const float*)part, (const int*)lengths, (T*)out, B, H, D, PS, NP, S,
      window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* page_table, const void* lengths, void* out, void* part,
           int B, int H, int Hkv, int D, int PS, int NP, int S, int window,
           void* stream) {
  if (B < 0 || window < 0 || H <= 0 || Hkv <= 0 || H % Hkv || PS <= 0 ||
      NP < 0 ||
      (long long)NP * PS > 0x7fffffff ||
      S != (int)(((long long)NP * PS + CHUNK - 1) / CHUNK) || S > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch_d<T, 16>(q, k_pool, v_pool, page_table, lengths, out, part, B, H, Hkv, PS, NP, S, window, s);
    case 32: return launch_d<T, 32>(q, k_pool, v_pool, page_table, lengths, out, part, B, H, Hkv, PS, NP, S, window, s);
    case 64: return launch_d<T, 64>(q, k_pool, v_pool, page_table, lengths, out, part, B, H, Hkv, PS, NP, S, window, s);
    case 128: return launch_d<T, 128>(q, k_pool, v_pool, page_table, lengths, out, part, B, H, Hkv, PS, NP, S, window, s);
    case 256: return launch_d<T, 256>(q, k_pool, v_pool, page_table, lengths, out, part, B, H, Hkv, PS, NP, S, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out: (B, H, D); k_pool, v_pool: (P, PS, Hkv, D), all contiguous on the
// caller's current device, in fp32 (f32) or bf16 (bf16), the pools 16-byte
// aligned; page_table: (B, NP) int32; lengths: (B,) int32; part: fp32
// scratch of B * H * S * (D + 2) values, S = ceil(NP * PS / 64); window:
// the keys a sliding-window layer attends, 0 for every key. Launches
// both passes on `stream` and returns the first non-zero cudaGetLastError().
extern "C" int paged_attention_f32(const void* q, const void* k_pool,
                                   const void* v_pool, const void* page_table,
                                   const void* lengths, void* out, void* part,
                                   int B, int H, int Hkv, int D, int PS,
                                   int NP, int S, int window, void* stream) {
  return launch<float>(q, k_pool, v_pool, page_table, lengths, out, part, B,
                       H, Hkv, D, PS, NP, S, window, stream);
}

extern "C" int paged_attention_bf16(const void* q, const void* k_pool,
                                    const void* v_pool, const void* page_table,
                                    const void* lengths, void* out, void* part,
                                    int B, int H, int Hkv, int D, int PS,
                                    int NP, int S, int window,
                                    void* stream) {
  return launch<__nv_bfloat16>(q, k_pool, v_pool, page_table, lengths, out,
                               part, B, H, Hkv, D, PS, NP, S, window, stream);
}
