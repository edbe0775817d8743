// Prefill attention forward over grouped-query heads, causal and/or
// sliding-window. For batch b, query row i and query head h (kv head
// h / (H / Hkv)):
//   out[b, i, h] = sum_j softmax_j(s_ij) v[b, j, h / (H / Hkv)],
//   s_ij = (q[b, i, h] . k[b, j, h / (H / Hkv)]) * (1 / sqrt(D)),
// over the visible keys j: j <= i when causal (top-left aligned, also when
// Sq != Sk), j > i - window when window > 0
// (src/repro/kernels/flash_attention/ref.py).
//
// Replaces the Pallas TPU kernel `flash_attention_fwd`
// (src/repro/kernels/flash_attention/flash_attention.py). That kernel walks a
// (B, H, nQ, nK) grid with the KV blocks innermost, in order, carrying the
// online-softmax state (m, l, acc) across grid steps in VMEM scratch and
// skipping KV blocks outside the causal/window band. On the card blocks run
// in parallel and carry nothing, so the KV loop moves inside the block, and
// the band is computed up front: the loop runs over the keys that some row
// of the block can see, and nothing else is read.
//
// Bound on an H100 SXM: operations. The visible (row, key) pairs cost
// 4 * D flops per query head against about 2 * D * bytes-per-value of K
// and V per key shared by a group of heads, so at yi-6b's prefill shape the
// work is ~1.4e11 flops over ~0.15 GB: 2.05 ms at the 67 TFLOP/s fp32 rate,
// 0.045 ms of bytes. For bf16 the least time is the tensor-core rate's.
//
// This file is the fp32 path, and bf16 at D = 32; bf16 at D in {64, 128,
// 256} runs on the tensor cores in csrc/flash_attention_sm90.cu.
//
// Design, simple first (no tensor cores, no TMA, no wgmma): one block of 256
// threads per (query tile of 64 rows, query head, batch). The block stages
// its Q tile once, then walks the band in K/V tiles of BK keys (64, or 32 at
// D = 256). Every tile is loaded with 16-byte vector loads, all of a
// thread's loads issued before any store to shared memory (the trip counts
// are compile-time constants, so the loops unroll), and converted to fp32 in
// shared memory with rows padded by 4 floats, so that the float4 reads of 8
// lanes fall on distinct banks. Thread (rg, cg) = (tid / 16, tid % 16) owns
// query rows 4 rg .. 4 rg + 3: it computes their scores against keys
// cg + 16 j with fp32 FMAs in the order d = 0 .. D-1, then multiplies by the
// scale (the Pallas kernel's order), masks with NEG_INF = -1e30, and keeps
// the rows' running max m and sum l in registers, reduced over the 16 lanes
// of the row group with shuffles. P goes to shared memory (over the K tile,
// which is no longer read) in fp32 also for bf16 inputs (as the Pallas
// kernel, which casts v to fp32 before P V), and the
// thread accumulates P V for its 4 rows x D / 16 columns in registers. The
// output is acc / max(l, 1e-30) in q's dtype. Tiles are taken in reverse
// order of query position, so the longest causal rows start first. Offsets
// are 64-bit.
//
// A row with no visible key (window > 0 and row > Sk + window - 2) gets
// zeros: until a row sees a key its scores are taken against 0, not
// against their max NEG_INF, so its probabilities are all 0, its sum l stays
// 0 and the output is acc / 1e-30 = 0. The plain version gives the mean of v there.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BQ = 64;    // query rows per block
constexpr int TM = 4;     // query rows per thread
constexpr int GROUP = 16; // threads sharing a row group (lanes of a half warp)
constexpr int PAD = 4;    // floats of padding per shared-memory row
constexpr float NEG_INF = -1e30f;

template <int D>
struct Tile {
  static constexpr int BK = D >= 256 ? 32 : 64;  // keys per K/V tile
  static constexpr int TN = BK / GROUP;          // score columns per thread
  static constexpr int LD = D + PAD;             // pitch of Q, K, V rows
  static constexpr int LDP = BK + PAD;           // pitch of P rows
  static constexpr int VEC = D >= 64 ? 4 : 2;    // output columns per read
  static constexpr int CPT = D / GROUP;          // output columns per thread
  static constexpr int NV = CPT / VEC;
  static constexpr int KP = BK * LD > BQ * LDP ? BK * LD : BQ * LDP;
  static constexpr int SMEM = 4 * (BQ * LD + KP + BK * LD);  // bytes
};

// 16 bytes of T (4 fp32 or 8 bf16 values) to fp32 in shared memory
__device__ __forceinline__ void store_f32(float* dst, uint4 x, float) {
  *reinterpret_cast<float4*>(dst) = make_float4(
      __uint_as_float(x.x), __uint_as_float(x.y), __uint_as_float(x.z),
      __uint_as_float(x.w));
}
__device__ __forceinline__ void store_f32(float* dst, uint4 x,
                                          __nv_bfloat16) {
  // bf16 is the top half of an fp32: the low element of each word first
  *reinterpret_cast<float4*>(dst) = make_float4(
      __uint_as_float(x.x << 16), __uint_as_float(x.x & 0xffff0000u),
      __uint_as_float(x.y << 16), __uint_as_float(x.y & 0xffff0000u));
  *reinterpret_cast<float4*>(dst + 4) = make_float4(
      __uint_as_float(x.z << 16), __uint_as_float(x.z & 0xffff0000u),
      __uint_as_float(x.w << 16), __uint_as_float(x.w & 0xffff0000u));
}

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Copy ROWS rows of D values (row r at src + r * stride) into shared memory
// as fp32 with pitch D + PAD; rows >= nrows are zeros. All loads of a thread
// are issued before its first store.
template <typename T, int ROWS, int D>
__device__ __forceinline__ void load_tile(float* dst,
                                          const T* __restrict__ src,
                                          int64_t stride, int nrows) {
  constexpr int PER = 16 / sizeof(T);  // values per 16-byte vector
  constexpr int VPR = D / PER;         // vectors per row
  constexpr int TOTAL = ROWS * VPR;
  constexpr int ITERS = (TOTAL + THREADS - 1) / THREADS;
  uint4 buf[ITERS];
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / VPR, c = (i % VPR) * PER;
    buf[it] = make_uint4(0u, 0u, 0u, 0u);
    if (i < TOTAL && r < nrows)
      buf[it] = *reinterpret_cast<const uint4*>(src + r * stride + c);
  }
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / VPR, c = (i % VPR) * PER;
    if (i < TOTAL) store_f32(dst + r * (D + PAD) + c, buf[it], T());
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq,
                       int Sk, int H, int Hkv, int causal, int window,
                       float scale) {
  using G = Tile<D>;
  constexpr int BK = G::BK, TN = G::TN, LD = G::LD, LDP = G::LDP;
  constexpr int VEC = G::VEC, NV = G::NV;

  const int q_lo = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int tid = threadIdx.x, rg = tid / GROUP, cg = tid % GROUP;

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // BQ x LD
  float* Ks = Qs + BQ * LD;                     // BK x LD, then P: BQ x LDP
  float* Ps = Ks;
  float* Vs = Ks + G::KP;                       // BK x LD

  const int64_t q_stride = (int64_t)H * D, kv_stride = (int64_t)Hkv * D;
  const T* q_base = q + ((int64_t)b * Sq + q_lo) * q_stride + (int64_t)h * D;
  const T* k_base = k + (int64_t)b * Sk * kv_stride + (int64_t)kvh * D;
  const T* v_base = v + (int64_t)b * Sk * kv_stride + (int64_t)kvh * D;
  load_tile<T, BQ, D>(Qs, q_base, q_stride, Sq - q_lo);

  // the band of keys some row of this tile can see
  const int q_hi = min(q_lo + BQ, Sq) - 1;
  const int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int k_end = causal ? min(Sk, q_hi + 1) : Sk;

  float m[TM], l[TM], acc[TM][G::CPT];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < G::CPT; ++c) acc[i][c] = 0.0f;
  }
  const int row0 = rg * TM;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the last tile's P and V reads are done
    load_tile<T, BK, D>(Ks, k_base + (int64_t)k0 * kv_stride, kv_stride,
                        k_end - k0);
    load_tile<T, BK, D>(Vs, v_base + (int64_t)k0 * kv_stride, kv_stride,
                        k_end - k0);
    __syncthreads();

    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[TM], kb[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        qa[i] = *reinterpret_cast<const float4*>(Qs + (row0 + i) * LD + d);
#pragma unroll
      for (int j = 0; j < TN; ++j)
        kb[j] = *reinterpret_cast<const float4*>(Ks + (cg + GROUP * j) * LD + d);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          float a = s[i][j];
          a = fmaf(qa[i].x, kb[j].x, a);
          a = fmaf(qa[i].y, kb[j].y, a);
          a = fmaf(qa[i].z, kb[j].z, a);
          a = fmaf(qa[i].w, kb[j].w, a);
          s[i][j] = a;
        }
    }

    // scale, mask, online softmax over the row group's 16 lanes
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qp = q_lo + row0 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int kp = k0 + cg + GROUP * j;
        bool ok = kp < k_end;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = GROUP / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      // no visible key yet: every score is NEG_INF, and exp(s - m_new)
      // would be 1 on each; against 0 it is 0, so such a row keeps l = 0
      const float ref = m_new > NEG_INF ? m_new : 0.0f;
      const float alpha = expf(m[i] - ref);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        s[i][j] = expf(s[i][j] - ref);
        sum += s[i][j];
      }
#pragma unroll
      for (int o = GROUP / 2; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < G::CPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // every score is read out of the K tile
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        Ps[(row0 + i) * LDP + cg + GROUP * j] = s[i][j];
    __syncthreads();

    // acc += P V over the tile's keys, in key order
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pa[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        pa[i] = *reinterpret_cast<const float4*>(Ps + (row0 + i) * LDP + kk);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float* vr = Vs + (kk + t) * LD + cg * VEC;
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          float vv[VEC];
          if constexpr (VEC == 4) {
            const float4 x =
                *reinterpret_cast<const float4*>(vr + n * GROUP * VEC);
            vv[0] = x.x; vv[1] = x.y; vv[2] = x.z; vv[3] = x.w;
          } else {
            const float2 x =
                *reinterpret_cast<const float2*>(vr + n * GROUP * VEC);
            vv[0] = x.x; vv[1] = x.y;
          }
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float p = t == 0 ? pa[i].x : t == 1 ? pa[i].y
                          : t == 2 ? pa[i].z : pa[i].w;
#pragma unroll
            for (int c = 0; c < VEC; ++c)
              acc[i][n * VEC + c] = fmaf(p, vv[c], acc[i][n * VEC + c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int qp = q_lo + row0 + i;
    if (qp >= Sq) continue;
    T* o = out + (((int64_t)b * Sq + qp) * H + h) * D + cg * VEC;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int c = 0; c < VEC; ++c)
        store_out(o + n * GROUP * VEC + c, acc[i][n * VEC + c] / denom);
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* out, int B,
             int Sq, int Sk, int H, int Hkv, int causal, int window,
             cudaStream_t stream) {
  constexpr int bytes = Tile<D>::SMEM;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const float scale = (float)(1.0 / sqrt((double)D));
  const dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)H, (unsigned)B);
  flash_attention_kernel<T, D><<<grid, THREADS, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Sq, Sk, H, Hkv, causal,
      window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int Hkv, int D, int causal, int window,
           void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || Hkv <= 0 || H % Hkv ||
      window < 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (D == 32)
    return launch_d<T, 32>(q, k, v, out, B, Sq, Sk, H, Hkv, causal, window, s);
  if constexpr (sizeof(T) == 2) {  // bf16 at larger D: flash_attention_sm90.cu
    return (int)cudaErrorInvalidValue;
  } else {
    switch (D) {
      case 64: return launch_d<T, 64>(q, k, v, out, B, Sq, Sk, H, Hkv, causal, window, s);
      case 128: return launch_d<T, 128>(q, k, v, out, B, Sq, Sk, H, Hkv, causal, window, s);
      case 256: return launch_d<T, 256>(q, k, v, out, B, Sq, Sk, H, Hkv, causal, window, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
}

}  // namespace

// q, out: (B, Sq, H, D); k, v: (B, Sk, Hkv, D); all contiguous and 16-byte
// aligned on the caller's current device, in fp32 (f32) or bf16 (bf16);
// D in {32, 64, 128, 256} for f32, D = 32 for bf16. Launches on `stream`
// and returns cudaGetLastError() after the launch.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out, int B, int Sq,
                                   int Sk, int H, int Hkv, int D, int causal,
                                   int window, void* stream) {
  return launch<float>(q, k, v, out, B, Sq, Sk, H, Hkv, D, causal, window,
                       stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int B, int Sq,
                                    int Sk, int H, int Hkv, int D, int causal,
                                    int window, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, Hkv, D, causal,
                               window, stream);
}
