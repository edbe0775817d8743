// Prefill attention forward over grouped-query heads, causal and/or
// sliding-window, on Hopper's tensor cores at fp32 accuracy. For batch b,
// query row i and query head h (kv head h / (H / Hkv)):
//   out[b, i, h] = sum_j softmax_j(s_ij) v[b, j, h / (H / Hkv)],
//   s_ij = (q[b, i, h] . k[b, j, h / (H / Hkv)]) * (1 / sqrt(D)),
// over the visible keys j: j <= i when causal (top-left aligned, also when
// Sq != Sk), j > i - window when window > 0
// (src/repro/kernels/flash_attention/ref.py).
//
// Replaces the Pallas TPU kernel `flash_attention_fwd`
// (src/repro/kernels/flash_attention/flash_attention.py:86, its pallas_call
// at :106) for fp32 inputs at D in {32, 64, 128, 256} and bf16 at D = 32;
// bf16 at D in {64, 128, 256} runs csrc/flash_attention_sm90.cu. That kernel
// walks a (B, H, nQ, nK) grid with the KV blocks innermost, in order,
// carrying the online-softmax state (m, l, acc) across grid steps in VMEM
// scratch and skipping KV blocks outside the causal/window band. On the card
// blocks run in parallel and carry nothing, so the KV loop moves inside the
// block, and the band is computed up front: the loop runs over the keys that
// some row of the block can see, and nothing else is read.
//
// Bound on an H100 SXM: operations. The visible (row, key) pairs cost
// W = 4 * D flops per query head against about 2 * D * 4 bytes of K and V
// per key shared by a group of heads. At yi-6b's prefill (1, 4096, 4096, 32
// heads over 4, D 128, causal) W = 1.375e11: 2.052 ms at the 67 TFLOP/s fp32
// FMA rate, 0.833 ms as three TF32 products at the 495 TFLOP/s dense TF32
// rate (below), 0.045 ms of bytes. At recurrentgemma-2b's local prefill (1,
// 8192, 8192, 10 heads over 1, D 256, window 2048) W = 1.503e11: 2.244 and
// 0.911 ms. The TF32 figure is the least time the card can take for this
// work at fp32 accuracy.
//
// fp32 accuracy from TF32 products (3xTF32). Each fp32 operand x splits into
//   hi = rna(x),  lo = rna(x - hi),
// rna being cvt.rna.tf32.f32's rounding (to_tf32), so |x - hi - lo| <=
// 2^-22 |x|, and x y = hi_x hi_y + hi_x lo_y + lo_x hi_y with lo_x lo_y
// (<= 2^-22 |x y|) dropped: three mma.sync.m16n8k8 TF32 products
// accumulated in fp32. A TF32 product alone is off by up to about 2^-11 of
// each operand, some 5e-4 relative, which misses the 2e-5 fp32 tolerance;
// the three products stay within a few 1e-6 of the fp32 result at the
// shapes chip_smoke.py checks. Both products are split so: S = Q K^T, its
// two small products summed in accumulators of their own and added to
// hi x hi once a tile, and O += P V, the small products first, with P split
// in registers after the softmax. A bf16 value is exact in TF32 (its lo is
// 0), so the products a bf16 instance takes are counted at compile time
// (split<LO>, mma3<A_LO, B_LO>): S = Q K^T one, P V two (P_hi V + P_lo V; P
// stays fp32 in value, as the Pallas kernel keeps it, flash_attention.py:50,
// :70).
//
// Design: one block of four warps per (64 query rows, query head, batch),
// 16 rows a warp, blocks in reverse order of query position so the longest
// causal rows start first.
// - Q (64 rows) and the band's K and V tiles of BK keys (64 at D <= 64, 32
//   at D >= 128, where the O accumulator holds D / 2 fp32 a thread) go to
//   shared memory with 16-byte cp.async, in q's dtype, rows padded by 16
//   bytes. K and V fill a ring of two stages: tile j + 1 is in flight while
//   tile j is computed, and one __syncthreads a tile both publishes tile j
//   and frees the stage tile j + 1 goes to. Rows past the band's end (and Q
//   rows past Sq) are zero-filled by the copy and read from nowhere.
// - The fragments are read element by element from shared memory and split
//   in registers: Q as the A operand ([row g][d t], [g + 8][t], [g][t + 4],
//   [g + 8][t + 4] for lane 4 g + t), K as B ([key g][d t], [g][t + 4]), V as
//   B ([key 2 t][d g], [2 t + 1][g]). The S accumulator gives a lane keys
//   2 t and 2 t + 1 of each 8-key tile, where the A operand of P V wants k
//   slots t and t + 4; the sum over keys does not depend on their order, so
//   P V takes slot t as key 2 t and slot t + 4 as key 2 t + 1, reads V's
//   rows in that order, and P needs no shuffle. With a row pitch of D + 4
//   words (D / 2 + 4 in bf16) each of those reads falls on 32 distinct
//   banks.
// - The scores are scaled after the product (the Pallas kernel's order),
//   masked by their (row, key) positions with NEG_INF = -1e30 (keys past the
//   band's end too), and the online softmax takes each row's max over the 4
//   lanes that hold it; each lane keeps its part of l, summed over the 4
//   lanes at the end. A warp skips a tile none of its rows sees a key of.
// - The output is O / max(l, 1e-30) in q's dtype, stored from registers as
//   pairs, masked to rows below Sq. Offsets are 64-bit.
//
// A row with no visible key (window > 0 and row > Sk + window - 2) gets
// zeros: until a row sees a key its scores are taken against 0, not against
// their max NEG_INF, so its probabilities are all 0, its sum l stays 0 and
// the output is 0 / 1e-30 = 0. The plain version gives the mean of v there.
//
// Known limits (scripts/flash_tf32_probe.py measures them): mma.sync, not
// wgmma. On an H100 mma.sync TF32 reaches about 60 % of the dense TF32 rate
// even with nothing else to do, and each one reads its operands from the
// register file; wgmma takes TF32 operands K-major only, so P V through it
// would need V transposed and hi/lo planes written to shared memory by the
// threads. The splits cost about a quarter of the time and do not overlap
// the products: each warp splits every K and V value it reads (four
// instructions a value, the rounding on the bit pattern) and re-splits its
// Q fragment each tile. At D = 256 one block fits on an SM (Q and the ring
// take 195 KiB), four warps.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;

// Tiles of one (input type, head dim) instance.
template <typename T, int D>
struct Cfg {
  static constexpr bool EXACT = sizeof(T) == 2;  // bf16 is exact in TF32
  static constexpr int WARPS = 4;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BQ = 16 * WARPS;      // query rows per block
  static constexpr int BK = D >= 128 ? 32 : 64;  // keys per K/V tile
  static constexpr int STAGES = 2;           // K/V tiles in the ring
  static constexpr int S_UNROLL = D >= 128 ? 4 : D / 8;  // k-steps of Q K^T
  static constexpr int LD = D + 16 / (int)sizeof(T);  // row pitch, elements
  static constexpr int SMEM = (int)sizeof(T) * LD * (BQ + 2 * STAGES * BK);
  static constexpr int MIN_BLOCKS = SMEM <= 113 * 1024 ? 2 : 1;
};

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero), on the bit pattern: the same result for finite x in two
// integer instructions, where cvt.rna takes a compare-and-select sequence
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x as TF32 pieces: hi, and lo = x - hi rounded again when LO; a value
// TF32 holds exactly (bf16) is its own hi
template <bool LO>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (LO) {
    hi = to_tf32(x);
    lo = to_tf32(x - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(x);
    lo = 0u;
  }
}

// c += a b on the tensor cores, a 16 x 8 (row-major fragment), b 8 x 8
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// a b to fp32 accuracy in 1 + A_LO + B_LO TF32 products: lo_a hi_b when a
// has a lo part and hi_a lo_b when b has one go to small, then hi_a hi_b to
// big (small and big may be one accumulator)
template <bool A_LO, bool B_LO>
__device__ __forceinline__ void mma3(float (&small)[4], float (&big)[4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  if constexpr (A_LO) mma(small, al, bh);
  if constexpr (B_LO) mma(small, ah, bl);
  mma(big, ah, bh);
}

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  // bf16 is the top half of an fp32
  return __uint_as_float(
      (uint32_t)*reinterpret_cast<const unsigned short*>(p) << 16);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// 16 bytes from global to shared memory, in flight until cp_async_wait;
// zeros, and nothing read, when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying ROWS rows of D values (row r at src + r * stride) to
// shared memory with pitch LD; rows >= nrows become zeros.
template <typename T, int D, int LD, int ROWS, int THREADS>
__device__ __forceinline__ void load_async(T* dst, const T* src,
                                           int64_t stride, int nrows) {
  constexpr int PER = 16 / sizeof(T);  // values per 16-byte copy
  constexpr int VPR = D / PER;         // copies per row
  constexpr int STEP = THREADS / VPR;  // rows per pass of the block
  static_assert(THREADS % VPR == 0 && ROWS % STEP == 0, "whole passes");
  const int r = threadIdx.x / VPR, c = (threadIdx.x % VPR) * PER;
  dst += r * LD + c;
  const T* row = src + r * stride + c;
#pragma unroll
  for (int it = 0; it < ROWS / STEP; ++it) {
    const bool ok = r + it * STEP < nrows;
    cp_async16(dst + it * STEP * LD, ok ? row : src, ok);
    row += STEP * stride;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Cfg<T, D>::THREADS, Cfg<T, D>::MIN_BLOCKS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq,
                       int Sk, int H, int Hkv, int causal, int window,
                       float scale) {
  using C = Cfg<T, D>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, STAGES = C::STAGES;
  constexpr int THREADS = C::THREADS, S_UNROLL = C::S_UNROLL;
  constexpr int NT = BK / 8;  // 8-key tiles of S; k-steps of P V
  constexpr int KD = D / 8;   // k-steps of Q K^T; 8-column tiles of O
  constexpr bool LO = !C::EXACT;

  const int q_lo = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row and column index

  extern __shared__ float4 smem4[];
  T* Qs = reinterpret_cast<T*>(smem4);  // BQ x LD
  T* ring = Qs + BQ * LD;               // STAGES x (K, V), BK x LD each

  const int64_t q_stride = (int64_t)H * D, kv_stride = (int64_t)Hkv * D;
  const T* k_base = k + (int64_t)b * Sk * kv_stride + (int64_t)kvh * D;
  const T* v_base = v + (int64_t)b * Sk * kv_stride + (int64_t)kvh * D;

  // the band of keys some row of this tile can see
  const int q_hi = min(q_lo + BQ, Sq) - 1;
  const int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int k_end = causal ? min(Sk, q_hi + 1) : Sk;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  auto load_kv = [&](int j) {
    T* Ks = ring + (j % STAGES) * 2 * BK * LD;
    const int k0 = k_begin + j * BK;
    load_async<T, D, LD, BK, THREADS>(Ks, k_base + k0 * kv_stride, kv_stride,
                                      k_end - k0);
    load_async<T, D, LD, BK, THREADS>(Ks + BK * LD, v_base + k0 * kv_stride,
                                      kv_stride, k_end - k0);
  };
  // Q travels in the first tile's group
  load_async<T, D, LD, BQ, THREADS>(
      Qs, q + ((int64_t)b * Sq + q_lo) * q_stride + (int64_t)h * D, q_stride,
      Sq - q_lo);
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < n_tiles) load_kv(j);
    cp_async_commit();
  }

  const int w_lo = q_lo + 16 * warp;        // this warp's first row
  const int qp0 = w_lo + g, qp1 = qp0 + 8;  // the lane's two rows
  float o[KD][4] = {}, m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile j has landed; every warp is done with j - 1
    if (j + STAGES - 1 < n_tiles) load_kv(j + STAGES - 1);
    cp_async_commit();

    const int k0 = k_begin + j * BK;
    if (w_lo >= Sq || (causal && k0 > w_lo + 15) ||
        (window > 0 && k0 + BK - 1 <= w_lo - window))
      continue;  // no row of this warp sees a key of the tile
    const T* Ks = ring + (j % STAGES) * 2 * BK * LD;
    const T* Vs = Ks + BK * LD;

    // S = Q K^T, its small products summed apart and added once
    float s[NT][4] = {}, s_lo[NT][4] = {};
#pragma unroll S_UNROLL
    for (int ks = 0; ks < KD; ++ks) {
      const T* qr = Qs + (16 * warp + g) * LD + 8 * ks + t;
      uint32_t ah[4], al[4];
      split<LO>(ld(qr), ah[0], al[0]);
      split<LO>(ld(qr + 8 * LD), ah[1], al[1]);
      split<LO>(ld(qr + 4), ah[2], al[2]);
      split<LO>(ld(qr + 8 * LD + 4), ah[3], al[3]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const T* kr = Ks + (8 * nt + g) * LD + 8 * ks + t;
        uint32_t bh[2], bl[2];
        split<LO>(ld(kr), bh[0], bl[0]);
        split<LO>(ld(kr + 4), bh[1], bl[1]);
        mma3<LO, LO>(s_lo[nt], s[nt], ah, al, bh, bl);
      }
    }

    // scale, mask, online softmax; s[nt][e] is row e < 2 ? qp0 : qp1, key
    // k0 + 8 nt + 2 t + (e & 1)
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] += s_lo[nt][e];
        const int kp = k0 + 8 * nt + 2 * t + (e & 1);
        const int qp = e < 2 ? qp0 : qp1;
        bool ok = kp < k_end;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        s[nt][e] = ok ? s[nt][e] * scale : NEG_INF;
        mx[e / 2] = fmaxf(mx[e / 2], s[nt][e]);
      }
    float ref[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      // no visible key yet: every score is NEG_INF, and exp(s - m_new)
      // would be 1 on each; against 0 it is 0, so such a row keeps l = 0
      ref[r] = m_new > NEG_INF ? m_new : 0.0f;
      alpha[r] = expf(m[r] - ref[r]);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - ref[e / 2]);
        l[e / 2] += s[nt][e];
      }
#pragma unroll
    for (int dt = 0; dt < KD; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }

    // O += P V; k slot t is key 2 t, slot t + 4 key 2 t + 1 of the 8-key tile
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      uint32_t ph[4], pl[4];
      split<true>(s[kk][0], ph[0], pl[0]);  // row g, key 2 t
      split<true>(s[kk][2], ph[1], pl[1]);  // row g + 8, key 2 t
      split<true>(s[kk][1], ph[2], pl[2]);  // row g, key 2 t + 1
      split<true>(s[kk][3], ph[3], pl[3]);  // row g + 8, key 2 t + 1
      const T* vr = Vs + (8 * kk + 2 * t) * LD + g;
#pragma unroll
      for (int dt = 0; dt < KD; ++dt) {
        uint32_t bh[2], bl[2];
        split<LO>(ld(vr + 8 * dt), bh[0], bl[0]);
        split<LO>(ld(vr + LD + 8 * dt), bh[1], bl[1]);
        mma3<true, LO>(o[dt], o[dt], ph, pl, bh, bl);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float denom = fmaxf(sum, 1e-30f);
    const int qp = r ? qp1 : qp0;
    if (qp >= Sq) continue;
    T* orow = out + (((int64_t)b * Sq + qp) * H + h) * D + 2 * t;
#pragma unroll
    for (int dt = 0; dt < KD; ++dt)
      store2(orow + 8 * dt, o[dt][2 * r] / denom, o[dt][2 * r + 1] / denom);
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* out, int B,
             int Sq, int Sk, int H, int Hkv, int causal, int window,
             cudaStream_t stream) {
  using C = Cfg<T, D>;
  if (C::SMEM > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return (int)e;
  }
  const float scale = (float)(1.0 / sqrt((double)D));
  const dim3 grid((unsigned)((Sq + C::BQ - 1) / C::BQ), (unsigned)H,
                  (unsigned)B);
  flash_attention_kernel<T, D><<<grid, C::THREADS, C::SMEM, stream>>>(
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
