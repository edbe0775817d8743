// Prefill attention forward in bf16 on Hopper's tensor cores, over
// grouped-query heads, causal and/or sliding-window. For batch b, query row i
// and query head h (kv head h / (H / Hkv)):
//   out[b, i, h] = sum_j softmax_j(s_ij) v[b, j, h / (H / Hkv)],
//   s_ij = (q[b, i, h] . k[b, j, h / (H / Hkv)]) * (1 / sqrt(D)),
// over the visible keys j: j <= i when causal (top-left aligned, also when
// Sq != Sk), j > i - window when window > 0
// (src/repro/kernels/flash_attention/ref.py).
//
// Replaces the Pallas TPU kernel `flash_attention_fwd`
// (src/repro/kernels/flash_attention/flash_attention.py) for bf16 inputs at
// D in {64, 128, 256}; fp32, and bf16 at D = 32, run the 3xTF32 kernel of
// csrc/flash_attention.cu. The Pallas kernel walks a (B, H, nQ, nK) grid with
// the KV blocks innermost, carrying (m, l, acc) in VMEM scratch across grid
// steps and skipping blocks outside the causal/window band. Here the KV loop
// is inside the block and walks only the band.
//
// Bound on an H100 SXM: operations. The visible (row, key) pairs cost 4 * D
// flops per query head on the tensor cores (989 TFLOP/s dense bf16) against
// about 4 * D bytes of K and V per key shared by a group of heads: at yi-6b's
// prefill (S 4096, 32 heads over 4, D 128, causal) 0.139 ms of operations
// and 0.045 ms of bytes.
//
// Design: one block of three warpgroups per (128 query rows, query head,
// batch), in reverse order of query position so the longest causal rows
// start first.
// - Warpgroup 2 is the producer; one thread of it issues every copy, and the
//   warpgroup gives up registers (setmaxnreg 24). It loads the Q tile once
//   by TMA, then the band's K and V tiles of BK keys (128 at D <= 128, 64 at
//   D = 256) into two rings of three stages (two at D = 256), each stage
//   with a full and an empty mbarrier, K and V apart, so a K stage is free
//   again as soon as its scores are taken. The tensor maps describe the 4-D
//   (B, S, heads, D) arrays with 128-byte swizzle, so a row of D values
//   lands as D / 64 panels of 128-byte rows; TMA clips at Sq, Sk and the
//   batch edge and fills zeros there.
// - Warpgroups 0 and 1 are consumers of 64 query rows each (setmaxnreg 240).
//   S = Q K^T is wgmma m64nBKk16 with both operands K-major from shared
//   memory, D / 16 steps, fp32 accumulators; bf16 x bf16 products are exact
//   in fp32, so S differs from the fp32 reference only in summation order.
//   The scores are scaled after the product, as Pallas does (by
//   log2(e) / sqrt(D), for exp2 on the SFU), masked in the accumulator
//   registers by their (row, column) positions with selects (keys at or
//   past Sk too: a zero-filled key would score 0), and the online softmax
//   takes each row's max and sum over the 4 lanes that hold it. A row that
//   has seen no key takes its scores against 0, not NEG_INF, so its
//   probabilities are 0 and it ends as zeros. P is rounded to bf16 in
//   registers, where the fp32 accumulator layout of two adjacent 8-column
//   chunks is the A-operand layout, and O += P V is wgmma m64nDk16 with A
//   from registers and V from shared memory as an MN-major B operand (the
//   descriptor's transpose bit), so V is never transposed by hand. l sums
//   the fp32 P.
// - Overlap: a consumer issues S(j + 1) and P(j) V(j) together, takes the
//   softmax of S(j + 1) while P(j) V(j) runs, then rescales O. The two
//   consumers take turns to issue their products (named barriers 1 and 2),
//   so one's products run while the other computes its softmax. Tiles wholly
//   outside a warpgroup's rows' band are skipped, and tiles wholly inside
//   it are not masked.
// - The output is O / max(l, 1e-30), stored from registers as bf16 pairs,
//   masked to rows below Sq.
//
// Deliberate difference: P is rounded to bf16 before P V (the Pallas kernel
// casts v to fp32 and keeps P in fp32, flash_attention.py:50, :70; so does
// the 3xTF32 kernel). It stays within the bf16 tolerance of 2e-2.
//
// Known limits: one block per SM (384 threads at 168 registers at launch),
// so each block's start (Q load, first tile without overlap) and its
// epilogue are not hidden behind another tile, where a persistent kernel
// would hide them; the output is written from registers with 4-byte
// stores, not through shared memory and a TMA store; the tensor maps are
// encoded on the host for each call; D = 32 stays on the 3xTF32 kernel (its
// 64-byte rows need a 64-byte swizzle, a second layout).
#include <climits>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 128;      // query rows per block: two consumer warpgroups
constexpr int THREADS = 384; // consumers 0..255, producer 256..383
constexpr int PANEL = 64;    // bf16 values per 128-byte swizzled row
constexpr float NEG_INF = -1e30f;

template <int D>
struct Cfg {
  static constexpr int BK = D <= 128 ? 128 : 64;   // keys per K/V tile
  static constexpr int STAGES = D <= 128 ? 3 : 2;  // K and V ring depth
  static constexpr int NS = BK / 2;                // score registers
  static constexpr int PANELS = D / PANEL;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;  // one K or V tile
  static constexpr int Q_PANEL = BQ * 128;     // bytes per Q panel
  static constexpr int KV_PANEL = BK * 128;
  // Q, K ring, V ring, then the barriers; +1024 to align the base
  static constexpr int BYTES =
      Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (1 + 4 * STAGES) + 1024;
  static_assert(BYTES <= 232448, "shared memory of one block");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one 4-D TMA box {64, 1, rows, 1} at (d, head, row, batch) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(head),
      "r"(row), "r"(batch)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets in 16-byte units
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving register traffic across an async wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void fence_scalars(float& a, float& b, float& c,
                                              float& d) {
  asm volatile("" : "+f"(a), "+f"(b), "+f"(c), "+f"(d)::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// named barriers 1 and 2, between the two consumer warpgroups (256 threads)
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// wgmma m64nNk16, bf16 operands, fp32 accumulators. ss: A and B from shared
// memory, both K-major; rs: A from registers, B MN-major (transposed).
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32],
                                                   uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64],
                                                   uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32],
                                                    const uint32_t* a,
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64],
                                                    const uint32_t* a,
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n256k16(float (&d)[128],
                                                    const uint32_t* a,
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_rs_o(float (&o)[D / 2],
                                           const uint32_t* a, uint64_t db) {
  if constexpr (D == 64) wgmma_rs_m64n64k16(o, a, db);
  else if constexpr (D == 128) wgmma_rs_m64n128k16(o, a, db);
  else wgmma_rs_m64n256k16(o, a, db);
}

// S = Q K^T for one warpgroup's 64 rows against a K tile: D / 16 steps of
// wgmma m64nBKk16 over the swizzled panels, issued and committed as a group
template <int D>
__device__ __forceinline__ void issue_s(float (&sc)[Cfg<D>::NS], uint32_t q,
                                        uint32_t k) {
  using C = Cfg<D>;
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    const uint32_t off = (kd % 4) * 32;  // 16 values into a 128-byte row
    const uint64_t da = desc_sw128(q + (kd / 4) * C::Q_PANEL + off, 16, 1024);
    const uint64_t db = desc_sw128(k + (kd / 4) * C::KV_PANEL + off, 16, 1024);
    if constexpr (C::BK == 128) wgmma_ss_m64n128k16(sc, da, db, kd > 0);
    else wgmma_ss_m64n64k16(sc, da, db, kd > 0);
  }
  wgmma_commit();
}

// O += P V over a V tile, P (bf16) from registers, committed as a group
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[Cfg<D>::NS / 2],
                                         uint32_t v) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < C::BK / 16; ++kk) {
    // V is MN-major: 8-key groups 1024 bytes apart (SBO), 64-column panels
    // KV_PANEL apart (LBO); 16 keys are 2048 bytes
    const uint64_t db = desc_sw128(v + kk * 2048, C::KV_PANEL, 1024);
    wgmma_rs_o<D>(o, pa + 4 * kk, db);
  }
  wgmma_commit();
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; -1e30 gives 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Scale, mask and online softmax of one tile's scores, in place, in base 2:
// sc becomes P = 2^(s log2(e) / sqrt(D) - m) in fp32, m being the row's
// running max in the same units (against 0 for a row that has seen no key,
// so its P is 0); m and l are updated (l summing this thread's columns),
// and al0, al1 are the factors by which O's rows must be scaled.
template <int NS>
__device__ __forceinline__ void softmax_tile(float (&sc)[NS], float& m0,
                                             float& m1, float& l0, float& l1,
                                             float& al0, float& al1, int k0,
                                             int lo0, int hi0, int lo1,
                                             int hi1, bool need_mask,
                                             float scale_l2) {
  float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
  for (int j = 0; j < NS / 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float a = sc[4 * j + e], c = sc[4 * j + 2 + e];
      if (need_mask) {  // selects, no branches
        const int kp = k0 + 8 * j + e;
        a = (kp >= lo0) & (kp <= hi0) ? a : NEG_INF;
        c = (kp >= lo1) & (kp <= hi1) ? c : NEG_INF;
      }
      sc[4 * j + e] = a;
      sc[4 * j + 2 + e] = c;
      mx0 = fmaxf(mx0, a);
      mx1 = fmaxf(mx1, c);
    }
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
  }
  // the scale is > 0, so the max of the scaled scores is the scaled max
  const float mn0 = fmaxf(m0, mx0 > NEG_INF ? mx0 * scale_l2 : NEG_INF);
  const float mn1 = fmaxf(m1, mx1 > NEG_INF ? mx1 * scale_l2 : NEG_INF);
  // no visible key yet: against 0 every probability is 0, so l stays 0
  const float ref0 = mn0 > NEG_INF ? mn0 : 0.0f;
  const float ref1 = mn1 > NEG_INF ? mn1 : 0.0f;
  al0 = ex2(m0 - ref0);
  al1 = ex2(m1 - ref1);
  m0 = mn0;
  m1 = mn1;
  float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
  for (int j = 0; j < NS / 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float p0 = ex2(fmaf(sc[4 * j + e], scale_l2, -ref0));
      const float p1 = ex2(fmaf(sc[4 * j + 2 + e], scale_l2, -ref1));
      sc[4 * j + e] = p0;
      sc[4 * j + 2 + e] = p1;
      sum0 += p0;
      sum1 += p1;
    }
  l0 = l0 * al0 + sum0;
  l1 = l1 * al1 + sum1;
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            __nv_bfloat16* __restrict__ out, int Sq, int Sk,
                            int H, int Hkv, int causal, int window,
                            float scale_l2) {
  using C = Cfg<D>;
  constexpr int BK = C::BK, STAGES = C::STAGES, NS = C::NS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t q_s = smem_addr(smem);
  const uint32_t k_s = q_s + C::Q_BYTES;            // STAGES K tiles
  const uint32_t v_s = k_s + STAGES * C::KV_BYTES;  // STAGES V tiles
  const uint32_t bar = v_s + STAGES * C::KV_BYTES;  // 8 bytes each
  const uint32_t q_full = bar;
  // a full and an empty barrier for each K stage and each V stage
  auto full_k = [&](int s) { return bar + 8 * (1 + s); };
  auto empty_k = [&](int s) { return bar + 8 * (1 + STAGES + s); };
  auto full_v = [&](int s) { return bar + 8 * (1 + 2 * STAGES + s); };
  auto empty_v = [&](int s) { return bar + 8 * (1 + 3 * STAGES + s); };

  const int q_lo = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  // the band of keys some row of this block can see
  const int q_hi = min(q_lo + BQ, Sq) - 1;
  const int k_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int k_end = causal ? min(Sk, q_hi + 1) : Sk;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 2 * 128);  // every consumer thread
      mbar_init(empty_v(s), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread issues every TMA copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x != 256) return;
    mbar_expect_tx(q_full, C::Q_BYTES);
    for (int p = 0; p < C::PANELS; ++p)
      tma_load(q_s + p * C::Q_PANEL, &q_map, q_full, p * PANEL, h, q_lo, b);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES, k0 = k_begin + j * BK;
      const uint32_t parity = ((j / STAGES) & 1) ^ 1;
      mbar_wait(empty_k(s), parity);
      mbar_expect_tx(full_k(s), C::KV_BYTES);
      for (int p = 0; p < C::PANELS; ++p)
        tma_load(k_s + s * C::KV_BYTES + p * C::KV_PANEL, &k_map, full_k(s),
                 p * PANEL, kvh, k0, b);
      mbar_wait(empty_v(s), parity);
      mbar_expect_tx(full_v(s), C::KV_BYTES);
      for (int p = 0; p < C::PANELS; ++p)
        tma_load(v_s + s * C::KV_BYTES + p * C::KV_PANEL, &v_map, full_v(s),
                 p * PANEL, kvh, k0, b);
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q_lo + 64 wg .. + 63; thread
  // (warp w, lane) holds rows r0 = 16 w + lane / 4 and r0 + 8 of them, and
  // columns 8 j + 2 (lane % 4) + {0, 1} of each 8-column chunk j
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int lane = threadIdx.x & 31, w = (threadIdx.x / 32) & 3;
  const int wr_lo = q_lo + 64 * wg;
  const int wr_hi = min(wr_lo + 63, Sq - 1);
  const int r0 = wr_lo + 16 * w + lane / 4;
  const int cq = 2 * (lane & 3);
  const uint32_t q_wg = q_s + wg * 64 * 128;  // this warpgroup's Q rows
  // the keys rows r0 and r0 + 8 see, less this thread's column offset cq:
  // kp + cq is visible to row r when lo <= kp <= hi
  const int lo0 = (window > 0 ? r0 - window + 1 : INT_MIN / 2) - cq;
  const int lo1 = (window > 0 ? r0 + 8 - window + 1 : INT_MIN / 2) - cq;
  const int hi0 = (causal ? min(r0, Sk - 1) : Sk - 1) - cq;
  const int hi1 = (causal ? min(r0 + 8, Sk - 1) : Sk - 1) - cq;

  // the tiles some row of this warpgroup sees: a run [j_lo, j_hi); a tile
  // is skipped when every key of it is past the causal edge of the last row
  // or at or before the window's edge of the first
  int j_lo = 0, j_hi = wr_lo <= wr_hi ? n_tiles : 0;
  if (causal && j_hi > 0) j_hi = min(j_hi, (wr_hi - k_begin) / BK + 1);
  if (window > 0) {
    const int lim = wr_lo - window - BK + 1 - k_begin;
    if (lim >= 0) j_lo = lim / BK + 1;
  }
  auto need_mask = [&](int k0) {
    return k0 + BK > Sk || (causal && k0 + BK - 1 > wr_lo) ||
           (window > 0 && k0 <= wr_hi - window);
  };

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.0f, l1 = 0.0f, al0, al1;
  float sc[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) sc[i] = 0.0f;
  uint32_t pa[NS / 2];  // P in bf16: the A operand of P V

  // The two warpgroups take turns to issue their wgmma (barriers 1 + wg):
  // one's products run while the other does its softmax. Each takes
  // n_tiles + 1 turns, warpgroup 0 first; a turn issues the products of
  // at most one tile step and then passes the turn on.
  const int turns = n_tiles + 1;
  int turn = 0;
  auto my_turn = [&]() { bar_sync(1 + wg); };
  auto pass_turn = [&]() {
    ++turn;
    if (wg == 0 || turn < turns) bar_arrive(2 - wg);
  };
  // a tile no row here sees: a turn without products, then release it
  auto pass_tile = [&](int j) {
    mbar_wait(full_k(j % STAGES), (j / STAGES) & 1);
    mbar_wait(full_v(j % STAGES), (j / STAGES) & 1);
    my_turn();
    pass_turn();
    mbar_arrive(empty_k(j % STAGES));
    mbar_arrive(empty_v(j % STAGES));
  };
  if (wg == 1) bar_arrive(1);  // warpgroup 0's first turn

  mbar_wait(q_full, 0);
  for (int j = 0; j < min(j_lo, n_tiles); ++j) pass_tile(j);
  if (j_lo < j_hi) {
    // the run's first scores, softmax and P
    {
      const int s = j_lo % STAGES, k0 = k_begin + j_lo * BK;
      mbar_wait(full_k(s), (j_lo / STAGES) & 1);
      my_turn();
      wgmma_fence();
      issue_s<D>(sc, q_wg, k_s + s * C::KV_BYTES);
      pass_turn();
      wgmma_wait<0>();
      fence_regs(sc);
      mbar_arrive(empty_k(s));
      softmax_tile(sc, m0, m1, l0, l1, al0, al1, k0, lo0, hi0, lo1, hi1,
                   need_mask(k0), scale_l2);
#pragma unroll
      for (int i = 0; i < NS / 2; ++i)
        pa[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
    }
    // each tile j but the last: S(j + 1) is issued, then P(j) V(j); the
    // softmax of S(j + 1) runs while P(j) V(j) is on the tensor cores, and
    // O is rescaled once that product is done
    for (int j = j_lo; j < j_hi - 1; ++j) {
      const int s = j % STAGES, s1 = (j + 1) % STAGES;
      const int k1 = k_begin + (j + 1) * BK;
      mbar_wait(full_k(s1), ((j + 1) / STAGES) & 1);
      mbar_wait(full_v(s), (j / STAGES) & 1);
      fence_regs(o);
      fence_regs(pa);
      my_turn();
      wgmma_fence();
      issue_s<D>(sc, q_wg, k_s + s1 * C::KV_BYTES);
      issue_pv<D>(o, pa, v_s + s * C::KV_BYTES);
      pass_turn();
      wgmma_wait<1>();  // S(j + 1) is done; P(j) V(j) may still run
      fence_regs(sc);
      mbar_arrive(empty_k(s1));
      softmax_tile(sc, m0, m1, l0, l1, al0, al1, k1, lo0, hi0, lo1, hi1,
                   need_mask(k1), scale_l2);
      fence_regs(sc);  // the softmax stays ahead of the wait, beside P V
      fence_scalars(l0, l1, al0, al1);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      mbar_arrive(empty_v(s));
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        o[4 * i] *= al0;
        o[4 * i + 1] *= al0;
        o[4 * i + 2] *= al1;
        o[4 * i + 3] *= al1;
      }
#pragma unroll
      for (int i = 0; i < NS / 2; ++i)
        pa[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
    }
    // the run's last P V
    {
      const int s = (j_hi - 1) % STAGES;
      mbar_wait(full_v(s), ((j_hi - 1) / STAGES) & 1);
      fence_regs(o);
      fence_regs(pa);
      my_turn();
      wgmma_fence();
      issue_pv<D>(o, pa, v_s + s * C::KV_BYTES);
      pass_turn();
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(empty_v(s));
    }
  } else {  // no run: the turn it would have taken
    my_turn();
    pass_turn();
  }
  for (int j = max(j_hi, j_lo); j < n_tiles; ++j) pass_tile(j);

  // out = O / max(l, 1e-30), rows below Sq
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const float d0 = 1.0f / fmaxf(l0, 1e-30f), d1 = 1.0f / fmaxf(l1, 1e-30f);
  const int64_t row_stride = (int64_t)H * D;
  __nv_bfloat16* o0 = out + ((int64_t)b * Sq + r0) * row_stride +
                      (int64_t)h * D + cq;
  __nv_bfloat16* o1 = o0 + 8 * row_stride;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (r0 < Sq)
      *reinterpret_cast<uint32_t*>(o0 + 8 * j) =
          pack_bf16(o[4 * j] * d0, o[4 * j + 1] * d0);
    if (r0 + 8 < Sq)
      *reinterpret_cast<uint32_t*>(o1 + 8 * j) =
          pack_bf16(o[4 * j + 2] * d1, o[4 * j + 3] * d1);
  }
}

// cuTensorMapEncodeTiled, looked up through cudaGetDriverEntryPoint so that
// the library links no libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the 4-D (B, S, heads, D) bf16 array as a tensor map with boxes of
// {64, 1, rows, 1} and 128-byte swizzle; out-of-range elements read as 0
bool make_map(CUtensorMap* map, const void* base, int B, int S, int heads,
              int D, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {PANEL, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* out, int B,
             int Sq, int Sk, int H, int Hkv, int causal, int window,
             cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, B, Sq, H, D, BQ) ||
      !make_map(&km, k, B, Sk, Hkv, D, Cfg<D>::BK) ||
      !make_map(&vm, v, B, Sk, Hkv, D, Cfg<D>::BK))
    return (int)cudaErrorInvalidValue;
  constexpr int bytes = Cfg<D>::BYTES;
  // once per device: the attribute call costs host time on every launch
  static bool attribute_set[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !attribute_set[dev]) {
    e = cudaFuncSetAttribute(flash_attention_sm90_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) attribute_set[dev] = true;
  }
  // log2(e) / sqrt(D): the scores in base 2
  const float scale_l2 = (float)(1.4426950408889634 / sqrt((double)D));
  const dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)H, (unsigned)B);
  flash_attention_sm90_kernel<D><<<grid, THREADS, bytes, stream>>>(
      qm, km, vm, (__nv_bfloat16*)out, Sq, Sk, H, Hkv, causal, window,
      scale_l2);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: (B, Sq, H, D); k, v: (B, Sk, Hkv, D); all contiguous bf16, 16-byte
// aligned, on the caller's current device; D in {64, 128, 256}. Launches on
// `stream` and returns cudaGetLastError() after the launch.
extern "C" int flash_attention_bf16_sm90(const void* q, const void* k,
                                         const void* v, void* out, int B,
                                         int Sq, int Sk, int H, int Hkv, int D,
                                         int causal, int window,
                                         void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || Hkv <= 0 || H % Hkv ||
      window < 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 64: return launch_d<64>(q, k, v, out, B, Sq, Sk, H, Hkv, causal, window, s);
    case 128: return launch_d<128>(q, k, v, out, B, Sq, Sk, H, Hkv, causal, window, s);
    case 256: return launch_d<256>(q, k, v, out, B, Sq, Sk, H, Hkv, causal, window, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
