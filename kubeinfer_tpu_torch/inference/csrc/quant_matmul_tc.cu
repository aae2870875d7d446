// Tensor-core int8-weight matmul for Hopper (sm_90a): the route of every
// bf16 call of kernel #15 with K % 16 == 0, N % 16 == 0 and 16-byte
// aligned x and qw (weight_quant.qmm_route).
//
// Replaces kubeinfer_tpu/inference/weight_quant.py:quant_matmul (:204,
// pallas_call :222, body _quant_matmul_kernel :189 with _wq_tile_dot
// :156 and _wq_finish :169): out[M, N] = (x[M, K] @ qw[K, N]) * scale[N],
// the int8 codes cast exactly to bf16 (|q| <= 127), the sum in f32, the
// f32 per-column scale applied to the f32 sum and cast to bf16 once.
// Plain PyTorch version: kubeinfer_tpu_torch/inference/weight_quant.py
// quant_matmul_plain, which this kernel matches within 2**-6 of each
// output row's magnitude (bf16 x bf16 products are exact in f32; only
// the order of the f32 sums differs). Every other bf16 shape and every
// f32 call stay on quant_matmul.cu.
//
// Bound on this card (H100 SXM: 989 TFLOP/s bf16 dense, 3.35 TB/s), on
// the llama-3-8b projections (K, N in 1024..14336):
// - M in the hundreds and thousands (an admit's 512 rows, an engine
//   chunk's 2048) by operations: 2 M N K, 240.5 GFLOP for a 2048-row
//   gate projection (0.243 ms);
// - M <= 64 (a decode step's 8 rows, a T = 5 verify window's 40) by
//   bytes: the int8 weight is read once, 58.7 MB for the gate
//   projection (0.0176 ms), and x, scale and out are small beside it.
//
// Design: the weight is wgmma's A operand, converted in registers, and x
// is its B operand, so out^T[N, M] = qw^T[N, K] . x^T[K, M].
// - A block owns 128 weight columns and kRows rows of x (8, 16, 32 or 64
//   for M <= 64, padded by TMA's zero fill, so 8 decode rows pay no
//   padding to 64; above, 256 where such blocks fill the card, else 128:
//   weight_quant.qmm_tc_plan), over a range of K in 64-deep stages. Two
//   consumer warpgroups own 64 weight columns each; a producer
//   warpgroup (one thread of it; the rest only hand their registers to
//   the consumers by setmaxnreg: 232 a consumer thread, so a 256-row
//   block's 128 accumulators and two A buffers need no spill) keeps a
//   ring of stages in flight by TMA: the x tile (bf16, 128-byte swizzle,
//   K-major: wgmma's B) and the int8 weight tile [64 k, 128 n] (128-byte
//   swizzle, its raw codes: half of bf16's bytes). The ring is as deep
//   as shared memory allows (5 stages at 256 rows, 9 at 128, 12 at
//   decode sizes: up to 96 KB of codes in flight a block).
// - Each consumer thread gathers its A fragment's codes from the staged
//   tile (two-byte loads: its fragment rows g and g + 8 are mapped to
//   the neighbouring weight columns 2g and 2g + 1, so one load serves
//   both and the epilogue stores column pairs), turns them into bf16
//   exactly (the codes offset into a float's mantissa, one subtract, the
//   high halves kept) and issues wgmma m64nNk16 (N = kRows) with A from
//   registers and f32 accumulators in registers. The conversion of stage
//   i + 1 runs while stage i's products are in flight (two register
//   buffers for A); a stage is released to the producer once its
//   products are done. The converted weight never touches shared
//   memory: shared memory carries only the TMA tiles and wgmma's reads
//   of x, and the conversion is paid once per weight tile for kRows rows.
// - Split K: where the (M, N) tiles alone leave SMs idle (k and v's
//   N = 1024, the down projection at decode), the wrapper gives each
//   block a range of K (weight_quant.qmm_tc_plan). The splits combine
//   in the same launch: each block writes its f32 partial to a
//   workspace, takes a ticket of its tile after __threadfence(), and the
//   block that draws the last one adds the partials in split order
//   (0, 1, ...), applies the scale, casts once and resets the ticket for
//   the next launch. The sum's order does not depend on which block
//   finishes last, so two calls on the same inputs give the same bits.
// - Ragged edges: TMA zero-fills x rows past M, x columns and weight rows
//   past K, and weight columns past N (zeros add exactly 0); the
//   epilogue stores only rows < M and columns < N.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBK = 64;    // K a stage: one 128-byte swizzle row of bf16
constexpr int kBN = 128;   // weight columns a block: 64 a consumer warpgroup
constexpr int kRaw = kBK * kBN;    // the int8 tile of a stage
constexpr int kCons = 256;         // consumer threads: warpgroups 0 and 1
constexpr int kThreads = kCons + 128;  // and the producer warpgroup
constexpr int kSmemBudget = 224 * 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers and TMA ------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// --- wgmma ------------------------------------------------------------------

// shared-memory matrix descriptor, 128-byte swizzle (layout type 1); the
// offsets are in bytes and every operand block starts 1024-byte aligned
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// pins register values in place around the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D[64 x n] += A[64 x 16] . B[16 x n]: A (bf16 pairs) from registers, B
// from shared memory, K-major (trans-b = 0)

__device__ __forceinline__ void wgmma_rs_n8(float* d, const uint32_t* a,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x n] += A . B for n = kRows
template <int kRows>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (kRows == 8) {
    wgmma_rs_n8(d, a, db);
  } else if constexpr (kRows == 16) {
    wgmma_rs_n16(d, a, db);
  } else if constexpr (kRows == 32) {
    wgmma_rs_n32(d, a, db);
  } else if constexpr (kRows == 64) {
    wgmma_rs_n64(d, a, db);
  } else if constexpr (kRows == 128) {
    wgmma_rs_n128(d, a, db);
  } else {
    static_assert(kRows == 256, "x rows a block: 8, 16, 32, 64, 128, 256");
    wgmma_rs_n256(d, a, db);
  }
}

template <int N>
__device__ __forceinline__ void fence_uregs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// --- the int8 -> bf16 conversion --------------------------------------------

// four int8 codes (one word, lowest byte first) as two bf16 pairs, exact:
// q + 128 as the low byte of the float 2^23 + (q + 128), minus 2^23 + 128
// gives q exactly; an integer of at most 8 significant bits has a zero
// low half, so its bf16 is the float's high half
__device__ __forceinline__ void codes_bf16(uint32_t w, uint32_t& p01,
                                           uint32_t& p23) {
  const uint32_t u = w ^ 0x80808080u;
  const uint32_t e = 0x4B000000u;
  const float f0 = __uint_as_float(__byte_perm(u, e, 0x7650)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, e, 0x7651)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, e, 0x7652)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, e, 0x7653)) - 8388736.f;
  p01 = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  p23 = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// A fragments of the four k16 steps of a stage: raw is the staged int8
// tile [64 k][128 n] in the 128-byte swizzle (16-byte chunk c of row k
// at (c ^ (k % 8)) * 16), col the byte of this thread's weight columns
// (2g, 2g + 1 of its warp's 16) in a row. Fragment register 0 holds
// rows g (column 2g) and k 2tg, 2tg + 1; 1 row g + 8 (column 2g + 1);
// 2 and 3 the same at k + 8.
__device__ __forceinline__ void load_a(uint32_t* a, const uint8_t* raw,
                                       int col, int tg) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = 16 * kk + 8 * h + 2 * tg;
      const int c = col >> 4, b = col & 15;
      const uint32_t u0 = *reinterpret_cast<const uint16_t*>(
          raw + k * kBN + ((c ^ (k & 7)) << 4) + b);
      const uint32_t u1 = *reinterpret_cast<const uint16_t*>(
          raw + (k + 1) * kBN + ((c ^ ((k + 1) & 7)) << 4) + b);
      // bytes (k, 2g), (k + 1, 2g), (k, 2g + 1), (k + 1, 2g + 1)
      codes_bf16(__byte_perm(u0, u1, 0x5140), a[4 * kk + 2 * h],
                 a[4 * kk + 2 * h + 1]);
    }
  }
}

// --- the kernel -------------------------------------------------------------

// kRows: x rows a block. One ring of load stages (x tile, int8 tile).
template <int kRows>
struct Layout {
  static constexpr int kX = kRows * 128;  // the x tile, a multiple of 1024
  static constexpr int kLoad = kX + kRaw;
  static constexpr int kLoads =
      kSmemBudget / kLoad < 12 ? kSmemBudget / kLoad : 12;
  static constexpr int kBar = kLoads * kLoad;  // 2 x kLoads mbarriers
  static constexpr size_t kBytes = 1024 + kBar + 2 * kLoads * 8 + 16;
};

template <int kRows>
__global__ void __launch_bounds__(kThreads, 1) qmm_tc_kernel(
    const __grid_constant__ CUtensorMap tm_x,
    const __grid_constant__ CUtensorMap tm_w, const float* __restrict__ scale,
    __nv_bfloat16* __restrict__ out, float* __restrict__ ws,
    int* __restrict__ tickets, int M, int N, int K, int m_tiles, int k_per) {
  using L = Layout<kRows>;
  constexpr int S = L::kLoads;
  constexpr int kAcc = kRows / 2;  // f32 accumulators a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::kBar);  // landed
  uint64_t* empty = full + S;  // its products done
  int* s_last = reinterpret_cast<int*>(empty + S);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = (blockIdx.x % m_tiles) * kRows;
  const int n0 = (blockIdx.x / m_tiles) * kBN;
  const int splits = gridDim.y, split = blockIdx.y;
  const int kt0 = split * k_per;
  const int n_k = min((K + kBK - 1) / kBK, kt0 + k_per) - kt0;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kCons / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kCons / 32) {
    // the producer warpgroup, one thread of which refills stage s once
    // the consumers release it; its registers go to the consumers (168
    // a thread at launch: 128 x (168 - 40) = 256 x (232 - 168))
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (warp == kCons / 32 && lane == 0) {
      for (int it = 0; it < n_k; ++it) {
        const int s = it % S;
        if (it >= S) mbar_wait(&empty[s], ((it / S) - 1) & 1);
        uint8_t* st = sm + s * L::kLoad;
        const int k0 = (kt0 + it) * kBK;
        mbar_expect_tx(&full[s], L::kLoad);
        tma_2d(st, &tm_x, &full[s], k0, m0);
        tma_2d(st + L::kX, &tm_w, &full[s], n0, k0);
      }
    }
  } else {
    // the consumers: warpgroup wg owns weight columns 64 wg .. 64 wg + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = warp >> 2, w = warp & 3, g = lane >> 2, tg = lane & 3;
    const int col = 64 * wg + 16 * w + 2 * g;  // fragment rows g, g + 8
    float acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    uint32_t a[2][16];  // A fragments of two stages in turn

    auto fetch = [&](uint32_t* frag, int it) {
      const int s = it % S;
      mbar_wait(&full[s], (it / S) & 1);
      load_a(frag, sm + s * L::kLoad + L::kX, col, tg);
    };
    // issue stage it from frag; then wait for stage it - 1's products,
    // release its stage and convert stage it + 1 into the other buffer
    auto step = [&](uint32_t* frag, uint32_t* other, int it) {
      const uint8_t* xs = sm + (it % S) * L::kLoad;
      fence_regs<kAcc>(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_rs<kRows>(acc, frag + 4 * kk,
                        sw128_desc(xs + kk * 32, 16, 1024));
      wg_commit();
      wg_wait<1>();
      fence_regs<kAcc>(acc);
      fence_uregs<16>(other);  // stage it - 1's fragments are read
      if (it > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % S]);
      if (it + 1 < n_k) fetch(other, it + 1);
    };
    if (n_k > 0) fetch(a[0], 0);
    for (int it = 0; it < n_k; it += 2) {
      step(a[0], a[1], it);
      if (it + 1 < n_k) step(a[1], a[0], it + 1);
    }
    wg_wait<0>();
    fence_regs<kAcc>(acc);
    fence_uregs<16>(a[0]);
    fence_uregs<16>(a[1]);

    // acc[4j + 2i + c]: D row 16 w + g + 8 i, that is weight column
    // n0 + col + i, and D column 8 j + 2 tg + c, that is x row m
    const int n = n0 + col;
    if (n < N) {
      const float s0 = scale[n], s1 = scale[n + 1];
#pragma unroll
      for (int j = 0; j < kAcc / 4; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int m = m0 + 8 * j + 2 * tg + c;
          if (m >= M) continue;
          const float v0 = acc[4 * j + c], v1 = acc[4 * j + 2 + c];
          if (splits > 1) {
            *reinterpret_cast<float2*>(ws + ((size_t)split * M + m) * N + n) =
                make_float2(v0, v1);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * N + n) =
                __floats2bfloat162_rn(v0 * s0, v1 * s1);
          }
        }
      }
    }
  }
  if (splits == 1) return;

  // the last of the tile's splits to finish adds them in split order
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int prev = atomicAdd(&tickets[blockIdx.x], 1);
    *s_last = prev == splits - 1;
    if (*s_last) atomicExch(&tickets[blockIdx.x], 0);  // for the next launch
  }
  __syncthreads();
  if (!*s_last) return;
  __threadfence();
  // four columns an item, the loads of four splits in flight at a time,
  // added in split order
  const int rows = min(kRows, M - m0);
  const size_t stride = (size_t)M * N;
  for (int idx = tid; idx < rows * (kBN / 4); idx += kThreads) {
    const int m = m0 + idx / (kBN / 4), n = n0 + 4 * (idx % (kBN / 4));
    if (n >= N) continue;
    const float* p = ws + (size_t)m * N + n;
    float4 sum = __ldcg(reinterpret_cast<const float4*>(p));
    int z = 1;
    for (; z + 4 <= splits; z += 4) {
      float4 q[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        q[u] = __ldcg(reinterpret_cast<const float4*>(p + (z + u) * stride));
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        sum.x += q[u].x;
        sum.y += q[u].y;
        sum.z += q[u].z;
        sum.w += q[u].w;
      }
    }
    for (; z < splits; ++z) {
      const float4 q = __ldcg(reinterpret_cast<const float4*>(p + z * stride));
      sum.x += q.x;
      sum.y += q.y;
      sum.z += q.z;
      sum.w += q.w;
    }
    __nv_bfloat162 o[2] = {
        __floats2bfloat162_rn(sum.x * scale[n], sum.y * scale[n + 1]),
        __floats2bfloat162_rn(sum.z * scale[n + 2], sum.w * scale[n + 3])};
    *reinterpret_cast<uint2*>(out + (size_t)m * N + n) =
        *reinterpret_cast<const uint2*>(o);
  }
}

// --- host: tensor maps and launch -----------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda the CUDA runtime has already
// loaded: no link against libcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 2-D tiled map over [rows, cols] (cols innermost, row stride in bytes)
// of bf16 or of bytes, with the 128-byte swizzle
bool encode(CUtensorMap* map, const void* base, uint64_t cols, uint64_t rows,
            uint64_t row_bytes, uint32_t box_cols, uint32_t box_rows,
            bool bytes) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t ones[2] = {1, 1};
  return fn(map,
            bytes ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            2, const_cast<void*>(base), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kRows>
cudaError_t launch(const void* x, const void* qw, const void* scale, void* out,
                   void* ws, void* tickets, int M, int N, int K, int splits,
                   int k_per, cudaStream_t stream) {
  CUtensorMap tx, tw;
  if (!encode(&tx, x, K, M, (uint64_t)K * 2, kBK, kRows, false) ||
      !encode(&tw, qw, N, K, N, kBN, kBK, true))
    return cudaErrorInvalidValue;
  const size_t smem = Layout<kRows>::kBytes;
  auto kern = qmm_tc_kernel<kRows>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int m_tiles = (M + kRows - 1) / kRows;
  dim3 grid(m_tiles * ((N + kBN - 1) / kBN), splits);
  kern<<<grid, kThreads, smem, stream>>>(
      tx, tw, static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws),
      static_cast<int*>(tickets), M, N, K, m_tiles, k_per);
  return cudaGetLastError();
}

}  // namespace

// x bf16 [M, K], qw int8 [K, N], scale f32 [N], out bf16 [M, N]; K % 16 ==
// 0, N % 16 == 0, x and qw 16-byte aligned. Blocks of `rows` rows of x (8,
// 16, 32, 64, 128 or 256) and 128 weight columns; K splits over `splits`
// ranges of k_per 64-deep tiles, each non-empty; with splits > 1, ws
// holds splits * M * N floats and tickets one zeroed int a (M, N) tile
// (weight_quant.qmm_tc_plan gives all three).
extern "C" int quant_matmul_tc_launch(const void* x, const void* qw,
                                      const void* scale, void* out, void* ws,
                                      void* tickets, int M, int N, int K,
                                      int rows, int splits, int k_per,
                                      void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0) return cudaSuccess;
  const int k_tiles = (K + kBK - 1) / kBK;
  if (K <= 0 || K % 16 || N % 16 || splits < 1 || splits > 65535 ||
      k_per < 1 || (splits - 1) * k_per >= k_tiles ||
      splits * k_per < k_tiles || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(qw) % 16 ||
      (splits > 1 && (ws == nullptr || tickets == nullptr)))
    return cudaErrorInvalidValue;
  switch (rows) {
    case 8:
      return launch<8>(x, qw, scale, out, ws, tickets, M, N, K, splits,
                       k_per, st);
    case 16:
      return launch<16>(x, qw, scale, out, ws, tickets, M, N, K, splits,
                        k_per, st);
    case 32:
      return launch<32>(x, qw, scale, out, ws, tickets, M, N, K, splits,
                        k_per, st);
    case 64:
      return launch<64>(x, qw, scale, out, ws, tickets, M, N, K, splits,
                        k_per, st);
    case 128:
      return launch<128>(x, qw, scale, out, ws, tickets, M, N, K, splits,
                         k_per, st);
    case 256:
      return launch<256>(x, qw, scale, out, ws, tickets, M, N, K, splits,
                         k_per, st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* quant_matmul_tc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
