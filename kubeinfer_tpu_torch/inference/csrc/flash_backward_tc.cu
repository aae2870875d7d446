// Tensor-core backward of the ragged causal GQA flash attention for Hopper
// (sm_90a): the bf16 route of kernel #14 for head widths D = 64 and 128,
// as two kernels.
//
// Replaces kubeinfer_tpu/inference/flash_attention.py:_diff_bwd, its dQ
// pallas_call (:1590, body _flash_bwd_dq_kernel :1349) and its dK/dV
// pallas_call (:1617, body _flash_bwd_dkv_kernel :1396). Plain PyTorch
// versions: kubeinfer_tpu_torch/inference/flash_attention.py
// flash_bwd_dq_plain and flash_bwd_dkv_plain, which these kernels match
// within 2**-6 of each row's magnitude (bf16 x bf16 products are exact in
// f32; the sums run in another order, which can move a rounded dS by one
// ulp). f32 and other head widths stay on the CUDA-core kernels in
// flash_backward.cu.
//
// What they compute. q, dO [B, T, H, D], k, v [B, S, n_kv, D], bf16; lse
// and drow = rowsum(dO * O) f32 [B * n_kv, T * G] in the folded (t, g) row
// order of one kv head (G = H / n_kv). Query t of row b attends key s iff
// s <= q_offset + t and s < row_lens[b]. Per live (folded row, key) pair:
//   P  = exp((q . k) * scale - lse)    (0 exactly where masked, and on
//                                       every query of a row with
//                                       row_len == 0),
//   dP = dO . v,   dS = P * (dP - drow),
// summed in f32 with the reference's roundings: dS rounded to bf16 before
// dS . K and dS^T . Q, P before P^T . dO; the scale multiplies the summed
// dQ and dK once, at the end:
//   dQ = scale * sum_s bf(dS) K,  dV = sum_t bf(P)^T dO,
//   dK = scale * sum_t bf(dS)^T Q.
// Each block owns its output tile: no atomics, and the result does not
// depend on the order blocks run in. A row with row_len == 0 walks nothing
// and gets exactly zero gradients.
//
// Bound on this card (H100 SXM: 989 TFLOP/s bf16 dense, 3.35 TB/s):
// operations. dQ does 6 * D flops per live (query head, key) pair (S, dP,
// dS . K), dK/dV 8 * D (S^T, dP^T, P^T . dO, dS^T . Q): at q [1, 2048, 32,
// 128] causal (67.1 M live pairs) 51.6 and 68.8 GFLOP, 0.052 and 0.070 ms,
// against some 50 MB moved (0.015 ms).
//
// Design. Every product is wgmma m64nNk16 (bf16 in, f32 accumulators);
// every Q, K, V and dO tile comes by TMA (cp.async.bulk.tensor, mbarrier
// completion) with the 128-byte swizzle; the operand layouts are
// flash_prefill_tc.cu's.
// - Rows: the reference's GQA fold. A query tile is 64 folded rows of one
//   (batch row b, kv head h), TB = 64 / G positions x G heads (16 x 4 on
//   llama-3-8b): one 5-D TMA box over (d, g, kv head, t, b) per 64-column
//   chunk, as the forward loads Q. Rows past T are zero-filled by TMA.
// - dq_kernel: a block (one warpgroup) owns one query tile; Q and dO stay
//   resident in shared memory, each row's lse and drow in registers. It
//   walks the key tiles (64 keys, 4-D boxes over (d, kv head, s, b)) before
//   min(row_len, the block's last position + 1), the reference's skip
//   rule, through a 2-stage ring. Per tile: S = Q . K^T and dP = dO . V^T
//   (both operands from shared memory, K-major), dS built in registers and
//   packed into bf16 A fragments, dQ += dS . K with K MN-major (trans-b = 1).
//   The last query tiles (the longest walks) run first.
// - dkv_kernel: a block owns 128 keys of one (b, h), 64 keys for each of
//   two warpgroups; their K and V tiles are loaded once and stay resident.
//   It walks the query tiles that can see its first key, from the tile
//   holding position max(0, s0 - q_offset) to the last, and both
//   warpgroups share every Q / dO / lse / drow tile of a 2-stage ring
//   (Q and dO by TMA; the 64 lse and drow values of the next tile are
//   read by 128 threads while this tile computes and stored into its
//   stage at the end: a tile's rows start at any float, and a TMA box
//   whose start is not 16-byte aligned faults). Every product has M =
//   keys:
//   S^T = K . Q^T and dP^T = V . dO^T (from shared memory, K-major), P^T
//   and dS^T in registers (lse and drow index the accumulators' columns,
//   read from shared memory), dV += P^T . dO and dK += dS^T . Q with the
//   A operand from registers and B MN-major. dK and dV take D / 2 f32
//   registers a thread each, S^T and dP^T 32 each: D = 128 is the widest
//   that fits one warpgroup's 255 registers, so wider heads stay on CUDA
//   cores.
// - Gating: keys at or past S or row_len and pairs past the causal edge
//   get P = 0 and dS = 0 by selection (never by multiplying a possibly
//   non-finite score); so do folded rows past T and, in dkv_kernel, the
//   rows 64 - TB * G at the end of a tile that no position fills (their
//   Q / dO rows are zeroed once, so 0 x 0 is all they add).
// - With a non-null `walked` counter each block adds the number of tiles it
//   folds, so a caller can hold the walk against its plain mirror
//   (flash_bwd_walk); a null counter costs nothing.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 64;   // folded query rows of a tile
constexpr int kKeys = 64;   // keys of a dq_kernel tile / a dkv warpgroup
constexpr int kBlockKeys = 2 * kKeys;  // keys of a dkv_kernel block
constexpr int kChunk = 64 * 64 * 2;    // a [64 rows, 64] bf16 swizzle block

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

__device__ __forceinline__ void tma_4d(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1, int c2,
                                       int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_5d(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1, int c2,
                                       int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
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
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// pins register values in place around the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, both from shared memory,
// K-major (trans-a = trans-b = 0)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64]: A (bf16 pairs) from registers, B
// from shared memory, MN-major (trans-b = 1)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
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

// D[64 x 128] += A[64 x 16] . B[16 x 128]: A (bf16 pairs) from registers, B
// from shared memory, MN-major (trans-b = 1)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t (&a)[4],
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
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the bf16 A fragments of four k16 steps from a [64 x 64] accumulator
// (acc[4j + 2i + c]: row warp * 16 + lane / 4 + 8i, column 8j + cq + c)
__device__ __forceinline__ void pack_a(const float* acc, uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const float* a0 = acc + 8 * kk;      // columns 16kk + cq + {0, 1}
    const float* a1 = acc + 8 * kk + 4;  // columns 16kk + 8 + cq + {0, 1}
    a[kk][0] = pack_bf16(a0[0], a0[1]);
    a[kk][1] = pack_bf16(a0[2], a0[3]);
    a[kk][2] = pack_bf16(a1[0], a1[1]);
    a[kk][3] = pack_bf16(a1[2], a1[3]);
  }
}

// d[64 x D] += A[64 x 64] . B[64 x D]: A the fragments of pack_a, B a [64,
// D] tile in 64-column swizzle blocks read MN-major: 16 rows are 2048
// bytes into each block, the next 64 columns the next block (LBO)
template <int D>
__device__ __forceinline__ void mma_rs(float* d, const uint32_t (&a)[4][4],
                                       const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int n = 0; n < D / 128; ++n)
      wgmma_rs_n128(d + 64 * n, a[kk],
                    sw128_desc(b + 2 * n * kChunk + kk * 2048, kChunk, 1024));
    if constexpr (D % 128 != 0)
      wgmma_rs_n64(d + 64 * (D / 128), a[kk],
                   sw128_desc(b + 2 * (D / 128) * kChunk + kk * 2048, kChunk,
                              1024));
  }
}

// d[64 x 64] = A[64 x D] . B[64 x D]^T, both [64, D] tiles in 64-column
// swizzle blocks read K-major: k16 steps of 32 bytes inside a block, the
// next block every 4 steps
template <int D>
__device__ __forceinline__ void mma_ss(float (&d)[32], const uint8_t* a,
                                       const uint8_t* b) {
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int off = (kc >> 2) * kChunk + (kc & 3) * 32;
    wgmma_ss_n64(d, sw128_desc(a + off, 16, 1024), sw128_desc(b + off, 16, 1024),
                 kc > 0);
  }
}

// --- dQ ---------------------------------------------------------------------

// shared memory of a dq block: Q, dO, two stages of K and V, 3 mbarriers
template <int D>
struct DqSmem {
  static constexpr int kTile = (D / 64) * kChunk;  // one [64, D] tile
  static constexpr int kStage = 2 * kTile;         // K, V
  static constexpr int kBar = 2 * kTile + 2 * kStage;
  static constexpr size_t kBytes = 1024 + kBar + 32;
};

template <int D>
__global__ void __launch_bounds__(128) dq_tc_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
    const float* __restrict__ drow, const int* __restrict__ row_lens,
    __nv_bfloat16* __restrict__ dq, int* __restrict__ walked, int T, int S,
    int H, int n_kv, int TB, int q_offset, float scale) {
  using L = DqSmem<D>;
  constexpr int NC = D / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = sm;
  uint8_t* dos = sm + L::kTile;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + L::kBar);  // Q, stage 0/1

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x, b = bh / n_kv, h = bh % n_kv;
  const int G = H / n_kv, R = T * G;
  // the last query tiles first: under a causal mask they walk the most
  // key tiles, so the grid's tail is the light blocks
  const int t0 = (gridDim.y - 1 - blockIdx.y) * TB;
  const int n_t = min(TB, T - t0);
  const int rows = n_t * G;
  // the reference's skip rule: key tiles before min(row_len, the block's
  // last position + 1); none for a row with row_len == 0
  const int lim = min(S, row_lens[b]);
  const int walk = max(0, min(lim, q_offset + t0 + n_t));
  const int n_walk = (walk + kKeys - 1) / kKeys;
  if (walked != nullptr && tid == 0 && n_walk > 0) atomicAdd(walked, n_walk);

  auto load_tile = [&](int i, int st) {  // thread 0: key tile i, stage st
    uint8_t* ks = sm + 2 * L::kTile + st * L::kStage;
    mbar_expect_tx(&bar[1 + st], 2 * L::kTile);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      tma_4d(ks + c * kChunk, &tm_k, &bar[1 + st], c * 64, h, i * kKeys, b);
      tma_4d(ks + L::kTile + c * kChunk, &tm_v, &bar[1 + st], c * 64, h,
             i * kKeys, b);
    }
  };
  if (n_walk > 0 && tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(&bar[0], 2 * NC * TB * G * 128);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      tma_5d(qs + c * kChunk, &tm_q, &bar[0], c * 64, 0, h, t0, b);
      tma_5d(dos + c * kChunk, &tm_do, &bar[0], c * 64, 0, h, t0, b);
    }
    load_tile(0, 0);
  }
  __syncthreads();  // the barriers are initialised

  // this thread's rows of the 64: lr[i] = warp * 16 + lane / 4 + 8 i
  int lr[2], q_pos[2];
  bool valid[2];
  float lse_r[2], drow_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lr[i] = warp * 16 + (lane >> 2) + 8 * i;
    valid[i] = lr[i] < rows;
    q_pos[i] = q_offset + t0 + lr[i] / G;
    const size_t r = (size_t)bh * R + (size_t)t0 * G + lr[i];
    lse_r[i] = valid[i] ? lse[r] : 0.f;
    drow_r[i] = valid[i] ? drow[r] : 0.f;
  }
  const int cq = 2 * (lane & 3);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  if (n_walk > 0) mbar_wait(&bar[0], 0);
  for (int it = 0; it < n_walk; ++it) {
    const int st = it & 1;
    if (it + 1 < n_walk) {
      __syncthreads();  // every warp is done with tile it - 1's stage
      if (tid == 0) {
        proxy_fence();
        load_tile(it + 1, st ^ 1);
      }
    }
    mbar_wait(&bar[1 + st], (it >> 1) & 1);
    const uint8_t* ks = sm + 2 * L::kTile + st * L::kStage;
    const uint8_t* vs = ks + L::kTile;
    const int s0 = it * kKeys;

    float s[32], dp[32];
    wg_fence();
    mma_ss<D>(s, qs, ks);
    mma_ss<D>(dp, dos, vs);
    wg_commit();
    wg_wait0();
    fence_regs<32>(s);
    fence_regs<32>(dp);

    // dS in place of dP; s[4j + 2i + c] is row lr[i], key s0 + 8j + cq + c
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int p = s0 + 8 * j + cq + c;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int x = 4 * j + 2 * i + c;
          const bool ok = valid[i] && p < lim && p <= q_pos[i];
          const float pr = ok ? __expf(s[x] * scale - lse_r[i]) : 0.f;
          dp[x] = ok ? pr * (dp[x] - drow_r[i]) : 0.f;
        }
      }
    }
    uint32_t da[4][4];
    pack_a(dp, da);
    fence_regs<D / 2>(acc);
    wg_fence();
    mma_rs<D>(acc, da, ks);
    wg_commit();
    wg_wait0();
    fence_regs<D / 2>(acc);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!valid[i]) continue;
    __nv_bfloat16* dst =
        dq + ((size_t)(b * T + t0 + lr[i] / G) * H + h * G + lr[i] % G) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + cq) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i] * scale,
                                acc[4 * j + 2 * i + 1] * scale);
    }
  }
}

// --- dK / dV ----------------------------------------------------------------

// shared memory of a dkv block: K and V of both warpgroups, two stages of
// Q, dO, lse and drow, the column table, 3 mbarriers
template <int D>
struct DkvSmem {
  static constexpr int kTile = (D / 64) * kChunk;  // one [64, D] tile
  static constexpr int kV = 2 * kTile;             // V after both K tiles
  static constexpr int kRing = 4 * kTile;
  static constexpr int kStage = 2 * kTile + 1024;  // Q, dO, lse, drow
  static constexpr int kCol = kRing + 2 * kStage;  // int[64]
  static constexpr int kBar = kCol + 256;
  static constexpr size_t kBytes = 1024 + kBar + 32;
};

template <int D>
__global__ void __launch_bounds__(256, 1) dkv_tc_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
    const float* __restrict__ drow, const int* __restrict__ row_lens,
    __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int* __restrict__ walked, int T, int S,
    int H, int n_kv, int TB, int q_offset, float scale) {
  using L = DkvSmem<D>;
  constexpr int NC = D / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + L::kBar);  // K/V, stage 0/1
  int* col_t = reinterpret_cast<int*>(sm + L::kCol);

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int bh = blockIdx.x, b = bh / n_kv, h = bh % n_kv;
  const int G = H / n_kv, R = T * G;
  const int s0 = blockIdx.y * kBlockKeys;
  const int rows = TB * G;  // folded rows a query tile fills
  // the query tiles that can see key s0: from the one holding position
  // max(0, s0 - q_offset) to the last; none if s0 is at or past
  // min(S, row_len) or no query reaches it
  const int lim = min(S, row_lens[b]);
  const int t_first = max(0, s0 - q_offset);
  const int j0 = t_first / TB;
  const int n_walk =
      (s0 < lim && t_first < T) ? (T + TB - 1) / TB - j0 : 0;
  if (walked != nullptr && tid == 0 && n_walk > 0) atomicAdd(walked, n_walk);
  const bool wg1_live = s0 + kKeys < S;  // any key of warpgroup 1's tile

  auto load_q = [&](int it, int st) {  // thread 0: query tile j0 + it
    uint8_t* qs = sm + L::kRing + st * L::kStage;
    const int t0 = (j0 + it) * TB;
    mbar_expect_tx(&bar[1 + st], 2 * NC * rows * 128);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      tma_5d(qs + c * kChunk, &tm_q, &bar[1 + st], c * 64, 0, h, t0, b);
      tma_5d(qs + L::kTile + c * kChunk, &tm_do, &bar[1 + st], c * 64, 0, h,
             t0, b);
    }
  };
  // threads 0-63 read lse, 64-127 drow, of query tile j0 + it (0 past the
  // tile's rows); stored into the tile's stage as floats 0-63 and 128-191
  auto row_val = [&](int it) {
    const int c = tid & 63, r = (j0 + it) * TB * G + c;
    if (tid >= 2 * kRows || c >= rows || r >= R) return 0.f;
    return (tid < kRows ? lse : drow)[(size_t)bh * R + r];
  };
  auto row_slot = [&](int st) {
    return reinterpret_cast<float*>(sm + L::kRing + st * L::kStage +
                                    2 * L::kTile) +
           (tid < kRows ? tid : tid + kRows);
  };
  if (n_walk > 0) {
    if (tid < kRows) col_t[tid] = tid < rows ? tid / G : (1 << 20);
    if (tid < 2 * kRows) *row_slot(0) = row_val(0);
    // the rows no position fills stay zero in every stage's Q and dO
    const int tail = (kRows - rows) * 128;
    for (int st = 0; st < 2; ++st) {
      for (int c = 0; c < 2 * NC; ++c) {
        uint8_t* base = sm + L::kRing + st * L::kStage + c * kChunk + rows * 128;
        for (int x = tid * 16; x < tail; x += 256 * 16)
          *reinterpret_cast<uint4*>(base + x) = make_uint4(0, 0, 0, 0);
      }
    }
    proxy_fence();
    if (tid == 0) {
      for (int i = 0; i < 3; ++i) mbar_init(&bar[i], 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
  __syncthreads();

  if (n_walk > 0 && tid == 0) {
    const int nw = wg1_live ? 2 : 1;
    mbar_expect_tx(&bar[0], 2 * nw * L::kTile);
    for (int w = 0; w < nw; ++w) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        tma_4d(sm + w * L::kTile + c * kChunk, &tm_k, &bar[0], c * 64, h,
               s0 + w * kKeys, b);
        tma_4d(sm + L::kV + w * L::kTile + c * kChunk, &tm_v, &bar[0],
               c * 64, h, s0 + w * kKeys, b);
      }
    }
    load_q(0, 0);
  }

  const uint8_t* ks = sm + wg * L::kTile;
  const uint8_t* vs = sm + L::kV + wg * L::kTile;
  // this thread's keys: key0 and key0 + 8
  const int key0 = s0 + wg * kKeys + warp * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);

  float gk[D / 2], gv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) gk[i] = gv[i] = 0.f;

  if (n_walk > 0) mbar_wait(&bar[0], 0);
  for (int it = 0; it < n_walk; ++it) {
    const int st = it & 1;
    // both warpgroups are done with tile it - 1's stage, and tile it's lse
    // and drow are in
    __syncthreads();
    const bool next = it + 1 < n_walk;
    if (next && tid == 0) {
      proxy_fence();
      load_q(it + 1, st ^ 1);
    }
    const float next_row = next ? row_val(it + 1) : 0.f;
    mbar_wait(&bar[1 + st], (it >> 1) & 1);
    const uint8_t* qs = sm + L::kRing + st * L::kStage;
    const uint8_t* dos = qs + L::kTile;
    const float* lse_s = reinterpret_cast<const float*>(qs + 2 * L::kTile);
    const float* drow_s = lse_s + 128;
    const int t0 = (j0 + it) * TB;
    const int n_t = min(TB, T - t0);

    float s[32], dp[32];
    wg_fence();
    mma_ss<D>(s, ks, qs);
    mma_ss<D>(dp, vs, dos);
    wg_commit();
    wg_wait0();
    fence_regs<32>(s);
    fence_regs<32>(dp);

    // P^T in place of S^T, dS^T in place of dP^T; s[4j + 2i + c] is key
    // key0 + 8i, folded row 8j + cq + c of the tile
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + cq + c;
        const int tl = col_t[col];
        const float l_c = lse_s[col], d_c = drow_s[col];
        const int q_pos = q_offset + t0 + tl;
        const bool col_ok = tl < n_t;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int x = 4 * j + 2 * i + c;
          const int key = key0 + 8 * i;
          const bool ok = col_ok && key < lim && key <= q_pos;
          const float pr = ok ? __expf(s[x] * scale - l_c) : 0.f;
          s[x] = pr;
          dp[x] = ok ? pr * (dp[x] - d_c) : 0.f;
        }
      }
    }
    uint32_t pa[4][4], da[4][4];
    pack_a(s, pa);
    pack_a(dp, da);
    fence_regs<D / 2>(gv);
    fence_regs<D / 2>(gk);
    wg_fence();
    mma_rs<D>(gv, pa, dos);
    mma_rs<D>(gk, da, qs);
    wg_commit();
    wg_wait0();
    fence_regs<D / 2>(gv);
    fence_regs<D / 2>(gk);
    if (next && tid < 2 * kRows) *row_slot(st ^ 1) = next_row;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    if (key >= S) continue;
    const size_t row = (((size_t)b * S + key) * n_kv + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + row + 8 * j + cq) =
          __floats2bfloat162_rn(gk[4 * j + 2 * i] * scale,
                                gk[4 * j + 2 * i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + row + 8 * j + cq) =
          __floats2bfloat162_rn(gv[4 * j + 2 * i], gv[4 * j + 2 * i + 1]);
    }
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

// a tiled bf16 map over `rank` dims (innermost first; strides in bytes of
// dims 1..rank-1) with the 128-byte swizzle
bool encode(CUtensorMap* map, const void* base, int rank,
            const cuuint64_t* dims, const cuuint64_t* strides,
            const cuuint32_t* box) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(base), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *drow, *row_lens;
  void *out0, *out1;
  int* walked;
  int B, T, S, H, n_kv, D, q_offset;
  float scale;
};

// Q and dO: a [TB positions x G heads, 64] box per 64-column chunk over
// (d, g, kv head, t, b); K and V: a [64 keys, 64] box over (d, kv head,
// s, b)
bool encode_qkv(const Args& a, int TB, CUtensorMap* tq, CUtensorMap* tk,
                CUtensorMap* tv, CUtensorMap* tdo) {
  const int G = a.H / a.n_kv;
  const cuuint64_t e = 2;  // bytes of a bf16
  const cuuint64_t qd[5] = {(cuuint64_t)a.D, (cuuint64_t)G,
                            (cuuint64_t)a.n_kv, (cuuint64_t)a.T,
                            (cuuint64_t)a.B};
  const cuuint64_t qs[4] = {a.D * e, (cuuint64_t)G * a.D * e,
                            (cuuint64_t)a.H * a.D * e,
                            (cuuint64_t)a.T * a.H * a.D * e};
  const cuuint32_t qb[5] = {64, (cuuint32_t)G, 1, (cuuint32_t)TB, 1};
  const cuuint64_t kd[4] = {(cuuint64_t)a.D, (cuuint64_t)a.n_kv,
                            (cuuint64_t)a.S, (cuuint64_t)a.B};
  const cuuint64_t ks[3] = {a.D * e, (cuuint64_t)a.n_kv * a.D * e,
                            (cuuint64_t)a.S * a.n_kv * a.D * e};
  const cuuint32_t kb[4] = {64, 1, (cuuint32_t)kKeys, 1};
  return encode(tq, a.q, 5, qd, qs, qb) && encode(tdo, a.dout, 5, qd, qs, qb) &&
         encode(tk, a.k, 4, kd, ks, kb) && encode(tv, a.v, 4, kd, ks, kb);
}

template <int D>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  const int TB = kRows / (a.H / a.n_kv);
  CUtensorMap tq, tk, tv, tdo;
  if (!encode_qkv(a, TB, &tq, &tk, &tv, &tdo)) return cudaErrorInvalidValue;
  const size_t smem = DqSmem<D>::kBytes;
  auto kern = dq_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.B * a.n_kv, (a.T + TB - 1) / TB);
  kern<<<grid, 128, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.drow), static_cast<const int*>(a.row_lens),
      static_cast<__nv_bfloat16*>(a.out0), a.walked, a.T, a.S, a.H, a.n_kv,
      TB, a.q_offset, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& a, cudaStream_t stream) {
  const int TB = kRows / (a.H / a.n_kv);
  CUtensorMap tq, tk, tv, tdo;
  if (!encode_qkv(a, TB, &tq, &tk, &tv, &tdo)) return cudaErrorInvalidValue;
  const size_t smem = DkvSmem<D>::kBytes;
  auto kern = dkv_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.B * a.n_kv, (a.S + kBlockKeys - 1) / kBlockKeys);
  kern<<<grid, 256, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.drow), static_cast<const int*>(a.row_lens),
      static_cast<__nv_bfloat16*>(a.out0), static_cast<__nv_bfloat16*>(a.out1),
      a.walked, a.T, a.S, a.H, a.n_kv, TB, a.q_offset, a.scale);
  return cudaGetLastError();
}

int run(bool dkv, const Args& a, void* stream) {
  if (a.B <= 0 || a.T <= 0 || a.S <= 0) return cudaSuccess;
  if (a.n_kv <= 0 || a.H % a.n_kv || a.H / a.n_kv > kRows || a.q_offset < 0 ||
      (long long)a.B * a.n_kv * a.T * (a.H / a.n_kv) > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  switch (a.D) {
    case 64:
      return dkv ? launch_dkv<64>(a, st) : launch_dq<64>(a, st);
    case 128:
      return dkv ? launch_dkv<128>(a, st) : launch_dq<128>(a, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// bf16 q, dO [B, T, H, D], k, v [B, S, n_kv, D], D = 64 or 128; lse and
// drow f32 [B * n_kv, T * G]; row_lens i32 [B]; walked, if not null, an
// int the blocks add their folded key tiles to.
extern "C" int flash_bwd_dq_tc_launch(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* drow,
                                      const void* row_lens, void* dq,
                                      void* walked, int B, int T, int S,
                                      int H, int n_kv, int D, int q_offset,
                                      float scale, void* stream) {
  const Args a{q, k, v, dout, lse, drow, row_lens, dq, nullptr,
               static_cast<int*>(walked), B, T, S, H, n_kv, D, q_offset,
               scale};
  return run(false, a, stream);
}

// ... dk, dv [B, S, n_kv, D] bf16; walked counts folded query tiles.
extern "C" int flash_bwd_dkv_tc_launch(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* drow,
                                       const void* row_lens, void* dk,
                                       void* dv, void* walked, int B, int T,
                                       int S, int H, int n_kv, int D,
                                       int q_offset, float scale,
                                       void* stream) {
  const Args a{q, k, v, dout, lse, drow, row_lens, dk, dv,
               static_cast<int*>(walked), B, T, S, H, n_kv, D, q_offset,
               scale};
  return run(true, a, stream);
}

extern "C" const char* flash_backward_tc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
