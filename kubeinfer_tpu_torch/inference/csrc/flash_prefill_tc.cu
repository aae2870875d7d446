// Tensor-core prefill attention for Hopper (sm_90a): the bf16 route of
// kernels #9, #9b and #13, for head widths D % 64 == 0 up to 256.
//
// Replaces, in kubeinfer_tpu/inference/flash_attention.py, _run_flash's
// pallas_call (:288) with _flash_ragged_kernel (:206-238, the walk of
// _ragged_tile_active :241-252; #9, flash_attention_ragged) and with
// _flash_kernel (:193-203; #9b, flash_attention over a dense bool mask),
// and _diff_fwd (:1525) with _flash_ragged_lse_kernel (:1303; #13, the
// forward of flash_attention_causal_diff). All three fold key tiles with
// _softmax_fold / _fold_tile_math (:82-190): f32 scores (q . k) * scale
// plus an additive -1e30 penalty, the online softmax (running max m,
// normaliser l, accumulator o, all f32), p rounded to bf16 before P.V,
// out = o / max(l, 1e-30) in bf16, and for #13 the per-row logsumexp
// m + log(max(l, 1e-30)) in the folded [B * n_kv, T * G] layout #14
// reads. Plain PyTorch versions: kubeinfer_tpu_torch/inference/
// flash_attention.py flash_attention_ragged_plain, flash_ragged_lse_plain
// and flash_attention_plain, which this kernel matches within 2**-6 of
// each row's magnitude (bf16 x bf16 products are exact in f32 and P is
// bf16 by definition: only the order of the f32 sums differs). f32 and
// other head widths stay on the CUDA-core kernel in flash_prefill.cu.
//
// Bound on this card (H100 SXM: 989 TFLOP/s bf16 dense, 3.35 TB/s): #9
// and #13 by operations, 4 * D flops per live (query head, key) pair (a
// 2048-query causal chunk at D = 128: 34.4 GFLOP, 0.035 ms; 2048 queries
// over 4100 keys: 137.6 GFLOP, 0.139 ms); #9b on a sparse packed mask by
// bytes (q, k, v, out and the mask read once: 46.1 MB, 0.0138 ms).
//
// Design.
// - Rows: the reference's GQA fold. A block owns 64 folded query rows of
//   one (batch row b, kv head h): TB = 64 / G query positions x G heads
//   (16 x 4 on llama-3-8b), so every K/V tile is read once for all G
//   heads. Grid (B * n_kv, ceil(T / TB)), one warpgroup of 128 threads;
//   the last query blocks (the longest walks under a causal mask) run
//   first.
// - Products on tensor cores: S = Q . K^T is wgmma m64n64k16 with Q and
//   K from shared memory (K-major, 128-byte swizzle); scale, penalty and
//   the online softmax run on S in registers; P is converted to bf16 in
//   registers and is the register A operand of P . V, wgmma m64nNk16
//   (N = 128 or 64 per instruction) with V from shared memory in its
//   [keys, D] layout (MN-major, trans-b = 1). O accumulates in f32
//   registers (D / 2 a thread: 128 at D = 256 beside S's 32).
// - Copies: TMA (cp.async.bulk.tensor, mbarrier completion). Q is one
//   5-D box per 64-column chunk over (d, g, kv head, t, b) with strides
//   (1, D, G * D, H * D, T * H * D); K and V are 4-D boxes over (d, kv
//   head, s, b), so a (b, h) tile is a [64 keys, 64] box with row stride
//   n_kv * D. Key tiles go through a 2-stage ring: tile i + 1 is
//   requested before tile i's products, so its load overlaps them.
//   Rows past T and keys past S are zero-filled by TMA; keys at or past
//   S get score -inf (p exactly 0), queries past T are not stored.
// - #9 and #13 walk the tiles of the reference's _ragged_tile_active
//   rule: tile 0, every tile for a row with row_len == 0 (the uniform
//   average over all S keys), else the tiles before min(row_len, the
//   block's last query position + 1). #13 is the same kernel with a
//   non-null lse pointer, so its o is bitwise #9's.
// - #9b skips key tiles that add exactly zero. A prescan reads the
//   block's TB mask rows (16-byte loads) and marks every 64-key tile
//   holding a True for any of them, and every row holding a True at all.
//   If every row of the block has a True, the block walks only the
//   marked tiles, else every tile. Exact: in a skipped tile every key of
//   every row of the block is masked. A row that has already seen a live
//   key has a finite m, so the skipped tile's p = exp(-1e30 - m) is 0
//   and its alpha 1: it adds exactly nothing. A row that has not yet
//   seen one (m = -1e30) has folded only masked keys, and its first live
//   tile multiplies that state by alpha = exp(-1e30 - m_new) = 0 exactly.
//   A row with no True at all keeps every tile: its penalties round
//   every score to -1e30 exactly and its defined output is the uniform
//   mean of v over all S keys. The mask tile rides in the same stage by
//   TMA (a [TB, 64]-byte box) when S % 16 == 0 and the mask is 16-byte
//   aligned; otherwise each thread reads its bytes from global memory.
//   With a non-null `walked` counter each block adds the number of key
//   tiles it folds, so a caller can hold the walk against its plain
//   mirror (flash_mask_walk); a null counter costs nothing.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kBM = 64;  // folded query rows a block (one warpgroup)
constexpr int kBN = 64;  // keys a tile
constexpr int kThreads = 128;
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 64 * 64 * 2;  // a [64 rows, 64] bf16 swizzle block

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

__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
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

// shared memory of one block: Q (D / 64 swizzle blocks), two stages of
// K, V (and the mask tile), three mbarriers, and the #9b walk
template <int D, bool kMask>
struct Smem {
  static constexpr int kQ = (D / 64) * kChunk;
  static constexpr int kKV = (D / 64) * kChunk;
  static constexpr int kM = kMask ? kBN * kBM : 0;  // [TB <= 64][64] bytes
  static constexpr int kStage = 2 * kKV + kM;       // a multiple of 1024
  static constexpr int kBar = kQ + 2 * kStage;      // 3 x uint64 + n_walk
  static constexpr int kWalk = kBar + 32;           // #9b: flags and list
  static size_t bytes(int n_tiles) {
    return 1024 + kWalk + (kMask ? 3 * (size_t)n_tiles + kBM + 16 : 0);
  }
};

template <int D, bool kMask>
__global__ void __launch_bounds__(kThreads) prefill_tc_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_m, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, const int* __restrict__ row_lens,
    const uint8_t* __restrict__ mask, int* __restrict__ walked, int T, int S,
    int H, int n_kv, int TB, int q_offset, float scale, int mask_tma) {
  using L = Smem<D, kMask>;
  constexpr int NC = D / 64;  // 64-column swizzle blocks of Q, K, V
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = sm;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + L::kBar);  // Q, stage 0/1
  int* walk_n = reinterpret_cast<int*>(sm + L::kBar + 24);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x, b = bh / n_kv, h = bh % n_kv;
  const int G = H / n_kv, R = T * G;
  // the last query blocks first: under a causal or packed-document mask
  // they walk the most key tiles, so the grid's tail is the light blocks
  const int t0 = (gridDim.y - 1 - blockIdx.y) * TB;
  const int n_t = min(TB, T - t0);  // query positions of this block
  const int rows = n_t * G;         // folded rows of this block
  const int n_tiles = (S + kBN - 1) / kBN;

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  // the key tiles this block folds
  int n_walk;
  uint16_t* list = nullptr;
  if constexpr (kMask) {
    uint8_t* tflag = sm + L::kWalk;   // [n_tiles]
    uint8_t* rflag = tflag + n_tiles;  // [kBM]
    list = reinterpret_cast<uint16_t*>(
        sm + L::kWalk + ((n_tiles + kBM + 1) & ~1));  // [n_tiles]
    for (int i = tid; i < n_tiles; i += kThreads) tflag[i] = 0;
    if (tid < kBM) rflag[tid] = 0;
    __syncthreads();
    const uint8_t* mrow = mask + ((size_t)b * T + t0) * S;
    if (mask_tma) {  // S % 16 == 0, 16-byte aligned: whole 16-byte chunks
      const int chunks = S / 16;
      for (int c = tid; c < n_t * chunks; c += kThreads) {
        const int tl = c / chunks, cc = c % chunks;
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
            mrow + (size_t)tl * S + cc * 16));
        if (raw.x | raw.y | raw.z | raw.w) {
          tflag[cc * 16 / kBN] = 1;
          rflag[tl] = 1;
        }
      }
    } else {
      for (int c = tid; c < n_t * S; c += kThreads) {
        const int tl = c / S, p = c % S;
        if (mrow[(size_t)tl * S + p]) {
          tflag[p / kBN] = 1;
          rflag[tl] = 1;
        }
      }
    }
    __syncthreads();
    if (warp == 0) {
      bool all_live = true;
      for (int tl = lane; tl < n_t; tl += 32) all_live &= rflag[tl] != 0;
      all_live = __all_sync(kFull, all_live);
      int count = 0;
      for (int base = 0; base < n_tiles; base += 32) {
        const int i = base + lane;
        const bool f = i < n_tiles && (!all_live || tflag[i]);
        const unsigned bal = __ballot_sync(kFull, f);
        if (f) list[count + __popc(bal & ((1u << lane) - 1))] = (uint16_t)i;
        count += __popc(bal);
      }
      if (lane == 0) *walk_n = count;
    }
    __syncthreads();
    n_walk = *walk_n;
  } else {
    const int row_len = row_lens[b];
    const int q_max = q_offset + t0 + n_t - 1;
    const int walk =
        row_len == 0 ? S : min(S, max(1, min(q_max + 1, row_len)));
    n_walk = (walk + kBN - 1) / kBN;
    __syncthreads();  // the barriers are initialised
  }
  if (walked != nullptr && tid == 0) atomicAdd(walked, n_walk);

  auto tile_of = [&](int i) { return kMask ? (int)list[i] : i; };
  auto load_tile = [&](int i, int st) {  // thread 0: tile i into stage st
    uint8_t* ks = sm + L::kQ + st * L::kStage;
    uint8_t* vs = ks + L::kKV;
    const int s0 = tile_of(i) * kBN;
    const bool mt = kMask && mask_tma;
    mbar_expect_tx(&bar[1 + st], 2 * L::kKV + (mt ? kBN * TB : 0));
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      tma_4d(ks + c * kChunk, &tm_k, &bar[1 + st], c * 64, h, s0, b);
      tma_4d(vs + c * kChunk, &tm_v, &bar[1 + st], c * 64, h, s0, b);
    }
    if (mt) tma_3d(vs + L::kKV, &tm_m, &bar[1 + st], s0, t0, b);
  };

  if (tid == 0) {
    mbar_expect_tx(&bar[0], NC * TB * G * 128);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      tma_5d(qs + c * kChunk, &tm_q, &bar[0], c * 64, 0, h, t0, b);
    load_tile(0, 0);
  }

  // this thread's rows of the 64: lr[i] = warp * 16 + lane / 4 + 8 i
  int lr[2], tq[2];
  bool valid[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lr[i] = warp * 16 + (lane >> 2) + 8 * i;
    valid[i] = lr[i] < rows;
    tq[i] = t0 + lr[i] / G;  // query position (meaningful iff valid)
  }
  const int row_len = kMask ? 0 : row_lens[b];
  const int cq = 2 * (lane & 3);  // first of this thread's column pair

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  mbar_wait(&bar[0], 0);
  for (int it = 0; it < n_walk; ++it) {
    const int st = it & 1;
    if (it + 1 < n_walk) {
      __syncthreads();  // every warp is done with tile it - 1's stage
      if (tid == 0) {
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        load_tile(it + 1, st ^ 1);
      }
    }
    mbar_wait(&bar[1 + st], (it >> 1) & 1);
    const uint8_t* ks = sm + L::kQ + st * L::kStage;
    const uint8_t* vs = ks + L::kKV;
    const int s0 = tile_of(it) * kBN;

    // S = Q . K^T: D / 16 steps of k16, 32 bytes each inside a swizzle
    // block, the next block every 4 steps
    float acc[32];
    wg_fence();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      const int off = (kc >> 2) * kChunk + (kc & 3) * 32;
      wgmma_ss_n64(acc, sw128_desc(qs + off, 16, 1024),
                   sw128_desc(ks + off, 16, 1024), kc > 0);
    }
    wg_commit();
    wg_wait0();
    fence_regs<32>(acc);

    // scale, penalty, online softmax; acc[4j + 2i + c] is row lr[i], key
    // s0 + 8j + cq + c
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q_pos = q_offset + tq[i];
      const uint8_t* mrow = nullptr;
      if constexpr (kMask) {
        mrow = mask_tma ? vs + L::kKV + (lr[i] / G) * kBN
                        : mask + ((size_t)b * T + tq[i]) * S + s0;
      }
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * j + cq + c;
          const int p = s0 + col;
          float x = acc[4 * j + 2 * i + c];
          if (p < S) {
            bool ok;
            if constexpr (kMask) {
              ok = valid[i] && mrow[col] != 0;
            } else {
              ok = p <= q_pos && p < row_len;
            }
            x = x * scale + (ok ? 0.f : kNeg);
          } else {
            x = -INFINITY;  // no such key: p is exactly 0
          }
          acc[4 * j + 2 * i + c] = x;
          mt = fmaxf(mt, x);
        }
      }
      mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, 2));
      const float m_new = fmaxf(m[i], mt);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float pj = __expf(acc[4 * j + 2 * i + c] - m_new);
          acc[4 * j + 2 * i + c] = pj;
          rs += pj;
        }
      }
      rs += __shfl_xor_sync(kFull, rs, 1);
      rs += __shfl_xor_sync(kFull, rs, 2);
      alpha[i] = __expf(m[i] - m_new);
      l[i] = alpha[i] * l[i] + rs;
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j + 0] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }

    // P (bf16, the A fragments of four k16 steps) . V
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* a0 = acc + 8 * kk;      // keys 16kk + cq + {0, 1}
      const float* a1 = acc + 8 * kk + 4;  // keys 16kk + 8 + cq + {0, 1}
      pa[kk][0] = pack_bf16(a0[0], a0[1]);
      pa[kk][1] = pack_bf16(a0[2], a0[3]);
      pa[kk][2] = pack_bf16(a1[0], a1[1]);
      pa[kk][3] = pack_bf16(a1[2], a1[3]);
    }
    fence_regs<D / 2>(o);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // 16 keys = 16 rows of 128 bytes into each swizzle block; the next
      // 64 columns of V are the next block (LBO), 8 keys are 1024 bytes
#pragma unroll
      for (int n = 0; n < D / 128; ++n)
        wgmma_rs_n128(o + 64 * n, pa[kk],
                      sw128_desc(vs + 2 * n * kChunk + kk * 2048, kChunk,
                                 1024));
      if constexpr (D % 128 != 0)
        wgmma_rs_n64(o + 64 * (D / 128), pa[kk],
                     sw128_desc(vs + 2 * (D / 128) * kChunk + kk * 2048,
                                kChunk, 1024));
    }
    wg_commit();
    wg_wait0();
    fence_regs<D / 2>(o);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!valid[i]) continue;
    const int r = t0 * G + lr[i];
    const int g = r % G;
    __nv_bfloat16* dst = out + ((size_t)(b * T + tq[i]) * H + h * G + g) * D;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + cq) =
          __floats2bfloat162_rn(o[4 * j + 2 * i] * inv_l,
                                o[4 * j + 2 * i + 1] * inv_l);
    }
    if (lse != nullptr && (lane & 3) == 0)
      lse[(size_t)bh * R + r] = m[i] + logf(fmaxf(l[i], 1e-30f));
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

// a tiled map over `rank` dims (innermost first; strides in bytes of dims
// 1..rank-1), box `box`, bf16 with 128-byte swizzle or bytes without
bool encode(CUtensorMap* map, const void* base, int rank,
            const cuuint64_t* dims, const cuuint64_t* strides,
            const cuuint32_t* box, bool bytes) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return fn(map,
            bytes ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            rank, const_cast<void*>(base), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            bytes ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool kMask>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* row_lens, const void* mask, void* out,
                   void* lse, int* walked, int B, int T, int S, int H,
                   int n_kv, int q_offset, float scale, cudaStream_t stream) {
  const int G = H / n_kv;
  const int TB = kBM / G;  // query positions a block
  CUtensorMap tq, tk, tv, tm;
  const cuuint64_t e = 2;  // bytes of a bf16
  const cuuint64_t qd[5] = {(cuuint64_t)D, (cuuint64_t)G, (cuuint64_t)n_kv,
                            (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t qs[4] = {D * e, (cuuint64_t)G * D * e,
                            (cuuint64_t)H * D * e, (cuuint64_t)T * H * D * e};
  const cuuint32_t qb[5] = {64, (cuuint32_t)G, 1, (cuuint32_t)TB, 1};
  const cuuint64_t kd[4] = {(cuuint64_t)D, (cuuint64_t)n_kv, (cuuint64_t)S,
                            (cuuint64_t)B};
  const cuuint64_t ks[3] = {D * e, (cuuint64_t)n_kv * D * e,
                            (cuuint64_t)S * n_kv * D * e};
  const cuuint32_t kb[4] = {64, 1, (cuuint32_t)kBN, 1};
  if (!encode(&tq, q, 5, qd, qs, qb, false) ||
      !encode(&tk, k, 4, kd, ks, kb, false) ||
      !encode(&tv, v, 4, kd, ks, kb, false))
    return cudaErrorInvalidValue;
  int mask_tma = 0;
  memset(&tm, 0, sizeof(tm));
  if (kMask && S % 16 == 0 && reinterpret_cast<uintptr_t>(mask) % 16 == 0) {
    const cuuint64_t md[3] = {(cuuint64_t)S, (cuuint64_t)T, (cuuint64_t)B};
    const cuuint64_t ms[2] = {(cuuint64_t)S, (cuuint64_t)T * S};
    const cuuint32_t mb[3] = {(cuuint32_t)kBN, (cuuint32_t)TB, 1};
    if (!encode(&tm, mask, 3, md, ms, mb, true)) return cudaErrorInvalidValue;
    mask_tma = 1;
  }
  const int n_tiles = (S + kBN - 1) / kBN;
  const size_t smem = Smem<D, kMask>::bytes(n_tiles);
  auto kern = prefill_tc_kernel<D, kMask>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * n_kv, (T + TB - 1) / TB);
  kern<<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, tm, static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), static_cast<const int*>(row_lens),
      static_cast<const uint8_t*>(mask), walked, T, S, H, n_kv, TB, q_offset,
      scale, mask_tma);
  return cudaGetLastError();
}

template <bool kMask>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* row_lens, const void* mask, void* out,
                     void* lse, int* walked, int B, int T, int S, int H,
                     int n_kv, int D, int q_offset, float scale,
                     cudaStream_t stream) {
  if (B <= 0 || T <= 0) return cudaSuccess;
  if (S <= 0 || n_kv <= 0 || H % n_kv || H / n_kv > kBM || q_offset < 0 ||
      (S + kBN - 1) / kBN > 65535)
    return cudaErrorInvalidValue;
  switch (D) {
    case 64:
      return launch<64, kMask>(q, k, v, row_lens, mask, out, lse, walked, B,
                                T, S, H, n_kv, q_offset, scale, stream);
    case 128:
      return launch<128, kMask>(q, k, v, row_lens, mask, out, lse, walked, B,
                                T, S, H, n_kv, q_offset, scale, stream);
    case 192:
      return launch<192, kMask>(q, k, v, row_lens, mask, out, lse, walked, B,
                                T, S, H, n_kv, q_offset, scale, stream);
    case 256:
      return launch<256, kMask>(q, k, v, row_lens, mask, out, lse, walked, B,
                                T, S, H, n_kv, q_offset, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// #9 (lse null) and #13 (lse an f32 [B * n_kv, T * G] buffer): bf16
// q [B, T, H, D], k/v [B, S, n_kv, D], row_lens i32 [B], D % 64 == 0.
extern "C" int flash_prefill_tc_launch(const void* q, const void* k,
                                       const void* v, const void* row_lens,
                                       void* out, void* lse, int B, int T,
                                       int S, int H, int n_kv, int D,
                                       int q_offset, float scale,
                                       void* stream) {
  return dispatch<false>(q, k, v, row_lens, nullptr, out, lse, nullptr, B, T,
                         S, H, n_kv, D, q_offset, scale,
                         static_cast<cudaStream_t>(stream));
}

// #9b: mask bool [B, T, S] (one byte a pair, nonzero = attend); walked,
// if not null, an int the blocks add their folded key tiles to.
extern "C" int flash_masked_tc_launch(const void* q, const void* k,
                                      const void* v, const void* mask,
                                      void* out, void* walked, int B, int T,
                                      int S, int H, int n_kv, int D,
                                      float scale, void* stream) {
  return dispatch<true>(q, k, v, nullptr, mask, out, nullptr,
                        static_cast<int*>(walked), B, T, S, H, n_kv, D, 0,
                        scale, static_cast<cudaStream_t>(stream));
}

extern "C" const char* flash_prefill_tc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
