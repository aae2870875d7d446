// Split-K GQA decode attention for Hopper (sm_90a): kernels #10, #11 and
// #12.
//
// Replaces kubeinfer_tpu/inference/flash_attention.py:decode_attention
// (:504, _decode_attn_kernel: dense per-row caches, T == 1),
// :decode_attention_blocks (:779, _decode_blocks_kernel: a paged pool
// read through block tables, T >= 1, the speculative verify windows
// included) and :decode_attention_blocks_q8 (:1115,
// _decode_blocks_q8_kernel: the same walk over the int8 pool). Plain
// PyTorch versions:
// kubeinfer_tpu_torch/inference/flash_attention.py:decode_attention_plain,
// :decode_attention_blocks_plain and :decode_attention_blocks_q8_plain,
// which this kernel matches within a stated tolerance (the sums run in
// another order); :decode_split_combine_plain mirrors its
// split-and-combine arithmetic.
//
// What it computes. For batch row b and kv head h, the R = T*G folded
// query rows r = t*G + g (query t, head h*G + g) attend key positions p
// with s = (q . k_p) * scale + (p <= len - T + t ? 0 : -1e30),
// len = lengths[b]; an online softmax (running max m from -1e30,
// normaliser l, accumulator acc, all f32), p rounded to the value dtype
// before P.V, and out = acc / max(l, 1e-30) in q's dtype. Position p
// lives at k[b, p] (linear cache [B, S, n_kv, D]) or at
// pool[tables[b, p / bs], p % bs] (paged pool [num_blocks, bs, n_kv, D]).
// The int8 pool (#12) holds int8 pages [num_blocks, bs, n_kv, D], one f32
// scale per (block, kv head) and per-row tails [B, 2, bs, n_kv, D] in q's
// dtype. With the tail base tb = max(len - T, 0) / bs (derived on the
// device from lengths, as the reference derives it), position p of page
// ts = p / bs reads tail[b, min(ts - tb, 1), p % bs] verbatim when
// ts >= tb, else code * scale of block tables[b, ts] in f32, rounded once
// to q's dtype (the reference's _dequant_tile): the effective K/V tiles
// are bitwise the plain version's, and only the tile loader differs
// from #11's.
// A row with len >= T walks [0, min(len, S_total)): every later position
// is masked for every query and adds exactly 0. A row with len < T has
// queries with no live position, whose defined output is the uniform
// average over every position the row names, so it walks all S_total of
// them (null-padded table entries included), as the reference does.
//
// Bound on this card: bytes. The live K and V of every (row, kv head)
// are read once (2 * walk * D * sizeof(T) each; a committed int8 page one
// byte a value and its two scales); at T*G = 4-20 folded rows that is
// 4-20 FLOP a byte, far below the ridge, so the least time is the live
// K/V over 3.35 TB/s.
//
// Design.
// 1. Split the keys across blocks. The grid is (B * n_kv * row_blocks,
//    n_split): each block owns C consecutive positions of one (row, kv
//    head) and its folded query rows (a second row block only past 64
//    rows in bf16, 16 in f32). C comes from the cache geometry alone (the
//    wrapper's decode_split_size: 256 positions of the linear cache, or
//    the whole pool pages that make at least 128: one page of 128), so
//    the host never reads lengths; a block reads its row's length and
//    exits at once when its first position lies at or past the row's
//    walk. llama-3-8b's 4101-position engine row gives 17 x 8 = 136 live
//    blocks, eight pool rows of 515 give 5 x 64 = 320: at least one wave
//    of 132 SMs, resident together. (A split's fixed cost, its partial
//    and its share of the combine, weighs against the wave's balance: on
//    the H100 the engine row ran faster in splits of 256 than of 128, the
//    pool rows faster in single pages than in pairs.)
// 2. Keep bytes in flight. K and V tiles of kt keys (8 KB of K and as
//    much V a stage, or one step of the warps' walk where that is more:
//    bf16 D 128 at T = 1 takes 64 keys) are copied with 16-byte cp.async
//    into a ring of kStages = 4 stages (as many as the split has tiles,
//    where that is fewer): while tile i is scored and folded, tiles i+1
//    to i+3 are in flight, so a block asks for its whole split of 128
//    positions (64 KB of bf16 K/V at D 128) at once. The pool offset of
//    each position of the split is read from the table once, into
//    shared memory, by the block itself, in the round trip that reads the
//    row's length. Every row's split 0 is dispatched first, then split 1,
//    ...: the blocks past a short row's walk come last and exit at once.
// 3. Score without a serial D loop.
//    bf16 (kDT > 0): mma.sync m16n8k16 (bf16 in, f32 accumulate). A warp
//    holds 16 folded query rows (an m-tile; rows past R are zero) as A
//    fragments in registers and walks 16-key sub-tiles of the stage:
//    S = Q.K^T from ldmatrix'd K rows (padded by 16 bytes a row, so the
//    8 rows of a matrix hit distinct banks), the online softmax on the
//    accumulators (a row's 16 keys sit in one quad of lanes), P packed
//    to bf16 as the A operand of P.V, V by ldmatrix.trans. The warps of
//    a block split the m-tiles and, in 2 key slices (4 for the linear
//    cache's single m-tile), the sub-tiles: every K/V byte is read from
//    device memory once for all T*G rows. At T = 1 12 of the 16 rows are padding: the tensor cores
//    idle either way, and the instruction count stays small at T = 5.
//    f32 (kDT == 0): CUDA cores, to keep f32 within 1e-5 (no TF32). A key
//    is scored by a group of `lanes` lanes (D * 4 / 16 rounded up to a
//    power of two, at most 32), each holding 16 bytes (32 past D 128) of
//    K and of 4 query rows in registers; the dot products close with
//    shuffles inside the group, and each group folds 4 keys per
//    online-softmax step with its own (m, l, acc); the warps split the
//    row groups and, in 2 key slices (as bf16), the keys.
//    On the paged pool a row's arithmetic does not depend on T, G or the
//    other rows of its block (the same keys fold in the same order into
//    the same merges, and a position masked for a query adds exactly 0
//    where a position past the walk is not walked), so a verify window's
//    query t equals the T = 1 step at its length bitwise, as the
//    reference's penalty-only window rule implies for exact arithmetic.
// 4. Combine in the same launch. The warps' states merge in shared
//    memory into the block's partial (m, l, acc[rows, D]) in f32, written
//    to a workspace the wrapper allocates (torch.empty); after
//    __threadfence() each block takes an atomic ticket of its (row, kv
//    head, row block); the block that draws the last one (n_live - 1,
//    n_live derived from the row's length on the device) resets the
//    ticket to 0 for the next launch and reduces
//    out = sum_s e^{m_s - m} acc_s / max(sum_s e^{m_s - m} l_s, 1e-30),
//    m = max_s m_s, in running form over the splits in order (no pass for
//    the max first: every load of the reduction is independent of the
//    sums, so a thread keeps kUnroll splits' loads in flight). That tail
//    is a chain of round trips (fence, ticket, loads), so every block has
//    at least 4 warps to share it; the warps beyond the compute ones only
//    copy, merge and combine. One launch a call: serving decode is
//    host-paced, so a second combine launch per layer would cost host
//    time (and a cluster would cap a row at 16 splits). A row with one
//    live split writes its output directly and takes no ticket.
// 5. The defined outputs survive the split. In a row with len < T every
//    score of a query with no live position is -1e30 exactly (the
//    penalty swallows the dot product), so every split's m is -1e30 and
//    the combine weights them equally: the uniform average. Keys past a
//    split's end take no part (selection, never a -inf score, and their
//    V rows are zeroed in the ring so a 0 weight never meets a stale
//    value); every m is finite, so no exp is taken of a non-finite
//    difference; exited splits take no part in the combine.
// 6. Per-call host work: the shared-memory attribute is set once per
//    instantiation and device, not every launch.
// 7. The int8 pool (#12) keeps everything above and changes the loader.
//    The block reads, per page of its split, the table entry and (for a
//    page before the tail base) the page's K and V scales, right after
//    the row's length. A tail page's rows are copied verbatim with
//    cp.async, as #11 copies a pool page; a committed page's int8 codes
//    (half of bf16's bytes, a quarter of f32's) are copied with cp.async
//    into a staging ring beside the K/V ring, and once a tile has landed
//    the block dequantizes them, __fmul_rn(code, scale) rounded once to
//    q's dtype, into the same padded ring rows the walk reads (one more
//    barrier a tile). At decode_split_size(128, True) a split is one page,
//    so its tiles are all tail or all committed; a direct call at bs 16 or
//    64 puts several pages in a split, and the loader decides per page.
//
// walked (an int counter or null): each live block adds 1, so one launch
// adds n_kv * row_blocks * sum over rows of the live splits
// (flash_attention.decode_split_walk).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kStages = 4;         // depth of the K/V ring
constexpr int kStageBytes = 8192;  // K bytes a stage (and as many of V)
constexpr int kMaxThreads = 256;   // 8 warps at most: 4 row warps x 2
constexpr int kMaxDev = 64;
constexpr int kSmemCap = 200 * 1024;  // dynamic shared memory allowed
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
// the CUDA-core (f32) walk
constexpr int kRowsPerWarp = 4;  // query rows a warp holds in registers
constexpr int kCoreRows = 16;    // rows a block holds: 4 row warps of 4
constexpr int kSteps = 4;        // keys a lane group folds per softmax step
// the tensor-core (bf16) walk
constexpr int kTile = 16;        // rows of an m-tile, keys of a sub-tile
constexpr int kMmaRows = 64;     // rows a block holds: 4 m-tiles
constexpr int kMaxKeys = 128;    // keys a stage at most
constexpr int kSlices = 2;       // key slices of a block (see geometry)
constexpr int kMinWarps = 4;     // warps a block has at least
constexpr int kUnroll = 8;       // splits' loads in flight in the combine

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 16 bytes of T into f32
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& raw, float* dst) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) dst[i] = to_f(e[i]);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(smem_dst)),
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

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// c += a . b, m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The lane's kNch chunks of one key row in shared memory (chunk
// gl + c * lanes), zeros for chunks past the row or for a dead key.
template <typename T, int kNch>
__device__ __forceinline__ void load_row(const T* row, int gl, int lanes,
                                         int chunks, bool live,
                                         float* dst) {
  constexpr int EV = 16 / sizeof(T);
#pragma unroll
  for (int c = 0; c < kNch; ++c) {
    const int ch = gl + c * lanes;
    if (live && ch < chunks) {
      unpack16<T>(*reinterpret_cast<const uint4*>(row + ch * EV),
                  dst + c * EV);
    } else {
#pragma unroll
      for (int e = 0; e < EV; ++e) dst[c * EV + e] = 0.f;
    }
  }
}

// where key position p lives: a linear cache, a pool page, or (kQ8) an
// int8 pool page or the row's tail
enum Src { kLinear = 0, kPaged = 1, kQ8 = 2 };

// the int8 pool's pages and scales (kQ8; unused otherwise): k and v of
// the kernel are then the tails
struct Q8 {
  const int8_t* kq;  // int8 pages [num_blocks, bs, n_kv, D]
  const int8_t* vq;
  const float* ks;  // f32 scales [num_blocks, n_kv]
  const float* vs;
};

// 16 int8 codes times their scale in f32, each rounded once to T, into
// 16 values of T (16-byte aligned)
template <typename T>
__device__ __forceinline__ void dequant16(const int8_t* src, float scale,
                                          T* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
  uint4 w[sizeof(T)];  // 16 values of T
  T* e = reinterpret_cast<T*>(w);
#pragma unroll
  for (int i = 0; i < 16; ++i)
    e[i] = from_f<T>(__fmul_rn(static_cast<float>(c[i]), scale));
#pragma unroll
  for (int i = 0; i < (int)sizeof(T); ++i)
    reinterpret_cast<uint4*>(dst)[i] = w[i];
}

// launch geometry, computed on the host (geometry below)
struct Geo {
  int rows;        // R = T * G folded query rows of one kv head
  int row_blocks;  // blocks over the rows of one (row, kv head)
  int row_warps;   // warps a block gives to its rows (4 rows or 16 each)
  int kslices;     // warps a block gives to keys for each of those
  int lanes;       // f32: lanes scoring one key (a power of two)
  int chunks;      // 16-byte chunks of one key row
  int kt;          // keys a stage
  int ld;          // elements a key row takes in the ring
  int C;           // positions a split
  int pages;       // pool pages a split (C / bs; 0 for the linear cache)
  int warps;       // warps a block: row_warps * kslices, at least 4
  int stages;      // stages of the ring: kStages, or the split's tiles
};

// kDT: 0 for the CUDA-core (f32) walk; for the tensor-core (bf16) walk the
// head width rounded up to a power of two (register arrays are sized by
// it; the k-steps and n-tiles past D are skipped)
template <typename T, int kNch, int kSrc, int kDT>
__global__ void __launch_bounds__(kMaxThreads) split_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ tables,
    const int* __restrict__ lengths, T* __restrict__ out,
    float* __restrict__ ws, int* __restrict__ tickets,
    int* __restrict__ walked, int Tq, int H, int n_kv, int D, int width,
    int M, float scale, Geo geo, Q8 q8) {
  // width: S of the linear cache, or the pool's block size bs; kQ8: k
  // and v are the tails [B, 2, bs, n_kv, D]
  constexpr bool kMma = kDT > 0;
  constexpr int EV = 16 / sizeof(T);
  constexpr int kBlockRows = kMma ? kMmaRows : kCoreRows;
  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  const int rb = blockIdx.x % geo.row_blocks;
  const int bh = blockIdx.x / geo.row_blocks;
  const int b = bh / n_kv, h = bh % n_kv;
  const int G = H / n_kv;
  const int R = geo.rows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int kt = geo.kt, chunks = geo.chunks, ld = geo.ld;

  extern __shared__ __align__(16) unsigned char smem[];
  const int stages = geo.stages;
  T* k_ring = reinterpret_cast<T*>(smem);        // [stages][kt][ld]
  T* v_ring = k_ring + (size_t)stages * kt * ld;  // [stages][kt][ld]
  // kQ8: the committed pages' codes land here first, [stages][kt][D]
  int8_t* k8_ring =
      reinterpret_cast<int8_t*>(v_ring + (size_t)stages * kt * ld);
  int8_t* v8_ring = k8_ring + (size_t)stages * kt * D;
  // kPaged: the element offset of each position of the split; kQ8: of
  // each page's first row (in the tail or in the pages), with the page's
  // scales and whether it is a tail page
  size_t* rowoff = reinterpret_cast<size_t*>(
      kSrc == kQ8 ? v8_ring + (size_t)stages * kt * D
                  : reinterpret_cast<int8_t*>(k8_ring));
  float* pg_ks = reinterpret_cast<float*>(rowoff + geo.pages);
  float* pg_vs = pg_ks + geo.pages;
  int* pg_tail = reinterpret_cast<int*>(pg_vs + geo.pages);
  // the block's merge: per row its m, l and the key slices' weights
  __shared__ float s_m[kBlockRows], s_l[kBlockRows];
  __shared__ float s_w[2 * kSlices][kBlockRows];
  __shared__ int s_last;

  // the row's length and (paged) the pool offsets of the split's
  // positions, loaded in one round trip
  const int len = lengths[b];
  const int s_total = kSrc == kLinear ? width : M * width;
  const int p0 = split * geo.C;
  if constexpr (kSrc == kPaged) {
    for (int i = tid; i < min(geo.C, s_total - p0); i += nthreads) {
      const int p = p0 + i, pg = p / width;
      rowoff[i] = (((size_t)tables[(size_t)b * M + pg] * width +
                    (p - pg * width)) * n_kv + h) * D;
    }
  }
  if constexpr (kSrc == kQ8) {
    // per page: the row's tail slot min(ts - tb, 1) from the tail base
    // on, else the int8 page of the table entry and its scales
    const int tb = max(len - Tq, 0) / width;
    const int pg0 = p0 / width;
    for (int i = tid; i < min(geo.C, s_total - p0) / width; i += nthreads) {
      const int ts = pg0 + i;
      const size_t blk = tables[(size_t)b * M + ts];
      if (ts >= tb) {
        rowoff[i] = (((size_t)b * 2 + min(ts - tb, 1)) * width * n_kv + h) * D;
        pg_tail[i] = 1;
      } else {
        rowoff[i] = (blk * width * n_kv + h) * D;
        pg_ks[i] = q8.ks[blk * n_kv + h];
        pg_vs[i] = q8.vs[blk * n_kv + h];
        pg_tail[i] = 0;
      }
    }
  }
  const int walk = len < Tq ? s_total : min(len, s_total);
  if (p0 >= walk) return;  // past the row's walk: no part in anything
  const int p1 = min(p0 + geo.C, walk);
  const int n_live = (walk + geo.C - 1) / geo.C;
  if constexpr (kSrc != kLinear) __syncthreads();

  const int rw = warp % geo.row_warps;   // this warp's rows
  const int ksl = warp / geo.row_warps;  // and key slice
  // the warps past row_warps * kslices only copy, merge and combine
  const bool computes = ksl < geo.kslices;
  const int r_base = rb * kBlockRows;
  const int rows_blk = min(kBlockRows, R - r_base);
  const int rpw = kMma ? kTile : kRowsPerWarp;  // rows a warp holds
  const int rcap = geo.row_warps * rpw;
  const int row0 = r_base + rw * rpw;  // this warp's first row

  if (walked != nullptr && tid == 0) atomicAdd(walked, 1);

  const int ntiles = (p1 - p0 + kt - 1) / kt;
  // the copies: thread -> 16-byte chunk copy_ch of keys copy_j,
  // copy_j + copy_step, ...
  const int copy_step = nthreads / chunks;  // geometry: nthreads >= chunks
  const int copy_ch = tid % chunks, copy_j = tid / chunks;
  const bool copier = copy_j < copy_step;
  // one stage: keys [p0 + tile * kt, ...) of K and V in 16-byte copies; a
  // group is committed even when empty, so the wait below always names
  // the same tile
  auto issue = [&](int tile) {
    if (tile < ntiles) {
      const int stage = tile % stages;
      const int base = p0 + tile * kt;
      const int nk = min(kt, p1 - base);
      T* kd = k_ring + (size_t)stage * kt * ld + copy_ch * EV;
      T* vd = v_ring + (size_t)stage * kt * ld + copy_ch * EV;
      if constexpr (kSrc == kQ8) {
        const size_t slot = (size_t)n_kv * D;  // elements between rows
        // tail pages: the rows in T, verbatim, as a pool page of #11
        for (int j = copy_j; copier && j < nk; j += copy_step) {
          const int x = base - p0 + j, i = x / width;
          if (!pg_tail[i]) continue;
          const size_t off = rowoff[i] + (x - i * width) * slot + copy_ch * EV;
          cp_async16(kd + j * ld, k + off);
          cp_async16(vd + j * ld, v + off);
        }
        // committed pages: the int8 codes into the staging ring
        const int ch8 = D / 16;
        int8_t* kd8 = k8_ring + (size_t)stage * kt * D;
        int8_t* vd8 = v8_ring + (size_t)stage * kt * D;
        for (int c = tid; c < nk * ch8; c += nthreads) {
          const int j = c / ch8, x = base - p0 + j, i = x / width;
          if (pg_tail[i]) continue;
          const int cb = (c - j * ch8) * 16;
          const size_t off = rowoff[i] + (x - i * width) * slot + cb;
          cp_async16(kd8 + (size_t)j * D + cb, q8.kq + off);
          cp_async16(vd8 + (size_t)j * D + cb, q8.vq + off);
        }
      } else if (copier) {
        for (int j = copy_j; j < nk; j += copy_step) {
          size_t off = copy_ch * EV;
          if constexpr (kSrc == kPaged) {
            off += rowoff[base - p0 + j];
          } else {
            off += (((size_t)b * width + base + j) * n_kv + h) * D;
          }
          cp_async16(kd + j * ld, k + off);
          cp_async16(vd + j * ld, v + off);
        }
      }
      if constexpr (kMma) {
        // dead keys of the last sub-tile: V rows of zeros (P is 0 there)
        const int z1 = min(kt, (nk + kTile - 1) / kTile * kTile);
        if (copier) {
          for (int j = nk + copy_j; j < z1; j += copy_step)
            *reinterpret_cast<uint4*>(vd + j * ld) = make_uint4(0, 0, 0, 0);
        }
      }
    }
    cp_async_commit();
  };
  // kQ8, once tile `it` has landed: its committed positions' codes times
  // their page's scale, rounded once to T, into the ring rows the walk
  // reads; a barrier before the walk
  auto dequant = [&](int it) {
    if constexpr (kSrc == kQ8) {
      const int stage = it % stages, base = p0 + it * kt;
      const int nk = min(kt, p1 - base), ch8 = D / 16;
      const int8_t* ks8 = k8_ring + (size_t)stage * kt * D;
      const int8_t* vs8 = v8_ring + (size_t)stage * kt * D;
      T* kw = k_ring + (size_t)stage * kt * ld;
      T* vw = v_ring + (size_t)stage * kt * ld;
      for (int c = tid; c < nk * ch8; c += nthreads) {
        const int j = c / ch8, i = (base - p0 + j) / width;
        if (pg_tail[i]) continue;
        const int cb = (c - j * ch8) * 16;
        dequant16<T>(ks8 + (size_t)j * D + cb, pg_ks[i],
                     kw + (size_t)j * ld + cb);
        dequant16<T>(vs8 + (size_t)j * D + cb, pg_vs[i],
                     vw + (size_t)j * ld + cb);
      }
      __syncthreads();
    }
  };

  // the merge area, over the ring once the walk is done:
  // acc [kslices][rcap][D], m and l [kslices][rcap]
  float* c_acc = reinterpret_cast<float*>(smem);
  float* c_m = c_acc + (size_t)geo.kslices * rcap * D;
  float* c_l = c_m + geo.kslices * rcap;

  // the first stages' copies go out before anything else is loaded
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  if constexpr (kMma) {
    // ---- tensor cores: 16 rows a warp, 16-key sub-tiles ----------------
    constexpr int KS = kDT / 16;  // k-steps over D (past D skipped)
    constexpr int NT = kDT / 8;   // n-tiles of the output over D
    const int g4 = lane >> 2, t4 = lane & 3;
    // the A fragments of Q: rows g4 and g4 + 8, dims 2 t4 (+8) of a step
    uint32_t qa[KS][4];
    int lim[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = computes ? row0 + g4 + 8 * hh : R;
      const int t = r / G, g = r % G;
      lim[hh] = len - Tq + t;
      const uint32_t* qrow = reinterpret_cast<const uint32_t*>(
          q + ((size_t)(b * Tq + t) * H + h * G + g) * D);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        qa[kk][hh] = qa[kk][2 + hh] = 0u;  // rows past R, steps past D
        if (r < R && kk * 16 < D) {
          qa[kk][hh] = __ldg(qrow + kk * 8 + t4);
          qa[kk][2 + hh] = __ldg(qrow + kk * 8 + 4 + t4);
        }
      }
    }
    float o[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[n][c] = 0.f;
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};  // l: this lane's part
    const int mi = lane >> 3, r8 = lane & 7;  // ldmatrix: matrix, row

    for (int it = 0; it < ntiles; ++it) {
      issue(it + kStages - 1);
      cp_async_wait<kStages - 1>();
      __syncthreads();  // tile `it` is in shared memory for every thread
      dequant(it);
      const T* kb = k_ring + (size_t)(it % stages) * kt * ld;
      const T* vb = v_ring + (size_t)(it % stages) * kt * ld;
      const int base = p0 + it * kt;
      for (int j16 = ksl * kTile; computes && j16 < kt;
           j16 += geo.kslices * kTile) {
        if (base + j16 >= p1) break;
        float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        // S = Q . K^T: matrices (keys 0-7 | 8-15) x (dims lo | hi)
        const T* krow = kb + (size_t)(j16 + (mi >> 1) * 8 + r8) * ld +
                        (mi & 1) * 8;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          if (kk * 16 >= D) break;
          uint32_t bk[4];
          ldsm_x4(bk, krow + kk * 16);
          mma16816(sc[0], qa[kk], bk[0], bk[1]);
          mma16816(sc[1], qa[kk], bk[2], bk[3]);
        }
        // the online softmax: rows g4 (c 0, 1) and g4 + 8 (c 2, 3); a
        // row's 16 keys lie in the quad of lanes 4 g4 .. 4 g4 + 3
        uint32_t pa[4];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float s[2][2];
          bool live[2][2];
          float mt = m[hh];
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int p = base + j16 + n * 8 + 2 * t4 + e;
              live[n][e] = p < p1;
              s[n][e] = sc[n][2 * hh + e] * scale +
                        (p <= lim[hh] ? 0.f : kNeg);
              if (live[n][e]) mt = fmaxf(mt, s[n][e]);
            }
          mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, 1));
          mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, 2));
          const float alpha = expf(m[hh] - mt);
          float pe[2][2], sum = 0.f;
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              pe[n][e] = live[n][e] ? expf(s[n][e] - mt) : 0.f;
              sum += pe[n][e];
            }
          l[hh] = l[hh] * alpha + sum;
          m[hh] = mt;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            o[n][2 * hh] *= alpha;
            o[n][2 * hh + 1] *= alpha;
          }
          // P in bf16 (the value dtype) as the A fragment of P.V
          pa[hh] = pack_bf16(pe[0][0], pe[0][1]);
          pa[2 + hh] = pack_bf16(pe[1][0], pe[1][1]);
        }
        // O += P . V: matrices (keys 0-7 | 8-15) x (dims of tile n | n+1)
        const T* vrow = vb + (size_t)(j16 + (mi & 1) * 8 + r8) * ld +
                        (mi >> 1) * 8;
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          if (n * 8 >= D) break;
          uint32_t bv[4];
          ldsm_x4_t(bv, vrow + n * 8);
          mma16816(o[n], pa, bv[0], bv[1]);
          mma16816(o[n + 1], pa, bv[2], bv[3]);
        }
      }
      __syncthreads();  // the stage is free for the copy issued next
    }
    cp_async_wait<0>();

    // this warp's state into the merge area (the ring is free: every copy
    // has landed and every warp passed the last barrier)
    if (computes) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        l[hh] += __shfl_xor_sync(kFull, l[hh], 1);
        l[hh] += __shfl_xor_sync(kFull, l[hh], 2);
        const int rl = rw * kTile + g4 + 8 * hh;
        float* dst = c_acc + ((size_t)ksl * rcap + rl) * D;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          if (n * 8 >= D) break;
          dst[n * 8 + 2 * t4] = o[n][2 * hh];
          dst[n * 8 + 2 * t4 + 1] = o[n][2 * hh + 1];
        }
        if (t4 == 0) {
          c_m[ksl * rcap + rl] = m[hh];
          c_l[ksl * rcap + rl] = l[hh];
        }
      }
    }
  } else {
    // ---- CUDA cores: 4 rows a warp, a lane group a key -----------------
    constexpr int E = kNch * EV;  // values of a row a lane holds
    const int lanes = geo.lanes, kpw = 32 / lanes;
    const int grp = lane / lanes, gl = lane % lanes;
    float qr[kRowsPerWarp][E];
    int lim[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = computes ? row0 + i : R;
      const int t = r / G, g = r % G;
      lim[i] = len - Tq + t;
#pragma unroll
      for (int c = 0; c < kNch; ++c) {
        const int ch = gl + c * lanes;
        if (r < R && ch < chunks) {
          const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
              q + ((size_t)(b * Tq + t) * H + h * G + g) * D + ch * EV));
          unpack16<T>(raw, &qr[i][c * EV]);
        } else {
#pragma unroll
          for (int e = 0; e < EV; ++e) qr[i][c * EV + e] = 0.f;
        }
      }
    }
    float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][E];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      m[i] = kNeg;
      l[i] = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
    }

    const int unit = geo.kslices * kpw;  // keys the block scores at once
    const int rounds = kt / (unit * kSteps);
    for (int it = 0; it < ntiles; ++it) {
      issue(it + kStages - 1);
      cp_async_wait<kStages - 1>();
      __syncthreads();  // tile `it` is in shared memory for every thread
      dequant(it);
      const T* kb = k_ring + (size_t)(it % stages) * kt * ld;
      const T* vb = v_ring + (size_t)(it % stages) * kt * ld;
      const int base = p0 + it * kt;
      for (int rd = 0; computes && rd < rounds; ++rd) {
        const int j0 = rd * unit * kSteps + ksl * kpw + grp;
        float part[kRowsPerWarp][kSteps];
        bool live[kSteps];
#pragma unroll
        for (int n = 0; n < kSteps; ++n) {
          const int j = j0 + n * unit;
          live[n] = base + j < p1;
          float kv[E];
          load_row<T, kNch>(kb + (size_t)j * ld, gl, lanes, chunks, live[n],
                            kv);
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i) {
            float d = 0.f;
#pragma unroll
            for (int e = 0; e < E; ++e) d = fmaf(qr[i][e], kv[e], d);
            part[i][n] = d;
          }
        }
        // close the dot products over the lanes of each group
        for (int o = lanes >> 1; o > 0; o >>= 1) {
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
            for (int n = 0; n < kSteps; ++n)
              part[i][n] += __shfl_xor_sync(kFull, part[i][n], o);
        }
        // one online-softmax step over the group's kSteps keys
        float pr[kRowsPerWarp][kSteps];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          float s[kSteps];
          float mt = m[i];
#pragma unroll
          for (int n = 0; n < kSteps; ++n) {
            const int p = base + j0 + n * unit;
            s[n] = part[i][n] * scale + (p <= lim[i] ? 0.f : kNeg);
            if (live[n]) mt = fmaxf(mt, s[n]);
          }
          const float alpha = expf(m[i] - mt);
          float sum = 0.f;
#pragma unroll
          for (int n = 0; n < kSteps; ++n) {
            const float pe = live[n] ? expf(s[n] - mt) : 0.f;
            sum += pe;
            pr[i][n] = to_f(from_f<T>(pe));  // p in the value dtype
          }
          l[i] = l[i] * alpha + sum;
          m[i] = mt;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[i][e] *= alpha;
        }
#pragma unroll
        for (int n = 0; n < kSteps; ++n) {
          if (!live[n]) continue;
          float vv[E];
          load_row<T, kNch>(vb + (size_t)(j0 + n * unit) * ld, gl, lanes,
                            chunks, true, vv);
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
            for (int e = 0; e < E; ++e)
              acc[i][e] = fmaf(pr[i][n], vv[e], acc[i][e]);
        }
      }
      __syncthreads();  // the stage is free for the copy issued next
    }
    cp_async_wait<0>();

    // merge the lane groups of the warp (every m is finite: -1e30 at least)
    for (int o = lanes; o < 32; o <<= 1) {
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float mo = __shfl_xor_sync(kFull, m[i], o);
        const float lo = __shfl_xor_sync(kFull, l[i], o);
        const float mn = fmaxf(m[i], mo);
        const float a = expf(m[i] - mn), ao = expf(mo - mn);
        l[i] = l[i] * a + lo * ao;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float x = __shfl_xor_sync(kFull, acc[i][e], o);
          acc[i][e] = acc[i][e] * a + x * ao;
        }
        m[i] = mn;
      }
    }
    if (grp == 0 && computes) {
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int rl = rw * kRowsPerWarp + i;
        float* dst = c_acc + ((size_t)ksl * rcap + rl) * D;
#pragma unroll
        for (int c = 0; c < kNch; ++c) {
          const int ch = gl + c * lanes;
          if (ch < chunks) {
#pragma unroll
            for (int e = 0; e < EV; ++e)
              dst[ch * EV + e] = acc[i][c * EV + e];
          }
        }
        if (gl == 0) {
          c_m[ksl * rcap + rl] = m[i];
          c_l[ksl * rcap + rl] = l[i];
        }
      }
    }
  }
  __syncthreads();

  // the key slices of the block, merged: the block's partial. Per row
  // once: the slices' max, their weights and the summed l
  for (int rl = tid; rl < rows_blk; rl += nthreads) {
    float mm = c_m[rl];
    for (int s2 = 1; s2 < geo.kslices; ++s2)
      mm = fmaxf(mm, c_m[s2 * rcap + rl]);
    float L = 0.f;
    for (int s2 = 0; s2 < geo.kslices; ++s2) {
      const float w = expf(c_m[s2 * rcap + rl] - mm);
      s_w[s2][rl] = w;
      L += w * c_l[s2 * rcap + rl];
    }
    s_m[rl] = mm;
    s_l[rl] = L;
  }
  __syncthreads();
  const size_t ws_rows = (size_t)(gridDim.x / geo.row_blocks) * n_split * R;
  float* ws_acc = ws;               // [B * n_kv][n_split][R][D]
  float* ws_ml = ws + ws_rows * D;  // [B * n_kv][n_split][R][2]
  const int D4 = D / 4;             // 4 values of a row a thread
  for (int idx = tid; idx < rows_blk * D4; idx += nthreads) {
    const int rl = idx / D4, d = (idx - rl * D4) * 4;
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s2 = 0; s2 < geo.kslices; ++s2) {
      const float w = s_w[s2][rl];
      const float4 a = *reinterpret_cast<const float4*>(
          c_acc + ((size_t)s2 * rcap + rl) * D + d);
      A.x += w * a.x;
      A.y += w * a.y;
      A.z += w * a.z;
      A.w += w * a.w;
    }
    const int r = r_base + rl;
    if (n_live == 1) {
      const int t = r / G, g = r % G;
      T* o4 = out + ((size_t)(b * Tq + t) * H + h * G + g) * D + d;
      const float L = fmaxf(s_l[rl], 1e-30f);
      o4[0] = from_f<T>(A.x / L);
      o4[1] = from_f<T>(A.y / L);
      o4[2] = from_f<T>(A.z / L);
      o4[3] = from_f<T>(A.w / L);
    } else {
      const size_t row = ((size_t)bh * n_split + split) * R + r;
      *reinterpret_cast<float4*>(ws_acc + row * D + d) = A;
      if (d == 0) {
        ws_ml[row * 2] = s_m[rl];
        ws_ml[row * 2 + 1] = s_l[rl];
      }
    }
  }
  if (n_live == 1) return;

  // the last of the row's live splits to finish combines them
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int prev = atomicAdd(&tickets[blockIdx.x], 1);
    s_last = prev == n_live - 1;
    if (s_last) atomicExch(&tickets[blockIdx.x], 0);  // for the next launch
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // the running form of sum_s e^{m_s - m} acc_s / max(sum_s e^{m_s - m}
  // l_s, 1e-30), the splits in order: every load independent of the
  // sums, kUnroll splits' loads in flight a thread
  const size_t first = (size_t)bh * n_split;  // split 0 of this (row, head)
  for (int idx = tid; idx < rows_blk * D4; idx += nthreads) {
    const int rl = idx / D4, d = (idx - rl * D4) * 4;
    const int r = r_base + rl;
    float mm = kNeg, L = 0.f;
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll kUnroll
    for (int s2 = 0; s2 < n_live; ++s2) {
      const size_t row = (first + s2) * R + r;
      const float ms = __ldcg(ws_ml + row * 2);
      const float ls = __ldcg(ws_ml + row * 2 + 1);
      const float4 a =
          __ldcg(reinterpret_cast<const float4*>(ws_acc + row * D + d));
      const float mn = fmaxf(mm, ms);
      const float ea = expf(mm - mn), eb = expf(ms - mn);
      L = L * ea + ls * eb;
      A.x = A.x * ea + a.x * eb;
      A.y = A.y * ea + a.y * eb;
      A.z = A.z * ea + a.z * eb;
      A.w = A.w * ea + a.w * eb;
      mm = mn;
    }
    const int t = r / G, g = r % G;
    T* o4 = out + ((size_t)(b * Tq + t) * H + h * G + g) * D + d;
    L = fmaxf(L, 1e-30f);
    o4[0] = from_f<T>(A.x / L);
    o4[1] = from_f<T>(A.y / L);
    o4[2] = from_f<T>(A.z / L);
    o4[3] = from_f<T>(A.w / L);
  }
}

// the bytes of the ring, and beside it the paged pool's offsets or the
// int8 pool's staging ring and page records
template <typename T, int kSrc>
size_t ring_bytes(const Geo& g) {
  size_t bytes = (size_t)2 * g.stages * g.kt * g.ld * sizeof(T);
  if (kSrc == kPaged) bytes += sizeof(size_t) * g.C;
  if (kSrc == kQ8) {
    const size_t d = (size_t)g.chunks * 16 / sizeof(T);  // D
    bytes += 2 * g.stages * g.kt * d +
             (sizeof(size_t) + 2 * sizeof(float) + sizeof(int)) * g.pages;
  }
  return bytes;
}

template <typename T, int kNch, int kSrc, int kDT>
Geo geometry(int R, int D, int C, int pages) {
  constexpr bool kMma = kDT > 0;
  Geo g;
  g.rows = R;
  g.C = C;
  g.pages = pages;
  g.chunks = D * (int)sizeof(T) / 16;
  const int block_rows = kMma ? kMmaRows : kCoreRows;
  g.row_blocks = (R + block_rows - 1) / block_rows;
  const int rblk = R < block_rows ? R : block_rows;
  g.row_warps = kMma ? (rblk + kTile - 1) / kTile
                     : (rblk + kRowsPerWarp - 1) / kRowsPerWarp;
  if (kMma) {
    g.lanes = 32;
    g.ld = D + 8;  // 16 bytes of padding: ldmatrix rows on distinct banks
  } else {
    const int need = (g.chunks + kNch - 1) / kNch;
    g.lanes = 1;
    while (g.lanes < need) g.lanes <<= 1;
    g.ld = D;
  }
  // the paged pool: kSlices key slices whatever the rows, so a row's
  // arithmetic (which keys each warp folds, in which order they merge) is
  // the same for every T and a verify window's rows equal the T = 1
  // steps bitwise. The linear cache serves T = 1 alone: a single row
  // group takes twice the key slices there, where their ring fits
  const bool wide = kSrc == kLinear && g.row_warps == 1;
  for (int slices = wide ? 2 * kSlices : kSlices;; slices = kSlices) {
    g.kslices = slices;
    // keys the block's warps walk at once
    const int step = kMma ? slices * kTile
                          : slices * (32 / g.lanes) * kSteps;
    int fit = kStageBytes / (D * (int)sizeof(T));
    if (kMma && fit > kMaxKeys) fit = kMaxKeys;
    fit = fit / step * step;
    g.kt = fit > step ? fit : step;
    // a split of fewer tiles than kStages takes no more stages: all its
    // tiles are in flight at once and no stage is reused
    const int tiles = (C + g.kt - 1) / g.kt;
    g.stages = tiles < kStages ? tiles : kStages;
    if (slices == kSlices || ring_bytes<T, kSrc>(g) <= (size_t)kSmemCap)
      break;
  }
  g.warps = g.row_warps * g.kslices;
  if (g.warps < kMinWarps) g.warps = kMinWarps;
  return g;
}

template <typename T, int kNch, int kSrc, int kDT>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* tables, const void* lengths, void* out,
                   void* ws, void* tickets, void* walked, int B, int Tq,
                   int H, int n_kv, int D, int width, int M, int C,
                   float scale, Q8 q8, cudaStream_t stream) {
  const Geo g = geometry<T, kNch, kSrc, kDT>(Tq * (H / n_kv), D, C,
                                             kSrc == kLinear ? 0 : C / width);
  const int s_total = kSrc == kLinear ? width : M * width;
  const int n_split = (s_total + C - 1) / C;
  const long long rows_x = (long long)B * n_kv * g.row_blocks;
  if (rows_x > 0x7fffffff || n_split > 65535) return cudaErrorInvalidValue;
  const size_t ring = ring_bytes<T, kSrc>(g);
  const int rpw = kDT > 0 ? kTile : kRowsPerWarp;
  const size_t merge =
      sizeof(float) * (size_t)g.kslices * g.row_warps * rpw * (D + 2);
  const size_t smem = ring > merge ? ring : merge;
  if (smem > (size_t)kSmemCap) return cudaErrorInvalidValue;
  auto kern = split_kernel<T, kNch, kSrc, kDT>;
  // once per instantiation and device: as much as any launch asks for
  static bool raised[kMaxDev] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDev) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemCap);
    if (err != cudaSuccess) return err;
    raised[dev] = true;
  }
  // every row's split 0 first, then split 1, ...: the live blocks (the
  // first splits of each row) are dispatched before the ones that exit
  const dim3 grid((unsigned)rows_x, n_split);
  kern<<<grid, 32 * g.warps, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<T*>(out),
      static_cast<float*>(ws), static_cast<int*>(tickets),
      static_cast<int*>(walked), Tq, H, n_kv, D, width, M, scale, g, q8);
  return cudaGetLastError();
}

template <int kSrc>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* tables, const void* lengths, void* out,
                     void* ws, void* tickets, void* walked, int B, int Tq,
                     int H, int n_kv, int D, int width, int M, int C,
                     float scale, int dtype, Q8 q8, cudaStream_t st) {
  if (B <= 0) return cudaSuccess;
  if (Tq <= 0 || n_kv <= 0 || H % n_kv || D <= 0 || D % 16 || D > 256 ||
      width <= 0 || C <= 0 || (kSrc != kLinear && (M <= 0 || C % width)))
    return cudaErrorInvalidValue;
#define SPLIT_ARGS                                                        \
  q, k, v, tables, lengths, out, ws, tickets, walked, B, Tq, H, n_kv, D, \
      width, M, C, scale, q8, st
  using bf16 = __nv_bfloat16;
  if (dtype == 1) {  // tensor cores, registers sized by D's power of two
    if (D <= 16) return launch<bf16, 1, kSrc, 16>(SPLIT_ARGS);
    if (D <= 32) return launch<bf16, 1, kSrc, 32>(SPLIT_ARGS);
    if (D <= 64) return launch<bf16, 1, kSrc, 64>(SPLIT_ARGS);
    if (D <= 128) return launch<bf16, 1, kSrc, 128>(SPLIT_ARGS);
    return launch<bf16, 1, kSrc, 256>(SPLIT_ARGS);
  }
  if (dtype != 0) return cudaErrorInvalidValue;
  // f32 past D 128: two 16-byte chunks a lane, so a key fits 32 lanes
  if (D > 128) return launch<float, 2, kSrc, 0>(SPLIT_ARGS);
  return launch<float, 1, kSrc, 0>(SPLIT_ARGS);
#undef SPLIT_ARGS
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. ws: f32, B * n_kv * n_split * R *
// (D + 2) floats (n_split = ceil(S / C), R = H / n_kv); tickets: int32,
// B * n_kv * row_blocks of them, row_blocks = ceil(R / 64) in bf16 and
// ceil(R / 16) in f32 (flash_attention.decode_row_blocks), zero before
// the first launch (the kernel leaves them zero).
extern "C" int decode_split_launch(const void* q, const void* k,
                                   const void* v, const void* lengths,
                                   void* out, void* ws, void* tickets,
                                   void* walked, int B, int H, int n_kv,
                                   int D, int S, int C, float scale,
                                   int dtype, void* stream) {
  return dispatch<kLinear>(q, k, v, nullptr, lengths, out, ws, tickets,
                           walked, B, 1, H, n_kv, D, S, 0, C, scale, dtype,
                           Q8{}, static_cast<cudaStream_t>(stream));
}

// the paged pool [num_blocks, bs, n_kv, D] through tables i32[B, M]; C a
// multiple of bs, n_split = ceil(M * bs / C), R = T * H / n_kv
extern "C" int decode_split_blocks_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* tables, const void* lengths, void* out, void* ws,
    void* tickets, void* walked, int B, int T, int H, int n_kv, int D,
    int bs, int M, int C, float scale, int dtype, void* stream) {
  return dispatch<kPaged>(q, k_pool, v_pool, tables, lengths, out, ws,
                          tickets, walked, B, T, H, n_kv, D, bs, M, C, scale,
                          dtype, Q8{}, static_cast<cudaStream_t>(stream));
}

// the int8 pool: int8 pages [num_blocks, bs, n_kv, D] with f32 scales
// [num_blocks, n_kv] and tails [B, 2, bs, n_kv, D] in q's dtype, through
// tables i32[B, M]; C, ws and tickets as for the paged pool
extern "C" int decode_split_blocks_q8_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scales, const void* v_scales, const void* k_tail,
    const void* v_tail, const void* tables, const void* lengths, void* out,
    void* ws, void* tickets, void* walked, int B, int T, int H, int n_kv,
    int D, int bs, int M, int C, float scale, int dtype, void* stream) {
  const Q8 q8{static_cast<const int8_t*>(k_pool),
              static_cast<const int8_t*>(v_pool),
              static_cast<const float*>(k_scales),
              static_cast<const float*>(v_scales)};
  return dispatch<kQ8>(q, k_tail, v_tail, tables, lengths, out, ws, tickets,
                       walked, B, T, H, n_kv, D, bs, M, C, scale, dtype, q8,
                       static_cast<cudaStream_t>(stream));
}

extern "C" const char* decode_split_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
