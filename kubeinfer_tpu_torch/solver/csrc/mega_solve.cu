// Class-serialised greedy placement loop ("mega" solve) for Hopper (sm_90a).
//
// Replaces kubeinfer_tpu/solver/pallas_kernels.py:mega_solve_pallas
// (pallas_call :909, body _mega_kernel :777, round math _mega_round_math
// :674). Plain PyTorch version: kubeinfer_tpu_torch/solver/kernels.py:
// mega_rounds, which this kernel matches bit for bit.
//
// What it computes. The job axis arrives priority-sorted and is cut into
// W-wide windows. For each window, settlement rounds run to a fixpoint:
//   1. r_lo/r_hi over the window's unplaced ranks (is a fence needed?);
//   2. when r_lo < r_hi, the per-node fence min: a row reduction over W;
//   3. the per-job packed (quantized cost << bits | node) min bid: a column
//      reduction over N;
//   4. per-node bidder totals tg/tm and winner key win;
//   5. per-job accept: fits_all[choice] or key == win[choice];
//   6. per-node consumed capacity and the capacity update;
//   7. the progress flag, cut short when the smallest unplaced demand
//      fits no node.
// The capacity vectors carry from one window to the next.
//
// Bound on this card: one read of S from HBM (N x J x 4 bytes) and of the
// job and node vectors; 0.0151 ms at 10k jobs x 1k nodes. The work of a
// round is small (N x W pairs of compare-selects, 2 M at that shape), so
// the latency of what must cross the card each round sets the pace: two
// grid barriers (about 1.1 us each on an H100) and the L2 reads after
// each (PERF.md breaks a round down).
//
// Design. ONE persistent cooperative launch runs every window and every
// round, with the NODES split over the card: block b owns the R = N / B
// contiguous nodes [b R, b R + R), one block an SM (mega_plan in
// kernels.py chooses B and R). The block keeps its nodes' state in shared
// memory for the whole launch (gf, mf, fence minimum, uq, tg, tm, win,
// used) and writes gpu_free/mem_free once, at the end. The fence is a row
// reduction, so each block computes its own nodes' minima; the accept of a
// job happens in the block that owns its chosen node. Only the column
// minimum of the bids crosses blocks.
// - The window stays on chip: on entry a block has its R rows of the
//   window, S[n, col:col+W] (contiguous 4W-byte rows of the node-major
//   field), in shared memory, copied by cp.async.bulk with an mbarrier,
//   and quantizes them once, (S - q_lo) * q_scale (the reference does the
//   same once per window, pallas_kernels.py:819). The buffer is doubled:
//   the next window's rows are copied while this window's rounds run, so
//   S is read from HBM once a solve. R x W x 4 <= 8 MiB / B bytes a block.
// - The launch packs each job's (d, md, rank, cur) into one 16-byte word;
//   a window's words and keys sit in shared memory where they fit
//   (vec_smem), else they are read through L2. A list of the window's
//   active columns (unplaced and may bid; 16-bit, two buffers) is rebuilt
//   every round in one pass, so later rounds touch only the columns still
//   unplaced.
// - A round takes two grid barriers:
//     A. every block knows the window scalars (r_lo, r_hi) from the last
//        round; it computes its rows' fence minima (when r_lo < r_hi) and
//     B. its rows' packed bids, each active column's minimum over its rows
//        (shuffles) and one atomicMin a (block, column) into prim[round
//        parity];
//     barrier 1;
//     C. each block reads prim and takes the jobs whose choice lies in its
//        range: tg, tm and win in shared memory;
//     D. accept (fits all, or the winner), asg[j] written by the owner of
//        the chosen node alone, the capacity update of its own rows, and
//        its share of the progress test (any accept, the largest gf) stored
//        in its own slot;
//     barrier 2;
//     E. every block reads asg and every slot, rebuilds the active list
//        and the window scalars, and evaluates progress from the same
//        values, so all blocks take the same branch.
//   Nothing runs on one block while the others wait. prim is reset one
//   round ahead, by a round in which nobody reads that parity; a slot is
//   rewritten every round before anyone reads it. A window's entry needs no
//   barrier (each block reads the entry state itself), the launch one (asg
//   from asg0, the packed job words, prim reset). So a launch takes 1 + 2 x
//   rounds barriers, all state set inside it (back-to-back launches and
//   CUDA graph replays need nothing between them). Where walked is not
//   null, block 0 adds the windows entered, rounds, fenced rounds and
//   barriers taken (kernels.mega_walk mirrors them). Thread-block clusters
//   that combine the column minima in distributed shared memory before the
//   atomics were measured slower (PERF.md), so the blocks are not
//   clustered.
//
// Exactness. The min-reductions (fence, packed bid, winner key) give the
// same result in any order. The float demand sums (tg, tm, used; shared-
// memory atomics) are taken in an order that changes from run to run: they
// are exact, and so bit-identical to the plain version's sums, only while
// the demands are small dyadic values (integers, halves, quarters), the
// same premise the reference's kernel/twin parity rests on. The arithmetic
// uses __fsub_rn/__fmul_rn/__fadd_rn and the library is built with
// -fmad=false, so nothing is fused that PyTorch rounds twice; the clip
// comes before the truncating __float2int_rz, as in .astype(int32).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kI32Max = 0x7FFFFFFF;
constexpr float kEps = 1e-4f;
constexpr float kRankInf = 1e9f;
constexpr float kDemandSentinel = 3.4e38f;

struct Params {
  const float* S;  // [N, J] node-major cost field
  const float* d;  // [J] gpu demand
  const float* md;  // [J] mem demand
  const int* key;  // [J] accept key
  const float* rank;  // [J] fence rank
  const int* cur;  // [J] incumbent node (-1 none)
  const int* asg0;  // [J] seeded assignment
  const unsigned char* may;  // [J] bool: job may bid
  const float* gf0;  // [N]
  const float* mf0;  // [N]
  const float* vg;  // [N]
  const float* vm;  // [N]
  int* asg;  // [J] out
  float* gf;  // [N] out
  float* mf;  // [N] out
  int* stats;  // [2] out: rounds, capped
  int* prim;  // [2][W] packed min bid, by round parity
  int2* slot;  // [B] each block's (any accept, largest gf key) of the round
  float4* jv;  // [J] (d, md, rank, cur bits), packed by the launch
  unsigned long long* walked;  // [4] or null: windows, rounds, fenced, barriers
  int N, J, W, R, max_rounds;
  float q_lo, q_scale, q_max;
  int bits;
};

// shared-memory bytes of a block; kernels.py:mega_smem_bytes mirrors it
__host__ __device__ size_t smem_bytes(int R, int W, int vec) {
  size_t b = 2ull * R * (W + 4) * 4;  // the window's rows, two buffers
  b += 16;                            // their two mbarriers
  b += (size_t)R * 16;                // node words (gf + eps, mf + eps, fence min, uq)
  if (vec) b += (size_t)W * 20;       // job words and keys
  b += (size_t)R * 40;                // ten more words a row
  b += (size_t)W * 6;                 // two active lists and the owner rows
  return b;
}

// order-preserving int image of a float, for integer atomics
__device__ __forceinline__ int fkey(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7FFFFFFF;
}
__device__ __forceinline__ float fval(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7FFFFFFF);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// A window's job words: in shared memory, or the launch's packed copy
// (written in this launch, so read from L2).
template <bool kVec>
struct Jobs {
  const float4* p;
  __device__ __forceinline__ float4 operator[](int j) const {
    if constexpr (kVec) return p[j];
    return __ldcg(&p[j]);
  }
};

// One pass of a stable compaction: dst gets, in order, the columns
// j = src[k] (k < n; with identity, j = k) where keep(j) holds. A thread
// takes ceil(n / kThreads) <= 32 consecutive k, so its keep bits fit a
// word and its loads go out together. Returns the kept count (the same in
// every thread) and, over the kept columns, min d, min rank and max rank;
// on the way it also reduces each thread's `any` (or) and `gmax` (max)
// over the block, for the progress test.
template <typename Keep, typename JobWords>
__device__ int compact(const uint16_t* src, bool identity, int n,
                       uint16_t* dst, Keep keep, const JobWords& jobs,
                       float& min_d, float& r_lo, float& r_hi, int& any,
                       float& gmax, int* shi, float* shf) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int per = (n + kThreads - 1) / kThreads;
  const int k0 = min(n, t * per), k1 = min(n, k0 + per);
  unsigned bits = 0;
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    const int j = identity ? k : src[k];
    bits |= (keep(j) ? 1u : 0u) << (k - k0);
  }
  float mn = kDemandSentinel, lo = kRankInf, hi = -kRankInf;
  for (unsigned b = bits; b; b &= b - 1) {
    const int k = k0 + __ffs(b) - 1;
    const float4 v = jobs[identity ? k : src[k]];
    mn = fminf(mn, v.x);
    lo = fminf(lo, v.z);
    hi = fmaxf(hi, v.z);
  }
  const int c = __popc(bits);
  int incl;
  if (per == 1) {  // one column a thread: the warp's prefix is a ballot
    const unsigned m = __ballot_sync(kFull, c != 0);
    incl = __popc(m & (0xffffffffu >> (31 - lane)));
  } else {
    incl = c;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
  }
  float ag = gmax;
  int aa = any;
  for (int o = 16; o > 0; o >>= 1) {
    mn = fminf(mn, __shfl_xor_sync(kFull, mn, o));
    lo = fminf(lo, __shfl_xor_sync(kFull, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, o));
    ag = fmaxf(ag, __shfl_xor_sync(kFull, ag, o));
    aa |= __shfl_xor_sync(kFull, aa, o);
  }
  if (lane == 31) shi[warp] = incl;
  if (lane == 0) {
    shf[warp] = mn;
    shf[kWarps + warp] = lo;
    shf[2 * kWarps + warp] = hi;
    shf[3 * kWarps + warp] = ag;
    shi[kWarps + warp] = aa;
  }
  __syncthreads();
  int off = incl - c, total = 0;
#pragma unroll
  for (int q = 0; q < kWarps / 4; ++q) {  // 16-byte reads of the warp words
    const int4 v = reinterpret_cast<const int4*>(shi)[q];
    const int w0 = 4 * q;
    total += v.x + v.y + v.z + v.w;
    off += (w0 < warp ? v.x : 0) + (w0 + 1 < warp ? v.y : 0) +
           (w0 + 2 < warp ? v.z : 0) + (w0 + 3 < warp ? v.w : 0);
    const int4 u = reinterpret_cast<const int4*>(shi + kWarps)[q];
    aa |= u.x | u.y | u.z | u.w;
    const float4 a = reinterpret_cast<const float4*>(shf)[q];
    const float4 b = reinterpret_cast<const float4*>(shf + kWarps)[q];
    const float4 h = reinterpret_cast<const float4*>(shf + 2 * kWarps)[q];
    const float4 x = reinterpret_cast<const float4*>(shf + 3 * kWarps)[q];
    mn = fminf(mn, fminf(fminf(a.x, a.y), fminf(a.z, a.w)));
    lo = fminf(lo, fminf(fminf(b.x, b.y), fminf(b.z, b.w)));
    hi = fmaxf(hi, fmaxf(fmaxf(h.x, h.y), fmaxf(h.z, h.w)));
    ag = fmaxf(ag, fmaxf(fmaxf(x.x, x.y), fmaxf(x.z, x.w)));
  }
  for (unsigned b = bits; b; b &= b - 1) {
    const int k = k0 + __ffs(b) - 1;
    dst[off++] = static_cast<uint16_t>(identity ? k : src[k]);
  }
  __syncthreads();  // dst is complete; shi and shf may be reused
  min_d = mn;
  r_lo = lo;
  r_hi = hi;
  any = aa;
  gmax = ag;
  return total;
}

__device__ __forceinline__ int floor_pow2(int x) {
  return x <= 1 ? 1 : 1 << (31 - __clz(x));
}

// kVec: the window's job words and keys in shared memory (vec_smem).
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1) mega_kernel(Params P) {
  extern __shared__ __align__(128) unsigned char sm[];
  __shared__ __align__(16) float shf[4 * kWarps];
  __shared__ __align__(16) int shi[2 * kWarps];

  cg::grid_group grid = cg::this_grid();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int N = P.N, J = P.J, W = P.W, R = P.R;
  const int n0 = blockIdx.x * R;
  const int stride = W + 4;
  const int nwin = J / W;
  const int node_mask = (1 << P.bits) - 1;

  // shared-memory layout (smem_bytes)
  float* Sb = reinterpret_cast<float*>(sm);  // [2][R][stride]
  unsigned char* p = sm + 2ull * R * stride * 4;
  uint64_t* bar = reinterpret_cast<uint64_t*>(p);
  p += 16;
  float4* node4 = reinterpret_cast<float4*>(p);  // gf+eps, mf+eps, minrank, uq
  p += (size_t)R * 16;
  float4* v_jv = nullptr;
  int* v_key = nullptr;
  if (kVec) {
    v_jv = reinterpret_cast<float4*>(p);
    v_key = reinterpret_cast<int*>(v_jv + W);
    p += (size_t)W * 20;
  }
  float* r_gf = reinterpret_cast<float*>(p);
  float* r_mf = r_gf + R;
  float* r_vg = r_mf + R;
  float* r_vm = r_vg + R;
  float* r_tg = r_vm + R;  // bidder totals
  float* r_tm = r_tg + R;
  float* r_ug = r_tm + R;  // accepted totals
  float* r_um = r_ug + R;
  int* r_minr = reinterpret_cast<int*>(r_um + R);  // fence min (fkey)
  int* r_win = r_minr + R;                         // winner key
  uint16_t* lists = reinterpret_cast<uint16_t*>(r_win + R);  // [2][W]
  uint16_t* mrow = lists + 2 * W;  // chosen row + 1 of active k, 0 if not ours

  auto load_window = [&](int w) {  // warp 0: window w's rows into buffer w & 1
    uint64_t* b = &bar[w & 1];
    // the buffer's last generic reads and writes before the async copy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    if (lane == 0) mbar_expect_tx(b, static_cast<uint32_t>(R) * W * 4);
    __syncwarp();
    float* dst = Sb + (size_t)(w & 1) * R * stride;
    for (int r = lane; r < R; r += 32)
      bulk_copy(dst + (size_t)r * stride,
                P.S + (size_t)(n0 + r) * J + (size_t)w * W, W * 4, b);
  };

  // a row's words for the next round: gf + eps, mf + eps, the fence
  // minimum (none yet), uq = (vg gf + vm mf) q_scale
  auto node_words = [&](int i) {
    const float gv = r_gf[i], mv = r_mf[i];
    node4[i] = make_float4(
        __fadd_rn(gv, kEps), __fadd_rn(mv, kEps), kRankInf,
        __fmul_rn(__fadd_rn(__fmul_rn(r_vg[i], gv), __fmul_rn(r_vm[i], mv)),
                  P.q_scale));
    r_minr[i] = fkey(kRankInf);
  };

  if (t == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (warp == 0) load_window(0);

  // Launch state: asg from asg0, the packed job words, prim reset.
  const int gtid = blockIdx.x * kThreads + t;
  const int gthreads = gridDim.x * kThreads;
  for (int j = gtid; j < J; j += gthreads) {
    P.asg[j] = P.asg0[j];
    P.jv[j] = make_float4(P.d[j], P.md[j], P.rank[j], __int_as_float(P.cur[j]));
  }
  for (int j = gtid; j < 2 * W; j += gthreads) P.prim[j] = kI32Max;
  for (int r = t; r < R; r += kThreads) {
    r_gf[r] = P.gf0[n0 + r];
    r_mf[r] = P.mf0[n0 + r];
    r_vg[r] = P.vg[n0 + r];
    r_vm[r] = P.vm[n0 + r];
    r_tg[r] = 0.f;
    r_tm[r] = 0.f;
    r_ug[r] = 0.f;
    r_um[r] = 0.f;
    r_win[r] = kI32Max;
    node_words(r);
  }
  // the largest gf over every node, as the progress test needs it
  float max_gf = -kDemandSentinel;
  for (int n = t; n < N; n += kThreads) max_gf = fmaxf(max_gf, P.gf0[n]);
  for (int o = 16; o > 0; o >>= 1)
    max_gf = fmaxf(max_gf, __shfl_xor_sync(kFull, max_gf, o));
  if (lane == 0) shf[warp] = max_gf;
  __syncthreads();
  for (int i = 0; i < kWarps; ++i) max_gf = fmaxf(max_gf, shf[i]);
  grid.sync();
  unsigned long long barriers = 1;

  int g = 0;  // rounds in this launch: the parity of the buffers
  int rounds = 0, capped = 0, entered = 0, fenced = 0;
  int cur_list = 0;
  for (int w = 0; w < nwin; ++w) {
    const int col = w * W;
    __syncthreads();  // the last window's readers are done
    Jobs<kVec> jobs{P.jv + col};
    const int* key = P.key + col;
    if (kVec) {
#pragma unroll 4
      for (int j = t; j < W; j += kThreads) {
        v_jv[j] = __ldcg(&P.jv[col + j]);
        v_key[j] = key[j];
      }
      __syncthreads();
      jobs.p = v_jv;
      key = v_key;
    }
    // the window's entry state, read by every block itself
    const unsigned char* may = P.may + col;
    const int* asg0 = P.asg0 + col;
    float min_d, r_lo, r_hi, unused_max = max_gf;
    int unused_any = 0;
    int nact = compact(
        nullptr, true, W, lists + cur_list * W,
        [&](int j) { return may[j] && asg0[j] < 0; }, jobs, min_d, r_lo,
        r_hi, unused_any, unused_max, shi, shf);
    bool prog = nact > 0 && min_d <= __fadd_rn(max_gf, kEps);

    // this window's rows: wait for their copy, quantize them once
    mbar_wait(&bar[w & 1], (w >> 1) & 1);
    float* Sw = Sb + (size_t)(w & 1) * R * stride;
    if (prog) {
      const int w4 = W >> 2;
      for (int i = t; i < R * w4; i += kThreads) {
        const int r = i / w4;
        float4* s = reinterpret_cast<float4*>(Sw + (size_t)r * stride) +
                    (i - r * w4);
        float4 v = *s;
        v.x = __fmul_rn(__fsub_rn(v.x, P.q_lo), P.q_scale);
        v.y = __fmul_rn(__fsub_rn(v.y, P.q_lo), P.q_scale);
        v.z = __fmul_rn(__fsub_rn(v.z, P.q_lo), P.q_scale);
        v.w = __fmul_rn(__fsub_rn(v.w, P.q_lo), P.q_scale);
        *s = v;
      }
    }
    __syncthreads();  // the other buffer's last readers are done too
    if (w + 1 < nwin && warp == 0) load_window(w + 1);
    entered += prog ? 1 : 0;

    int r = 0;
    while (prog && r < P.max_rounds) {
      const int par = g & 1;
      int* prim = P.prim + par * W;
      const uint16_t* act = lists + cur_list * W;
      const bool fence = r_lo < r_hi;
      fenced += fence ? 1 : 0;
      // Phase A: the rows' fence minima (their other words were set at the
      // end of the last round)
      if (fence) {
        // tpr lanes a row, each over a stride of the active columns
        const int tpr = floor_pow2(kThreads / R);
        const int row = t / tpr, ln = t & (tpr - 1);
        float mr = kRankInf;
        if (row < R) {
          const float4 nd = node4[row];
#pragma unroll 4
          for (int k = ln; k < nact; k += tpr) {
            const float4 v = jobs[act[k]];
            if (v.x <= nd.x && v.y <= nd.y) mr = fminf(mr, v.z);
          }
        }
        for (int o = 1; o < tpr && o < 32; o <<= 1)
          mr = fminf(mr, __shfl_xor_sync(kFull, mr, o));
        if (row < R && (ln & 31) == 0) atomicMin(&r_minr[row], fkey(mr));
        __syncthreads();
        for (int i = t; i < R; i += kThreads) node4[i].z = fval(r_minr[i]);
        __syncthreads();
      }
      // Phase B: each active column's least packed bid over the rows
      {
        const int cpt = min(min(32, floor_pow2(R)),
                            floor_pow2(kThreads / max(nact, 1)));
        const int per = kThreads / cpt;
        const int s = t & (cpt - 1);
        for (int base = 0; base < nact; base += per) {
          const int k = base + t / cpt;
          int best = kI32Max;
          if (k < nact) {
            const int j = act[k];
            const float4 v = jobs[j];
            const int cj = __float_as_int(v.w) - n0;
            const float* sc = Sw + j;
#pragma unroll 4
            for (int i = s; i < R; i += cpt) {
              const float4 nd = node4[i];
              if (v.x <= nd.x && v.y <= nd.y && (v.z <= nd.z || cj == i)) {
                const float q = fminf(
                    fmaxf(__fadd_rn(sc[(size_t)i * stride], nd.w), 0.f),
                    P.q_max);
                best = min(best, (__float2int_rz(q) << P.bits) | (n0 + i));
              }
            }
          }
          for (int o = 1; o < cpt; o <<= 1)
            best = min(best, __shfl_xor_sync(kFull, best, o));
          if (s == 0 && k < nact && best != kI32Max)
            atomicMin(&prim[act[k]], best);
        }
      }
      grid.sync();
      ++barriers;
      // Phase C: the bidders of this block's nodes
      {  // and the next round's bid buffer, which no block reads until then
        int* nxt = P.prim + (par ^ 1) * W;
        for (int j = gtid; j < W; j += gthreads) nxt[j] = kI32Max;
      }
#pragma unroll 4
      for (int k = t; k < nact; k += kThreads) {
        const int pk = __ldcg(&prim[act[k]]);
        const int c = (pk & node_mask) - n0;
        mrow[k] = pk != kI32Max && c >= 0 && c < R ? c + 1 : 0;
      }
      for (int k = t; k < nact; k += kThreads) {
        const int c = mrow[k] - 1;
        if (c < 0) continue;
        const int j = act[k];
        const float4 v = jobs[j];
        atomicAdd(&r_tg[c], v.x);
        atomicAdd(&r_tm[c], v.y);
        atomicMin(&r_win[c], key[j]);
      }
      __syncthreads();
      // Phase D: accept, consumed capacity, the block's progress share
      int any = 0;
      for (int k = t; k < nact; k += kThreads) {
        const int c = mrow[k] - 1;
        if (c < 0) continue;
        const int j = act[k];
        const float4 nd = node4[c];
        const bool fits_all = r_tg[c] <= nd.x && r_tm[c] <= nd.y;
        if (fits_all || key[j] == r_win[c]) {
          const float4 v = jobs[j];
          P.asg[col + j] = n0 + c;
          atomicAdd(&r_ug[c], v.x);
          atomicAdd(&r_um[c], v.y);
          any = 1;
        }
      }
      __syncthreads();
      float mx = -kDemandSentinel;
      for (int i = t; i < R; i += kThreads) {
        const float gv = __fsub_rn(r_gf[i], r_ug[i]);
        r_gf[i] = gv;
        r_mf[i] = __fsub_rn(r_mf[i], r_um[i]);
        mx = fmaxf(mx, gv);
        r_tg[i] = 0.f;
        r_tm[i] = 0.f;
        r_ug[i] = 0.f;
        r_um[i] = 0.f;
        r_win[i] = kI32Max;
        node_words(i);
      }
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      if (lane == 0) shf[warp] = mx;
      any = __syncthreads_or(any);
      if (t == 0) {
        for (int i = 1; i < kWarps; ++i) mx = fmaxf(mx, shf[i]);
        // a slot a block, stored: atomics of every block on one word
        // queue at its L2 slice
        P.slot[blockIdx.x] = make_int2(any, fkey(mx));
      }
      grid.sync();
      ++barriers;
      // Phase E: the round's accepts and progress, read by every block
      int any_accept = 0;
      max_gf = -kDemandSentinel;
      if (t < static_cast<int>(gridDim.x)) {  // a block's slot a thread
        const int2 v = __ldcg(&P.slot[t]);
        any_accept = v.x;
        max_gf = fval(v.y);
      }
      const int* asg = P.asg + col;
      nact = compact(
          act, false, nact, lists + (cur_list ^ 1) * W,
          [&](int j) { return __ldcg(&asg[j]) < 0; }, jobs, min_d, r_lo,
          r_hi, any_accept, max_gf, shi, shf);
      cur_list ^= 1;
      prog = any_accept && nact > 0 && min_d <= __fadd_rn(max_gf, kEps);
      ++r;
      ++g;
    }
    rounds += r;
    capped |= prog ? 1 : 0;
  }
  for (int i = t; i < R; i += kThreads) {
    P.gf[n0 + i] = r_gf[i];
    P.mf[n0 + i] = r_mf[i];
  }
  if (blockIdx.x == 0 && t == 0) {
    P.stats[0] = rounds;
    P.stats[1] = capped;
    if (P.walked != nullptr) {
      atomicAdd(&P.walked[0], (unsigned long long)entered);
      atomicAdd(&P.walked[1], (unsigned long long)rounds);
      atomicAdd(&P.walked[2], (unsigned long long)fenced);
      atomicAdd(&P.walked[3], barriers);
    }
  }
}

// `iters` grid barriers and nothing else, on the grid mega_kernel takes:
// the cost of one barrier (chip_smoke.py [4]).
__global__ void __launch_bounds__(kThreads, 1) barrier_kernel(int iters,
                                                              int* out) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < iters; ++i) grid.sync();
  if (blockIdx.x == 0 && threadIdx.x == 0) out[0] = iters;
}

// A cooperative launch of `blocks` blocks, refused where they cannot all
// be resident at once: a barrier over more blocks than fit would deadlock.
cudaError_t launch(const void* fn, void** args, int blocks, size_t smem,
                   cudaStream_t stream) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int coop = 0, sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return cudaErrorNotSupported;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                    smem);
  if (e != cudaSuccess) return e;
  if (per_sm * sms < blocks) return cudaErrorCooperativeLaunchTooLarge;
  e = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kThreads), args, smem,
                                  stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" int mega_solve_launch(
    const void* S, const void* d, const void* md, const void* key,
    const void* rank, const void* cur, const void* asg0, const void* may,
    const void* gf0, const void* mf0, const void* vg, const void* vm,
    void* asg, void* gf, void* mf, void* stats, void* ws, void* walked,
    int N, int J, int W, int max_rounds, float q_lo, float q_scale,
    float q_max, int bits, int blocks, int rows, int vec_smem,
    void* stream) {
  if (W <= 0 || J % W != 0 || N <= 0 || rows <= 0 || rows > kThreads ||
      blocks * rows != N || W > 32 * kThreads || (W & 3) != 0 ||
      (reinterpret_cast<uintptr_t>(S) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(ws) & 15) != 0)
    return cudaErrorInvalidValue;
  Params P;
  P.S = static_cast<const float*>(S);
  P.d = static_cast<const float*>(d);
  P.md = static_cast<const float*>(md);
  P.key = static_cast<const int*>(key);
  P.rank = static_cast<const float*>(rank);
  P.cur = static_cast<const int*>(cur);
  P.asg0 = static_cast<const int*>(asg0);
  P.may = static_cast<const unsigned char*>(may);
  P.gf0 = static_cast<const float*>(gf0);
  P.mf0 = static_cast<const float*>(mf0);
  P.vg = static_cast<const float*>(vg);
  P.vm = static_cast<const float*>(vm);
  P.asg = static_cast<int*>(asg);
  P.gf = static_cast<float*>(gf);
  P.mf = static_cast<float*>(mf);
  P.stats = static_cast<int*>(stats);
  // ws: 4J + 2W + 2B ints: the packed job words (16-byte aligned), prim,
  // the blocks' progress slots
  P.jv = static_cast<float4*>(ws);
  P.prim = reinterpret_cast<int*>(P.jv + J);
  P.slot = reinterpret_cast<int2*>(P.prim + 2 * W);
  P.walked = static_cast<unsigned long long*>(walked);
  P.N = N;
  P.J = J;
  P.W = W;
  P.R = rows;
  P.max_rounds = max_rounds;
  P.q_lo = q_lo;
  P.q_scale = q_scale;
  P.q_max = q_max;
  P.bits = bits;
  void* args[] = {&P};
  const void* fn = vec_smem ? reinterpret_cast<const void*>(mega_kernel<true>)
                            : reinterpret_cast<const void*>(mega_kernel<false>);
  return launch(fn, args, blocks,
                smem_bytes(rows, W, vec_smem),
                static_cast<cudaStream_t>(stream));
}

extern "C" int mega_barrier_launch(int blocks, int iters, void* out,
                                   void* stream) {
  void* args[] = {&iters, &out};
  return launch(reinterpret_cast<const void*>(barrier_kernel), args, blocks,
                0, static_cast<cudaStream_t>(stream));
}

extern "C" const char* mega_solve_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
