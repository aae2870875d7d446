// The pipelined greedy loop's round ops for Hopper (sm_90a): fence, bid and
// accept, one kernel each.
//
// Replace, in kubeinfer_tpu/solver/pallas_kernels.py:
//   fence  <- fence_minrank_pallas (_fence_kernel)
//   bid    <- bid_reduce_pallas (_bid_kernel) -> bid_select_pallas
//   accept <- accept_phase_pallas (_accept_verdict_kernel)
//             -> accept_flags_pallas (_accept_flags_kernel)
// Plain PyTorch versions: kubeinfer_tpu_torch/solver/kernels.py
// (fence_minrank, round_bids, dense_accept), which each kernel matches bit
// for bit. Each reproduces the function's output, not the TPU blocking.
//
// fence. minrank[n] = min over jobs j feasible on n of rank[j]: compare-
// selects over vectors, no [N, J] array. A block takes 512 nodes, two a
// thread, and one split of 2048 jobs (blockIdx.y; the splits combine with
// an atomic float min). It stages its jobs' (d, md, rank) in shared memory
// and, per chunk of 32 jobs, the chunk's least rank, d and md over its
// jobs below RANK_INF. A warp sweeps a chunk only where one of its nodes
// could be lowered by it: mr above the chunk's least rank and both free
// capacities at least its least demands. A job whose rank is not below mr
// cannot lower it, and one that does not fit cannot either, so the skip is
// exact for ranks in any order (and <= RANK_INF, as the solver's are). The
// job axis arrives priority-sorted, so in a round the first chunk with a
// feasible unplaced job settles a node and the rest of its sweep is
// skipped. One shared-memory read of a job serves both of a thread's
// nodes. Where walked is not null each warp adds its sweeps
// (kernels.fence_walk mirrors them). Bound: the larger of the bytes (N x 8 + J x 12 read, N x 4
// written) and the compare-selects of the sweeps taken.
//
// bid. Per job j, the least packed (q << bits) | n over the nodes it may
// bid, and the least bid outside that node's group. The reference's column
// skip (kubeinfer_tpu/solver/core.py:718-735, pallas_kernels.py
// tile_activity): a column can bid at a node only if its rank is below
// RANK_INF / 2 and at most the node's fence minimum, or the node is its
// incumbent's; a node whose minimum is not finite admits no unplaced job.
// So per (chunk of 512 nodes, tile of 128 columns) a block finds the
// chunk's largest finite minimum and walks the chunk only for the columns
// whose rank is at most it; another column reads S only at its incumbent's
// node, if that is in the chunk; a tile where no column may bid reads
// nothing. The node axis is split over blockIdx.y, so round 1's ~2500
// active columns fill the card; a block with nothing to read leaves at
// once. A lane takes four columns (coalesced rows of S), a warp 64 nodes,
// with the node vectors staged once a chunk in shared memory (one
// broadcast read serves four columns): it tests two nodes' pairs, then
// issues their S loads together, each only where its pair is allowed, so
// the bytes moved are the allowed pairs' (in 32-byte sectors). A running (least, its group, least of the other groups)
// triple is folded group segment by segment; since bids below BIG are
// unique it merges over any partition of the nodes, in any order. So the
// warps' triples merge in shared memory, and each chunk folds its pair
// into the job's (prim, alt) word, which starts at (BIG, BIG), by a
// 64-bit compare-and-swap in the same launch: a chunk whose columns have
// no bid writes nothing. Where walked is not null the kernel adds the
// pairs it tested and the chunks it walked (kernels.bid_walk mirrors
// both). Bound: bytes (the S entries of the allowed pairs).
//
// accept. One cooperative launch, ONE grid barrier: (1) per bidder,
// atomicAdd its demands into its node's totals and atomicMax its key's
// code (INT_MAX - key in order, so a zero word is "no winner") into the
// node's winner word, in the half of a two-half workspace that the
// previous call left zeroed, while every thread zeroes its share of the
// other half, which nothing in this call reads (the next call's); (2) per
// node, the winner's demand is gathered through the job index in the
// winner key's low bits, then fits_all / fits_win and the consumed
// capacity; per job, the accept flag is a gather through choice of the
// same verdicts. choice outside [0, N) (the N sentinel) matches no node.
// The workspace belongs to the solve (kernels.AcceptWorkspace, one for
// every accept call of core.run_rounds), and the wrapper flips its half
// after each launch. Bound: launch and barrier latency (O(N + J) work).
//
// Exactness. The bid arithmetic is (S + u - q_lo) * q_scale in the plain
// version's order with __fadd_rn/__fsub_rn/__fmul_rn (the library is built
// with -fmad=false), clipped before the truncating __float2int_rz. The
// accept's float sums are atomics in a changing order: exact, and so equal
// to the plain version's, for small dyadic demands only, the same premise
// as the reference's kernel/twin parity.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int kI32Max = 0x7FFFFFFF;
constexpr float kEps = 1e-4f;
constexpr float kRankInf = 1e9f;
constexpr float kRankHalf = 5e8f;  // RANK_INF * 0.5, exact in f32

// ---- fence -----------------------------------------------------------------

constexpr int kFenceThreads = 256;
constexpr int kFenceNodes = 2;  // nodes a thread: n and n + kFenceThreads
constexpr int kFenceBlockNodes = kFenceThreads * kFenceNodes;
constexpr int kFenceJobs = 2048;  // jobs a block stages: one split of J
constexpr int kFenceChunk = 32;  // jobs a warp sweeps or skips at once
constexpr int kFenceChunks = kFenceJobs / kFenceChunk;
constexpr int kFencePasses = kFenceJobs / kFenceThreads;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Atomic float min that orders negative values too (the output starts at
// RANK_INF > 0): non-negative floats order as signed ints, negative ones
// in reverse as unsigned ints.
__device__ void atomic_min_float(float* addr, float v) {
  if (v >= 0.f)
    atomicMin(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMax(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
}

__global__ void __launch_bounds__(kFenceThreads)
    fence_kernel(const float* __restrict__ gf, const float* __restrict__ mf,
                 const float* __restrict__ d, const float* __restrict__ md,
                 const float* __restrict__ rank, float* __restrict__ out,
                 unsigned long long* __restrict__ walked, int N, int J) {
  __shared__ float4 sjob[kFenceJobs];  // (d, md, rank, -)
  // per chunk of 32 jobs, over its jobs with rank < RANK_INF: (least
  // rank, least d, least md); RANK_INF, +inf, +inf when it has none
  __shared__ float4 schunk[kFenceChunks];
  const int lane = threadIdx.x & 31;
  const int j0 = blockIdx.y * kFenceJobs;
  const int len = min(kFenceJobs, J - j0);
  const int staged = (len + kFenceChunk - 1) / kFenceChunk * kFenceChunk;

  // stage the split: every load issued before the first reduction; pass
  // p of warp w holds chunk 8p + w whole, so its lanes reduce it by
  // shuffles (staged is a multiple of 32: a warp is in or out as one)
  float4 v[kFencePasses];
#pragma unroll
  for (int p = 0; p < kFencePasses; ++p) {
    const int k = p * kFenceThreads + threadIdx.x;
    v[p] = k < len ? make_float4(d[j0 + k], md[j0 + k], rank[j0 + k], 0.f)
                   : make_float4(0.f, 0.f, kRankInf, 0.f);
  }
#pragma unroll
  for (int p = 0; p < kFencePasses; ++p) {
    const int k = p * kFenceThreads + threadIdx.x;
    if (k < staged) {
      sjob[k] = v[p];
      const bool act = v[p].z < kRankInf;
      float r = act ? v[p].z : kRankInf;
      float dm = act ? v[p].x : INFINITY;
      float mm = act ? v[p].y : INFINITY;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        r = fminf(r, __shfl_xor_sync(kFull, r, o));
        dm = fminf(dm, __shfl_xor_sync(kFull, dm, o));
        mm = fminf(mm, __shfl_xor_sync(kFull, mm, o));
      }
      if (lane == 0) schunk[k / kFenceChunk] = make_float4(r, dm, mm, 0.f);
    }
  }
  __syncthreads();

  float g[kFenceNodes], m[kFenceNodes], mr[kFenceNodes];
  bool live[kFenceNodes];
#pragma unroll
  for (int i = 0; i < kFenceNodes; ++i) {
    const int n = blockIdx.x * kFenceBlockNodes + i * kFenceThreads +
                  threadIdx.x;
    live[i] = n < N;
    g[i] = live[i] ? __fadd_rn(gf[n], kEps) : 0.f;
    m[i] = live[i] ? __fadd_rn(mf[n], kEps) : 0.f;
    mr[i] = kRankInf;
  }
  unsigned sweeps = 0;
  for (int c = 0; c < staged / kFenceChunk; ++c) {
    // a job lowers mr only if its rank is below mr and it fits: a node
    // whose mr is at most the chunk's least rank, or that is below the
    // chunk's least demand in either resource, keeps its mr
    const float4 cd = schunk[c];
    bool need = false;
#pragma unroll
    for (int i = 0; i < kFenceNodes; ++i)
      need |= live[i] && !(mr[i] <= cd.x || g[i] < cd.y || m[i] < cd.z);
    if (!__any_sync(kFull, need)) continue;
    ++sweeps;
    const float4* jc = sjob + c * kFenceChunk;
#pragma unroll 8
    for (int k = 0; k < kFenceChunk; ++k) {
      const float4 jb = jc[k];  // one broadcast read for every node
#pragma unroll
      for (int i = 0; i < kFenceNodes; ++i)
        if (jb.x <= g[i] && jb.y <= m[i]) mr[i] = fminf(mr[i], jb.z);
    }
  }
#pragma unroll
  for (int i = 0; i < kFenceNodes; ++i) {
    const int n = blockIdx.x * kFenceBlockNodes + i * kFenceThreads +
                  threadIdx.x;
    if (live[i] && mr[i] < kRankInf) atomic_min_float(&out[n], mr[i]);
  }
  if (walked != nullptr && lane == 0 && sweeps > 0)
    atomicAdd(walked, static_cast<unsigned long long>(sweeps));
}

// ---- bid -------------------------------------------------------------------

constexpr int kBidWarps = 8;
constexpr int kBidThreads = 32 * kBidWarps;
constexpr int kBidLaneCols = 4;  // columns a lane: j = tile + lane + 32k
constexpr int kBidCols = 32 * kBidLaneCols;  // columns a block
constexpr int kBidChunk = 512;  // nodes a block
constexpr int kBidWarpNodes = kBidChunk / kBidWarps;
constexpr int kBidUnroll = 2;  // nodes whose S loads a lane issues at once

struct BidParams {
  const float* S;  // [N, J] node-major
  const float* u;  // [N] live best-fit pressure
  const float* gf;  // [N]
  const float* mf;  // [N]
  const float* d;  // [J]
  const float* md;  // [J]
  const float* rank;  // [J] fence rank (RANK_INF = may not bid)
  const float* minrank;  // [N]
  const int* cur;  // [J] incumbent node, -1 = none
  // [J] out: (prim, alt) in one 8-byte word a job, (BIG, BIG) on entry
  unsigned long long* out;
  unsigned long long* walked;  // [2] pairs tested, (chunk, tile) walks
  int N, J, gs, bits, mask;
  float q_lo, q_scale, q_max;
};

// (least bid, its group, least bid outside that group) of the bids seen.
// Bids below BIG are unique (they embed the node), so folding in any
// partition of the nodes gives the pair the plain version takes from whole
// group minima; a BIG bid changes nothing.
struct Top2 {
  int p, gp, a;
};

__device__ __forceinline__ void top2_push(Top2& t, int v, int g) {
  if (v < t.p) {
    if (t.gp != g) t.a = t.p;
    t.p = v;
    t.gp = g;
  } else if (g != t.gp) {
    t.a = min(t.a, v);
  }
}

// fold another partition's (least, least of the others) pair in
__device__ __forceinline__ void top2_merge(Top2& t, int p, int a,
                                           const BidParams& P) {
  top2_push(t, p, (p & P.mask) / P.gs);
  top2_push(t, a, (a & P.mask) / P.gs);
}

// the fence test of one (node, column) pair: the job fits, and its rank
// is at most the node's minimum or the node is its incumbent's; dj is NaN
// for a column the chunk does not walk, which allows nothing
__device__ __forceinline__ bool bid_allowed(float4 nd, int n, float dj,
                                            float mdj, float rj, int cj) {
  return dj <= nd.x && mdj <= nd.y && (rj <= nd.z || cj == n);
}

// the packed bid of S entry s at node n (u = nd.w)
__device__ __forceinline__ int bid_packed(float s, float un, int n,
                                          const BidParams& P) {
  const float x = __fmul_rn(__fsub_rn(__fadd_rn(s, un), P.q_lo), P.q_scale);
  const float q = fminf(fmaxf(x, 0.f), P.q_max);
  return (__float2int_rz(q) << P.bits) | n;
}

__device__ __forceinline__ unsigned long long pack_pair(int p, int a) {
  return static_cast<unsigned int>(p) |
         (static_cast<unsigned long long>(static_cast<unsigned int>(a)) << 32);
}

// fold a chunk's pair into the job's word; the fold depends only on the
// set of bids folded, so the chunks may arrive in any order
__device__ void merge_into(unsigned long long* word, int p, int a,
                           const BidParams& P) {
  unsigned long long seen = pack_pair(kI32Max, kI32Max);  // the first guess
  while (true) {
    Top2 t = {static_cast<int>(seen & 0xFFFFFFFFu), 0,
              static_cast<int>(seen >> 32)};
    t.gp = (t.p & P.mask) / P.gs;
    top2_merge(t, p, a, P);
    const unsigned long long want = pack_pair(t.p, t.a);
    if (want == seen) return;
    const unsigned long long prev = atomicCAS(word, seen, want);
    if (prev == seen) return;
    seen = prev;
  }
}

__global__ void __launch_bounds__(kBidThreads, 4) bid_kernel(BidParams P) {
  __shared__ float4 snode[kBidChunk];  // (gf + eps, mf + eps, minrank, u)
  __shared__ int sp[kBidWarps][kBidCols], sa[kBidWarps][kBidCols];
  __shared__ float shi[kBidWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tile = blockIdx.x * kBidCols;
  const int n0 = blockIdx.y * kBidChunk;
  const int n1 = min(P.N, n0 + kBidChunk);

  // the chunk's largest finite fence minimum (-1 where none is finite:
  // the reference's rule, kubeinfer_tpu/solver/core.py:726-731), its
  // loads issued with the columns'
  constexpr int kPer = kBidChunk / kBidThreads;  // minima a thread
  static_assert(kPer * kBidThreads == kBidChunk, "whole minima a thread");
  float mrv[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int n = n0 + i * kBidThreads + threadIdx.x;
    mrv[i] = n < n1 ? P.minrank[n] : -INFINITY;
  }
  // this lane's columns (every warp holds the same ones)
  float rj[kBidLaneCols], dj[kBidLaneCols], mdj[kBidLaneCols];
  int cj[kBidLaneCols];
  bool alive = false;
#pragma unroll
  for (int k = 0; k < kBidLaneCols; ++k) {
    const int j = tile + lane + 32 * k;
    const bool in = j < P.J;
    rj[k] = in ? P.rank[j] : kRankInf;
    dj[k] = in ? P.d[j] : 0.f;
    mdj[k] = in ? P.md[j] : 0.f;
    cj[k] = in ? P.cur[j] : -1;
    alive |= rj[k] < kRankHalf;
  }
  // no column of the tile may bid: its words stay (BIG, BIG); the same
  // in every warp
  if (!__any_sync(kFull, alive)) return;
  float hi = -INFINITY;
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    if (n0 + i * kBidThreads + threadIdx.x < n1)
      hi = fmaxf(hi, mrv[i] < kRankHalf ? mrv[i] : -1.f);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, o));
  if (lane == 0) shi[warp] = hi;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kBidWarps; ++w) hi = fmaxf(hi, shi[w]);

  // a column walks the chunk if its rank is at most the chunk's largest
  // finite minimum; else only its incumbent's node (when in the chunk)
  // may take its bid: one S read. A node whose minimum is not finite
  // admits no job below RANK_INF (it is the fence minimum of the same
  // inputs), so nothing else in the chunk can be allowed.
  unsigned walk = 0, home = 0;
#pragma unroll
  for (int k = 0; k < kBidLaneCols; ++k) {
    if (!(rj[k] < kRankHalf)) continue;
    if (rj[k] <= hi)
      walk |= 1u << k;
    else if (cj[k] >= n0 && cj[k] < n1)
      home |= 1u << k;
  }
  // the same in every warp: a block with nothing to read leaves, its
  // columns' words keep what the other chunks fold in
  if (!__any_sync(kFull, (walk | home) != 0)) return;
  const bool walks = __any_sync(kFull, walk != 0);
  if (walks) {
    for (int i = threadIdx.x; i < n1 - n0; i += kBidThreads) {
      const int n = n0 + i;
      snode[i] = make_float4(__fadd_rn(P.gf[n], kEps),
                             __fadd_rn(P.mf[n], kEps), P.minrank[n], P.u[n]);
    }
    __syncthreads();
  }

  Top2 t[kBidLaneCols];
  const float* col[kBidLaneCols];
#pragma unroll
  for (int k = 0; k < kBidLaneCols; ++k) {
    t[k] = {kI32Max, -1, kI32Max};
    col[k] = P.S + tile + lane + 32 * k;
    if (!((walk >> k) & 1)) dj[k] = __int_as_float(0x7fc00000);  // NaN
  }
  const int w0 = n0 + warp * kBidWarpNodes;
  const int w1 = min(n1, w0 + kBidWarpNodes);
  if (walks) {
    // the warp's run of nodes, one group segment at a time
    for (int s0 = w0; s0 < w1;) {
      const int g = s0 / P.gs;
      const int s1 = min(w1, (g + 1) * P.gs);
      int gm[kBidLaneCols];
#pragma unroll
      for (int k = 0; k < kBidLaneCols; ++k) gm[k] = kI32Max;
      int n = s0;
      for (; n + kBidUnroll <= s1; n += kBidUnroll) {
        // the tests first (node vectors from shared memory), then every S
        // load of the step, each only where its pair is allowed
        float4 nd[kBidUnroll];
        bool ok[kBidUnroll][kBidLaneCols];
        float sv[kBidUnroll][kBidLaneCols];
#pragma unroll
        for (int x = 0; x < kBidUnroll; ++x) {
          nd[x] = snode[n + x - n0];
#pragma unroll
          for (int k = 0; k < kBidLaneCols; ++k)
            ok[x][k] = bid_allowed(nd[x], n + x, dj[k], mdj[k], rj[k], cj[k]);
        }
#pragma unroll
        for (int x = 0; x < kBidUnroll; ++x)
#pragma unroll
          for (int k = 0; k < kBidLaneCols; ++k)
            sv[x][k] = ok[x][k]
                           ? __ldg(col[k] + static_cast<size_t>(n + x) * P.J)
                           : 0.f;
#pragma unroll
        for (int x = 0; x < kBidUnroll; ++x)
#pragma unroll
          for (int k = 0; k < kBidLaneCols; ++k)
            if (ok[x][k])
              gm[k] = min(gm[k], bid_packed(sv[x][k], nd[x].w, n + x, P));
      }
      for (; n < s1; ++n) {
        const float4 nd = snode[n - n0];
#pragma unroll
        for (int k = 0; k < kBidLaneCols; ++k) {
          if (bid_allowed(nd, n, dj[k], mdj[k], rj[k], cj[k])) {
            const float s = __ldg(col[k] + static_cast<size_t>(n) * P.J);
            gm[k] = min(gm[k], bid_packed(s, nd.w, n, P));
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kBidLaneCols; ++k) top2_push(t[k], gm[k], g);
      s0 = s1;
    }
  }
  // the incumbent's own node, for a column that does not walk the chunk:
  // allowed where the job fits (the fence exempts it there)
#pragma unroll
  for (int k = 0; k < kBidLaneCols; ++k) {
    const int n = cj[k];
    if (((home >> k) & 1) && n >= w0 && n < w1) {
      const int j = tile + lane + 32 * k;
      const float4 nd = make_float4(__fadd_rn(P.gf[n], kEps),
                                    __fadd_rn(P.mf[n], kEps), kRankInf,
                                    P.u[n]);
      if (bid_allowed(nd, n, P.d[j], mdj[k], rj[k], cj[k]))
        top2_push(t[k],
                  bid_packed(__ldg(&P.S[static_cast<size_t>(n) * P.J + j]),
                             nd.w, n, P),
                  n / P.gs);
    }
  }

  // the walk's own count: pairs tested (S is read at the allowed ones),
  // and whether the chunk was walked
  if (P.walked != nullptr && warp == 0) {
    int cols = 0, homes = 0;
#pragma unroll
    for (int k = 0; k < kBidLaneCols; ++k) {
      cols += __popc(__ballot_sync(kFull, (walk >> k) & 1));
      homes += __popc(__ballot_sync(kFull, (home >> k) & 1));
    }
    if (lane == 0) {
      atomicAdd(&P.walked[0], static_cast<unsigned long long>(cols) *
                                  (n1 - n0) + homes);
      if (walks) atomicAdd(&P.walked[1], 1ull);
    }
  }

  // the warps' pairs, then the chunks' pairs
#pragma unroll
  for (int k = 0; k < kBidLaneCols; ++k) {
    sp[warp][lane + 32 * k] = t[k].p;
    sa[warp][lane + 32 * k] = t[k].a;
  }
  __syncthreads();
  const int c = threadIdx.x;  // one thread a column
  const int j = tile + c;
  if (c < kBidCols && j < P.J) {
    Top2 r = {kI32Max, -1, kI32Max};
#pragma unroll
    for (int w = 0; w < kBidWarps; ++w) top2_merge(r, sp[w][c], sa[w][c], P);
    if (r.p != kI32Max) merge_into(&P.out[j], r.p, r.a, P);
  }
}

// ---- accept ----------------------------------------------------------------

constexpr int kAcceptThreads = 256;

struct AcceptParams {
  const int* choice;  // [J] node, or N = no bid
  const int* key;  // [J]
  const float* d;  // [J]
  const float* md;  // [J]
  const float* gf;  // [N]
  const float* mf;  // [N]
  unsigned char* accept;  // [J] out (bool)
  float* used_g;  // [N] out
  float* used_m;  // [N] out
  float* tg;  // [N] this call's half, zero on entry: bidder gpu totals
  float* tm;  // [N]
  unsigned* win;  // [N] winner code, win_code(key); 0 = none
  unsigned* zero;  // [3N] the other half, zeroed here for the next call
  int N, J, idx_mask;
};

// the least key has the largest code; INT_MAX ("no key") has code 0
__device__ __forceinline__ unsigned win_code(int key) {
  return static_cast<unsigned>(key) ^ 0x7FFFFFFFu;
}

__device__ __forceinline__ int win_key(unsigned code) {
  return static_cast<int>(code ^ 0x7FFFFFFFu);
}

struct Verdict {
  bool all, win;
  float wd, wmd;
};

__device__ __forceinline__ Verdict node_verdict(const AcceptParams& P, int n,
                                                int w) {
  Verdict v;
  const bool has = w != kI32Max;
  const int wj = min(w & P.idx_mask, P.J - 1);
  v.wd = has ? P.d[wj] : 0.f;
  v.wmd = has ? P.md[wj] : 0.f;
  const float g = __fadd_rn(P.gf[n], kEps);
  const float m = __fadd_rn(P.mf[n], kEps);
  v.all = __ldcg(&P.tg[n]) <= g && __ldcg(&P.tm[n]) <= m;
  v.win = has && v.wd <= g && v.wmd <= m;
  return v;
}

__global__ void __launch_bounds__(kAcceptThreads) accept_kernel(AcceptParams P) {
  cg::grid_group grid = cg::this_grid();
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthreads = gridDim.x * blockDim.x;
  for (int j = gtid; j < P.J; j += nthreads) {
    const int c = P.choice[j];
    if (c >= 0 && c < P.N) {
      atomicAdd(&P.tg[c], P.d[j]);
      atomicAdd(&P.tm[c], P.md[j]);
      atomicMax(&P.win[c], win_code(P.key[j]));
    }
  }
  for (int i = gtid; i < 3 * P.N; i += nthreads) P.zero[i] = 0u;
  grid.sync();
  for (int n = gtid; n < P.N; n += nthreads) {
    const Verdict v = node_verdict(P, n, win_key(__ldcg(&P.win[n])));
    P.used_g[n] = v.all ? __ldcg(&P.tg[n]) : (v.win ? v.wd : 0.f);
    P.used_m[n] = v.all ? __ldcg(&P.tm[n]) : (v.win ? v.wmd : 0.f);
  }
  for (int j = gtid; j < P.J; j += nthreads) {
    const int c = P.choice[j];
    bool ok = false;
    if (c >= 0 && c < P.N) {
      const int w = win_key(__ldcg(&P.win[c]));
      const Verdict v = node_verdict(P, c, w);
      ok = v.all || (v.win && w == P.key[j]);
    }
    P.accept[j] = ok ? 1 : 0;
  }
}

// Per device, once a process: the SM count and the accept kernel's
// resident blocks an SM, 0 where cooperative launches do not work (a
// benign race: every thread stores the same values).
struct AcceptDevice {
  int sms = -1, per_sm = 0;
};
AcceptDevice g_accept_devices[64];

}  // namespace

extern "C" int fence_launch(const void* gf, const void* mf, const void* d,
                            const void* md, const void* rank, void* out,
                            void* walked, int N, int J, void* stream) {
  if (N <= 0 || J <= 0) return cudaErrorInvalidValue;
  const dim3 grid((N + kFenceBlockNodes - 1) / kFenceBlockNodes,
                  (J + kFenceJobs - 1) / kFenceJobs);
  fence_kernel<<<grid, kFenceThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gf), static_cast<const float*>(mf),
      static_cast<const float*>(d), static_cast<const float*>(md),
      static_cast<const float*>(rank), static_cast<float*>(out),
      static_cast<unsigned long long*>(walked), N, J);
  return cudaGetLastError();
}

extern "C" int bid_launch(const void* S, const void* u, const void* gf,
                          const void* mf, const void* d, const void* md,
                          const void* rank, const void* minrank,
                          const void* cur, void* out, void* walked, int N,
                          int J, int gs, int bits, float q_lo, float q_scale,
                          float q_max, void* stream) {
  if (N <= 0 || J <= 0 || gs <= 0 || N % gs != 0 || bits < 1 || bits > 30)
    return cudaErrorInvalidValue;
  BidParams P;
  P.S = static_cast<const float*>(S);
  P.u = static_cast<const float*>(u);
  P.gf = static_cast<const float*>(gf);
  P.mf = static_cast<const float*>(mf);
  P.d = static_cast<const float*>(d);
  P.md = static_cast<const float*>(md);
  P.rank = static_cast<const float*>(rank);
  P.minrank = static_cast<const float*>(minrank);
  P.cur = static_cast<const int*>(cur);
  P.out = static_cast<unsigned long long*>(out);
  P.walked = static_cast<unsigned long long*>(walked);
  P.N = N;
  P.J = J;
  P.gs = gs;
  P.bits = bits;
  P.mask = (1 << bits) - 1;
  P.q_lo = q_lo;
  P.q_scale = q_scale;
  P.q_max = q_max;
  const dim3 grid((J + kBidCols - 1) / kBidCols,
                  (N + kBidChunk - 1) / kBidChunk);
  bid_kernel<<<grid, kBidThreads, 0, static_cast<cudaStream_t>(stream)>>>(P);
  return cudaGetLastError();
}

extern "C" int accept_launch(const void* choice, const void* key,
                             const void* d, const void* md, const void* gf,
                             const void* mf, void* accept, void* used_g,
                             void* used_m, void* ws, int half, int N, int J,
                             void* stream) {
  if (N <= 0 || J <= 0 || (half != 0 && half != 1))
    return cudaErrorInvalidValue;
  AcceptParams P;
  P.choice = static_cast<const int*>(choice);
  P.key = static_cast<const int*>(key);
  P.d = static_cast<const float*>(d);
  P.md = static_cast<const float*>(md);
  P.gf = static_cast<const float*>(gf);
  P.mf = static_cast<const float*>(mf);
  P.accept = static_cast<unsigned char*>(accept);
  P.used_g = static_cast<float*>(used_g);
  P.used_m = static_cast<float*>(used_m);
  // ws: two halves of (tg, tm, win), N words each
  unsigned* w = static_cast<unsigned*>(ws);
  unsigned* mine = w + 3 * N * half;
  P.tg = reinterpret_cast<float*>(mine);
  P.tm = P.tg + N;
  P.win = mine + 2 * N;
  P.zero = w + 3 * N * (half ^ 1);
  P.N = N;
  P.J = J;
  int bits = 1;
  while ((1 << bits) < J) ++bits;  // max((J - 1).bit_length(), 1)
  P.idx_mask = (1 << bits) - 1;

  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  AcceptDevice& info = g_accept_devices[dev];
  if (info.sms < 0) {
    int coop = 0, sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, accept_kernel,
                                                      kAcceptThreads, 0);
    if (e != cudaSuccess) return e;
    info.per_sm = coop ? std::min(per_sm, 2) : 0;
    info.sms = sms;
  }
  // every block of a cooperative grid must be co-resident
  if (info.per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int want = (std::max(N, J) + kAcceptThreads - 1) / kAcceptThreads;
  const int blocks = std::max(1, std::min(want, info.sms * info.per_sm));
  void* args[] = {&P};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(accept_kernel),
                                  dim3(blocks), dim3(kAcceptThreads), args, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

extern "C" const char* round_ops_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
