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
// fence. minrank[n] = min over jobs j feasible on n of rank[j]: N x J
// compare-selects over vectors, no [N, J] array. One thread per node; a
// block stages a tile of (d, md, rank) in shared memory and every thread
// sweeps it (all lanes of a warp read one address: a broadcast). A tile
// whose ranks are all >= RANK_INF cannot lower a minimum and is skipped,
// which is exact for ranks <= RANK_INF (the solver's are class ranks or
// RANK_INF). The job axis is split over blockIdx.y so
// the grid fills the card; the splits combine with an atomic float min.
// Bound: operations (N x J compare-selects).
//
// bid. Per job j, the least packed (q << bits) | n over the nodes it may
// bid, and the least bid outside that node's group. One thread per job
// column (a warp reads 32 consecutive floats of an S row), 16 warps per
// block, each warp over a contiguous run of whole node groups. A thread
// keeps the running group minimum and a running top-2 of finished group
// minima; since non-BIG bids are unique (they embed the node), the top-2
// of group minima is exactly (prim, alt). The warps' top-2 pairs merge in
// shared memory. S[n, j] is loaded only where the pair is feasible and
// fence-allowed, so a round reads the S entries it needs and no [G, J]
// group array is written. Bound: bytes (S of the active columns).
//
// accept. One cooperative launch, two grid barriers: (1) reset the node
// accumulators; (2) per bidder, atomicAdd its demands into its node's
// totals and atomicMin its key into the node's winner key; (3) per node,
// the winner's demand is gathered through the job index in the winner
// key's low bits, then fits_all / fits_win and the consumed capacity;
// per job, the accept flag is a gather through choice of the same
// verdicts. choice outside [0, N) (the N sentinel) matches no node.
// Bound: launch and barrier latency (O(N + J) work).
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

constexpr int kFenceThreads = 128;
constexpr int kFenceTile = 1024;

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
                 int N, int J, int per_split) {
  __shared__ float sd[kFenceTile], smd[kFenceTile], sr[kFenceTile];
  const int n = blockIdx.x * kFenceThreads + threadIdx.x;
  const bool live = n < N;
  const float g = live ? __fadd_rn(gf[n], kEps) : 0.f;
  const float m = live ? __fadd_rn(mf[n], kEps) : 0.f;
  float mr = kRankInf;
  const int j_begin = blockIdx.y * per_split;
  const int j_end = min(J, j_begin + per_split);
  for (int t0 = j_begin; t0 < j_end; t0 += kFenceTile) {
    const int len = min(kFenceTile, j_end - t0);
    int active = 0;
    for (int k = threadIdx.x; k < len; k += kFenceThreads) {
      sd[k] = d[t0 + k];
      smd[k] = md[t0 + k];
      const float r = rank[t0 + k];
      sr[k] = r;
      active |= r < kRankInf;
    }
    if (__syncthreads_or(active)) {
      for (int k = 0; k < len; ++k) {
        if (sd[k] <= g && smd[k] <= m) mr = fminf(mr, sr[k]);
      }
    }
    __syncthreads();
  }
  if (live && mr < kRankInf) atomic_min_float(&out[n], mr);
}

// ---- bid -------------------------------------------------------------------

constexpr int kBidWarps = 16;

// Fold a finished group minimum into a (least, least-of-other-groups) pair.
__device__ __forceinline__ void top2_push(int& p, int& a, int gm) {
  if (gm < p) {
    a = p;
    p = gm;
  } else {
    a = min(a, gm);
  }
}

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
  int* prim;  // [J] out
  int* alt;  // [J] out
  int N, J, gs, bits;
  float q_lo, q_scale, q_max;
};

__global__ void __launch_bounds__(32 * kBidWarps) bid_kernel(BidParams P) {
  __shared__ int sp[kBidWarps][32], sa[kBidWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + lane;
  int p = kI32Max, a = kI32Max;
  if (j < P.J) {
    const float rj = P.rank[j];
    if (rj < kRankHalf) {
      const float dj = P.d[j], mdj = P.md[j];
      const int cj = P.cur[j];
      const int groups = P.N / P.gs;
      const int per_warp = (groups + kBidWarps - 1) / kBidWarps;
      const int g0 = warp * per_warp;
      const int g1 = min(groups, g0 + per_warp);
      const float* col = P.S + j;
      for (int g = g0; g < g1; ++g) {
        int gm = kI32Max;
        const int n0 = g * P.gs;
#pragma unroll 4
        for (int n = n0; n < n0 + P.gs; ++n) {
          const bool ok = dj <= __fadd_rn(__ldg(&P.gf[n]), kEps) &&
                          mdj <= __fadd_rn(__ldg(&P.mf[n]), kEps) &&
                          (rj <= __ldg(&P.minrank[n]) || cj == n);
          if (ok) {
            const float s = __ldg(col + (size_t)n * P.J);
            const float x = __fmul_rn(
                __fsub_rn(__fadd_rn(s, __ldg(&P.u[n])), P.q_lo), P.q_scale);
            const float q = fminf(fmaxf(x, 0.f), P.q_max);
            gm = min(gm, (__float2int_rz(q) << P.bits) | n);
          }
        }
        top2_push(p, a, gm);
      }
    }
  }
  sp[warp][lane] = p;
  sa[warp][lane] = a;
  __syncthreads();
  if (warp == 0 && j < P.J) {
    for (int w = 1; w < kBidWarps; ++w) {
      // the other warp's pair covers other groups: its least is a
      // candidate for either slot, its second only for the second
      const int op = sp[w][lane], oa = sa[w][lane];
      if (op < p) {
        a = min(p, oa);
        p = op;
      } else {
        a = min(a, op);
      }
    }
    P.prim[j] = p;
    P.alt[j] = a;
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
  float* tg;  // [N] scratch: bidder gpu totals
  float* tm;  // [N]
  int* win;  // [N] scratch: winner key
  int N, J, idx_mask;
};

struct Verdict {
  bool all, win;
  float wd, wmd;
};

__device__ __forceinline__ Verdict node_verdict(const AcceptParams& P, int n) {
  Verdict v;
  const int w = __ldcg(&P.win[n]);
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
  for (int n = gtid; n < P.N; n += nthreads) {
    P.tg[n] = 0.f;
    P.tm[n] = 0.f;
    P.win[n] = kI32Max;
  }
  grid.sync();
  for (int j = gtid; j < P.J; j += nthreads) {
    const int c = P.choice[j];
    if (c >= 0 && c < P.N) {
      atomicAdd(&P.tg[c], P.d[j]);
      atomicAdd(&P.tm[c], P.md[j]);
      atomicMin(&P.win[c], P.key[j]);
    }
  }
  grid.sync();
  for (int n = gtid; n < P.N; n += nthreads) {
    const Verdict v = node_verdict(P, n);
    P.used_g[n] = v.all ? __ldcg(&P.tg[n]) : (v.win ? v.wd : 0.f);
    P.used_m[n] = v.all ? __ldcg(&P.tm[n]) : (v.win ? v.wmd : 0.f);
  }
  for (int j = gtid; j < P.J; j += nthreads) {
    const int c = P.choice[j];
    bool ok = false;
    if (c >= 0 && c < P.N) {
      const Verdict v = node_verdict(P, c);
      ok = v.all || (v.win && __ldcg(&P.win[c]) == P.key[j]);
    }
    P.accept[j] = ok ? 1 : 0;
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

}  // namespace

extern "C" int fence_launch(const void* gf, const void* mf, const void* d,
                            const void* md, const void* rank, void* out,
                            int N, int J, void* stream) {
  if (N <= 0 || J <= 0) return cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorNoDevice;
  const int node_tiles = (N + kFenceThreads - 1) / kFenceThreads;
  const int job_tiles = (J + kFenceTile - 1) / kFenceTile;
  // about four blocks per SM, each over whole job tiles
  int splits = (4 * sms + node_tiles - 1) / node_tiles;
  splits = std::max(1, std::min(splits, job_tiles));
  const int per_split = ((job_tiles + splits - 1) / splits) * kFenceTile;
  splits = (J + per_split - 1) / per_split;
  fence_kernel<<<dim3(node_tiles, splits), kFenceThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gf), static_cast<const float*>(mf),
      static_cast<const float*>(d), static_cast<const float*>(md),
      static_cast<const float*>(rank), static_cast<float*>(out), N, J,
      per_split);
  return cudaGetLastError();
}

extern "C" int bid_launch(const void* S, const void* u, const void* gf,
                          const void* mf, const void* d, const void* md,
                          const void* rank, const void* minrank,
                          const void* cur, void* prim, void* alt, int N, int J,
                          int gs, int bits, float q_lo, float q_scale,
                          float q_max, void* stream) {
  if (N <= 0 || J <= 0 || gs <= 0 || N % gs != 0) return cudaErrorInvalidValue;
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
  P.prim = static_cast<int*>(prim);
  P.alt = static_cast<int*>(alt);
  P.N = N;
  P.J = J;
  P.gs = gs;
  P.bits = bits;
  P.q_lo = q_lo;
  P.q_scale = q_scale;
  P.q_max = q_max;
  bid_kernel<<<(J + 31) / 32, 32 * kBidWarps, 0,
               static_cast<cudaStream_t>(stream)>>>(P);
  return cudaGetLastError();
}

extern "C" int accept_launch(const void* choice, const void* key,
                             const void* d, const void* md, const void* gf,
                             const void* mf, void* accept, void* used_g,
                             void* used_m, void* ws_f, void* ws_i, int N,
                             int J, void* stream) {
  if (N <= 0 || J <= 0) return cudaErrorInvalidValue;
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
  P.tg = static_cast<float*>(ws_f);  // 2N floats
  P.tm = P.tg + N;
  P.win = static_cast<int*>(ws_i);  // N ints
  P.N = N;
  P.J = J;
  int bits = 1;
  while ((1 << bits) < J) ++bits;  // max((J - 1).bit_length(), 1)
  P.idx_mask = (1 << bits) - 1;

  int dev = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return cudaErrorNotSupported;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, accept_kernel,
                                                    kAcceptThreads, 0);
  if (e != cudaSuccess) return e;
  // every block of a cooperative grid must be co-resident
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int want = (std::max(N, J) + kAcceptThreads - 1) / kAcceptThreads;
  const int blocks =
      std::max(1, std::min(want, sm_count() * std::min(per_sm, 2)));
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
