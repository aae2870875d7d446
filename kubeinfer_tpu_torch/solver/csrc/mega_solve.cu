// Class-serialised greedy placement loop ("mega" solve) for Hopper (sm_90a).
//
// Replaces kubeinfer_tpu/solver/pallas_kernels.py:mega_solve_pallas
// (_mega_kernel + _mega_round_math). Plain PyTorch version:
// kubeinfer_tpu_torch/solver/kernels.py:mega_rounds, which this kernel
// matches bit for bit.
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
// Design. ONE persistent cooperative launch runs every window and every
// round; grid-wide barriers (cooperative_groups grid sync) separate the
// phases, and the grid is never larger than what is co-resident (checked
// with the occupancy API before launch; a barrier over more blocks would
// deadlock). The TPU kernel kept an [N, W] window in VMEM; here a window
// of the node-major cost field S ([1024, 2048] f32 = 8 MiB at the headline
// shape) stays resident in the 50 MB L2 across its rounds, and the
// quantized cost (S - q_lo) * q_scale is recomputed on the fly instead of
// materialised. The bid phase gives each thread one job column and a
// slice of the nodes, so a warp reads 32 consecutive floats of one S row
// (coalesced), and combines slices with atomicMin on the packed i32 bid.
// Phases 4 and 6 are O(W) atomics into per-node accumulators, not [N, W]
// sweeps; the small O(N + W) reductions of phases 1 and 7 run in block 0.
//
// Exactness. The float demand sums (phases 4 and 6) are taken with
// atomics in an order that changes from run to run. They are exact, and so
// bit-identical to the plain version's sums, only while the demands are
// small dyadic values (integers, halves, quarters): the same premise the
// reference's kernel/twin parity rests on. The bid arithmetic uses
// __fsub_rn/__fmul_rn/__fadd_rn (and the library is built with
// -fmad=false) so nothing is fused that PyTorch rounds twice; the clip
// comes before the truncating __float2int_rz, as in .astype(int32).
//
// Bound on this card: the rounds read their window of S from L2, so the
// least time is one read of S from HBM plus rounds x (N x W x 4 bytes) at
// the 3.35 TB/s HBM rate (an upper bound on the bytes the bid phase needs);
// in practice the ~5 grid barriers per round set the pace.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kI32Max = 0x7FFFFFFF;
constexpr float kEps = 1e-4f;
constexpr float kRankInf = 1e9f;
constexpr float kDemandSentinel = 3.4e38f;

// flags: [0] fence needed, [1] any accept this round,
//        [4 + (epoch & 1)] progress (double-buffered: block 0 writes the
//        next value while other blocks may still be reading the last one)
constexpr int kFlagFence = 0;
constexpr int kFlagAccept = 1;
constexpr int kFlagProgress = 4;

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
  float* gf;  // [N] out, live capacity
  float* mf;  // [N] out
  int* stats;  // [2] out: rounds, capped
  float4* node4;  // [N] per round: {gf + eps, mf + eps, minrank, uq}
  float* tg;  // [N] bidder gpu totals
  float* tm;  // [N] bidder mem totals
  float* used_g;  // [N] accepted gpu totals
  float* used_m;  // [N]
  int* win;  // [N] winner key
  int* prim;  // [W] packed min bid
  int* choice;  // [W] chosen node (N = none)
  int* flags;  // [16]
  int N, J, W, max_rounds;
  float q_lo, q_scale, q_max;
  int bits;
};

struct MinF {
  __device__ float operator()(float a, float b) const { return fminf(a, b); }
};
struct MaxF {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct OrI {
  __device__ int operator()(int a, int b) const { return a | b; }
};

// Block-wide reduction; every thread gets the result.
template <typename T, typename Op>
__device__ T block_reduce(T v, Op op, T* sh) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // sh may still be read by a previous reduction
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  T r = sh[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) r = op(r, sh[w]);
  return r;
}

// Block 0 only: reset the per-round accumulators, and compute the flags
// for the next round from the live assignment of the window at `col`.
// With `entering`, the window's seeded assignment is copied in first.
__device__ void block0_settle(const Params& P, int col, int epoch,
                              bool entering, bool first_window) {
  __shared__ float shf[32];
  __shared__ int shi[32];
  const int t = threadIdx.x;
  const int any_accept = entering ? 1 : __ldcg(&P.flags[kFlagAccept]);
  float max_gf = -3.4e38f;
  for (int n = t; n < P.N; n += blockDim.x) {
    float g, m;
    if (first_window) {
      g = P.gf0[n];
      m = P.mf0[n];
    } else {
      g = __ldcg(&P.gf[n]);
      m = __ldcg(&P.mf[n]);
      if (!entering) {
        g = __fsub_rn(g, __ldcg(&P.used_g[n]));
        m = __fsub_rn(m, __ldcg(&P.used_m[n]));
      }
    }
    P.gf[n] = g;
    P.mf[n] = m;
    max_gf = fmaxf(max_gf, g);
    P.tg[n] = 0.f;
    P.tm[n] = 0.f;
    P.used_g[n] = 0.f;
    P.used_m[n] = 0.f;
    P.win[n] = kI32Max;
  }
  int any_unpl = 0;
  float min_d = kDemandSentinel, r_lo = kRankInf, r_hi = -kRankInf;
  for (int j = t; j < P.W; j += blockDim.x) {
    const int jj = col + j;
    int a;
    if (entering) {
      a = P.asg0[jj];
      P.asg[jj] = a;
      P.prim[j] = kI32Max;
    } else {
      a = __ldcg(&P.asg[jj]);
    }
    if (P.may[jj] && a < 0) {
      any_unpl = 1;
      min_d = fminf(min_d, P.d[jj]);
      r_lo = fminf(r_lo, P.rank[jj]);
      r_hi = fmaxf(r_hi, P.rank[jj]);
    }
  }
  max_gf = block_reduce(max_gf, MaxF(), shf);
  min_d = block_reduce(min_d, MinF(), shf);
  r_lo = block_reduce(r_lo, MinF(), shf);
  r_hi = block_reduce(r_hi, MaxF(), shf);
  any_unpl = block_reduce(any_unpl, OrI(), shi);
  if (t == 0) {
    const bool prog =
        any_accept && any_unpl && (min_d <= __fadd_rn(max_gf, kEps));
    P.flags[kFlagProgress + (epoch & 1)] = prog ? 1 : 0;
    P.flags[kFlagFence] = (r_lo < r_hi) ? 1 : 0;
    P.flags[kFlagAccept] = 0;
  }
}

__global__ void __launch_bounds__(kThreads, 2) mega_kernel(Params P) {
  cg::grid_group grid = cg::this_grid();
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthreads = gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;
  const int gwarp = gtid >> 5;
  const int nwarps = nthreads >> 5;
  const int N = P.N, J = P.J, W = P.W;
  const int node_mask = (1 << P.bits) - 1;
  // bid phase split: each job column is shared by `slices` threads
  const int slices = nthreads >= W ? nthreads / W : 1;
  const int per_slice = (N + slices - 1) / slices;

  int epoch = 0, rounds = 0, capped = 0;
  for (int col = 0; col < J; col += W) {
    if (blockIdx.x == 0) block0_settle(P, col, epoch, true, col == 0);
    grid.sync();
    bool prog = __ldcg(&P.flags[kFlagProgress + (epoch & 1)]) != 0;
    ++epoch;
    int r = 0;
    while (prog && r < P.max_rounds) {
      // Phase A: node thresholds, live fit pressure, fence minimum.
      const bool fence = __ldcg(&P.flags[kFlagFence]) != 0;
      for (int n = gtid; n < N; n += nthreads) {
        const float g = __ldcg(&P.gf[n]);
        const float m = __ldcg(&P.mf[n]);
        const float u = __fmul_rn(
            __fadd_rn(__fmul_rn(P.vg[n], g), __fmul_rn(P.vm[n], m)),
            P.q_scale);
        P.node4[n].x = __fadd_rn(g, kEps);
        P.node4[n].y = __fadd_rn(m, kEps);
        P.node4[n].w = u;
        // with a fence, .z is written by the node's warp below
        if (!fence) P.node4[n].z = kRankInf;
      }
      if (fence) {
        // row reduction over the window, one warp per node
        for (int n = gwarp; n < N; n += nwarps) {
          const float g = __fadd_rn(__ldcg(&P.gf[n]), kEps);
          const float m = __fadd_rn(__ldcg(&P.mf[n]), kEps);
          float mr = kRankInf;
          for (int j = lane; j < W; j += 32) {
            const int jj = col + j;
            if (P.may[jj] && __ldcg(&P.asg[jj]) < 0 && P.d[jj] <= g &&
                P.md[jj] <= m)
              mr = fminf(mr, P.rank[jj]);
          }
          for (int o = 16; o > 0; o >>= 1)
            mr = fminf(mr, __shfl_xor_sync(0xffffffffu, mr, o));
          if (lane == 0) P.node4[n].z = mr;
        }
      }
      grid.sync();

      // Phase B: packed min bid per job (column reduction over N).
      for (int idx = gtid; idx < W * slices; idx += nthreads) {
        const int j = idx % W;
        const int s = idx / W;
        const int jj = col + j;
        if (!P.may[jj] || __ldcg(&P.asg[jj]) >= 0) continue;
        const float dj = P.d[jj], mdj = P.md[jj], rj = P.rank[jj];
        const int cj = P.cur[jj];
        const int n0 = s * per_slice;
        const int n1 = min(N, n0 + per_slice);
        int best = kI32Max;
        for (int n = n0; n < n1; ++n) {
          const float4 v = __ldcg(&P.node4[n]);
          if (dj <= v.x && mdj <= v.y && (rj <= v.z || cj == n)) {
            const float sq = __fmul_rn(
                __fsub_rn(P.S[(size_t)n * J + jj], P.q_lo), P.q_scale);
            const float q = fminf(fmaxf(__fadd_rn(sq, v.w), 0.f), P.q_max);
            const int packed = (__float2int_rz(q) << P.bits) | n;
            best = min(best, packed);
          }
        }
        if (best != kI32Max) atomicMin(&P.prim[j], best);
      }
      grid.sync();

      // Phase C: per-node bidder totals and winner key.
      for (int j = gtid; j < W; j += nthreads) {
        const int p = __ldcg(&P.prim[j]);
        P.prim[j] = kI32Max;  // ready for the next round's bids
        const int c = p != kI32Max ? (p & node_mask) : N;
        P.choice[j] = c;
        if (c < N) {
          const int jj = col + j;
          atomicAdd(&P.tg[c], P.d[jj]);
          atomicAdd(&P.tm[c], P.md[jj]);
          atomicMin(&P.win[c], P.key[jj]);
        }
      }
      grid.sync();

      // Phase D: per-job accept and consumed capacity.
      for (int j = gtid; j < W; j += nthreads) {
        const int c = __ldcg(&P.choice[j]);
        if (c >= N) continue;
        const int jj = col + j;
        const float g = __fadd_rn(__ldcg(&P.gf[c]), kEps);
        const float m = __fadd_rn(__ldcg(&P.mf[c]), kEps);
        const bool fits_all = __ldcg(&P.tg[c]) <= g && __ldcg(&P.tm[c]) <= m;
        if (fits_all || P.key[jj] == __ldcg(&P.win[c])) {
          P.asg[jj] = c;
          atomicAdd(&P.used_g[c], P.d[jj]);
          atomicAdd(&P.used_m[c], P.md[jj]);
          P.flags[kFlagAccept] = 1;
        }
      }
      grid.sync();

      // Phase E (block 0): capacity update, progress, next round's fence.
      if (blockIdx.x == 0) block0_settle(P, col, epoch, false, false);
      grid.sync();
      prog = __ldcg(&P.flags[kFlagProgress + (epoch & 1)]) != 0;
      ++epoch;
      ++r;
    }
    rounds += r;
    capped |= prog ? 1 : 0;
  }
  if (gtid == 0) {
    P.stats[0] = rounds;
    P.stats[1] = capped;
  }
}

}  // namespace

extern "C" int mega_solve_launch(
    const void* S, const void* d, const void* md, const void* key,
    const void* rank, const void* cur, const void* asg0, const void* may,
    const void* gf0, const void* mf0, const void* vg, const void* vm,
    void* asg, void* gf, void* mf, void* stats, void* ws_f, void* ws_i,
    int N, int J, int W, int max_rounds, float q_lo, float q_scale,
    float q_max, int bits, void* stream) {
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
  float* wf = static_cast<float*>(ws_f);  // 8N floats
  P.node4 = reinterpret_cast<float4*>(wf);
  P.tg = wf + 4 * N;
  P.tm = wf + 5 * N;
  P.used_g = wf + 6 * N;
  P.used_m = wf + 7 * N;
  int* wi = static_cast<int*>(ws_i);  // N + 2W + 16 ints
  P.win = wi;
  P.prim = wi + N;
  P.choice = wi + N + W;
  P.flags = wi + N + 2 * W;
  P.N = N;
  P.J = J;
  P.W = W;
  P.max_rounds = max_rounds;
  P.q_lo = q_lo;
  P.q_scale = q_scale;
  P.q_max = q_max;
  P.bits = bits;
  if (W <= 0 || J % W != 0 || N <= 0) return cudaErrorInvalidValue;

  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int coop = 0, sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return cudaErrorNotSupported;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mega_kernel,
                                                    kThreads, 0);
  if (e != cudaSuccess) return e;
  // every block of a cooperative grid must be co-resident
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int blocks = sms * (per_sm < 2 ? per_sm : 2);
  void* args[] = {&P};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(mega_kernel),
                                  dim3(blocks), dim3(kThreads), args, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

extern "C" const char* mega_solve_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
