// Jacobi auction loop of the jax-auction policy for Hopper (sm_90a).
//
// Replaces kubeinfer_tpu/solver/pallas_kernels.py:auction_solve
// (_auction_kernel). Plain PyTorch version:
// kubeinfer_tpu_torch/solver/kernels.py:auction_rounds, which this kernel
// matches bit for bit, iteration count included.
//
// What it computes. From assigned = -1, owner = -1, price = 0, while
//   progress && any unassigned valid job && it < max_iters && stale < 16:
//   A. every unassigned valid job j: value[n] = benefit[j, n] - price[n];
//      best_v = max value; best_n = the node with the largest tie-break
//      hash among the values >= best_v - 1e-5 (lowest n on equal hashes);
//      second_v = max(NEG, max over n != best_n of value); a job with
//      best_v > NEG / 2 bids (price[best_n] + (best_v - second_v)) + eps
//      on best_n;
//   B. every node with a bid: the highest bid wins, the lowest job index
//      on a float tie; the previous owner is evicted, the winner owns the
//      node and the node's price becomes the winning bid;
//   C. progress = any job bid; the pending count falls by the nodes won
//      that had no owner; stale resets when the pending count reaches a
//      new low and counts up otherwise.
// Every float is a selection or one of the two expressions above, taken
// with __fsub_rn/__fadd_rn in the plain version's order (no multiply, so
// nothing can be contracted).
//
// Design. ONE persistent cooperative launch runs every iteration, with two
// grid barriers per iteration (after A, after B); the grid is sized by the
// occupancy API so every block is co-resident. The TPU kernel kept the
// whole [J, N] field in VMEM and swept it with [J, N] masks; here:
//   A. one warp per job row, and only rows that are unassigned and valid
//      (the others have value = NEG and cannot bid in the reference, so
//      nothing they compute reaches the state). Pass 1 walks the row with
//      coalesced loads and keeps the top two values WITH multiplicity, so
//      second_v = (value[best_n] == best_v ? second : best_v) needs no
//      third pass; pass 2 picks best_n (it depends on best_v, so it cannot
//      share pass 1). The bid goes to the node by one 64-bit atomicMax on
//      (orderable bits of the bid << 32) | (0xFFFFFFFF - j): the highest
//      bid, then the lowest j.
//   B. one thread per node with a key. Bidders are unassigned and owners
//      are assigned, so no job is both evicted and a winner in the same
//      iteration, and each owner owns exactly one node: the writes to
//      assigned[] are to distinct jobs and need no order.
//   C. the pending count moves by a count of fresh wins (atomics, into a
//      counter double-buffered by iteration parity and cleared in phase B
//      of the iteration before its next use), so every thread evaluates
//      the loop condition from the same values with no third barrier.
// Benefit + tiebreak is 8 MiB at 1024 x 1024, which stays in the 50 MB L2
// across iterations; at 4096 x 4096 (128 MiB) it does not.
//
// Bound on this card: bytes. Each iteration reads the benefit row of every
// active job (4 * N each) and the tie-break only at the near entries of
// the rows that bid (4 each; auction_rounds counts both), summed over the
// iterations, over 3.35 TB/s. The two grid barriers per iteration are
// expected to set the pace instead.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr float kNeg = -1e9f;  // -INFEASIBLE
constexpr float kHalfNeg = -5e8f;  // NEG * 0.5, exact
constexpr float kTieTol = 1e-5f;
constexpr int kStaleIters = 16;
constexpr unsigned kFull = 0xffffffffu;

// counters: [parity] fresh wins, [2 + parity] progress, [4] valid jobs
constexpr int kFresh = 0;
constexpr int kProgress = 2;
constexpr int kValid = 4;

struct Params {
  const float* benefit;  // [J, N]; -INFEASIBLE marks infeasible
  const int* tiebreak;  // [J, N]
  const unsigned char* valid;  // [J] bool
  int* asg;  // [J] out: assigned node, -1 = unplaced
  int* iters;  // [1] out
  unsigned long long* key;  // [N] packed highest bid of this iteration
  float* price;  // [N]
  int* owner;  // [N]
  int* counters;  // [8]
  int J, N, max_iters;
  float eps;
};

// order-preserving map of a float onto an unsigned int
__device__ __forceinline__ unsigned orderable(float f) {
  const unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_orderable(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// Phase A for one job row, by one warp.
__device__ void bid_row(const Params& P, int j, int lane, int parity) {
  const int N = P.N;
  const float* brow = P.benefit + (size_t)j * N;
  const int* trow = P.tiebreak + (size_t)j * N;
  // pass 1: the two largest values, with multiplicity
  float a = -INFINITY, b = -INFINITY;
  for (int n = lane; n < N; n += 32) {
    const float v = __fsub_rn(__ldg(brow + n), __ldcg(P.price + n));
    if (v > a) {
      b = a;
      a = v;
    } else if (v > b) {
      b = v;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float a2 = __shfl_xor_sync(kFull, a, o);
    const float b2 = __shfl_xor_sync(kFull, b, o);
    const float lo = fminf(a, a2);
    a = fmaxf(a, a2);
    b = fmaxf(lo, fmaxf(b, b2));
  }
  const float best_v = a;
  if (!(best_v > kHalfNeg)) return;  // cannot bid: every node infeasible
  // pass 2: best_n = argmax of (near ? tiebreak : -1), first index
  const float thr = __fsub_rn(best_v, kTieTol);
  int tb = INT_MIN, bn = N;
  float bv = 0.f;
  for (int n = lane; n < N; n += 32) {
    const float v = __fsub_rn(__ldg(brow + n), __ldcg(P.price + n));
    const int t = v >= thr ? __ldg(trow + n) : -1;
    if (t > tb) {
      tb = t;
      bn = n;
      bv = v;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const int tb2 = __shfl_xor_sync(kFull, tb, o);
    const int bn2 = __shfl_xor_sync(kFull, bn, o);
    const float bv2 = __shfl_xor_sync(kFull, bv, o);
    if (tb2 > tb || (tb2 == tb && bn2 < bn)) {
      tb = tb2;
      bn = bn2;
      bv = bv2;
    }
  }
  if (lane == 0) {
    // the best value off best_n; the masked slot itself contributes NEG
    const float second_v = fmaxf(bv == best_v ? b : best_v, kNeg);
    const float bid = __fadd_rn(
        __fadd_rn(__ldcg(P.price + bn), __fsub_rn(best_v, second_v)), P.eps);
    const unsigned long long k =
        ((unsigned long long)orderable(bid) << 32) | (0xffffffffu - (unsigned)j);
    atomicMax(P.key + bn, k);
    P.counters[kProgress + parity] = 1;
  }
}

__global__ void __launch_bounds__(kThreads, 2) auction_kernel(Params P) {
  cg::grid_group grid = cg::this_grid();
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthreads = gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;
  const int gwarp = gtid >> 5;
  const int nwarps = nthreads >> 5;
  const int J = P.J, N = P.N;

  // prologue: the workspace arrives zeroed (key, price, counters)
  int nvalid = 0;
  for (int j = gtid; j < J; j += nthreads) {
    P.asg[j] = -1;
    nvalid += P.valid[j] ? 1 : 0;
  }
  for (int n = gtid; n < N; n += nthreads) P.owner[n] = -1;
  for (int o = 16; o > 0; o >>= 1) nvalid += __shfl_xor_sync(kFull, nvalid, o);
  if (lane == 0 && nvalid) atomicAdd(P.counters + kValid, nvalid);
  grid.sync();

  int n_pending = __ldcg(P.counters + kValid);
  int it = 0, pending_best = J + 1, stale = 0;
  bool progress = true;
  while (progress && n_pending > 0 && it < P.max_iters && stale < kStaleIters) {
    const int parity = it & 1;
    // Phase A: bids, one warp per active row
    for (int j = gwarp; j < J; j += nwarps) {
      if (__ldcg(P.asg + j) >= 0 || !P.valid[j]) continue;
      bid_row(P, j, lane, parity);
    }
    grid.sync();

    // Phase B: winners, evictions, prices; count fresh wins
    int fresh = 0;
    for (int n = gtid; n < N; n += nthreads) {
      const unsigned long long k = __ldcg(P.key + n);
      if (k == 0ull) continue;
      const int winner = (int)(0xffffffffu - (unsigned)(k & 0xffffffffull));
      const int prev = __ldcg(P.owner + n);
      if (prev >= 0) {
        P.asg[prev] = -1;
      } else {
        ++fresh;
      }
      P.owner[n] = winner;
      P.price[n] = from_orderable((unsigned)(k >> 32));
      P.asg[winner] = n;
      P.key[n] = 0ull;
    }
    // the other parity's counters were last read before this iteration's
    // first barrier and are next written after its second
    if (gtid == 0) {
      P.counters[kFresh + (parity ^ 1)] = 0;
      P.counters[kProgress + (parity ^ 1)] = 0;
    }
    for (int o = 16; o > 0; o >>= 1) fresh += __shfl_xor_sync(kFull, fresh, o);
    if (lane == 0 && fresh) atomicAdd(P.counters + kFresh + parity, fresh);
    grid.sync();

    // Phase C: the loop state, the same in every thread
    progress = __ldcg(P.counters + kProgress + parity) != 0;
    n_pending -= __ldcg(P.counters + kFresh + parity);
    ++it;
    if (n_pending < pending_best) {
      pending_best = n_pending;
      stale = 0;
    } else {
      ++stale;
    }
  }
  if (gtid == 0) P.iters[0] = it;
}

}  // namespace

extern "C" int auction_launch(const void* benefit, const void* tiebreak,
                              const void* valid, void* asg, void* iters,
                              void* ws, int J, int N, int max_iters, float eps,
                              void* stream) {
  if (J <= 0 || N <= 0) return cudaErrorInvalidValue;
  Params P;
  P.benefit = static_cast<const float*>(benefit);
  P.tiebreak = static_cast<const int*>(tiebreak);
  P.valid = static_cast<const unsigned char*>(valid);
  P.asg = static_cast<int*>(asg);
  P.iters = static_cast<int*>(iters);
  int* w = static_cast<int*>(ws);  // 4N + 8 ints, zeroed
  P.key = reinterpret_cast<unsigned long long*>(w);
  P.price = reinterpret_cast<float*>(w + 2 * N);
  P.owner = w + 3 * N;
  P.counters = w + 4 * N;
  P.J = J;
  P.N = N;
  P.max_iters = max_iters;
  P.eps = eps;

  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int coop = 0, sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return cudaErrorNotSupported;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, auction_kernel,
                                                    kThreads, 0);
  if (e != cudaSuccess) return e;
  // every block of a cooperative grid must be co-resident
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int blocks = sms * (per_sm < 2 ? per_sm : 2);
  void* args[] = {&P};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(auction_kernel),
                                  dim3(blocks), dim3(kThreads), args, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

extern "C" const char* auction_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
