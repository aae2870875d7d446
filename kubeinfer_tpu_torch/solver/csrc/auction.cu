// Jacobi auction loop of the jax-auction policy for Hopper (sm_90a).
//
// Replaces kubeinfer_tpu/solver/pallas_kernels.py:auction_solve
// (_auction_kernel). Plain PyTorch version:
// kubeinfer_tpu_torch/solver/kernels.py:auction_rounds, which both kernels
// here match bit for bit, iteration count included.
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
//   C. progress = any job bid; the pending count is the number of
//      unassigned valid jobs; stale resets when it reaches a new low and
//      counts up otherwise.
// Every float is a selection or one of the two expressions above, taken
// with __fsub_rn/__fadd_rn in the plain version's order (no multiply, so
// nothing can be contracted). Every reduction is a max, a top-2 with
// multiplicity or an (hash desc, node asc) argmax: none depends on how a
// row is split over threads, so any split gives the same bits.
//
// Both kernels send a bid to its node by one 64-bit atomicMax on
// (orderable bits of the bid << 32) | (0xFFFFFFFF - j): the highest bid,
// then the lowest j. Bidders are unassigned and owners assigned, so no job
// is both evicted and a winner in an iteration, and each owner owns one
// node: the writes to assigned[] are to distinct jobs and need no order.
//
// The shared-state kernel (kernels.auction_plan's "shared" route, N <=
// 16384 and the state within shared memory). ONE cooperative launch of one
// block an SM runs every iteration with ONE grid barrier an iteration:
//   - every block holds price[N], owner[N] and assigned[J] in shared
//     memory, and every block's copy is the same: after the barrier each
//     block reads all N keys of the iteration and applies the winners,
//     evictions and prices itself. The pending count is the number of
//     unassigned valid rows of its own copy and progress is "some key was
//     set", so every block decides the loop from the same values, with no
//     counters and no second barrier;
//   - every block compacts the unassigned valid rows of its copy with a
//     block scan (the same list in every block). The rows are dealt over
//     the card: a whole block a row while there are fewer rows than
//     blocks, else a group of G = 32..512 threads a row (the most threads
//     that still give every row a group). Each thread loads its
//     share of the row once, all loads issued before use (16 bytes each
//     where N % 4 == 0), and keeps the values in registers for the tie
//     pass; the tie-break lines of the same entries are prefetched into L1
//     beside them, and loaded only at the entries within TIE_TOL of the
//     best. Phase A reads price from shared memory, not L2;
//   - the keys are triple-buffered by iteration mod 3. Buffer it % 3 is
//     written by the bids of iteration it (before barrier it) and read by
//     every block after barrier it, before that block reaches barrier
//     it + 1. After barrier it each block clears its slice of buffer
//     (it + 2) % 3, the one every block read one iteration before (all
//     before barrier it); it is next written after barrier it + 1. With
//     two buffers the clear would hit the buffer that the next iteration's
//     bids write, which a block that has gone on may already be writing
//     (no barrier separates one iteration's reads from the next
//     iteration's bids); with three it cannot. Buffer 0 arrives zeroed.
// Where walked is not null it adds the rows walked, the tie-break entries
// read and its grid barriers (kernels.auction_walk mirrors all three).
//
// The two-barrier kernel (the "wide" route, past that line): two grid
// barriers an iteration over two blocks an SM; one warp walks a row twice
// (pass 2 re-reads it), the state in L2.
//
// Bound on this card: bytes. Each iteration reads the benefit row of every
// active job (4 * N each) and the tie-break only at the near entries of
// the rows that bid (4 each; auction_rounds counts both), summed over the
// iterations, over 3.35 TB/s. Latency sets the pace instead: an
// iteration is a grid barrier, the keys' L2 read after it, a block scan,
// and a row walk of one L2 trip (the row, its tie-break lines prefetched
// beside it) and two group reductions.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace cg = cooperative_groups;

namespace {

constexpr float kNeg = -1e9f;  // -INFEASIBLE
constexpr float kHalfNeg = -5e8f;  // NEG * 0.5, exact
constexpr float kTieTol = 1e-5f;
constexpr int kStaleIters = 16;
constexpr unsigned kFull = 0xffffffffu;

// order-preserving map of a float onto an unsigned int
__device__ __forceinline__ unsigned orderable(float f) {
  const unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_orderable(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ unsigned long long bid_key(float bid, int j) {
  return ((unsigned long long)orderable(bid) << 32) |
         (0xffffffffu - (unsigned)j);
}

// the two largest values, with multiplicity
__device__ __forceinline__ void top2_push(float& a, float& b, float v) {
  if (v > a) {
    b = a;
    a = v;
  } else if (v > b) {
    b = v;
  }
}

__device__ __forceinline__ void top2_merge(float& a, float& b, float a2,
                                           float b2) {
  const float lo = fminf(a, a2);
  a = fmaxf(a, a2);
  b = fmaxf(lo, fmaxf(b, b2));
}

// ---- the shared-state kernel -----------------------------------------------

constexpr int kSThreads = 512;
constexpr int kSWarps = kSThreads / 32;
constexpr int kVMax = 32;  // benefit values a thread holds: N <= 32 x 512
constexpr int kKeyBatch = 4;  // key pairs a thread loads before applying

struct SParams {
  const float* benefit;  // [J, N]; -INFEASIBLE marks infeasible
  const int* tiebreak;  // [J, N]
  const unsigned char* valid;  // [J] bool
  int* asg;  // [J] out: assigned node, -1 = unplaced
  int* iters;  // [1] out
  unsigned long long* keys;  // [3][Np], buffer 0 zeroed; Np = N rounded even
  unsigned long long* walked;  // [3] or null: rows, tie entries, barriers
  int J, N, Np, max_iters;
  float eps;
};

struct Pick {
  int tb, bn;
  float bv;
};

// a group's barrier: a named barrier over its warps (id 1 + the group's
// index in the block; 0 is __syncthreads), or the warp itself
__device__ __forceinline__ void group_sync(int id, int G) {
  if (G > 32)
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(G) : "memory");
  else
    __syncwarp();
}

// Phase A for row j, by the G threads of one group; r is the thread's
// index in it, wfirst the group's first warp in the block. VEC = 4: thread
// r holds nodes 4 (r + G k) + e, else r + G k, for the `used` chunks k
// that start inside N (the loops stop there: the bound is the same for the
// whole group, so the registers stay registers).
template <int VEC>
__device__ void walk_row(const SParams& P, const float* __restrict__ price,
                         int j, int r, int G, int wfirst, int bar,
                         float2* red1, Pick* red2,
                         unsigned long long* __restrict__ kbuf) {
  const int N = P.N;
  const int lane = r & 31;
  const int used = min(kVMax / VEC, (N + VEC * G - 1) / (VEC * G));
  const float* brow = P.benefit + (size_t)j * N;
  const int* trow = P.tiebreak + (size_t)j * N;
  float v[kVMax];
  // pass 1: the row's values, every load issued before use, and their two
  // largest with multiplicity; the tie-break lines of the same entries are
  // prefetched into L1 meanwhile, for pass 2's loads at the near entries
#pragma unroll
  for (int k = 0; k < kVMax / VEC; ++k) {
    if (k == used) break;
    const int n = VEC * (r + G * k);
    if (n < N) {
      const int* t = trow + n;
      if ((reinterpret_cast<uintptr_t>(t) & 127) < 4 * VEC || r == 0)
        asm volatile("prefetch.global.L1 [%0];" ::"l"(t));
    }
  }
  if (VEC == 4) {
    float4 x[kVMax / 4];
#pragma unroll
    for (int k = 0; k < kVMax / 4; ++k) {
      if (k == used) break;
      const int n = 4 * (r + G * k);
      x[k] = n < N ? __ldg(reinterpret_cast<const float4*>(brow + n))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < kVMax / 4; ++k) {
      if (k == used) break;
      const int n = 4 * (r + G * k);
      if (n < N) {
        const float4 p = *reinterpret_cast<const float4*>(price + n);
        v[4 * k] = __fsub_rn(x[k].x, p.x);
        v[4 * k + 1] = __fsub_rn(x[k].y, p.y);
        v[4 * k + 2] = __fsub_rn(x[k].z, p.z);
        v[4 * k + 3] = __fsub_rn(x[k].w, p.w);
      } else {
        v[4 * k] = v[4 * k + 1] = v[4 * k + 2] = v[4 * k + 3] = -INFINITY;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kVMax; ++k) {
      if (k == used) break;
      const int n = r + G * k;
      v[k] = n < N ? __ldg(brow + n) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kVMax; ++k) {
      if (k == used) break;
      const int n = r + G * k;
      v[k] = n < N ? __fsub_rn(v[k], price[n]) : -INFINITY;
    }
  }
  float a = -INFINITY, b = -INFINITY;
#pragma unroll
  for (int k = 0; k < kVMax; ++k) {
    if (k == VEC * used) break;
    top2_push(a, b, v[k]);
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float a2 = __shfl_xor_sync(kFull, a, o);
    const float b2 = __shfl_xor_sync(kFull, b, o);
    top2_merge(a, b, a2, b2);
  }
  const int gw = G >> 5;
  if (gw > 1) {
    // the group's warps' pairs, merged by a shuffle over gw lanes
    if (lane == 0) red1[wfirst + (r >> 5)] = make_float2(a, b);
    group_sync(bar, G);
    const float2 p = red1[wfirst + (lane & (gw - 1))];
    a = p.x;
    b = p.y;
    for (int o = gw >> 1; o > 0; o >>= 1) {
      const float a2 = __shfl_xor_sync(kFull, a, o);
      const float b2 = __shfl_xor_sync(kFull, b, o);
      top2_merge(a, b, a2, b2);
    }
  }
  const float best_v = a;
  if (!(best_v > kHalfNeg)) return;  // cannot bid: every node infeasible
  // pass 2: best_n = argmax of (near ? tiebreak : -1), lowest node on
  // equal hashes; the tie-break is loaded at the near entries only
  const float thr = __fsub_rn(best_v, kTieTol);
  int tb = INT_MIN, bn = N, near = 0;
  float bv = 0.f;
#pragma unroll
  for (int k = 0; k < kVMax; ++k) {
    if (k == VEC * used) break;
    const int n = VEC == 4 ? 4 * (r + G * (k >> 2)) + (k & 3) : r + G * k;
    if (n < N) {
      const bool is_near = v[k] >= thr;
      const int t = is_near ? __ldg(trow + n) : -1;
      near += is_near;
      if (t > tb || (t == tb && n < bn)) {
        tb = t;
        bn = n;
        bv = v[k];
      }
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
  if (P.walked != nullptr) {
    near = __reduce_add_sync(kFull, near);
    if (lane == 0 && near) atomicAdd(&P.walked[1], (unsigned long long)near);
  }
  if (gw > 1) {
    // the warps' picks, merged by the group's first warp
    if (lane == 0) red2[wfirst + (r >> 5)] = Pick{tb, bn, bv};
    group_sync(bar, G);
    if (r < 32) {
      const Pick p = red2[wfirst + (lane & (gw - 1))];
      tb = p.tb;
      bn = p.bn;
      bv = p.bv;
      for (int o = gw >> 1; o > 0; o >>= 1) {
        const int tb2 = __shfl_xor_sync(kFull, tb, o);
        const int bn2 = __shfl_xor_sync(kFull, bn, o);
        const float bv2 = __shfl_xor_sync(kFull, bv, o);
        if (tb2 > tb || (tb2 == tb && bn2 < bn)) {
          tb = tb2;
          bn = bn2;
          bv = bv2;
        }
      }
    }
  }
  if (r == 0) {
    // the best value off best_n; the masked slot itself contributes NEG
    const float second_v = fmaxf(bv == best_v ? b : best_v, kNeg);
    const float bid =
        __fadd_rn(__fadd_rn(price[bn], __fsub_rn(best_v, second_v)), P.eps);
    atomicMax(kbuf + bn, bid_key(bid, j));
  }
}

// One node's key applied to a block's copy of the state; false if unset.
__device__ __forceinline__ bool apply_key(unsigned long long k, int n,
                                          float* price, int* owner,
                                          int* asg) {
  if (k == 0ull) return false;
  const int winner = (int)(0xffffffffu - (unsigned)(k & 0xffffffffull));
  const int prev = owner[n];
  if (prev >= 0) asg[prev] = -1;
  owner[n] = winner;
  price[n] = from_orderable((unsigned)(k >> 32));
  asg[winner] = n;
  return true;
}

// The unassigned valid rows (asg == -1) of a block's copy, in the order
// (tid, k) of rows tid + 512 k: the same list in every block. Returns
// their number.
__device__ int compact(const int* asg, int* list, int J, int* wsum) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int c = 0;
  for (int j = tid; j < J; j += kSThreads) c += asg[j] == -1;
  int incl = c;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  // the warps' counts, scanned over the first 16 lanes of every warp
  int s = lane < kSWarps ? wsum[lane] : 0;
  for (int o = 1; o < kSWarps; o <<= 1) {
    const int y = __shfl_up_sync(kFull, s, o);
    if (lane >= o) s += y;
  }
  const int total = __shfl_sync(kFull, s, kSWarps - 1);
  const int before = __shfl_sync(kFull, s, (warp + kSWarps - 1) % kSWarps);
  int off = (warp ? before : 0) + incl - c;
  if (c)
    for (int j = tid; j < J; j += kSThreads)
      if (asg[j] == -1) list[off++] = j;
  __syncthreads();
  return total;
}

template <int VEC>
__global__ void __launch_bounds__(kSThreads, 1)
    auction_shared_kernel(SParams P) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float2 red1[2][kSWarps];  // by row parity within a group
  __shared__ Pick red2[kSWarps];
  __shared__ int wsum[kSWarps];
  const int J = P.J, N = P.N, B = gridDim.x, tid = threadIdx.x;
  float* price = reinterpret_cast<float*>(smem);  // [N]
  int* owner = reinterpret_cast<int*>(price + N);  // [N]
  int* asg = owner + N;  // [J]: node, -1 unplaced, -2 invalid
  int* list = asg + J;  // [J] the active rows

  for (int n = tid; n < N; n += kSThreads) {
    price[n] = 0.f;
    owner[n] = -1;
  }
  for (int j = tid; j < J; j += kSThreads) asg[j] = P.valid[j] ? -1 : -2;
  __syncthreads();
  int active = compact(asg, list, J, wsum);

  // the least group that holds a row: G x kVMax >= N
  int gmin = 32;
  while (gmin * kVMax < N) gmin <<= 1;
  // this block's slice of a key buffer, to clear
  const int chunk = (P.Np + B - 1) / B;
  const int c0 = min(P.Np, blockIdx.x * chunk), c1 = min(P.Np, c0 + chunk);
  int it = 0, pending_best = J + 1, stale = 0;
  bool progress = true;
  while (progress && active > 0 && it < P.max_iters && stale < kStaleIters) {
    unsigned long long* kbuf = P.keys + (size_t)(it % 3) * P.Np;
    // Phase A: bids, the active rows dealt over the card
    {
      const int fit = B * kSThreads / active;  // threads a row, >= 1
      const int G = min(kSThreads, max(gmin, 1 << (31 - __clz(fit))));
      const int per_block = kSThreads / G, groups = B * per_block;
      const int g = tid / G, r = tid - g * G;
      int parity = 0;
      for (int i = blockIdx.x * per_block + g; i < active; i += groups) {
        walk_row<VEC>(P, price, list[i], r, G, g * (G >> 5), 1 + g,
                      red1[parity], red2, kbuf);
        parity ^= 1;
      }
      if (P.walked != nullptr && blockIdx.x == 0 && tid == 0) {
        atomicAdd(&P.walked[0], (unsigned long long)active);
        atomicAdd(&P.walked[2], 1ull);
      }
    }
    grid.sync();

    // Phase B: every block applies the iteration's keys to its own copy
    bool any = false;
    for (int n0 = 2 * tid; n0 < P.Np; n0 += 2 * kSThreads * kKeyBatch) {
      ulonglong2 k[kKeyBatch];
#pragma unroll
      for (int u = 0; u < kKeyBatch; ++u) {
        const int n = n0 + 2 * kSThreads * u;
        k[u] = n < P.Np ? __ldcg(reinterpret_cast<const ulonglong2*>(kbuf + n))
                        : make_ulonglong2(0ull, 0ull);
      }
#pragma unroll
      for (int u = 0; u < kKeyBatch; ++u) {
        const int n = n0 + 2 * kSThreads * u;
        any |= apply_key(k[u].x, n, price, owner, asg);
        any |= apply_key(k[u].y, n + 1, price, owner, asg);
      }
    }
    // this block's slice of the keys every block read one iteration ago
    unsigned long long* old = P.keys + (size_t)((it + 2) % 3) * P.Np;
    for (int n = c0 + tid; n < c1; n += kSThreads) __stcg(old + n, 0ull);
    progress = __syncthreads_or(any);

    // Phase C: the loop state, the same in every block
    active = compact(asg, list, J, wsum);
    ++it;
    if (active < pending_best) {
      pending_best = active;
      stale = 0;
    } else {
      ++stale;
    }
  }
  for (int j = blockIdx.x * kSThreads + tid; j < J; j += B * kSThreads)
    P.asg[j] = max(asg[j], -1);
  if (blockIdx.x == 0 && tid == 0) P.iters[0] = it;
}

// ---- the two-barrier kernel -------------------------------------------------

constexpr int kThreads = 512;

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
  unsigned long long* walked;  // [3] or null: rows, tie entries, barriers
  int J, N, max_iters;
  float eps;
};

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
  if (P.walked != nullptr) {
    // the walk's own count, apart from the loops above: the tie-break
    // entries pass 2 read
    int near = 0;
    for (int n = lane; n < N; n += 32)
      near += __fsub_rn(__ldg(brow + n), __ldcg(P.price + n)) >= thr;
    near = __reduce_add_sync(kFull, near);
    if (lane == 0) atomicAdd(&P.walked[1], (unsigned long long)near);
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
  if (P.walked != nullptr && gtid == 0) atomicAdd(&P.walked[2], 1ull);
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
    if (P.walked != nullptr && gtid == 0) {
      atomicAdd(&P.walked[0], (unsigned long long)n_pending);
      atomicAdd(&P.walked[2], 2ull);
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

// Per device, once a process: the SM count and whether cooperative
// launches work (a benign race: every thread stores the same values).
struct Device {
  int sms = 0, coop = 0;
  int smem[2] = {0, 0};  // the shared kernel's opt-in bytes, by vec == 4
};
Device g_devices[64];

cudaError_t device_info(Device& out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  Device& d = g_devices[dev];
  if (d.sms == 0) {
    int coop = 0, sms = 0;
    cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    d.coop = coop;
    d.sms = sms;
  }
  out = d;
  return d.coop ? cudaSuccess : cudaErrorNotSupported;
}

}  // namespace

extern "C" int auction_shared_launch(const void* benefit, const void* tiebreak,
                                     const void* valid, void* asg, void* iters,
                                     void* keys, void* walked, int J, int N,
                                     int max_iters, float eps, int blocks,
                                     int smem, int vec, void* stream) {
  if (J <= 0 || N <= 0 || N > kSThreads * kVMax || blocks <= 0 ||
      smem < 8 * (N + J) ||
      (vec != 1 && vec != 4) || (vec == 4 && (N & 3) != 0) ||
      (reinterpret_cast<uintptr_t>(keys) & 15) != 0 ||
      (vec == 4 && (reinterpret_cast<uintptr_t>(benefit) & 15) != 0))
    return cudaErrorInvalidValue;
  SParams P;
  P.benefit = static_cast<const float*>(benefit);
  P.tiebreak = static_cast<const int*>(tiebreak);
  P.valid = static_cast<const unsigned char*>(valid);
  P.asg = static_cast<int*>(asg);
  P.iters = static_cast<int*>(iters);
  P.keys = static_cast<unsigned long long*>(keys);
  P.walked = static_cast<unsigned long long*>(walked);
  P.J = J;
  P.N = N;
  P.Np = N + (N & 1);
  P.max_iters = max_iters;
  P.eps = eps;
  Device d;
  cudaError_t e = device_info(d);
  if (e != cudaSuccess) return e;
  if (blocks > d.sms) return cudaErrorCooperativeLaunchTooLarge;
  const void* fn = vec == 4
                       ? reinterpret_cast<const void*>(auction_shared_kernel<4>)
                       : reinterpret_cast<const void*>(auction_shared_kernel<1>);
  // the opt-in shared memory, raised once to the largest size asked for
  int dev = 0;
  cudaGetDevice(&dev);
  int& opted = g_devices[dev].smem[vec == 4];
  if (smem > opted) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    opted = smem;
  }
  void* args[] = {&P};
  e = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kSThreads), args,
                                  static_cast<size_t>(smem),
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

extern "C" int auction_launch(const void* benefit, const void* tiebreak,
                              const void* valid, void* asg, void* iters,
                              void* ws, void* walked, int J, int N,
                              int max_iters, float eps, void* stream) {
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
  P.walked = static_cast<unsigned long long*>(walked);
  P.J = J;
  P.N = N;
  P.max_iters = max_iters;
  P.eps = eps;

  Device d;
  cudaError_t e = device_info(d);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, auction_kernel,
                                                    kThreads, 0);
  if (e != cudaSuccess) return e;
  // every block of a cooperative grid must be co-resident
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int blocks = d.sms * (per_sm < 2 ? per_sm : 2);
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
