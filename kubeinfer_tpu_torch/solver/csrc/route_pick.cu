// Masked row argmax of the batched route solve for Hopper (sm_90a).
//
// Replaces kubeinfer_tpu/solver/pallas_kernels.py:route_pick_pallas
// (_route_pick_kernel). Plain PyTorch version:
// kubeinfer_tpu_torch/solver/kernels.py:route_pick_plain, which this kernel
// matches bit for bit.
//
// What it computes. For each request row b:
//   s[r] = (match[b, r] >= 0 && active[b]) ? (float)match[b, r] + bias[r]
//                                           : ROUTE_NEG,
// one f32 add (__fadd_rn; nothing to contract); val[b] = max s and
// idx[b] = the first r where s[r] == val[b], or -1 when val[b] is not
// above ROUTE_NEG (a row with no eligible replica, or an inactive row).
//
// Design. One warp per row. The Pallas kernel carried a running (max,
// argmax) across a sequential grid of replica tiles; here the lanes stride
// over the row with coalesced i32 loads, each keeping a running (value,
// index) with a strict > (so the first index of its maximum), and the warp
// reduces with shuffles: the larger value wins, the lower index on equal
// values. A lexicographic max on (value, -index) does not depend on the
// order of the reduction, so this is the first index of the row maximum,
// as the plain version computes it. An inactive row loads nothing.
//
// Bound on this card: bytes, 4 R per active row (match) + 4 R (bias) + B
// (active) read and 8 B written, over 3.35 TB/s: at most about 15 us at
// 12288 x 1024 with every row active, 12.3 us with the 10 000 active rows
// of the solved_affinity plane's first round.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr float kRouteNeg = -3e38f;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads) route_pick_kernel(
    const int* __restrict__ match, const float* __restrict__ bias,
    const unsigned char* __restrict__ active, float* __restrict__ val,
    int* __restrict__ idx, int B, int R) {
  const int b = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (b >= B) return;  // warp-uniform
  if (!active[b]) {
    // every entry is masked: the maximum is ROUTE_NEG itself
    if (lane == 0) {
      val[b] = kRouteNeg;
      idx[b] = -1;
    }
    return;
  }
  const int* row = match + (size_t)b * R;
  float v = -INFINITY;
  int i = INT_MAX;
  for (int r = lane; r < R; r += 32) {
    const int m = __ldg(row + r);
    const float s = m >= 0 ? __fadd_rn((float)m, __ldg(bias + r)) : kRouteNeg;
    if (s > v) {
      v = s;
      i = r;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_xor_sync(kFull, v, o);
    const int i2 = __shfl_xor_sync(kFull, i, o);
    if (v2 > v || (v2 == v && i2 < i)) {
      v = v2;
      i = i2;
    }
  }
  if (lane == 0) {
    val[b] = v;
    idx[b] = v > kRouteNeg ? i : -1;
  }
}

}  // namespace

extern "C" int route_pick_launch(const void* match, const void* bias,
                                 const void* active, void* val, void* idx,
                                 int B, int R, void* stream) {
  if (B <= 0 || R <= 0) return cudaErrorInvalidValue;
  const long long threads = (long long)B * 32;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  route_pick_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(match), static_cast<const float*>(bias),
      static_cast<const unsigned char*>(active), static_cast<float*>(val),
      static_cast<int*>(idx), B, R);
  return cudaGetLastError();
}

extern "C" const char* route_pick_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
