// GQA decode attention for Hopper (sm_90a): kernels #10 and #11.
//
// Replaces kubeinfer_tpu/inference/flash_attention.py:decode_attention
// (_decode_attn_kernel, dense per-row caches, T == 1) and
// :decode_attention_blocks (_decode_blocks_kernel, a paged pool read
// through block tables, T >= 1). Plain PyTorch versions:
// kubeinfer_tpu_torch/inference/flash_attention.py:decode_attention_plain
// and :decode_attention_blocks_plain, which this kernel matches within a
// stated tolerance (the sums run in another order).
//
// What it computes. For batch row b and kv head h, the T*G query rows
// r = t*G + g (query t, head h*G + g) attend key positions p with
//   s = (q . k_p) * scale + (p <= len - T + t ? 0 : -1e30),
// len = lengths[b], an online softmax over key tiles (running max m,
// normaliser l, accumulator acc, all f32), p rounded to the value dtype
// before P.V (the reference's p.astype(v.dtype)), and
// out = acc / max(l, 1e-30) in q's dtype. At T == 1 the rule is the
// decode rule p < len. Key position p lives at k[b, p] (linear cache
// [B, S, n_kv, D]) or at pool[tables[b, p / bs], p % bs] (paged pool
// [num_blocks, bs, n_kv, D]; the table index is the block's own load, no
// scalar prefetch).
//
// Which positions are walked. A row with len >= T walks only its live
// positions [0, len): every later position is masked, and once the
// running max is finite (position 0 is live for every query) a masked
// position adds exactly 0. A row with len < T has queries with no live
// position; their defined output is the uniform average over every
// position the row names, so such a row walks all of them, null-padded
// table entries included, as the reference does. Retired rows (an
// all-null table) are computed and discarded by the caller.
//
// Bound on this card: bytes. Each block reads its row's live K and V for
// one head once (2 * len * D * sizeof(T)), far below the bf16 ridge, so
// the least time is the live K/V over 3.35 TB/s. Design: one block of 128
// threads per (row, kv head); the T*G query rows and their f32
// accumulators sit in shared memory; each 32-key tile of K and V is
// loaded once with 16-byte vector loads (K padded to D+1 floats a row, so
// the lanes of a warp, one key each, hit distinct banks), a warp scores
// one query row against the tile (lane = key), reduces max and sum with
// shuffles, and the block then folds P.V into the accumulators. No split
// over the cache yet: a long row is walked by one block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kKeys = 32;  // key positions per tile: one per lane
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

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

// 16 bytes of T (4 floats or 8 bf16) into f32 registers
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
  __device__ __forceinline__ static void load(const T* src, float* dst) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = to_f(e[i]);
  }
};

template <typename T, bool kPaged>
__global__ void __launch_bounds__(kThreads) decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ tables,
    const int* __restrict__ lengths, T* __restrict__ out, int Tq, int H,
    int n_kv, int D, int width, int M, float scale) {
  // width: S of the linear cache, or the pool's block size bs
  const int b = blockIdx.x / n_kv;
  const int h = blockIdx.x % n_kv;
  const int G = H / n_kv;
  const int R = Tq * G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float smem[];
  float* qs = smem;                   // [R][D]
  float* acc = qs + R * D;            // [R][D]
  float* ks = acc + R * D;            // [kKeys][D + 1]
  float* vs = ks + kKeys * (D + 1);   // [kKeys][D]
  float* ps = vs + kKeys * D;         // [R][kKeys]
  float* m_s = ps + R * kKeys;        // [R]
  float* l_s = m_s + R;               // [R]
  float* a_s = l_s + R;               // [R] this tile's rescale

  const int len = lengths[b];
  const int s_total = kPaged ? M * width : width;
  const int walk = len < Tq ? s_total : min(len, s_total);

  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int t = r / G, g = r % G;
    qs[i] = to_f(q[((size_t)(b * Tq + t) * H + h * G + g) * D + d]);
    acc[i] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    m_s[r] = kNeg;
    l_s[r] = 0.f;
  }

  constexpr int kVec = Vec<T>::N;
  const int row_chunks = D / kVec;
  for (int s0 = 0; s0 < walk; s0 += kKeys) {
    __syncthreads();  // the previous tile's P.V is done with ks/vs/ps
    for (int c = tid; c < kKeys * row_chunks; c += kThreads) {
      const int j = c / row_chunks;
      const int d0 = (c % row_chunks) * kVec;
      const int p = s0 + j;
      float kv[kVec], vv[kVec];
      if (p < s_total) {
        size_t row;
        if (kPaged) {
          const int blk = tables[(size_t)b * M + p / width];
          row = ((size_t)blk * width + p % width) * n_kv + h;
        } else {
          row = ((size_t)b * width + p) * n_kv + h;
        }
        Vec<T>::load(k + row * D + d0, kv);
        Vec<T>::load(v + row * D + d0, vv);
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) kv[i] = vv[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        ks[j * (D + 1) + d0 + i] = kv[i];
        vs[j * D + d0 + i] = vv[i];
      }
    }
    __syncthreads();

    // scores and the online-softmax step: a warp per query row, a lane
    // per key
    for (int r = warp; r < R; r += kThreads / 32) {
      const int t = r / G;
      const int p = s0 + lane;
      float s = -INFINITY;  // no such position: p exp()s to exactly 0
      if (p < s_total) {
        const float* qr = qs + r * D;
        const float* kr = ks + lane * (D + 1);
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * scale + (p <= len - Tq + t ? 0.f : kNeg);
      }
      float mt = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mt);
      const float pj = expf(s - m_new);
      float sum = pj;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
      ps[r * kKeys + lane] = to_f(from_f<T>(pj));
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        m_s[r] = m_new;
        l_s[r] = alpha * l_s[r] + sum;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P . V
    for (int i = tid; i < R * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const float* pr = ps + r * kKeys;
      float o = 0.f;
#pragma unroll 8
      for (int j = 0; j < kKeys; ++j) o = fmaf(pr[j], vs[j * D + d], o);
      acc[i] = acc[i] * a_s[r] + o;
    }
  }
  __syncthreads();

  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int t = r / G, g = r % G;
    out[((size_t)(b * Tq + t) * H + h * G + g) * D + d] =
        from_f<T>(acc[i] / fmaxf(l_s[r], 1e-30f));
  }
}

size_t smem_bytes(int R, int D) {
  return sizeof(float) * ((size_t)2 * R * D + (size_t)kKeys * (D + 1) +
                          (size_t)kKeys * D + (size_t)R * kKeys + 3 * R);
}

template <typename T, bool kPaged>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* tables, const void* lengths, void* out, int B,
                   int Tq, int H, int n_kv, int D, int width, int M,
                   float scale, cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  if (Tq <= 0 || n_kv <= 0 || H % n_kv || D % 16 || D > 256 || width <= 0)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(Tq * (H / n_kv), D);
  auto kern = decode_kernel<T, kPaged>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<B * n_kv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<T*>(out), Tq, H, n_kv,
      D, width, M, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       void* out, int B, int H, int n_kv,
                                       int D, int S, float scale, int dtype,
                                       void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, false>(q, k, v, nullptr, lengths, out, B, 1, H,
                                n_kv, D, S, 0, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(q, k, v, nullptr, lengths, out, B,
                                        1, H, n_kv, D, S, 0, scale, st);
  return cudaErrorInvalidValue;
}

extern "C" int decode_attention_blocks_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* tables, const void* lengths, void* out, int B, int T, int H,
    int n_kv, int D, int bs, int M, float scale, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, true>(q, k_pool, v_pool, tables, lengths, out, B,
                               T, H, n_kv, D, bs, M, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, true>(q, k_pool, v_pool, tables, lengths,
                                       out, B, T, H, n_kv, D, bs, M, scale,
                                       st);
  return cudaErrorInvalidValue;
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
