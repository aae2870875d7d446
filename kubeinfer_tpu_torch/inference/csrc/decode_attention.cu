// GQA decode attention for Hopper (sm_90a): the first kernels of #10,
// #11 and #12.
//
// The wrappers of #10, #11 and #12 launch csrc/decode_split.cu (split-K)
// for every call. decode_attention_launch, decode_attention_blocks_launch
// and decode_attention_blocks_q8_launch stay here, one block per (row, kv
// head), launchable only for chip_smoke.py's "old kernel on the same
// call" times.
//
// Replaces kubeinfer_tpu/inference/flash_attention.py:decode_attention
// (_decode_attn_kernel, dense per-row caches, T == 1),
// :decode_attention_blocks (_decode_blocks_kernel, a paged pool read
// through block tables, T >= 1) and :decode_attention_blocks_q8
// (_decode_blocks_q8_kernel, the same walk over an int8 pool). Plain
// PyTorch versions: kubeinfer_tpu_torch/inference/flash_attention.py
// :decode_attention_plain, :decode_attention_blocks_plain and
// :decode_attention_blocks_q8_plain, which this kernel matches within a
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
// The int8 pool (#12). Pages are int8 [num_blocks, bs, n_kv, D] with one
// f32 scale per (block, kv head) and a per-row tail [B, 2, bs, n_kv, D]
// in q's dtype holding the row's current partial block and the one a
// window may spill into. With ts = p / bs and the tail base
// tb = max(len - T, 0) / bs (the window's start block, derived here from
// lengths as the reference derives it), position p reads the tail
// tail[b, min(ts - tb, 1), p % bs] verbatim when ts >= tb, else the page
// of block tables[b, ts] times its scale in f32, rounded to q's dtype
// before the fold (the reference's _dequant_tile cast). The walk, the
// live-tile rule and the len < T rule are #11's: quantization changes the
// tile values, never which tiles are folded.
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
// one head once (2 * len * D * sizeof(T); int8 pages a quarter of that
// in f32 and half in bf16), far below the bf16 ridge, so the least time
// is the live K/V over 3.35 TB/s. Design: one block of 128 threads per
// (row, kv head); the T*G query rows and their f32 accumulators sit in
// shared memory; each 32-key tile of K and V is loaded once with 16-byte
// vector loads (16 int8 codes a load for the int8 pages, converted and
// scaled in registers; K padded to D+1 floats a row, so the lanes of a
// warp, one key each, hit distinct banks), a warp scores one query row
// against the tile (lane = key), reduces max and sum with shuffles, and
// the block then folds P.V into the accumulators. No split over the
// cache: a long row is walked by one block (decode_split.cu splits it).

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

// 16 int8 codes times their f32 scale, each rounded to T, into f32
template <typename T>
__device__ __forceinline__ void load_q8(const int8_t* src, float sc,
                                        float* dst) {
  const int4 raw = __ldg(reinterpret_cast<const int4*>(src));
  const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 16; ++i)
    dst[i] = to_f(from_f<T>(static_cast<float>(e[i]) * sc));
}

// where key position p lives
enum Src { kLinear = 0, kPaged = 1, kQ8 = 2 };

template <typename T, int kSrc>
__global__ void __launch_bounds__(kThreads) decode_kernel(
    const T* __restrict__ q, const void* __restrict__ k_,
    const void* __restrict__ v_, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const T* __restrict__ k_tail,
    const T* __restrict__ v_tail, const int* __restrict__ tables,
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
  const int s_total = kSrc == kLinear ? width : M * width;
  const int walk = len < Tq ? s_total : min(len, s_total);
  const int tb = max(len - Tq, 0) / width;  // the int8 pool's tail base

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
  // values per chunk: 16 int8 codes (one 16-byte load) for the int8 pool
  constexpr int kChunk = kSrc == kQ8 ? 16 : kVec;
  const int row_chunks = D / kChunk;
  for (int s0 = 0; s0 < walk; s0 += kKeys) {
    __syncthreads();  // the previous tile's P.V is done with ks/vs/ps
    for (int c = tid; c < kKeys * row_chunks; c += kThreads) {
      const int j = c / row_chunks;
      const int d0 = (c % row_chunks) * kChunk;
      const int p = s0 + j;
      float kv[kChunk], vv[kChunk];
      if (p >= s_total) {
#pragma unroll
        for (int i = 0; i < kChunk; ++i) kv[i] = vv[i] = 0.f;
      } else if constexpr (kSrc == kQ8) {
        const int ts = p / width;
        if (ts >= tb) {
          const size_t row =
              (((size_t)b * 2 + min(ts - tb, 1)) * width + p % width) *
                  n_kv + h;
#pragma unroll
          for (int i = 0; i < kChunk; i += kVec) {
            Vec<T>::load(k_tail + row * D + d0 + i, kv + i);
            Vec<T>::load(v_tail + row * D + d0 + i, vv + i);
          }
        } else {
          const int blk = tables[(size_t)b * M + ts];
          const size_t row = ((size_t)blk * width + p % width) * n_kv + h;
          const size_t si = (size_t)blk * n_kv + h;
          load_q8<T>(static_cast<const int8_t*>(k_) + row * D + d0,
                     k_scales[si], kv);
          load_q8<T>(static_cast<const int8_t*>(v_) + row * D + d0,
                     v_scales[si], vv);
        }
      } else {
        size_t row;
        if constexpr (kSrc == kPaged) {
          const int blk = tables[(size_t)b * M + p / width];
          row = ((size_t)blk * width + p % width) * n_kv + h;
        } else {
          row = ((size_t)b * width + p) * n_kv + h;
        }
        Vec<T>::load(static_cast<const T*>(k_) + row * D + d0, kv);
        Vec<T>::load(static_cast<const T*>(v_) + row * D + d0, vv);
      }
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
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

template <typename T, int kSrc>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* k_scales, const void* v_scales,
                   const void* k_tail, const void* v_tail,
                   const void* tables, const void* lengths, void* out, int B,
                   int Tq, int H, int n_kv, int D, int width, int M,
                   float scale, cudaStream_t stream) {
  if (B <= 0) return cudaSuccess;
  if (Tq <= 0 || n_kv <= 0 || H % n_kv || D % 16 || D > 256 || width <= 0)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(Tq * (H / n_kv), D);
  auto kern = decode_kernel<T, kSrc>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<B * n_kv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), k, v, static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales), static_cast<const T*>(k_tail),
      static_cast<const T*>(v_tail), static_cast<const int*>(tables),
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
    return launch<float, kLinear>(q, k, v, nullptr, nullptr, nullptr,
                                  nullptr, nullptr, lengths, out, B, 1, H,
                                  n_kv, D, S, 0, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, kLinear>(q, k, v, nullptr, nullptr, nullptr,
                                          nullptr, nullptr, lengths, out, B,
                                          1, H, n_kv, D, S, 0, scale, st);
  return cudaErrorInvalidValue;
}

extern "C" int decode_attention_blocks_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* tables, const void* lengths, void* out, int B, int T, int H,
    int n_kv, int D, int bs, int M, float scale, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, kPaged>(q, k_pool, v_pool, nullptr, nullptr,
                                 nullptr, nullptr, tables, lengths, out, B, T,
                                 H, n_kv, D, bs, M, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, kPaged>(q, k_pool, v_pool, nullptr, nullptr,
                                         nullptr, nullptr, tables, lengths,
                                         out, B, T, H, n_kv, D, bs, M, scale,
                                         st);
  return cudaErrorInvalidValue;
}

// the int8 pool: int8 pages, f32 scales [num_blocks, n_kv], tails in q's
// dtype [B, 2, bs, n_kv, D]
extern "C" int decode_attention_blocks_q8_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scales, const void* v_scales, const void* k_tail,
    const void* v_tail, const void* tables, const void* lengths, void* out,
    int B, int T, int H, int n_kv, int D, int bs, int M, float scale,
    int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, kQ8>(q, k_pool, v_pool, k_scales, v_scales, k_tail,
                              v_tail, tables, lengths, out, B, T, H, n_kv, D,
                              bs, M, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, kQ8>(q, k_pool, v_pool, k_scales, v_scales,
                                      k_tail, v_tail, tables, lengths, out, B,
                                      T, H, n_kv, D, bs, M, scale, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
