// Chunked-prefill GQA flash attention for Hopper (sm_90a) on CUDA cores:
// kernels #9, #9b and #13 for f32 (in full f32, never TF32) and for head
// widths D % 64 != 0. Every bf16 call with D % 64 == 0 goes to the
// tensor-core kernel in flash_prefill_tc.cu instead (the wrappers choose
// statically by dtype and D: flash_attention.py tc_route).
//
// Replaces kubeinfer_tpu/inference/flash_attention.py:_run_flash with
// _flash_ragged_kernel (#9, the path of flash_attention_ragged) and
// _diff_fwd with _flash_ragged_lse_kernel (#13, the forward of the
// differentiable flash_attention_causal_diff). Plain PyTorch versions:
// kubeinfer_tpu_torch/inference/flash_attention.py:
// flash_attention_ragged_plain and flash_ragged_lse_plain, which this
// kernel matches within a stated tolerance (the sums run in another
// order).
//
// #13 is #9 with one more output: given a non-null lse pointer, a block
// writes each of its rows' logsumexp m + log(max(l, 1e-30)) (f32, the
// folded [B * n_kv, T * G] layout) after the last key tile. The o
// arithmetic is the same kernel on the same walk, so #13's o is bitwise
// #9's on the same inputs: the custom_vjp contract of the reference.
//
// What it computes. q [B, T, H, D], k/v [B, S, n_kv, D]. Query t of row b
// sits at global position q_offset + t and attends key s iff
//   s <= q_offset + t  and  s < row_lens[b],
// the mask derived here from the two scalars: nothing [T, S]-sized is
// made. Scores are f32 (q . k) * scale with an additive -1e30 penalty,
// folded by the online softmax (running max m, normaliser l, accumulator
// o, all f32), p rounded to the value dtype before P.V, and
// out = o / max(l, 1e-30) in q's dtype.
//
// #9b (flash_masked_launch) replaces _run_flash with _flash_kernel, the
// path of flash_attention: the same fold, but the penalty is read from a
// caller's dense bool [B, T, S] mask (one byte a pair, 1 = attend; the
// reference ships it as int8) instead of derived from two scalars. It is
// a separate instantiation (kMask = true) of the same kernel: the mask
// pointer is its last parameter, which #9 and #13 never read, so their
// code is unchanged. The mask route walks EVERY key tile (the reference's
// _flash_kernel passes no `active`), so a row with no True gets p == 1 at
// every key and returns the uniform mean of v over all S keys, as the
// dense softmax does. Each K/V tile step also stages the block's
// [rows/G, BC] byte tile of the mask in shared memory with 16-byte loads
// (one byte a load only where S is not a multiple of 16 or the mask's
// base is not 16-byte aligned); query row r of kv head h reads the mask
// row (b, t = r / G), the reference's index map bh // n_kv.
//
// Which key tiles are walked by #9 and #13: the reference's
// _ragged_tile_active rule.
// Tile 0 always; every tile for a row with row_len == 0 (its queries see
// no live key, and their defined output is the uniform average over all
// S keys); otherwise the tiles that start at or before the block's last
// query position and before row_len. A skipped tile is exactly a tile of
// masked keys, which adds exactly 0 once the running max is finite (key 0
// is live for every query of such a row).
//
// Bound on this card: operations. A 2048-query chunk against up to 8192
// keys does 4 * D flops per (query head, live key) pair, far above the
// bf16 ridge. Design: the GQA fold of the reference, (t, g) query rows of
// one kv head in one block, so each K/V tile is read once for G heads; a
// grid of (B * n_kv, ceil(T * G / BR)) blocks of 128 threads; BR x BC =
// 64 x 64 tiles up to D = 128, 32 x 32 above. The Q tile, one K tile
// (rows padded to D + 1 floats), one V tile and the P tile sit in shared
// memory as f32; each thread holds a (BR/8) x (BC/16) block of scores and
// a (BR/8) x (D/16) block of the output accumulator in registers (CUDA
// cores, f32 FMA). The bf16 route on tensor cores, with TMA and the #9b
// tile skip, is flash_prefill_tc.cu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 128;  // 8 row groups x 16 lanes
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

// max/sum over the 16 lanes that share a row group (lanes 0-15 or 16-31)
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <typename T, int BR, int BC, int DMAX, bool kMask>
__global__ void __launch_bounds__(kThreads) prefill_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ row_lens,
    T* __restrict__ out, float* __restrict__ lse, int Tq, int S, int H,
    int n_kv, int D, int q_offset, float scale,
    const uint8_t* __restrict__ mask) {
  constexpr int RI = BR / 8;     // rows per thread
  constexpr int CJ = BC / 16;    // score columns per thread
  constexpr int DK = DMAX / 16;  // output columns per thread (at most)
  const int b = blockIdx.x / n_kv;
  const int h = blockIdx.x % n_kv;
  const int G = H / n_kv;
  const int R = Tq * G;
  const int r0 = blockIdx.y * BR;
  const int tid = threadIdx.x;
  const int tr = tid >> 4;  // row group
  const int tc = tid & 15;  // lane in the group
  const int dk = D / 16;

  extern __shared__ float smem[];
  float* qs = smem;                  // [BR][D + 1]
  float* ks = qs + BR * (D + 1);     // [BC][D + 1]
  float* vs = ks + BC * (D + 1);     // [BC][D]
  float* ps = vs + BC * D;           // [BR][BC + 1]
  // kMask: the mask tile, [BR][BC] bytes (rows t - t0 of the block)
  uint8_t* mtile = reinterpret_cast<uint8_t*>(ps + BR * (BC + 1));

  constexpr int kVec = Vec<T>::N;
  const int row_chunks = D / kVec;
  for (int c = tid; c < BR * row_chunks; c += kThreads) {
    const int rl = c / row_chunks;
    const int d0 = (c % row_chunks) * kVec;
    const int r = r0 + rl;
    float x[kVec];
    if (r < R) {
      const int t = r / G, g = r % G;
      Vec<T>::load(q + ((size_t)(b * Tq + t) * H + h * G + g) * D + d0, x);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) x[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) qs[rl * (D + 1) + d0 + i] = x[i];
  }

  // the block's key range: every tile for the mask route, else the
  // reference's _ragged_tile_active rule
  const int t0 = r0 / G;
  const int t_last = (min(r0 + BR, R) - 1) / G;
  int row_len = 0, walk = S;
  if constexpr (!kMask) {
    row_len = row_lens[b];
    const int q_max = q_offset + t_last;
    walk = row_len == 0 ? S : min(S, max(1, min(q_max + 1, row_len)));
  }
  const int n_t = t_last - t0 + 1;  // mask rows the block reads
  const bool vec_mask =
      kMask && (S & 15) == 0 && (reinterpret_cast<uintptr_t>(mask) & 15) == 0;

  int q_pos[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) q_pos[i] = q_offset + (r0 + tr + 8 * i) / G;

  float m[RI], l[RI], o[RI][DK];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) o[i][kk] = 0.f;
  }

  for (int s0 = 0; s0 < walk; s0 += BC) {
    __syncthreads();  // Q is in; the previous tile is done with ks/vs/ps
    for (int c = tid; c < BC * row_chunks; c += kThreads) {
      const int j = c / row_chunks;
      const int d0 = (c % row_chunks) * kVec;
      const int p = s0 + j;
      float kv[kVec], vv[kVec];
      if (p < S) {
        const size_t row = ((size_t)b * S + p) * n_kv + h;
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
    if constexpr (kMask) {
      // rows t0 .. t_last of the mask, columns s0 .. s0 + BC
      const uint8_t* mrow = mask + ((size_t)b * Tq + t0) * S + s0;
      if (vec_mask) {
        constexpr int kChunks = BC / 16;
        for (int c = tid; c < n_t * kChunks; c += kThreads) {
          const int tl = c / kChunks, c0 = (c % kChunks) * 16;
          uint4 raw = make_uint4(0u, 0u, 0u, 0u);
          if (s0 + c0 < S)  // S % 16 == 0: a chunk is whole or absent
            raw = __ldg(reinterpret_cast<const uint4*>(mrow + (size_t)tl * S
                                                       + c0));
          *reinterpret_cast<uint4*>(mtile + tl * BC + c0) = raw;
        }
      } else {
        for (int c = tid; c < n_t * BC; c += kThreads) {
          const int tl = c / BC, j = c % BC;
          mtile[tl * BC + j] = s0 + j < S ? mrow[(size_t)tl * S + j] : 0;
        }
      }
    }
    __syncthreads();

    // scores for rows tr + 8i, keys tc + 16j
    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = qs[(tr + 8 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = ks[(tc + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // mask, online softmax, P (rounded to the value dtype) to shared
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int p = s0 + tc + 16 * j;
        if (p < S) {
          bool ok;
          if constexpr (kMask) {
            const int r = r0 + tr + 8 * i;
            ok = r < R && mtile[(r / G - t0) * BC + tc + 16 * j] != 0;
          } else {
            ok = p <= q_pos[i] && p < row_len;
          }
          s[i][j] = s[i][j] * scale + (ok ? 0.f : kNeg);
        } else {
          s[i][j] = -INFINITY;  // no such key: p is exactly 0
        }
        mt = fmaxf(mt, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mt));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float pj = expf(s[i][j] - m_new);
        rs += pj;
        ps[(tr + 8 * i) * (BC + 1) + tc + 16 * j] = to_f(from_f<T>(pj));
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + group_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) o[i][kk] *= alpha;
    }
    __syncthreads();

    // o += P . V for rows tr + 8i, columns tc + 16kk
    for (int j = 0; j < BC; ++j) {
      float pv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = ps[(tr + 8 * i) * (BC + 1) + j];
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        if (kk < dk) {
          const float vj = vs[j * D + tc + 16 * kk];
#pragma unroll
          for (int i = 0; i < RI; ++i) o[i][kk] = fmaf(pv[i], vj, o[i][kk]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = r0 + tr + 8 * i;
    if (r >= R) continue;
    const int t = r / G, g = r % G;
    T* dst = out + ((size_t)(b * Tq + t) * H + h * G + g) * D;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      if (kk < dk) dst[tc + 16 * kk] = from_f<T>(o[i][kk] * inv_l);
    }
    if (lse != nullptr && tc == 0)
      lse[(size_t)blockIdx.x * R + r] = m[i] + logf(fmaxf(l[i], 1e-30f));
  }
}

template <typename T, int BR, int BC, int DMAX, bool kMask>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* row_lens, void* out, void* lse, int B, int Tq,
                   int S, int H, int n_kv, int D, int q_offset, float scale,
                   const void* mask, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
                      ((size_t)BR * (D + 1) + (size_t)BC * (D + 1) +
                       (size_t)BC * D + (size_t)BR * (BC + 1)) +
                      (kMask ? (size_t)BR * BC : 0);
  auto kern = prefill_kernel<T, BR, BC, DMAX, kMask>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int R = Tq * (H / n_kv);
  dim3 grid(B * n_kv, (R + BR - 1) / BR);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(row_lens),
      static_cast<T*>(out), static_cast<float*>(lse), Tq, S, H, n_kv, D,
      q_offset, scale, static_cast<const uint8_t*>(mask));
  return cudaGetLastError();
}

template <typename T, bool kMask>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* row_lens, void* out, void* lse, int B,
                     int Tq, int S, int H, int n_kv, int D, int q_offset,
                     float scale, const void* mask, cudaStream_t stream) {
  if (D <= 128)
    return launch<T, 64, 64, 128, kMask>(q, k, v, row_lens, out, lse, B, Tq,
                                         S, H, n_kv, D, q_offset, scale, mask,
                                         stream);
  return launch<T, 32, 32, 256, kMask>(q, k, v, row_lens, out, lse, B, Tq, S,
                                       H, n_kv, D, q_offset, scale, mask,
                                       stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. lse: null for #9, an f32
// [B * n_kv, T * G] buffer for #13.
extern "C" int flash_prefill_launch(const void* q, const void* k,
                                    const void* v, const void* row_lens,
                                    void* out, void* lse, int B, int T, int S,
                                    int H, int n_kv, int D, int q_offset,
                                    float scale, int dtype, void* stream) {
  if (B <= 0 || T <= 0) return cudaSuccess;
  if (S <= 0 || n_kv <= 0 || H % n_kv || D % 16 || D > 256 || q_offset < 0)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float, false>(q, k, v, row_lens, out, lse, B, T, S, H,
                                  n_kv, D, q_offset, scale, nullptr, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16, false>(q, k, v, row_lens, out, lse, B, T,
                                          S, H, n_kv, D, q_offset, scale,
                                          nullptr, st);
  return cudaErrorInvalidValue;
}

// #9b: mask is bool [B, T, S] (one byte a pair, nonzero = attend); every
// key tile is folded.
extern "C" int flash_masked_launch(const void* q, const void* k,
                                   const void* v, const void* mask,
                                   void* out, int B, int T, int S, int H,
                                   int n_kv, int D, float scale, int dtype,
                                   void* stream) {
  if (B <= 0 || T <= 0) return cudaSuccess;
  if (S <= 0 || n_kv <= 0 || H % n_kv || D % 16 || D > 256)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float, true>(q, k, v, nullptr, out, nullptr, B, T, S, H,
                                 n_kv, D, 0, scale, mask, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16, true>(q, k, v, nullptr, out, nullptr, B,
                                         T, S, H, n_kv, D, 0, scale, mask,
                                         st);
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_prefill_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
