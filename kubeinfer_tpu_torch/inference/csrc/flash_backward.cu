// Backward of the ragged causal GQA flash attention for Hopper (sm_90a):
// kernel #14, as two kernels.
//
// Replaces kubeinfer_tpu/inference/flash_attention.py:_diff_bwd, its dQ
// pallas_call (body _flash_bwd_dq_kernel) and its dK/dV pallas_call (body
// _flash_bwd_dkv_kernel). Plain PyTorch versions:
// kubeinfer_tpu_torch/inference/flash_attention.py:flash_bwd_dq_plain and
// flash_bwd_dkv_plain, which these kernels match within a stated
// tolerance (the sums run in another order).
//
// What they compute. q, dO [B, T, H, D], k, v [B, S, n_kv, D], all of one
// dtype; lse and drow = rowsum(dO * O) f32 [B * n_kv, T * G] in the
// folded (t, g) row order of one kv head (G = H / n_kv), both from the
// forward (#13) and the wrapper. Query t of row b attends key s iff
// s <= q_offset + t and s < row_lens[b]. Both kernels recompute, per
// (query row, key) pair,
//   P  = exp((q . k) * scale - lse)   (0 where masked, and on every query
//                                      of a row with row_len == 0),
//   dP = dO . v,   dS = P * (dP - drow),
// and sum in f32, with the reference's roundings: dS rounded to the
// input dtype before dS . K and dS^T . Q, P before P^T . dO; the scale
// multiplies the summed dQ and dK once, at the end.
//   dq_kernel:  dQ = scale * sum_s bf(dS) K        (one block per query
//               row tile; walks the key tiles the causal + length rule
//               admits, the reference's skip rule)
//   dkv_kernel: dV = sum_t bf(P)^T dO, dK = scale * sum_t bf(dS)^T Q
//               (one block per key tile; walks the query row tiles that
//               can see it). The GQA group sum falls out of the folded
//               rows: a kv head's block walks the rows of all its G heads.
// Each block owns its outputs, so there are no atomics and the result
// does not depend on the order blocks run in. A row with row_len == 0
// walks no tile and gets exactly zero gradients. A masked pair has P = 0
// exactly, so these tiles need not match the reference's 256 x 512.
//
// Bound on this card: operations. At T = S = 2048 (causal, 32 heads,
// D = 128) the dQ kernel does 6 * D flops per live (head, pair) and
// dK/dV 8 * D, about 120 GFLOP for both, against some 50 MB moved. Design:
// 256 threads as 16 row groups x 16 lanes; 64 x 64 tiles up to D = 128,
// 32 x 32 above; the block's Q, dO (or K, V) and the walked K, V (or Q,
// dO) tiles sit in shared memory as f32 with rows padded to D + 1 floats
// (the score loop reads conflict-free), with the rounded dS (and P) tile;
// each thread holds a (tile / 16) x (tile / 16) block of the score
// products and a (tile / 16) x (D / 16) block of each f32 accumulator in
// registers (CUDA cores, f32 FMA). About 150-170 KB of shared memory per
// block at D = 128, so one block per SM. Tensor-core mma/wgmma and TMA
// pipelining are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;  // 16 row groups x 16 lanes

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
// x rounded to T and back: the reference's .astype(dtype) before a product
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
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

// rows [r0, r0 + rows) of the folded (t, g) view of a [B, T, H, D]
// tensor (kv head h of batch row b) into shared memory [rows][D + 1];
// rows past R are zeros
template <typename T>
__device__ __forceinline__ void load_qrows(float* dst, const T* src, int b,
                                           int h, int r0, int rows, int R,
                                           int Tq, int H, int G, int D) {
  constexpr int kVec = Vec<T>::N;
  const int chunks = D / kVec;
  for (int c = threadIdx.x; c < rows * chunks; c += kThreads) {
    const int rl = c / chunks;
    const int d0 = (c % chunks) * kVec;
    const int r = r0 + rl;
    float x[kVec];
    if (r < R) {
      const int t = r / G, g = r % G;
      Vec<T>::load(src + ((size_t)(b * Tq + t) * H + h * G + g) * D + d0, x);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) x[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) dst[rl * (D + 1) + d0 + i] = x[i];
  }
}

// keys [s0, s0 + rows) of kv head h of batch row b of a [B, S, n_kv, D]
// tensor into shared memory [rows][D + 1]; keys past S are zeros
template <typename T>
__device__ __forceinline__ void load_keys(float* dst, const T* src, int b,
                                          int h, int s0, int rows, int S,
                                          int n_kv, int D) {
  constexpr int kVec = Vec<T>::N;
  const int chunks = D / kVec;
  for (int c = threadIdx.x; c < rows * chunks; c += kThreads) {
    const int j = c / chunks;
    const int d0 = (c % chunks) * kVec;
    const int p = s0 + j;
    float x[kVec];
    if (p < S) {
      Vec<T>::load(src + (((size_t)b * S + p) * n_kv + h) * D + d0, x);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) x[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) dst[j * (D + 1) + d0 + i] = x[i];
  }
}

// dQ: grid (B * n_kv, ceil(T * G / BR)). Thread (tr, tc) holds query rows
// tr + 16i and, per key tile, keys tc + 16j of the scores, and output
// columns tc + 16kk of dQ.
template <typename T, int BR, int BC, int DMAX>
__global__ void __launch_bounds__(kThreads) dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ drow,
    const int* __restrict__ row_lens, T* __restrict__ dq, int Tq, int S,
    int H, int n_kv, int D, int q_offset, float scale) {
  constexpr int RI = BR / 16;    // query rows per thread
  constexpr int CJ = BC / 16;    // keys per thread
  constexpr int DK = DMAX / 16;  // dQ columns per thread (at most)
  const int b = blockIdx.x / n_kv;
  const int h = blockIdx.x % n_kv;
  const int G = H / n_kv;
  const int R = Tq * G;
  const int r0 = blockIdx.y * BR;
  const int tr = threadIdx.x >> 4;
  const int tc = threadIdx.x & 15;
  const int dk = D / 16;

  extern __shared__ float smem[];
  float* qs = smem;                // [BR][D + 1]
  float* dos = qs + BR * (D + 1);  // [BR][D + 1]
  float* ks = dos + BR * (D + 1);  // [BC][D + 1]
  float* vs = ks + BC * (D + 1);   // [BC][D + 1]
  float* dss = vs + BC * (D + 1);  // [BR][BC + 1]

  load_qrows(qs, q, b, h, r0, BR, R, Tq, H, G, D);
  load_qrows(dos, dout, b, h, r0, BR, R, Tq, H, G, D);

  // the reference's skip rule: key tiles at or before the block's last
  // query and before row_len; none for a row with row_len == 0
  const int row_len = row_lens[b];
  const int t_last = (min(r0 + BR, R) - 1) / G;
  const int walk = min(S, min(q_offset + t_last + 1, row_len));

  int q_pos[RI];
  float lse_r[RI], drow_r[RI];
  bool row_ok[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = r0 + tr + 16 * i;
    row_ok[i] = r < R;
    q_pos[i] = q_offset + r / G;
    lse_r[i] = row_ok[i] ? lse[(size_t)blockIdx.x * R + r] : 0.f;
    drow_r[i] = row_ok[i] ? drow[(size_t)blockIdx.x * R + r] : 0.f;
  }

  float acc[RI][DK];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) acc[i][kk] = 0.f;

  for (int s0 = 0; s0 < walk; s0 += BC) {
    __syncthreads();  // Q/dO are in; the last tile is done with ks/vs/dss
    load_keys(ks, k, b, h, s0, BC, S, n_kv, D);
    load_keys(vs, v, b, h, s0, BC, S, n_kv, D);
    __syncthreads();

    float s[RI][CJ], dp[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[RI], ov[RI], kv[CJ], vv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        qv[i] = qs[(tr + 16 * i) * (D + 1) + d];
        ov[i] = dos[(tr + 16 * i) * (D + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        kv[j] = ks[(tc + 16 * j) * (D + 1) + d];
        vv[j] = vs[(tc + 16 * j) * (D + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

    // P from the saved lse, dS, rounded to the key dtype, to shared
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int p = s0 + tc + 16 * j;
        const bool ok = row_ok[i] && p < S && p <= q_pos[i] && p < row_len;
        const float pr = ok ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        dss[(tr + 16 * i) * (BC + 1) + tc + 16 * j] =
            round_to<T>(pr * (dp[i][j] - drow_r[i]));
      }
    __syncthreads();

    // dQ += dS . K for rows tr + 16i, columns tc + 16kk
    for (int j = 0; j < BC; ++j) {
      float dsv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) dsv[i] = dss[(tr + 16 * i) * (BC + 1) + j];
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        if (kk < dk) {
          const float kj = ks[j * (D + 1) + tc + 16 * kk];
#pragma unroll
          for (int i = 0; i < RI; ++i) acc[i][kk] = fmaf(dsv[i], kj, acc[i][kk]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    if (!row_ok[i]) continue;
    const int r = r0 + tr + 16 * i;
    const int t = r / G, g = r % G;
    T* dst = dq + ((size_t)(b * Tq + t) * H + h * G + g) * D;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      if (kk < dk) dst[tc + 16 * kk] = from_f<T>(acc[i][kk] * scale);
    }
  }
}

// dK/dV: grid (B * n_kv, ceil(S / BC)). Thread (tr, tc) holds keys
// tr + 16i and, per query row tile, rows tc + 16j of the transposed
// scores, and output columns tc + 16kk of dK and dV.
template <typename T, int BR, int BC, int DMAX>
__global__ void __launch_bounds__(kThreads) dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ drow,
    const int* __restrict__ row_lens, T* __restrict__ dk_out,
    T* __restrict__ dv_out, int Tq, int S, int H, int n_kv, int D,
    int q_offset, float scale) {
  constexpr int KI = BC / 16;    // keys per thread
  constexpr int RJ = BR / 16;    // query rows per thread
  constexpr int DK = DMAX / 16;  // output columns per thread (at most)
  const int b = blockIdx.x / n_kv;
  const int h = blockIdx.x % n_kv;
  const int G = H / n_kv;
  const int R = Tq * G;
  const int s0 = blockIdx.y * BC;
  const int tr = threadIdx.x >> 4;
  const int tc = threadIdx.x & 15;
  const int dk = D / 16;

  extern __shared__ float smem[];
  float* ks = smem;                  // [BC][D + 1]
  float* vs = ks + BC * (D + 1);     // [BC][D + 1]
  float* qs = vs + BC * (D + 1);     // [BR][D + 1]
  float* dos = qs + BR * (D + 1);    // [BR][D + 1]
  float* ps = dos + BR * (D + 1);    // [BC][BR + 1], P^T rounded
  float* dss = ps + BC * (BR + 1);   // [BC][BR + 1], dS^T rounded
  float* lse_s = dss + BC * (BR + 1);  // [BR]
  float* drow_s = lse_s + BR;          // [BR]

  load_keys(ks, k, b, h, s0, BC, S, n_kv, D);
  load_keys(vs, v, b, h, s0, BC, S, n_kv, D);

  const int row_len = row_lens[b];
  int key[KI];
#pragma unroll
  for (int i = 0; i < KI; ++i) key[i] = s0 + tr + 16 * i;

  float gk[KI][DK], gv[KI][DK];
#pragma unroll
  for (int i = 0; i < KI; ++i)
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) gk[i][kk] = gv[i][kk] = 0.f;

  // the row tiles that can see this key tile: s0 <= q_offset + their
  // last query and s0 < row_len (none for a row with row_len == 0)
  const int live = s0 < row_len;
  for (int r0 = 0; live && r0 < R; r0 += BR) {
    const int t_last = (min(r0 + BR, R) - 1) / G;
    if (q_offset + t_last < s0) continue;
    __syncthreads();  // the last tile is done with qs/dos/ps/dss
    load_qrows(qs, q, b, h, r0, BR, R, Tq, H, G, D);
    load_qrows(dos, dout, b, h, r0, BR, R, Tq, H, G, D);
    for (int c = threadIdx.x; c < BR; c += kThreads) {
      const int r = r0 + c;
      lse_s[c] = r < R ? lse[(size_t)blockIdx.x * R + r] : 0.f;
      drow_s[c] = r < R ? drow[(size_t)blockIdx.x * R + r] : 0.f;
    }
    __syncthreads();

    float st[KI][RJ], dpt[KI][RJ];
#pragma unroll
    for (int i = 0; i < KI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) st[i][j] = dpt[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float kv[KI], vv[KI], qv[RJ], ov[RJ];
#pragma unroll
      for (int i = 0; i < KI; ++i) {
        kv[i] = ks[(tr + 16 * i) * (D + 1) + d];
        vv[i] = vs[(tr + 16 * i) * (D + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        qv[j] = qs[(tc + 16 * j) * (D + 1) + d];
        ov[j] = dos[(tc + 16 * j) * (D + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < KI; ++i)
#pragma unroll
        for (int j = 0; j < RJ; ++j) {
          st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
          dpt[i][j] = fmaf(vv[i], ov[j], dpt[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < KI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        const int rl = tc + 16 * j;
        const int r = r0 + rl;
        const int p = key[i];
        const bool ok =
            r < R && p < S && p <= q_offset + r / G && p < row_len;
        const float pr = ok ? expf(st[i][j] * scale - lse_s[rl]) : 0.f;
        ps[(tr + 16 * i) * (BR + 1) + rl] = round_to<T>(pr);
        dss[(tr + 16 * i) * (BR + 1) + rl] =
            round_to<T>(pr * (dpt[i][j] - drow_s[rl]));
      }
    __syncthreads();

    // dV += P^T . dO, dK += dS^T . Q for keys tr + 16i, columns tc + 16kk
    for (int rl = 0; rl < BR; ++rl) {
      float pv[KI], dsv[KI];
#pragma unroll
      for (int i = 0; i < KI; ++i) {
        pv[i] = ps[(tr + 16 * i) * (BR + 1) + rl];
        dsv[i] = dss[(tr + 16 * i) * (BR + 1) + rl];
      }
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        if (kk < dk) {
          const float ov = dos[rl * (D + 1) + tc + 16 * kk];
          const float qv = qs[rl * (D + 1) + tc + 16 * kk];
#pragma unroll
          for (int i = 0; i < KI; ++i) {
            gv[i][kk] = fmaf(pv[i], ov, gv[i][kk]);
            gk[i][kk] = fmaf(dsv[i], qv, gk[i][kk]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < KI; ++i) {
    if (key[i] >= S) continue;
    const size_t row = (((size_t)b * S + key[i]) * n_kv + h) * D;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      if (kk < dk) {
        dk_out[row + tc + 16 * kk] = from_f<T>(gk[i][kk] * scale);
        dv_out[row + tc + 16 * kk] = from_f<T>(gv[i][kk]);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *drow, *row_lens;
  void *out0, *out1;
  int B, Tq, S, H, n_kv, D, q_offset;
  float scale;
};

template <typename T, int BR, int BC, int DMAX>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)(2 * BR + 2 * BC) * (a.D + 1) +
                                       (size_t)BR * (BC + 1));
  auto kern = dq_kernel<T, BR, BC, DMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int R = a.Tq * (a.H / a.n_kv);
  dim3 grid(a.B * a.n_kv, (R + BR - 1) / BR);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.drow),
      static_cast<const int*>(a.row_lens), static_cast<T*>(a.out0), a.Tq,
      a.S, a.H, a.n_kv, a.D, a.q_offset, a.scale);
  return cudaGetLastError();
}

template <typename T, int BR, int BC, int DMAX>
cudaError_t launch_dkv(const Args& a, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(2 * BR + 2 * BC) * (a.D + 1) +
                       2 * (size_t)BC * (BR + 1) + 2 * (size_t)BR);
  auto kern = dkv_kernel<T, BR, BC, DMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.B * a.n_kv, (a.S + BC - 1) / BC);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.drow),
      static_cast<const int*>(a.row_lens), static_cast<T*>(a.out0),
      static_cast<T*>(a.out1), a.Tq, a.S, a.H, a.n_kv, a.D, a.q_offset,
      a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(bool dkv, const Args& a, cudaStream_t stream) {
  if (a.D <= 128)
    return dkv ? launch_dkv<T, 64, 64, 128>(a, stream)
               : launch_dq<T, 64, 64, 128>(a, stream);
  return dkv ? launch_dkv<T, 32, 32, 256>(a, stream)
             : launch_dq<T, 32, 32, 256>(a, stream);
}

int run(bool dkv, const Args& a, int dtype, void* stream) {
  if (a.B <= 0 || a.Tq <= 0 || a.S <= 0) return cudaSuccess;
  if (a.n_kv <= 0 || a.H % a.n_kv || a.D % 16 || a.D > 256 || a.q_offset < 0)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(dkv, a, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(dkv, a, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO and the outputs alike);
// lse and drow f32 [B * n_kv, T * G]; row_lens i32 [B].
extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* drow,
                                   const void* row_lens, void* dq, int B,
                                   int T, int S, int H, int n_kv, int D,
                                   int q_offset, float scale, int dtype,
                                   void* stream) {
  const Args a{q, k, v, dout, lse, drow, row_lens, dq, nullptr,
               B, T, S, H, n_kv, D, q_offset, scale};
  return run(false, a, dtype, stream);
}

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* drow,
                                    const void* row_lens, void* dk, void* dv,
                                    int B, int T, int S, int H, int n_kv,
                                    int D, int q_offset, float scale,
                                    int dtype, void* stream) {
  const Args a{q, k, v, dout, lse, drow, row_lens, dk, dv,
               B, T, S, H, n_kv, D, q_offset, scale};
  return run(true, a, dtype, stream);
}

extern "C" const char* flash_backward_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
