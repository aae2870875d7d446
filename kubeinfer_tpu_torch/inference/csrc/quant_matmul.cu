// Fused int8-weight matmul for Hopper (sm_90a): kernel #15.
//
// Replaces kubeinfer_tpu/inference/weight_quant.py:quant_matmul (body
// _quant_matmul_kernel): out[M, N] = (x[M, K] @ qw[K, N]) * scale[N],
// with the int8 codes converted to the activation type (exact: |q| <=
// 127), f32 accumulation, and the per-column f32 scale applied to the
// f32 sum in the epilogue, cast once to x's dtype. Plain PyTorch version:
// kubeinfer_tpu_torch/inference/weight_quant.py:quant_matmul_plain
// ((x.float() @ qw.float()) * scale, cast once), which this kernel
// matches within a stated tolerance (the sums run in another order).
// Ragged M, N and K are masked.
//
// The shapes it serves: since quant_matmul_tc.cu (wgmma + TMA) took
// every bf16 call with K % 16 == 0, N % 16 == 0 and 16-byte aligned x
// and qw (weight_quant.qmm_route: every llama-3-8b projection), this
// file runs the other bf16 calls (a ragged N or K, an x view at an odd
// offset) and every f32 call. chip_smoke.py times its bf16 kernel beside
// the tensor-core one on the same calls (old_qmm).
//
// Bound on this card, and the design. The shapes of the serving path
// span two orders of magnitude:
// - decode (M = 8 rows) is bound by bytes: each launch streams the whole
//   int8 weight once (58.7 MB for a 4096 x 14336 projection, 0.0175 ms
//   at 3.35 TB/s). The bf16 instantiation takes a 16-row M tile there
//   (one m16 MMA: 2x padding, not the 8-16x of a 64- or 128-row tile)
//   with 64-deep K tiles, and splits K over blocks when the (M, N) tiles
//   alone would leave most SMs idle; the f32 partial sums of the splits
//   are added in split order by a second, small pass that applies the
//   scale. The next K tile's weight bytes are in flight while the
//   current one is multiplied.
// - prefill (M = 512 at an admit, 2048 in the engine route's chunks) is
//   bound by operations (2 M N K; 240.5 GFLOP for a 2048-row gate
//   projection, 0.243 ms at 989 TFLOP/s). The bf16 instantiation runs on
//   the tensor cores with mma.sync.m16n8k16 (bf16 in, f32 accumulators)
//   over 64- or 128-row by 128-column tiles, two shared-memory stages:
//   the x tile arrives by cp.async, the int8 weight tile through
//   registers (loaded one tile ahead, converted to bf16 and stored
//   k-major), and ldmatrix (.trans for the weight) feeds the fragments.
// The f32 instantiation runs on the CUDA cores in full f32 (never TF32):
// 64 x 64 tiles, 256 threads, 4 x 4 outputs each. wgmma, TMA and a
// persistent schedule are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// 16 bytes global -> shared without registers; src_bytes 0 fills zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// One (BM x BN) output tile over the K range of split blockIdx.z, with
// WM x WN warps. With ws == nullptr the epilogue applies the scale and
// writes out; otherwise it writes the f32 partial sums to ws[blockIdx.z].
template <int BM, int BN, int BK, int WM, int WN>
__global__ void __launch_bounds__(WM * WN * 32) qmm_bf16_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
    float* __restrict__ ws, int M, int N, int K, int k_per_split,
    bool vec) {
  constexpr int kThreads = WM * WN * 32;
  constexpr int kWTM = BM / WM, kWTN = BN / WN;  // a warp's tile
  constexpr int kFM = kWTM / 16, kFN = kWTN / 8;
  static_assert(kFN % 2 == 0, "weight fragments load two n8 tiles at once");
  constexpr int kLdA = BK + 8;  // x tile row stride, bf16 values
  constexpr int kLdB = BN + 8;  // weight tile row stride (k-major)
  constexpr int kChunksA = BM * BK / 8;   // 16-byte chunks of the x tile
  constexpr int kChunksB = BK * BN / 16;  // 16-code chunks of the weight
  constexpr int kPerB = (kChunksB + kThreads - 1) / kThreads;

  __shared__ __align__(16) __nv_bfloat16 As[2][BM * kLdA];  // [m][k]
  __shared__ __align__(16) __nv_bfloat16 Bs[2][BK * kLdB];  // [k][n]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, tg = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);

  // the x tile at k0 into stage s (cp.async on the vector path)
  auto load_a = [&](int s, int k0) {
    for (int c = tid; c < kChunksA; c += kThreads) {
      const int r = c / (BK / 8), kk = (c % (BK / 8)) * 8;
      const int m = m0 + r, k = k0 + kk;
      __nv_bfloat16* dst = &As[s][r * kLdA + kk];
      if (vec) {
        const bool in = m < M && k < k_end;  // k_end % 8 == 0 here
        cp_async16(dst, in ? xs + (size_t)m * K + k : xs, in ? 16 : 0);
      } else {
        union {
          uint4 u;
          unsigned short h[8];
        } val;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          val.h[i] = m < M && k + i < k_end ? xs[(size_t)m * K + k + i] : 0;
        *reinterpret_cast<uint4*>(dst) = val.u;
      }
    }
  };
  // the weight tile at k0 into registers
  union Codes {
    int4 u;
    int8_t q[16];
  };
  auto load_b = [&](Codes* regs, int k0) {
#pragma unroll
    for (int i = 0; i < kPerB; ++i) {
      const int c = tid + i * kThreads;
      regs[i].u = make_int4(0, 0, 0, 0);
      if (c >= kChunksB) continue;
      const int kk = c / (BN / 16), nn = (c % (BN / 16)) * 16;
      const int k = k0 + kk, n = n0 + nn;
      if (k >= k_end) continue;
      if (vec && n + 16 <= N) {
        regs[i].u = __ldg(reinterpret_cast<const int4*>(w + (size_t)k * N + n));
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          regs[i].q[j] = n + j < N ? w[(size_t)k * N + n + j] : 0;
      }
    }
  };
  // registers -> stage s, converted to bf16 (exact), k-major
  auto store_b = [&](int s, const Codes* regs) {
#pragma unroll
    for (int i = 0; i < kPerB; ++i) {
      const int c = tid + i * kThreads;
      if (c >= kChunksB) continue;
      const int kk = c / (BN / 16), nn = (c % (BN / 16)) * 16;
      union {
        uint4 u[2];
        uint32_t pair[8];
      } v;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(
            static_cast<float>(regs[i].q[2 * j]),
            static_cast<float>(regs[i].q[2 * j + 1]));
        v.pair[j] = *reinterpret_cast<const uint32_t*>(&h);
      }
      uint4* dst = reinterpret_cast<uint4*>(&Bs[s][kk * kLdB + nn]);
      dst[0] = v.u[0];
      dst[1] = v.u[1];
    }
  };

  float acc[kFM][kFN][4];
#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  Codes breg[kPerB];
  if (k_begin < k_end) {
    load_a(0, k_begin);
    cp_async_commit();
    load_b(breg, k_begin);
    store_b(0, breg);
    cp_async_wait_all();
  }
  __syncthreads();

  int s = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += BK, s ^= 1) {
    const bool more = k0 + BK < k_end;
    if (more) {  // the next tile's bytes fly while this one multiplies
      load_a(s ^ 1, k0 + BK);
      cp_async_commit();
      load_b(breg, k0 + BK);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[kFM][4], b[kFN][2];
#pragma unroll
      for (int i = 0; i < kFM; ++i)
        ldsm_x4(a[i], &As[s][(wm * kWTM + i * 16 + (lane & 15)) * kLdA + kk +
                            (lane >> 4) * 8]);
#pragma unroll
      for (int j = 0; j < kFN; j += 2) {
        uint32_t r[4];
        ldsm_x4_trans(r, &Bs[s][(kk + (lane & 15)) * kLdB + wn * kWTN +
                                j * 8 + (lane >> 4) * 8]);
        b[j][0] = r[0];
        b[j][1] = r[1];
        b[j + 1][0] = r[2];
        b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < kFM; ++i)
#pragma unroll
        for (int j = 0; j < kFN; ++j) mma_bf16(acc[i][j], a[i], b[j]);
    }
    if (more) store_b(s ^ 1, breg);
    cp_async_wait_all();
    __syncthreads();
  }

  // accumulator fragment: rows g and g + 8, columns 2 tg and 2 tg + 1
#pragma unroll
  for (int i = 0; i < kFM; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + wm * kWTM + i * 16 + g + (e >> 1) * 8;
        const int c = n0 + wn * kWTN + j * 8 + tg * 2 + (e & 1);
        if (r >= M || c >= N) continue;
        if (ws != nullptr) {
          ws[((size_t)blockIdx.z * M + r) * N + c] = acc[i][j][e];
        } else {
          out[(size_t)r * N + c] = __float2bfloat16_rn(acc[i][j][e] * scale[c]);
        }
      }
}

// the split-K second pass: partial sums added in split order, then the
// scale, cast once
template <typename T>
__global__ void qmm_reduce_kernel(const float* __restrict__ ws,
                                  const float* __restrict__ scale,
                                  T* __restrict__ out, int M, int N,
                                  int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)M * N;
  if (i >= total) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += ws[z * total + i];
  const float v = s * scale[i % N];
  if constexpr (sizeof(T) == 4) {
    out[i] = v;
  } else {
    out[i] = __float2bfloat16_rn(v);
  }
}

// f32 activations on the CUDA cores: 64 x 64 output tiles, 256 threads,
// thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j
constexpr int kF32Threads = 256;
constexpr int kFB = 64, kFK = 16;

__global__ void __launch_bounds__(kF32Threads) qmm_f32_kernel(
    const float* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, float* __restrict__ out, int M, int N,
    int K) {
  __shared__ float As[kFK][kFB + 4];  // [k][m]
  __shared__ float Bs[kFK][kFB];      // [k][n]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kFB, n0 = blockIdx.x * kFB;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kFK) {
    for (int idx = tid; idx < kFB * kFK; idx += kF32Threads) {
      const int r = idx / kFK, c = idx % kFK;
      const int m = m0 + r, k = k0 + c;
      As[c][r] = (m < M && k < K) ? x[(size_t)m * K + k] : 0.f;
    }
    for (int idx = tid; idx < kFK * kFB; idx += kF32Threads) {
      const int r = idx / kFB, c = idx % kFB;
      const int k = k0 + r, n = n0 + c;
      Bs[r][c] = (k < K && n < N) ? static_cast<float>(w[(size_t)k * N + n])
                                  : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (m < M && n < N) out[(size_t)m * N + n] = acc[i][j] * scale[n];
    }
}

// tiles (BM, BN, BK) and warps (WM, WN) of the bf16 instantiation; the
// wrapper's weight_quant.mma_tiles must name the same tiles
template <int BM, int BN, int BK, int WM, int WN>
cudaError_t launch_bf16(const void* x, const void* qw, const void* scale,
                        void* out, float* ws, int M, int N, int K,
                        int splits, cudaStream_t stream) {
  const int k_tiles = (K + BK - 1) / BK;
  splits = max(1, min(splits, k_tiles));
  const int per = (k_tiles + splits - 1) / splits * BK;
  const int used = (K + per - 1) / per;
  const bool vec = K % 8 == 0 && N % 16 == 0;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, used);
  qmm_bf16_kernel<BM, BN, BK, WM, WN><<<grid, WM * WN * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(qw),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out),
      used > 1 ? ws : nullptr, M, N, K, per, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || used == 1) return err;
  const size_t total = (size_t)M * N;
  qmm_reduce_kernel<__nv_bfloat16><<<(total + 255) / 256, 256, 0, stream>>>(
      ws, static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out),
      M, N, used);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. ws holds splits * M * N floats when
// splits > 1 (bf16 only; the f32 instantiation takes no split).
extern "C" int quant_matmul_launch(const void* x, const void* qw,
                                   const void* scale, void* out, void* ws,
                                   int M, int N, int K, int splits, int dtype,
                                   void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (K <= 0 || splits <= 0) return cudaErrorInvalidValue;
  if (dtype == 0) {
    dim3 grid((N + kFB - 1) / kFB, (M + kFB - 1) / kFB);
    qmm_f32_kernel<<<grid, kF32Threads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(qw),
        static_cast<const float*>(scale), static_cast<float*>(out), M, N, K);
    return cudaGetLastError();
  }
  if (dtype != 1) return cudaErrorInvalidValue;
  float* w = static_cast<float*>(ws);
  if (M <= 16)
    return launch_bf16<16, 128, 64, 1, 4>(x, qw, scale, out, w, M, N, K,
                                          splits, st);
  if (M <= 512)
    return launch_bf16<64, 128, 32, 2, 2>(x, qw, scale, out, w, M, N, K,
                                          splits, st);
  return launch_bf16<128, 128, 32, 2, 4>(x, qw, scale, out, w, M, N, K,
                                         splits, st);
}

extern "C" const char* quant_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
