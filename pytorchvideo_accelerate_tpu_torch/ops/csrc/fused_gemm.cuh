// Shared tile machinery of the fused conv + BN + act kernels
// (fused_pw_bn_act.cu, fused_conv_bn_act.cu).
//
// Both kernels are one GEMM shape: out[M, N] = act(A[M, K] @ Wf[K, N] + b[N])
// with bf16 operands, an f32 accumulator and one bf16 store. They differ only
// in how a block fills its A tile: the pointwise kernel reads dense rows, the
// conv kernel gathers shifted input rows (implicit im2col). This header holds
// the rest: tile sizes, the W-tile loader, the tensor-core step and the
// bias + act epilogue.
//
// Block: 128 threads (4 warps, 2 x 2), output tile BM x BN = 64 x 64, K step
// BK = 32. Each warp owns a 32 x 32 sub-tile = 2 x 2 WMMA bf16 16x16x16
// fragments accumulating in f32. The K loop is single-buffered (load, sync,
// mma, sync): simple first; cp.async/TMA pipelining and wgmma are later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace pva {

using bf16 = __nv_bfloat16;

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 128;
// padded leading dims (elements): multiples of 8 for WMMA 16-bit loads and of
// 4 for the f32 store, and off the 128-byte bank period
constexpr int A_LD = BK + 8;  // 40
constexpr int B_LD = BN + 8;  // 72
constexpr int C_LD = BN + 4;  // 68
constexpr int A_BYTES = BM * A_LD * 2;  // 5120
constexpr int B_BYTES = BK * B_LD * 2;  // 4608
constexpr int C_BYTES = BM * C_LD * 4;  // 17408
// the f32 epilogue tile reuses the operand tiles' storage
constexpr int SMEM_BYTES = (A_BYTES + B_BYTES) > C_BYTES ? (A_BYTES + B_BYTES) : C_BYTES;

enum Act { ACT_IDENTITY = 0, ACT_RELU = 1, ACT_SILU = 2 };

__device__ __forceinline__ float apply_act(float v, int act) {
  if (act == ACT_RELU) return fmaxf(v, 0.f);
  if (act == ACT_SILU) return v / (1.f + expf(-v));
  return v;
}

__device__ __forceinline__ uint4 zero16() { return make_uint4(0u, 0u, 0u, 0u); }

// W tile: rows k0..k0+BK of the (K, N) row-major folded weight, columns
// n0..n0+BN; zeros past K or N (this is what zero-pads a short K such as
// Cin = 8). 256 chunks of 8 bf16, two per thread.
__device__ __forceinline__ void load_w_tile(bf16* Bs, const bf16* __restrict__ w,
                                            int k0, int n0, int K, int N) {
  const bool vec = (N % 8) == 0;
  for (int idx = threadIdx.x; idx < BK * BN / 8; idx += THREADS) {
    const int r = idx / (BN / 8);
    const int c = (idx % (BN / 8)) * 8;
    const int k = k0 + r;
    const int n = n0 + c;
    uint4 v = zero16();
    if (vec) {
      if (k < K && n < N) v = *reinterpret_cast<const uint4*>(w + (size_t)k * N + n);
    } else {
      __align__(16) bf16 tmp[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        tmp[e] = (k < K && n + e < N) ? w[(size_t)k * N + n + e] : __float2bfloat16(0.f);
      v = *reinterpret_cast<const uint4*>(tmp);
    }
    *reinterpret_cast<uint4*>(Bs + r * B_LD + c) = v;
  }
}

// one BK step on the tensor cores: warp (wm, wn) multiplies its 32 rows of
// the A tile by its 32 columns of the W tile into acc
__device__ __forceinline__ void mma_tile(
    const bf16* As, const bf16* Bs, int wm, int wn,
    nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> (&acc)[2][2]) {
  using namespace nvcuda;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * A_LD + kk, A_LD);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::load_matrix_sync(b[j], Bs + kk * B_LD + wn * 32 + j * 16, B_LD);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
  }
}

// epilogue: accumulators -> shared f32 tile -> + bias, act, one bf16 store.
// Cs aliases the operand tiles, so the caller must have synchronised after
// its last mma_tile.
__device__ __forceinline__ void store_bias_act(
    float* Cs, int wm, int wn,
    nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> (&acc)[2][2],
    const float* __restrict__ bias, bf16* __restrict__ out, int m0, int n0, int M, int N,
    int act) {
  using namespace nvcuda;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * C_LD + wn * 32 + j * 16, acc[i][j],
                              C_LD, wmma::mem_row_major);
  __syncthreads();
  const bool vec = (N % 8) == 0;
  for (int idx = threadIdx.x; idx < BM * BN / 8; idx += THREADS) {
    const int r = idx / (BN / 8);
    const int c = (idx % (BN / 8)) * 8;
    const int m = m0 + r;
    const int n = n0 + c;
    if (m >= M || n >= N) continue;
    const float* src = Cs + r * C_LD + c;
    bf16* dst = out + (size_t)m * N + n;
    if (vec) {
      __align__(16) bf16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16(apply_act(src[e] + bias[n + e], act));
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
    } else {
      for (int e = 0; e < 8 && n + e < N; ++e)
        dst[e] = __float2bfloat16(apply_act(src[e] + bias[n + e], act));
    }
  }
}

}  // namespace pva
