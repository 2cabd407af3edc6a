// Fused (1,1,1) conv + folded BatchNorm + activation for Hopper (sm_90a).
//
// Replaces: pytorchvideo_accelerate_tpu/ops/pallas_fused.py `_pw_bn_act_kernel`
// (forward). A pointwise NDHWC conv is a GEMM over rows M = B*T*H*W:
//     out[M, Cout] = act(x[M, Cin] @ wf[Cin, Cout] + b[Cout])
// with wf the BN-scale-folded weight in bf16, b the folded f32 bias, f32
// accumulation and one bf16 store.
//
// What bounds it on the card: at the main path's widths (Cin, Cout from 8 to
// 2048) most sites do 2*Cin*Cout/(2*(Cin+Cout)) = Cin*Cout/(Cin+Cout) FLOP per
// byte moved, under the H100's ~295 FLOP/byte ridge, so the bytes (read x
// once, write out once) bound it; only the widest slow res4/res5 sites reach
// the tensor-core bound.
// What the design does about it: each x row is read from device memory once
// per 64-column tile of Cout and the result is written once, already biased
// and activated (no separate BN or activation pass over the tensor). The
// Pallas kernel's (256, Cin) VMEM row tile becomes a 64 x 64 output tile with
// a K loop through shared memory, so any Cin fits in 227 KB; a short K (Cin =
// 8 on the fast pathway) is zero-padded in shared memory, never read out of
// bounds.
#include "fused_gemm.cuh"

namespace pva {

__global__ void __launch_bounds__(THREADS)
fused_pw_bn_act_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                       const float* __restrict__ bias, bf16* __restrict__ out,
                       int M, int K, int N, int act) {
  using namespace nvcuda;
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = reinterpret_cast<bf16*>(smem + A_BYTES);
  float* Cs = reinterpret_cast<float*>(smem);

  const int warp = threadIdx.x / 32;
  const int wm = warp / 2;
  const int wn = warp % 2;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const bool vec = (K % 8) == 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile: 64 rows x 32 columns of x = 256 chunks of 8 bf16, two per thread
    for (int idx = threadIdx.x; idx < BM * BK / 8; idx += THREADS) {
      const int r = idx / (BK / 8);
      const int c = (idx % (BK / 8)) * 8;
      const int m = m0 + r;
      const int k = k0 + c;
      uint4 v = zero16();
      if (vec) {
        if (m < M && k < K) v = *reinterpret_cast<const uint4*>(x + (size_t)m * K + k);
      } else {
        __align__(16) bf16 tmp[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          tmp[e] = (m < M && k + e < K) ? x[(size_t)m * K + k + e] : __float2bfloat16(0.f);
        v = *reinterpret_cast<const uint4*>(tmp);
      }
      *reinterpret_cast<uint4*>(As + r * A_LD + c) = v;
    }
    load_w_tile(Bs, w, k0, n0, K, N);
    __syncthreads();
    mma_tile(As, Bs, wm, wn, acc);
    __syncthreads();
  }
  store_bias_act(Cs, wm, wn, acc, bias, out, m0, n0, M, N, act);
}

}  // namespace pva

// C entry point (bound with ctypes). Pointers are device pointers; `stream` is
// the caller's cudaStream_t. Launches asynchronously, allocates nothing, and
// returns cudaGetLastError() so a refused launch is reported to the caller.
extern "C" int pva_fused_pw_bn_act(const void* x, const void* w, const void* bias, void* out,
                                   int M, int K, int N, int act, void* stream) {
  dim3 grid((M + pva::BM - 1) / pva::BM, (N + pva::BN - 1) / pva::BN);
  pva::fused_pw_bn_act_kernel<<<grid, pva::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const pva::bf16*>(x), static_cast<const pva::bf16*>(w),
      static_cast<const float*>(bias), static_cast<pva::bf16*>(out), M, K, N, act);
  return static_cast<int>(cudaGetLastError());
}
