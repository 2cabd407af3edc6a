// Fused (1,1,1) conv + folded BatchNorm + activation for Hopper (sm_90a).
//
// Replaces: pytorchvideo_accelerate_tpu/ops/pallas_fused.py `_pw_bn_act_kernel`
// (forward), and the dx of its custom VJP `_pw_bwd`, which ops/fused.py
// `PwBnAct.backward` launches as this kernel on wf^T with a zero bias. A
// pointwise NDHWC conv is a GEMM over rows M = B*T*H*W:
//     out[M, Cout] = act(x[M, Cin] @ wf[Cin, Cout] + b[Cout])
// with wf the BN-scale-folded weight in bf16, b the folded f32 bias, f32
// accumulation and one bf16 store.
//
// What bounds it on the card: a site does Cin*Cout/(Cin+Cout) FLOP per byte
// it must move, so at the main path's widths (8 to 2048) most sites sit
// under the H100's ~295 FLOP/byte ridge and are bound by bytes (read x once,
// write out once); the widest slow res4/res5 sites reach the tensor-core
// bound.
// What the design does about it: the tile engine of fused_gemm.cuh keeps
// the copies of two or three K steps in flight by cp.async while mma.sync
// works, and here its blocks are persistent, so the next tile's copies
// overlap this tile's epilogue at the short-K, byte-bound sites while the
// wide ones keep the tensor cores fed; ops/fused.py `gemm_plan` gives a
// narrow Cout (the fast pathway's 8 to 32, a dx row's narrow Cin) a narrow
// tile, so it does not compute 2-8x the useful products, and each x row is
// read from device memory once per BN-column tile (the blocks of one row
// tile run together and share it through L2). The output is written once,
// already biased and activated.
#include "fused_gemm.cuh"

namespace pva {

// the pointwise sites are short in K (8 to 2048) and many bound by bytes:
// persistent blocks overlap one tile's epilogue with the next tile's copies
constexpr bool PERSISTENT = true;

// A tile of dense x rows: each thread copies one 8-column group of
// T::A_PASSES rows a step (rows past M, columns past K zero-filled)
template <typename T>
struct PwRows {
  const bf16* x;
  int K;
  int row_off[T::A_PASSES];  // m * K, or -1 past M
  int k;                     // this thread's column of the next step

  int M;

  __device__ PwRows(const bf16* x_, int M_, int K_) : x(x_), K(K_), M(M_) {}

  // the next step is K step 0 of the row tile at m0
  __device__ __forceinline__ void reset(int m0) {
    k = (threadIdx.x % T::GROUPS) * 8;
#pragma unroll
    for (int i = 0; i < T::A_PASSES; ++i) {
      const int m = m0 + threadIdx.x / T::GROUPS + i * T::A_ROWS;
      row_off[i] = m < M ? m * K : -1;
    }
  }

  template <int PATH>
  __device__ __forceinline__ void load(bf16* As) {
    const int r0 = threadIdx.x / T::GROUPS, col = (threadIdx.x % T::GROUPS) * 8;
#pragma unroll
    for (int i = 0; i < T::A_PASSES; ++i) {
      const bool ok = row_off[i] >= 0 && k < K;
      copy8<PATH>(As + (r0 + i * T::A_ROWS) * T::A_LD + col,
                  x + (ok ? (size_t)row_off[i] + k : 0), x, ok, K - k);
    }
    k += T::BK;
  }
};

template <int CONFIG>
__global__ void __launch_bounds__(Config<CONFIG>::Tile::THREADS, Config<CONFIG>::Tile::MIN_BLOCKS)
fused_pw_bn_act_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                       const float* __restrict__ bias, bf16* __restrict__ out, int M, int K,
                       int N, int act) {
  using Cfg = Config<CONFIG>;
  PwRows<typename Cfg::Tile> a(x, M, K);
  gemm_bias_act<Cfg, PERSISTENT>(a, w, bias, out, M, K, N, act);
}

}  // namespace pva

// C entry points (bound with ctypes). Pointers are device pointers; `stream`
// is the caller's cudaStream_t; `config` is a tile * 3 + path id of
// fused_gemm.cuh (ops/fused.py `gemm_plan`), and the caller guarantees its
// path's alignment. Launches asynchronously, allocates nothing, and returns
// cudaGetLastError() (cudaErrorInvalidValue for an unknown config), so a
// refused launch reaches the caller.
extern "C" int pva_fused_pw_bn_act(const void* x, const void* w, const void* bias, void* out,
                                   int M, int K, int N, int act, int config, void* stream) {
  return pva::with_config(config, [&](auto id) {
    constexpr int C = decltype(id)::value;
    return pva::launch<pva::Config<C>, pva::PERSISTENT>(pva::fused_pw_bn_act_kernel<C>, M, N,
                            static_cast<cudaStream_t>(stream),
                            static_cast<const pva::bf16*>(x), static_cast<const pva::bf16*>(w),
                            static_cast<const float*>(bias), static_cast<pva::bf16*>(out), M, K,
                            N, act);
  });
}

// Build facts of one configuration: out[4] = registers a thread, local
// memory a thread (bytes; spills), the dynamic shared memory a block
// launches with, resident blocks per SM. `kernel` 0 names this source's
// kernel (1 is fused_conv_bn_act.cu's).
extern "C" int pva_fused_gemm_attrs(int kernel, int config, int* out) {
  if (kernel != 0) return static_cast<int>(cudaErrorInvalidValue);
  return pva::with_config(config, [&](auto id) {
    using Cfg = pva::Config<decltype(id)::value>;
    return pva_mma::attrs_of(pva::fused_pw_bn_act_kernel<decltype(id)::value>, Cfg::Tile::THREADS,
                             Cfg::Tile::smem_bytes(pva::PERSISTENT), out);
  });
}
