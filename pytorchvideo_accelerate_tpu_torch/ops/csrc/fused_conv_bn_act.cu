// Fused stride-1 SAME 3D conv (odd taps) + folded BatchNorm + activation for
// Hopper (sm_90a).
//
// Replaces: pytorchvideo_accelerate_tpu/ops/pallas_fused.py `_conv_bn_act_kernel`
// (forward): act(conv3d_s1(x, wf) + b) over NDHWC x (B, T, H, W, Cin), wf
// (kt, kh, kw, Cin, Cout) BN-scale-folded bf16, b folded f32 bias, f32
// accumulation over all taps and one bf16 store.
//
// Implicit GEMM: rows are the M = B*T*H*W output positions, columns Cout, and
// the reduction runs over K = kt*kh*kw*Cin, tap-major (k = tap*Cin + c), which
// is the memory order of wf, so wf is read as a (K, Cout) row-major matrix.
// Each K step gathers, for every row of the tile, the input row shifted by the
// step's tap and writes zeros where that row lies outside the volume: the SAME
// padding is never materialised (the Pallas wrapper pads a copy of x first).
//
// What bounds it on the card: the (3,1,1) and (1,3,3) sites do 3 or 9 times
// the pointwise work on the same bytes; the slow-pathway (1,3,3) sites (64 to
// 512 channels, K = 576 to 4608) sit above the ~295 FLOP/byte ridge and are
// tensor-core bound, the narrow fast-pathway ones (8 to 64 channels) are bound
// by bytes.
// What the design does about it: the TPU kernel moves one halo window (tile +
// k-1 rows, full W, full Cin) into VMEM; at Cin = 1024 that window is ~2.6 MB
// and cannot fit a block's 227 KB of shared memory. Here the window is cut
// along K instead: a block keeps only a 64 x 32 slice of the gathered input
// and a 32 x 64 slice of wf in shared memory, the neighbouring taps' reloads
// of the same input rows are served mostly by L1/L2, and the output is
// written once, already biased and activated.
#include "fused_gemm.cuh"

namespace pva {

// each thread gathers two (row, 8-channel chunk) slots of the A tile per K
// step; rows r = threadIdx.x / 4 and r + 32, chunk column (threadIdx.x % 4) * 8
constexpr int ROWS_PER_THREAD = BM * BK / 8 / THREADS;  // 2

__global__ void __launch_bounds__(THREADS)
fused_conv_bn_act_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                         const float* __restrict__ bias, bf16* __restrict__ out,
                         int B, int T, int H, int W, int Cin, int N,
                         int kt, int kh, int kw, int act) {
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
  const int M = B * T * H * W;
  const int K = kt * kh * kw * Cin;
  const int pt = kt / 2, ph = kh / 2, pw = kw / 2;
  const bool vec = (Cin % 8) == 0;  // an 8-chunk then never straddles two taps

  // decode this thread's output rows once: (b, t, h, w) of each
  const int c_col = (threadIdx.x % (BK / 8)) * 8;
  int rb[ROWS_PER_THREAD], rt[ROWS_PER_THREAD], rh[ROWS_PER_THREAD], rw[ROWS_PER_THREAD];
  bool rvalid[ROWS_PER_THREAD];
#pragma unroll
  for (int j = 0; j < ROWS_PER_THREAD; ++j) {
    const int m = m0 + threadIdx.x / (BK / 8) + j * (THREADS / (BK / 8));
    rvalid[j] = m < M;
    const int mm = rvalid[j] ? m : 0;
    rw[j] = mm % W;
    int q = mm / W;
    rh[j] = q % H;
    q /= H;
    rt[j] = q % T;
    rb[j] = q / T;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int j = 0; j < ROWS_PER_THREAD; ++j) {
      const int r = threadIdx.x / (BK / 8) + j * (THREADS / (BK / 8));
      uint4 v = zero16();
      if (vec) {
        const int k = k0 + c_col;
        if (rvalid[j] && k < K) {
          const int tap = k / Cin;
          const int ci = k - tap * Cin;
          const int dw = tap % kw;
          const int dh = (tap / kw) % kh;
          const int dt = tap / (kw * kh);
          const int ti = rt[j] + dt - pt;
          const int hi = rh[j] + dh - ph;
          const int wi = rw[j] + dw - pw;
          if (ti >= 0 && ti < T && hi >= 0 && hi < H && wi >= 0 && wi < W) {
            const size_t off = ((((size_t)rb[j] * T + ti) * H + hi) * W + wi) * Cin + ci;
            v = *reinterpret_cast<const uint4*>(x + off);
          }
        }
      } else {
        __align__(16) bf16 tmp[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          tmp[e] = __float2bfloat16(0.f);
          const int k = k0 + c_col + e;
          if (!rvalid[j] || k >= K) continue;
          const int tap = k / Cin;
          const int ci = k - tap * Cin;
          const int dw = tap % kw;
          const int dh = (tap / kw) % kh;
          const int dt = tap / (kw * kh);
          const int ti = rt[j] + dt - pt;
          const int hi = rh[j] + dh - ph;
          const int wi = rw[j] + dw - pw;
          if (ti >= 0 && ti < T && hi >= 0 && hi < H && wi >= 0 && wi < W)
            tmp[e] = x[((((size_t)rb[j] * T + ti) * H + hi) * W + wi) * Cin + ci];
        }
        v = *reinterpret_cast<const uint4*>(tmp);
      }
      *reinterpret_cast<uint4*>(As + r * A_LD + c_col) = v;
    }
    load_w_tile(Bs, w, k0, n0, K, N);
    __syncthreads();
    mma_tile(As, Bs, wm, wn, acc);
    __syncthreads();
  }
  store_bias_act(Cs, wm, wn, acc, bias, out, m0, n0, M, N, act);
}

}  // namespace pva

// C entry point (bound with ctypes): x (B, T, H, W, Cin) and out (B, T, H, W,
// N) contiguous bf16, w (kt*kh*kw*Cin, N) contiguous bf16, bias (N,) f32.
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int pva_fused_conv_bn_act(const void* x, const void* w, const void* bias, void* out,
                                     int B, int T, int H, int W, int Cin, int N, int kt, int kh,
                                     int kw, int act, void* stream) {
  const int M = B * T * H * W;
  dim3 grid((M + pva::BM - 1) / pva::BM, (N + pva::BN - 1) / pva::BN);
  pva::fused_conv_bn_act_kernel<<<grid, pva::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const pva::bf16*>(x), static_cast<const pva::bf16*>(w),
      static_cast<const float*>(bias), static_cast<pva::bf16*>(out), B, T, H, W, Cin, N, kt, kh,
      kw, act);
  return static_cast<int>(cudaGetLastError());
}
