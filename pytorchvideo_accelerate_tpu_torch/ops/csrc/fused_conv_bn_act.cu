// Fused stride-1 SAME 3D conv (odd taps) + folded BatchNorm + activation for
// Hopper (sm_90a).
//
// Replaces: pytorchvideo_accelerate_tpu/ops/pallas_fused.py `_conv_bn_act_kernel`
// (forward): act(conv3d_s1(x, wf) + b) over NDHWC x (B, T, H, W, Cin), wf
// (kt, kh, kw, Cin, Cout) BN-scale-folded bf16, b folded f32 bias, f32
// accumulation over all taps and one bf16 store; and the dx of its custom
// VJP `_conv_bwd`, which ops/fused.py `ConvBnAct.backward` launches as this
// kernel on the tap-flipped, channel-transposed weights with a zero bias.
//
// Implicit GEMM: rows are the M = B*T*H*W output positions, columns Cout, and
// the reduction runs over K = kt*kh*kw*Cin, tap-major (k = tap*Cin + c), which
// is the memory order of wf, so wf is read as a (K, Cout) row-major matrix.
// Each K step gathers, for every row of the tile, the input row shifted by
// the step's taps and zero-fills (cp.async src-size 0) where that row lies
// outside the volume: the SAME padding is never materialised.
//
// What bounds it on the card: the (3,1,1) and (1,3,3) sites do 3 or 9 times
// the pointwise work on the same bytes; the slow pathway's sites (64 to 512
// channels, K = 576 to 6144) sit far above the ~295 FLOP/byte ridge and are
// bound by the tensor cores, the fast pathway's (8 to 32 channels) by bytes.
// What the design does about it: the TPU kernel moves one halo window (tile
// + k-1 rows, full W, full Cin) into VMEM; at Cin = 1024 that window is ~2.6
// MB and cannot fit a block's 227 KB of shared memory. Here the window is cut
// along K instead: the tile engine of fused_gemm.cuh keeps three or four
// BK-deep stages of the gathered input and of wf in shared memory, all but
// one in flight by cp.async while mma.sync runs the products of the other,
// with 128 x 128 tiles at the wide sites. The neighbouring taps'
// reloads of the same input rows are served by L1/L2. Each thread decodes
// its rows' (t, h, w) once; its column's (tap, channel) advances from step to
// step without a division.
#include "fused_gemm.cuh"

namespace pva {

// one tile a block: the gather's state would have to advance to the next
// tile inside the K loop; whether persistent blocks would pay here is not
// measured (no A/B of the two is recorded)
constexpr bool PERSISTENT = false;

// A tile gathered from x: each thread copies one 8-column group of
// T::A_PASSES rows a step. With Cin % 8 == 0 (16-byte path) the 8 columns
// lie in one tap; otherwise the group is cut into chunks of 2 (Cin even) or
// 1 and each chunk finds its own tap. A BK-deep step may straddle taps
// (Cin = 8 or 16 at BK = 32).
template <typename T>
struct ConvRows {
  const bf16* x;
  int Td, Hd, Wd, Cin, kt, kh, kw;
  int tt[T::A_PASSES], hh[T::A_PASSES], ww[T::A_PASSES];  // tt far negative past M
  int row_off[T::A_PASSES];                            // m * Cin: x's row at the output's position
  int c, dt, dh, dw;  // (channel, tap) of this thread's column at the next step

  int M;

  __device__ ConvRows(const bf16* x_, int Td_, int Hd_, int Wd_, int Cin_, int kt_, int kh_,
                      int kw_, int M_)
      : x(x_), Td(Td_), Hd(Hd_), Wd(Wd_), Cin(Cin_), kt(kt_), kh(kh_), kw(kw_), M(M_) {}

  // the next step is K step 0 of the row tile at m0: decode its rows once
  __device__ __forceinline__ void reset(int m0) {
#pragma unroll
    for (int i = 0; i < T::A_PASSES; ++i) {
      const int m = m0 + threadIdx.x / T::GROUPS + i * T::A_ROWS;
      const int mm = m < M ? m : 0;
      ww[i] = mm % Wd;
      int q = mm / Wd;
      hh[i] = q % Hd;
      q /= Hd;
      tt[i] = m < M ? q % Td : -(1 << 28);  // never inside the volume
      row_off[i] = mm * Cin;
    }
    c = dt = dh = dw = 0;
    advance(c, dt, dh, dw, (threadIdx.x % T::GROUPS) * 8);
  }

  // (c, tap) moved `by` columns along k = tap * Cin + c, taps in (dt, dh, dw)
  // order; dt reaches kt past K
  __device__ __forceinline__ void advance(int& c_, int& dt_, int& dh_, int& dw_, int by) const {
    c_ += by;
    while (c_ >= Cin) {
      c_ -= Cin;
      if (++dw_ == kw) {
        dw_ = 0;
        if (++dh_ == kh) {
          dh_ = 0;
          ++dt_;
        }
      }
    }
  }

  template <int PATH>
  __device__ __forceinline__ void load(bf16* As) {
    constexpr int V = chunk_elems<PATH>();
    const int r0 = threadIdx.x / T::GROUPS, col = (threadIdx.x % T::GROUPS) * 8;
    int sc = c, sdt = dt, sdh = dh, sdw = dw;
#pragma unroll
    for (int j = 0; j < 8; j += V) {
      if (j) advance(sc, sdt, sdh, sdw, V);
      const bool tap_ok = sdt < kt;
      const int ot = sdt - kt / 2, oh = sdh - kh / 2, ow = sdw - kw / 2;
      const int shift = ((ot * Hd + oh) * Wd + ow) * Cin + sc;
#pragma unroll
      for (int i = 0; i < T::A_PASSES; ++i) {
        const bool ok = tap_ok && static_cast<unsigned>(tt[i] + ot) < static_cast<unsigned>(Td) &&
                        static_cast<unsigned>(hh[i] + oh) < static_cast<unsigned>(Hd) &&
                        static_cast<unsigned>(ww[i] + ow) < static_cast<unsigned>(Wd);
        copy_chunk<PATH>(As + (r0 + i * T::A_ROWS) * T::A_LD + col + j,
                         x + (ok ? (long long)row_off[i] + shift : 0LL), x, ok);
      }
    }
    advance(c, dt, dh, dw, T::BK);
  }
};

// The 4-byte and plain-load gathers walk each chunk's own tap and do not fit
// the 8-warp tiles' 128 registers a thread: those paths give up the tile's
// blocks per SM rather than spill. No site of the main path takes them
// (every SlowFast and CSN conv has Cin % 8 == 0).
template <int CONFIG>
__global__ void __launch_bounds__(Config<CONFIG>::Tile::THREADS,
                                  Config<CONFIG>::PATH == PATH_CP16
                                      ? Config<CONFIG>::Tile::MIN_BLOCKS : 1)
fused_conv_bn_act_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                         const float* __restrict__ bias, bf16* __restrict__ out, int B, int Td,
                         int Hd, int Wd, int Cin, int N, int kt, int kh, int kw, int act) {
  using Cfg = Config<CONFIG>;
  const int M = B * Td * Hd * Wd;
  ConvRows<typename Cfg::Tile> a(x, Td, Hd, Wd, Cin, kt, kh, kw, M);
  gemm_bias_act<Cfg, PERSISTENT>(a, w, bias, out, M, kt * kh * kw * Cin, N, act);
}

}  // namespace pva

// C entry points (bound with ctypes): x (B, T, H, W, Cin) and out (B, T, H,
// W, N) contiguous bf16, w (kt*kh*kw*Cin, N) contiguous bf16, bias (N,) f32,
// odd taps; `config` is a tile * 3 + path id of fused_gemm.cuh (ops/fused.py
// `gemm_plan`), and the caller guarantees its path's alignment. Launches on
// `stream`, allocates nothing, returns cudaGetLastError()
// (cudaErrorInvalidValue for an unknown config).
extern "C" int pva_fused_conv_bn_act(const void* x, const void* w, const void* bias, void* out,
                                     int B, int T, int H, int W, int Cin, int N, int kt, int kh,
                                     int kw, int act, int config, void* stream) {
  return pva::with_config(config, [&](auto id) {
    constexpr int C = decltype(id)::value;
    return pva::launch<pva::Config<C>, pva::PERSISTENT>(pva::fused_conv_bn_act_kernel<C>, B * T * H * W, N,
                            static_cast<cudaStream_t>(stream),
                            static_cast<const pva::bf16*>(x), static_cast<const pva::bf16*>(w),
                            static_cast<const float*>(bias), static_cast<pva::bf16*>(out), B, T,
                            H, W, Cin, N, kt, kh, kw, act);
  });
}

// Build facts of one configuration (see fused_pw_bn_act.cu); `kernel` 1
// names this source's kernel.
extern "C" int pva_fused_gemm_attrs(int kernel, int config, int* out) {
  if (kernel != 1) return static_cast<int>(cudaErrorInvalidValue);
  return pva::with_config(config, [&](auto id) {
    using Cfg = pva::Config<decltype(id)::value>;
    return pva_mma::attrs_of(pva::fused_conv_bn_act_kernel<decltype(id)::value>, Cfg::Tile::THREADS,
                             Cfg::Tile::smem_bytes(pva::PERSISTENT), out);
  });
}
