// Depthwise stride-1 SAME 3D convolution for Hopper (sm_90a): one stencil,
// two entry points.
//
// Replaces:
//   pva_fused_dw_bn_act  pytorchvideo_accelerate_tpu/ops/pallas_fused.py
//                        `_dw_bn_act_kernel`: act(dwconv(x, kf) + b), kf the
//                        BN-scale-folded taps in bf16, b the folded f32 bias,
//                        act identity | relu | silu
//   pva_depthwise3d_s1   pytorchvideo_accelerate_tpu/ops/pallas_depthwise.py
//                        `_dw_kernel`: dwconv(x, k), no bias, no act
// with x (B, T, H, W, C) NDHWC bf16, taps (kt, kh, kw, C) bf16 (odd sizes),
// SAME padding k//2, f32 accumulation in tap order (dt, dh, dw), the bias and
// the act on the f32 sum, and one bf16 store. The backward's dx of both is
// this stencil against the tap-flipped taps (ops/fused.py DwBnAct,
// ops/depthwise.py Depthwise3dS1).
//
// What bounds it on the card: 2 * taps FLOP per output element against one
// bf16 read and one bf16 write (13.5 FLOP/byte at 27 taps), far under the
// H100's ~295 FLOP/byte ridge: the bytes bound it.
// What the design does about it: the Pallas kernel DMAs a halo window (tile +
// k-1, full W and C) of a pre-padded copy of x into VMEM; here nothing is
// padded or staged. One thread computes one output element, consecutive
// threads on consecutive channels, so each tap's load by a warp is one
// contiguous run of x (NDHWC), and the neighbouring threads' reuse of an input
// element across taps hits L1/L2; taps that fall outside the volume are
// skipped, so the SAME padding is never read or materialised. Any C works,
// the ragged channel tail included (X3D's 54). The common tap shapes (3,3,3)
// and (5,1,1) are compiled with their loops unrolled. Shared-memory halo
// tiles and vector loads are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace pva {

using bf16 = __nv_bfloat16;

constexpr int DW_THREADS = 256;

__device__ __forceinline__ float dw_act(float v, int act) {
  if (act == 1) return fmaxf(v, 0.f);
  if (act == 2) return v / (1.f + expf(-v));
  return v;
}

// KT/KH/KW > 0: tap sizes fixed at compile time; 0: taken from kt/kh/kw.
template <int KT, int KH, int KW>
__global__ void __launch_bounds__(DW_THREADS)
depthwise3d_kernel(const bf16* __restrict__ x, const bf16* __restrict__ k,
                   const float* __restrict__ bias, bf16* __restrict__ out,
                   int total, int T, int H, int W, int C, int kt, int kh, int kw,
                   int act) {
  const int idx = blockIdx.x * DW_THREADS + threadIdx.x;
  if (idx >= total) return;
  const int nt = KT > 0 ? KT : kt;
  const int nh = KH > 0 ? KH : kh;
  const int nw = KW > 0 ? KW : kw;
  const int c = idx % C;
  int p = idx / C;
  const int w = p % W;
  p /= W;
  const int h = p % H;
  p /= H;
  const int t = p % T;
  const int b = p / T;
  const int t0 = t - nt / 2, h0 = h - nh / 2, w0 = w - nw / 2;
  float acc = 0.f;
#pragma unroll
  for (int dt = 0; dt < nt; ++dt) {
    const int ti = t0 + dt;
    if (ti < 0 || ti >= T) continue;
#pragma unroll
    for (int dh = 0; dh < nh; ++dh) {
      const int hi = h0 + dh;
      if (hi < 0 || hi >= H) continue;
      const bf16* row = x + (((b * T + ti) * H + hi) * W) * C + c;
      const bf16* taps = k + ((dt * nh + dh) * nw) * C + c;
#pragma unroll
      for (int dw = 0; dw < nw; ++dw) {
        const int wi = w0 + dw;
        if (wi < 0 || wi >= W) continue;
        acc = fmaf(__bfloat162float(row[wi * C]), __bfloat162float(taps[dw * C]), acc);
      }
    }
  }
  if (bias != nullptr) acc += bias[c];
  out[idx] = __float2bfloat16(dw_act(acc, act));
}

inline int launch(const void* x, const void* k, const void* bias, void* out, int B, int T,
                  int H, int W, int C, int kt, int kh, int kw, int act, void* stream) {
  const int total = B * T * H * W * C;
  const dim3 grid((total + DW_THREADS - 1) / DW_THREADS);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* kp = static_cast<const bf16*>(k);
  const float* bp = static_cast<const float*>(bias);
  bf16* op = static_cast<bf16*>(out);
  if (kt == 3 && kh == 3 && kw == 3)
    depthwise3d_kernel<3, 3, 3><<<grid, DW_THREADS, 0, s>>>(xp, kp, bp, op, total, T, H, W, C,
                                                            kt, kh, kw, act);
  else if (kt == 5 && kh == 1 && kw == 1)
    depthwise3d_kernel<5, 1, 1><<<grid, DW_THREADS, 0, s>>>(xp, kp, bp, op, total, T, H, W, C,
                                                            kt, kh, kw, act);
  else
    depthwise3d_kernel<0, 0, 0><<<grid, DW_THREADS, 0, s>>>(xp, kp, bp, op, total, T, H, W, C,
                                                            kt, kh, kw, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pva

// C entry points (bound with ctypes). x and out (B, T, H, W, C) contiguous
// bf16, k (kt*kh*kw, C) contiguous bf16, bias (C,) f32; B*T*H*W*C < 2**31
// (the wrapper checks). Launch on `stream`, allocate nothing, return
// cudaGetLastError() so a refused launch reaches the caller.
extern "C" int pva_fused_dw_bn_act(const void* x, const void* kf, const void* bias, void* out,
                                   int B, int T, int H, int W, int C, int kt, int kh, int kw,
                                   int act, void* stream) {
  return pva::launch(x, kf, bias, out, B, T, H, W, C, kt, kh, kw, act, stream);
}

extern "C" int pva_depthwise3d_s1(const void* x, const void* k, void* out, int B, int T, int H,
                                  int W, int C, int kt, int kh, int kw, void* stream) {
  return pva::launch(x, k, nullptr, out, B, T, H, W, C, kt, kh, kw, 0, stream);
}
