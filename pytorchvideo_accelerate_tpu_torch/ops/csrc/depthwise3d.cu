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
// H100's ~295 FLOP/byte ridge: the bytes bound it. But at 27 taps the f32
// multiply-adds alone are ~27 instructions an element, and the card runs
// ~40 thread instructions in the time it moves one element's 4 bytes, so
// the instructions spent around each multiply-add decide how near the byte
// bound the kernel gets.
//
// What the design does about it:
// - A block owns an output column: one batch index, an HB x WB spatial tile,
//   a CC-channel chunk, and a chunk of `tchunk` output planes, which it walks
//   in T. Its input planes, (HB + kh - 1) x (WB + kw - 1) x CC each with the
//   spatial halo, sit in a ring of kt + PF slots of dynamic shared memory:
//   each input plane is copied from HBM once per block and serves all kt
//   output planes that need it, so T costs no halo. Per T step: wait for the
//   step's plane, one barrier, start the copy of plane t + kt/2 + PF (into
//   the slot that plane t - kt/2 - 1 left), then the products of plane t:
//   PF planes are in flight during the products.
// - Copies are cp.async in the widest unit the channels allow (the path):
//   16 bytes when C % 8 == 0, 8 when C % 4 == 0, 4 when C is even, plain
//   loads otherwise. Rows and columns outside the volume are zero-filled by
//   src-size 0, so the SAME padding is never read and the inner loop has no
//   bounds branch; planes outside [0, T) are neither copied nor multiplied
//   (a block-uniform skip).
// - A thread owns two channels (one bf16x2 word of a plane) and a register
//   strip of S outputs along W. Its kt*kh*kw taps stay in registers for
//   the whole block. For each (dt, dh) it reads the S + kw - 1 words of the
//   strip's window once and adds each into every output of the strip that
//   uses it, so a shared-memory word is read and widened to f32 once per
//   tap row, not once per tap. Every output still sums its taps in (dt, dh,
//   dw) order: planes, then rows, then columns arrive in increasing order.
//   The bias and act run in registers, then one 4-byte bf16x2 store per
//   output pair.
// - The channel pairs of a warp are consecutive words, so its shared-memory
//   reads fall on distinct banks (CC = 64) and its stores are contiguous.
// - The tiles (`DwTileOf`, the one place that holds them): h7, 7 x 7
//   outputs of 64 channels, a 1 x 7 strip a thread (every site's H and W is
//   a multiple of 7), and n24, 8 x 14 outputs of 24 channels for C <= 24
//   (X3D's stem). ops/fused.py `dw_plan` picks the tile, the path and the T
//   chunk per call; the config id is tile * 4 + path. Registers set the
//   sizes: the unrolled (3,3,3) strip takes ~127 of the 128 a thread may
//   have at two 7-warp blocks per SM (a 2 x 7 strip spilled).
// - (3,3,3) (in h7) and (5,1,1) taps are compiled with their loops
//   unrolled; any other odd taps take the generic instantiation, which
//   reads its taps through L1 instead of registers and forgoes the window
//   reuse.
// Each output is one thread's sum in a fixed order: two launches are bitwise
// equal. bf16 x bf16 is exact in f32, so the fused multiply-add gives the
// product-then-add of the plain version bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "flash_mma.cuh"

namespace pva_dw {

using bf16 = __nv_bfloat16;

enum Act { ACT_IDENTITY = 0, ACT_RELU = 1, ACT_SILU = 2 };
enum Path { PATH_CP16 = 0, PATH_CP8 = 1, PATH_CP4 = 2, PATH_PLAIN = 3, NUM_PATHS = 4 };

// bf16 channels each copy moves, by path
template <int PATH>
__host__ __device__ constexpr int vec_of() {
  return PATH == PATH_CP16 ? 8 : PATH == PATH_CP8 ? 4 : PATH == PATH_CP4 ? 2 : 1;
}

template <int CC_, int HB_, int WB_, int S_, int PF_, int MIN_BLOCKS_, int FIXED333_>
struct DwTile {
  static constexpr int CC = CC_;  // channels of a block
  static constexpr int HB = HB_, WB = WB_;  // output rows, columns of a block
  static constexpr int S = S_;  // outputs of a thread's strip along W
  static constexpr int PF = PF_;  // input planes in flight during the products
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;  // blocks per SM: caps registers
  // (3,3,3) taps unrolled with their 54 taps in registers (else generic)
  static constexpr bool FIXED333 = FIXED333_ != 0;
  static constexpr int PAIRS = CC / 2;  // bf16x2 words of one pixel's chunk
  static constexpr int THREADS = PAIRS * HB * (WB / S);
  static_assert(WB % S == 0 && CC % 8 == 0, "strips must cover the tile");
  // dynamic shared memory of a block with (kt, kh, kw) taps: kt + PF planes
  static constexpr int smem_bytes(int kt, int kh, int kw) {
    return (kt + PF) * (HB + kh - 1) * (WB + kw - 1) * CC * 2;
  }
};

// The tile table: config id = tile * NUM_PATHS + path. ops/fused.py
// `DW_TILES` names the tiles in this order with CC, HB, WB and blocks per SM
// (what the plan needs); the rest lives here only.
template <int TILE>
struct DwTileOf;
template <> struct DwTileOf<0> { using type = DwTile<64, 7, 7, 7, 2, 2, 1>; };   // h7: C > 24
template <> struct DwTileOf<1> { using type = DwTile<24, 8, 14, 7, 2, 3, 0>; };  // n24: C <= 24
constexpr int NUM_TILES = 2, NUM_CONFIGS = NUM_TILES * NUM_PATHS;

// f(std::integral_constant<int, config>{}) for a config id known at run time
template <typename F>
int with_config(int config, F&& f) {
  static_assert(NUM_CONFIGS == 8, "the switch lists every config id");
  switch (config) {
#define PVA_DW_CONFIG(id) \
  case id: return f(std::integral_constant<int, id>{});
    PVA_DW_CONFIG(0) PVA_DW_CONFIG(1) PVA_DW_CONFIG(2) PVA_DW_CONFIG(3)
    PVA_DW_CONFIG(4) PVA_DW_CONFIG(5) PVA_DW_CONFIG(6) PVA_DW_CONFIG(7)
#undef PVA_DW_CONFIG
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// f(integral_constant kt, kh, kw): (3,3,3) (where the tile unrolls it) and
// (5,1,1) fixed, else 0 (generic)
template <typename Tile, typename F>
int with_taps(int kt, int kh, int kw, F&& f) {
  using std::integral_constant;
  if constexpr (Tile::FIXED333) {
    if (kt == 3 && kh == 3 && kw == 3)
      return f(integral_constant<int, 3>{}, integral_constant<int, 3>{}, integral_constant<int, 3>{});
  }
  if (kt == 5 && kh == 1 && kw == 1)
    return f(integral_constant<int, 5>{}, integral_constant<int, 1>{}, integral_constant<int, 1>{});
  return f(integral_constant<int, 0>{}, integral_constant<int, 0>{}, integral_constant<int, 0>{});
}

struct Geo {
  int T, H, W, C, kt, kh, kw, act;
  int tchunk, n_tchunks, tiles_w, tiles_h, chunks_c;
};

__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(pva_mma::smem_addr(dst)),
               "l"(src), "r"(ok ? 8 : 0));
}

// all but the newest N committed cp.async groups have landed
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float lo_f32(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_f32(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// VEC = vec_of<PATH>() contiguous bf16 from src to dst, zeros if !ok (src
// then only has to exist)
template <int PATH>
__device__ __forceinline__ void copy_vec(bf16* dst, const bf16* src, bool ok) {
  if constexpr (PATH == PATH_CP16) {
    pva_mma::cp_async16(dst, src, ok);
  } else if constexpr (PATH == PATH_CP8) {
    cp_async8(dst, src, ok);
  } else if constexpr (PATH == PATH_CP4) {
    pva_mma::cp_async4(dst, src, ok);
  } else {
    *dst = ok ? *src : __float2bfloat16(0.f);
  }
}

__device__ __forceinline__ float act_of(float v, int act) {
  if (act == ACT_RELU) return fmaxf(v, 0.f);
  if (act == ACT_SILU) return v / (1.f + expf(-v));
  return v;
}

// KT/KH/KW > 0: tap sizes fixed at compile time; 0: taken from the geometry
template <int CONFIG, int KT, int KH, int KW>
__global__ void __launch_bounds__(DwTileOf<CONFIG / NUM_PATHS>::type::THREADS,
                                  DwTileOf<CONFIG / NUM_PATHS>::type::MIN_BLOCKS)
dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ k,
          const float* __restrict__ bias, bf16* __restrict__ out, Geo g) {
  using Tile = typename DwTileOf<CONFIG / NUM_PATHS>::type;
  constexpr int PATH = CONFIG % NUM_PATHS;
  constexpr bool FIXED = KT > 0;
  constexpr int S = Tile::S, PF = Tile::PF, CC = Tile::CC, PAIRS = Tile::PAIRS;
  constexpr int VEC = vec_of<PATH>();
  constexpr int VECS = CC / VEC;  // copies per pixel of a plane
  extern __shared__ __align__(16) uint32_t smem[];

  const int kt = FIXED ? KT : g.kt, kh = FIXED ? KH : g.kh, kw = FIXED ? KW : g.kw;
  const int pt = kt / 2, ph = kh / 2, pw = kw / 2;
  const int rows = Tile::HB + kh - 1, cols = Tile::WB + kw - 1;  // an input plane
  const int plane_words = rows * cols * PAIRS;
  const int nslot = kt + PF;
  const int T = g.T, H = g.H, W = g.W, C = g.C;

  // the block's column, decoded once: T chunk fastest, so the blocks that
  // share a T halo run side by side and meet in L2
  int bid = blockIdx.x;
  const int tci = bid % g.n_tchunks;
  bid /= g.n_tchunks;
  const int w0 = (bid % g.tiles_w) * Tile::WB;
  bid /= g.tiles_w;
  const int h0 = (bid % g.tiles_h) * Tile::HB;
  bid /= g.tiles_h;
  const int c0 = (bid % g.chunks_c) * CC;
  const int b = bid / g.chunks_c;
  const int t_begin = tci * g.tchunk;
  const int t_end = min(T, t_begin + g.tchunk);

  // the thread's strip: channel pair fastest (a warp's words are
  // consecutive), then the strip's place in the tile's row, then the row
  const int tid = threadIdx.x;
  const int cp = tid % PAIRS;
  const int sx = (tid / PAIRS) % (Tile::WB / S);
  const int ry = tid / (PAIRS * (Tile::WB / S));
  const int c = c0 + 2 * cp;
  const bool c_in = c < C, c1_in = c + 1 < C;

  float tap[FIXED ? KT * KH * KW : 1][2];
  if constexpr (FIXED) {
#pragma unroll
    for (int i = 0; i < KT * KH * KW; ++i) {
      tap[i][0] = c_in ? __bfloat162float(k[i * C + c]) : 0.f;
      tap[i][1] = c1_in ? __bfloat162float(k[i * C + c + 1]) : 0.f;
    }
  }
  const bool has_bias = bias != nullptr;
  const float bias0 = has_bias && c_in ? bias[c] : 0.f;
  const float bias1 = has_bias && c1_in ? bias[c + 1] : 0.f;

  // ring slot of input plane p (t_begin - pt <= p)
  auto slot_of = [&](int p) { return (p - t_begin + pt) % nslot; };

  // input plane p into its slot, as this thread's share of the copies.
  // Where the block's threads cover whole pixels (THREADS % VECS == 0, every
  // path but h7's plain loads), a thread always copies the same channel
  // vector, of every PSTEP-th pixel: its vector's place in C and its pixel
  // walk are fixed per block, and a copy costs a pixel's row and column, two
  // bounds tests and the address. Vectors of channels past C are not copied
  // (their lanes store nothing). Offsets are 32-bit: B*T*H*W*C < 2**31.
  constexpr bool WHOLE_PIXELS = Tile::THREADS % VECS == 0;
  constexpr int PSTEP = WHOLE_PIXELS ? Tile::THREADS / VECS : 1;
  const int cv = WHOLE_PIXELS ? tid % VECS : 0, pix0 = WHOLE_PIXELS ? tid / VECS : 0;
  const bool cv_in = c0 + cv * VEC < C;
  const int npix = rows * cols;
  auto copy_plane = [&](int p) {
    bf16* dst = reinterpret_cast<bf16*>(smem + slot_of(p) * plane_words);
    const bf16* src = x + (b * T + p) * H * W * C + c0;
    if constexpr (WHOLE_PIXELS) {
      if (!cv_in) return;
      bf16* d = dst + cv * VEC;
      const bf16* s = src + cv * VEC;
#pragma unroll 4
      for (int pix = pix0; pix < npix; pix += PSTEP) {
        const int row = pix / cols, col = pix - row * cols;
        const int hi = h0 - ph + row, wi = w0 - pw + col;
        const bool ok = (unsigned)hi < (unsigned)H && (unsigned)wi < (unsigned)W;
        copy_vec<PATH>(d + pix * CC, s + (ok ? (hi * W + wi) * C : 0), ok);
      }
    } else {
      for (int v = tid; v < npix * VECS; v += Tile::THREADS) {
        const int vc = v % VECS, pix = v / VECS;
        if (c0 + vc * VEC >= C) continue;
        const int row = pix / cols, col = pix - row * cols;
        const int hi = h0 - ph + row, wi = w0 - pw + col;
        const bool ok = (unsigned)hi < (unsigned)H && (unsigned)wi < (unsigned)W;
        copy_vec<PATH>(dst + pix * CC + vc * VEC, src + (ok ? (hi * W + wi) * C : 0) + vc * VEC,
                       ok);
      }
    }
  };

  // prologue: planes t_begin - pt .. t_begin + pt + PF - 1, one group each
  const int p_last = min(T, t_end + pt) - 1;  // the last plane the chunk reads
  for (int i = 0; i < kt + PF - 1; ++i) {
    const int p = t_begin - pt + i;
    if (p >= 0 && p <= p_last) copy_plane(p);
    pva_mma::cp_commit();
  }

  for (int t = t_begin; t < t_end; ++t) {
    cp_wait<PF - 1>();  // this thread's copies of plane t + pt have landed
    __syncthreads();    // everyone's have; everyone is done with step t - 1
    {
      const int p = t + pt + PF;  // into the slot plane t - pt - 1 left
      if (p <= p_last) copy_plane(p);
      pva_mma::cp_commit();
    }

    float acc[S][2];
#pragma unroll
    for (int so = 0; so < S; ++so) acc[so][0] = acc[so][1] = 0.f;

    if constexpr (FIXED) {
#pragma unroll
      for (int dt = 0; dt < KT; ++dt) {
        const int p = t - pt + dt;
        if (p < 0 || p >= T) continue;  // SAME padding in T: block-uniform
        const uint32_t* plane = smem + slot_of(p) * plane_words + (ry * cols + sx * S) * PAIRS + cp;
#pragma unroll
        for (int dh = 0; dh < KH; ++dh) {
#pragma unroll
          for (int j = 0; j < S + KW - 1; ++j) {  // the window, each word once
            const uint32_t v = plane[(dh * cols + j) * PAIRS];
            const float x0 = lo_f32(v), x1 = hi_f32(v);
#pragma unroll
            for (int so = 0; so < S; ++so) {
              const int dw = j - so;
              if (dw < 0 || dw >= KW) continue;
              const int i = (dt * KH + dh) * KW + dw;
              acc[so][0] = fmaf(x0, tap[i][0], acc[so][0]);
              acc[so][1] = fmaf(x1, tap[i][1], acc[so][1]);
            }
          }
        }
      }
    } else {
      for (int dt = 0; dt < kt; ++dt) {
        const int p = t - pt + dt;
        if (p < 0 || p >= T) continue;
        const uint32_t* plane = smem + slot_of(p) * plane_words + (ry * cols + sx * S) * PAIRS + cp;
        for (int dh = 0; dh < kh; ++dh) {
          for (int dw = 0; dw < kw; ++dw) {
            const int i = (dt * kh + dh) * kw + dw;
            const float k0 = c_in ? __bfloat162float(__ldg(k + i * C + c)) : 0.f;
            const float k1 = c1_in ? __bfloat162float(__ldg(k + i * C + c + 1)) : 0.f;
#pragma unroll
            for (int so = 0; so < S; ++so) {
              const uint32_t v = plane[(dh * cols + so + dw) * PAIRS];
              acc[so][0] = fmaf(lo_f32(v), k0, acc[so][0]);
              acc[so][1] = fmaf(hi_f32(v), k1, acc[so][1]);
            }
          }
        }
      }
    }

    // epilogue: bias + act on the f32 sums, one bf16x2 store per output
    const int h = h0 + ry;
    if (c_in && h < H) {
      bf16* o_row = out + ((b * T + t) * H + h) * W * C + c;
#pragma unroll
      for (int so = 0; so < S; ++so) {
        const int w = w0 + sx * S + so;
        if (w >= W) continue;
        const float y0 = act_of(acc[so][0] + bias0, g.act);
        const float y1 = act_of(acc[so][1] + bias1, g.act);
        bf16* o = o_row + w * C;
        if constexpr (PATH != PATH_PLAIN) {  // C even: the pair is whole and aligned
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(y0, y1);
        } else {
          o[0] = __float2bfloat16(y0);
          if (c1_in) o[1] = __float2bfloat16(y1);
        }
      }
    }
  }
  pva_mma::cp_wait_all();
}

// the kernel of a config and taps, its dynamic shared memory, and its
// attribute raised to the 227 KB a block may have (once per device)
template <int CONFIG, int KT, int KH, int KW>
int prepare(int kt, int kh, int kw, size_t& smem) {
  using Tile = typename DwTileOf<CONFIG / NUM_PATHS>::type;
  smem = Tile::smem_bytes(kt, kh, kw);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<bool> ready[32];
  int dev = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc) return rc;
  if (dev < 32 && ready[dev].load(std::memory_order_relaxed)) return 0;
  rc = pva_mma::set_smem(dw_kernel<CONFIG, KT, KH, KW>, 227 * 1024);
  if (!rc && dev < 32) ready[dev].store(true, std::memory_order_relaxed);
  return rc;
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

int launch(const void* x, const void* k, const void* bias, void* out, int B, int T, int H,
           int W, int C, int kt, int kh, int kw, int act, int config, int tchunk,
           void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || W <= 0 || C <= 0 || tchunk <= 0 ||
      kt % 2 == 0 || kh % 2 == 0 || kw % 2 == 0 || kt < 1 || kh < 1 || kw < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return with_config(config, [&](auto id) {
    constexpr int CONFIG = decltype(id)::value;
    using Tile = typename DwTileOf<CONFIG / NUM_PATHS>::type;
    constexpr int VEC = vec_of<CONFIG % NUM_PATHS>();
    if (C % VEC) return static_cast<int>(cudaErrorInvalidValue);
    return with_taps<Tile>(kt, kh, kw, [&](auto ft, auto fh, auto fw) {
      constexpr int KT = decltype(ft)::value, KH = decltype(fh)::value, KW = decltype(fw)::value;
      size_t smem = 0;
      int rc = prepare<CONFIG, KT, KH, KW>(kt, kh, kw, smem);
      if (rc) return rc;
      Geo g{T, H, W, C, kt, kh, kw, act, tchunk, cdiv(T, tchunk), cdiv(W, Tile::WB),
            cdiv(H, Tile::HB), cdiv(C, Tile::CC)};
      const long long blocks = (long long)g.n_tchunks * g.tiles_w * g.tiles_h * g.chunks_c * B;
      if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
      dw_kernel<CONFIG, KT, KH, KW><<<static_cast<int>(blocks), Tile::THREADS, smem,
                                      static_cast<cudaStream_t>(stream)>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(k),
          static_cast<const float*>(bias), static_cast<bf16*>(out), g);
      return static_cast<int>(cudaGetLastError());
    });
  });
}

}  // namespace pva_dw

// C entry points (bound with ctypes). x and out (B, T, H, W, C) contiguous
// bf16, k (kt*kh*kw, C) contiguous bf16, bias (C,) f32; B*T*H*W*C < 2**31
// (the wrapper checks); `config` a tile * 4 + path id and `tchunk` the
// output planes a block walks (ops/fused.py `dw_plan`). Launch on `stream`,
// allocate nothing, return cudaGetLastError() so a refused launch reaches
// the caller.
extern "C" int pva_fused_dw_bn_act(const void* x, const void* kf, const void* bias, void* out,
                                   int B, int T, int H, int W, int C, int kt, int kh, int kw,
                                   int act, int config, int tchunk, void* stream) {
  return pva_dw::launch(x, kf, bias, out, B, T, H, W, C, kt, kh, kw, act, config, tchunk,
                        stream);
}

extern "C" int pva_depthwise3d_s1(const void* x, const void* k, void* out, int B, int T, int H,
                                  int W, int C, int kt, int kh, int kw, int config, int tchunk,
                                  void* stream) {
  return pva_dw::launch(x, k, nullptr, out, B, T, H, W, C, kt, kh, kw, 0, config, tchunk,
                        stream);
}

// out[5] = registers a thread, local memory a thread (bytes; spills), the
// dynamic shared memory a block launches with, resident blocks per SM of the
// kernel that a launch in `config` with (kt, kh, kw) taps runs, and the taps
// that kernel is compiled for (KT * 100 + KH * 10 + KW; 0: the generic one)
extern "C" int pva_depthwise3d_attrs(int config, int kt, int kh, int kw, int* out) {
  return pva_dw::with_config(config, [&](auto id) {
    constexpr int CONFIG = decltype(id)::value;
    using Tile = typename pva_dw::DwTileOf<CONFIG / pva_dw::NUM_PATHS>::type;
    return pva_dw::with_taps<Tile>(kt, kh, kw, [&](auto ft, auto fh, auto fw) {
      constexpr int KT = decltype(ft)::value, KH = decltype(fh)::value, KW = decltype(fw)::value;
      auto kernel = pva_dw::dw_kernel<CONFIG, KT, KH, KW>;
      size_t smem = 0;
      cudaFuncAttributes fa;
      int blocks = 0;
      int rc = pva_dw::prepare<CONFIG, KT, KH, KW>(kt, kh, kw, smem);
      if (!rc) rc = static_cast<int>(cudaFuncGetAttributes(&fa, kernel));
      if (!rc)
        rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, kernel, Tile::THREADS, smem));
      if (rc) return rc;
      out[0] = fa.numRegs;
      out[1] = static_cast<int>(fa.localSizeBytes);
      out[2] = static_cast<int>(smem);
      out[3] = blocks;
      out[4] = KT * 100 + KH * 10 + KW;
      return 0;
    });
  });
}
