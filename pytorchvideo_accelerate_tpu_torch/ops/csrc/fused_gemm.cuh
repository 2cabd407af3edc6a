// Tile engine of the fused conv + BN + act kernels (fused_pw_bn_act.cu,
// fused_conv_bn_act.cu), sm_90a.
//
// Both kernels compute one GEMM, out[M, N] = act(A[M, K] @ Wf[K, N] + b[N]),
// with bf16 operands, an f32 accumulator, an f32 bias and one bf16 store.
// They differ only in how a block fills its A tile: the pointwise kernel
// copies dense rows, the conv kernel gathers shifted input rows (implicit
// im2col). Each source defines that loader; this header holds the rest.
//
// - Tile configurations (`TileShape`, `TileOf`, `Config`, `with_config`): a
//   block owns a BM x BN output tile, each warp a (BM / WARPS_M) x (BN /
//   WARPS_N) part of it as register-resident accumulators. ops/fused.py
//   `gemm_plan` picks one id per call: id = tile * 3 + path, with
//   path 0 = 16-byte cp.async (K % 8 == N % 8 == 0), 1 = 4-byte cp.async (K
//   and N even), 2 = plain loads (any shape).
// - The operand ring: STAGES stages of (A tile, W tile) in dynamic shared
//   memory, each row padded by 16 bytes so that ldmatrix is free of bank
//   conflicts. Per K step: wait until the step's copies have landed, one
//   barrier, issue the copies of step k + STAGES - 1 (into the stage that
//   step k - 1 read), then the products of step k. The copies of STAGES - 1
//   steps are in flight while the tensor cores work.
// - Products: mma.sync m16n8k16 bf16 -> f32 (flash_mma.cuh); A fragments by
//   ldmatrix from the row-major A tile, W fragments by ldmatrix.trans from
//   the (K, N) row-major W tile.
// - Epilogue in registers: bias + act on the f32 C fragments, packed to
//   bf16, staged through a bf16 C tile for row-contiguous stores of 16
//   bytes. Each output is one block's sum over K in a fixed order, so two
//   launches are bitwise equal.
// - Persistent blocks (PERSISTENT, chosen per source: the pointwise kernel):
//   at most as many blocks as the card holds at once, each walking several
//   output tiles with the copies of the next tile's first steps in flight
//   during this tile's last products and epilogue (its C tile beside the
//   ring). Most pointwise sites are short in K (8 to 512), and without that
//   overlap a block's first copies and last stores leave the SM idle. A
//   one-tile block (the conv kernel) stages its C tile in the ring.
#pragma once

#include <atomic>
#include <type_traits>

#include "flash_mma.cuh"

namespace pva {

using bf16 = __nv_bfloat16;

enum Act { ACT_IDENTITY = 0, ACT_RELU = 1, ACT_SILU = 2 };
enum Path { PATH_CP16 = 0, PATH_CP4 = 1, PATH_SCALAR = 2, NUM_PATHS = 3 };

__device__ __forceinline__ float apply_act(float v, int act) {
  if (act == ACT_RELU) return fmaxf(v, 0.f);
  if (act == ACT_SILU) return v / (1.f + expf(-v));
  return v;
}

// all but the newest N committed cp.async groups have landed
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the W fragment (k16 x n8) of a single n8 tile: ldmatrix x2 .trans, row
// addresses from lanes 0-15
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(pva_mma::smem_addr(p)));
}

// elements a padded tile row of `width` bf16 takes: 16 bytes more, except an
// 8-wide row, whose 16-byte stride already puts the 8 rows of one ldmatrix
// on distinct banks
__host__ __device__ constexpr int padded(int width) { return width == 8 ? 8 : width + 8; }

template <int BM_, int BN_, int BK_, int WARPS_M_, int WARPS_N_, int MIN_BLOCKS_, int STAGES_>
struct TileShape {
  static constexpr int BM = BM_, BN = BN_, BK = BK_;
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;  // blocks per SM: caps registers
  static constexpr int STAGES = STAGES_;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int MT = BM / WARPS_M / 16;  // m16 tiles of a warp
  static constexpr int NT = BN / WARPS_N / 8;   // n8 tiles of a warp
  static constexpr int A_LD = padded(BK), B_LD = padded(BN), C_LD = padded(BN);
  static constexpr int A_ELEMS = BM * A_LD;
  static constexpr int STAGE_ELEMS = A_ELEMS + BK * B_LD;
  static constexpr int RING_BYTES = STAGES * STAGE_ELEMS * 2;
  static constexpr int C_BYTES = BM * C_LD * 2;
  // a persistent block keeps its C tile beside the ring (the next tile's
  // copies are in flight during the epilogue); a one-tile block's C tile
  // reuses the ring
  static constexpr int smem_bytes(bool persistent) {
    return persistent ? RING_BYTES + C_BYTES : RING_BYTES > C_BYTES ? RING_BYTES : C_BYTES;
  }
  // A tile: each thread copies one 8-column group of A_PASSES rows a step
  static constexpr int GROUPS = BK / 8;
  static constexpr int A_ROWS = THREADS / GROUPS;
  static constexpr int A_PASSES = BM / A_ROWS;
  static_assert(MT >= 1 && NT >= 1 && BM == MT * 16 * WARPS_M && BN == NT * 8 * WARPS_N,
                "warp tiles must cover the block tile");
  static_assert(BK % 16 == 0 && THREADS % GROUPS == 0 && BM % A_ROWS == 0,
                "A copies must cover the A tile");
};

// The tile table: config id = tile * NUM_PATHS + path. ops/fused.py
// `GEMM_TILES` names the tiles in this order with their BM, BN, BK (what the
// plan needs); the rest lives here only.
template <int TILE>
struct TileOf;
template <> struct TileOf<0> { using type = TileShape<128, 128, 32, 2, 4, 2, 4>; };  // wide: N > 64
template <> struct TileOf<1> { using type = TileShape<128, 64, 32, 2, 2, 3, 3>; };   // n64: N <= 64, or a short wide grid
template <> struct TileOf<2> { using type = TileShape<256, 32, 32, 8, 1, 2, 4>; };   // n32: 16 < N <= 32
template <> struct TileOf<3> { using type = TileShape<256, 16, 32, 8, 1, 2, 4>; };   // n16: 8 < N <= 16
template <> struct TileOf<4> { using type = TileShape<256, 8, 32, 8, 1, 2, 4>; };    // n8: N <= 8
template <> struct TileOf<5> { using type = TileShape<256, 32, 16, 8, 1, 2, 4>; };   // k16: K <= 16, 16 < N <= 32
template <> struct TileOf<6> { using type = TileShape<128, 128, 32, 2, 2, 2, 4>; };  // deep: N > 64, K >= 1536
constexpr int NUM_TILES = 7, NUM_CONFIGS = NUM_TILES * NUM_PATHS;

// A kernel is instantiated per config id, so its mangled name carries the id
// (`..._kernelILi<id>EE`), which is how ptxas's report is matched to it.
template <int CONFIG>
struct Config {
  static_assert(0 <= CONFIG && CONFIG < NUM_CONFIGS, "unknown GEMM config id");
  using Tile = typename TileOf<CONFIG / NUM_PATHS>::type;
  static constexpr int PATH = CONFIG % NUM_PATHS;
};

// f(std::integral_constant<int, config>{}) for a config id known at run time
template <typename F>
int with_config(int config, F&& f) {
  static_assert(NUM_CONFIGS == 21, "the switch lists every config id");
  switch (config) {
#define PVA_CONFIG(id) \
  case id: return f(std::integral_constant<int, id>{});
    PVA_CONFIG(0) PVA_CONFIG(1) PVA_CONFIG(2) PVA_CONFIG(3) PVA_CONFIG(4) PVA_CONFIG(5)
    PVA_CONFIG(6) PVA_CONFIG(7) PVA_CONFIG(8) PVA_CONFIG(9) PVA_CONFIG(10) PVA_CONFIG(11)
    PVA_CONFIG(12) PVA_CONFIG(13) PVA_CONFIG(14) PVA_CONFIG(15) PVA_CONFIG(16)
    PVA_CONFIG(17) PVA_CONFIG(18) PVA_CONFIG(19) PVA_CONFIG(20)
#undef PVA_CONFIG
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// --- copies into the ring ---------------------------------------------------

// V contiguous bf16 (V = 8, 2 or 1 by path) from src to dst; zeros if !ok,
// with the source clamped to `base`, which exists
template <int PATH>
__device__ __forceinline__ void copy_chunk(bf16* dst, const bf16* src, const bf16* base,
                                           bool ok) {
  if constexpr (PATH == PATH_CP16) {
    pva_mma::cp_async16(dst, ok ? src : base, ok);
  } else if constexpr (PATH == PATH_CP4) {
    pva_mma::cp_async4(dst, ok ? src : base, ok);
  } else {
    *dst = ok ? *src : __float2bfloat16(0.f);
  }
}

template <int PATH>
__host__ __device__ constexpr int chunk_elems() {
  return PATH == PATH_CP16 ? 8 : PATH == PATH_CP4 ? 2 : 1;
}

// 8 contiguous bf16 of which the first `avail` exist (all 8 if avail >= 8;
// on the 16-byte path avail >= 8 whenever ok), zeros elsewhere
template <int PATH>
__device__ __forceinline__ void copy8(bf16* dst, const bf16* src, const bf16* base, bool ok,
                                      int avail) {
  constexpr int V = chunk_elems<PATH>();
#pragma unroll
  for (int j = 0; j < 8; j += V) copy_chunk<PATH>(dst + j, src + j, base, ok && j < avail);
}

// rows [k0, k0 + BK) x cols [n0, n0 + BN) of the (K, N) row-major Wf into
// a W tile, zeros past K or N
template <typename T, int PATH>
__device__ __forceinline__ void load_w(bf16* Bs, const bf16* __restrict__ w, int k0, int n0,
                                       int K, int N) {
  constexpr int G = T::BN / 8, TOTAL = T::BK * G;
#pragma unroll
  for (int i = 0; i < (TOTAL + T::THREADS - 1) / T::THREADS; ++i) {
    const int idx = i * T::THREADS + threadIdx.x;
    if (TOTAL % T::THREADS == 0 || idx < TOTAL) {
      const int r = idx / G, c = (idx % G) * 8;
      const int k = k0 + r, n = n0 + c;
      const bool ok = k < K && n < N;
      copy8<PATH>(Bs + r * T::B_LD + c, w + (ok ? (size_t)k * N + n : 0), w, ok, N - n);
    }
  }
}

// --- products ----------------------------------------------------------------

// one BK step: warp tile (wm0, wn0) of the stage's A x W into acc
template <typename T>
__device__ __forceinline__ void mma_step(const bf16* As, const bf16* Bs, int wm0, int wn0,
                                         int lane, float (&acc)[T::MT][T::NT][4]) {
#pragma unroll
  for (int kk = 0; kk < T::BK; kk += 16) {
    uint32_t b[T::NT][2];
#pragma unroll
    for (int nt = 0; nt + 1 < T::NT; nt += 2) {
      uint32_t r[4];
      pva_mma::load_b_cols<T::B_LD>(r, Bs, kk, wn0 + nt * 8, lane);
      b[nt][0] = r[0];
      b[nt][1] = r[1];
      b[nt + 1][0] = r[2];
      b[nt + 1][1] = r[3];
    }
    if constexpr (T::NT % 2 == 1)
      ldsm_x2_t(b[T::NT - 1], Bs + (kk + (lane & 15)) * T::B_LD + wn0 + (T::NT - 1) * 8);
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt) {
      uint32_t a[4];
      pva_mma::load_a<T::A_LD>(a, As + (wm0 + mt * 16) * T::A_LD, kk, lane);
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt) pva_mma::mma(acc[mt][nt], a, b[nt][0], b[nt][1]);
    }
  }
}

// --- the GEMM --------------------------------------------------------------

// bias + act on the f32 C fragments of one output tile, packed to bf16 into
// the C tile Cs, then row-contiguous stores of out[m0 + BM, n0 + BN). The
// caller separates two calls by a barrier (Cs is read here after being
// written).
template <typename Cfg>
__device__ __forceinline__ void store_tile(const float (&acc)[Cfg::Tile::MT][Cfg::Tile::NT][4],
                                           bf16* Cs, const float* __restrict__ bias,
                                           bf16* __restrict__ out, int M, int N, int m0, int n0,
                                           int wm0, int wn0, int lane, int act) {
  using T = typename Cfg::Tile;
  const int g = lane >> 2, cq = (lane & 3) * 2;
#pragma unroll
  for (int nt = 0; nt < T::NT; ++nt) {
    const int n = n0 + wn0 + nt * 8 + cq;
    const float b0 = n < N ? bias[n] : 0.f;
    const float b1 = n + 1 < N ? bias[n + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt) {
      bf16* row = Cs + (wm0 + mt * 16 + g) * T::C_LD + wn0 + nt * 8 + cq;
      *reinterpret_cast<uint32_t*>(row) = pva_mma::pack_bf16(
          apply_act(acc[mt][nt][0] + b0, act), apply_act(acc[mt][nt][1] + b1, act));
      *reinterpret_cast<uint32_t*>(row + 8 * T::C_LD) = pva_mma::pack_bf16(
          apply_act(acc[mt][nt][2] + b0, act), apply_act(acc[mt][nt][3] + b1, act));
    }
  }
  __syncthreads();
  constexpr int G = T::BN / 8, TOTAL = T::BM * G;
#pragma unroll
  for (int i = 0; i < (TOTAL + T::THREADS - 1) / T::THREADS; ++i) {
    const int idx = i * T::THREADS + threadIdx.x;
    if (TOTAL % T::THREADS != 0 && idx >= TOTAL) continue;
    const int r = idx / G, c = (idx % G) * 8;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    const bf16* src = Cs + r * T::C_LD + c;
    bf16* dst = out + (size_t)m * N + n;
    if constexpr (Cfg::PATH == PATH_CP16) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else if constexpr (Cfg::PATH == PATH_CP4) {
#pragma unroll
      for (int j = 0; j < 8; j += 2)
        if (n + j < N)
          *reinterpret_cast<uint32_t*>(dst + j) = *reinterpret_cast<const uint32_t*>(src + j);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (n + j < N) dst[j] = src[j];
    }
  }
}

// out[M, N] = act(A @ Wf + b), output tiles numbered with N tiles fastest
// (the blocks that run together share their A rows). A PERSISTENT block takes
// the tiles blockIdx.x, + gridDim.x, ... and walks their K steps as one
// stream through the ring: the copies run STAGES - 1 steps ahead across tile
// boundaries, so the next tile's operands are in flight while this one's
// epilogue stores. Otherwise a block computes tile blockIdx.x alone. `a`
// fills the A tile of its next K step on each a.load(As), in order, and
// starts over at row m0 on a.reset(m0).
template <typename Cfg, bool PERSISTENT, typename ALoader>
__device__ __forceinline__ void gemm_bias_act(ALoader& a, const bf16* __restrict__ w,
                                              const float* __restrict__ bias,
                                              bf16* __restrict__ out, int M, int K, int N,
                                              int act) {
  using T = typename Cfg::Tile;
  constexpr int S = T::STAGES;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  bf16* Cs = PERSISTENT ? smem + S * T::STAGE_ELEMS : smem;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm0 = (warp / T::WARPS_N) * (T::MT * 16);
  const int wn0 = (warp % T::WARPS_N) * (T::NT * 8);
  const int steps = (K + T::BK - 1) / T::BK;
  const int n_tiles = (N + T::BN - 1) / T::BN;
  const int tiles = (M + T::BM - 1) / T::BM * n_tiles;
  const int first = static_cast<int>(blockIdx.x);
  const int stride = PERSISTENT ? static_cast<int>(gridDim.x) : tiles;
  if (first >= tiles) return;
  const int total = ((tiles - 1 - first) / stride + 1) * steps;  // K steps of this block

  float acc[T::MT][T::NT][4];
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // the copy side: tile and K step of the next step to copy
  int ld_tile = first, ld_step = 0, ld_n0 = (first % n_tiles) * T::BN;
  a.reset((first / n_tiles) * T::BM);
  auto load_next = [&](int stage) {
    bf16* As = smem + stage * T::STAGE_ELEMS;
    a.template load<Cfg::PATH>(As);
    load_w<T, Cfg::PATH>(As + T::A_ELEMS, w, ld_step * T::BK, ld_n0, K, N);
    ++ld_step;
    if constexpr (PERSISTENT) {
      if (ld_step == steps) {
        ld_step = 0;
        ld_tile += stride;
        if (ld_tile < tiles) {
          a.reset((ld_tile / n_tiles) * T::BM);
          ld_n0 = (ld_tile % n_tiles) * T::BN;
        }
      }
    }
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < total) load_next(s);
    pva_mma::cp_commit();
  }
  int g = 0;  // this block's K steps so far
  for (int tile = first; tile < tiles; tile += stride) {
    for (int step = 0; step < steps; ++step, ++g) {
      cp_wait<S - 2>();
      __syncthreads();
      if (g + S - 1 < total) load_next((g + S - 1) % S);
      pva_mma::cp_commit();
      const bf16* As = smem + (g % S) * T::STAGE_ELEMS;
      mma_step<T>(As, As + T::A_ELEMS, wm0, wn0, lane, acc);
    }
    if constexpr (!PERSISTENT) {  // the C tile reuses the ring
      pva_mma::cp_wait_all();
      __syncthreads();
    }
    // (persistent: the next tile's first barrier separates this epilogue's
    // Cs reads from the next epilogue's writes)
    store_tile<Cfg>(acc, Cs, bias, out, M, N, (tile / n_tiles) * T::BM,
                    (tile % n_tiles) * T::BN, wm0, wn0, lane, act);
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  }
  pva_mma::cp_wait_all();
}

// --- host side ---------------------------------------------------------------

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// the dynamic shared memory limit of `kernel`, set once per device, and the
// blocks the whole card holds at once (SMs x resident blocks per SM)
template <typename Cfg, bool PERSISTENT, typename Kernel>
int prepare(Kernel kernel, int& resident) {
  constexpr int smem = Cfg::Tile::smem_bytes(PERSISTENT);
  static_assert(smem <= 227 * 1024, "a block may have 227 KB of shared memory");
  static std::atomic<int> cache[32];  // per device: resident blocks, 0 unknown
  int dev = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc) return rc;
  if (dev < 32 && (resident = cache[dev].load(std::memory_order_relaxed)) > 0) return 0;
  int sms = 0, per_sm = 0;
  rc = pva_mma::set_smem(kernel, smem);
  if (!rc) rc = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (!rc)
    rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, Cfg::Tile::THREADS, smem));
  if (rc) return rc;
  resident = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < 32) cache[dev].store(resident, std::memory_order_relaxed);
  return 0;
}

// one block per output tile, or (PERSISTENT) at most as many as the card
// holds at once, each then walking several tiles; returns cudaGetLastError()
template <typename Cfg, bool PERSISTENT, typename Kernel, typename... Args>
int launch(Kernel kernel, int M, int N, cudaStream_t stream, Args... args) {
  using T = typename Cfg::Tile;
  int resident = 0;
  int rc = prepare<Cfg, PERSISTENT>(kernel, resident);
  if (rc) return rc;
  const long long tiles = (long long)cdiv(M, T::BM) * cdiv(N, T::BN);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = PERSISTENT && tiles > resident ? resident : static_cast<int>(tiles);
  kernel<<<blocks, T::THREADS, T::smem_bytes(PERSISTENT), stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pva
