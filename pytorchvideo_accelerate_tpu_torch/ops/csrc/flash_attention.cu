// Flash attention forward for Hopper (sm_90a).
//
// Replaces: pytorchvideo_accelerate_tpu/ops/pallas_attention.py
//   pva_flash_fwd     <- `_fwd_kernel`     (:54, pallas_call :160)
// The backward kernels (`_bwd_dq_kernel`, `_bwd_dkv_kernel`) are
// csrc/flash_attention_bwd.cu; the three belong to one custom VJP
// (`_flash_bhnd`), ported as ops/flash_attention.py `FlashAttention`. Both
// sources take their PTX wrappers and fragment helpers from flash_mma.cuh.
//
// What it computes, per (batch b, head h), q (Nq, D), k/v (Nk, D) bf16,
// s = q k^T * scale in f32: an online softmax over K/V tiles: m, l running
// max and sum (f32), p = exp(s - m) rounded to bf16 before P V (l summed
// from the unrounded p), O rescaled in f32 and divided by l at the end;
// out bf16, lse = m + log(max(l, 1e-30)) f32. Key columns past Nk get
// p = 0 (the reference's s = -1e30). Query rows past Nq are loaded as
// zeros, contribute nothing and are never stored.
//
// What bounds it on the H100: per (b, h) it moves (2 Nq + 2 Nk) D bf16
// values plus 4 Nq bytes of lse and does 4 Nq Nk D FLOPs. At every MViT-B
// and ViT-B site (Nq, Nk >= 160, D 64 or 96) that is far above the ~295
// FLOP/byte ridge: the tensor cores bound it.
//
// What the design does about it:
// - A block is 4 warps. Each warp owns two m16 row tiles (32 query rows;
//   one tile at D > 96, for registers), so a block owns 128 rows (64 at
//   D > 96), and every K or V fragment a warp reads from shared memory by
//   ldmatrix feeds two products: half the shared-memory reads per product
//   of one row tile a warp.
// - Q is brought into registers once (ldmatrix A fragments, D / 16 k steps
//   a row tile) and held for the whole K loop, so is the running O (D / 8
//   m16n8 f32 C fragments a row tile) and the per-row m and l.
// - S = Q K^T is an mma.sync m16n8k16 (bf16 in, f32 accumulate) into
//   register C fragments, K the "rows" B operand. The softmax works on the
//   fragments: a lane holds 2 rows x 2 columns of each n8 tile; row maxima
//   reduce over the lane quad (__shfl_xor_sync 1, 2). The max is taken on
//   the unscaled s (scale >= 0; the wrapper flips the sign of q otherwise),
//   so p = exp2(s * scale log2(e) - m * scale log2(e)) is one FMA and one
//   MUFU.EX2 (ex2.approx.ftz), and lse's m is the reference's
//   max(s * scale). l is summed per lane and reduced over the quad once, at
//   the end.
// - P stays in registers: its C fragments are packed to bf16 in place as
//   the A operand of O += P V, V the k-major B operand (ldmatrix.trans).
//   alpha rescales the O fragments in registers. Neither S, P nor O touch
//   shared memory inside the loop.
// - K and V stream by 16-byte cp.async in two stages: tile j + 1 is in
//   flight while tile j computes, one __syncthreads per step. Rows past Nk
//   are zero-filled by the copy's src-size operand; the key mask runs on
//   the last tile only. 64 keys a step (32 at D = 80 and 96, where two row
//   tiles of O take D registers a lane).
// - Epilogue: O times 1/l in registers, each warp stages its bf16 rows
//   through its own rows of the Q tile (free once Q is in registers) and
//   writes `out` in 16-byte stores; one lane per row writes lse.
// - D is a template parameter (any multiple of 16 up to 128; the path uses
//   64 and 96), so every fragment array has a compile-time size and lives
//   in registers. Shared memory: Q and two stages of K and V (53 KB at
//   D = 96, 55 KB at D = 64), two blocks an SM (registers the limit).
// - No split over K: the grid is (ceil(Nq / 128), B * H), at least 192
//   blocks at every site of the path. No atomics: deterministic.
// wgmma, TMA and warp specialisation are later steps.
//
// Layout: q, k and v are read as (B, N, H, D) through element strides
// (b, n, h; the last dim contiguous, rows 16-byte aligned), so the qkv
// projection's split views need no copy. out is written (B, N, H, D)
// contiguous; lse is (B, H, Nq) f32.
#include "flash_mma.cuh"

namespace pva_flash {

using namespace pva_mma;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// m16 row tiles a warp owns: two up to D = 96 (B fragments are read from
// shared memory once for both), one above (registers)
template <int D>
__host__ __device__ constexpr int fwd_mt() { return D <= 96 ? 2 : 1; }
// query rows of a block
template <int D>
__host__ __device__ constexpr int fwd_br() { return WARPS * 16 * fwd_mt<D>(); }
// keys streamed per step: 32 where two row tiles of D > 64 hold O
template <int D>
__host__ __device__ constexpr int fwd_bc() { return fwd_mt<D>() == 2 && D > 64 ? 32 : 64; }

// 2^x in one MUFU.EX2; subnormal results flush to 0 (p and alpha never
// need them: l >= 1 and O carries the row's largest p = 1)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
constexpr size_t fwd_smem() {
  return (size_t)(fwd_br<D>() + 4 * fwd_bc<D>()) * (D + 8) * sizeof(bf16);  // Q; 2 x (K, V)
}

// The softmax step on one m16 row tile's S fragments (unscaled q k^T, NT n8
// tiles): s becomes p = exp2(s * sl - m_new * sl), the running max m and
// per-lane sums l move to the new max and the O fragments are rescaled.
// MASK: keys at or past nk (key0 is this lane's first column) get p = 0.
template <bool MASK, int NT, int DT>
__device__ __forceinline__ void softmax_step(float (&s)[NT][4], float (&o)[DT][4], float (&m)[2],
                                             float (&l)[2], float sl, int key0, int nk) {
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int t = 0; t < NT; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (MASK && key0 + t * 8 + (e & 1) >= nk) s[t][e] = NEG_INF;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[t][e]);
    }
  }
  float ms[2], alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = exp2_ftz((m[r] - m_new) * sl);
    ms[r] = m_new * sl;
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int t = 0; t < NT; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = exp2_ftz(fmaf(s[t][e], sl, -ms[e >> 1]));
      if (MASK && key0 + t * 8 + (e & 1) >= nk) p = 0.f;
      s[t][e] = p;
      l[e >> 1] += p;
    }
  }
#pragma unroll
  for (int t = 0; t < DT; ++t) {
    o[t][0] *= alpha[0];
    o[t][1] *= alpha[0];
    o[t][2] *= alpha[1];
    o[t][3] *= alpha[1];
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
fwd_kernel(View q, View k, View v, bf16* __restrict__ out, float* __restrict__ lse, int H,
           int Nq, int Nk, float scale) {
  constexpr int MT = fwd_mt<D>(), BR = fwd_br<D>(), BC = fwd_bc<D>();
  constexpr int LD = D + 8, NT = BC / 8, DT = D / 8, KT = D / 16, CH = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BR * LD;      // 2 stages
  bf16* Vs = Ks + 2 * BC * LD;  // 2 stages

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * BR, w0 = q0 + warp * 16 * MT;  // this warp's first row
  const bf16* kb = k.head(b, h);
  const bf16* vb = v.head(b, h);

  load_tile<BR, D, THREADS>(Qs, q.head(b, h), q.sn, q0, Nq);
  load_tile<BC, D, THREADS>(Ks, kb, k.sn, 0, Nk);
  load_tile<BC, D, THREADS>(Vs, vb, v.sn, 0, Nk);
  cp_commit();

  const float sl = scale * LOG2E;
  bf16* Qw = Qs + warp * 16 * MT * LD;
  uint32_t qa[MT][KT][4];
  float o[MT][DT][4] = {};
  float m[MT][2], l[MT][2];  // rows g and g + 8 of each row tile
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = NEG_INF;
    l[mt][0] = l[mt][1] = 0.f;
  }
  const int steps = (Nk + BC - 1) / BC;
  for (int j = 0; j < steps; ++j) {
    cp_wait_all();
    __syncthreads();  // tile j landed; every warp is done with tile j - 1
    if (j == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) load_a<LD>(qa[mt][kk], Qw + mt * 16 * LD, kk * 16, lane);
    }
    if (j + 1 < steps) {
      const int nxt = (j + 1) & 1;
      load_tile<BC, D, THREADS>(Ks + nxt * BC * LD, kb, k.sn, (j + 1) * BC, Nk);
      load_tile<BC, D, THREADS>(Vs + nxt * BC * LD, vb, v.sn, (j + 1) * BC, Nk);
    }
    cp_commit();
    const bf16* Kt = Ks + (j & 1) * BC * LD;
    const bf16* Vt = Vs + (j & 1) * BC * LD;

    // s = q k^T (unscaled): this warp's 16 MT rows x BC keys
    float s[MT][NT][4] = {};
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
      for (int n = 0; n < BC; n += 16) {
        uint32_t bk[4];
        load_b_rows<LD>(bk, Kt, n, kk * 16, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(s[mt][n / 8], qa[mt][kk], bk[0], bk[1]);
          mma(s[mt][n / 8 + 1], qa[mt][kk], bk[2], bk[3]);
        }
      }
    }
    const int key0 = j * BC + (lane & 3) * 2;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (j * BC + BC > Nk)
        softmax_step<true>(s[mt], o[mt], m[mt], l[mt], sl, key0, Nk);
      else
        softmax_step<false>(s[mt], o[mt], m[mt], l[mt], sl, key0, Nk);
    }
    // o += bf16(p) v
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) c_to_a(a[mt], s[mt], kk);
#pragma unroll
      for (int n = 0; n < D; n += 16) {
        uint32_t bv[4];
        load_b_cols<LD>(bv, Vt, kk * 16, n, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(o[mt][n / 8], a[mt], bv[0], bv[1]);
          mma(o[mt][n / 8 + 1], a[mt], bv[2], bv[3]);
        }
      }
    }
  }

  // l over the lane quad; lse by the quad's first lane; O / l staged as
  // bf16 in this warp's rows of the Q tile (only this warp reads them)
  const int g = lane >> 2, c = (lane & 3) * 2;
  float* lse_bh = lse + (size_t)bh * Nq;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[mt][r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      inv[r] = 1.f / lr;
      const int row = w0 + mt * 16 + r * 8 + g;
      if ((lane & 3) == 0 && row < Nq)
        lse_bh[row] = m[mt][r] * scale + logf(fmaxf(lr, 1e-30f));
    }
    bf16* rows = Qw + (mt * 16 + g) * LD + c;
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      *reinterpret_cast<uint32_t*>(rows + t * 8) =
          pack_bf16(o[mt][t][0] * inv[0], o[mt][t][1] * inv[0]);
      *reinterpret_cast<uint32_t*>(rows + 8 * LD + t * 8) =
          pack_bf16(o[mt][t][2] * inv[1], o[mt][t][3] * inv[1]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < MT * CH / 2; ++i) {  // 16 MT rows x CH chunks, 32 lanes
    const int idx = i * 32 + lane;
    const int r = idx / CH, col = (idx % CH) * 8;
    if (w0 + r < Nq)
      *reinterpret_cast<uint4*>(out + (((size_t)b * Nq + w0 + r) * H + h) * D + col) =
          *reinterpret_cast<const uint4*>(Qw + r * LD + col);
  }
}

template <int D>
int run_fwd(View q, View k, View v, bf16* out, float* lse, int B, int H, int Nq, int Nk,
            float scale, cudaStream_t stream) {
  constexpr size_t smem = fwd_smem<D>();
  int rc = set_smem(fwd_kernel<D>, smem);
  if (rc) return rc;
  dim3 grid((Nq + fwd_br<D>() - 1) / fwd_br<D>(), B * H);
  fwd_kernel<D><<<grid, THREADS, smem, stream>>>(q, k, v, out, lse, H, Nq, Nk, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pva_flash

// C entry points (bound with ctypes). Pointers are device pointers; strides
// are in elements over (B, N, H, D) with the last dim contiguous; `stream` is
// the caller's cudaStream_t. It launches asynchronously, allocates nothing,
// and returns cudaGetLastError() (or cudaErrorInvalidValue for a D that is
// not a multiple of 16 up to 128, or a negative scale), so a
// refused launch reaches the caller.
using pva_flash::View;
using pva_flash::bf16;

extern "C" int pva_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                             int B, int H, int Nq, int Nk, int D, int q_sb, int q_sn, int q_sh,
                             int k_sb, int k_sn, int k_sh, int v_sb, int v_sn, int v_sh,
                             float scale, void* stream) {
  if (!(scale >= 0.f)) return static_cast<int>(cudaErrorInvalidValue);
  const View qv{static_cast<const bf16*>(q), q_sb, q_sn, q_sh};
  const View kv{static_cast<const bf16*>(k), k_sb, k_sn, k_sh};
  const View vv{static_cast<const bf16*>(v), v_sb, v_sn, v_sh};
  bf16* o = static_cast<bf16*>(out);
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return pva_flash::with_d(D, [&](auto d) {
    return pva_flash::run_fwd<decltype(d)::value>(qv, kv, vv, o, l, B, H, Nq, Nk, scale, st);
  });
}

// Build facts of the forward kernel at head dim D: out[4] = registers a
// thread, local memory a thread (bytes; spills), the dynamic shared memory
// a block launches with, and resident blocks per SM.
extern "C" int pva_flash_fwd_attrs(int D, int* out) {
  return pva_flash::with_d(D, [&](auto d) {
    constexpr int DD = decltype(d)::value;
    return pva_flash::attrs_of(pva_flash::fwd_kernel<DD>, pva_flash::THREADS,
                               pva_flash::fwd_smem<DD>(), out);
  });
}
