// Flash attention backward for Hopper (sm_90a): dq and dk/dv.
//
// Replaces: pytorchvideo_accelerate_tpu/ops/pallas_attention.py
//   pva_flash_bwd_dq  <- `_bwd_dq_kernel`  (:93, pallas_call :227)
//   pva_flash_bwd_dkv <- `_bwd_dkv_kernel` (:116, pallas_call :246)
// The forward (`_fwd_kernel`) is csrc/flash_attention.cu; the three belong to
// one custom VJP (`_flash_bhnd`), ported as ops/flash_attention.py
// `FlashAttention`. Both sources take their PTX wrappers and fragment
// helpers from flash_mma.cuh.
//
// What they compute, per (batch b, head h), from bf16 q, dO (Nq, D) and k, v
// (Nk, D), and f32 lse and delta = rowsum(dO * out) (Nq):
//   s = q k^T * scale (f32), p = exp(s - lse), 0 for keys >= Nk and for
//   queries >= Nq; dp = dO v^T; ds = p * (dp - delta) * scale;
//   dq = bf16(ds) k, dk = bf16(ds)^T q, dv = bf16(p)^T dO,
// every sum in f32, each gradient cast to bf16 once. dq loops over K tiles
// and dk/dv over Q tiles (the FlashAttention-2 split of the reference's two
// pallas_calls): no atomics, the result is deterministic.
//
// What bounds them on the H100: per (b, h) dq does 6 Nq Nk D FLOPs (s, dp and
// ds k) and dk/dv 8 (s^T, dp^T, p^T dO, ds^T q), against (3 Nq + 2 Nk) D and
// (2 Nq + 4 Nk) D bf16 values moved. At every site of the path (Nq, Nk >= 160,
// D 64 or 96) that is far above the ~295 FLOP/byte ridge: the tensor cores
// bound them.
//
// What the design does about it:
// - Every product is a warp-level mma.sync m16n8k16 (bf16 in, f32
//   accumulate) whose operands ldmatrix brings from shared memory (.trans
//   where the operand is stored k-major). A block is 4 warps; each owns 16
//   of its 64 rows: query rows in dq, key rows in dk/dv.
// - The running sums (dq; dk and dv) stay in registers for the whole loop.
//   S and dP (S^T and dP^T in dk/dv) are computed into register fragments,
//   p and ds are formed in place by the lanes that hold them, packed to
//   bf16x2 and used directly as the A operand of the next product: the C
//   fragments of two m16n8 tiles are the A fragment of one m16k16 step. P
//   and dS never touch shared memory. dk/dv computes S^T = k q^T and
//   dP^T = v dO^T, so p^T and ds^T are row-major A operands of
//   dv += p^T dO and dk += ds^T q.
// - Shared memory holds bf16 operand tiles only (rows padded by 16 bytes,
//   so ldmatrix is free of bank conflicts) and the streamed lse/delta: at
//   D = 96, 80 KB for dq and 53 KB for dk/dv, so two blocks (8 warps) or
//   more share an SM (`__launch_bounds__(128, 2)` caps registers at 255).
// - The streamed tiles (k and v in dq; q, dO, lse and delta in dk/dv) load
//   by cp.async into two stages: tile j + 1 is in flight while tile j
//   computes, with one __syncthreads per step. Ragged rows are zero-filled
//   by the copy's src-size operand, not by a branch around a load.
// - Split-Q in dk/dv: where ceil(Nk / 64) * B * H blocks would leave the
//   card short (the wrapper's `dkv_splits`), the Q loop is cut into
//   `splits` ranges of whole 64-row tiles, one block per (K tile, split).
//   Each block writes f32 partial dk and dv to a workspace the caller
//   allocates, and a second kernel sums the splits in a fixed order and
//   casts to bf16. Both launch from the one entry point.
// - D is a template parameter (any multiple of 16 up to 128; the path uses
//   64 and 96), so every fragment array has a compile-time size and lives
//   in registers.
// wgmma, TMA and warp specialisation are later steps.
//
// Layout: q, k, v and dO are read as (B, N, H, D) through element strides
// (b, n, h; the last dim contiguous, rows 16-byte aligned). dq, dk, dv are
// written (B, N, H, D) contiguous; lse and delta are (B, H, Nq) f32.
#include "flash_mma.cuh"

namespace pva_flash_bwd {

using namespace pva_mma;

constexpr int BR = 64;         // rows a block owns; also the split unit of Q
constexpr int THREADS = 128;   // 4 warps x 16 rows
constexpr int DQ_BC = 64;      // keys streamed per dq step
constexpr float LOG2E = 1.4426950408889634f;

// queries streamed per dk/dv step: 32 above D = 64 keeps dk + dv (D floats
// a thread) and the S^T, dP^T fragments within 255 registers
template <int D>
__host__ __device__ constexpr int dkv_bc() { return D <= 64 ? 64 : 32; }

struct Args {
  View q, k, v, dout;
  const float* lse;
  const float* delta;
  int B, H, Nq, Nk;
  float scale;
  cudaStream_t stream;
};

// ROWS per-row f32 stats (lse or delta) of rows r0.. into dst; 0 past n
template <int ROWS>
__device__ __forceinline__ void load_stat(float* dst, const float* src, int r0, int n) {
  if (threadIdx.x < ROWS) {
    const int r = threadIdx.x;
    const bool ok = r0 + r < n;
    cp_async4(dst + r, src + (ok ? r0 + r : 0), ok);
  }
}

template <int D>
constexpr size_t dq_smem() {
  return (size_t)(2 * BR + 4 * DQ_BC) * (D + 8) * sizeof(bf16);  // Q, dO; 2 x (K, V)
}

template <int D>
constexpr size_t dkv_smem() {
  // K, V; 2 x (Q, dO); 2 x (lse, delta)
  return (size_t)(2 * BR + 4 * dkv_bc<D>()) * (D + 8) * sizeof(bf16) +
         4 * dkv_bc<D>() * sizeof(float);
}

// --- dq -------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
dq_kernel(View q, View k, View v, View dout, const float* __restrict__ lse,
          const float* __restrict__ delta, bf16* __restrict__ dq, int H, int Nq, int Nk,
          float scale) {
  constexpr int LD = D + 8, BC = DQ_BC, NT = BC / 8, DT = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + BR * LD;
  bf16* Ks = dOs + BR * LD;     // 2 stages
  bf16* Vs = Ks + 2 * BC * LD;  // 2 stages

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* kb = k.head(b, h);
  const bf16* vb = v.head(b, h);

  load_tile<BR, D, THREADS>(Qs, q.head(b, h), q.sn, q0, Nq);
  load_tile<BR, D, THREADS>(dOs, dout.head(b, h), dout.sn, q0, Nq);
  load_tile<BC, D, THREADS>(Ks, kb, k.sn, 0, Nk);
  load_tile<BC, D, THREADS>(Vs, vb, v.sn, 0, Nk);
  cp_commit();

  // this lane's two query rows (C rows g and g + 8 of the warp's 16)
  const int r_lo = q0 + warp * 16 + (lane >> 2), r_hi = r_lo + 8;
  const float* lse_bh = lse + (size_t)bh * Nq;
  const float* delta_bh = delta + (size_t)bh * Nq;
  const float l_lo = r_lo < Nq ? lse_bh[r_lo] * LOG2E : 0.f;
  const float l_hi = r_hi < Nq ? lse_bh[r_hi] * LOG2E : 0.f;
  const float d_lo = r_lo < Nq ? delta_bh[r_lo] : 0.f;
  const float d_hi = r_hi < Nq ? delta_bh[r_hi] : 0.f;
  const float scale_log2 = scale * LOG2E;

  const bf16* Qw = Qs + warp * 16 * LD;
  const bf16* dOw = dOs + warp * 16 * LD;
  float acc[DT][4] = {};
  const int steps = (Nk + BC - 1) / BC;
  for (int j = 0; j < steps; ++j) {
    cp_wait_all();
    __syncthreads();  // tile j landed; every warp is done with tile j - 1
    if (j + 1 < steps) {
      const int nxt = (j + 1) & 1;
      load_tile<BC, D, THREADS>(Ks + nxt * BC * LD, kb, k.sn, (j + 1) * BC, Nk);
      load_tile<BC, D, THREADS>(Vs + nxt * BC * LD, vb, v.sn, (j + 1) * BC, Nk);
    }
    cp_commit();
    const bf16* Kt = Ks + (j & 1) * BC * LD;
    const bf16* Vt = Vs + (j & 1) * BC * LD;

    float s[NT][4] = {}, dp[NT][4] = {};
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t qa[4], da[4];
      load_a<LD>(qa, Qw, kk, lane);
      load_a<LD>(da, dOw, kk, lane);
#pragma unroll
      for (int n = 0; n < BC; n += 16) {
        uint32_t bk[4], bv[4];
        load_b_rows<LD>(bk, Kt, n, kk, lane);
        mma(s[n / 8], qa, bk[0], bk[1]);
        mma(s[n / 8 + 1], qa, bk[2], bk[3]);
        load_b_rows<LD>(bv, Vt, n, kk, lane);
        mma(dp[n / 8], da, bv[0], bv[1]);
        mma(dp[n / 8 + 1], da, bv[2], bv[3]);
      }
    }
    // ds in place of s; keys past Nk get p = 0
    const int key0 = j * BC + (lane & 3) * 2;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = key0 + t * 8 + (e & 1) < Nk;
        const float p = ok ? exp2f(fmaf(s[t][e], scale_log2, -(e < 2 ? l_lo : l_hi))) : 0.f;
        s[t][e] = p * (dp[t][e] - (e < 2 ? d_lo : d_hi)) * scale;
      }
    }
    // dq += bf16(ds) k
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, s, kk);
#pragma unroll
      for (int n = 0; n < D; n += 16) {
        uint32_t bk[4];
        load_b_cols<LD>(bk, Kt, kk * 16, n, lane);
        mma(acc[n / 8], a, bk[0], bk[1]);
        mma(acc[n / 8 + 1], a, bk[2], bk[3]);
      }
    }
  }

  const int c = (lane & 3) * 2;
  bf16* out_lo = dq + (((size_t)b * Nq + r_lo) * H + h) * D + c;
  bf16* out_hi = dq + (((size_t)b * Nq + r_hi) * H + h) * D + c;
#pragma unroll
  for (int t = 0; t < DT; ++t) {
    if (r_lo < Nq) *reinterpret_cast<uint32_t*>(out_lo + t * 8) = pack_bf16(acc[t][0], acc[t][1]);
    if (r_hi < Nq) *reinterpret_cast<uint32_t*>(out_hi + t * 8) = pack_bf16(acc[t][2], acc[t][3]);
  }
}

// --- dk / dv ---------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
dkv_kernel(View q, View k, View v, View dout, const float* __restrict__ lse,
           const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
           float* __restrict__ ws, int H, int Nq, int Nk, int splits, float scale) {
  constexpr int LD = D + 8, BC = dkv_bc<D>(), NT = BC / 8, DT = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BR * LD;
  bf16* Qs = Vs + BR * LD;      // 2 stages
  bf16* dOs = Qs + 2 * BC * LD; // 2 stages
  float* Ls = reinterpret_cast<float*>(dOs + 2 * BC * LD);  // 2 stages
  float* Ds = Ls + 2 * BC;                                   // 2 stages

  const int k0 = blockIdx.x * BR, split = blockIdx.y, bh = blockIdx.z;
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // this block's query rows: split `split` of ceil(tiles / splits) whole
  // 64-row tiles each (the wrapper's `dkv_split_rows`)
  const int tiles = (Nq + BR - 1) / BR, per = (tiles + splits - 1) / splits;
  const int qa = min(Nq, split * per * BR), qe = min(Nq, qa + per * BR);
  const bf16* qb = q.head(b, h);
  const bf16* db = dout.head(b, h);
  const float* lse_bh = lse + (size_t)bh * Nq;
  const float* delta_bh = delta + (size_t)bh * Nq;

  load_tile<BR, D, THREADS>(Ks, k.head(b, h), k.sn, k0, Nk);
  load_tile<BR, D, THREADS>(Vs, v.head(b, h), v.sn, k0, Nk);
  const int steps = (qe - qa + BC - 1) / BC;
  if (steps > 0) {
    load_tile<BC, D, THREADS>(Qs, qb, q.sn, qa, Nq);
    load_tile<BC, D, THREADS>(dOs, db, dout.sn, qa, Nq);
    load_stat<BC>(Ls, lse_bh, qa, Nq);
    load_stat<BC>(Ds, delta_bh, qa, Nq);
  }
  cp_commit();

  const float scale_log2 = scale * LOG2E;
  const bf16* Kw = Ks + warp * 16 * LD;
  const bf16* Vw = Vs + warp * 16 * LD;
  float dka[DT][4] = {}, dva[DT][4] = {};
  for (int j = 0; j < steps; ++j) {
    cp_wait_all();
    __syncthreads();  // tile j landed; every warp is done with tile j - 1
    const int q0 = qa + j * BC;
    if (j + 1 < steps) {
      const int nxt = (j + 1) & 1;
      load_tile<BC, D, THREADS>(Qs + nxt * BC * LD, qb, q.sn, q0 + BC, Nq);
      load_tile<BC, D, THREADS>(dOs + nxt * BC * LD, db, dout.sn, q0 + BC, Nq);
      load_stat<BC>(Ls + nxt * BC, lse_bh, q0 + BC, Nq);
      load_stat<BC>(Ds + nxt * BC, delta_bh, q0 + BC, Nq);
    }
    cp_commit();
    const bf16* Qt = Qs + (j & 1) * BC * LD;
    const bf16* dOt = dOs + (j & 1) * BC * LD;
    const float* Lt = Ls + (j & 1) * BC;
    const float* Dt = Ds + (j & 1) * BC;

    // s^T = k q^T, dp^T = v dO^T: this warp's 16 key rows x BC queries
    float st[NT][4] = {}, dpt[NT][4] = {};
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t ka[4], va[4];
      load_a<LD>(ka, Kw, kk, lane);
      load_a<LD>(va, Vw, kk, lane);
#pragma unroll
      for (int n = 0; n < BC; n += 16) {
        uint32_t bq[4], bd[4];
        load_b_rows<LD>(bq, Qt, n, kk, lane);
        mma(st[n / 8], ka, bq[0], bq[1]);
        mma(st[n / 8 + 1], ka, bq[2], bq[3]);
        load_b_rows<LD>(bd, dOt, n, kk, lane);
        mma(dpt[n / 8], va, bd[0], bd[1]);
        mma(dpt[n / 8 + 1], va, bd[2], bd[3]);
      }
    }
    // p^T in place of s^T, ds^T in place of dp^T; queries past Nq get p = 0
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int c = t * 8 + (lane & 3) * 2;
      const float2 l2 = *reinterpret_cast<const float2*>(Lt + c);
      const float2 d2 = *reinterpret_cast<const float2*>(Dt + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = q0 + c + (e & 1) < Nq;
        const float l = (e & 1) ? l2.y : l2.x;
        const float dl = (e & 1) ? d2.y : d2.x;
        const float p = ok ? exp2f(fmaf(st[t][e], scale_log2, -l * LOG2E)) : 0.f;
        dpt[t][e] = p * (dpt[t][e] - dl) * scale;
        st[t][e] = p;
      }
    }
    // dv += bf16(p^T) dO, dk += bf16(ds^T) q
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
      uint32_t ap[4], as[4];
      c_to_a(ap, st, kk);
      c_to_a(as, dpt, kk);
#pragma unroll
      for (int n = 0; n < D; n += 16) {
        uint32_t bd[4], bq[4];
        load_b_cols<LD>(bd, dOt, kk * 16, n, lane);
        mma(dva[n / 8], ap, bd[0], bd[1]);
        mma(dva[n / 8 + 1], ap, bd[2], bd[3]);
        load_b_cols<LD>(bq, Qt, kk * 16, n, lane);
        mma(dka[n / 8], as, bq[0], bq[1]);
        mma(dka[n / 8 + 1], as, bq[2], bq[3]);
      }
    }
  }

  // this lane's two key rows; rows past Nk are never stored
  const int r_lo = k0 + warp * 16 + (lane >> 2), r_hi = r_lo + 8;
  const int c = (lane & 3) * 2;
  if (splits == 1) {
    const size_t lo = (((size_t)b * Nk + r_lo) * H + h) * D + c;
    const size_t hi = (((size_t)b * Nk + r_hi) * H + h) * D + c;
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      if (r_lo < Nk) {
        *reinterpret_cast<uint32_t*>(dk + lo + t * 8) = pack_bf16(dka[t][0], dka[t][1]);
        *reinterpret_cast<uint32_t*>(dv + lo + t * 8) = pack_bf16(dva[t][0], dva[t][1]);
      }
      if (r_hi < Nk) {
        *reinterpret_cast<uint32_t*>(dk + hi + t * 8) = pack_bf16(dka[t][2], dka[t][3]);
        *reinterpret_cast<uint32_t*>(dv + hi + t * 8) = pack_bf16(dva[t][2], dva[t][3]);
      }
    }
    return;
  }
  // f32 partials: ws is (2, splits, B * H, Nk, D), dk's then dv's
  const size_t plane = (size_t)splits * gridDim.z * Nk * D;
  float* wk = ws + ((size_t)split * gridDim.z + bh) * Nk * D + c;
  float* wv = wk + plane;
#pragma unroll
  for (int t = 0; t < DT; ++t) {
    if (r_lo < Nk) {
      *reinterpret_cast<float2*>(wk + (size_t)r_lo * D + t * 8) = make_float2(dka[t][0], dka[t][1]);
      *reinterpret_cast<float2*>(wv + (size_t)r_lo * D + t * 8) = make_float2(dva[t][0], dva[t][1]);
    }
    if (r_hi < Nk) {
      *reinterpret_cast<float2*>(wk + (size_t)r_hi * D + t * 8) = make_float2(dka[t][2], dka[t][3]);
      *reinterpret_cast<float2*>(wv + (size_t)r_hi * D + t * 8) = make_float2(dva[t][2], dva[t][3]);
    }
  }
}

// dk (blockIdx.y 0) or dv (1) = bf16 of the sum of the `splits` f32 partials
// in ws, taken in split order; n = B * H * Nk * D, 4 elements a thread step
__global__ void split_sum_kernel(const float* __restrict__ ws, bf16* __restrict__ dk,
                                 bf16* __restrict__ dv, int splits, int H, int Nk, int D,
                                 size_t n) {
  const float* src = ws + (size_t)blockIdx.y * splits * n;
  bf16* out = blockIdx.y ? dv : dk;
  for (size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4; i < n;
       i += (size_t)gridDim.x * blockDim.x * 4) {
    float4 acc = *reinterpret_cast<const float4*>(src + i);
    for (int s = 1; s < splits; ++s) {
      const float4 x = *reinterpret_cast<const float4*>(src + s * n + i);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    const int d = static_cast<int>(i % D);
    const size_t row = i / D;  // (b * H + h) * Nk + key
    const int key = static_cast<int>(row % Nk);
    const size_t bh = row / Nk;
    const size_t dst = (((bh / H) * Nk + key) * H + bh % H) * D + d;
    *reinterpret_cast<uint2*>(out + dst) =
        make_uint2(pack_bf16(acc.x, acc.y), pack_bf16(acc.z, acc.w));
  }
}

// --- launches ---------------------------------------------------------------------

template <int D>
int run_dq(const Args& a, bf16* dq) {
  constexpr size_t smem = dq_smem<D>();
  int rc = set_smem(dq_kernel<D>, smem);
  if (rc) return rc;
  dim3 grid((a.Nq + BR - 1) / BR, a.B * a.H);
  dq_kernel<D><<<grid, THREADS, smem, a.stream>>>(a.q, a.k, a.v, a.dout, a.lse, a.delta, dq,
                                                  a.H, a.Nq, a.Nk, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int run_dkv(const Args& a, bf16* dk, bf16* dv, float* ws, int splits) {
  constexpr size_t smem = dkv_smem<D>();
  int rc = set_smem(dkv_kernel<D>, smem);
  if (rc) return rc;
  dim3 grid((a.Nk + BR - 1) / BR, splits, a.B * a.H);
  dkv_kernel<D><<<grid, THREADS, smem, a.stream>>>(a.q, a.k, a.v, a.dout, a.lse, a.delta, dk,
                                                   dv, ws, a.H, a.Nq, a.Nk, splits, a.scale);
  rc = static_cast<int>(cudaGetLastError());
  if (rc || splits == 1) return rc;
  const size_t n = (size_t)a.B * a.H * a.Nk * D;
  const size_t threads = 256, blocks = (n / 4 + threads - 1) / threads;
  dim3 sum_grid(static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 2);
  split_sum_kernel<<<sum_grid, threads, 0, a.stream>>>(ws, dk, dv, splits, a.H, a.Nk, D, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pva_flash_bwd

// C entry points (bound with ctypes). Pointers are device pointers; strides
// are in elements over (B, N, H, D) with the last dim contiguous; `stream` is
// the caller's cudaStream_t. Each launches asynchronously, allocates nothing,
// and returns cudaGetLastError() (or cudaErrorInvalidValue for a D that is
// not a multiple of 16 up to 128, or a bad `splits`), so a refused launch
// reaches the caller.
using pva_flash_bwd::Args;
using pva_flash_bwd::View;
using pva_flash_bwd::bf16;

static Args make_args(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, int B, int H, int Nq, int Nk,
                      int q_sb, int q_sn, int q_sh, int k_sb, int k_sn, int k_sh, int v_sb,
                      int v_sn, int v_sh, int do_sb, int do_sn, int do_sh, float scale,
                      void* stream) {
  return Args{View{static_cast<const bf16*>(q), q_sb, q_sn, q_sh},
              View{static_cast<const bf16*>(k), k_sb, k_sn, k_sh},
              View{static_cast<const bf16*>(v), v_sb, v_sn, v_sh},
              View{static_cast<const bf16*>(dout), do_sb, do_sn, do_sh},
              static_cast<const float*>(lse),
              static_cast<const float*>(delta),
              B, H, Nq, Nk, scale, static_cast<cudaStream_t>(stream)};
}

extern "C" int pva_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dq, int B, int H,
                                int Nq, int Nk, int D, int q_sb, int q_sn, int q_sh, int k_sb,
                                int k_sn, int k_sh, int v_sb, int v_sn, int v_sh, int do_sb,
                                int do_sn, int do_sh, float scale, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, B, H, Nq, Nk, q_sb, q_sn, q_sh, k_sb,
                           k_sn, k_sh, v_sb, v_sn, v_sh, do_sb, do_sn, do_sh, scale, stream);
  bf16* out = static_cast<bf16*>(dq);
  return pva_flash_bwd::with_d(D, [&](auto d) { return pva_flash_bwd::run_dq<decltype(d)::value>(a, out); });
}

// `ws` is an f32 workspace of 2 * splits * B * H * Nk * D values, read only
// when splits > 1; then a second kernel on the same stream sums the splits.
extern "C" int pva_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dk, void* dv,
                                 void* ws, int B, int H, int Nq, int Nk, int D, int splits,
                                 int q_sb, int q_sn, int q_sh, int k_sb, int k_sn, int k_sh,
                                 int v_sb, int v_sn, int v_sh, int do_sb, int do_sn, int do_sh,
                                 float scale, void* stream) {
  if (splits < 1 || splits > 65535 || (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(q, k, v, dout, lse, delta, B, H, Nq, Nk, q_sb, q_sn, q_sh, k_sb,
                           k_sn, k_sh, v_sb, v_sn, v_sh, do_sb, do_sn, do_sh, scale, stream);
  bf16* dk_ = static_cast<bf16*>(dk);
  bf16* dv_ = static_cast<bf16*>(dv);
  float* ws_ = static_cast<float*>(ws);
  return pva_flash_bwd::with_d(D, [&](auto d) {
    return pva_flash_bwd::run_dkv<decltype(d)::value>(a, dk_, dv_, ws_, splits);
  });
}

// Build facts of one kernel at head dim D: which 0 = dq, 1 = dk/dv. Fills
// out[4] with registers a thread, local memory a thread (bytes; spills), the
// dynamic shared memory a block launches with, and resident blocks per SM.
extern "C" int pva_flash_bwd_attrs(int which, int D, int* out) {
  return pva_flash_bwd::with_d(D, [&](auto d) {
    constexpr int DD = decltype(d)::value;
    return which == 0 ? pva_flash_bwd::attrs_of(pva_flash_bwd::dq_kernel<DD>, pva_flash_bwd::THREADS,
                                                pva_flash_bwd::dq_smem<DD>(), out)
                      : pva_flash_bwd::attrs_of(pva_flash_bwd::dkv_kernel<DD>, pva_flash_bwd::THREADS,
                                                pva_flash_bwd::dkv_smem<DD>(), out);
  });
}
