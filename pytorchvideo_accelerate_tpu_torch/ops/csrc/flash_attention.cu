// Flash attention forward for Hopper (sm_90a).
//
// Replaces: pytorchvideo_accelerate_tpu/ops/pallas_attention.py
//   pva_flash_fwd     <- `_fwd_kernel`     (:54, pallas_call :160)
// The backward kernels (`_bwd_dq_kernel`, `_bwd_dkv_kernel`) are
// csrc/flash_attention_bwd.cu; the three belong to one custom VJP
// (`_flash_bhnd`), ported as ops/flash_attention.py `FlashAttention`.
//
// What it computes, per (batch b, head h), q (Nq, D), k/v (Nk, D) bf16,
// s = q k^T * scale in f32: an online softmax over K/V tiles: m, l running
// max and sum (f32), p = exp(s - m) rounded to bf16 before P V, O rescaled
// in f32 and divided by l at the end; out bf16, lse = m + log(max(l, 1e-30))
// f32. Key columns past Nk take s = -1e30 (NEG_INF of the reference, not
// -inf), so their p is exactly 0. Query rows past Nq are loaded as zeros,
// contribute nothing and are never stored.
//
// What bounds it on the H100: per (b, h) it moves (2 Nq + 2 Nk) D bf16
// values plus 4 Nq bytes of lse and does 4 Nq Nk D FLOPs. At every MViT-B
// and ViT-B site (Nq, Nk >= 160, D 64 or 96) that is far above the ~295
// FLOP/byte ridge: the tensor cores bound it.
// What the design does about it: the Pallas kernel's sequential third grid
// axis (VMEM scratch carried across K blocks) becomes a loop inside one
// thread block, so S and P never leave shared memory and each Q tile reads
// K/V once. The two products run on the tensor cores (WMMA bf16 16x16x16
// with f32 accumulation). Blocks of 128 threads (4 warps) own a 64-row
// tile; warp w owns rows 16w..16w+15, so the softmax rows a warp updates
// are its own and only warp-level syncs are needed inside a tile step.
// The running O lives in a shared f32 tile, which lets D be a runtime value
// (any multiple of 16 up to 128; the path uses 64 and 96; D = 96 is not a
// power of two). Per-row stats are one value per row (B*H*Nq), not the
// TPU's 128-lane broadcast tile. Loads are single buffered; the backward's
// design (register-resident sums, mma.sync, cp.async stages) is the next
// step for this kernel.
//
// Layout: q, k and v are read as (B, N, H, D) through element strides
// (b, n, h; the last dim contiguous), so the qkv projection's split views
// need no copy. out is written (B, N, H, D) contiguous; lse is (B, H, Nq)
// f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace pva_flash {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int BR = 64;         // query rows of a tile
constexpr int BC = 64;         // columns streamed per step
constexpr int THREADS = 128;   // 4 warps x 16 rows
constexpr int MAX_D = 128;
constexpr float NEG_INF = -1e30f;
constexpr int LDS = BC + 4;    // f32 score tile leading dim
constexpr int LDP = BC + 8;    // bf16 probability tile leading dim

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBCol;

struct View {  // one (B, N, H, D) operand
  const bf16* p;
  int sb, sn, sh;
};

// Carves 128-byte aligned regions out of dynamic shared memory.
struct Carver {
  unsigned char* base;
  size_t off = 0;
  __host__ __device__ Carver(unsigned char* b) : base(b) {}
  template <typename T>
  __host__ __device__ T* take(size_t count) {
    T* out = base ? reinterpret_cast<T*>(base + off) : nullptr;
    off += (count * sizeof(T) + 127) / 128 * 128;
    return out;
  }
};

__host__ __device__ inline int ldh(int D) { return D + 8; }  // bf16 operand tiles
__host__ __device__ inline int ldf(int D) { return D + 4; }  // f32 running sums

// 64 rows x D of one (b, h) slice into a bf16 tile, 16-byte chunks; rows at
// or past n are zeros.
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* base, int sn,
                                          int r0, int n, int D) {
  const int chunks = D / 8;
  for (int idx = threadIdx.x; idx < BR * chunks; idx += THREADS) {
    const int r = idx / chunks;
    const int c = (idx % chunks) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n) v = *reinterpret_cast<const uint4*>(base + (size_t)(r0 + r) * sn + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
  }
}

// C(16 x 64) of this warp = A(16 rows of a, D deep) * B^T where B holds 64
// rows of D: the score tile s = q k^T (or k q^T, v dO^T ...), f32 into c.
__device__ __forceinline__ void rows_times_rows_t(const bf16* a, const bf16* b, int ld, int D,
                                                  float* c, int warp) {
  Acc acc[BC / 16];
#pragma unroll
  for (int j = 0; j < BC / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
  for (int kk = 0; kk < D; kk += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + warp * 16 * ld + kk, ld);
#pragma unroll
    for (int j = 0; j < BC / 16; ++j) {
      FragBCol fb;
      wmma::load_matrix_sync(fb, b + j * 16 * ld + kk, ld);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < BC / 16; ++j)
    wmma::store_matrix_sync(c + warp * 16 * LDS + j * 16, acc[j], LDS, wmma::mem_row_major);
}

// sum(16 x D, f32 in shared) of this warp += P(16 x 64, bf16) * X(64 rows x D)
__device__ __forceinline__ void accumulate_p_times(float* sum, int ldsum, const bf16* p,
                                                   const bf16* x, int ldx, int D, int warp) {
  for (int d0 = 0; d0 < D; d0 += 16) {
    Acc acc;
    float* dst = sum + warp * 16 * ldsum + d0;
    wmma::load_matrix_sync(acc, dst, ldsum, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < BC; kk += 16) {
      FragA fa;
      FragBRow fb;
      wmma::load_matrix_sync(fa, p + warp * 16 * LDP + kk, LDP);
      wmma::load_matrix_sync(fb, x + kk * ldx + d0, ldx);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(dst, acc, ldsum, wmma::mem_row_major);
  }
}

__device__ __forceinline__ void zero_f32(float* x, int count) {
  for (int i = threadIdx.x; i < count; i += THREADS) x[i] = 0.f;
}

// rows [r0, r0 + 64) of a shared f32 tile (64 x D) -> bf16 at
// out + ((b * n + row) * H + h) * D, rows past n skipped.
__device__ __forceinline__ void store_rows(bf16* out, const float* src, int ld, int r0, int n,
                                           int b, int h, int H, int D) {
  for (int idx = threadIdx.x; idx < BR * D; idx += THREADS) {
    const int r = idx / D;
    const int c = idx % D;
    if (r0 + r < n)
      out[(((size_t)b * n + r0 + r) * H + h) * D + c] = __float2bfloat16(src[r * ld + c]);
  }
}

size_t fwd_smem(int D) {
  Carver c(nullptr);
  c.take<bf16>(3 * BR * ldh(D));  // Q, K, V
  c.take<float>(BR * LDS);        // S
  c.take<bf16>(BR * LDP);         // P
  c.take<float>(BR * ldf(D));     // O
  c.take<float>(3 * BR);          // m, l, alpha
  return c.off;
}

__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(View q, View k, View v, bf16* __restrict__ out, float* __restrict__ lse,
                 int H, int Nq, int Nk, int D, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  Carver c(smem);
  const int LDH = ldh(D), LDF = ldf(D);
  bf16* Qs = c.take<bf16>(3 * BR * LDH);
  bf16* Ks = Qs + BR * LDH;
  bf16* Vs = Ks + BR * LDH;
  float* Ss = c.take<float>(BR * LDS);
  bf16* Ps = c.take<bf16>(BR * LDP);
  float* Os = c.take<float>(BR * LDF);
  float* ms = c.take<float>(3 * BR);
  float* ls = ms + BR;
  float* alphas = ls + BR;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* qb = q.p + (size_t)b * q.sb + (size_t)h * q.sh;
  const bf16* kb = k.p + (size_t)b * k.sb + (size_t)h * k.sh;
  const bf16* vb = v.p + (size_t)b * v.sb + (size_t)h * v.sh;

  load_rows(Qs, LDH, qb, q.sn, q0, Nq, D);
  zero_f32(Os, BR * LDF);
  for (int r = threadIdx.x; r < BR; r += THREADS) {
    ms[r] = NEG_INF;
    ls[r] = 0.f;
  }
  // each lane pair owns one row of the warp's 16: 32 columns per lane
  const int row = warp * 16 + (lane >> 1);
  const int c0 = (lane & 1) * (BC / 2);

  for (int k0 = 0; k0 < Nk; k0 += BC) {
    load_rows(Ks, LDH, kb, k.sn, k0, Nk, D);
    load_rows(Vs, LDH, vb, v.sn, k0, Nk, D);
    __syncthreads();
    rows_times_rows_t(Qs, Ks, LDH, D, Ss, warp);
    __syncwarp();
    float* srow = Ss + row * LDS;
    float mx = NEG_INF;
    for (int j = c0; j < c0 + BC / 2; ++j) {
      const float s = (k0 + j < Nk) ? srow[j] * scale : NEG_INF;
      srow[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_prev = ms[row];
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.f;
    for (int j = c0; j < c0 + BC / 2; ++j) {
      const float p = expf(srow[j] - m_new);
      sum += p;
      Ps[row * LDP + j] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float alpha = expf(m_prev - m_new);
    __syncwarp();  // both lanes of the pair have read ms[row]
    if ((lane & 1) == 0) {
      ms[row] = m_new;
      ls[row] = ls[row] * alpha + sum;
      alphas[row] = alpha;
    }
    __syncwarp();
    for (int idx = lane; idx < 16 * D; idx += 32) {
      const int r = warp * 16 + idx / D;
      Os[r * LDF + idx % D] *= alphas[r];
    }
    __syncwarp();
    accumulate_p_times(Os, LDF, Ps, Vs, LDH, D, warp);
    __syncthreads();  // K/V tiles are overwritten next step
  }

  for (int r = threadIdx.x; r < BR; r += THREADS) {
    const float l = ls[r];
    if (q0 + r < Nq) lse[(size_t)bh * Nq + q0 + r] = ms[r] + logf(fmaxf(l, 1e-30f));
    ls[r] = 1.f / l;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < BR * D; idx += THREADS) {
    const int r = idx / D;
    Os[r * LDF + idx % D] *= ls[r];
  }
  __syncthreads();
  store_rows(out, Os, LDF, q0, Nq, b, h, H, D);
}

inline bool bad_d(int D) { return D <= 0 || D % 16 != 0 || D > MAX_D; }

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

}  // namespace pva_flash

// C entry point (bound with ctypes). Pointers are device pointers; strides
// are in elements over (B, N, H, D) with the last dim contiguous; `stream` is
// the caller's cudaStream_t. It launches asynchronously, allocates nothing,
// and returns cudaGetLastError() (or cudaErrorInvalidValue for a D that is
// not a multiple of 16 up to 128), so a refused launch reaches the caller.
using pva_flash::View;

extern "C" int pva_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                             int B, int H, int Nq, int Nk, int D, int q_sb, int q_sn, int q_sh,
                             int k_sb, int k_sn, int k_sh, int v_sb, int v_sn, int v_sh,
                             float scale, void* stream) {
  if (pva_flash::bad_d(D)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = pva_flash::fwd_smem(D);
  int rc = pva_flash::set_smem(pva_flash::flash_fwd_kernel, smem);
  if (rc) return rc;
  dim3 grid((Nq + pva_flash::BR - 1) / pva_flash::BR, B * H);
  pva_flash::flash_fwd_kernel<<<grid, pva_flash::THREADS, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      View{static_cast<const pva_flash::bf16*>(q), q_sb, q_sn, q_sh},
      View{static_cast<const pva_flash::bf16*>(k), k_sb, k_sn, k_sh},
      View{static_cast<const pva_flash::bf16*>(v), v_sb, v_sn, v_sh},
      static_cast<pva_flash::bf16*>(out), static_cast<float*>(lse), H, Nq, Nk, D, scale);
  return static_cast<int>(cudaGetLastError());
}
