// Warp-level tensor-core helpers shared by the flash attention kernels
// (csrc/flash_attention.cu, csrc/flash_attention_bwd.cu), sm_90a.
//
// - PTX wrappers: 16- and 4-byte cp.async (src-size 0 zero-fills the
//   destination), ldmatrix x4 (.trans), mma.sync m16n8k16 bf16 -> f32.
// - Fragment loaders for bf16 tiles in shared memory whose rows are D + 8
//   elements (16 bytes of padding: ldmatrix is free of bank conflicts at
//   every D), and the C -> A fragment repack that lets a product's f32
//   result feed the next product as a bf16 operand without leaving
//   registers.
// - `load_tile`: rows of one (b, h) slice into such a tile by cp.async.
// - Host side: the head-dim switch of the entry points and a kernel's
//   runtime attributes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace pva_mma {

using bf16 = __nv_bfloat16;

struct View {  // one (B, N, H, D) operand, read through element strides
  const bf16* p;
  int sb, sn, sh;
  __device__ const bf16* head(int b, int h) const {
    return p + (size_t)b * sb + (size_t)h * sh;
  }
};

// --- PTX wrappers -------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_size 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// --- fragments ------------------------------------------------------------------
// Lane l of an m16n8k16 holds, with g = l / 4 and c = 2 (l % 4):
//   A regs 0-3: (row g, cols c, c+1), (g + 8, c), (g, c + 8), (g + 8, c + 8)
//   B regs 0-1: (k c, c+1; n g), (k c + 8, c + 9; n g)
//   C: (row g, cols c, c+1), (row g + 8, cols c, c+1)

// A (16 x 16, row-major) from rows [0, 16), cols [k0, k0 + 16) of a tile
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int k0, int lane) {
  ldsm_x4(a, tile + (lane & 15) * LD + k0 + (lane >> 4) * 8);
}

// B of two n8 tiles where B[k][n] = X[n][k]: X rows [n0, n0 + 16), cols
// [k0, k0 + 16); b[0..1] for rows n0.., b[2..3] for rows n0 + 8..
template <int LD>
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4], const bf16* x, int n0, int k0,
                                            int lane) {
  ldsm_x4(b, x + (n0 + (lane >> 4) * 8 + (lane & 7)) * LD + k0 + ((lane >> 3) & 1) * 8);
}

// B of two n8 tiles where B[k][n] = X[k][n] (X stored k-major): X rows
// [k0, k0 + 16), cols [n0, n0 + 16); b[0..1] for cols n0.., b[2..3] n0 + 8..
template <int LD>
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[4], const bf16* x, int k0, int n0,
                                            int lane) {
  ldsm_x4_t(b, x + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD + n0 + (lane >> 4) * 8);
}

// the A fragment of k-step kk from C fragments c[2 kk], c[2 kk + 1]
template <int N>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c)[N][4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// --- tiles ---------------------------------------------------------------------

// rows [r0, r0 + ROWS) of one (b, h) slice (row stride sn) into a bf16 tile
// with rows of D + 8, by 16-byte cp.async from a block of THREADS threads;
// rows at or past n are zero-filled (their source clamped to row 0, which
// exists: n >= 1 where this runs)
template <int ROWS, int D, int THREADS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base, int sn, int r0, int n) {
  constexpr int CH = D / 8, LD = D + 8, TOTAL = ROWS * CH;
#pragma unroll
  for (int i = 0; i < (TOTAL + THREADS - 1) / THREADS; ++i) {
    const int idx = i * THREADS + threadIdx.x;
    if (TOTAL % THREADS == 0 || idx < TOTAL) {
      const int r = idx / CH, c = (idx % CH) * 8;
      const bool ok = r0 + r < n;
      cp_async16(dst + r * LD + c, base + (size_t)(ok ? r0 + r : 0) * sn + c, ok);
    }
  }
}

// --- host side ---------------------------------------------------------------------

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

// f(std::integral_constant<int, D>) for a D that is a multiple of 16 up to 128
template <typename F>
int with_d(int D, F&& f) {
  switch (D) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 48: return f(std::integral_constant<int, 48>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 80: return f(std::integral_constant<int, 80>{});
    case 96: return f(std::integral_constant<int, 96>{});
    case 112: return f(std::integral_constant<int, 112>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out[4] = registers a thread, local memory a thread (bytes; spills), the
// dynamic shared memory a block launches with, resident blocks per SM
template <typename Kernel>
int attrs_of(Kernel kernel, int threads, size_t smem, int* out) {
  cudaFuncAttributes fa;
  int rc = set_smem(kernel, smem);
  if (!rc) rc = static_cast<int>(cudaFuncGetAttributes(&fa, kernel));
  int blocks = 0;
  if (!rc)
    rc = static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem));
  if (rc) return rc;
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(smem);
  out[3] = blocks;
  return 0;
}

}  // namespace pva_mma
