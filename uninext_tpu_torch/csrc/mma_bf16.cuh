// Warp-level bf16 tensor-core helpers for sm_80+ (used on sm_90a): the
// m16n8k16 product, ldmatrix loads of its operands from shared memory, and
// 16-byte cp.async copies; and the padded key space of the rel-pos bias.
// Shared by kernel A (rel_pos_flash_attn_mma.cu) and its backward
// (rel_pos_flash_attn_bwd_mma.cu).
//
// Fragment layout of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32,
// with g = lane / 4 and t = lane % 4 (each .b32 register holds two bf16, the
// lower column in the low half):
//   A (16 x 16, row-major): a0 = A[g][2t..2t+1],   a1 = A[g+8][2t..2t+1],
//                           a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9]
//   B (16 x 8, k x n):      b0 = B[2t..2t+1][g],   b1 = B[2t+8..2t+9][g]
//   C (16 x 8, fp32):       c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1]
// A C fragment pair of n-tiles (2j, 2j+1) is, element for element, the A
// fragment of a 16-deep k-step (as packed by `pack_bf16x2`): flash
// attention feeds its probabilities back into the second product this way.
//
// ldmatrix.x4: lanes 8m..8m+7 give the row addresses (16 bytes each) of
// 8 x 8 matrix m; register m of a lane then holds M_m[g][2t..2t+1] (or, with
// .trans, M_m[2t..2t+1][g]). Row-major K rows (key, d) load as B operands of
// q.k^T directly; row-major V rows (key, d) load as B operands of P.V with
// .trans.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>

namespace mma_bf16 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; with `valid` false nothing is
// read and the 16 bytes are zero-filled (src must still be a valid address).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, asynchronously (both 4-byte aligned)
__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a . b on the tensor cores (bf16 in, fp32 accumulate)
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (nearest even), `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x on the SFU (ex2.approx.ftz: relative error about 2^-22; 2^-inf = 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float LOG2E = 1.4426950408889634f;
constexpr float FAR = -1e30f;   // bias of a padding key: exp2 of it is 0

// Keys are walked in a padded space: grid row y' holds padded keys
// y' Wp .. y' Wp + Wp - 1, of which the first W are keys. An 8-key n-tile
// then lies in one grid row. Tiles of `bk` padded keys; HS is the row
// stride of a block's bh table in shared memory.
struct Layout {
  int Wp, ntiles, HS;
};

inline Layout layout(int H, int W, int bk) {
  Layout L;
  L.Wp = (W + 7) / 8 * 8;
  L.ntiles = (H * L.Wp + bk - 1) / bk;
  const int hp = (L.ntiles * bk + L.Wp - 1) / L.Wp;   // grid rows the tiles touch
  L.HS = hp | 1;     // odd: 8 rows at one column hit 8 banks
  return L;
}

// Row r of a block's bw table starts at r Wp + 8 floor(r q / 4) floats,
// with q = 4, 2 or 0 as Wp = 0, 16 or 8 (mod 32): then any 4 rows 4k..4k+3
// start 8 banks apart, and a half-warp's 8-byte accesses (4 rows x 4 lanes
// at even columns) are conflict-free. bw_row(rows, Wp) is the table's size.
__host__ __device__ inline int bw_row(int r, int Wp) {
  const int q = Wp % 32 == 0 ? 4 : Wp % 32 == 16 ? 2 : 0;
  return r * Wp + 8 * ((r * q) >> 2);
}

}  // namespace mma_bf16
