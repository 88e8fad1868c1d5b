// Thin inline-PTX wrappers for the bf16 tensor-core paths of attention_fwd.cu and
// attention_bwd.cu (sm_80+ instructions, built here for sm_90a).
//
//   s2t_mma_bf16       mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32: D += A B with A a
//                      16x16 bf16 tile (4 registers), B a 16x8 bf16 tile (2 registers), D a
//                      16x8 f32 tile (4 floats).  Lane l holds, with g = l / 4, c = l % 4:
//                        A: a0 (row g, cols 2c, 2c+1), a1 (row g+8, same cols),
//                           a2 (row g, cols 2c+8, 2c+9), a3 (row g+8, cols 2c+8, 2c+9);
//                        B: b0 (k 2c, 2c+1; n g), b1 (k 2c+8, 2c+9; n g);
//                        D: d0, d1 (row g, cols 2c, 2c+1), d2, d3 (row g+8, same cols).
//                      So the D fragments of two n8 tiles (cols 0-7 and 8-15) are, packed to
//                      bf16 pairs, the A fragment of one k16 tile: no trip through shared memory.
//   s2t_ldmatrix_x4    ldmatrix.sync.aligned.m8n8.x4[.trans].shared.b16: four 8x8 bf16 matrices;
//                      lanes 8i..8i+7 give the 16-byte row addresses of matrix i, and register i
//                      of lane l holds (row l / 4, cols 2(l % 4), +1) of matrix i, or of its
//                      transpose with .trans.
//   s2t_cp_async_16/4  cp.async.{cg,ca}.shared.global of 16 / 4 bytes, zero-filling the
//                      destination when the source row lies past the end (src-size 0), with
//                      commit_group and wait_group.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t s2t_smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void s2t_mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void s2t_ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void s2t_ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void s2t_cp_async_16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void s2t_cp_async_4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void s2t_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void s2t_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// two floats rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t s2t_pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the A fragment of one k16 tile from the D fragments of the two n8 tiles it spans
__device__ __forceinline__ void s2t_acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                             const float (&hi)[4]) {
  a[0] = s2t_pack_bf16(lo[0], lo[1]);
  a[1] = s2t_pack_bf16(lo[2], lo[3]);
  a[2] = s2t_pack_bf16(hi[0], hi[1]);
  a[3] = s2t_pack_bf16(hi[2], hi[3]);
}

// ldmatrix row addresses of lane l for a 16x16 bf16 block at (r0, c0) of a row-major tile
// with row stride ld (elements):
//   a_frag:  the A fragment (rows r0..r0+15, cols c0..c0+15), non-transposed;
//   b_frag:  B fragments of two n8 tiles whose n index is the tile's row (K^T, Q^T, ...):
//            registers 0-1 for rows r0..r0+7, 2-3 for rows r0+8..r0+15, non-transposed;
//   bt_frag: B fragments of two n8 tiles whose n index is the tile's column (V, dO, ...):
//            registers 0-1 for cols c0..c0+7, 2-3 for cols c0+8..c0+15, with .trans.
__device__ __forceinline__ const __nv_bfloat16* s2t_a_frag_row(const __nv_bfloat16* tile, int ld,
                                                               int r0, int c0, int lane) {
  return tile + (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8;
}
__device__ __forceinline__ const __nv_bfloat16* s2t_b_frag_row(const __nv_bfloat16* tile, int ld,
                                                               int r0, int c0, int lane) {
  return tile + (r0 + (lane & 7) + ((lane >> 4) << 3)) * ld + c0 + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ const __nv_bfloat16* s2t_bt_frag_row(const __nv_bfloat16* tile, int ld,
                                                                int r0, int c0, int lane) {
  return tile + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + c0 + (lane >> 4) * 8;
}

// Shared tiles hold D bf16 per row with a pad of 8: a row stride of 2D + 16 bytes puts the 8
// rows an ldmatrix reads at one column in 8 distinct 16-byte bank groups (no conflicts) and
// keeps every row 16-byte aligned for cp.async.
template <int D>
__host__ __device__ constexpr int s2t_tile_ld() {
  return D + 8;
}

// cp.async of rows [t0, t0 + ROWS) of a (T, D) bf16 slice with row stride stride_t elements
// (16-byte aligned rows) into a [ROWS][D + 8] shared tile; rows >= T_len are zero-filled.
template <int ROWS, int D, int THREADS>
__device__ __forceinline__ void s2t_load_tile(__nv_bfloat16* tile, const __nv_bfloat16* base,
                                              long long stride_t, int t0, int T_len, int tid) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  static_assert((ROWS * CHUNKS) % THREADS == 0, "the tile must split evenly over the threads");
#pragma unroll
  for (int j = 0; j < ROWS * CHUNKS / THREADS; ++j) {
    const int i = tid + j * THREADS;
    const int r = i / CHUNKS, c = i % CHUNKS;
    const int t = t0 + r;
    const bool in = t < T_len;
    s2t_cp_async_16(s2t_smem_addr(tile + r * s2t_tile_ld<D>() + c * 8),
                    base + (in ? (long long)t * stride_t + c * 8 : 0), in);
  }
}
