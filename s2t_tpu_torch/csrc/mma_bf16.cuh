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

// The kernels are compiled for padded head dims DP (multiples of 16, the mma's k-step) and
// take the real head dim D <= DP at run time: the tile columns D .. DP - 1 are zero, so they
// add nothing to Q K^T, dO V^T or Delta, and the output columns past D (which come out 0) are
// never stored.  The padded dims the launchers instantiate: D <= 32 runs DP = 32, then
// 48, 64, 80, 96, 112 and 128.
__host__ __device__ constexpr int s2t_padded_head_dim(int D) {
  return D <= 32 ? 32 : (D + 15) / 16 * 16;
}

// Shared tiles hold DP bf16 per row with a pad of 8: a row stride of 2 DP + 16 bytes puts the
// 8 rows an ldmatrix reads at one column in 8 distinct 16-byte bank groups (no conflicts) and
// keeps every row 16-byte aligned for cp.async.
template <int DP>
__host__ __device__ constexpr int s2t_tile_ld() {
  return DP + 8;
}

// The widest copy a (T, D) bf16 slice's rows allow: 16 bytes when the slice pointer, the row
// stride and D are multiples of 8 elements, 4 bytes when they are even, else 2 (an odd D or
// an odd stride).  The (B, T, H D) projection of an even D that is not a multiple of 8 (the
// recipes' 30, 42, 44, 50, 60, 90) takes the 4-byte copies.
__device__ __forceinline__ int s2t_copy_width(const __nv_bfloat16* base, long long stride_t,
                                              int D) {
  const unsigned long long p = reinterpret_cast<unsigned long long>(base);
  if (p % 16 == 0 && stride_t % 8 == 0 && D % 8 == 0) return 16;
  if (p % 4 == 0 && stride_t % 2 == 0 && D % 2 == 0) return 4;
  return 2;
}

// Whether a bf16 (B, T, H, D) operand with element strides (b, t, h) and a unit head-dim
// stride lets every (b, h) slice take 16-byte copies of whole padded rows (D = DP): the
// launchers run the WIDE kernels, whose D is the constant DP, when all of q, k, v (and dO)
// do; that is the code the D = 32, 64 and 128 instantiations ran before other head dims.
__host__ __forceinline__ bool s2t_wide_rows(const void* p, long long sb, long long st,
                                            long long sh, int D) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0 && sb % 8 == 0 && st % 8 == 0 &&
         sh % 8 == 0 && D == s2t_padded_head_dim(D);
}

// Rows [t0, t0 + ROWS) of a (T, D) bf16 slice with row stride stride_t elements into a
// [ROWS][DP + 8] shared tile, through cp.async of 16 or 4 bytes, or plain 2-byte loads and
// stores; rows >= T_len and columns >= D are zero-filled.  WIDE (s2t_wide_rows): only the
// 16-byte copies are compiled; otherwise the width is s2t_copy_width's.  The 2-byte path
// writes shared memory directly: the callers' __syncthreads after the cp.async wait orders
// it as it orders the copies.
template <int ROWS, int DP, int THREADS, bool WIDE>
__device__ __forceinline__ void s2t_load_tile(__nv_bfloat16* tile, const __nv_bfloat16* base,
                                              long long stride_t, int t0, int T_len, int D,
                                              int tid) {
  constexpr int LD = s2t_tile_ld<DP>();
  const int width = WIDE ? 16 : s2t_copy_width(base, stride_t, D);
  if (WIDE || width == 16) {
    constexpr int CHUNKS = DP / 8;  // 16-byte chunks per row
    constexpr int N = ROWS * CHUNKS;
#pragma unroll
    for (int j = 0; j < (N + THREADS - 1) / THREADS; ++j) {
      const int i = tid + j * THREADS;
      if (N % THREADS == 0 || i < N) {
        const int r = i / CHUNKS, c = i % CHUNKS;
        const int t = t0 + r;
        const bool in = t < T_len && c * 8 < D;
        s2t_cp_async_16(s2t_smem_addr(tile + r * LD + c * 8),
                        base + (in ? (long long)t * stride_t + c * 8 : 0), in);
      }
    }
  } else if (width == 4) {  // not compiled when WIDE
    constexpr int WORDS = DP / 2;  // 4-byte words per row
    constexpr int N = ROWS * WORDS;
    static_assert(N % THREADS == 0, "the tile's words must split evenly over the threads");
#pragma unroll 4
    for (int j = 0; j < N / THREADS; ++j) {
      const int i = tid + j * THREADS;
      const int r = i / WORDS, c = i % WORDS;
      const int t = t0 + r;
      const bool in = t < T_len && c * 2 < D;
      s2t_cp_async_4(s2t_smem_addr(tile + r * LD + c * 2),
                     base + (in ? (long long)t * stride_t + c * 2 : 0), in);
    }
  } else {
    for (int i = tid; i < ROWS * DP; i += THREADS) {
      const int r = i / DP, c = i % DP;
      const int t = t0 + r;
      tile[r * LD + c] =
          t < T_len && c < D ? base[(long long)t * stride_t + c] : __float2bfloat16(0.f);
    }
  }
}

// Store the output pair (col, col + 1) of an accumulator fragment row, for col < D: one 4- or
// 8-byte store where the pair is whole and aligned (always, in a WIDE kernel: D = DP and the
// wrapper's outputs are contiguous), else element by element.
template <bool WIDE>
__device__ __forceinline__ void s2t_store_pair(__nv_bfloat16* p, int col, int D, float x0,
                                               float x1) {
  if (col >= D) return;
  if (WIDE || (col + 1 < D && reinterpret_cast<unsigned long long>(p) % 4 == 0)) {
    *reinterpret_cast<uint32_t*>(p) = s2t_pack_bf16(x0, x1);
  } else {
    p[0] = __float2bfloat16(x0);
    if (col + 1 < D) p[1] = __float2bfloat16(x1);
  }
}

template <bool WIDE>
__device__ __forceinline__ void s2t_store_pair(float* p, int col, int D, float x0, float x1) {
  if (col >= D) return;
  if (WIDE || (col + 1 < D && reinterpret_cast<unsigned long long>(p) % 8 == 0)) {
    *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
  } else {
    p[0] = x0;
    if (col + 1 < D) p[1] = x1;
  }
}
