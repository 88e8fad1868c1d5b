// Encoder self-attention forward for Hopper (sm_90a): dropout(softmax(Q K^T / sqrt(D) + bias)) V
// with bias = -1e9 on key columns >= the row's length, non-causal, uint8-threshold
// attention dropout, and optionally the per-row log-sum-exp for the backward.
//
// Replaces: s2t_tpu/ops/attention_pallas.py:_fwd_kernel (reached through
// _pallas_attention_padded) and its native-layout twin _fwd_kernel_btd.
//
// Bound on this card: at the serving shape (bf16, B=64, T'=250, H=4, D=64) the function
// reads Q, K, V and writes O, 4 x 8.19 MB, 0.0098 ms at 3.35 TB/s; its 4 B H T^2 D = 4.1
// GFLOP take 0.0041 ms at 989 TFLOP/s, so bytes set the bound (about 2 flops per byte
// against the H100's ~295 ridge).  At the training shape (B=40, H=8, with lse) the same
// holds.  fp32 runs on the CUDA cores (67 TFLOP/s, ridge ~20), still bytes at T' = 250.
//
// Two paths, chosen by dtype_code in s2t_attention_fwd.  Both are tiled online-softmax
// (flash-style) forwards: the TPU kernel keeps a whole (heads, Tp, Tp) f32 score block in
// VMEM, and a (256, 256) f32 block alone exceeds the 227 KB a CTA may use.
//
// bf16: attention_fwd_mma_kernel, on the tensor cores (mma_bf16.cuh):
//   * one CTA of 4 warps per (64-query tile, head, batch row); warp w owns query rows
//     16w..16w+15, and their Q fragments (A operands, D/16 k16 tiles) stay in registers for
//     the whole key loop;
//   * K/V tiles of 64 keys are bf16 in shared memory with rows padded by 8 elements (no
//     ldmatrix bank conflicts), double-buffered through cp.async: tile j+1 is in flight
//     while tile j's products run; rows past T are zero-filled by the copy;
//   * S = Q K^T by mma.m16n8k16 into f32 registers (K read with ldmatrix); the online
//     softmax runs on the accumulator fragments in the log2 domain (exp2f of the scaled,
//     biased scores times log2 e), the row max reduced over the 4 lanes of a row with
//     shuffles, the row sum kept per lane and reduced once at the end;
//   * dropout zeroes P in registers, (query, key) from the fragment's lane mapping; the
//     row sum uses the undropped P and 1/(1 - k/256) is folded into the final 1/l;
//   * P is rounded to bf16 in registers, where the Pallas kernel rounds it
//     (attention_pallas.py:109-111), and its C fragments are the A operand of the P V
//     mma; V is read with ldmatrix.trans; O is normalised at the end and written as bf16;
//   * lse = m ln 2 + ln l, natural log, for the backward.
// Shared memory: Q + 2 K + 2 V tiles, 46,080 bytes at D=64; the registers (about 154 a
// thread at D=64) allow 3 CTAs, 12 warps, per SM.  What bounds it at the main-path
// shapes: not bytes (about 3x the byte bound) but dispatching the ldmatrix, mma and
// softmax instructions with little latency hidden over T' = 250 (4 key tiles a CTA), and at
// p = 0.1 the dropout hash, two mix32 per entry, about a third of the call (PERF.md).
//
// fp32: attention_fwd_kernel, f32 FMAs on the CUDA cores, kept for parity (the card-vs-CPU
// checks hold fp32 at 1e-3 to 1e-5, which TF32 tensor cores would break):
//   * one CTA of 128 threads per (64-query tile, head, batch row);
//   * K/V tiles of 64 keys are staged in shared memory as f32 (bf16 inputs are widened
//     on load), the running max / sum / output accumulator stay in f32 registers;
//   * thread (ty, tx) owns query rows 4*ty..4*ty+3 and the key / head-dim columns
//     tx, tx+8, ... so the 8 lanes that share a row sit in one warp and reduce with
//     shuffles, and shared-memory reads are conflict-free;
//   * Q, K and the probability tile are stored transposed with a row stride of 68 floats
//     (16-byte aligned float4 reads of 4 query rows);
//   * explicit (batch, time, head) strides in elements with a unit head-dim stride: the
//     model's native (B, T, H, D) projections and a head-major (B, H, T, D) buffer viewed
//     as (B, T, H, D) are read in place, with no transposes;
//   * masking is against the true T (no padding to 128).  Keys >= length get the additive
//     -1e9 of the dense path; for a row with length >= 1 their weight is exactly 0 in
//     f32, so key tiles at or past the length are skipped.  A 0-length row sees only
//     biased keys and, like the dense path, averages V over all T keys.
//   * attention dropout: the row sum l uses the undropped probabilities; the tile
//     written for the P.V product is dropped and rescaled in registers with bits from
//     the counter-based hash of dropout_hash.cuh (key = seed, counter = (b, h, query,
//     key)), so the backward regenerates the same mask and nothing is stored;
//   * lse (B, H, T) f32 = m + log(l), the natural-log normaliser of the biased scaled
//     scores, is written when the caller passes a buffer (training).
// The masking, 0-length rows, dropout bits and lse are the same on both paths.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "dropout_hash.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int BM = 64;        // query rows per CTA
constexpr int BN = 64;        // keys per tile
constexpr int THREADS = 128;  // 16 row groups x 8 column lanes
constexpr int PAD = BM + 4;   // row stride of the transposed tiles, in floats
constexpr float NEG_BIAS = -1e9f;

// the FMA kernels are instantiated for float only; bf16 takes the tensor-core path
__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

struct Strides {
  long long b, t, h;  // in elements; the head-dim stride is 1
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(2 * D * PAD + BN * D + BN * PAD);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                     const int* __restrict__ lengths, const long long* __restrict__ seed,
                     int T_len, int rate_u8, Strides sq, Strides sk, Strides sv, Strides so,
                     float scale, float keep_scale) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [D][PAD]   query tile, transposed
  float* Ks = Qs + D * PAD;                     // [D][PAD]   key tile, transposed
  float* Vs = Ks + D * PAD;                     // [BN][D]    value tile
  float* Ps = Vs + BN * D;                      // [BN][PAD]  probabilities, transposed

  constexpr int DC = D / 8;  // head-dim columns per thread
  const int tid = threadIdx.x;
  const int tx = tid & 7;
  const int ty = tid >> 3;
  const int m0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int len = lengths[b];
  const int kv_end = len > 0 ? min(len, T_len) : T_len;
  const uint32_t stream =
      rate_u8 > 0 ? s2t_dropout_stream((unsigned long long)seed[0], b * gridDim.y + h) : 0u;

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  T* ob = o + b * so.b + h * so.h;

  for (int idx = tid; idx < BM * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    const int t = m0 + r;
    Qs[d * PAD + r] = t < T_len ? to_f32(qb[(long long)t * sq.t + d]) : 0.f;
  }

  float acc[4][DC];
  float m_i[4], l_i[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_i[r] = -INFINITY;
    l_i[r] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[r][j] = 0.f;
  }

  for (int n0 = 0; n0 < kv_end; n0 += BN) {
    __syncthreads();  // the previous tile's Ks / Vs / Ps reads are done
    for (int idx = tid; idx < BN * D; idx += THREADS) {
      const int r = idx / D, d = idx % D;
      const int t = n0 + r;
      const bool in = t < T_len;
      Ks[d * PAD + r] = in ? to_f32(kb[(long long)t * sk.t + d]) : 0.f;
      Vs[r * D + d] = in ? to_f32(vb[(long long)t * sv.t + d]) : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&Qs[d * PAD + 4 * ty]);
      float kv[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) kv[c] = Ks[d * PAD + tx + 8 * c];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        s[0][c] = fmaf(qv.x, kv[c], s[0][c]);
        s[1][c] = fmaf(qv.y, kv[c], s[1][c]);
        s[2][c] = fmaf(qv.z, kv[c], s[2][c]);
        s[3][c] = fmaf(qv.w, kv[c], s[3][c]);
      }
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = n0 + tx + 8 * c;
        float x = s[r][c] * scale;
        if (col >= T_len) {
          x = -INFINITY;
        } else if (col >= len) {
          x += NEG_BIAS;
        }
        s[r][c] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      // column 0 of the first tile is always a real key, so m_new is finite
      const float m_new = fmaxf(m_i[r], mx);
      const float alpha = expf(m_i[r] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float p = expf(s[r][c] - m_new);
        s[r][c] = p;
        rs += p;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l_i[r] = l_i[r] * alpha + rs;
      m_i[r] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[r][j] *= alpha;
      if (rate_u8 > 0) {
        const int qrow = m0 + 4 * ty + r;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const bool keep = s2t_dropout_keep(stream, qrow, n0 + tx + 8 * c, rate_u8);
          s[r][c] = keep ? s[r][c] * keep_scale : 0.f;
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      *reinterpret_cast<float4*>(&Ps[(tx + 8 * c) * PAD + 4 * ty]) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BN; ++j) {
      const float4 pv = *reinterpret_cast<const float4*>(&Ps[j * PAD + 4 * ty]);
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) {
        const float vv = Vs[j * D + tx + 8 * jj];
        acc[0][jj] = fmaf(pv.x, vv, acc[0][jj]);
        acc[1][jj] = fmaf(pv.y, vv, acc[1][jj]);
        acc[2][jj] = fmaf(pv.z, vv, acc[2][jj]);
        acc[3][jj] = fmaf(pv.w, vv, acc[3][jj]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = m0 + 4 * ty + r;
    if (t < T_len) {
      const float inv = 1.f / l_i[r];
      if (lse != nullptr && tx == 0) {
        lse[((long long)b * gridDim.y + h) * T_len + t] = m_i[r] + logf(l_i[r]);
      }
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) {
        ob[(long long)t * so.t + tx + 8 * jj] = from_f32<T>(acc[r][jj] * inv);
      }
    }
  }
}

// ---- bf16 on the tensor cores ---------------------------------------------------------
using bf16 = __nv_bfloat16;
constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
constexpr size_t mma_smem_bytes() {  // Q, K[2], V[2] tiles of 64 rows
  return sizeof(bf16) * (size_t)(5 * BM * s2t_tile_ld<D>());
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
attention_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o,
                         float* __restrict__ lse, const int* __restrict__ lengths,
                         const long long* __restrict__ seed, int T_len, int rate_u8, Strides sq,
                         Strides sk, Strides sv, Strides so, float scale, float keep_scale) {
  static_assert(BM == MMA_WARPS * 16 && BN == 64, "one warp per 16 query rows, 64-key tiles");
  constexpr int LD = s2t_tile_ld<D>();
  constexpr int TILE = BM * LD;
  constexpr int KD = D / 16;  // k16 tiles of the head dim
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);  // [BM][LD]
  bf16* Ks = Qs + TILE;                       // [2][BN][LD]
  bf16* Vs = Ks + 2 * TILE;                   // [2][BN][LD]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = 2 * (lane & 3);  // fragment row and column pair
  const int m0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int len = lengths[b];
  const int kv_end = len > 0 ? min(len, T_len) : T_len;
  const int n_tiles = (kv_end + BN - 1) / BN;
  const uint32_t stream =
      rate_u8 > 0 ? s2t_dropout_stream((unsigned long long)seed[0], b * gridDim.y + h) : 0u;

  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;

  s2t_load_tile<BM, D, MMA_THREADS>(Qs, qb, sq.t, m0, T_len, tid);
  s2t_load_tile<BN, D, MMA_THREADS>(Ks, kb, sk.t, 0, T_len, tid);
  s2t_load_tile<BN, D, MMA_THREADS>(Vs, vb, sv.t, 0, T_len, tid);
  s2t_cp_async_commit();

  uint32_t qf[KD][4];
  float acc[D / 8][4];
  float m_r[2] = {-INFINITY, -INFINITY};  // running max of rows g and g + 8, log2 domain
  float l_r[2] = {0.f, 0.f};              // this lane's share of the running sum
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int n0 = it * BN;
    if (it + 1 < n_tiles) {  // the next tile's copy runs during this tile's math
      const int nb = (it + 1) & 1;
      s2t_load_tile<BN, D, MMA_THREADS>(Ks + nb * TILE, kb, sk.t, n0 + BN, T_len, tid);
      s2t_load_tile<BN, D, MMA_THREADS>(Vs + nb * TILE, vb, sv.t, n0 + BN, T_len, tid);
      s2t_cp_async_commit();
      s2t_cp_async_wait<1>();
    } else {
      s2t_cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        s2t_ldmatrix_x4(qf[kk], s2t_smem_addr(s2t_a_frag_row(Qs, LD, 16 * warp, 16 * kk, lane)));
    }
    const bf16* Kt = Ks + (it & 1) * TILE;
    const bf16* Vt = Vs + (it & 1) * TILE;

    // S = Q K^T: this warp's 16 rows x 64 keys, 8 n8 tiles
    float s[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        uint32_t bk[4];
        s2t_ldmatrix_x4(bk, s2t_smem_addr(s2t_b_frag_row(Kt, LD, 16 * np, 16 * kk, lane)));
        s2t_mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
        s2t_mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // scale and bias as the dense path does, then into the log2 domain
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + 8 * j + c2 + (e & 1);
        float x = s[j][e] * scale;
        if (col >= T_len) {
          x = -INFINITY;
        } else {
          if (col >= len) x += NEG_BIAS;
          x *= LOG2E;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // column 0 of the first tile is always a real key, so the max is finite
      const float m_new = fmaxf(m_r[r], mx[r]);
      alpha[r] = exp2f(m_r[r] - m_new);
      m_r[r] = m_new;
      l_r[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m_r[e >> 1]);
        l_r[e >> 1] += p;
        s[j][e] = p;
      }
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
    if (rate_u8 > 0) {
      const int row = m0 + 16 * warp + g;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!s2t_dropout_keep(stream, row + 8 * (e >> 1), n0 + 8 * j + c2 + (e & 1), rate_u8))
            s[j][e] = 0.f;
    }

    // O += P V: P rounded to bf16 in registers as the A operand, V through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t pa[4];
      s2t_acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bv[4];
        s2t_ldmatrix_x4_trans(bv, s2t_smem_addr(s2t_bt_frag_row(Vt, LD, 16 * kk, 16 * dp, lane)));
        s2t_mma_bf16(acc[2 * dp], pa, bv[0], bv[1]);
        s2t_mma_bf16(acc[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  bf16* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    const int t = m0 + 16 * warp + g + 8 * r;
    if (t < T_len) {
      const float inv = keep_scale / l_r[r];
      if (lse != nullptr && c2 == 0) {
        lse[((long long)b * gridDim.y + h) * T_len + t] = m_r[r] * LN2 + logf(l_r[r]);
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(ob + (long long)t * so.t + 8 * j + c2) =
            s2t_pack_bf16(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v;
  void *o;
  float* lse;
  const int* lengths;
  const long long* seed;
  int B, T_len, H, rate_u8;
  Strides sq, sk, sv, so;
  float scale, keep_scale;
};

template <int D>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_mma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T_len + BM - 1) / BM, a.H, a.B);
  attention_fwd_mma_kernel<D><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<bf16*>(a.o), a.lse, a.lengths, a.seed, a.T_len, a.rate_u8, a.sq, a.sk, a.sv,
      a.so, a.scale, a.keep_scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T_len + BM - 1) / BM, a.H, a.B);
  attention_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.o), a.lse, a.lengths, a.seed, a.T_len, a.rate_u8, a.sq, a.sk, a.sv,
      a.so, a.scale, a.keep_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const Args& a, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_mma(int D, const Args& a, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_mma<32>(a, stream);
    case 64: return launch_mma<64>(a, stream);
    case 128: return launch_mma<128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: (B, T, H, D) with element strides (b, t, h) and a unit head-dim stride;
// lse: (B, H, T) float32 or null; lengths: (B,) int32 on the device; seed: one int64 on
// the device (read only when rate_u8 > 0); dtype_code 0 = float32 (FMA kernel),
// 1 = bfloat16 (tensor-core kernel: q, k, v, o 16-byte aligned with b, t, h strides that
// are multiples of 8 elements, which the wrapper checks).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int s2t_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                                 const void* lengths, const void* seed, int B, int T_len, int H,
                                 int D, int dtype_code, int rate_u8, long long sq_b,
                                 long long sq_t, long long sq_h, long long sk_b, long long sk_t,
                                 long long sk_h, long long sv_b, long long sv_t, long long sv_h,
                                 long long so_b, long long so_t, long long so_h, float scale,
                                 float keep_scale, void* stream) {
  if (rate_u8 < 0 || rate_u8 > 255 || (rate_u8 > 0 && seed == nullptr)) return cudaErrorInvalidValue;
  const Args a{q, k, v, o, static_cast<float*>(lse), static_cast<const int*>(lengths),
               static_cast<const long long*>(seed), B, T_len, H, rate_u8,
               Strides{sq_b, sq_t, sq_h}, Strides{sk_b, sk_t, sk_h}, Strides{sv_b, sv_t, sv_h},
               Strides{so_b, so_t, so_h}, scale, keep_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0) return dispatch_d<float>(D, a, st);
  if (dtype_code == 1) return dispatch_mma(D, a, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* s2t_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
