// Encoder self-attention forward for Hopper (sm_90a): dropout(softmax(Q K^T / sqrt(D) + bias)) V
// with bias = -1e9 on key columns >= the row's length, non-causal, uint8-threshold
// attention dropout, and optionally the per-row log-sum-exp for the backward.
//
// Replaces: s2t_tpu/ops/attention_pallas.py:_fwd_kernel (reached through
// _pallas_attention_padded) and its native-layout twin _fwd_kernel_btd.
//
// Bound on this card: at the serving shapes (T' = 250 frames after subsampling, D = 64)
// the function moves 4*B*T*H*D elements and does 4*B*H*T*T_kv*D flops; in bf16 that is
// about 2 flops per byte, far below the ~295 flops/byte ridge of the H100, so the bound
// is memory (bytes).  In fp32 without tensor cores (67 TFLOP/s) the ridge is ~20 and the
// bound is still bytes at T' = 250.
//
// Design.  The TPU kernel keeps a whole (heads, Tp, Tp) f32 score block in VMEM; on
// Hopper a (256, 256) f32 block alone exceeds the 227 KB a CTA may use, so this is a
// tiled online-softmax (flash-style) forward instead:
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
// The products are plain f32 FMAs (no tensor cores yet): right and simple first.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "dropout_hash.cuh"

namespace {

constexpr int BM = 64;        // query rows per CTA
constexpr int BN = 64;        // keys per tile
constexpr int THREADS = 128;  // 16 row groups x 8 column lanes
constexpr int PAD = BM + 4;   // row stride of the transposed tiles, in floats
constexpr float NEG_BIAS = -1e9f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

}  // namespace

// q, k, v, o: (B, T, H, D) with element strides (b, t, h) and a unit head-dim stride;
// lse: (B, H, T) float32 or null; lengths: (B,) int32 on the device; seed: one int64 on
// the device (read only when rate_u8 > 0); dtype_code 0 = float32, 1 = bfloat16.
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
  if (dtype_code == 1) return dispatch_d<__nv_bfloat16>(D, a, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* s2t_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
