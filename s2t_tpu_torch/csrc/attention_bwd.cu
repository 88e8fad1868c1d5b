// Encoder self-attention backward for Hopper (sm_90a): dQ, dK, dV of
// O = dropout(softmax(Q K^T / sqrt(D) + bias)) V, bias = -1e9 on keys >= the row's length.
//
// Replaces: s2t_tpu/ops/attention_pallas.py:_bwd_kernel (reached through
// _pallas_attention_bwd_padded, the custom_vjp backward of fused_attention) and its
// native-layout twin _bwd_kernel_btd.  Same math:
//   P = exp(S - lse) recomputed from Q, K and the forward's log-sum-exp,
//   Z = the forward's dropout multiplier (0 or 1/(1-k/256)), regenerated from the seed,
//   dV = (P o Z)^T dO,   dP = (dO V^T) o Z,   dS = P o (dP - Delta),  Delta = rowsum(dO o O),
//   dQ = dS K / sqrt(D),  dK = dS^T Q / sqrt(D);
// f32 accumulation, outputs in the input dtype.
//
// Bound on this card: at the training shape (bf16, B=40, T'=250, H=8, D=64) the function
// reads Q, K, V, O, dO and writes dQ, dK, dV: 8 x 10.24 MB plus the (B, H, T) lse / Delta,
// ~82.6 MB, 0.025 ms at 3.35 TB/s; its 10 B H T^2 D = 12.8 GFLOP take 0.013 ms at
// 989 TFLOP/s, so bytes set the bound.  The kernels below recompute S and dP in the dQ
// pass (7 products, 17.9 GFLOP), and with attention dropout each pass regenerates the
// mask: about 18 integer operations per (query, key) entry, 20M entries a pass.
//
// The TPU kernel keeps four whole (heads, Tp, Tp) f32 blocks live in VMEM (_head_block);
// that does not fit a CTA's 227 KB, so both paths are tiled flash-style backwards in three
// launches on one stream, with no atomics (run to run identical), chosen by dtype_code:
//
// bf16, on the tensor cores (mma_bf16.cuh), every product an mma.m16n8k16 with f32
// accumulators:
//   1. delta_bf16_kernel: Delta (B, H, T) f32 = rowsum(dO o O), D/8 lanes per row, 16-byte
//      loads; its own small launch, since dK/dV need Delta of every query.  O is the float32
//      output the forward wrote beside its bf16 O (attention_fwd.cu): for a row whose
//      probability sits on one key, dP o Z and Delta then agree to f32 rounding and dS
//      cancels as in the Pallas kernel, which takes Delta as sum dP P from its f32 P; from
//      the bf16 O it kept ~2^-9 |dO V| per query, 0.038 of dK's scale at D=32, T=100,
//      p = 0.15 (2e-2 is the tolerance).  A third pass over the key tiles for Delta = sum
//      dP P before dK/dV would cost more than reading 4 more bytes of O per element once;
//   2. dkdv_mma_kernel: one CTA of 4 warps per (64-key tile, head, batch row); warp w owns
//      keys 16w..16w+15 and reads their K and V fragments (A operands) from shared memory
//      for each query tile (held in registers they cost the third CTA per SM, measured
//      14 % slower).  Q and dO tiles of 32 queries, with that tile's lse and Delta, come
//      through cp.async, double-buffered.  It computes S^T = K Q^T and dP^T = V dO^T
//      (ldmatrix on Q / dO), forms P^T, Z, P^T o Z and dS^T = P^T o (dP^T o Z - Delta) in
//      registers, rounds P o Z and dS to bf16 in registers, where the Pallas kernel rounds
//      them (attention_pallas.py:131-153), and accumulates dV += (P o Z)^T dO and
//      dK += dS^T Q (ldmatrix.trans) in f32 registers;
//   3. dq_mma_kernel: the mirror, one CTA per 64-query tile; Q and dO fragments in
//      registers, K / V tiles of BK keys (64, or 32 at D = 128) double-buffered through
//      cp.async; S and dP recomputed, dQ += dS K (ldmatrix.trans on K).
//   At D <= 64 both are compiled for 3 CTAs (12 warps) per SM, at most 168 registers a
//   thread.  Shared tiles are padded by 8 elements a row (no ldmatrix bank conflicts);
//   37,376 bytes (dK/dV) and 55,296 bytes (dQ) at D=64.  Key tiles at or past a row's
//   length are skipped (dK/dV written as zeros), as on the fp32 path.
//   What bounds them at the training shape: not bytes (the kernels read their inputs
//   about once from L2) but dispatching the ldmatrix, mma and per-entry softmax and
//   dropout-hash instructions of 12 warps an SM, with little latency hidden; the dropout
//   hash adds about a quarter at p = 0.1 (PERF.md).
//
// fp32, f32 FMAs on the CUDA cores, kept for parity with the CPU (the card-vs-CPU checks
// hold fp32 training at 1e-4, which TF32 tensor cores would break):
//   1. delta_kernel: Delta (B, H, T) f32 = rowsum(dO o O), one warp per (b, t, h) row;
//   2. dkdv_kernel: one CTA per (64-key tile, head, batch row) holds its K and V tiles
//      (transposed, f32) in shared memory and walks every 64-query tile: it recomputes
//      S^T and dP^T for its keys (thread (ty, tx) owns keys 4ty..4ty+3 and queries
//      tx + 8c), forms P o Z and dS in registers, stages both through shared memory and
//      accumulates dV and dK in registers.  A key tile at or past a row's length (length
//      >= 1) has P = 0 exactly in f32, so it writes zeros and returns;
//   3. dq_kernel: one CTA per (64-query tile, head, batch row) holds its Q and dO tiles
//      and walks the key tiles below the row's length, recomputing S and dP (thread owns
//      queries 4ty..4ty+3, keys tx + 8c), and accumulates dQ = dS K in registers.
// Q, dO, K and V rows that are read per query/key are staged with a row stride of DP + 1
// floats, so the 8 lanes that read 8 rows at one column hit 8 banks.  Explicit (batch,
// time, head) strides cover both the native (B, T, H, D) layout (K2b) and a head-major
// buffer (K1b) with no transposes.  A 0-length row attends uniformly to all T keys in the
// forward (every key carries the same -1e9 bias, which the f32 sum rounds away); autograd
// through the dense version then passes dS = P o (dP - Delta) with P = 1/T into dQ and dK,
// and so do both paths (P = 1/T for such rows instead of exp(S - lse)).
//
// Head dims: as in attention_fwd.cu, every D from 1 to 128 runs the instantiation of the
// padded DP = 32, 48, ..., 128 (s2t_padded_head_dim) with the real D at run time: the tiles'
// columns past D are zero-filled, so they add nothing to S, dP or Delta and their dQ, dK and
// dV columns (which come out 0) are not stored; bf16 tiles copy 16, 4 or 2 bytes at a time
// as the rows allow (s2t_copy_width; the WIDE instantiations, run when every q/k/v/dO
// slice takes 16-byte copies of whole rows and D = DP, compile only those copies, the
// code the D = 32, 64 and 128 kernels ran before the other head dims), and delta_bf16_kernel reads a row's tail, or a row that is not 16-byte aligned,
// element by element.  MIN_CTAS of the D = 32, 64 and 128 instantiations is unchanged.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#include "dropout_hash.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int BM = 64;        // query rows per tile
constexpr int BN = 64;        // keys per tile
constexpr int THREADS = 128;  // 16 row groups x 8 column lanes
constexpr int PAD = 68;       // row stride of the transposed tiles, in floats
constexpr float NEG_BIAS = -1e9f;

// the FMA kernels are instantiated for float only; bf16 takes the tensor-core path
__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

struct Strides {
  long long b, t, h;  // in elements; the head-dim stride is 1
};

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  const int* lengths;
  const long long* seed;
  int B, T_len, H, D, rate_u8;  // D: the real head dim, <= the instantiation's padded DP
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  float scale, keep_scale;
};

// P (o Z) and dS of one (query, key) entry, from the raw dot products.
struct Entry {
  float pd, ds;
};

__device__ __forceinline__ Entry entry(float qk, float dpd, int query, int key, int T_len,
                                       int len, float lse, float delta, uint32_t stream,
                                       int rate_u8, float scale, float keep_scale) {
  float p;
  if (key >= T_len || query >= T_len) {
    p = 0.f;
  } else if (len == 0) {
    p = 1.f / (float)T_len;
  } else {
    float x = qk * scale;
    if (key >= len) x += NEG_BIAS;
    p = expf(x - lse);
  }
  float z = 1.f;
  if (rate_u8 > 0) z = s2t_dropout_keep(stream, query, key, rate_u8) ? keep_scale : 0.f;
  return Entry{p * z, p * (dpd * z - delta)};
}

template <typename T>
__global__ void delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                             float* __restrict__ delta, int B, int T_len, int H, int D,
                             Strides so, Strides sdo) {
  const long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= (long long)B * T_len * H) return;
  const int h = (int)(row % H);
  const int t = (int)((row / H) % T_len);
  const int b = (int)(row / ((long long)H * T_len));
  const T* orow = o + b * so.b + (long long)t * so.t + h * so.h;
  const T* drow = dout + b * sdo.b + (long long)t * sdo.t + h * sdo.h;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f32(orow[d]), to_f32(drow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[((long long)b * H + h) * T_len + t] = acc;
}

template <int DP>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(float) * (size_t)(2 * DP * PAD + 2 * BM * (DP + 1) + 2 * BM * PAD + 2 * BM);
}

// DP: the padded head dim of the tiles (mma_bf16.cuh); a.D <= DP the real one, whose
// columns alone are read (the others are zero) and written
template <typename T, int DP>
__global__ void __launch_bounds__(THREADS) dkdv_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [DP][PAD]     key tile, transposed
  float* Vs = Ks + DP * PAD;                    // [DP][PAD]     value tile, transposed
  float* Qr = Vs + DP * PAD;                    // [BM][DP + 1]  query tile
  float* Or = Qr + BM * (DP + 1);               // [BM][DP + 1]  dO tile
  float* Ps = Or + BM * (DP + 1);               // [BM][PAD]     P o Z, keys contiguous
  float* Ss = Ps + BM * PAD;                    // [BM][PAD]     dS, keys contiguous
  float* lse_s = Ss + BM * PAD;                 // [BM]
  float* dl_s = lse_s + BM;                     // [BM]

  constexpr int DC = DP / 8;
  const int D = a.D;
  const int tid = threadIdx.x;
  const int tx = tid & 7;
  const int ty = tid >> 3;
  const int n0 = blockIdx.x * BN;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int T_len = a.T_len;
  const int len = a.lengths[b];
  const int kv_end = len > 0 ? min(len, T_len) : T_len;

  T* dkb = static_cast<T*>(a.dk) + b * a.sdk.b + h * a.sdk.h;
  T* dvb = static_cast<T*>(a.dv) + b * a.sdv.b + h * a.sdv.h;
  if (n0 >= kv_end) {  // these keys carry no probability: zero gradient
    for (int idx = tid; idx < BN * D; idx += THREADS) {
      const int t = n0 + idx / D, d = idx % D;
      if (t < T_len) {
        dkb[(long long)t * a.sdk.t + d] = from_f32<T>(0.f);
        dvb[(long long)t * a.sdv.t + d] = from_f32<T>(0.f);
      }
    }
    return;
  }
  const T* qb = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* kb = static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h;
  const T* ob = static_cast<const T*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  const float* lse_b = a.lse + ((long long)b * a.H + h) * T_len;
  const float* dl_b = a.delta + ((long long)b * a.H + h) * T_len;
  const uint32_t stream =
      a.rate_u8 > 0 ? s2t_dropout_stream((unsigned long long)a.seed[0], b * a.H + h) : 0u;

  for (int idx = tid; idx < BN * DP; idx += THREADS) {
    const int r = idx / DP, d = idx % DP;
    const int t = n0 + r;
    const bool in = t < T_len && d < D;
    Ks[d * PAD + r] = in ? to_f32(kb[(long long)t * a.sk.t + d]) : 0.f;
    Vs[d * PAD + r] = in ? to_f32(vb[(long long)t * a.sv.t + d]) : 0.f;
  }

  float dk[4][DC], dv[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int m0 = 0; m0 < T_len; m0 += BM) {
    __syncthreads();  // the previous query tile's reads are done (and Ks / Vs written)
    for (int idx = tid; idx < BM * DP; idx += THREADS) {
      const int r = idx / DP, d = idx % DP;
      const int t = m0 + r;
      const bool in = t < T_len && d < D;
      Qr[r * (DP + 1) + d] = in ? to_f32(qb[(long long)t * a.sq.t + d]) : 0.f;
      Or[r * (DP + 1) + d] = in ? to_f32(ob[(long long)t * a.sdo.t + d]) : 0.f;
    }
    for (int r = tid; r < BM; r += THREADS) {
      const int t = m0 + r;
      lse_s[r] = t < T_len ? lse_b[t] : INFINITY;
      dl_s[r] = t < T_len ? dl_b[t] : 0.f;
    }
    __syncthreads();

    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      const float4 kf = *reinterpret_cast<const float4*>(&Ks[d * PAD + 4 * ty]);
      const float4 vf = *reinterpret_cast<const float4*>(&Vs[d * PAD + 4 * ty]);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float qv = Qr[(tx + 8 * c) * (DP + 1) + d];
        const float ov = Or[(tx + 8 * c) * (DP + 1) + d];
        s[0][c] = fmaf(kf.x, qv, s[0][c]);
        s[1][c] = fmaf(kf.y, qv, s[1][c]);
        s[2][c] = fmaf(kf.z, qv, s[2][c]);
        s[3][c] = fmaf(kf.w, qv, s[3][c]);
        dp[0][c] = fmaf(vf.x, ov, dp[0][c]);
        dp[1][c] = fmaf(vf.y, ov, dp[1][c]);
        dp[2][c] = fmaf(vf.z, ov, dp[2][c]);
        dp[3][c] = fmaf(vf.w, ov, dp[3][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = n0 + 4 * ty + i;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int ql = tx + 8 * c;
        const Entry e = entry(s[i][c], dp[i][c], m0 + ql, key, T_len, len, lse_s[ql], dl_s[ql],
                              stream, a.rate_u8, a.scale, a.keep_scale);
        s[i][c] = e.pd;
        dp[i][c] = e.ds;
      }
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      *reinterpret_cast<float4*>(&Ps[(tx + 8 * c) * PAD + 4 * ty]) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
      *reinterpret_cast<float4*>(&Ss[(tx + 8 * c) * PAD + 4 * ty]) =
          make_float4(dp[0][c], dp[1][c], dp[2][c], dp[3][c]);
    }
    __syncthreads();

    const int m_end = min(BM, T_len - m0);
#pragma unroll 2
    for (int r = 0; r < m_end; ++r) {
      const float4 pv = *reinterpret_cast<const float4*>(&Ps[r * PAD + 4 * ty]);
      const float4 sv = *reinterpret_cast<const float4*>(&Ss[r * PAD + 4 * ty]);
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const float ov = Or[r * (DP + 1) + tx + 8 * j];
        const float qv = Qr[r * (DP + 1) + tx + 8 * j];
        dv[0][j] = fmaf(pv.x, ov, dv[0][j]);
        dv[1][j] = fmaf(pv.y, ov, dv[1][j]);
        dv[2][j] = fmaf(pv.z, ov, dv[2][j]);
        dv[3][j] = fmaf(pv.w, ov, dv[3][j]);
        dk[0][j] = fmaf(sv.x, qv, dk[0][j]);
        dk[1][j] = fmaf(sv.y, qv, dk[1][j]);
        dk[2][j] = fmaf(sv.z, qv, dk[2][j]);
        dk[3][j] = fmaf(sv.w, qv, dk[3][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = n0 + 4 * ty + i;
    if (t < T_len) {
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        if (tx + 8 * j >= D) continue;
        dkb[(long long)t * a.sdk.t + tx + 8 * j] = from_f32<T>(dk[i][j] * a.scale);
        dvb[(long long)t * a.sdv.t + tx + 8 * j] = from_f32<T>(dv[i][j]);
      }
    }
  }
}

template <int DP>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (size_t)(2 * DP * PAD + 2 * BN * (DP + 1) + BN * PAD);
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS) dq_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [DP][PAD]     query tile, transposed
  float* Os = Qs + DP * PAD;                    // [DP][PAD]     dO tile, transposed
  float* Kr = Os + DP * PAD;                    // [BN][DP + 1]  key tile
  float* Vr = Kr + BN * (DP + 1);               // [BN][DP + 1]  value tile
  float* Ss = Vr + BN * (DP + 1);               // [BN][PAD]     dS, queries contiguous

  constexpr int DC = DP / 8;
  const int D = a.D;
  const int tid = threadIdx.x;
  const int tx = tid & 7;
  const int ty = tid >> 3;
  const int m0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int T_len = a.T_len;
  const int len = a.lengths[b];
  const int kv_end = len > 0 ? min(len, T_len) : T_len;

  const T* qb = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* kb = static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h;
  const T* ob = static_cast<const T*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  T* dqb = static_cast<T*>(a.dq) + b * a.sdq.b + h * a.sdq.h;
  const float* lse_b = a.lse + ((long long)b * a.H + h) * T_len;
  const float* dl_b = a.delta + ((long long)b * a.H + h) * T_len;
  const uint32_t stream =
      a.rate_u8 > 0 ? s2t_dropout_stream((unsigned long long)a.seed[0], b * a.H + h) : 0u;

  for (int idx = tid; idx < BM * DP; idx += THREADS) {
    const int r = idx / DP, d = idx % DP;
    const int t = m0 + r;
    const bool in = t < T_len && d < D;
    Qs[d * PAD + r] = in ? to_f32(qb[(long long)t * a.sq.t + d]) : 0.f;
    Os[d * PAD + r] = in ? to_f32(ob[(long long)t * a.sdo.t + d]) : 0.f;
  }
  float lse_r[4], dl_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = m0 + 4 * ty + i;
    lse_r[i] = t < T_len ? lse_b[t] : INFINITY;
    dl_r[i] = t < T_len ? dl_b[t] : 0.f;
  }

  float dq[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) dq[i][j] = 0.f;

  for (int n0 = 0; n0 < kv_end; n0 += BN) {
    __syncthreads();  // the previous key tile's reads are done (and Qs / Os written)
    for (int idx = tid; idx < BN * DP; idx += THREADS) {
      const int r = idx / DP, d = idx % DP;
      const int t = n0 + r;
      const bool in = t < T_len && d < D;
      Kr[r * (DP + 1) + d] = in ? to_f32(kb[(long long)t * a.sk.t + d]) : 0.f;
      Vr[r * (DP + 1) + d] = in ? to_f32(vb[(long long)t * a.sv.t + d]) : 0.f;
    }
    __syncthreads();

    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      const float4 qf = *reinterpret_cast<const float4*>(&Qs[d * PAD + 4 * ty]);
      const float4 of = *reinterpret_cast<const float4*>(&Os[d * PAD + 4 * ty]);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float kv = Kr[(tx + 8 * c) * (DP + 1) + d];
        const float vv = Vr[(tx + 8 * c) * (DP + 1) + d];
        s[0][c] = fmaf(qf.x, kv, s[0][c]);
        s[1][c] = fmaf(qf.y, kv, s[1][c]);
        s[2][c] = fmaf(qf.z, kv, s[2][c]);
        s[3][c] = fmaf(qf.w, kv, s[3][c]);
        dp[0][c] = fmaf(of.x, vv, dp[0][c]);
        dp[1][c] = fmaf(of.y, vv, dp[1][c]);
        dp[2][c] = fmaf(of.z, vv, dp[2][c]);
        dp[3][c] = fmaf(of.w, vv, dp[3][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int query = m0 + 4 * ty + i;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const Entry e = entry(s[i][c], dp[i][c], query, n0 + tx + 8 * c, T_len, len, lse_r[i],
                              dl_r[i], stream, a.rate_u8, a.scale, a.keep_scale);
        dp[i][c] = e.ds;
      }
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      *reinterpret_cast<float4*>(&Ss[(tx + 8 * c) * PAD + 4 * ty]) =
          make_float4(dp[0][c], dp[1][c], dp[2][c], dp[3][c]);
    }
    __syncthreads();

    const int n_end = min(BN, kv_end - n0);
#pragma unroll 2
    for (int r = 0; r < n_end; ++r) {
      const float4 sv = *reinterpret_cast<const float4*>(&Ss[r * PAD + 4 * ty]);
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const float kv = Kr[r * (DP + 1) + tx + 8 * j];
        dq[0][j] = fmaf(sv.x, kv, dq[0][j]);
        dq[1][j] = fmaf(sv.y, kv, dq[1][j]);
        dq[2][j] = fmaf(sv.z, kv, dq[2][j]);
        dq[3][j] = fmaf(sv.w, kv, dq[3][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = m0 + 4 * ty + i;
    if (t < T_len) {
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        if (tx + 8 * j < D)
          dqb[(long long)t * a.sdq.t + tx + 8 * j] = from_f32<T>(dq[i][j] * a.scale);
      }
    }
  }
}

// ---- bf16 on the tensor cores ---------------------------------------------------------
using bf16 = __nv_bfloat16;
constexpr int MMA_WARPS = 4;  // one warp per 16 rows of a 64-row tile
constexpr int MMA_THREADS = 32 * MMA_WARPS;
static_assert(BM == 16 * MMA_WARPS && BN == 16 * MMA_WARPS, "64-row tiles of 4 warps");

template <int DP>
struct MmaTiles {
  static constexpr int LD = s2t_tile_ld<DP>();
  static constexpr int BQ = 32;                  // query tile of dkdv_mma_kernel
  static constexpr int BK = DP <= 64 ? 64 : 32;  // key tile of dq_mma_kernel
  // CTAs per SM the register budget aims at: 3 at DP <= 64 (at most 168 registers a
  // thread), measured 14 % faster than the 2 that 172-255 registers allow
  static constexpr int MIN_CTAS = DP <= 64 ? 3 : 1;
  // lanes of delta_bf16_kernel per (b, t, h) row, 8 columns each: a power of two so a row's
  // lanes reduce by xor shuffles inside one warp
  static constexpr int DELTA_LANES = DP <= 32 ? 4 : (DP <= 64 ? 8 : 16);
  static constexpr size_t dkdv_smem =
      sizeof(bf16) * (size_t)(2 * BN + 4 * BQ) * LD + sizeof(float) * 4 * BQ;
  static constexpr size_t dq_smem = sizeof(bf16) * (size_t)(2 * BM + 4 * BK) * LD;
};

template <int DP>
__global__ void delta_bf16_kernel(const float* __restrict__ o, const bf16* __restrict__ dout,
                                  float* __restrict__ delta, int B, int T_len, int H, int D,
                                  Strides so, Strides sdo) {
  constexpr int LANES = MmaTiles<DP>::DELTA_LANES;  // 8 columns a lane; a row's lanes share a warp
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = i / LANES;
  const int part = (int)(i % LANES);
  const bool in = row < (long long)B * T_len * H;
  const int h = (int)(row % H);
  const int t = (int)((row / H) % T_len);
  const int b = (int)(row / ((long long)H * T_len));
  float acc = 0.f;
  const int c0 = 8 * part;
  if (in && c0 < D) {
    const float* orow = o + b * so.b + (long long)t * so.t + h * so.h + c0;
    const bf16* drow = dout + b * sdo.b + (long long)t * sdo.t + h * sdo.h + c0;
    if (c0 + 8 <= D && reinterpret_cast<unsigned long long>(orow) % 16 == 0 &&
        reinterpret_cast<unsigned long long>(drow) % 16 == 0) {  // 16-byte loads
      const float4* op = reinterpret_cast<const float4*>(orow);
      const float4 o0 = op[0], o1 = op[1];
      const uint4 dv = *reinterpret_cast<const uint4*>(drow);
      const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(&dv);
      const float x[8] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 y = __bfloat1622float2(dp[j]);
        acc = fmaf(x[2 * j], y.x, acc);
        acc = fmaf(x[2 * j + 1], y.y, acc);
      }
    } else {  // the row's tail, or a row that is not 16-byte aligned
      for (int j = 0; j < 8 && c0 + j < D; ++j)
        acc = fmaf(orow[j], __bfloat162float(drow[j]), acc);
    }
  }
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (in && part == 0) delta[((long long)b * H + h) * T_len + t] = acc;
}

// WIDE: every q/k/v/dO slice takes 16-byte copies of whole rows, D = DP (s2t_wide_rows)
template <int DP, bool WIDE>
__global__ void __launch_bounds__(MMA_THREADS, MmaTiles<DP>::MIN_CTAS) dkdv_mma_kernel(Args a) {
  using Cfg = MmaTiles<DP>;
  constexpr int LD = Cfg::LD;
  constexpr int BQ = Cfg::BQ;
  constexpr int KD = DP / 16;
  const int D = WIDE ? DP : a.D;  // a constant in the WIDE kernels
  extern __shared__ float4 smem4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem4);                  // [BN][LD]
  bf16* Vs = Ks + BN * LD;                                    // [BN][LD]
  bf16* Qs = Vs + BN * LD;                                    // [2][BQ][LD]
  bf16* Os = Qs + 2 * BQ * LD;                                // [2][BQ][LD]   dO
  float* lse_s = reinterpret_cast<float*>(Os + 2 * BQ * LD);  // [2][BQ]
  float* dl_s = lse_s + 2 * BQ;                               // [2][BQ]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  const int n0 = blockIdx.x * BN;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int T_len = a.T_len;
  const int len = a.lengths[b];
  const int kv_end = len > 0 ? min(len, T_len) : T_len;

  bf16* dkb = static_cast<bf16*>(a.dk) + b * a.sdk.b + h * a.sdk.h;
  bf16* dvb = static_cast<bf16*>(a.dv) + b * a.sdv.b + h * a.sdv.h;
  if (n0 >= kv_end) {  // these keys carry no probability: zero gradient
    for (int idx = tid; idx < BN * D; idx += MMA_THREADS) {
      const int t = n0 + idx / D, d = idx % D;
      if (t < T_len) {
        dkb[(long long)t * a.sdk.t + d] = __float2bfloat16(0.f);
        dvb[(long long)t * a.sdv.t + d] = __float2bfloat16(0.f);
      }
    }
    return;
  }
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.sq.b + h * a.sq.h;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.sk.b + h * a.sk.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.sv.b + h * a.sv.h;
  const bf16* ob = static_cast<const bf16*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  const float* lse_b = a.lse + ((long long)b * a.H + h) * T_len;
  const float* dl_b = a.delta + ((long long)b * a.H + h) * T_len;
  const uint32_t stream =
      a.rate_u8 > 0 ? s2t_dropout_stream((unsigned long long)a.seed[0], b * a.H + h) : 0u;

  // Q, dO, lse and Delta of queries [m0, m0 + BQ) into buffer buf (lse / Delta rows are 4
  // bytes apart with no 16-byte alignment, so they come 4 bytes a thread)
  auto load_queries = [&](int buf, int m0) {
    s2t_load_tile<BQ, DP, MMA_THREADS, WIDE>(Qs + buf * BQ * LD, qb, a.sq.t, m0, T_len, D, tid);
    s2t_load_tile<BQ, DP, MMA_THREADS, WIDE>(Os + buf * BQ * LD, ob, a.sdo.t, m0, T_len, D, tid);
    if (tid < 2 * BQ) {
      const int r = tid % BQ, t = m0 + r;
      const bool in = t < T_len;
      const float* src = (tid < BQ ? lse_b : dl_b) + (in ? t : 0);
      s2t_cp_async_4(s2t_smem_addr((tid < BQ ? lse_s : dl_s) + buf * BQ + r), src, in);
    }
  };
  s2t_load_tile<BN, DP, MMA_THREADS, WIDE>(Ks, kb, a.sk.t, n0, T_len, D, tid);
  s2t_load_tile<BN, DP, MMA_THREADS, WIDE>(Vs, vb, a.sv.t, n0, T_len, D, tid);
  load_queries(0, 0);
  s2t_cp_async_commit();

  float dk[DP / 8][4], dv[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  const int n_q = (T_len + BQ - 1) / BQ;
  for (int it = 0; it < n_q; ++it) {
    const int m0 = it * BQ;
    const int buf = it & 1;
    if (it + 1 < n_q) {  // the next query tile's copy runs during this tile's math
      load_queries(buf ^ 1, m0 + BQ);
      s2t_cp_async_commit();
      s2t_cp_async_wait<1>();
    } else {
      s2t_cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qt = Qs + buf * BQ * LD;
    const bf16* Ot = Os + buf * BQ * LD;
    const float* lse_t = lse_s + buf * BQ;
    const float* dl_t = dl_s + buf * BQ;

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x BQ queries
    float st[BQ / 8][4], dpt[BQ / 8][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ka[4], va[4];  // this warp's K and V fragments, read again per tile
      s2t_ldmatrix_x4(ka, s2t_smem_addr(s2t_a_frag_row(Ks, LD, 16 * warp, 16 * kk, lane)));
      s2t_ldmatrix_x4(va, s2t_smem_addr(s2t_a_frag_row(Vs, LD, 16 * warp, 16 * kk, lane)));
#pragma unroll
      for (int np = 0; np < BQ / 16; ++np) {
        uint32_t bq[4], bo[4];
        s2t_ldmatrix_x4(bq, s2t_smem_addr(s2t_b_frag_row(Qt, LD, 16 * np, 16 * kk, lane)));
        s2t_mma_bf16(st[2 * np], ka, bq[0], bq[1]);
        s2t_mma_bf16(st[2 * np + 1], ka, bq[2], bq[3]);
        s2t_ldmatrix_x4(bo, s2t_smem_addr(s2t_b_frag_row(Ot, LD, 16 * np, 16 * kk, lane)));
        s2t_mma_bf16(dpt[2 * np], va, bo[0], bo[1]);
        s2t_mma_bf16(dpt[2 * np + 1], va, bo[2], bo[3]);
      }
    }
    // P o Z and dS per entry: fragment rows are keys, columns queries
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = 8 * j + c2 + (e & 1);
        const Entry en = entry(st[j][e], dpt[j][e], m0 + ql, n0 + 16 * warp + g + 8 * (e >> 1),
                               T_len, len, lse_t[ql], dl_t[ql], stream, a.rate_u8, a.scale,
                               a.keep_scale);
        st[j][e] = en.pd;
        dpt[j][e] = en.ds;
      }
    }
    // dV += (P o Z)^T dO and dK += dS^T Q, both rounded to bf16 in registers
#pragma unroll
    for (int kq = 0; kq < BQ / 16; ++kq) {
      uint32_t pa[4], sa[4];
      s2t_acc_to_a(pa, st[2 * kq], st[2 * kq + 1]);
      s2t_acc_to_a(sa, dpt[2 * kq], dpt[2 * kq + 1]);
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        uint32_t bo[4], bq[4];
        s2t_ldmatrix_x4_trans(bo, s2t_smem_addr(s2t_bt_frag_row(Ot, LD, 16 * kq, 16 * dp, lane)));
        s2t_mma_bf16(dv[2 * dp], pa, bo[0], bo[1]);
        s2t_mma_bf16(dv[2 * dp + 1], pa, bo[2], bo[3]);
        s2t_ldmatrix_x4_trans(bq, s2t_smem_addr(s2t_bt_frag_row(Qt, LD, 16 * kq, 16 * dp, lane)));
        s2t_mma_bf16(dk[2 * dp], sa, bq[0], bq[1]);
        s2t_mma_bf16(dk[2 * dp + 1], sa, bq[2], bq[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = n0 + 16 * warp + g + 8 * r;
    if (t < T_len) {
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        s2t_store_pair<WIDE>(dkb + (long long)t * a.sdk.t + 8 * j + c2, 8 * j + c2, D,
                             dk[j][2 * r] * a.scale, dk[j][2 * r + 1] * a.scale);
        s2t_store_pair<WIDE>(dvb + (long long)t * a.sdv.t + 8 * j + c2, 8 * j + c2, D,
                             dv[j][2 * r], dv[j][2 * r + 1]);
      }
    }
  }
}

template <int DP, bool WIDE>
__global__ void __launch_bounds__(MMA_THREADS, MmaTiles<DP>::MIN_CTAS) dq_mma_kernel(Args a) {
  using Cfg = MmaTiles<DP>;
  constexpr int LD = Cfg::LD;
  constexpr int BK = Cfg::BK;
  constexpr int KD = DP / 16;
  const int D = WIDE ? DP : a.D;  // a constant in the WIDE kernels
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);  // [BM][LD]
  bf16* Os = Qs + BM * LD;                    // [BM][LD]      dO
  bf16* Ks = Os + BM * LD;                    // [2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;                // [2][BK][LD]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  const int m0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int T_len = a.T_len;
  const int len = a.lengths[b];
  const int kv_end = len > 0 ? min(len, T_len) : T_len;
  const int n_k = (kv_end + BK - 1) / BK;

  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.sq.b + h * a.sq.h;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.sk.b + h * a.sk.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.sv.b + h * a.sv.h;
  const bf16* ob = static_cast<const bf16*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  bf16* dqb = static_cast<bf16*>(a.dq) + b * a.sdq.b + h * a.sdq.h;
  const float* lse_b = a.lse + ((long long)b * a.H + h) * T_len;
  const float* dl_b = a.delta + ((long long)b * a.H + h) * T_len;
  const uint32_t stream =
      a.rate_u8 > 0 ? s2t_dropout_stream((unsigned long long)a.seed[0], b * a.H + h) : 0u;

  s2t_load_tile<BM, DP, MMA_THREADS, WIDE>(Qs, qb, a.sq.t, m0, T_len, D, tid);
  s2t_load_tile<BM, DP, MMA_THREADS, WIDE>(Os, ob, a.sdo.t, m0, T_len, D, tid);
  s2t_load_tile<BK, DP, MMA_THREADS, WIDE>(Ks, kb, a.sk.t, 0, T_len, D, tid);
  s2t_load_tile<BK, DP, MMA_THREADS, WIDE>(Vs, vb, a.sv.t, 0, T_len, D, tid);
  s2t_cp_async_commit();

  float lse_r[2], dl_r[2];  // rows g and g + 8 of this warp (unused past T: P = 0 there)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = m0 + 16 * warp + g + 8 * r;
    lse_r[r] = t < T_len ? lse_b[t] : 0.f;
    dl_r[r] = t < T_len ? dl_b[t] : 0.f;
  }
  uint32_t qf[KD][4], of[KD][4];
  float dq[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  for (int it = 0; it < n_k; ++it) {
    const int n0 = it * BK;
    if (it + 1 < n_k) {  // the next key tile's copy runs during this tile's math
      const int nb = (it + 1) & 1;
      s2t_load_tile<BK, DP, MMA_THREADS, WIDE>(Ks + nb * BK * LD, kb, a.sk.t, n0 + BK, T_len, D,
                                               tid);
      s2t_load_tile<BK, DP, MMA_THREADS, WIDE>(Vs + nb * BK * LD, vb, a.sv.t, n0 + BK, T_len, D,
                                               tid);
      s2t_cp_async_commit();
      s2t_cp_async_wait<1>();
    } else {
      s2t_cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        s2t_ldmatrix_x4(qf[kk], s2t_smem_addr(s2t_a_frag_row(Qs, LD, 16 * warp, 16 * kk, lane)));
        s2t_ldmatrix_x4(of[kk], s2t_smem_addr(s2t_a_frag_row(Os, LD, 16 * warp, 16 * kk, lane)));
      }
    }
    const bf16* Kt = Ks + (it & 1) * BK * LD;
    const bf16* Vt = Vs + (it & 1) * BK * LD;

    // S = Q K^T and dP = dO V^T: this warp's 16 queries x BK keys
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t bk[4], bv[4];
        s2t_ldmatrix_x4(bk, s2t_smem_addr(s2t_b_frag_row(Kt, LD, 16 * np, 16 * kk, lane)));
        s2t_mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
        s2t_mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
        s2t_ldmatrix_x4(bv, s2t_smem_addr(s2t_b_frag_row(Vt, LD, 16 * np, 16 * kk, lane)));
        s2t_mma_bf16(dp[2 * np], of[kk], bv[0], bv[1]);
        s2t_mma_bf16(dp[2 * np + 1], of[kk], bv[2], bv[3]);
      }
    }
    // dS per entry: fragment rows are queries, columns keys
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const Entry en = entry(s[j][e], dp[j][e], m0 + 16 * warp + g + 8 * (e >> 1),
                               n0 + 8 * j + c2 + (e & 1), T_len, len, lse_r[e >> 1],
                               dl_r[e >> 1], stream, a.rate_u8, a.scale, a.keep_scale);
        s[j][e] = en.ds;
      }
    }
    // dQ += dS K, dS rounded to bf16 in registers, K through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t sa[4];
      s2t_acc_to_a(sa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dd = 0; dd < DP / 16; ++dd) {
        uint32_t bk[4];
        s2t_ldmatrix_x4_trans(bk, s2t_smem_addr(s2t_bt_frag_row(Kt, LD, 16 * kk, 16 * dd, lane)));
        s2t_mma_bf16(dq[2 * dd], sa, bk[0], bk[1]);
        s2t_mma_bf16(dq[2 * dd + 1], sa, bk[2], bk[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = m0 + 16 * warp + g + 8 * r;
    if (t < T_len) {
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        s2t_store_pair<WIDE>(dqb + (long long)t * a.sdq.t + 8 * j + c2, 8 * j + c2, D,
                             dq[j][2 * r] * a.scale, dq[j][2 * r + 1] * a.scale);
      }
    }
  }
}

template <int DP, bool WIDE>
cudaError_t launch_mma_width(const Args& a, cudaStream_t stream) {
  using Cfg = MmaTiles<DP>;
  const long long threads = (long long)a.B * a.T_len * a.H * Cfg::DELTA_LANES;
  delta_bf16_kernel<DP><<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(a.o), static_cast<const bf16*>(a.dout), a.delta, a.B, a.T_len,
      a.H, a.D, a.so, a.sdo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(dkdv_mma_kernel<DP, WIDE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Cfg::dkdv_smem);
  if (err != cudaSuccess) return err;
  dkdv_mma_kernel<DP, WIDE><<<dim3((a.T_len + BN - 1) / BN, a.H, a.B), MMA_THREADS, Cfg::dkdv_smem,
                       stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(dq_mma_kernel<DP, WIDE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Cfg::dq_smem);
  if (err != cudaSuccess) return err;
  dq_mma_kernel<DP, WIDE><<<dim3((a.T_len + BM - 1) / BM, a.H, a.B), MMA_THREADS, Cfg::dq_smem,
                     stream>>>(a);
  return cudaGetLastError();
}

// the 16-byte copies alone when every q/k/v/dO slice allows them
template <int DP>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  const bool wide = s2t_wide_rows(a.q, a.sq.b, a.sq.t, a.sq.h, a.D) &&
                    s2t_wide_rows(a.k, a.sk.b, a.sk.t, a.sk.h, a.D) &&
                    s2t_wide_rows(a.v, a.sv.b, a.sv.t, a.sv.h, a.D) &&
                    s2t_wide_rows(a.dout, a.sdo.b, a.sdo.t, a.sdo.h, a.D);
  return wide ? launch_mma_width<DP, true>(a, stream) : launch_mma_width<DP, false>(a, stream);
}

// the instantiation of the padded head dim s2t_padded_head_dim(D)
cudaError_t dispatch_mma(int D, const Args& a, cudaStream_t stream) {
  switch (s2t_padded_head_dim(D)) {
    case 32: return launch_mma<32>(a, stream);
    case 48: return launch_mma<48>(a, stream);
    case 64: return launch_mma<64>(a, stream);
    case 80: return launch_mma<80>(a, stream);
    case 96: return launch_mma<96>(a, stream);
    case 112: return launch_mma<112>(a, stream);
    case 128: return launch_mma<128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int DP>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const long long rows = (long long)a.B * a.T_len * a.H;
  const int warps_per_block = 8;
  delta_kernel<T><<<(unsigned)((rows + warps_per_block - 1) / warps_per_block),
                    32 * warps_per_block, 0, stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.delta, a.B, a.T_len, a.H,
      a.D, a.so, a.sdo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t smem_kv = dkdv_smem_bytes<DP>();
  err = cudaFuncSetAttribute(dkdv_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_kv);
  if (err != cudaSuccess) return err;
  dkdv_kernel<T, DP><<<dim3((a.T_len + BN - 1) / BN, a.H, a.B), THREADS, smem_kv, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t smem_q = dq_smem_bytes<DP>();
  err = cudaFuncSetAttribute(dq_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_q);
  if (err != cudaSuccess) return err;
  dq_kernel<T, DP><<<dim3((a.T_len + BM - 1) / BM, a.H, a.B), THREADS, smem_q, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const Args& a, cudaStream_t stream) {
  switch (s2t_padded_head_dim(D)) {
    case 32: return launch<T, 32>(a, stream);
    case 48: return launch<T, 48>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 80: return launch<T, 80>(a, stream);
    case 96: return launch<T, 96>(a, stream);
    case 112: return launch<T, 112>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: (B, T, H, D), 1 <= D <= 128, with element strides
// (b, t, h) and a unit head-dim stride, at any element alignment; o is the forward's output
// in float32 whatever the dtype (for bfloat16 the O the forward wrote before its bf16
// rounding); lse: (B, H, T) float32 from the forward; delta: (B, H, T) float32 scratch;
// lengths: (B,) int32; seed: one int64 (read only when rate_u8 > 0), all on the device.
// dtype_code 0 = float32 (FMA kernels), 1 = bfloat16 (tensor-core kernels).  Returns the
// first cudaError_t (0 on success).
extern "C" int s2t_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* delta, void* dq, void* dk, void* dv, const void* lengths,
    const void* seed, int B, int T_len, int H, int D, int dtype_code, int rate_u8,
    long long sq_b, long long sq_t, long long sq_h, long long sk_b, long long sk_t,
    long long sk_h, long long sv_b, long long sv_t, long long sv_h, long long so_b,
    long long so_t, long long so_h, long long sdo_b, long long sdo_t, long long sdo_h,
    long long sdq_b, long long sdq_t, long long sdq_h, long long sdk_b, long long sdk_t,
    long long sdk_h, long long sdv_b, long long sdv_t, long long sdv_h, float scale,
    float keep_scale, void* stream) {
  if (rate_u8 < 0 || rate_u8 > 255 || (rate_u8 > 0 && seed == nullptr)) return cudaErrorInvalidValue;
  if (D < 1 || D > 128) return cudaErrorInvalidValue;
  const Args a{q, k, v, o, dout, static_cast<const float*>(lse), static_cast<float*>(delta),
               dq, dk, dv, static_cast<const int*>(lengths), static_cast<const long long*>(seed),
               B, T_len, H, D, rate_u8,
               Strides{sq_b, sq_t, sq_h}, Strides{sk_b, sk_t, sk_h}, Strides{sv_b, sv_t, sv_h},
               Strides{so_b, so_t, so_h}, Strides{sdo_b, sdo_t, sdo_h},
               Strides{sdq_b, sdq_t, sdq_h}, Strides{sdk_b, sdk_t, sdk_h},
               Strides{sdv_b, sdv_t, sdv_h}, scale, keep_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0) return dispatch_d<float>(D, a, st);
  if (dtype_code == 1) return dispatch_mma(D, a, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* s2t_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
