// CTC lattice recurrences for Hopper (sm_90a): the alpha pass (K3) and the reverse beta
// pass fused with the emission gradient (K4), f32 log-space with NEG_INF = -1e30 (never
// -inf, so no inf - inf appears).
//
// Replaces: s2t_tpu/ops/ctc_pallas.py:_alpha_kernel (reached through _run_alpha) and
// _beta_grad_kernel (reached through _nll_bwd), the custom_vjp of the CTC negative
// log-likelihood over a dense (T, B, S) emission table, S = 2U + 1 lattice states.
//
//   ctc_alpha:      alpha_0 = emit_0 on states 0 and 1, NEG_INF elsewhere; for t >= 1
//                   alpha_t = logaddexp(alpha, shift1(alpha), shift2(alpha) + skip) + emit_t
//                   while t < length, carried unchanged after; every row goes to alphas.
//   ctc_beta_grad:  beta starts at `final` (0 on the two terminal states); going down from
//                   t = T - 1, d nll / d emit[t] = -exp(alpha_t + beta - logZ) for t < length
//                   (0 after), then beta = logaddexp(z, shiftleft1(z), shiftleft2(z) +
//                   skip_from), z = beta + emit_t, for t <= length - 1.  Invariant: beta
//                   equals final until t = length - 1, as in the TPU kernel.
//
// Bound on this card: at the training shape (B=40, T'=250, S=59) the alpha pass moves
// emit in and alphas out, 2 x 2.36 MB (0.0014 ms at 3.35 TB/s), the beta pass emit and
// alphas in and the gradient out, 3 x 2.36 MB (0.0021 ms).  Neither is what bounds it: each
// is a chain of T - 1 dependent steps, so its time is at least the latency of one step's
// dependent arithmetic times T.  chip_smoke.py measures that floor with
// ctc_chain_floor_kernel, one warp running the step on register values with no loads and
// no stores, and takes the bound as the larger of the two: K3's step (two shuffles, two
// logaddexp with the accurate expf and log1pf, an add), ~0.26 us on an H100, 0.064 ms for
// 249 steps, 50x the bytes; K4's own step (its gradient entry's expf, an add, two shuffles,
// two logaddexp), written for one warp as K3's is, for the design K4 does not have yet.
//
// The TPU kernel walks T inside one program with the whole (B, S) state in VMEM.
//
// Alpha (K3), S <= 256: ctc_alpha_warp_kernel<R>, one warp per batch row.  Lane l holds
// states [l R, l R + R) in registers, R = ceil(S / 32) (1..8, a template parameter the
// launcher picks); a state's shift-by-1 and shift-by-2 inputs are its own lane's registers
// or the previous lane's last two states, read with __shfl_up_sync, so a step has no
// barrier.  The emissions of step t come through cp.async (4-byte copies: rows are B S
// floats apart) into a ring of PREFETCH slots per lane in shared memory, PREFETCH - 1
// steps ahead, off the chain; only the lane that copied a slot reads it, after its
// cp.async.wait_group.  A ring in registers needs the step loop unrolled by its depth;
// that version ran slower on the card, also with its loads taken out, which points at the
// instruction stream of the one warp an SM holds rather than at the loads.
// Alphas go out with plain stores.  Per state the operations and their order are the
// plain version's, logaddexp with expf and log1pf.  A CTA holds one warp: on an H100 one
// row a CTA ran within 5 % of two, four and eight (PERF.md).
//
// Alpha, S > 256, and beta (K4): ctc_alpha_kernel / ctc_beta_grad_kernel, one CTA per
// batch row walking T; the S states lie across the threads (a thread takes states tid,
// tid + blockDim, ... when S > blockDim).  The alpha pass keeps alpha double-buffered in
// shared memory behind two NEG_INF guard slots, so one barrier per step orders the reads
// of step t - 1 before the writes of step t.  The beta pass keeps beta per thread and
// double-buffers z = beta + emit_t, with two NEG_INF guard slots after state S - 1, again
// one barrier per step.  Rows past a batch row's length are written without any barrier
// (carried alphas, zero gradients).

#include <cuda_runtime.h>
#include <math.h>

#include "mma_bf16.cuh"  // cp.async

namespace {

constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float logaddexp(float a, float b) {
  // jnp.logaddexp for finite inputs: max + log1p(exp(-|a - b|))
  return fmaxf(a, b) + log1pf(expf(-fabsf(a - b)));
}

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARP_MAX_R = 8;  // states per lane: one warp walks S <= 256
constexpr int PREFETCH = 16;   // slots of a lane's emission ring: rows in flight ahead

// One alpha step of the R states lane `lane` holds (valid[r]: state l R + r < S; the
// others stay NEG_INF): new[s] = logaddexp(logaddexp(a[s], a[s-1]), a[s-2] + skip[s]) + e[s].
template <int R>
__device__ __forceinline__ void alpha_step(float (&a)[R], const float (&skip)[R],
                                           const float (&e)[R], const bool (&valid)[R],
                                           int lane) {
  // the previous lane's last state, and the one before it (two lanes back when R == 1)
  float p1 = __shfl_up_sync(FULL, a[R - 1], 1);
  float p2;
  if constexpr (R >= 2) {
    p2 = __shfl_up_sync(FULL, a[R - 2], 1);
  } else {
    p2 = __shfl_up_sync(FULL, a[0], 2);
  }
  if (lane < 1) p1 = NEG_INF;
  if (lane < (R >= 2 ? 1 : 2)) p2 = NEG_INF;
  float nw[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float s1 = r >= 1 ? a[r - 1] : p1;
    const float s2 = r >= 2 ? a[r - 2] : (r == 1 ? p1 : p2);
    nw[r] = logaddexp(logaddexp(a[r], s1), s2 + skip[r]) + e[r];
  }
#pragma unroll
  for (int r = 0; r < R; ++r) a[r] = valid[r] ? nw[r] : NEG_INF;
}

template <int R>
__global__ void ctc_alpha_warp_kernel(const float* __restrict__ emit,
                                      const float* __restrict__ skip,
                                      const int* __restrict__ lengths, float* __restrict__ alphas,
                                      int T_len, int B, int S) {
  extern __shared__ float ring_s[];  // [PREFETCH][32 R]: each lane's own slots
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  float* ring = ring_s + lane * R;
  const long long row = (long long)B * S;  // elements per time step
  const float* e = emit + (long long)b * S + lane * R;
  float* out = alphas + (long long)b * S + lane * R;
  const int steps = min(max(lengths[b], 1), T_len);

  bool valid[R];
  float a[R], sk[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = lane * R + r;
    valid[r] = s < S;
    sk[r] = valid[r] ? skip[(long long)b * S + s] : NEG_INF;
    a[r] = valid[r] && s < 2 ? e[r] : NEG_INF;
    if (valid[r]) out[r] = a[r];
  }
  // the emissions of step t land in slot t % PREFETCH through cp.async, PREFETCH - 1 steps
  // ahead of their use, one commit group a step (empty past the row's steps)
  auto fetch = [&](int t) {
    float* slot = ring + (t % PREFETCH) * 32 * R;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool in = valid[r] && t < steps;
      s2t_cp_async_4(s2t_smem_addr(slot + r), in ? e + t * row + r : e, in);
    }
    s2t_cp_async_commit();
  };
  for (int t = 1; t < PREFETCH; ++t) fetch(t);
  for (int t = 1; t < steps; ++t) {
    s2t_cp_async_wait<PREFETCH - 2>();  // step t's group has landed
    float et[R];
    const float* slot = ring + (t % PREFETCH) * 32 * R;
#pragma unroll
    for (int r = 0; r < R; ++r) et[r] = slot[r];
    fetch(t + PREFETCH - 1);  // into the slot step t - 1 read
    alpha_step<R>(a, sk, et, valid, lane);
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (valid[r]) out[t * row + r] = a[r];
  }
  // frames at or past the length carry alpha unchanged
  for (int t = steps; t < T_len; ++t) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (valid[r]) out[t * row + r] = a[r];
  }
}

// One step of K4 written for one warp as alpha_step is: the gradient entry
// -exp(alpha + beta - logZ) of each state (summed into g, off the chain), then z = beta + e
// and new[s] = logaddexp(logaddexp(z[s], z[s+1]), z[s+2] + skip_from[s]), the shifted
// inputs from this lane's registers or the next lane's first two states (two lanes ahead
// when R == 1) read with __shfl_down_sync.
template <int R>
__device__ __forceinline__ void beta_step(float (&bt)[R], float (&g)[R],
                                          const float (&skip_from)[R], const float (&e)[R],
                                          const float (&al)[R], float lz, const bool (&valid)[R],
                                          int lane) {
  float z[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    g[r] -= expf(al[r] + bt[r] - lz);
    z[r] = bt[r] + e[r];
  }
  float n1 = __shfl_down_sync(FULL, z[0], 1);
  float n2;
  if constexpr (R >= 2) {
    n2 = __shfl_down_sync(FULL, z[1], 1);
  } else {
    n2 = __shfl_down_sync(FULL, z[0], 2);
  }
  if (lane >= 31) n1 = NEG_INF;
  if (lane >= (R >= 2 ? 31 : 30)) n2 = NEG_INF;
  float nw[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float s1 = r + 1 < R ? z[r + 1] : n1;
    const float s2 = r + 2 < R ? z[r + 2] : (r + 2 == R ? n1 : n2);
    nw[r] = logaddexp(logaddexp(z[r], s1), s2 + skip_from[r]);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) bt[r] = valid[r] ? nw[r] : NEG_INF;
}

// The chain floor of one lattice step: `steps - 1` dependent alpha_step<R> (K3's step) or,
// with BETA, beta_step<R> (K4's: its gradient entry and its beta update) on register values
// (emissions, alphas and skips made from the state index), no loads, and one store of the
// last state so the chain is not dead code.  One warp; a measurement for chip_smoke.py.
template <int R, bool BETA>
__global__ void ctc_chain_floor_kernel(float* __restrict__ out, int steps, int S) {
  const int lane = threadIdx.x & 31;
  bool valid[R];
  float a[R], sk[R], e[R], al[R], g[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = lane * R + r;
    valid[r] = s < S;
    e[r] = -1.f - 0.25f * (float)(s % 7);
    g[r] = 0.f;
    if constexpr (BETA) {  // beta starts at `final`: 0 on the two terminal states
      sk[r] = (s + 2) % 2 == 1 && s + 2 >= 3 && s + 2 < S ? 0.f : NEG_INF;  // skip_from
      al[r] = -2.f - 0.125f * (float)(s % 5);
      a[r] = valid[r] && s >= S - 2 ? 0.f : NEG_INF;
    } else {
      sk[r] = s % 2 == 1 && s >= 3 ? 0.f : NEG_INF;
      al[r] = 0.f;
      a[r] = valid[r] && s < 2 ? e[r] : NEG_INF;
    }
  }
  for (int t = 1; t < steps; ++t) {
    if constexpr (BETA) {
      beta_step<R>(a, g, sk, e, al, -3.f, valid, lane);
    } else {
      alpha_step<R>(a, sk, e, valid, lane);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (valid[r]) out[lane * R + r] = a[r] + g[r];
}

__global__ void ctc_alpha_kernel(const float* __restrict__ emit, const float* __restrict__ skip,
                                 const int* __restrict__ lengths, float* __restrict__ alphas,
                                 int T_len, int B, int S) {
  extern __shared__ float smem[];
  float* buf0 = smem;              // [S + 2]: alpha[s] at s + 2, NEG_INF at 0 and 1
  float* buf1 = buf0 + (S + 2);    // [S + 2]
  float* skip_s = buf1 + (S + 2);  // [S]
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const long long row = (long long)B * S;  // elements per time step
  const float* e = emit + (long long)b * S;
  float* out = alphas + (long long)b * S;
  const int len = lengths[b];
  const int steps = min(max(len, 1), T_len);

  if (tid < 2) buf0[tid] = buf1[tid] = NEG_INF;
  for (int s = tid; s < S; s += blockDim.x) {
    const float a0 = s < 2 ? e[s] : NEG_INF;
    buf0[s + 2] = a0;
    out[s] = a0;
    skip_s[s] = skip[(long long)b * S + s];
  }
  __syncthreads();

  float* prev = buf0;
  float* cur = buf1;
  for (int t = 1; t < steps; ++t) {
    const float* et = e + t * row;
    float* ot = out + t * row;
    for (int s = tid; s < S; s += blockDim.x) {
      const float a = logaddexp(logaddexp(prev[s + 2], prev[s + 1]), prev[s] + skip_s[s]);
      const float v = a + et[s];
      cur[s + 2] = v;
      ot[s] = v;
    }
    __syncthreads();
    float* tmp = prev;
    prev = cur;
    cur = tmp;
  }
  // frames at or past the length carry alpha unchanged; each thread reads only the
  // states it wrote itself, so no barrier is needed
  for (int t = steps; t < T_len; ++t) {
    float* ot = out + t * row;
    for (int s = tid; s < S; s += blockDim.x) ot[s] = prev[s + 2];
  }
}

__global__ void ctc_beta_grad_kernel(const float* __restrict__ emit,
                                     const float* __restrict__ alphas,
                                     const float* __restrict__ skip,
                                     const float* __restrict__ final_beta,
                                     const int* __restrict__ lengths,
                                     const float* __restrict__ logz,
                                     float* __restrict__ demit, int T_len, int B, int S) {
  extern __shared__ float smem[];
  float* z0 = smem;                 // [S + 2]: z[s] at s, NEG_INF at S and S + 1
  float* z1 = z0 + (S + 2);         // [S + 2]
  float* skip_from = z1 + (S + 2);  // [S]: skip[s + 2], NEG_INF past the end
  float* beta = skip_from + S;      // [S]: each thread touches only its own states
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const long long row = (long long)B * S;
  const float* e = emit + (long long)b * S;
  const float* al = alphas + (long long)b * S;
  float* g = demit + (long long)b * S;
  const int len = min(lengths[b], T_len);
  const float lz = logz[b];

  if (tid < 2) z0[S + tid] = z1[S + tid] = NEG_INF;
  for (int s = tid; s < S; s += blockDim.x) {
    skip_from[s] = s + 2 < S ? skip[(long long)b * S + s + 2] : NEG_INF;
    beta[s] = final_beta[(long long)b * S + s];
  }
  // frames at or past the length: zero gradient, beta stays `final`
  for (int t = T_len - 1; t >= max(len, 0); --t) {
    float* gt = g + t * row;
    for (int s = tid; s < S; s += blockDim.x) gt[s] = 0.f;
  }
  __syncthreads();

  float* z = z0;
  for (int t = len - 1; t >= 0; --t) {
    const float* et = e + t * row;
    const float* at = al + t * row;
    float* gt = g + t * row;
    for (int s = tid; s < S; s += blockDim.x) {
      const float bs = beta[s];
      gt[s] = -expf(at[s] + bs - lz);
      z[s] = bs + et[s];
    }
    __syncthreads();
    for (int s = tid; s < S; s += blockDim.x) {
      beta[s] = logaddexp(logaddexp(z[s], z[s + 1]), z[s + 2] + skip_from[s]);
    }
    z = z == z0 ? z1 : z0;  // the next step writes the other buffer while others read this
  }
}

}  // namespace

static int threads_for(int S) {
  const int t = (S + 31) / 32 * 32;
  return t < 32 ? 32 : (t > 256 ? 256 : t);
}

template <int R>
static cudaError_t launch_alpha_warp(const float* emit, const float* skip, const int* lengths,
                                     float* alphas, int T_len, int B, int S,
                                     cudaStream_t stream) {
  const int smem = (int)sizeof(float) * PREFETCH * 32 * R;  // <= 16 KB
  ctc_alpha_warp_kernel<R><<<B, 32, smem, stream>>>(emit, skip, lengths, alphas, T_len, B, S);
  return cudaGetLastError();
}

// emit, alphas: (T, B, S) float32; skip: (B, S) float32, 0 where the skip transition
// s - 2 -> s is allowed and NEG_INF elsewhere; lengths: (B,) int32; all on the device.
// S <= 256 runs ctc_alpha_warp_kernel, one warp a batch row; a larger S runs
// ctc_alpha_kernel, one CTA a row.
extern "C" int s2t_ctc_alpha(const void* emit, const void* skip, const void* lengths,
                             void* alphas, int T_len, int B, int S, void* stream) {
  if (T_len < 1 || B < 1 || S < 1) return cudaErrorInvalidValue;
  const float* e = static_cast<const float*>(emit);
  const float* sk = static_cast<const float*>(skip);
  const int* len = static_cast<const int*>(lengths);
  float* out = static_cast<float*>(alphas);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((S + 31) / 32) {
    case 1: return launch_alpha_warp<1>(e, sk, len, out, T_len, B, S, st);
    case 2: return launch_alpha_warp<2>(e, sk, len, out, T_len, B, S, st);
    case 3: return launch_alpha_warp<3>(e, sk, len, out, T_len, B, S, st);
    case 4: return launch_alpha_warp<4>(e, sk, len, out, T_len, B, S, st);
    case 5: return launch_alpha_warp<5>(e, sk, len, out, T_len, B, S, st);
    case 6: return launch_alpha_warp<6>(e, sk, len, out, T_len, B, S, st);
    case 7: return launch_alpha_warp<7>(e, sk, len, out, T_len, B, S, st);
    case 8: return launch_alpha_warp<8>(e, sk, len, out, T_len, B, S, st);
    default: break;
  }
  static_assert(WARP_MAX_R == 8, "the switch above covers R = 1 .. WARP_MAX_R");
  const size_t smem = sizeof(float) * (size_t)(3 * S + 4);
  ctc_alpha_kernel<<<B, threads_for(S), smem, st>>>(e, sk, len, out, T_len, B, S);
  return cudaGetLastError();
}

template <bool BETA>
static void launch_chain_floor(float* o, int steps, int S, cudaStream_t st) {
  switch ((S + 31) / 32) {
    case 1: ctc_chain_floor_kernel<1, BETA><<<1, 32, 0, st>>>(o, steps, S); break;
    case 2: ctc_chain_floor_kernel<2, BETA><<<1, 32, 0, st>>>(o, steps, S); break;
    case 3: ctc_chain_floor_kernel<3, BETA><<<1, 32, 0, st>>>(o, steps, S); break;
    case 4: ctc_chain_floor_kernel<4, BETA><<<1, 32, 0, st>>>(o, steps, S); break;
    case 5: ctc_chain_floor_kernel<5, BETA><<<1, 32, 0, st>>>(o, steps, S); break;
    case 6: ctc_chain_floor_kernel<6, BETA><<<1, 32, 0, st>>>(o, steps, S); break;
    case 7: ctc_chain_floor_kernel<7, BETA><<<1, 32, 0, st>>>(o, steps, S); break;
    default: ctc_chain_floor_kernel<8, BETA><<<1, 32, 0, st>>>(o, steps, S); break;
  }
}

// out: (S,) float32 on the device; one warp runs `steps - 1` dependent alpha steps (beta 0)
// or beta steps with their gradient entries (beta 1) of an S-state row (S <= 256) on
// register values.
extern "C" int s2t_ctc_chain_floor(void* out, int steps, int S, int beta, void* stream) {
  if (steps < 1 || S < 1 || S > 32 * WARP_MAX_R) return cudaErrorInvalidValue;
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (beta) {
    launch_chain_floor<true>(o, steps, S, st);
  } else {
    launch_chain_floor<false>(o, steps, S, st);
  }
  return cudaGetLastError();
}

// emit, alphas, demit: (T, B, S) float32; skip, final_beta: (B, S) float32; lengths: (B,)
// int32; logz: (B,) float32; all on the device.  demit = d(-logZ) / d emit per row.
extern "C" int s2t_ctc_beta_grad(const void* emit, const void* alphas, const void* skip,
                                 const void* final_beta, const void* lengths, const void* logz,
                                 void* demit, int T_len, int B, int S, void* stream) {
  if (T_len < 1 || B < 1 || S < 1) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)(4 * S + 4);
  ctc_beta_grad_kernel<<<B, threads_for(S), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(emit), static_cast<const float*>(alphas),
      static_cast<const float*>(skip), static_cast<const float*>(final_beta),
      static_cast<const int*>(lengths), static_cast<const float*>(logz),
      static_cast<float*>(demit), T_len, B, S);
  return cudaGetLastError();
}

extern "C" const char* s2t_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
