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
// is a chain of T - 1 dependent steps of a few hundred operations, so its time is the
// latency of one step (a shared-memory round trip and a barrier) times T.
//
// Design.  The TPU kernel walks T inside one program with the whole (B, S) state in
// VMEM.  Here one CTA per batch row walks T; the S states lie across the threads (a
// thread takes states tid, tid + blockDim, ... when S > blockDim).  The alpha pass keeps
// alpha double-buffered in shared memory behind two NEG_INF guard slots, so one barrier
// per step orders the reads of step t - 1 before the writes of step t.  The beta pass
// keeps beta per thread and double-buffers z = beta + emit_t, with two NEG_INF guard slots
// after state S - 1, again one barrier per step.  Rows past a batch row's length are
// written without any barrier (carried alphas, zero gradients).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float logaddexp(float a, float b) {
  // jnp.logaddexp for finite inputs: max + log1p(exp(-|a - b|))
  return fmaxf(a, b) + log1pf(expf(-fabsf(a - b)));
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

// emit, alphas: (T, B, S) float32; skip: (B, S) float32, 0 where the skip transition
// s - 2 -> s is allowed and NEG_INF elsewhere; lengths: (B,) int32; all on the device.
extern "C" int s2t_ctc_alpha(const void* emit, const void* skip, const void* lengths,
                             void* alphas, int T_len, int B, int S, void* stream) {
  if (T_len < 1 || B < 1 || S < 1) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)(3 * S + 4);
  ctc_alpha_kernel<<<B, threads_for(S), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(emit), static_cast<const float*>(skip),
      static_cast<const int*>(lengths), static_cast<float*>(alphas), T_len, B, S);
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
