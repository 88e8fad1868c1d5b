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
// logaddexp with the accurate expf and log1pf, an add) at ceil(S / 32) states a lane,
// ~0.26 us on an H100 at S = 59, 0.064 ms for 249 steps, 50x the bytes; K4's step
// (beta_step: its gradient entry's expf, an add, two shuffles, two logaddexp) at one state
// a lane, ~0.17 us, 0.042 ms for 249 steps.
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
// row a CTA ran within 5 % of two, four and eight (PERF.md).  Its step grows with R: at
// S = 127 (R = 4) K3 takes 0.132 ms over 249 steps against 0.042 ms for the one-state
// chain (PERF.md).
//
// Beta (K4), S <= 1024: ctc_beta_grad_warps_kernel, one CTA per batch row of
// W = ceil(S / 32) warps, one state a lane (thread s holds state s), beta in a register.
// K3's design, one warp holding R states a lane, would make each step's serial work grow
// with R: on an H100 80GB HBM3 at 700 W its beta step floors at 0.1604 ms over 249 steps at
// 4 states a lane (S = 127) and at 0.0607 ms at 2 (S = 59), against 0.042 ms for one state
// a lane (PERF.md).  So K4 spreads the lattice over warps instead.  A step is beta_step,
// the same function the chain floor runs: z = beta + emit, the shift-by-1 and shift-by-2
// inputs from the next lanes through __shfl_down_sync, two logaddexp, and the gradient entry
// -exp(alpha + beta - logZ) off the chain.  Only lanes 30-31 need values from past their
// warp, the next warp's lanes 0-1's z: every lane writes its z into its warp's row of a
// boundary table in shared memory, double-buffered by the step's parity, one __syncthreads
// orders those writes before every lane of the warp below reads the next row's first two
// (one broadcast load, kept by lanes 30-31), and the next write into the same row comes two
// steps later, after the next step's barrier.  The row past the last warp holds NEG_INF;
// at W = 1 (S <= 32) there is no barrier.  Every lane stores and loads so that the exchange
// has no branch: on an H100 a version that branched around the store and the load on the
// lanes that need them, with the loop not unrolled, took ~105 ns a step more than the
// one-warp step; this one takes ~8 more (PERF.md).  The emissions and
// alphas of the row's descending frames come through a cp.async ring of PREFETCH (emit,
// alpha) slots a thread, PREFETCH - 1 steps ahead (one commit group a step, zero fill past
// the row's steps), and each step reads the next step's slot at its end, so no load sits on
// the chain; the gradient entry is stored a step late, when its value is long ready, and
// the loop is unrolled by two.  Frames at or past a row's length get zero gradients,
// written before the walk with no barrier; beta stays `final` there.  On an H100 80GB HBM3
// at 700 W (chip_smoke.py, PERF.md): 0.0587 ms at the training shape (B=40, T'=250, S=59),
// 73 % of the 0.0428 ms bound, against 0.1150 ms for the CTA-wide kernel on the same
// inputs; 0.0598 ms at S = 127 (71 %); 0.0468 ms at B=128, T=192, S=127 (71 %); ~227 ns a
// step at one warp, ~235 at two or three, ~285 at eight, ~700 at 32 (S = 1023, 0.714 ms
// against the CTA-wide kernel's 2.77).
//
// Alpha, S > 256, and beta, S > 1024: ctc_alpha_kernel / ctc_beta_grad_kernel, one CTA per
// batch row walking T; the S states lie across the threads (a thread takes states tid,
// tid + blockDim, ... when S > blockDim).  The alpha pass keeps alpha double-buffered in
// shared memory behind two NEG_INF guard slots, so one barrier per step orders the reads
// of step t - 1 before the writes of step t.  The beta pass keeps beta per thread and
// double-buffers z = beta + emit_t, with two NEG_INF guard slots after state S - 1, again
// one barrier per step; its loads of emit and alphas sit inside the step.  Rows past a
// batch row's length are written without any barrier (carried alphas, zero gradients).

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

// One step of K4 at one state a lane: z = beta + e and new = logaddexp(logaddexp(z[s],
// z[s+1]), z[s+2] + skip_from[s]), z[s+1] and z[s+2] the next lanes' through __shfl_down_sync,
// and the gradient entry -exp(alpha + beta - logZ) into g (off the chain: after the exchange,
// so that it fills the stalls of the logaddexp chain).  Past the warp (lane 31 for z[s+1],
// lanes 30-31 for z[s+2]) the shuffle returns the lane's own z; `past_warp(z, n1, n2)` puts
// there what lies beyond: the next warp's first two z, or NEG_INF.  Shared by
// ctc_beta_grad_warps_kernel and its chain floor.
template <typename PastWarp>
__device__ __forceinline__ float beta_step(float bt, float e, float al, float lz,
                                           float skip_from, bool valid, float& g,
                                           PastWarp past_warp) {
  const float z = bt + e;
  float n1 = __shfl_down_sync(FULL, z, 1);
  float n2 = __shfl_down_sync(FULL, z, 2);
  past_warp(z, n1, n2);
  g = -expf(al + bt - lz);
  const float nw = logaddexp(logaddexp(z, n1), n2 + skip_from);
  return valid ? nw : NEG_INF;
}

// Nothing lies past the warp: the lattice ends at its lane 31.
struct LastWarp {
  int lane;
  __device__ __forceinline__ void operator()(float, float& n1, float& n2) const {
    if (lane >= 31) n1 = NEG_INF;
    if (lane >= 30) n2 = NEG_INF;
  }
};

// The chain floor of one lattice step: `steps - 1` dependent alpha_step<R> (K3's step) or,
// with BETA, beta_step (K4's: its gradient entry and its beta update, one state a lane,
// without the exchange between warps) on register values (emissions, alphas and skips made
// from the state index), no loads, and one store of the last state so the chain is not
// dead code.  One warp; a measurement for chip_smoke.py.
template <int R, bool BETA>
__global__ void ctc_chain_floor_kernel(float* __restrict__ out, int steps, int S) {
  static_assert(!BETA || R == 1, "K4's step holds one state a lane");
  const int lane = threadIdx.x & 31;
  if constexpr (BETA) {
    const bool valid = lane < S;
    const float e = -1.f - 0.25f * (float)(lane % 7);
    const float sk = lane + 2 >= 3 && lane % 2 == 1 && lane + 2 < S ? 0.f : NEG_INF;  // skip_from
    const float al = -2.f - 0.125f * (float)(lane % 5);
    float bt = valid && lane >= S - 2 ? 0.f : NEG_INF;  // beta starts at `final`
    float acc = 0.f;
    for (int t = 1; t < steps; ++t) {
      float g;
      bt = beta_step(bt, e, al, -3.f, sk, valid, g, LastWarp{lane});
      acc += g;
    }
    if (valid) out[lane] = bt + acc;
  } else {
    bool valid[R];
    float a[R], sk[R], e[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int s = lane * R + r;
      valid[r] = s < S;
      e[r] = -1.f - 0.25f * (float)(s % 7);
      sk[r] = s % 2 == 1 && s >= 3 ? 0.f : NEG_INF;
      a[r] = valid[r] && s < 2 ? e[r] : NEG_INF;
    }
    for (int t = 1; t < steps; ++t) alpha_step<R>(a, sk, e, valid, lane);
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (valid[r]) out[lane * R + r] = a[r];
  }
}

constexpr int BETA_WARPS_MAX_S = 1024;  // 32 warps of one state a lane

// MULTI: more than one warp (S > 32), so lanes 30-31 take the next warp's z through the
// boundary rows, one barrier a step; without it the lattice ends in the one warp.
template <bool MULTI>
__global__ void __launch_bounds__(BETA_WARPS_MAX_S)
    ctc_beta_grad_warps_kernel(const float* __restrict__ emit, const float* __restrict__ alphas,
                               const float* __restrict__ skip,
                               const float* __restrict__ final_beta,
                               const int* __restrict__ lengths, const float* __restrict__ logz,
                               float* __restrict__ demit, int T_len, int B, int S) {
  extern __shared__ float2 beta_ring[];  // [PREFETCH][threads]: (emit, alpha) of each state
  // [parity][warp][lane]: each warp's z of the step, written by every lane and read as its
  // lanes 0-1 by the warp below; the row past the last warp stays NEG_INF
  __shared__ __align__(16) float edge[2][33][32];
  const int s = threadIdx.x;
  const int threads = blockDim.x;
  const int lane = s & 31;
  const int warp = s >> 5;
  const int b = blockIdx.x;
  const long long row = (long long)B * S;  // elements per time step
  const bool valid = s < S;
  const float* e = emit + (long long)b * S + s;
  const float* al = alphas + (long long)b * S + s;
  float* g = demit + (long long)b * S + s;
  const int steps = max(min(lengths[b], T_len), 0);
  const float lz = logz[b];
  const float sk = valid && s + 2 < S ? skip[(long long)b * S + s + 2] : NEG_INF;  // skip_from
  float bt = valid ? final_beta[(long long)b * S + s] : NEG_INF;

  // the row past the last warp; the first step's barrier orders these writes
  if (MULTI && s < 64) edge[s >> 5][threads >> 5][lane] = NEG_INF;
  // frames at or past the length: zero gradient, beta stays `final`
  if (valid) {
    for (int t = steps; t < T_len; ++t) g[t * row] = 0.f;
  }
  // step k (frame steps - 1 - k) lands in slot k % PREFETCH through cp.async, PREFETCH - 1
  // steps ahead of its use, one commit group a step; a state past the lattice, or a step
  // past the row's, copies nothing (zero fill), so that state's z stays NEG_INF
  auto fetch = [&](int k) {
    const bool in = valid && k < steps;
    const long long off = in ? (long long)(steps - 1 - k) * row : 0;
    float2* slot = beta_ring + (k % PREFETCH) * threads + s;
    s2t_cp_async_4(s2t_smem_addr(&slot->x), e + off, in);
    s2t_cp_async_4(s2t_smem_addr(&slot->y), al + off, in);
    s2t_cp_async_commit();
  };
  for (int k = 0; k < PREFETCH - 1; ++k) fetch(k);
  s2t_cp_async_wait<PREFETCH - 2>();  // step 0's group has landed
  float2 ea = beta_ring[s];
  float g_last = 0.f;  // the previous step's gradient entry, stored a step late
  float* g_last_at = g;
#pragma unroll 2
  for (int k = 0; k < steps; ++k) {
    if (valid && k > 0) *g_last_at = g_last;  // its value is long ready: no stall
    const float2 cur = ea;
    if constexpr (MULTI) {
      float(*zs)[32] = edge[k & 1];
      bt = beta_step(bt, cur.x, cur.y, lz, sk, valid, g_last, [&](float z, float& n1, float& n2) {
        zs[warp][lane] = z;
        __syncthreads();
        const float2 next = *reinterpret_cast<const float2*>(zs[warp + 1]);  // its lanes 0-1
        n1 = lane == 31 ? next.x : n1;
        n2 = lane == 31 ? next.y : (lane == 30 ? next.x : n2);
      });
    } else {
      bt = beta_step(bt, cur.x, cur.y, lz, sk, valid, g_last, LastWarp{lane});
    }
    g_last_at = g + (long long)(steps - 1 - k) * row;
    // the next step's values, read here so that the read waits off the chain
    fetch(k + PREFETCH - 1);  // into the slot step k - 1 read
    s2t_cp_async_wait<PREFETCH - 2>();  // step k + 1's group has landed
    ea = beta_ring[((k + 1) % PREFETCH) * threads + s];
  }
  if (valid && steps > 0) *g_last_at = g_last;
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

// out: (S,) float32 on the device; one warp runs `steps - 1` dependent alpha steps at
// ceil(S / 32) states a lane (beta 0, S <= 256) or beta steps with their gradient entries at
// one state a lane (beta 1, S <= 32) of an S-state row on register values.
extern "C" int s2t_ctc_chain_floor(void* out, int steps, int S, int beta, void* stream) {
  if (steps < 1 || S < 1 || S > (beta ? 32 : 32 * WARP_MAX_R)) return cudaErrorInvalidValue;
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (beta) {
    ctc_chain_floor_kernel<1, true><<<1, 32, 0, st>>>(o, steps, S);
    return cudaGetLastError();
  }
  switch ((S + 31) / 32) {
    case 1: ctc_chain_floor_kernel<1, false><<<1, 32, 0, st>>>(o, steps, S); break;
    case 2: ctc_chain_floor_kernel<2, false><<<1, 32, 0, st>>>(o, steps, S); break;
    case 3: ctc_chain_floor_kernel<3, false><<<1, 32, 0, st>>>(o, steps, S); break;
    case 4: ctc_chain_floor_kernel<4, false><<<1, 32, 0, st>>>(o, steps, S); break;
    case 5: ctc_chain_floor_kernel<5, false><<<1, 32, 0, st>>>(o, steps, S); break;
    case 6: ctc_chain_floor_kernel<6, false><<<1, 32, 0, st>>>(o, steps, S); break;
    case 7: ctc_chain_floor_kernel<7, false><<<1, 32, 0, st>>>(o, steps, S); break;
    default: ctc_chain_floor_kernel<8, false><<<1, 32, 0, st>>>(o, steps, S); break;
  }
  return cudaGetLastError();
}

// emit, alphas, demit: (T, B, S) float32; skip, final_beta: (B, S) float32; lengths: (B,)
// int32; logz: (B,) float32; all on the device.  demit = d(-logZ) / d emit per row.
// s2t_ctc_beta_grad_warps runs ctc_beta_grad_warps_kernel (S <= 1024: ceil(S / 32) warps
// a batch row), s2t_ctc_beta_grad ctc_beta_grad_kernel (one CTA a row, any S); the wrapper
// (ops/ctc_cuda.py) picks by S.
extern "C" int s2t_ctc_beta_grad_warps(const void* emit, const void* alphas, const void* skip,
                                       const void* final_beta, const void* lengths,
                                       const void* logz, void* demit, int T_len, int B, int S,
                                       void* stream) {
  if (T_len < 1 || B < 1 || S < 1 || S > BETA_WARPS_MAX_S) return cudaErrorInvalidValue;
  const int threads = (S + 31) / 32 * 32;
  const int smem = (int)sizeof(float2) * PREFETCH * threads;  // <= 128 KB
  const float* e = static_cast<const float*>(emit);
  const float* al = static_cast<const float*>(alphas);
  const float* sk = static_cast<const float*>(skip);
  const float* fin = static_cast<const float*>(final_beta);
  const int* len = static_cast<const int*>(lengths);
  const float* lz = static_cast<const float*>(logz);
  float* out = static_cast<float*>(demit);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (threads == 32) {
    ctc_beta_grad_warps_kernel<false><<<B, 32, smem, st>>>(e, al, sk, fin, len, lz, out, T_len,
                                                           B, S);
  } else {
    // the ring and the static boundary table pass the default 48 KB from S = 289 on: opt in
    // before every launch, as the attention launchers do, so no launch depends on an earlier one
    const cudaError_t err = cudaFuncSetAttribute(
        ctc_beta_grad_warps_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    ctc_beta_grad_warps_kernel<true><<<B, threads, smem, st>>>(e, al, sk, fin, len, lz, out,
                                                               T_len, B, S);
  }
  return cudaGetLastError();
}

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
