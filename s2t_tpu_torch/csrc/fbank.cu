// Kaldi log-mel filterbank for Hopper (sm_90a), a float64 FFT per frame (K5).
//
// Replaces: s2t_tpu/ops/fbank_pallas.py:_fbank_kernel (reached through fbank_pallas), the
// fused feature extraction that SpeechToTextTask.forward_fn runs on raw int16-scale
// waveforms.  For every frame t of a (B, N) padded batch, T = 1 + (N - 400) / 160:
//
//   x = wave[b, 160 t : 160 t + 400]                    (zero-padded tail included)
//   d = x - mean(x)                                      (DC removal)
//   y[0] = d[0] - 0.97 d[0],  y[n] = d[n] - 0.97 d[n-1]  (preemphasis)
//   y *= povey window                                    (hann(400, symmetric) ** 0.85)
//   P[k] = |sum_n y[n] e^{-2 pi i n k / 512}|^2          (512-point DFT of the zero-padded y)
//   out[b, t, m] = log(max(sum_k P[k] mel[k, m], 1.1920928955078125e-07))
//
// Every frame is computed, also past a row's length, as fbank_jax and fbank_pallas do.
//
// Bound on this card: at B = 40, N = 160,000 (T = 998) the kernel reads 25.6 MB of samples
// and writes 12.8 MB of features, 0.0115 ms at 3.35 TB/s, and the bytes bound it.  This
// kernel's float64 work is ~10 kFLOP a frame (preprocessing ~2 k, two passes of 16
// radix-16 DFTs ~5.8 k, 225 twiddle products 1.4 k, the split and power of 255 bins ~2.5 k;
// 0.4 GFLOP in all, ~0.012 ms at the 34 TFLOP/s float64 rate) and the f32 mel product over
// the ~500 nonzero weights of the Kaldi triangles ~1 kFLOP a frame.  The direct DFT that
// the TPU kernel computes needs ~410 kFLOP a frame.  No tensor cores: TF32 or bf16
// products keep two to three digits, and the TPU kernel forces Precision.HIGHEST.
//
// Precision.  The preemphasis is a high-pass filter: for a noise-like frame the low bins of
// y hold ~1/1000 of the power of the high ones, while rounding y or the twiddles to f32
// adds white noise at 2^-24 of the frame to every bin.  Measured on the card against the
// float64 reference, at the parity tolerance (atol 5e-4 + rtol 1e-4): with y rounded to f32
// once, 40 rows of 10 s of noise miss it by 2x in the lowest mel bins; with y kept as two
// floats (hi + lo) the f32 twiddles still leave a fixture wav at 0.93 of it.  So the
// frames, the twiddles and the transform are float64, and the power is rounded to f32
// once before the f32 mel product and log, as in fbank_numpy.
//
// Design.  One CTA takes one batch row and a tile of FT = 8 frames, 16 threads a frame:
//   1. it stages the tile's (FT - 1) * 160 + 400 contiguous samples in shared memory,
//      widened to float64 once (streaming loads, all in flight together), with the window
//      and the twiddles; each frame's 16 threads sum it for its float64 mean (25 samples a
//      thread, then a shuffle tree);
//   2. pack: the real 512-point transform is a complex 256-point one of
//      z[n] = y[2n] + i y[2n+1] (0 from n = 200, the zero padding).  Thread n1 of a frame
//      preprocesses its own samples (DC removal, preemphasis, window) into
//      z[n1 + 16 n2], n2 = 0..15, in registers;
//   3. Z = FFT_256(z) as a 16 x 16 four-step, n = n1 + 16 n2, k = k2 + 16 k1:
//      a radix-16 DFT over n2 in registers (itself 4 x 4: radix-4 butterflies and seven
//      products by W16 constants), the twiddle W256^{n1 k2}, a transpose through shared
//      memory (rows of 17 16-byte complexes: a quarter-warp's 16-byte accesses land on 8
//      distinct slots in both directions), and a radix-16 DFT over n1; thread k2 then
//      holds Z[k2 + 16 k1], k1 = 0..15;
//   4. split: Y[k] = (Z[k] + conj Z[256-k]) / 2 - i W512^k (Z[k] - conj Z[256-k]) / 2,
//      Z[256] = Z[0].  Z[256 - k] of thread k2 is held by thread 16 - k2 of the frame (at
//      k1' = 15 - k1), so it comes by warp shuffle, and thread 0 holds its own; the power
//      of the bins in [k0, k0 + nk) (255 of the 257 for the Kaldi banks from 20 Hz: the DC
//      and Nyquist bins carry no weight), rounded to f32, goes to shared memory;
//   5. thread m forms mel bin m for the tile's frames from a compact table of the
//      filter's nonzero weights, then the log.
// The twiddles are float64 tables the wrapper builds once, in the order the threads read
// them (W256^{n1 k2} as [k2][n1], W512^k by k), so a warp's reads are contiguous; they
// sit in shared memory because the streamed samples evict them from L1.  No thread loops
// over the samples of a frame for a bin.  The FFT is the smaller part of a CTA's life:
// the rest is latency (the sample loads, the means, the split, the mel sums), which the
// 16 warps an SM hide.  Shared memory, 46,224 bytes a CTA: the
// twiddles and window, and one region that holds the samples, then the transpose, then
// the power; four CTAs (16 warps) fit an SM, and __launch_bounds__ holds the registers to
// the 128 a thread that allows.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WS = 400;        // window: 25 ms at 16 kHz
constexpr int SH = 160;        // shift: 10 ms
constexpr int NFFT = 512;      // padded window
constexpr int NZ = NFFT / 2;   // points of the packed complex transform
constexpr int RADIX = 16;      // NZ = RADIX x RADIX
constexpr int LDX = RADIX + 1; // row stride of a frame's transpose buffer, in complexes
constexpr int FT = 8;          // frames per CTA
constexpr int THREADS = FT * RADIX;
constexpr int MAX_BINS = 256;  // power entries a frame keeps
constexpr int SPAN = (FT - 1) * SH + WS;
constexpr double PREEMPH = 0.97;
constexpr float EPS = 1.1920928955078125e-07f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SPLIT_TWIDDLES = NZ + 1;  // W512^k, k = 0..256; then W256^{n1 k2} as [k2][n1]
constexpr int TWIDDLES = SPLIT_TWIDDLES + RADIX * RADIX;
// the twiddles (double2) and the window (double), then one region that holds the samples
// (double), then the transpose buffers (double2), then the power (float)
constexpr int REGION_BYTES = FT * RADIX * LDX * 16;
static_assert(REGION_BYTES >= SPAN * 8 && REGION_BYTES >= FT * MAX_BINS * 4, "region");
static_assert((TWIDDLES * 16 + WS * 8) % 16 == 0, "the region is 16-byte aligned");
constexpr int SMEM_BYTES = TWIDDLES * 16 + WS * 8 + REGION_BYTES;
constexpr int PER_THREAD = (SPAN + THREADS - 1) / THREADS;  // samples a thread stages

__device__ __forceinline__ double2 cadd(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ double2 csub(double2 a, double2 b) {
  return make_double2(a.x - b.x, a.y - b.y);
}

// a e^{-i theta} with cs = (cos theta, sin theta)
__device__ __forceinline__ double2 rotate(double2 a, double2 cs) {
  return make_double2(a.x * cs.x + a.y * cs.y, a.y * cs.x - a.x * cs.y);
}

// (cos, sin)(2 pi j / 16) for the j = m1 l2 of the radix-16 DFT
__device__ __forceinline__ double2 w16(int j) {
  constexpr double C1 = 0.92387953251128675613, S1 = 0.38268343236508977173;
  constexpr double H = 0.70710678118654752440;
  switch (j) {
    case 1: return make_double2(C1, S1);
    case 2: return make_double2(H, H);
    case 3: return make_double2(S1, C1);
    case 6: return make_double2(-H, H);
    case 9: return make_double2(-C1, -S1);
    default: return make_double2(1.0, 0.0);
  }
}

// X[k] = sum_n x[n] (-i)^{nk}, n, k < 4, in place
__device__ __forceinline__ void dft4(double2& x0, double2& x1, double2& x2, double2& x3) {
  const double2 t0 = cadd(x0, x2), t1 = csub(x0, x2), t2 = cadd(x1, x3);
  const double2 d = csub(x1, x3);
  const double2 t3 = make_double2(d.y, -d.x);  // -i (x1 - x3)
  x0 = cadd(t0, t2);
  x2 = csub(t0, t2);
  x1 = cadd(t1, t3);
  x3 = csub(t1, t3);
}

// X[k] = sum_n x[n] e^{-2 pi i n k / 16} in place, natural order in and out, as 4 x 4 with
// n = m1 + 4 m2, k = l2 + 4 l1
__device__ __forceinline__ void dft16(double2 (&x)[RADIX]) {
#pragma unroll
  for (int m1 = 0; m1 < 4; ++m1) dft4(x[m1], x[m1 + 4], x[m1 + 8], x[m1 + 12]);  // over m2
#pragma unroll
  for (int m1 = 1; m1 < 4; ++m1)
#pragma unroll
    for (int l2 = 1; l2 < 4; ++l2) {
      double2& a = x[m1 + 4 * l2];
      // W16^4 = -i exactly; a product by (0, 1) would still cost DFMAs (0 x is not folded)
      a = m1 * l2 == 4 ? make_double2(a.y, -a.x) : rotate(a, w16(m1 * l2));
    }
#pragma unroll
  for (int l2 = 0; l2 < 4; ++l2) dft4(x[4 * l2], x[4 * l2 + 1], x[4 * l2 + 2], x[4 * l2 + 3]);
  // X[l2 + 4 l1] now sits at x[l1 + 4 l2]
#pragma unroll
  for (int l1 = 0; l1 < 4; ++l1)
#pragma unroll
    for (int l2 = l1 + 1; l2 < 4; ++l2) {
      const double2 t = x[l1 + 4 * l2];
      x[l1 + 4 * l2] = x[l2 + 4 * l1];
      x[l2 + 4 * l1] = t;
    }
}

// y[n] of a frame x with mean m: DC removal, preemphasis, window
__device__ __forceinline__ double preprocess(const double* x, const double* win, int n,
                                             double m) {
  const double d = x[n] - m;
  const double dp = n > 0 ? x[n - 1] - m : d;
  return (d - PREEMPH * dp) * win[n];
}

// |Y[k]|^2 rounded to f32, Y[k] = (Z[k] + conj Zc) / 2 - i W512^k (Z[k] - conj Zc) / 2 with
// Zc = Z[256 - k] and cs = (cos, sin)(2 pi k / 512)
__device__ __forceinline__ float split_power(double2 z, double2 zc, double2 cs) {
  const double2 e = make_double2(0.5 * (z.x + zc.x), 0.5 * (z.y - zc.y));
  const double2 od = make_double2(0.5 * (z.y + zc.y), -0.5 * (z.x - zc.x));
  const double2 y = cadd(e, rotate(od, cs));
  return (float)(y.x * y.x + y.y * y.y);
}

__global__ void __launch_bounds__(THREADS, 4)
fbank_kernel(const float* __restrict__ wave, const double* __restrict__ window,
             const double2* __restrict__ twiddles, const float* __restrict__ mel_w,
             const int* __restrict__ mel_lo, const int* __restrict__ mel_hi,
             float* __restrict__ out, int N, int T, int n_mels, int k0, int nk) {
  extern __shared__ __align__(16) double2 smem[];
  double2* tw = smem;                                   // [TWIDDLES]
  double* win = reinterpret_cast<double*>(tw + TWIDDLES);  // [WS]
  double2* xs = reinterpret_cast<double2*>(win + WS);   // [FT][RADIX][LDX]  step 3
  double* raw = reinterpret_cast<double*>(xs);          // [SPAN]            steps 1-2
  float* power = reinterpret_cast<float*>(xs);          // [FT][nk]          steps 4-5

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * FT;
  const int tid = threadIdx.x;
  const float* w = wave + (long long)b * N;
  const long long first = (long long)t0 * SH;
  // the samples, read once (streaming loads, all in flight together), widened to float64;
  // frames of a partial last tile past T are computed from zeros and never written
  float x[PER_THREAD];
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int i = tid + j * THREADS;
    const long long s = first + i;
    x[j] = i < SPAN && s < N ? __ldcs(w + s) : 0.f;
  }
  for (int i = tid; i < TWIDDLES; i += THREADS) tw[i] = twiddles[i];
  for (int i = tid; i < WS; i += THREADS) win[i] = window[i];
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int i = tid + j * THREADS;
    if (i < SPAN) raw[i] = (double)x[j];
  }
  __syncthreads();

  const int f = tid / RADIX, r = tid % RADIX;  // r is n1 through step 3's transpose, then k2
  const int lane = tid & 31;
  double2 v[RADIX];
  {
    const double* xf = raw + f * SH;
    // the frame's float64 mean: its 16 threads sum 25 samples each, then a shuffle tree
    double acc = 0.0;
    for (int n = r; n < WS; n += RADIX) acc += xf[n];
#pragma unroll
    for (int o = RADIX / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
    const double m = acc * (1.0 / WS);  // no float64 division: its slow path is a call
#pragma unroll
    for (int n2 = 0; n2 < RADIX; ++n2) {
      const int n = r + RADIX * n2;
      v[n2] = 2 * n < WS ? make_double2(preprocess(xf, win, 2 * n, m),
                                        preprocess(xf, win, 2 * n + 1, m))
                         : make_double2(0.0, 0.0);
    }
  }
  // A[n1][k2] = W256^{n1 k2} sum_n2 z[n1 + 16 n2] W16^{n2 k2}
  dft16(v);
#pragma unroll
  for (int k2 = 1; k2 < RADIX; ++k2) v[k2] = rotate(v[k2], tw[SPLIT_TWIDDLES + k2 * RADIX + r]);
  __syncthreads();  // every thread has read the samples: the region now holds the transpose
  double2* xf = xs + f * RADIX * LDX;
#pragma unroll
  for (int k2 = 0; k2 < RADIX; ++k2) xf[r * LDX + k2] = v[k2];
  __syncthreads();
  // Z[k2 + 16 k1] = sum_n1 A[n1][k2] W16^{n1 k1}
#pragma unroll
  for (int n1 = 0; n1 < RADIX; ++n1) v[n1] = xf[n1 * LDX + r];
  __syncthreads();  // every column is read: the region now holds the power
  dft16(v);

  // thread r holds Z[r + 16 k1]; Z[256 - r - 16 k1] is Z[(16 - r) + 16 (15 - k1)], held by
  // thread 16 - r of this frame (r > 0), or Z[16 (16 - k1) mod 256] of thread 0's own
  const int partner = (lane & ~(RADIX - 1)) | ((RADIX - r) & (RADIX - 1));
  float* pf = power + f * nk - k0;
#pragma unroll
  for (int k1 = 0; k1 < RADIX; ++k1) {
    double2 zc = make_double2(__shfl_sync(FULL, v[RADIX - 1 - k1].x, partner),
                              __shfl_sync(FULL, v[RADIX - 1 - k1].y, partner));
    if (r == 0) zc = v[(RADIX - k1) % RADIX];
    const int k = r + RADIX * k1;
    if (k >= k0 && k < k0 + nk) pf[k] = split_power(v[k1], zc, tw[k]);
  }
  if (r == 0 && k0 + nk > NZ) pf[NZ] = split_power(v[0], v[0], tw[NZ]);  // Nyquist
  __syncthreads();

  // thread m forms filter m for the FT frames: each weight is read once for all of them,
  // and each output sums its bins in order, fmaf(P[k], weight, acc) from k = lo to hi - 1
  for (int m = tid; m < n_mels; m += THREADS) {
    const int lo = mel_lo[m], width = mel_hi[m] - lo;
    const float* p = power + lo - k0;
    float acc[FT];
#pragma unroll
    for (int ff = 0; ff < FT; ++ff) acc[ff] = 0.f;
    for (int j = 0; j < width; ++j) {
      const float weight = __ldg(mel_w + j * n_mels + m);
#pragma unroll
      for (int ff = 0; ff < FT; ++ff) acc[ff] = fmaf(p[ff * nk + j], weight, acc[ff]);
    }
#pragma unroll
    for (int ff = 0; ff < FT; ++ff) {
      if (t0 + ff < T) out[((long long)b * T + t0 + ff) * n_mels + m] = logf(fmaxf(acc[ff], EPS));
    }
  }
}

}  // namespace

// wave: (B, N) float32 int16-scale samples; window: (400,) float64; twiddles: (513, 2)
// float64 (cos, sin) pairs, 2 pi k / 512 for k = 0..256, then 2 pi n1 k2 / 256 at row
// 257 + 16 k2 + n1; mel_w: (W, n_mels) float32, row j the weight filter m gives FFT bin
// mel_lo[m] + j; mel_lo, mel_hi: (n_mels,) int32, the range [lo, hi) of FFT bins filter m
// weighs, inside [k0, k0 + nk) with 1 <= nk <= 256 and k0 + nk <= 257, hi - lo <= W; out:
// (B, T, n_mels) float32, T = 1 + (N - 400) / 160; all on the device.
extern "C" int s2t_fbank(const void* wave, const void* window, const void* twiddles,
                         const void* mel_w, const void* mel_lo, const void* mel_hi, void* out,
                         int B, int N, int T, int n_mels, int k0, int nk, void* stream) {
  if (B < 1 || B > 65535 || T < 1 || N < WS || T != 1 + (N - WS) / SH || n_mels < 1 ||
      nk < 1 || nk > MAX_BINS || k0 < 0 || k0 + nk > NZ + 1) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((T + FT - 1) / FT, B);
  fbank_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wave), static_cast<const double*>(window),
      static_cast<const double2*>(twiddles), static_cast<const float*>(mel_w),
      static_cast<const int*>(mel_lo), static_cast<const int*>(mel_hi),
      static_cast<float*>(out), N, T, n_mels, k0, nk);
  return cudaGetLastError();
}

extern "C" const char* s2t_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
