// Kaldi log-mel filterbank for Hopper (sm_90a), the DFT in float64 FMAs (K5).
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
// and writes 12.8 MB of features, 0.0115 ms at 3.35 TB/s, and the bytes bound it: the FFT
// formulation of the function, with the mel product over the ~500 nonzero weights of the
// Kaldi triangles, needs ~15 kFLOP a frame (0.61 GFLOP, 0.009 ms at the 67 TFLOP/s f32
// rate).  The direct DFT, which the TPU kernel and this kernel compute, needs ~410 kFLOP a
// frame (400 x 257 products of a real sample and a complex twiddle), ~0.25 ms at the f32
// rate and ~0.5 ms at the 34 TFLOP/s float64 rate: this kernel is bound by its own
// operations, ~40x the function's bound.  No tensor cores: TF32 or bf16 products keep two
// to three digits, and the TPU kernel forces Precision.HIGHEST.
//
// Precision.  The preemphasis is a high-pass filter: for a noise-like frame the low bins of
// y hold ~1/1000 of the power of the high ones, while rounding y or the twiddles to f32
// adds white noise at 2^-24 of the frame to every bin.  Measured on the card against the
// float64 reference, at the parity tolerance (atol 5e-4 + rtol 1e-4): with y rounded to f32
// once, 40 rows of 10 s of noise miss it by 2x in the lowest mel bins; with y kept as two
// floats (hi + lo, twice the f32 FMAs) the f32 twiddles still leave a fixture wav at 0.93
// of it.  A float64 FMA costs two f32 FMAs on this card, the same as the two-float DFT, and
// leaves only the rounding of the power to f32: so the frames, the twiddles and the DFT
// sums are float64, and the power, the mel product and the log are f32, as in fbank_numpy.
//
// Design.  The TPU kernel folds preemphasis and the window into two 400 x 257 DFT bases
// (822 KB in f32) and reads each frame as three row views; those bases do not fit a block's
// shared memory.  Here one CTA takes one batch row and a tile of FT = 16 frames:
//   1. it stages the tile's (FT - 1) * 160 + 400 contiguous samples in shared memory and a
//      512-entry table of (cos, sin)(2 pi j / 512);
//   2. one warp per frame sums the frame for its mean; the frames are written preprocessed
//      (DC removal, preemphasis, window; a silent frame gives exactly 0) as [n][f], so one
//      16-byte load gives a thread two frames;
//   3. the direct DFT: thread k takes one bin for all FT frames, stepping the twiddle index
//      (n k) mod 512 through the table, 32 accumulators in registers; one table load serves
//      16 frames, which keeps the loop on the FMA pipes rather than on shared-memory loads.
//      A direct DFT over a radix-2 FFT: every product is a table entry times a sample, with
//      no butterfly stages, barriers or bit reversal between them, and the loop is simple
//      enough to be right the first time; the FFT's ~10x fewer operations are for a later PR;
//   4. the power of each bin goes back to shared memory (over the frames), and each thread
//      forms (frame, mel bin) outputs over the contiguous range of FFT bins that the mel
//      filter covers, then the log.
// Only the bins that some mel filter weighs are computed (the wrapper passes their range,
// 255 of the 257 for the Kaldi banks from 20 Hz: the DC and Nyquist bins have no weight), so
// one pass of 256 threads covers them.  Shared memory, 70,720 bytes a CTA, is dynamic.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WS = 400;        // window: 25 ms at 16 kHz
constexpr int SH = 160;        // shift: 10 ms
constexpr int NFFT = 512;      // padded window
constexpr int FT = 16;         // frames per CTA
constexpr int THREADS = 256;   // DFT bins per pass
constexpr int SPAN = (FT - 1) * SH + WS;
constexpr double PREEMPH = 0.97;
constexpr float EPS = 1.1920928955078125e-07f;
// frames and twiddles (double), the raw samples (float), the frame means (double)
constexpr int SMEM_BYTES = (WS * FT + 2 * NFFT + FT) * 8 + SPAN * 4;

__global__ void __launch_bounds__(THREADS)
fbank_kernel(const float* __restrict__ wave, const float* __restrict__ window,
             const float* __restrict__ mel, const int* __restrict__ mel_lo,
             const int* __restrict__ mel_hi, float* __restrict__ out, int N, int T, int n_mels,
             int k0, int nk) {
  extern __shared__ __align__(16) double smem[];
  double* frames = smem;                                          // [WS][FT]
  double2* twiddle = reinterpret_cast<double2*>(frames + WS * FT);  // [NFFT]
  double* means = reinterpret_cast<double*>(twiddle + NFFT);       // [FT]
  float* raw = reinterpret_cast<float*>(means + FT);              // [SPAN]

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * FT;
  const int tid = threadIdx.x;
  const float* w = wave + (long long)b * N;
  const long long first = (long long)t0 * SH;
  for (int i = tid; i < SPAN; i += THREADS) {
    const long long s = first + i;
    raw[i] = s < N ? w[s] : 0.f;  // frames of a partial last tile past T are never written
  }
  for (int j = tid; j < NFFT; j += THREADS) {
    double s, c;
    sincospi((double)j / (NFFT / 2), &s, &c);
    twiddle[j] = make_double2(c, s);
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  for (int f = warp; f < FT; f += THREADS / 32) {
    double acc = 0.0;
    for (int n = lane; n < WS; n += 32) acc += (double)raw[f * SH + n];
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) means[f] = acc / WS;
  }
  __syncthreads();

  for (int i = tid; i < WS * FT; i += THREADS) {
    const int f = i / WS, n = i - f * WS;
    const float* x = raw + f * SH;
    const double m = means[f];
    const double d = (double)x[n] - m;
    const double dp = n > 0 ? (double)x[n - 1] - m : d;
    frames[n * FT + f] = (d - PREEMPH * dp) * (double)window[n];
  }
  __syncthreads();

  // thread tid takes bin k0 + tid; threads past the range repeat the last bin and store nothing
  const int k = k0 + min(tid, nk - 1);
  double re[FT], im[FT];
#pragma unroll
  for (int f = 0; f < FT; ++f) re[f] = im[f] = 0.0;
  const double2* rows = reinterpret_cast<const double2*>(frames);
  int idx = 0;  // (n k) mod 512
  for (int n = 0; n < WS; ++n) {
    const double2 c = twiddle[idx];
    idx = (idx + k) & (NFFT - 1);
#pragma unroll
    for (int q = 0; q < FT / 2; ++q) {
      const double2 x = rows[n * (FT / 2) + q];
      re[2 * q] = fma(x.x, c.x, re[2 * q]);
      im[2 * q] = fma(x.x, c.y, im[2 * q]);
      re[2 * q + 1] = fma(x.y, c.x, re[2 * q + 1]);
      im[2 * q + 1] = fma(x.y, c.y, im[2 * q + 1]);
    }
  }
  __syncthreads();  // every thread has read the frames; their buffer now holds the power

  float* power = reinterpret_cast<float*>(frames);
  if (tid < nk) {
#pragma unroll
    for (int f = 0; f < FT; ++f) power[f * nk + tid] = (float)(re[f] * re[f] + im[f] * im[f]);
  }
  __syncthreads();

  for (int o = tid; o < FT * n_mels; o += THREADS) {
    const int f = o / n_mels, m = o - f * n_mels;
    const int t = t0 + f;
    if (t >= T) continue;
    const float* p = power + f * nk - k0;
    float acc = 0.f;
    for (int kk = mel_lo[m]; kk < mel_hi[m]; ++kk) acc = fmaf(p[kk], mel[kk * n_mels + m], acc);
    out[((long long)b * T + t) * n_mels + m] = logf(fmaxf(acc, EPS));
  }
}

}  // namespace

// wave: (B, N) float32 int16-scale samples; window: (400,) float32; mel: (257, n_mels)
// float32; mel_lo, mel_hi: (n_mels,) int32, the range [lo, hi) of FFT bins filter m weighs,
// inside [k0, k0 + nk) with 1 <= nk <= 256; out: (B, T, n_mels) float32,
// T = 1 + (N - 400) / 160; all on the device.
extern "C" int s2t_fbank(const void* wave, const void* window, const void* mel,
                         const void* mel_lo, const void* mel_hi, void* out, int B, int N, int T,
                         int n_mels, int k0, int nk, void* stream) {
  if (B < 1 || B > 65535 || T < 1 || N < WS || T != 1 + (N - WS) / SH || n_mels < 1 ||
      nk < 1 || nk > THREADS || k0 < 0 || k0 + nk > NFFT / 2 + 1) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(fbank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + FT - 1) / FT, B);
  fbank_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wave), static_cast<const float*>(window),
      static_cast<const float*>(mel), static_cast<const int*>(mel_lo),
      static_cast<const int*>(mel_hi), static_cast<float*>(out), N, T, n_mels, k0, nk);
  return cudaGetLastError();
}

extern "C" const char* s2t_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
