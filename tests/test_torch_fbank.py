"""The port's Kaldi fbank (K5's plain version and its wrapper on CPU tensors)
against the JAX package: ``fbank_jax``, ``fbank_pallas`` in interpret mode (as
tests/test_fbank_pallas.py runs it) and ``fbank_numpy``.

Rows of 399 (no frame), 400 (one), 8000 and 6320 (38 frames) samples of
sigma-2000 noise and a silent row, zero-padded to 8000.  Features are compared
over all T = 48 frames of every row, the padded tail included (the silent
tail is log(EPSILON) everywhere), and against ``fbank_numpy`` over each row's
own frames, at the tolerance of tests/test_fbank_pallas.py: atol 5e-4, rtol
1e-4.  The port takes the frames and the DFT in float64 and rounds the power
to float32 once before the float32 mel product and log; the bound is set by
the JAX formulations, whose float32 DFT sums of 400 int16-scale samples keep
about five digits under the log.  Frame lengths must be equal.

K5's FFT (``csrc/fbank.cu``) is emulated step by step in numpy float64 (the
packing of the 400 real samples into 256 complex points, the 16 x 16
four-step with its radix-16 DFTs built from radix-4 butterflies, the
wrapper's twiddle tables and the transpose through a buffer with rows of 17,
and the split into the 257 bins of the real spectrum with Z[256 - k] taken
from the partner thread) and held to ``np.fft.rfft`` of the same frames at
1e-12 relative.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2t_tpu.data.audio.fbank import fbank_jax, fbank_numpy
from s2t_tpu.ops.fbank_pallas import fbank_pallas
from s2t_tpu_torch.data.audio.fbank import EPSILON, fbank_torch, speed_perturb_numpy
from s2t_tpu_torch.data.audio.fbank import fbank_numpy as port_fbank_numpy
from s2t_tpu_torch.data.audio.fbank import povey_window
from s2t_tpu_torch.data.dataset import load_waveform
from s2t_tpu_torch.ops import fbank_cuda
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

ATOL, RTOL = 5e-4, 1e-4
WAVS = [str(Path(__file__).parent / "fixtures" / "audio" / f"utt{i}.wav") for i in range(4)]
LENGTHS = [399, 400, 8000, 6320, 8000]
N = 8000


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    wave = np.zeros((len(LENGTHS), N), np.float32)
    for i, n in enumerate(LENGTHS[:-1]):  # the last row stays silent
        wave[i, :n] = rng.normal(scale=2000.0, size=n)
    return wave, np.asarray(LENGTHS, np.int32)


@pytest.fixture(scope="module")
def port(batch):
    wave, lengths = batch
    return fbank_cuda.fbank_plain(torch.from_numpy(wave), torch.from_numpy(lengths))


@pytest.mark.parametrize("reference", ["fbank_jax", "fbank_pallas_interpret"])
def test_plain_matches_jax_over_every_frame(batch, port, reference):
    wave, lengths = batch
    if reference == "fbank_jax":
        feats, flens = fbank_jax(jnp.asarray(wave), jnp.asarray(lengths))
    else:
        feats, flens = fbank_pallas(jnp.asarray(wave), jnp.asarray(lengths), interpret=True)
    got, got_lens = port
    assert got.shape == (len(LENGTHS), 48, 80) == np.asarray(feats).shape
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(flens))
    np.testing.assert_allclose(got.numpy(), np.asarray(feats), atol=ATOL, rtol=RTOL)


def test_plain_matches_numpy_per_row(batch, port):
    wave, lengths = batch
    got, got_lens = port
    for i, n in enumerate(lengths):
        ref = fbank_numpy(wave[i, :n])
        assert int(got_lens[i]) == ref.shape[0] == [0, 1, 48, 38, 48][i]
        np.testing.assert_allclose(got[i, : ref.shape[0]].numpy(), ref, atol=ATOL, rtol=RTOL)
    assert torch.all(got[-1] == np.float32(np.log(EPSILON)))  # silence: log(EPSILON) exactly
    # row 400: frames 1 and 2 still overlap its samples (ordinary data), the rest is silence
    assert torch.all(got[1, 3:] == np.float32(np.log(EPSILON)))
    assert torch.all(got[1, 1:3] > np.log(EPSILON))


def test_wrapper_on_cpu_tensors_is_the_plain_version(batch, port):
    wave, lengths = batch
    before = fbank_cuda.fbank.launches
    got, got_lens = fbank_cuda.fbank(torch.from_numpy(wave), torch.from_numpy(lengths))
    assert torch.equal(got, port[0]) and torch.equal(got_lens, port[1])
    assert got_lens.dtype == torch.int32
    assert fbank_cuda.fbank.launches == before  # the plain version is no launch


def test_short_batch_has_no_frames():
    feats, flens = fbank_torch(torch.zeros(2, 399), torch.tensor([399, 0]))
    assert feats.shape == (2, 0, 80) and flens.tolist() == [0, 0]


def test_host_copies_match_jax():
    rng = np.random.default_rng(1)
    wave = rng.normal(scale=1000.0, size=5000).astype(np.float32)
    np.testing.assert_array_equal(port_fbank_numpy(wave), fbank_numpy(wave))
    from s2t_tpu.data.audio.fbank import speed_perturb_numpy as jax_speed_perturb

    for speed in (0.9, 1.0, 1.1):
        np.testing.assert_array_equal(speed_perturb_numpy(wave, speed),
                                      jax_speed_perturb(wave, speed))


def test_mel_ranges_cover_every_weight():
    mel, lo, hi = fbank_cuda.mel_bin_ranges(80)
    for m in range(80):
        outside = np.ones(mel.shape[0], bool)
        outside[lo[m]:hi[m]] = False
        assert not mel[outside, m].any()
    # the bins the kernel computes: 1..255 (DC and Nyquist carry no weight)
    assert lo[lo < hi].min() == 1 and hi.max() == 256 <= 1 + fbank_cuda.MAX_BINS


# ---- K5's FFT, as fbank.cu computes it -------------------------------------------------
RADIX, LDX = 16, 17  # 256 = 16 x 16; rows of the kernel's transpose buffer
_TW = fbank_cuda.fft_twiddles()
TWIDDLES = _TW[:, 0] + 1j * _TW[:, 1]  # e^{i theta} of the kernel's (cos, sin) rows


def _rotate(a, cs):
    """a e^{-i theta}, the kernel's product by a (cos, sin) row."""
    return a * np.conj(cs)


def _dft4(x0, x1, x2, x3):
    t0, t1, t2, t3 = x0 + x2, x0 - x2, x1 + x3, -1j * (x1 - x3)
    return t0 + t2, t1 + t3, t0 - t2, t1 - t3


def _dft16(x):
    """fbank.cu dft16 on (..., 16): radix-4 over m2 (n = m1 + 4 m2), W16^{m1 l2},
    radix-4 over m1, then the 4 x 4 index transpose to natural order."""
    x = x.copy()
    for m1 in range(4):
        idx = [m1, m1 + 4, m1 + 8, m1 + 12]
        for i, val in zip(idx, _dft4(*(x[..., i] for i in idx))):
            x[..., i] = val
    for m1 in range(1, 4):
        for l2 in range(1, 4):
            x[..., m1 + 4 * l2] = _rotate(x[..., m1 + 4 * l2], np.exp(2j * np.pi * m1 * l2 / 16))
    for l2 in range(4):
        idx = [4 * l2, 4 * l2 + 1, 4 * l2 + 2, 4 * l2 + 3]
        for i, val in zip(idx, _dft4(*(x[..., i] for i in idx))):
            x[..., i] = val
    out = np.empty_like(x)
    for l1 in range(4):
        for l2 in range(4):
            out[..., l2 + 4 * l1] = x[..., l1 + 4 * l2]
    return out


def _k5_spectrum(y):
    """(F, 400) float64 frames -> (F, 257) complex: the 512-point real DFT of the
    zero-padded frames, step by step as fbank.cu takes it, thread by thread of a
    frame's 16 (axis 1)."""
    F = y.shape[0]
    yp = np.zeros((F, 512))
    yp[:, :400] = y
    z = yp[:, 0::2] + 1j * yp[:, 1::2]  # z[n] = y[2n] + i y[2n+1], 0 from n = 200
    r = np.arange(RADIX)
    v = z[:, r[:, None] + RADIX * r[None, :]]  # thread n1 holds v[n2] = z[n1 + 16 n2]
    v = _dft16(v)  # A[n1][k2]
    step = TWIDDLES[257 + RADIX * r[None, 1:] + r[:, None]]  # row 257 + 16 k2 + n1
    v[:, :, 1:] = _rotate(v[:, :, 1:], step)  # W256^{n1 k2}
    buf = np.zeros((F, RADIX * LDX), complex)
    buf[:, r[:, None] * LDX + r[None, :]] = v  # thread n1 writes row n1
    v = _dft16(buf[:, r[None, :] * LDX + r[:, None]])  # thread k2 reads column k2
    # thread k2 holds Z[k2 + 16 k1] at v[k2][k1]; Z[256 - k] comes from thread 16 - k2 at
    # k1' = 15 - k1 (the shuffle), or from thread 0's own v[(16 - k1) % 16]
    zc = v[:, (RADIX - r) % RADIX][:, :, ::-1].copy()
    zc[:, 0] = v[:, 0, (RADIX - r) % RADIX]
    k = r[:, None] + RADIX * r[None, :]
    spec = np.empty((F, 257), complex)
    cs = TWIDDLES[k]
    spec[:, k] = 0.5 * (v + np.conj(zc)) + _rotate(-0.5j * (v - np.conj(zc)), cs)
    z0 = v[:, 0, 0]  # Nyquist: Z[256] = Z[0]
    spec[:, 256] = 0.5 * (z0 + np.conj(z0)) + _rotate(-0.5j * (z0 - np.conj(z0)), TWIDDLES[256])
    return spec


def _frames(wave):
    """The kernel's preprocessing in float64: DC removal, preemphasis, window."""
    T = 1 + (len(wave) - 400) // 160
    x = wave[np.arange(T)[:, None] * 160 + np.arange(400)].astype(np.float64)
    d = x - x.mean(axis=1, keepdims=True)
    dp = np.concatenate([d[:, :1], d[:, :-1]], axis=1)
    return (d - 0.97 * dp) * povey_window(400).astype(np.float64)


@pytest.mark.parametrize("source", ["utt0", "utt1", "utt2", "utt3", "noise", "square"])
def test_k5_fft_decomposition_matches_rfft(source):
    if source.startswith("utt"):
        wave = load_waveform(WAVS[int(source[3])])
    elif source == "noise":
        wave = (np.random.default_rng(3).normal(size=16000) * 2000.0).astype(np.float32)
    else:  # a loud square wave: energy at the Nyquist side of the spectrum
        wave = np.where((np.arange(8000) // 3) % 2 == 0, 32767.0, -32767.0).astype(np.float32)
    y = _frames(wave)
    got, want = _k5_spectrum(y), np.fft.rfft(y, 512, axis=1)
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert (np.abs(got - want) / scale).max() <= 1e-12
    # and the features through the power rounded once to f32, the mel product and the log
    power = (got.real ** 2 + got.imag ** 2).astype(np.float32)
    mel = np.log(np.maximum(power @ fbank_cuda.mel_bin_ranges(80)[0], EPSILON))
    np.testing.assert_allclose(mel, fbank_numpy(wave), atol=ATOL, rtol=RTOL)
