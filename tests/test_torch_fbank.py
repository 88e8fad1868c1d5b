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
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2t_tpu.data.audio.fbank import fbank_jax, fbank_numpy
from s2t_tpu.ops.fbank_pallas import fbank_pallas
from s2t_tpu_torch.data.audio.fbank import EPSILON, fbank_torch, speed_perturb_numpy
from s2t_tpu_torch.data.audio.fbank import fbank_numpy as port_fbank_numpy
from s2t_tpu_torch.ops import fbank_cuda

ATOL, RTOL = 5e-4, 1e-4
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
