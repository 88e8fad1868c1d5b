"""The Berard LSTM encoder-decoder against the JAX package.

A tiny model (input layers 16 / 12, two stride-2 convs of 4 channels, 2
bidirectional layers of 8, 3 decoder cells of 16, twice the encoder width as the
initial state needs, so that the (i - 1) mod L wiring shows) on 3 ragged rows of 20-dim features, flax weights carried across by
``from_flax`` (``kernel_ih`` / ``kernel_hh`` transposed, the fused bias as
``bias_ih``), every leaf perturbed off its init:

* the encoder output and lengths (the reverse LSTM inside each row's length,
  zeros past it) within 1e-5, and the decoder logits within 1e-5 of their
  largest magnitude;
* the label-smoothed loss x sample size at 1e-4 and every gradient within 1e-4
  of its largest entry (``jax.value_and_grad``);
* ``from_flax`` both ways;
* neither beam generator decodes it: JAX's fails on the missing ``init_cache``,
  the port's raises ``AttributeError`` naming it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2t_tpu.criterions.build import build_criterion as jax_build_criterion
from s2t_tpu.inference.generator import SequenceGenerator as JaxGenerator
from s2t_tpu.models import berard as jb
from s2t_tpu_torch.criterions.build import build_criterion
from s2t_tpu_torch.inference.generator import SequenceGenerator
from s2t_tpu_torch.interop.from_flax import (
    flax_to_state_dict, load_flax_params, state_dict_to_flax)
from s2t_tpu_torch.models import berard as tb
from tests.test_torch_train_trainer import flat
from tests.test_torch_wav2vec2 import assert_close, perturb
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

TINY = dict(input_feat_per_channel=20, input_layers=(16, 12), conv_layers=((4, 3, 2), (4, 3, 2)),
            encoder_hidden=8, encoder_layers=2, decoder_hidden=16, decoder_layers=3,
            decoder_embed_dim=6, attention_dim=10, output_layer_dim=7, dropout=0.0,
            vocab_size=11)
LENGTHS = np.array([40, 27, 13], np.int32)  # 10, 7 and 4 encoder frames
CRIT = ("label_smoothed_cross_entropy", {"label_smoothing": 0.1})


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(3, 40, 20)).astype(np.float32)
    target = rng.integers(4, 11, size=(3, 6)).astype(np.int32)
    target[:, -1] = 2
    target[2, 3:] = 1
    target[2, 3] = 2
    prev = np.concatenate([np.full((3, 1), 2, np.int32), target[:, :-1]], axis=1)
    prev[2, 4:] = 1
    return feats, prev, target


@pytest.fixture(scope="module")
def pair():
    feats, prev, _ = inputs()
    jm = jb.BerardModel(jb.BerardConfig(**TINY))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), feats, LENGTHS, prev)["params"]
    params = perturb(jax.tree.map(np.asarray, params))
    tm = load_flax_params(tb.BerardModel(tb.BerardConfig(**TINY), device="cpu",
                                         for_training=True), params)
    return jm, params, tm


def test_from_flax_both_ways(pair):
    _, params, tm = pair
    sd = flax_to_state_dict(params)
    assert set(sd) == set(tm.state_dict())
    assert "encoder.blstms.1.bwd.weight_ih" in sd and "decoder.cells.2.weight_hh" in sd
    np.testing.assert_array_equal(sd["encoder.blstms.0.fwd.weight_ih"].numpy(),
                                  params["encoder"]["blstm0_fwd"]["kernel_ih"].T)
    back = dict(flat(state_dict_to_flax(tm.state_dict())))
    want = dict(flat(params))
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_forward_matches_jax_with_ragged_lengths(pair):
    jm, params, tm = pair
    feats, prev, _ = inputs()
    want = jax.jit(lambda p: jm.apply({"params": p}, feats, LENGTHS, prev))(params)
    with torch.no_grad():
        got = tm(torch.from_numpy(feats), torch.from_numpy(LENGTHS).long(),
                 torch.from_numpy(prev).long())
    np.testing.assert_array_equal(got["encoder_lengths"].numpy(), [10, 7, 4])
    np.testing.assert_array_equal(got["encoder_lengths"].numpy(),
                                  np.asarray(want["encoder_lengths"]))
    enc = got["encoder_out"].numpy()
    np.testing.assert_allclose(enc, np.asarray(want["encoder_out"]), atol=1e-5,
                               err_msg="encoder_out, atol 1e-5")
    assert np.all(enc[2, 4:] == 0) and np.all(enc[1, 7:] == 0)  # packed: zeros past a length
    assert_close(got["decoder_logits"].numpy(), want["decoder_logits"], "decoder_logits, 1e-5")


def test_loss_and_gradients_match_jax(pair):
    jm, params, tm = pair
    feats, prev, target = inputs(1)
    batch = {"target": target}
    jcrit = jax_build_criterion(*CRIT)

    def jax_loss(p):
        loss, size, _ = jcrit(jm.apply({"params": p}, feats, LENGTHS, prev), batch)
        return loss, size

    with jax.default_matmul_precision("highest"):
        (jloss, jsize), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    tm.zero_grad()
    out = tm(torch.from_numpy(feats), torch.from_numpy(LENGTHS).long(),
             torch.from_numpy(prev).long(), train=True, generator=torch.Generator().manual_seed(0))
    loss, size, _ = build_criterion(*CRIT)(out, {"target": torch.from_numpy(target).long()})
    loss.backward()
    assert size.item() == float(jsize)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4, err_msg="loss, rtol 1e-4")
    got = dict(flat(state_dict_to_flax({n: p.grad for n, p in tm.named_parameters()})))
    want = dict(flat(jax.tree.map(np.asarray, jgrads)))
    assert set(got) == set(want)
    for k in want:
        assert_close(got[k], want[k], f"{k}, 1e-4", tol=1e-4)
    # the reverse direction of the first layer reads every row's frames
    assert np.abs(got["encoder/blstm0_bwd/kernel_ih"]).max() > 0


def test_beam_generators_fail_on_init_cache(pair):
    jm, params, tm = pair
    feats, _, _ = inputs()
    batch = {"features": feats, "feat_lengths": LENGTHS}
    with pytest.raises(AttributeError, match="init_cache"):
        JaxGenerator(jm, beam_size=2, max_len_b=3).generate(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    with pytest.raises(AttributeError, match="init_cache"):
        SequenceGenerator(tm, beam_size=2, max_len_b=3).generate(batch)
