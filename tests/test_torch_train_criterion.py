"""Label-smoothed CE + CTC on the tiny model: the port against ``jax.value_and_grad``.

The tiny s2t_transformer of tests/test_torch_s2t_transformer.py (dropout 0) is
initialised by flax and carried across with ``from_flax`` into a model built
for training (float32 master parameters).  The loss, its logs (nll_loss,
ctc_loss, n_correct, sample_size) and the gradient of every parameter are
held to the JAX criterion's; the JAX model gathers its CTC emissions from the
head input (``ctc_fused``), the port from the logits, the same math in
another order.  fp32: loss rtol 1e-5, gradients atol 1e-5 relative to each
leaf's largest entry (two stacks of float32 sums).
"""

import jax
import numpy as np
import pytest
import torch

from s2t_tpu.criterions.build import build_criterion as jax_build_criterion
from s2t_tpu.models import s2t_transformer as jst
from s2t_tpu_torch.criterions.build import build_criterion
from s2t_tpu_torch.interop.from_flax import load_flax_params, state_dict_to_flax
from s2t_tpu_torch.models import s2t_transformer as tst
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

TINY = dict(
    vocab_size=32, encoder_layers=2, decoder_layers=2, encoder_embed_dim=64,
    decoder_embed_dim=64, encoder_ffn_embed_dim=128, decoder_ffn_embed_dim=128,
    encoder_attention_heads=4, decoder_attention_heads=4, subsampling_filter=64,
    max_target_positions=64, dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
)
CRITERION = ("label_smoothed_cross_entropy_with_ctc", {"ctc": {"ctc_weight": 0.3}})


def make_batch(seed=0, B=4, T=60, U=7, V=32, transcript=True):
    rng = np.random.default_rng(seed)
    target = rng.integers(4, V, size=(B, U)).astype(np.int32)
    target[:, -1] = 2
    target[1, -2:] = [2, 1]  # a shorter sentence: EOS, then pad
    prev = np.roll(target, 1, axis=1)
    prev[:, 0] = 2
    batch = {
        "features": rng.normal(size=(B, T, 80)).astype(np.float32),
        "feat_lengths": np.array([60, 45, 31, 20], np.int32)[:B],
        "prev_tokens": prev,
        "target": target,
    }
    if transcript:
        batch["transcript"] = target[:, :-1]
        batch["transcript_lengths"] = np.array([U - 1, U - 2, U - 1, U - 1], np.int32)[:B]
    return batch


def flax_init(cfg, batch):
    jm = jst.S2TTransformerModel(cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), batch["features"], batch["feat_lengths"],
                              batch["prev_tokens"])["params"]
    return jm, jax.tree.map(np.asarray, params)


def flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


@pytest.mark.parametrize("transcript", [True, False], ids=["transcript", "eos_rewrite"])
def test_loss_logs_and_grads_match_jax(transcript):
    cfg_kw = dict(TINY, share_decoder_input_output_embed=False) if transcript else TINY
    batch = make_batch(transcript=transcript)
    jm, params = flax_init(jst.s2t_transformer_s(**cfg_kw), batch)
    jcrit = jax_build_criterion(*CRITERION)

    def jax_loss(p):
        out = jm.apply({"params": p}, batch["features"], batch["feat_lengths"],
                       batch["prev_tokens"], deterministic=True)
        loss, sample_size, logs = jcrit(out, batch)
        return loss, (sample_size, logs)

    with jax.default_matmul_precision("highest"):
        (jloss, (jsize, jlogs)), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
            params)

    tm = tst.S2TTransformerModel(tst.s2t_transformer_s(**cfg_kw), device="cpu",
                                 for_training=True)
    load_flax_params(tm, params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = tm(tb["features"], tb["feat_lengths"], tb["prev_tokens"], train=False)
    loss, size, logs = build_criterion(*CRITERION)(out, tb)
    loss.backward()

    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert size.item() == float(jsize) == 27  # non-pad target tokens
    for key in ("nll_loss", "ce_loss", "ctc_loss", "n_correct", "total", "ntokens"):
        np.testing.assert_allclose(logs[key].item(), float(jlogs[key]), rtol=1e-5, err_msg=key)
    grads = state_dict_to_flax({n: p.grad for n, p in tm.named_parameters()})
    got, want = dict(flat(grads)), dict(flat(jgrads))
    assert set(got) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(got[name], g, atol=1e-5 * max(1.0, np.abs(g).max()),
                                   err_msg=name)


def test_unported_criteria_and_branches_raise():
    # the alignment CE (tests/test_torch_align.py) and nat_loss (tests/test_torch_nat.py)
    # build with their configs
    assert build_criterion("label_smoothed_cross_entropy_with_alignment",
                           {"alignment_lambda": 0.05}).cfg.alignment_lambda == 0.05
    assert build_criterion("nat_loss", {"length_loss_factor": 0.2}).cfg.length_loss_factor == 0.2
    # join_speech_and_text_loss (tests/test_torch_dual.py), wav2vec v1's CPC loss
    # (tests/test_torch_wav2vec_v1.py) and the latency-augmented CE, composite_loss and
    # model (tests/test_torch_latency.py) are ported; an unknown name raises
    assert build_criterion("latency_augmented_label_smoothed_cross_entropy",
                           {"latency_weight_avg": 0.1}).cfg.latency_weight_avg == 0.1
    with pytest.raises(NotImplementedError, match="no_such_criterion"):
        build_criterion("no_such_criterion")
    with pytest.raises(KeyError, match="no_such_field"):
        build_criterion("ctc", {"no_such_field": 1})
