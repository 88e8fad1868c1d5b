"""The main architecture's training settings against the JAX package.

* ``tri_stage`` and ``polynomial_decay`` at every step of a short schedule
  (``polynomial_decay`` holds lr through the warm-up, as JAX's does);
* quant noise: the selected parameters and the noised values with JAX's masks
  handed over, nothing at p = 0, and the Trainer's noised forward's loss and
  gradients against ``jax.value_and_grad`` through JAX's noise on the same masks;
* comma-separated multilingual splits: the batches equal JAX's index for index,
  ``<lang:xx>`` tags included, over 2 epochs, resampled in training;
* ``transplant_component`` against JAX's on a pair of flax inits (encoder,
  decoder, the strict and non-strict refusals; an ASR encoder into SATE's
  "encoder/acoustic"), and the CLI's
  ``load_pretrained_encoder_from`` / ``finetune_from_model``.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from s2t_tpu.config import OptimizationConfig as JaxOptimizationConfig
from s2t_tpu.config import TrainConfig as JaxTrainConfig
from s2t_tpu.config import from_dict as jax_from_dict
from s2t_tpu.criterions.build import build_criterion as jax_build_criterion
from s2t_tpu.data.dataset import S2TDataConfig as JaxDataConfig
from s2t_tpu.data.dictionary import Dictionary as JaxDictionary
from s2t_tpu.models import s2t_transformer as jst
from s2t_tpu.modules import quant_noise as jqn
from s2t_tpu.optim import builders as jbuilders
from s2t_tpu.tasks.speech_to_text import SpeechToTextTask as JaxTask
from s2t_tpu.utils.checkpoint import transplant_component as jax_transplant
from s2t_tpu_torch.cli.train import transplant_pretrained
from s2t_tpu_torch.config import CheckpointConfig, OptimizationConfig, TrainConfig, from_dict
from s2t_tpu_torch.criterions.build import build_criterion
from s2t_tpu_torch.data.dataset import S2TDataConfig
from s2t_tpu_torch.data.dictionary import Dictionary
from s2t_tpu_torch.interop.from_flax import (
    flax_to_state_dict, load_flax_params, state_dict_to_flax)
from s2t_tpu_torch.models import s2t_transformer as tst
from s2t_tpu_torch.modules.quant_noise import blocked_axis, quant_noise_params
from s2t_tpu_torch.optim.builders import build_lr_schedule
from s2t_tpu_torch.tasks.speech_to_text import SpeechToTextTask
from s2t_tpu_torch.trainer import Trainer
from s2t_tpu_torch.utils.checkpoint import save_tree, transplant_component
from tests.test_torch_train_trainer import CRITERION, OPT, TINY, batches, flat
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

# one layer a stack keeps JAX's Trainer compile short; widths stay multiples of the block
TINY = {**TINY, "encoder_layers": 1, "decoder_layers": 1, "encoder_embed_dim": 32,
        "decoder_embed_dim": 32, "encoder_ffn_embed_dim": 64, "decoder_ffn_embed_dim": 64,
        "encoder_attention_heads": 2, "decoder_attention_heads": 2, "subsampling_filter": 32}


@pytest.mark.parametrize("name,kw", [
    ("tri_stage", dict(lr=3e-5, max_update=40, warmup_updates=0, min_lr=0.0)),
    ("tri_stage", dict(lr=1e-3, max_update=30, warmup_updates=5, min_lr=2e-5)),
    ("polynomial_decay", dict(lr=5e-4, max_update=30, warmup_updates=8, min_lr=1e-5)),
    ("polynomial_decay", dict(lr=5e-4, max_update=5, warmup_updates=8)),
], ids=["tri_default_warmup", "tri_min_lr", "poly", "poly_no_decay"])
def test_schedule_matches_jax_at_every_step(name, kw):
    want_fn = getattr(jbuilders, name)(JaxOptimizationConfig(lr_scheduler=name, **kw))
    got_fn = build_lr_schedule(OptimizationConfig(lr_scheduler=name, **kw))
    for step in range(kw["max_update"] + 6):
        np.testing.assert_allclose(float(got_fn(step)), float(want_fn(step)), rtol=2e-6,
                                   err_msg=f"{name} @ {step}")
    if name == "polynomial_decay":  # held through the warm-up: no ramp, as in JAX
        assert float(got_fn(0)) == pytest.approx(kw["lr"])


@pytest.fixture(scope="module")
def tiny_params():
    jm = jst.S2TTransformerModel(jst.s2t_transformer_s(**TINY))
    b = batches(1, n=1)[0]
    return jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0), b["features"],
                                                     b["feat_lengths"], b["prev_tokens"])["params"])


def jax_masks(params, key, p, block):
    """JAX's quant-noise masks, in the port's layout and names: the zeros of
    quant_noise_params over a tree of ones, for every leaf it noises."""
    ones = jax.tree.map(np.ones_like, params)
    out = jax.tree.map(np.asarray, jqn.quant_noise_params(ones, key, p, block))
    noised = flax_to_state_dict(jax.tree.map(lambda a: (a != 1.0).astype(np.float32), out))
    zeros = flax_to_state_dict(jax.tree.map(lambda a: (a == 0.0).astype(np.float32), out))
    return {k: zeros[k].bool() for k, v in noised.items() if v.any()}


def test_quant_noise_selects_and_noises_as_jax(tiny_params):
    key, p, block = jax.random.PRNGKey(3), 0.25, 8
    masks = jax_masks(tiny_params, key, p, block)
    sd = flax_to_state_dict(tiny_params)
    eligible = {k for k, v in sd.items() if blocked_axis(k, v.shape) is not None
                and v.shape[1] % block == 0}
    assert set(masks) == eligible and any("embed_tokens" in k for k in eligible)
    assert not any(k.endswith(".bias") or "norm" in k for k in eligible)
    got = quant_noise_params(sd, p, block, masks=masks)
    want = flax_to_state_dict(jax.tree.map(np.asarray, jqn.quant_noise_params(
        tiny_params, key, p, block)))
    for k in eligible:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-7, err_msg=k)
    # whole blocks of input features go: along axis 1 in the port's layout
    m = masks["encoder.layers.0.ffn.fc1.weight"].reshape(64, -1, block)
    assert (m.all(-1) | ~m.any(-1)).all() and 0 < m.float().mean() < 1
    assert quant_noise_params(sd, 0.0, block) == {}
    drawn = quant_noise_params(sd, p, block, torch.Generator().manual_seed(0))
    assert set(drawn) == eligible


def test_quant_noise_step_matches_jax(tiny_params):
    """The Trainer's quant-noise forward (``functional_call`` over the noised copies)
    with JAX's masks handed over: loss and gradients against ``jax.value_and_grad``
    through ``quant_noise_params`` (s2t_tpu/trainer.py:282-291), zero gradient in the
    dropped blocks; then a whole step with drawn masks moves the loss."""
    key, p, block = jax.random.PRNGKey(11), 0.1, 8
    batch = batches(1, n=1, seed=3)[0]
    jm = jst.S2TTransformerModel(jst.s2t_transformer_s(**TINY))
    jcrit = jax_build_criterion(*CRITERION)

    def jax_loss(params):
        out = jm.apply({"params": jqn.quant_noise_params(params, key, p, block)},
                       batch["features"], batch["feat_lengths"], batch["prev_tokens"])
        return jcrit(out, batch)[0]

    with jax.default_matmul_precision("highest"):
        jloss, jgrads = jax.jit(jax.value_and_grad(jax_loss))(tiny_params)
    opt = OptimizationConfig(**OPT, quant_noise_p=p, quant_noise_block_size=block)
    model = load_flax_params(tst.S2TTransformerModel(tst.s2t_transformer_s(**TINY), device="cpu",
                                                     for_training=True), tiny_params)
    trainer = Trainer(model, build_criterion(*CRITERION), opt, device="cpu")
    masks = jax_masks(tiny_params, key, p, block)
    tb = {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}
    out = trainer._forward_train(tb, trainer._generator(0), masks)
    loss = trainer.criterion(out, tb)[0]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    got = dict(flat(state_dict_to_flax({n: q.grad for n, q in model.named_parameters()})))
    want = dict(flat(jax.tree.map(np.asarray, jgrads)))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5 * max(1.0, np.abs(want[k]).max()),
                                   err_msg=k)
    fc1 = "encoder.layers.0.ffn.fc1.weight"
    assert (model.get_parameter(fc1).grad[masks[fc1]] == 0).all()
    # a whole step on drawn masks: the noise moves the loss from the plain step's
    fresh = [tst.S2TTransformerModel(tst.s2t_transformer_s(**TINY), device="cpu",
                                     for_training=True) for _ in range(2)]
    losses = [Trainer(m, build_criterion(*CRITERION), o, device="cpu").train_step(batch)
              ["loss"].item() for m, o in zip(fresh, (OptimizationConfig(**OPT), opt))]
    assert losses[0] != pytest.approx(losses[1], rel=1e-6)


# --------------------------------------------------------------------------- #
LANGS = ("de", "fr", "es")


def _multilingual_corpus(root: Path) -> Path:
    rng = np.random.default_rng(4)
    words = ["aa", "bb", "cc", "dd"]
    (root / "dict.txt").write_text("".join(f"{w} 1\n" for w in words)
                                   + "".join(f"<lang:{l}> 1\n" for l in LANGS))
    for li, (lang, n) in enumerate(zip(LANGS, (9, 4, 2))):
        lines = ["id\taudio\tn_frames\ttgt_text\tsrc_text\ttgt_lang"]
        for i in range(n):
            t = int(rng.integers(5, 50))
            np.save(root / f"{lang}{i}.npy", rng.normal(size=(t, 80)).astype(np.float32))
            text = " ".join(rng.choice(words, size=int(rng.integers(1, 5))))
            lines.append(f"{lang}{i}\t{lang}{i}.npy\t{t}\t{text}\t{text}\t{lang}")
        (root / f"train_{lang}.tsv").write_text("\n".join(lines) + "\n")
    return root


@pytest.mark.parametrize("is_train", [True, False], ids=["train", "valid"])
def test_multilingual_batches_match_jax(tmp_path, is_train):
    root = _multilingual_corpus(tmp_path)
    cfg = {"dataset": {"data": str(root), "max_tokens": 150, "max_source_positions": 60,
                       "max_target_positions": 16, "num_buckets": 4,
                       "required_batch_size_multiple": 2}}
    dcfg = dict(prepend_tgt_lang_tag=True, sampling_alpha=0.5)
    split = ",".join(f"train_{l}" for l in LANGS)
    task = SpeechToTextTask(from_dict(TrainConfig, cfg), S2TDataConfig(**dcfg),
                            Dictionary.load(root / "dict.txt"))
    jtask = JaxTask(jax_from_dict(JaxTrainConfig, cfg), JaxDataConfig(**dcfg),
                    JaxDictionary.load(root / "dict.txt"), None)
    ds, jds = task.load_dataset(split, is_train), jtask.load_dataset(split, is_train)
    np.testing.assert_allclose(ds.ratios, jds.ratios)
    assert (ds.ratios[-1] > 1.0) == is_train
    its = [t.get_batch_iterator(d, seed=5, **({} if t is task else {"batch_size_multiple": 1}))
           for t, d in ((task, ds), (jtask, jds))]
    tags = {task.tgt_dict.index(f"<lang:{l}>") for l in LANGS}
    for _ in (1, 2):
        got, want = (list(it.next_epoch_itr()) for it in its)
        assert len(got) == len(want) > 1
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for key in g:
                np.testing.assert_array_equal(np.asarray(g[key]), np.asarray(w[key]), err_msg=key)
        assert {int(t) for b in got for t in b["target"][:b["nsentences"], 0]} <= tags
        for it in its:
            it.next_epoch()


# --------------------------------------------------------------------------- #
def _init(seed, **kw):
    jm = jst.S2TTransformerModel(jst.s2t_transformer_s(**{**TINY, **kw}))
    b = batches(1, n=1)[0]
    return jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(seed), b["features"],
                                                     b["feat_lengths"], b["prev_tokens"])["params"])


def _equal_trees(got, want):
    got, want = dict(flat(got)), dict(flat(want))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_transplant_component_matches_jax():
    tgt, src = _init(0), _init(1)
    tsd, ssd = flax_to_state_dict(tgt), flax_to_state_dict(src)
    for comp in ("encoder", "decoder"):
        want = jax_transplant(tgt, src, comp)
        _equal_trees(state_dict_to_flax(transplant_component(tsd, ssd, comp)), want)
    # a deeper source: strict refuses the extra layer in both, non-strict takes the shared ones
    deep = _init(2, encoder_layers=2)
    with pytest.raises(KeyError):
        jax_transplant(tgt, deep, "encoder")
    with pytest.raises(KeyError, match="structure"):
        transplant_component(tsd, flax_to_state_dict(deep), "encoder")
    _equal_trees(state_dict_to_flax(transplant_component(tsd, flax_to_state_dict(deep),
                                                         "encoder", strict=False)),
                 jax_transplant(tgt, deep, "encoder", strict=False))
    # another width: a shape mismatch in both
    wide = _init(3, vocab_size=40)
    with pytest.raises(KeyError):
        jax_transplant(tgt, wide, "decoder")
    with pytest.raises(KeyError, match="shape"):
        transplant_component(tsd, flax_to_state_dict(wide), "decoder")


def test_transplant_into_sate_acoustic_matches_jax():
    """SATE's workflow: an ASR encoder into "encoder/acoustic" (``source_component``)."""
    from s2t_tpu_torch.models import sate as tsate

    D = TINY["encoder_embed_dim"]
    sate = tsate.S2TSATEModel(tsate.s2t_sate_s(
        acoustic_encoder_embed_dim=D, acoustic_encoder_ffn_embed_dim=64,
        acoustic_encoder_layers=1, acoustic_encoder_attention_heads=2,
        acoustic_decoder_embed_dim=D, acoustic_decoder_ffn_embed_dim=64,
        acoustic_decoder_layers=1, acoustic_decoder_attention_heads=2,
        acoustic_subsampling_filter=32, text_encoder_layers=1, text_attention_heads=2,
        text_ffn_embed_dim=64, vocab_size=TINY["vocab_size"]), device="cpu")
    asr = tst.S2TTransformerModel(tst.s2t_transformer_s(**TINY), device="cpu", seed=9)
    tgt, src = sate.state_dict(), asr.state_dict()
    want = jax_transplant(state_dict_to_flax(tgt), state_dict_to_flax(src), "encoder/acoustic",
                          strict=False, source_component="encoder")
    got = transplant_component(tgt, src, "encoder/acoustic", strict=False,
                               source_component="encoder")
    _equal_trees(state_dict_to_flax(got), want)
    assert torch.equal(got["encoder.acoustic.layers.0.ffn.fc1.weight"],
                       src["encoder.layers.0.ffn.fc1.weight"])


def test_cli_transplant_hooks(tmp_path):
    src = tst.S2TTransformerModel(tst.s2t_transformer_s(**TINY), device="cpu", seed=5)
    save_tree(tmp_path / "asr.pt", {"params": src.state_dict()})
    model = tst.S2TTransformerModel(tst.s2t_transformer_s(**TINY), device="cpu", seed=6)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    transplant_pretrained(CheckpointConfig(load_pretrained_encoder_from=str(tmp_path / "asr.pt")),
                          model)
    for k, v in model.state_dict().items():
        want = src.state_dict()[k] if k.startswith("encoder.") else before[k]
        assert torch.equal(v, want), k
    transplant_pretrained(CheckpointConfig(finetune_from_model=str(tmp_path / "asr.pt")), model)
    assert all(torch.equal(v, src.state_dict()[k]) for k, v in model.state_dict().items())
