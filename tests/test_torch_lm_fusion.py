"""The port's Transformer LM, shallow fusion, ensembles and SequenceScorer against JAX on the CPU.

Tiny LMs (2 layers, d=32, vocab 32 / 40) are initialised by flax and carried
across with ``from_flax``; ``state_dict_to_flax`` gives the flax tree back leaf
for leaf (exactly: float32 copies).  Forward logits, the adaptive softmax's
full log-probs and its target log-probs agree at 1e-5.  With the LM fused at
weight 0.3 (temperature 1.2, which the LM's logits do not take), and for a
2-member ensemble, beam tokens must equal JAX's and scores agree at 1e-5.
``SequenceScorer`` (the model's forward, and the task's ``forward_fn``) gives
JAX's per-token log-probs and totals at 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from s2t_tpu.config import TrainConfig as JaxTrainConfig
from s2t_tpu.config import from_dict as jax_from_dict
from s2t_tpu.data.dataset import S2TDataConfig as JaxDataConfig
from s2t_tpu.data.dictionary import Dictionary as JaxDictionary
from s2t_tpu.inference.generator import SequenceGenerator as JaxGenerator
from s2t_tpu.inference.scorer import SequenceScorer as JaxScorer
from s2t_tpu.models import transformer_lm as jlm
from s2t_tpu.tasks.speech_to_text import SpeechToTextTask as JaxTask
from s2t_tpu_torch.config import TrainConfig, from_dict
from s2t_tpu_torch.data.dataset import S2TDataConfig
from s2t_tpu_torch.data.dictionary import Dictionary
from s2t_tpu_torch.inference.generator import SequenceGenerator
from s2t_tpu_torch.inference.scorer import SequenceScorer
from s2t_tpu_torch.interop.from_flax import load_flax_params, state_dict_to_flax
from s2t_tpu_torch.models import transformer_lm as tlm
from s2t_tpu_torch.models.build import build_model
from s2t_tpu_torch.tasks.speech_to_text import SpeechToTextTask

from tests.test_torch_search import TINY, build_pair, make_batch
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

ATOL = 1e-5
LM = dict(vocab_size=32, decoder_embed_dim=32, decoder_ffn_embed_dim=64, decoder_layers=2,
          decoder_attention_heads=2, dropout=0.0, max_target_positions=64)
ADAPTIVE = dict(LM, vocab_size=40, adaptive_softmax_cutoff=(10, 20),
                adaptive_input_cutoff=(10, 20), decoder_learned_pos=True)
LM_VARIANTS = {"transformer_lm": (jlm.transformer_lm_base, tlm.transformer_lm_base, LM),
               "wiki103_learned_pos": (jlm.transformer_lm_wiki103, tlm.transformer_lm_wiki103,
                                       ADAPTIVE)}


def lm_pair(variant, seed=3):
    jpreset, tpreset, kw = LM_VARIANTS[variant]
    jm = jlm.TransformerLM(jpreset(**kw))
    prev = make_batch()[2]
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(seed), prev)["params"])
    tm = tlm.TransformerLM(tpreset(**kw), device="cpu", seed=0)
    return jm, params, load_flax_params(tm, params)


@pytest.fixture(scope="module")
def models():
    return {"s2t": build_pair(), "s2t_2": build_pair(seed=7, torch_seed=3),
            "lm": lm_pair("transformer_lm")}


def test_every_lm_arch_builds():
    for arch in ("transformer_lm", "transformer_lm_big", "transformer_lm_wiki103",
                 "transformer_lm_baevski_wiki103"):
        m = build_model(arch, dict(decoder_layers=1, vocab_size=64, decoder_embed_dim=32,
                                   decoder_ffn_embed_dim=32, decoder_attention_heads=2,
                                   adaptive_softmax_cutoff=(16, 32) if "wiki" in arch else (),
                                   adaptive_input_cutoff=(16, 32) if "wiki" in arch else ()),
                        device="cpu")
        assert isinstance(m, tlm.TransformerLM)
        assert (m.adaptive is not None) == ("wiki" in arch)


@pytest.mark.parametrize("variant", list(LM_VARIANTS))
def test_lm_forward_and_from_flax_both_ways(variant):
    jm, params, tm = lm_pair(variant)
    prev = make_batch(seed=2)[2]
    ref = jm.apply({"params": params}, prev)
    with torch.no_grad():
        out = tm(torch.from_numpy(prev).long())
    np.testing.assert_allclose(out["decoder_logits"].numpy(), np.asarray(ref["decoder_logits"]),
                               atol=ATOL)
    if tm.adaptive is not None:
        tgt = np.roll(prev, -1, axis=1)
        ref = jm.apply({"params": params}, prev, targets=tgt)
        with torch.no_grad():
            got = tm(torch.from_numpy(prev).long(), targets=torch.from_numpy(tgt).long())
        np.testing.assert_allclose(got["target_logprob"].numpy(),
                                   np.asarray(ref["target_logprob"]), atol=ATOL)
        with pytest.raises(NotImplementedError, match="adaptive-softmax"):
            tm.decode_step(torch.from_numpy(prev[:, :1]).long(), tm.init_cache(4, 8), 0)
    back = state_dict_to_flax(tm.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_lm_fusion_tokens_identical(models):
    (jm, params, tm), (jl, lparams, tl) = models["s2t"], models["lm"]
    feats, lens, _ = make_batch()
    batch = {"features": feats, "feat_lengths": lens}
    kw = dict(beam_size=3, max_len_b=12, lm_weight=0.3, temperature=1.2)
    jt, js, _ = JaxGenerator(jm, lm_model=jl, lm_params=lparams, **kw).generate(params, batch)
    tt, ts, _ = SequenceGenerator(tm, lm_model=tl, **kw).generate(batch)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=ATOL, atol=ATOL)
    plain, _, _ = SequenceGenerator(tm, beam_size=3, max_len_b=12, temperature=1.2).generate(batch)
    assert not torch.equal(plain, tt)
    # lm_params: the LM's weights handed over as a state dict, as JAX hands over its tree
    other = tlm.TransformerLM(tlm.transformer_lm_base(**LM), device="cpu", seed=9)
    lt, _, _ = SequenceGenerator(tm, lm_model=other, lm_params=tl.state_dict(),
                                 **kw).generate(batch)
    assert torch.equal(lt, tt)


def test_two_member_ensemble_tokens_identical(models):
    (jm, params, tm), (jm2, params2, tm2) = models["s2t"], models["s2t_2"]
    feats, lens, _ = make_batch()
    batch = {"features": feats, "feat_lengths": lens}
    kw = dict(beam_size=3, max_len_b=12)
    jt, js, _ = JaxGenerator(jm, extra_models=[jm2], **kw).generate(params, batch,
                                                                    extra_params=[params2])
    tt, ts, _ = SequenceGenerator(tm, extra_models=[tm2], **kw).generate(batch)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=ATOL, atol=ATOL)


def _tasks(tmp_path):
    words = [f"w{i}" for i in range(28)]
    (tmp_path / "dict.txt").write_text("".join(f"{w} 1\n" for w in words))
    cfg = {"arch": "s2t_transformer_s", "model": TINY, "dataset": {"data": str(tmp_path)}}
    task = SpeechToTextTask(from_dict(TrainConfig, cfg), S2TDataConfig(),
                            Dictionary.load(tmp_path / "dict.txt"))
    jtask = JaxTask(jax_from_dict(JaxTrainConfig, cfg), JaxDataConfig(),
                    JaxDictionary.load(tmp_path / "dict.txt"), None)
    return task, jtask


def test_sequence_scorer_matches_jax(models, tmp_path):
    jm, params, tm = models["s2t"]
    feats, lens, prev = make_batch()
    target = np.concatenate([prev[:, 1:], np.full((4, 1), 2, np.int32)], axis=1)
    target[3, 3:] = 1  # a padded row
    batch = {"features": feats, "feat_lengths": lens, "prev_tokens": prev, "target": target}
    task, jtask = _tasks(tmp_path)
    for fwd, jfwd in ((None, None), (task.forward_fn(), jtask.forward_fn())):
        want = JaxScorer(jm, forward_fn=jfwd).score(params, batch)
        got = SequenceScorer(tm, forward_fn=fwd).score(batch)
        for key in ("positional_scores", "score", "avg_score"):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=ATOL,
                                       err_msg=key)
        np.testing.assert_array_equal(got["ntokens"].numpy(), np.asarray(want["ntokens"]))
    assert got["ntokens"].tolist() == [7, 7, 7, 3]
