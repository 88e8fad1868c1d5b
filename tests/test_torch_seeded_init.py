"""The seeded build of every model class skips torch's default init (``seeded_init``).

While a model is built, the ``reset_parameters`` of its Linear, Conv and
Embedding modules is poisoned here (NaN in place of the skipped init), so a
weight that neither construction nor ``init_and_place`` writes stays NaN; and
two builds under different global seeds must give the same weights, so none of
them comes from the global generator.  One arch per model class, at its
preset's width.
"""

import pytest
import torch

from s2t_tpu_torch.models import s2t_transformer
from s2t_tpu_torch.models.build import build_model
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

V = {"vocab_size": 100}
ARCHS = {  # one arch of each model class, with the task's context where it takes one
    "s2t_transformer_s": V, "s2t_conformer": V, "pdss2t_transformer_s_8": V,
    "s2t_sate_s": V, "s2t_ctc": V, "s2t_dual_s": V, "s2t_multibranch_s": V,
    "s2t_w2v2_transformer": V, "s2t_berard": V, "emformer_s": V, "transformer": V,
    "transformer_ctc": {**V, "use_ctc": True}, "transformer_lm": V, "wav2vec": {},
    "wav2vec2_base": {}, "wav2vec_ctc": V, "wav2vec_seq2seq": V, "fconv_iwslt_de_en": V,
    "transformer_align": V, "cmlm_transformer_small": V, "nacrf_transformer": V,
    "levenshtein_transformer_small": V, "insertion_transformer": V,
    # one layer a stack: the tables and heads are what these classes add
    "multilingual_transformer": {**V, "lang_pairs": ("de-en", "fr-en"), "share_decoders": True,
                                 "encoder_layers": 1, "decoder_layers": 1},
    "bert_base": {**V, "encoder_layers": 1}, "hf_gpt2": {**V, "decoder_layers": 1},
}


def poison(module):
    for p in module.parameters(recurse=False):
        p.data.fill_(float("nan"))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_seeded_build_writes_every_weight_from_the_seed(monkeypatch, arch):
    monkeypatch.setattr(s2t_transformer, "skip_default_init", poison)
    builds = []
    for global_seed in (1, 2):
        torch.manual_seed(global_seed)
        builds.append(build_model(arch, ARCHS[arch], device="cpu", seed=0,
                                  for_training=True).state_dict())
    unwritten = [n for n, t in builds[0].items()
                 if t.is_floating_point() and not torch.isfinite(t).all()]
    assert not unwritten, f"{arch}: left unwritten by the seeded build: {unwritten}"
    differ = [n for n in builds[0] if not torch.equal(builds[0][n], builds[1][n])]
    assert not differ, f"{arch}: weights that follow the global generator: {differ}"
