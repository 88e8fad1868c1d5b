"""Model construction from an arch name and config-dict overrides
(counterpart of s2t_tpu/models/build.py).

The ported presets: the ``s2t_transformer`` ones (base, s, xs, sp, m, mp, l,
lp, the Conformer ``s2t_conformer``, the encoder variants ``s2t_transformer_s_relative``,
``s2t_dynamic_transformer_s``, ``s2t_light_transformer_s``, ``s2t_transformer_s_dlcl``
and the ESPnet-ST ``convtransformer`` / ``convtransformer_espnet``), the 13
``pdss2t_transformer_*`` ones, SATE's ``s2t_sate`` / ``s2t_sate_s`` and the
encoder-only ``s2t_ctc``, ``s2t_nast``, ``s2t_ctc_pds`` and ``s2t_ctc_sate``, the
language models ``transformer_lm``, ``transformer_lm_big``, ``transformer_lm_wiki103``
and ``transformer_lm_baevski_wiki103``, the dual / multibranch models ``s2t_dual``,
``s2t_dual_s``, ``s2t_multibranch``, ``s2t_multibranch_s``, and the wav2vec 2.0
family ``wav2vec2_base``, ``wav2vec2_large``, ``wav2vec_ctc``, ``wav2vec_seq2seq``,
``s2t_w2v2_transformer`` and ``s2t_w2v2_transformer_base``, the Berard presets
(``berard``, ``s2t_berard``, ``s2t_berard_256_3_3``, ``berard_512_3_2``,
``s2t_berard_512_3_2``, ``s2t_berard_512_5_3``), wav2vec v1 (``wav2vec``,
``wav2vec_large``), the streaming ``emformer`` / ``emformer_s``, and the text
Transformer (``transformer``, ``transformer_iwslt_de_en``,
``transformer_wmt_en_de_big``, ``transformer_wmt_en_de_big_t2t``,
``transformer_ctc``), ConvS2S (``fconv``, ``fconv_iwslt_de_en``, ``fconv_wmt_en_de``),
the alignment Transformer (``transformer_align``, ``transformer_wmt_en_de_big_align``),
the NAT family (``cmlm_transformer``, ``cmlm_transformer_small``,
``nonautoregressive_transformer``, ``nacrf_transformer``, ``levenshtein_transformer``,
``levenshtein_transformer_small``, ``insertion_transformer``), BART (``bart_base``,
``bart_large``, ``mbart_large``), the LSTMs (``lstm``, ``lstm_wiseman_iwslt_de_en``,
``lstm_lm``) and the convolution models (``lightconv``, ``lightconv_iwslt_de_en``,
``dynamicconv``, ``dynamicconv_iwslt_de_en``), the multilingual Transformer
(``multilingual_transformer``, ``multilingual_transformer_iwslt_de_en``), RoBERTa / BERT
(``roberta_base``, ``roberta_large``, ``bert_base``, ``camembert``, ``gottbert``,
``xlmr_base``, ``xlmr_large``) and GPT-2 (``hf_gpt2``, ``hf_gpt2_medium``,
``hf_gpt2_large``): every architecture of the JAX registry.  A ported preset whose
config selects an unported branch raises naming the field.
"""

from __future__ import annotations

from typing import Any, Dict

from s2t_tpu_torch.models import (  # noqa: F401  (the presets)
    bart, berard, cmlm_transformer, fconv, hf_gpt2, insertion_transformer,
    levenshtein_transformer, lightconv, lstm, multilingual_transformer, pds, roberta, s2t_ctc,
    s2t_dual, s2t_multibranch, s2t_transformer, s2t_w2v2_transformer, sate, streaming,
    transformer, transformer_align, transformer_lm, wav2vec, wav2vec2)
from s2t_tpu_torch.registry import ARCHS, MODELS


def build_model(arch: str, overrides: Dict[str, Any] | None = None, *, device="cuda",
                seed: int = 0, for_training: bool = False, **ctx):
    """Build a model from a registered preset.  ``ctx`` carries task-provided
    fields (vocab sizes, feature dims, position caps) applied after the
    user's ``overrides``; the weights come from ``seed`` on ``device``."""
    model_name, preset = ARCHS.get(arch)
    merged = {**(overrides or {}), **ctx}
    # lists from YAML -> tuples (config fields are hashable tuples)
    merged = {k: tuple(v) if isinstance(v, list) else v for k, v in merged.items()}
    try:
        cfg = preset(**merged)
    except TypeError as e:
        raise ValueError(f"unknown model config key for arch {arch!r}: {e}") from e
    model_cls = MODELS.get(model_name)
    return model_cls(cfg, device=device, seed=seed, for_training=for_training)
