"""Speech-to-text task: ASR and end-to-end ST
(counterpart of s2t_tpu/tasks/speech_to_text.py).

The dictionaries come from the data directory's ``config.yaml`` (or a
``S2TDataConfig`` built in Python and handed to the constructor), datasets
are TSV manifests, and the forward adapter runs the feature pipeline inside
the step: with ``use_audio_input`` the Kaldi fbank through the K5 wrapper
(``ops/fbank_cuda.fbank``: the kernel on the card, its plain version on the
CPU), then the split's feature transforms, then the model.

In training the adapter also threads the encoder's own inputs, as the JAX
one does (``encoder_inputs``): the PAE oracle's transcript and EOS-stripped
target when the model's config sets a ground-truth ratio, and the step count
(``num_updates``) for mixup's ratio decay.

An encoder-only model (``decoder_layers == 0``) decodes through
``CTCGenerator`` (greedy, or the prefix beam for ``generation.beam`` > 1; the
XCTC head's logits when the model's config sets ``use_xctc``: a SATE config has
no such field, so ``s2t_ctc_sate`` decodes its acoustic CTC head, as in JAX), an
encoder-decoder through ``SequenceGenerator``, or ``JacobiGenerator`` under
``generation.jacobi`` (unless ``no_repeat_ngram_size`` > 0: then, with a
warning, the sequential engine); a ``generation.lm_path`` ending in ``.arpa``
gives the CTC generator its n-gram LM (``lm_weight``), and the sequence
generator takes every generation option of the JAX task (joint CTC decoding,
sampling, prefix forcing, diverse search, constraints, the int8 cache).  Under
``latency_augmented_label_smoothed_cross_entropy`` the adapter's output also
carries every decoder layer's cross-attention (``criterions/latency.with_cross_attn``).
Decoding a ``use_audio_input`` split raises as JAX's does (its generator feeds such a
batch's waveforms to the encoder without an fbank, ROADMAP.md section 3).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional

import torch

from s2t_tpu_torch.config import TrainConfig
from s2t_tpu_torch.data.audio.transforms import CompositeTransform
from s2t_tpu_torch.data.dataset import S2TDataConfig, SpeechToTextDataset
from s2t_tpu_torch.data.dictionary import Dictionary
from s2t_tpu_torch.data.multilingual import MultilingualS2TDataset
from s2t_tpu_torch.data.ngram_lm import ArpaLM
from s2t_tpu_torch.inference.ctc_decoder import CTCDecoder, CTCGenerator
from s2t_tpu_torch.inference.generator import SequenceGenerator
from s2t_tpu_torch.inference.jacobi import JacobiGenerator
from s2t_tpu_torch.ops.fbank_cuda import fbank
from s2t_tpu_torch.registry import register_task
from s2t_tpu_torch.tasks.base import Task
from s2t_tpu_torch.trainer import fold_in

# the JAX step folds its dropout key with 7 for the feature transforms
TRANSFORM_FOLD = 7


def encoder_inputs(mcfg, batch, train: bool) -> dict:
    """The encoder's keyword inputs of a training forward
    (s2t_tpu/tasks/speech_to_text.py:139-158): the oracle's ``transcript`` and
    the target with EOS (2) rewritten to pad (1) and its lengths less one, when
    the config sets a ground-truth ratio; ``num_updates`` (the batch's
    ``_step``) under mixup's ratio decay; in training and eval alike, the
    transcript of a model that ``consumes_transcript`` (:139-141)."""
    kw = {}
    if getattr(mcfg, "consumes_transcript", False) and "transcript" in batch:
        kw["transcript"] = batch["transcript"]
        kw["transcript_lengths"] = batch["transcript_lengths"]
    if not train:
        return kw
    if getattr(mcfg, "ctc_pae_ground_truth_ratio", 0.0) > 0 or \
            getattr(mcfg, "xctc_pae_ground_truth_ratio", 0.0) > 0:
        if "transcript" in batch:
            kw["transcript"] = batch["transcript"]
            kw["transcript_lengths"] = batch["transcript_lengths"]
        if "target" in batch and getattr(mcfg, "xctc_pae_ground_truth_ratio", 0.0) > 0:
            tgt = batch["target"]
            kw["target"] = torch.where(tgt == 2, 1, tgt)
            kw["target_lengths"] = batch["target_lengths"] - 1
    if getattr(mcfg, "inter_mixup_ratio_decay", False) and "_step" in batch:
        kw["num_updates"] = int(batch["_step"])
    return kw


@register_task("speech_to_text")
class SpeechToTextTask(Task):
    def __init__(self, cfg: TrainConfig, data_cfg: S2TDataConfig, tgt_dict: Dictionary,
                 src_dict: Optional[Dictionary] = None):
        super().__init__(cfg)
        self.data_cfg = data_cfg
        self.tgt_dict = tgt_dict
        self.src_dict = src_dict or tgt_dict

    @classmethod
    def setup(cls, cfg: TrainConfig) -> "SpeechToTextTask":
        root = Path(cfg.dataset.data)
        data_cfg_path = root / "config.yaml"
        data_cfg = (S2TDataConfig.from_yaml(data_cfg_path) if data_cfg_path.exists()
                    else S2TDataConfig())
        tgt_dict = Dictionary.load(root / data_cfg.vocab_filename)
        src_dict = None
        if data_cfg.src_vocab_filename:
            src_dict = Dictionary.load(root / data_cfg.src_vocab_filename)
        return cls(cfg, data_cfg, tgt_dict, src_dict)

    def load_dataset(self, split: str, is_train: bool = False):
        root = Path(self.cfg.dataset.data)

        def one(name):
            return SpeechToTextDataset(root / f"{name}.tsv", self.data_cfg, self.tgt_dict,
                                       self.src_dict, is_train=is_train, root=str(root))

        if "," in split:
            # per-language splits, upsampled by temperature (s2t_tpu/tasks/speech_to_text.py:73-80)
            ds = MultilingualS2TDataset([one(s.strip()) for s in split.split(",")],
                                        alpha=self.data_cfg.sampling_alpha, resample=is_train)
        else:
            ds = one(split)
        self.datasets[split] = ds
        return ds

    def build_model(self, device="cuda", seed: Optional[int] = None, for_training: bool = False):
        """The model of ``cfg.arch`` with the task's vocab sizes and feature and
        position caps.  With ``use_audio_input`` the position cap counts samples,
        as in the JAX package, so the encoder's sinusoidal table has that many rows."""
        from s2t_tpu_torch.models.build import build_model

        return build_model(
            self.cfg.arch or "s2t_transformer_s", self.cfg.model,
            device=device, seed=self.cfg.common.seed if seed is None else seed,
            for_training=for_training,
            vocab_size=len(self.tgt_dict),
            src_vocab_size=len(self.src_dict),
            input_feat_per_channel=self.data_cfg.input_feat_per_channel,
            input_channels=self.data_cfg.input_channels,
            max_source_positions=self.cfg.dataset.max_source_positions,
            max_target_positions=self.cfg.dataset.max_target_positions,
        )

    def forward_fn(self):
        train_tf = CompositeTransform.from_config_dict(self.data_cfg.get_transforms("train", True))
        eval_tf = CompositeTransform.from_config_dict(self.data_cfg.get_transforms("eval", False))
        use_audio = self.data_cfg.use_audio_input
        n_mels = self.data_cfg.input_feat_per_channel
        cfg = self.cfg

        def fwd(model, batch, train: bool = False, generator: Optional[torch.Generator] = None):
            feats, lengths = batch["features"], batch["feat_lengths"]
            if use_audio:
                # the fbank inside the step: K5 on the card, its plain version on the CPU
                feats, lengths = fbank(feats, lengths, num_mel_bins=n_mels)
            tf = train_tf if train else eval_tf
            if tf.transforms:
                tf_gen = None
                if train and generator is not None:
                    tf_gen = torch.Generator(device=feats.device).manual_seed(
                        fold_in(generator.initial_seed(), TRANSFORM_FOLD))
                feats = tf(feats, lengths, tf_gen)
            return model(feats, lengths, batch["prev_tokens"], train=train, generator=generator,
                         **encoder_inputs(model.cfg, batch, train))

        if cfg.criterion.startswith("latency_augmented"):
            # the latency penalty reads every decoder layer's cross-attention
            from s2t_tpu_torch.criterions.latency import with_cross_attn

            return with_cross_attn(fwd)
        return fwd

    def build_generator(self, model, gen_cfg=None):
        g = gen_cfg or self.cfg.generation
        if getattr(model.cfg, "decoder_layers", 1) == 0:
            # encoder-only model: decode from CTC (s2t_tpu/tasks/speech_to_text.py:182-202)
            ngram_lm = None
            if g.lm_path and str(g.lm_path).endswith(".arpa"):
                ngram_lm = ArpaLM.load(g.lm_path)
            dec = CTCDecoder(beam_size=g.beam, pad_id=self.tgt_dict.pad(),
                             self_ensemble=g.ctc_self_ensemble,
                             intermediate_logit=g.ctc_inter_logit)
            return CTCGenerator(model, dec, use_xctc=getattr(model.cfg, "use_xctc", False),
                                ngram_lm=ngram_lm, lm_weight=g.lm_weight,
                                dictionary=self.tgt_dict)
        if g.jacobi:
            if g.no_repeat_ngram_size > 0:
                # n-gram blocking has no parallel form: the sequential engine keeps it
                logging.getLogger("s2t_tpu_torch").warning(
                    "generation.jacobi ignored: no_repeat_ngram_size > 0 requires the "
                    "sequential beam engine")
            else:
                return JacobiGenerator(
                    model, max_len_a=g.max_len_a, max_len_b=g.max_len_b,
                    max_target_positions=self.cfg.dataset.max_target_positions,
                    min_len=g.min_len, lenpen=g.lenpen, eos_id=self.tgt_dict.eos(),
                    pad_id=self.tgt_dict.pad())
        return SequenceGenerator(
            model,
            beam_size=g.beam,
            max_len_a=g.max_len_a,
            max_len_b=g.max_len_b,
            min_len=g.min_len,
            lenpen=g.lenpen,
            temperature=g.temperature,
            no_repeat_ngram_size=g.no_repeat_ngram_size,
            eos_id=self.tgt_dict.eos(),
            pad_id=self.tgt_dict.pad(),
            max_target_positions=self.cfg.dataset.max_target_positions,
            infer_ctc_weight=g.infer_ctc_weight,
            sampling=g.sampling,
            sampling_topk=g.sampling_topk,
            sampling_topp=g.sampling_topp,
            prefix_size=g.prefix_size,
            diverse_beam_groups=g.diverse_beam_groups,
            diverse_beam_strength=g.diverse_beam_strength,
            diversity_rate=g.diversity_rate,
            constraints_mode=g.constraints,
            kv_cache_dtype=g.kv_cache_dtype,
        )

    def decode_tokens(self, tokens) -> str:
        """ids -> detokenised text (for scoring and the output files)."""
        return self.tgt_dict.string(tokens, bpe_symbol=self.cfg.generation.post_process)
