"""Levenshtein Transformer, the edit-based NAT of delete / insert / fill
(counterpart of s2t_tpu/models/levenshtein_transformer.py).

The encoder, the non-causal decoder and three heads on its features: deletion
(``del_head``, 2-way per token), placeholder counts (``ins_head``, ``max_ins``-way
over each adjacent pair of features) and the word predictor (the decoder's output
projection).  Training rolls in from a randomly word-dropped, bos-prefixed target
(``ops/levenshtein.py``): the insertion oracle is greedy leftmost matching, the
fill step predicts the dropped words on an <unk> canvas, and the deletion oracle
holds the model's own fill (argmax, no gradient) to the target through the LCS
backtrace.  Its draws come from ``draw_generator`` or the ``draws`` handed over
(``delete_scores`` (B, T + 1), ``delete_fractions`` (B,)).  Decoding
(``init_canvas`` / ``refine_step``) runs delete -> insert -> fill on a left-packed
(B, Tmax) canvas, so every decoder call's padding is a prefix.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from s2t_tpu_torch.models.cmlm_transformer import CMLMConfig, NATModel
from s2t_tpu_torch.modules.cast import Linear
from s2t_tpu_torch.ops.levenshtein import (
    compact_tokens, del_targets, ins_oracle_leftmost, insert_placeholders,
    random_delete_with_mask)
from s2t_tpu_torch.registry import register_model, register_model_architecture


@dataclass(frozen=True)
class LevenshteinConfig(CMLMConfig):
    max_ins: int = 64  # the placeholder-count classifier's arity


@register_model("levenshtein_transformer")
class LevenshteinTransformerModel(NATModel):
    def build_heads(self, cfg: LevenshteinConfig) -> None:
        D = cfg.decoder_embed_dim
        self.del_head = Linear(D, 2)
        self.ins_head = Linear(2 * D, cfg.max_ins)

    def _feats(self, tokens, enc_out, enc_valid, generator=None):
        return self.decoder.forward_features(tokens, enc_out, enc_valid, generator)

    def _ins_logits(self, feats):
        return self.ins_head(torch.cat([feats[:, :-1], feats[:, 1:]], dim=-1))

    def forward(self, src_tokens, src_lengths, prev_tokens=None, tgt_tokens=None,
                train: bool = False, generator: Optional[torch.Generator] = None,
                draws: Optional[Dict[str, torch.Tensor]] = None,
                draw_generator: Optional[torch.Generator] = None, **unused) -> Dict[str, Any]:
        """The roll-in and its three oracles (levenshtein_transformer.py:145-224);
        ``prev_tokens`` is unused."""
        cfg = self.cfg
        generator = self._generator(train, generator)
        tgt = prev_tokens if tgt_tokens is None else tgt_tokens
        enc = self.encoder(src_tokens, src_lengths, generator)
        enc_valid = self.encoder_valid(enc)
        eo = enc["encoder_out"]
        # a bos anchor, so insertions before the first word are modelled
        tgt = torch.cat([torch.full_like(tgt[:, :1], cfg.bos_id), tgt], dim=1)
        draws = draws or {}
        y_del, keep = random_delete_with_mask(
            tgt, cfg.pad_id, cfg.bos_id, cfg.eos_id, draw_generator,
            draws.get("delete_scores"), draws.get("delete_fractions"))
        # insertion: placeholder counts on the word-dropped canvas
        ins_logits = self._ins_logits(self._feats(y_del, eo, enc_valid, generator))
        ins_tgt = ins_oracle_leftmost(y_del, tgt, cfg.pad_id)[:, :-1].clamp(0, cfg.max_ins - 1)
        n_keep = (y_del != cfg.pad_id).sum(dim=1)
        ins_mask = torch.arange(ins_logits.shape[1], device=tgt.device)[None, :] \
            < (n_keep - 1)[:, None]
        # fill: the words of the <unk> canvas
        canvas = torch.where(keep, tgt, cfg.unk_id)
        canvas = torch.where(tgt == cfg.pad_id, cfg.pad_id, canvas)
        word_logits = self.decoder._output(self._feats(canvas, eo, enc_valid, generator))
        word_mask = canvas == cfg.unk_id
        # deletion: roll in from the model's own fill
        pred_fill = torch.where(word_mask, word_logits.detach().argmax(dim=-1), canvas)
        del_logits = self.del_head(self._feats(pred_fill, eo, enc_valid, generator))
        return {"word_ins_logits": word_logits, "word_ins_mask": word_mask,
                "word_ins_tgt": tgt,  # bos-prefixed; replaces the batch's target
                "ins_logits": ins_logits, "ins_tgt": ins_tgt, "ins_mask": ins_mask,
                "del_logits": del_logits, "del_tgt": del_targets(pred_fill, tgt, cfg.pad_id),
                "del_mask": pred_fill != cfg.pad_id, **enc}

    def init_canvas(self, encoder_out, enc_valid, Tmax: int) -> torch.Tensor:
        tokens = torch.full((encoder_out.shape[0], Tmax), self.cfg.pad_id, dtype=torch.long,
                            device=encoder_out.device)
        tokens[:, 0], tokens[:, 1] = self.cfg.bos_id, self.cfg.eos_id
        return tokens

    def refine_step(self, tokens, scores, encoder_out, enc_valid, step: int):
        """One delete -> insert -> fill round; the first round deletes nothing."""
        cfg = self.cfg
        special = (tokens == cfg.pad_id) | (tokens == cfg.bos_id) | (tokens == cfg.eos_id)
        if step > 0:
            del_pred = self.del_head(self._feats(tokens, encoder_out, enc_valid)).argmax(-1) == 1
            tokens, _ = compact_tokens(tokens, ~(del_pred & ~special) & (tokens != cfg.pad_id),
                                       cfg.pad_id)
        scores = torch.zeros_like(scores)
        counts = self._ins_logits(self._feats(tokens, encoder_out, enc_valid)).argmax(-1)
        counts = torch.cat([counts, torch.zeros_like(counts[:, :1])], dim=1)
        tokens, _ = insert_placeholders(tokens, counts, cfg.pad_id, cfg.unk_id)
        lp = torch.log_softmax(
            self.decoder._output(self._feats(tokens, encoder_out, enc_valid)).float(), dim=-1)
        fill_scores, fill = lp.max(dim=-1)
        masked = tokens == cfg.unk_id
        return torch.where(masked, fill, tokens), torch.where(masked, fill_scores, scores)


@register_model_architecture("levenshtein_transformer", "levenshtein_transformer")
def levenshtein_transformer(**kw) -> LevenshteinConfig:
    return LevenshteinConfig().replace(**kw)


@register_model_architecture("levenshtein_transformer", "levenshtein_transformer_small")
def levenshtein_transformer_small(**kw) -> LevenshteinConfig:
    return LevenshteinConfig(
        encoder_embed_dim=256, encoder_ffn_embed_dim=1024, encoder_attention_heads=4,
        decoder_embed_dim=256, decoder_ffn_embed_dim=1024, decoder_attention_heads=4,
    ).replace(**kw)
