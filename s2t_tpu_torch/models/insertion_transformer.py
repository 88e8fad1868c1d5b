"""Insertion Transformer, Stern et al. 2019 (counterpart of
s2t_tpu/models/insertion_transformer.py).

Canvas convention: [bos, t1 .. tk, eos, pad ...]; slot j sits between canvas
positions j and j + 1, and the "insert nothing" label is pad.  Training keeps a
random subset of each target's words on the canvas (``make_slot_targets``): every
slot is supervised with the tau-weighted soft distribution over the run of words
dropped there, centre words weighing most (slot = words kept before it; position
in the run = distance from the last kept word).  The slot head reads each pair of
adjacent decoder features: ``slot_proj`` (2D -> D), tanh-GELU (flax's default),
the decoder's output projection.  ``insertion_decode`` inserts in every confident
slot at once on a fixed (B, Tmax) canvas, until no slot inserts or ``max_iter``;
``pad_penalty`` is subtracted from the pad label first.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from s2t_tpu_torch.models.cmlm_transformer import NATModel
from s2t_tpu_torch.models.transformer import TransformerMTConfig
from s2t_tpu_torch.modules.cast import Linear
from s2t_tpu_torch.registry import register_model, register_model_architecture


@dataclass(frozen=True)
class InsertionConfig(TransformerMTConfig):
    insertion_tau: float = 1.0  # the tree weights' temperature
    unk_id: int = 3
    bos_id: int = 0
    eos_id: int = 2


def make_slot_targets(tgt: torch.Tensor, keep: torch.Tensor, pad_id: int, vocab_size: int,
                      tau: float = 1.0, bos_id: int = 0, eos_id: int = 2):
    """tgt (B, T) targets without eos (pad-padded), keep (B, T) the words that stay
    -> (canvas (B, T + 2), slot_tgt (B, T + 1, V) soft targets, slot_valid (B, T + 1))."""
    B, T = tgt.shape
    S = T + 1
    dev = tgt.device
    tgt = tgt.long()
    nonpad = tgt != pad_id
    keep = keep & nonpad
    dropped = nonpad & ~keep
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)  # kept words first
    pos = torch.arange(T, device=dev)[None, :]
    n_keep = keep.sum(dim=1)
    compact = torch.where(pos < n_keep[:, None], tgt.gather(1, order), pad_id)
    canvas = torch.cat([torch.full((B, 1), bos_id, dtype=torch.long, device=dev), compact,
                        torch.full((B, 1), pad_id, dtype=torch.long, device=dev)], dim=1)
    canvas[torch.arange(B, device=dev), n_keep + 1] = eos_id
    k = keep.long()
    slot = torch.cumsum(k, dim=1) - k  # the words kept before each position
    last_kept = torch.cummax(torch.where(keep, pos, -1), dim=1).values
    p = (pos - last_kept - 1).float()  # position within its run of dropped words
    slot_hot = F.one_hot(slot, S).float() * dropped[..., None]
    n_tok = slot_hot.sum(dim=1).gather(1, slot)  # the size of each word's run
    w = torch.exp(-tau * torch.abs(p - (n_tok - 1.0) / 2.0)) * dropped.float()
    slot_tgt = torch.zeros((B, S, vocab_size), dtype=torch.float32, device=dev)
    slot_tgt.index_put_((torch.arange(B, device=dev)[:, None].expand(B, T), slot, tgt), w,
                        accumulate=True)
    mass = slot_tgt.sum(dim=-1, keepdim=True)
    pad_hot = F.one_hot(torch.full((B, S), pad_id, dtype=torch.long, device=dev),
                        vocab_size).float()
    slot_tgt = torch.where(mass > 0, slot_tgt / torch.clamp(mass, min=1e-9), pad_hot)
    slot_valid = torch.arange(S, device=dev)[None, :] <= n_keep[:, None]
    return canvas, slot_tgt, slot_valid


@register_model("insertion_transformer")
class InsertionTransformerModel(NATModel):
    """``forward(src_tokens, src_lengths, canvas, slot_tgt, slot_valid, train,
    generator)`` -> {"slot_logits" (B, L - 1, V), ["slot_tgt", "slot_valid"], ...}."""

    decoder_positions_extra = 2  # bos and eos frame the canvas

    def build_heads(self, cfg: InsertionConfig) -> None:
        self.slot_proj = Linear(2 * cfg.decoder_embed_dim, cfg.decoder_embed_dim)

    def slot_head(self, feats: torch.Tensor) -> torch.Tensor:
        """(B, L, D) decoder features -> (B, L - 1, V) logits of the slots between them."""
        h = F.gelu(self.slot_proj(torch.cat([feats[:, :-1], feats[:, 1:]], dim=-1)),
                   approximate="tanh")
        return self.decoder._output(h)

    def slot_logits(self, canvas, encoder_out, enc_valid, generator=None) -> torch.Tensor:
        return self.slot_head(self.decoder.forward_features(canvas, encoder_out, enc_valid,
                                                            generator))

    def forward(self, src_tokens, src_lengths, canvas, slot_tgt=None, slot_valid=None,
                train: bool = False, generator: Optional[torch.Generator] = None,
                **unused) -> Dict[str, Any]:
        generator = self._generator(train, generator)
        enc = self.encoder(src_tokens, src_lengths, generator)
        out: Dict[str, Any] = {"slot_logits": self.slot_logits(
            canvas, enc["encoder_out"], self.encoder_valid(enc), generator), **enc}
        if slot_tgt is not None:
            out["slot_tgt"], out["slot_valid"] = slot_tgt, slot_valid
        return out


@torch.no_grad()
def insertion_decode(model, enc_out, enc_valid, Tmax: int, max_iter: int = 10, bos: int = 0,
                     pad: int = 1, eos: int = 2, threshold: float = 0.0,
                     pad_penalty: float = 0.0):
    """Parallel insertion on a (B, Tmax) canvas -> (tokens (B, Tmax) without bos,
    scores (B,) zeros); a canvas that would overflow inserts nothing that round."""
    B, dev = enc_out.shape[0], enc_out.device
    canvas = torch.full((B, Tmax), pad, dtype=torch.long, device=dev)
    canvas[:, 0], canvas[:, 1] = bos, eos
    length = torch.full((B,), 2, dtype=torch.long, device=dev)
    old_pos = torch.arange(Tmax, device=dev)[None, :]
    for _ in range(max_iter):
        lp = torch.log_softmax(model.slot_logits(canvas, enc_out, enc_valid).float(), dim=-1)
        lp[..., pad] -= pad_penalty
        best_lp, best = lp.max(dim=-1)  # (B, S)
        S = best.shape[1]
        slot_valid = old_pos[:, :S] < (length - 1)[:, None]
        do_ins = slot_valid & (best != pad) & (best_lp > lp[..., pad] + threshold)
        overflow = length + do_ins.sum(dim=1) > Tmax
        do_ins = do_ins & ~overflow[:, None]
        ins_before = torch.cumsum(do_ins.long(), dim=1)
        shift = torch.cat([torch.zeros_like(ins_before[:, :1]), ins_before], dim=1)[:, :Tmax]
        valid_old = old_pos < length[:, None]
        new = torch.full((B, Tmax + 1), pad, dtype=torch.long, device=dev)  # column Tmax: dropped
        new.scatter_(1, torch.where(valid_old, old_pos + shift, Tmax), canvas)
        ins_pos = torch.where(do_ins, old_pos[:, :S] + 1 + ins_before - do_ins.long(), Tmax)
        new.scatter_(1, ins_pos, torch.where(do_ins, best, pad))
        canvas = new[:, :Tmax]
        n_ins = do_ins.sum(dim=1)
        length = length + n_ins
        if not bool((n_ins > 0).any()):
            break
    tokens = torch.cat([canvas[:, 1:], torch.full_like(canvas[:, :1], pad)], dim=1)
    return tokens, torch.zeros(B, dtype=torch.float32, device=dev)


class InsertionGenerator:
    """``generate(batch)`` -> (tokens (B, 1, Tmax), scores (B, 1), the encoder dict)."""

    def __init__(self, model, max_iter: int = 10, max_target_positions: int = 128,
                 bos_id: int = 0, pad_id: int = 1, eos_id: int = 2, pad_penalty: float = 0.0):
        self.model = model
        self.max_iter = max_iter
        self.Tmax = max_target_positions
        self.bos, self.pad, self.eos = bos_id, pad_id, eos_id
        self.pad_penalty = pad_penalty

    @torch.inference_mode()
    def generate(self, batch: Dict[str, Any]):
        model, dev = self.model, self.model.device
        src = torch.as_tensor(batch.get("src_tokens", batch.get("features"))).long().to(dev)
        lens = torch.as_tensor(batch.get("src_lengths", batch.get("feat_lengths"))).long().to(dev)
        enc = model.encode(src, lens)
        tokens, scores = insertion_decode(
            model, enc["encoder_out"], model.encoder_valid(enc), self.Tmax, self.max_iter,
            self.bos, self.pad, self.eos, pad_penalty=self.pad_penalty)
        return tokens[:, None, :], scores[:, None], enc


@register_model_architecture("insertion_transformer", "insertion_transformer")
def insertion_transformer(**kw) -> InsertionConfig:
    return InsertionConfig(encoder_normalize_before=False,
                           decoder_normalize_before=False).replace(**kw)
