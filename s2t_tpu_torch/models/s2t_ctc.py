"""Encoder-only CTC model (counterpart of s2t_tpu/models/s2t_ctc.py).

``S2TCTCModel`` is an encoder and its CTC head, with no decoder: one
encoder pass emits the whole hypothesis, which ``inference/ctc_decoder.py``
reads off the CTC logits.  The encoder follows the config's type, as in the
JAX model: the s2t_transformer encoder for an ``S2TTransformerConfig``
(presets ``s2t_ctc`` and ``s2t_nast``: 18 layers, inter-CTC at 6 / 9 / 12 with
the ``inter_league`` PAE, and an XCTC head for translation), the PDS encoder
for a ``PDSConfig`` (``s2t_ctc_pds``), the SATE encoder for a ``SATEConfig``
(``s2t_ctc_sate``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from s2t_tpu_torch.device import resolve_device
from s2t_tpu_torch.models import pds, sate
from s2t_tpu_torch.models.s2t_transformer import (
    S2TTransformerConfig, S2TTransformerEncoder, _check_trainable, check_supported,
    init_and_place, s2t_transformer_s, seeded_init)
from s2t_tpu_torch.registry import register_model, register_model_architecture


def _check_config(cfg, for_training: bool) -> None:
    if isinstance(cfg, pds.PDSConfig):
        pds.check_supported(cfg)
    elif isinstance(cfg, sate.SATEConfig):
        sate.check_supported(cfg, for_training)
    elif isinstance(cfg, S2TTransformerConfig):
        check_supported(cfg)
        if for_training:
            _check_trainable(cfg)
    else:
        raise TypeError(f"S2TCTCModel takes an S2TTransformerConfig, a PDSConfig or a "
                        f"SATEConfig, not a {type(cfg).__name__}")


@register_model("s2t_ctc")
class S2TCTCModel(nn.Module):
    """Encoder-only model; ``forward`` returns the encoder's outputs with
    ``decoder_logits`` None, under the ``Trainer``'s signature.  Built and
    cast as ``S2TTransformerModel`` is: weights from ``seed``, serving (frozen,
    stored in ``cfg.dtype``) or ``for_training`` (float32 masters)."""

    @seeded_init
    def __init__(self, cfg, device="cuda", seed: int = 0, for_training: bool = False):
        super().__init__()
        _check_config(cfg, for_training)
        device = resolve_device(device)
        self.cfg = cfg
        if isinstance(cfg, pds.PDSConfig):
            self.encoder = pds.PDSEncoder(cfg)
        elif isinstance(cfg, sate.SATEConfig):
            self.encoder = sate.S2TSATEEncoder(cfg)
        else:
            # no decoder embedding exists to tie to, so the JAX encoder's CTC head has its
            # own projection whatever share_ctc_and_embed says
            self.encoder = S2TTransformerEncoder(cfg.replace(share_ctc_and_embed=False))
        init_and_place(self, cfg, device, seed, for_training)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def forward(self, features, feat_lengths, prev_tokens=None, train: bool = False,
                generator: Optional[torch.Generator] = None, **encoder_inputs) -> Dict[str, Any]:
        """``prev_tokens`` is unused (the Trainer's signature); ``train=True``
        applies every dropout with bits from ``generator``; ``encoder_inputs``
        (the oracle's targets, ``num_updates``) reach the encoder, None values
        dropped."""
        if train:
            _check_config(self.cfg, True)
            if generator is None:
                raise ValueError("train=True needs the step's torch.Generator")
        else:
            generator = None
        kw = {k: v for k, v in encoder_inputs.items() if v is not None}
        return {"decoder_logits": None,
                **self.encoder(features, feat_lengths, generator=generator, **kw)}

    def encode(self, features, feat_lengths):
        return self.encoder(features, feat_lengths)


@register_model_architecture("s2t_ctc", "s2t_ctc")
def s2t_ctc_base(**kw) -> S2TTransformerConfig:
    return s2t_transformer_s(decoder_layers=0, use_ctc=True).replace(**kw)


@register_model_architecture("s2t_ctc", "s2t_nast")
def s2t_nast(**kw) -> S2TTransformerConfig:
    """NAST: a deep encoder, inter-CTC with the PAE, XCTC for translation
    (s2t_tpu/models/s2t_ctc.py:73-86)."""
    return s2t_transformer_s(
        decoder_layers=0, encoder_layers=18, use_ctc=True, inter_ctc_layers=(6, 9, 12),
        ctc_pae="inter_league", use_xctc=True,
    ).replace(**kw)


@register_model_architecture("s2t_ctc", "s2t_ctc_pds")
def s2t_ctc_pds(**kw) -> pds.PDSConfig:
    """Encoder-only CTC over a PDS encoder (the purectc_pds_* recipes): the
    ``pdss2t_transformer_s_8`` plan with no decoder."""
    kw.setdefault("decoder_layers", 0)
    kw.setdefault("use_ctc", True)
    return pds.pdss2t_transformer_s_8(**kw)


@register_model_architecture("s2t_ctc", "s2t_ctc_sate")
def s2t_ctc_sate(**kw) -> sate.SATEConfig:
    """Encoder-only CTC over the SATE encoder (acoustic transformer or PDS by
    ``acoustic_encoder``): ``s2t_sate_s`` with no decoder."""
    kw.setdefault("acoustic_decoder_layers", 0)
    return sate.s2t_sate_s(**kw)
