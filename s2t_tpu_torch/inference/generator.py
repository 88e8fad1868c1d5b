"""SequenceGenerator: encode once, then beam search over the decoder
(counterpart of s2t_tpu/inference/generator.py:29-429, plain single-model beam).

Options of the JAX generator that the port does not have yet (sampling,
constraints, LM fusion, ensembles, joint CTC scoring, lazy reorder, int8 KV,
prefix forcing, diverse search) raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from s2t_tpu_torch.inference.beam_search import beam_search
from s2t_tpu_torch.utils.masking import lengths_to_mask

# option -> value that means "off"; any other value raises
_NOT_PORTED = {
    "infer_ctc_weight": 0.0, "lm_model": None, "lm_weight": 0.0, "sampling": False,
    "sampling_topk": -1, "sampling_topp": -1.0, "sampling_noise": None, "prefix_size": 0,
    "diverse_beam_groups": -1, "diversity_rate": -1.0, "constraints_mode": None,
    "kv_cache_dtype": "model", "lazy_beam_reorder": False, "extra_models": None,
}


def encoder_length_bound(cfg, T: int) -> int:
    """Conservative encoder length of T frames (s2t_tpu/inference/generator.py:397-405):
    a staged encoder (PDS) pads T to its ``pad_multiple`` and divides by its exact
    ``downsample_ratio``; otherwise the subsampling plan."""
    ratio = getattr(cfg, "downsample_ratio", 0)
    if ratio > 1:
        mult = getattr(cfg, "pad_multiple", 1)
        return -(-(-(-T // mult) * mult) // ratio)
    for _ in range(cfg.subsampling_layers):
        T = (T - 1) // cfg.subsampling_stride + 1
    return T


class SequenceGenerator:
    def __init__(
        self,
        model,
        beam_size: int = 5,
        max_len_a: float = 0.0,
        max_len_b: int = 200,
        min_len: int = 1,
        lenpen: float = 1.0,
        temperature: float = 1.0,
        no_repeat_ngram_size: int = 0,
        eos_id: int = 2,
        pad_id: int = 1,
        # banned output index; the reference fork bans index 0 (CTC blank ==
        # <s> in fairseq dicts) in every decode.  -1 allows it.
        blank_id: int = 0,
        max_target_positions: Optional[int] = None,
        static_cross_kv: bool = True,
        **options,
    ):
        for name, value in options.items():
            if name not in _NOT_PORTED:
                raise TypeError(f"SequenceGenerator got an unexpected option {name!r}")
            if value != _NOT_PORTED[name]:
                raise NotImplementedError(
                    f"SequenceGenerator option {name}={value!r} is not ported to s2t_tpu_torch"
                )
        self.model = model
        self.beam_size = beam_size
        self.max_len_a = max_len_a
        self.max_len_b = max_len_b
        self.min_len = min_len
        self.lenpen = lenpen
        self.temperature = temperature
        self.no_repeat_ngram_size = no_repeat_ngram_size
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.blank_id = blank_id
        self.max_target_positions = max_target_positions or model.cfg.max_target_positions
        # beam-shared cross-attention K/V, projected once per sentence
        self.static_cross_kv = static_cross_kv

    def _max_len_for(self, enc_T: int) -> int:
        return int(min(self.max_len_a * enc_T + self.max_len_b, self.max_target_positions - 1))

    def _enc_len_bound(self, T: int) -> int:
        return encoder_length_bound(self.model.cfg, T)

    @torch.inference_mode()
    def generate(self, batch: Dict[str, Any]) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, Any]]:
        """batch: {"features": (B, T, C), "feat_lengths": (B,)} as numpy arrays
        or tensors.  Returns (tokens (B, K, L), scores (B, K), encoder dict)."""
        model = self.model
        dev = model.device
        features = torch.as_tensor(batch["features"], dtype=torch.float32).to(dev)
        feat_lengths = torch.as_tensor(batch["feat_lengths"]).to(device=dev, dtype=torch.long)
        K = self.beam_size
        max_len = self._max_len_for(self._enc_len_bound(features.shape[1]))

        enc = model.encode(features, feat_lengths)
        enc_out = enc["encoder_out"]
        B = enc_out.shape[0]
        enc_mask = lengths_to_mask(enc["encoder_lengths"], enc_out.shape[1])
        enc_out_b = enc_out.repeat_interleave(K, dim=0)
        enc_mask_b = enc_mask.repeat_interleave(K, dim=0)
        cross_kv = model.precompute_cross(enc_out) if self.static_cross_kv else None
        cache = model.init_cache(B * K, max_len)

        def decode_step(tokens, cache, index):
            logits, cache = model.decode_step(
                tokens, cache, index, enc_out_b, enc_mask_b, cross_kv=cross_kv
            )
            logits = logits.float() / self.temperature
            return torch.log_softmax(logits, dim=-1), cache

        tokens, scores = beam_search(
            decode_step, cache,
            batch_size=B, beam_size=K, max_len=max_len,
            eos_id=self.eos_id, pad_id=self.pad_id,
            bos_id=self.eos_id,  # fairseq seeds generation with EOS
            blank_id=self.blank_id, lenpen=self.lenpen, min_len=self.min_len,
            no_repeat_ngram_size=self.no_repeat_ngram_size, device=dev,
        )
        return tokens, scores, enc
