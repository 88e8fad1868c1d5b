"""CTC decoding for encoder-only models: greedy and prefix beam search
(counterpart of s2t_tpu/inference/ctc_decoder.py).

Plain tensor ops on the model's device, as the JAX package leaves them to
XLA: the greedy decode has no host sync, the prefix beam one Python step a
frame over static (B, K, T) buffers.  ``CTCGenerator`` keeps the
``SequenceGenerator`` interface (``generate(batch)`` -> tokens, scores, the
encoder dict), with ``use_xctc`` decodes the XCTC head's logits (NAST
translation), and with an ``ngram_lm`` (``data/ngram_lm.py``) re-ranks the
beam's n-best on the host.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from s2t_tpu_torch.data.ngram_lm import rescore_nbest
from s2t_tpu_torch.inference.beam_search import stable_topk
from s2t_tpu_torch.ops.ctc import ctc_greedy_decode

NEG = -1e30


class CTCDecoder:
    """Decode from the encoder's CTC logits (s2t_tpu/inference/ctc_decoder.py:19-76).

    ``self_ensemble`` averages the log-probs of the inter-CTC logits with the
    final ones; ``intermediate_logit`` = k decodes the k-th inter-CTC logits.
    Both read the encoder's ``inter_ctc_logits``: without taps they do
    nothing, as in the JAX package."""

    def __init__(self, blank_id: int = 0, pad_id: int = 1, beam_size: int = 1,
                 self_ensemble: bool = False, intermediate_logit: int = 0):
        self.blank_id = blank_id
        self.pad_id = pad_id
        self.beam_size = beam_size
        self.self_ensemble = self_ensemble
        self.intermediate_logit = intermediate_logit

    def select_logits(self, encoder_out: Dict[str, Any]) -> torch.Tensor:
        """The log-probs to decode, in float32."""
        logits = encoder_out["ctc_logits"]
        inter = encoder_out.get("inter_ctc_logits") or ()
        if self.intermediate_logit > 0 and len(inter) >= self.intermediate_logit:
            logits = inter[self.intermediate_logit - 1][1]
        lp = torch.log_softmax(logits.float(), dim=-1)
        if self.self_ensemble and len(inter) > 0:
            # PDS stage taps at coarser time scales cannot be averaged on the final scale
            lps = [lp] + [torch.log_softmax(tap[1].float(), dim=-1) for tap in inter
                          if tap[1].shape[1] == logits.shape[1]
                          and tap[1].shape[-1] == logits.shape[-1]]
            return sum(lps) / len(lps)
        return lp

    def decode_greedy(self, encoder_out: Dict[str, Any]) -> Tuple[torch.Tensor, torch.Tensor]:
        return ctc_greedy_decode(self.select_logits(encoder_out), encoder_out["encoder_lengths"],
                                 self.blank_id, self.pad_id)

    def decode(self, encoder_out: Dict[str, Any]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Greedy: (tokens (B, T), lengths (B,)); beam: (tokens (B, K, T), scores (B, K))."""
        if self.beam_size <= 1:
            return self.decode_greedy(encoder_out)
        return ctc_prefix_beam_decode(self.select_logits(encoder_out),
                                      encoder_out["encoder_lengths"], beam_size=self.beam_size,
                                      blank_id=self.blank_id, pad_id=self.pad_id)


class CTCGenerator:
    """One encoder pass, then CTC greedy or prefix-beam decoding
    (s2t_tpu/inference/ctc_decoder.py:79-137); ``use_xctc`` decodes the XCTC
    logits in place of the CTC ones when the encoder emits them.  With an
    ``ngram_lm`` and its ``dictionary``, the beam's n-best is re-ranked by
    score + lm_weight ln p_LM(words) (greedy output is not)."""

    def __init__(self, model, decoder: CTCDecoder, use_xctc: bool = False, ngram_lm=None,
                 lm_weight: float = 0.5, dictionary=None):
        self.model = model
        self.decoder = decoder
        self.use_xctc = use_xctc
        self.ngram_lm = ngram_lm
        self.lm_weight = lm_weight
        self.dictionary = dictionary

    @torch.inference_mode()
    def generate(self, batch: Dict[str, Any]) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, Any]]:
        """batch: "features" and "feat_lengths" (numpy arrays or tensors).  Greedy
        returns (tokens (B, 1, T), zero scores (B, 1), encoder dict), the beam
        (tokens (B, K, T), scores (B, K), encoder dict); tokens are padded with pad_id."""
        dev = self.model.device
        feats = torch.as_tensor(batch["features"], dtype=torch.float32).to(dev)
        lengths = torch.as_tensor(batch["feat_lengths"]).to(device=dev, dtype=torch.long)
        enc = self.model.encode(feats, lengths)
        if self.use_xctc and enc.get("xctc_logits") is not None:
            enc = {**enc, "ctc_logits": enc["xctc_logits"]}
        tokens, second = self.decoder.decode(enc)
        if tokens.dim() == 2:
            return tokens[:, None, :], torch.zeros((tokens.shape[0], 1), device=dev), enc
        if self.ngram_lm is not None and self.dictionary is not None:
            tokens, second = rescore_nbest(tokens.cpu().numpy(), second.cpu().numpy(),
                                           self.dictionary, self.ngram_lm, self.lm_weight,
                                           pad_id=self.decoder.pad_id)
            return torch.from_numpy(tokens).to(dev), torch.from_numpy(second).to(dev), enc
        return tokens, second, enc


def ctc_prefix_beam_decode(log_probs: torch.Tensor, lengths: torch.Tensor, beam_size: int = 5,
                           blank_id: int = 0, pad_id: int = 1, prune_k: int = 16
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched CTC prefix beam search (s2t_tpu/inference/ctc_decoder.py:140-294),
    step for step: dense (B, K, T) prefix buffers with per-hypothesis blank and
    non-blank log-probs; each frame expands the K prefixes by the frame's
    ``prune_k`` best tokens, folds an extension equal to an existing prefix
    into it (the K x K prefix match), and keeps the top K.  Every top-k breaks
    ties to the lower index, as ``jax.lax.top_k`` does.

    log_probs (B, T, V) float32; lengths (B,).  Returns (tokens (B, K, T)
    padded with pad_id, scores (B, K)), best first."""
    B, T, V = log_probs.shape
    K, k = beam_size, min(prune_k, V)
    dev = log_probs.device
    lengths = lengths.to(dev)
    prefixes = torch.full((B, K, T), pad_id, dtype=torch.int32, device=dev)
    plen = torch.zeros((B, K), dtype=torch.long, device=dev)
    p_b = torch.full((B, K), NEG, device=dev)
    p_b[:, 0] = 0.0
    p_nb = torch.full((B, K), NEG, device=dev)
    pos = torch.arange(T, device=dev)

    for t in range(T):
        lp_t = log_probs[:, t]
        top_lp, top_tok = stable_topk(lp_t, k)  # (B, k)
        lp_blank = lp_t[:, blank_id]
        p_tot = torch.logaddexp(p_b, p_nb)
        cand0_pb = p_tot + lp_blank[:, None]

        last = prefixes.gather(2, (plen - 1).clamp(min=0)[..., None])[..., 0]
        last = torch.where(plen > 0, last, -1)
        tok, lp_e = top_tok[:, None, :], top_lp[:, None, :]
        same_as_last = tok == last[..., None]  # (B, K, k)
        is_blank_tok = tok == blank_id
        # a repeat extends only the blank-ending mass; the non-blank mass stays on the prefix
        extend_mass = torch.where(same_as_last, p_b[..., None], p_tot[..., None])
        cand_ext_pnb = torch.where(is_blank_tok, NEG, extend_mass + lp_e)
        stay_pnb = torch.where(same_as_last, p_nb[..., None] + lp_e, NEG)
        cand0_pnb = torch.logsumexp(torch.where(is_blank_tok, NEG, stay_pnb), dim=2)

        active = (t < lengths)[:, None]  # (B, 1)

        # merge[a, b]: prefix b is prefix a plus one token
        cmp_mask = pos[None, None, None, :] < plen[:, :, None, None]
        eq = ((prefixes[:, :, None, :] == prefixes[:, None, :, :]) | ~cmp_mask).all(dim=-1)
        merge_ab = eq & (plen[:, None, :] == plen[:, :, None] + 1)
        # nt[a, b]: prefix b's token at position plen_a (its last token)
        at = plen.clamp(max=T - 1)[:, None, :].expand(B, K, K)
        nt = prefixes.gather(2, at).transpose(1, 2)
        target = (merge_ab[..., None] & (nt[..., None] == top_tok[:, None, None, :])
                  & active[:, :, None, None])  # (B, Ka, Kb, k)
        add_mass = torch.logsumexp(
            torch.where(target, cand_ext_pnb[:, :, None, :], NEG), dim=(1, 3))  # (B, Kb)
        cand0_pnb = torch.logaddexp(cand0_pnb, add_mass)
        cand_ext_pnb = torch.where(target.any(dim=2), NEG, cand_ext_pnb)

        # the pool: K "stay" + K k "extend"; past the length every hypothesis stays
        all_scores = torch.cat([torch.logaddexp(cand0_pb, cand0_pnb),
                                cand_ext_pnb.reshape(B, K * k)], dim=1)
        keep_scores = torch.cat([p_tot, torch.full((B, K * k), NEG, device=dev)], dim=1)
        all_scores = torch.where(active, all_scores, keep_scores)

        _, sel = stable_topk(all_scores, K)  # (B, K)
        is_stay = sel < K
        parent = torch.where(is_stay, sel, (sel - K) // k)
        new_tok = top_tok.gather(1, torch.where(is_stay, 0, (sel - K) % k))

        new_prefixes = prefixes.gather(1, parent[..., None].expand(B, K, T))
        new_plen = plen.gather(1, parent)
        # the extension token goes to position new_plen (< T: a frame adds at most one
        # token); a stay writes back the token that is there, so nothing syncs the host
        at = new_plen.clamp(max=T - 1)[..., None]
        keep = new_prefixes.gather(2, at)[..., 0]
        new_prefixes.scatter_(2, at, torch.where(is_stay, keep, new_tok.to(torch.int32))[..., None])
        new_plen = torch.where(is_stay, new_plen, new_plen + 1)

        sel_pb = torch.where(is_stay, torch.where(active, cand0_pb, p_b).gather(1, parent), NEG)
        stay_pnb_sel = torch.where(active, cand0_pnb, p_nb).gather(1, parent)
        ext_pnb_sel = cand_ext_pnb.reshape(B, K * k).gather(1, (sel - K).clamp(0, K * k - 1))
        prefixes, plen = new_prefixes, new_plen
        p_b, p_nb = sel_pb, torch.where(is_stay, stay_pnb_sel, ext_pnb_sel)

    scores = torch.logaddexp(p_b, p_nb)
    order = torch.argsort(-scores, dim=1, stable=True)
    scores = scores.gather(1, order)
    prefixes = prefixes.gather(1, order[..., None].expand(B, K, T))
    plen = plen.gather(1, order)
    prefixes = torch.where(pos[None, None, :] < plen[..., None], prefixes, pad_id)
    return prefixes, scores
