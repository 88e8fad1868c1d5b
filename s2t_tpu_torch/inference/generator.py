"""SequenceGenerator: encode once, then search over the decoder
(counterpart of s2t_tpu/inference/generator.py:29-429), with every option of
the JAX generator:

- the beam (``inference/beam_search.py``): n-gram blocking, joint CTC/attention
  scoring (``infer_ctc_weight``: the encoder's XCTC logits when it has them,
  else its CTC logits, through ``inference/ctc_prefix.py``), prefix forcing
  (``prefix_size``: the first tokens of ``batch["target"]``), diverse beam
  groups and diverse siblings;
- sampling (``inference/sampling.py``), top-k / top-p, from a
  ``torch.Generator`` seeded by ``sampling_seed`` or from ``sampling_noise``;
- lexical constraints (``inference/constrained.py``) from ``batch["constraints"]``;
- ensembles (``extra_models``, averaged in probability space), shallow fusion
  with a Transformer LM (``lm_model``, ``lm_weight``), the int8 KV cache
  (``kv_cache_dtype="int8"``) and the lazy beam reorder.

Models and the LM are ``nn.Module``s that carry their weights, so
``generate`` takes only the batch.
"""

from __future__ import annotations

import logging
import math
from typing import Any, Dict, Optional, Tuple

import torch

from s2t_tpu_torch.inference.beam_search import beam_search
from s2t_tpu_torch.inference.constrained import constrained_beam_search
from s2t_tpu_torch.inference.ctc_prefix import CTCPrefixScorer
from s2t_tpu_torch.inference.sampling import sampling_decode
from s2t_tpu_torch.utils.masking import lengths_to_mask

logger = logging.getLogger("s2t_tpu_torch.generator")


def encoder_length_bound(cfg, T: int) -> int:
    """Conservative encoder length of T frames (s2t_tpu/inference/generator.py:397-405):
    a staged encoder (PDS) pads T to its ``pad_multiple`` and divides by its exact
    ``downsample_ratio``; otherwise the subsampling plan."""
    ratio = getattr(cfg, "downsample_ratio", 0)
    if ratio > 1:
        mult = getattr(cfg, "pad_multiple", 1)
        return -(-(-(-T // mult) * mult) // ratio)
    # a config without a subsampling plan (a wav2vec 2.0 front end over samples)
    # takes JAX's getattr defaults, 2 layers of stride 2
    for _ in range(getattr(cfg, "subsampling_layers", 2)):
        T = (T - 1) // getattr(cfg, "subsampling_stride", 2) + 1
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
        input_keys: Tuple[str, str] = ("features", "feat_lengths"),
        infer_ctc_weight: float = 0.0,
        ctc_prune_k: int = 8,
        lm_model=None,
        # a state dict to load into ``lm_model`` (the LM otherwise carries its weights)
        lm_params=None,
        lm_weight: float = 0.0,
        sampling: bool = False,
        sampling_topk: int = -1,
        sampling_topp: float = -1.0,
        sampling_seed: int = 0,
        # optional (max_len, B*K) uniforms in place of the generator's draws
        sampling_noise=None,
        prefix_size: int = 0,
        diverse_beam_groups: int = -1,
        diverse_beam_strength: float = 0.5,
        diversity_rate: float = -1.0,
        constraints_mode: Optional[str] = None,
        # beam-shared cross-attention K/V, projected once per sentence
        static_cross_kv: bool = True,
        kv_cache_dtype: str = "model",  # the model's dtype | "int8"
        # keep the KV cache in place and select each beam's ancestor slots in attention
        lazy_beam_reorder: bool = False,
        extra_models: Optional[list] = None,
    ):
        if diverse_beam_groups > 1 and beam_size % diverse_beam_groups != 0:
            raise ValueError(f"beam_size ({beam_size}) must be divisible by "
                             f"diverse_beam_groups ({diverse_beam_groups})")
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
        self.input_keys = input_keys
        self.infer_ctc_weight = infer_ctc_weight
        self.ctc_prune_k = ctc_prune_k
        if lm_model is not None and lm_params is not None:
            lm_model.load_state_dict(lm_params)
        self.lm_model = lm_model
        self.lm_weight = lm_weight
        self.sampling = sampling
        self.sampling_topk = sampling_topk
        self.sampling_topp = sampling_topp
        self.sampling_seed = sampling_seed
        self.sampling_noise = sampling_noise
        self.prefix_size = prefix_size
        self.diverse_beam_groups = diverse_beam_groups
        self.diverse_beam_strength = diverse_beam_strength
        self.diversity_rate = diversity_rate
        self.constraints_mode = constraints_mode
        self.static_cross_kv = static_cross_kv
        self.kv_int8 = kv_cache_dtype == "int8"
        self.lazy_beam_reorder = lazy_beam_reorder
        self.extra_models = list(extra_models or [])

    def _max_len_for(self, enc_T: int) -> int:
        return int(min(self.max_len_a * enc_T + self.max_len_b, self.max_target_positions - 1))

    def _enc_len_bound(self, T: int) -> int:
        return encoder_length_bound(self.model.cfg, T)

    def _ctc_scorer(self, enc, K: int) -> Optional[CTCPrefixScorer]:
        """The joint-CTC prefix scorer over the encoder's XCTC logits (its CTC
        logits without an XCTC head), or None."""
        if self.infer_ctc_weight <= 0:
            return None
        logits = enc.get("xctc_logits")
        if logits is None:
            logits = enc.get("ctc_logits")
        if logits is None:
            return None
        # the lattice blank is index 0 whether or not the generator bans it as an output
        return CTCPrefixScorer(torch.log_softmax(logits.float(), dim=-1), enc["encoder_lengths"],
                               beam_size=K, blank_id=self.blank_id if self.blank_id >= 0 else 0,
                               eos_id=self.eos_id)

    @torch.inference_mode()
    def generate(self, batch: Dict[str, Any]) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, Any]]:
        """batch: the ``input_keys`` (features (B, T, C) or a text model's source
        tokens (B, S), lengths (B,)) as numpy arrays or tensors; ``target`` (B, U)
        with ``prefix_size`` > 0; ``constraints`` (B, C, Lc) with ``constraints_mode``.
        Returns (tokens (B, K, L), scores (B, K), the encoder dict)."""
        model = self.model
        if not hasattr(model, "init_cache"):
            # the dual and multibranch models: JAX's generator fails on init_cache too
            raise AttributeError(f"{type(model).__name__} has no incremental decoder "
                                 "(init_cache / decode_step) for the beam generator")
        dev = model.device
        features = torch.as_tensor(batch[self.input_keys[0]])
        # features decode in float32; a text model's source tokens stay integers
        features = (features.float() if features.is_floating_point() else features.long()).to(dev)
        feat_lengths = torch.as_tensor(batch[self.input_keys[1]]).to(device=dev, dtype=torch.long)
        K = self.beam_size
        max_len = self._max_len_for(self._enc_len_bound(features.shape[1]))

        enc = model.encode(features, feat_lengths)
        B = enc["encoder_out"].shape[0]

        def context(e):
            mask = lengths_to_mask(e["encoder_lengths"], e["encoder_out"].shape[1])
            return e["encoder_out"].repeat_interleave(K, dim=0), mask.repeat_interleave(K, dim=0)

        enc_out_b, enc_mask_b = context(enc)
        cross_kv = (model.precompute_cross(enc["encoder_out"])
                    if self.static_cross_kv and hasattr(model, "precompute_cross") else None)
        kv_int8 = self.kv_int8 and getattr(model, "kv_int8_cache", False)
        if self.kv_int8 and not kv_int8:
            logger.warning("%s has no int8 cache mode; decoding at full precision",
                           type(model).__name__)
        cache = {"dec": model.init_cache(B * K, max_len, kv_int8=kv_int8)}
        use_lm = self.lm_model is not None and self.lm_weight != 0.0
        if use_lm:
            cache["lm"] = self.lm_model.init_cache(B * K, max_len)
        # ensemble members keep their own encoder output and cache
        extra_ctx = []
        for mi, em in enumerate(self.extra_models):
            extra_ctx.append(context(em.encode(features, feat_lengths)))
            cache[f"m{mi}"] = em.init_cache(B * K, max_len)

        def decode_step(tokens, cache, index, ancestry=None):
            kw = {} if ancestry is None else {"ancestry": ancestry}
            logits, _ = model.decode_step(tokens, cache["dec"], index, enc_out_b, enc_mask_b,
                                          cross_kv=cross_kv, **kw)
            lprobs = torch.log_softmax(logits.float() / self.temperature, dim=-1)
            if extra_ctx:
                # average in probability space
                all_lp = [lprobs]
                for mi, (em, (eo, emask)) in enumerate(zip(self.extra_models, extra_ctx)):
                    lg, _ = em.decode_step(tokens, cache[f"m{mi}"], index, eo, emask)
                    all_lp.append(torch.log_softmax(lg.float() / self.temperature, dim=-1))
                lprobs = torch.logsumexp(torch.stack(all_lp), dim=0) - math.log(len(all_lp))
            if use_lm:
                # the LM's logits are not tempered
                lm_logits, _ = self.lm_model.decode_step(tokens, cache["lm"], index)
                lprobs = lprobs + self.lm_weight * torch.log_softmax(lm_logits.float(), dim=-1)
            return lprobs, cache

        common = dict(eos_id=self.eos_id, pad_id=self.pad_id,
                      bos_id=self.eos_id,  # fairseq seeds generation with EOS
                      blank_id=self.blank_id, min_len=self.min_len, device=dev)
        if self.sampling:
            gen = torch.Generator(device=dev).manual_seed(self.sampling_seed)
            tokens, scores = sampling_decode(
                decode_step, cache, gen, batch_size=B, num_samples=K, max_len=max_len,
                temperature=1.0,  # decode_step already applies the temperature
                topk=self.sampling_topk, topp=self.sampling_topp,
                noise_uniforms=self.sampling_noise, **common)
            return tokens, scores, enc
        if self.constraints_mode and "constraints" in batch:
            tokens, scores = constrained_beam_search(
                decode_step, cache, torch.as_tensor(batch["constraints"]), batch_size=B,
                beam_size=K, max_len=max_len, lenpen=self.lenpen,
                ordered=self.constraints_mode == "ordered", **common)
            return tokens, scores, enc

        prefix = None
        if self.prefix_size > 0 and "target" in batch:
            prefix = torch.as_tensor(batch["target"]).to(dev)[:, :self.prefix_size].long()
        step_fn, reorder_fn = decode_step, None
        if (self.lazy_beam_reorder and not (use_lm or extra_ctx) and not kv_int8 and K > 1
                and getattr(model, "lazy_reorder", False)):
            # the KV cache stays in place; a (B, K, L) map holds each beam's ancestor slots
            anc = torch.zeros((B, K, max_len), dtype=torch.long, device=dev)

            def step_fn(tokens, cache, index):
                return decode_step(tokens, cache, index, ancestry=anc)

            def reorder_fn(cache, parent, i):
                anc.copy_(anc.gather(1, parent[:, :, None].expand(B, K, max_len)))
                anc[:, :, i] = parent
                return cache

        G = self.diverse_beam_groups
        tokens, scores = beam_search(
            step_fn, cache, batch_size=B, beam_size=K, max_len=max_len, lenpen=self.lenpen,
            no_repeat_ngram_size=self.no_repeat_ngram_size,
            ctc_scorer=self._ctc_scorer(enc, K), ctc_weight=self.infer_ctc_weight,
            ctc_prune_k=self.ctc_prune_k, prefix_tokens=prefix,
            diverse_groups=G if G > 1 else 1, diverse_strength=self.diverse_beam_strength,
            diverse_siblings_gamma=max(self.diversity_rate, 0.0), reorder_fn=reorder_fn,
            **common)
        return tokens, scores, enc
