"""Non-autoregressive translation (counterpart of s2t_tpu/tasks/translation_lev.py).

The translation task's data, with the NAT models (``cmlm_transformer`` by default),
``nat_loss`` by default, and the decoder input made from the target in the forward
adapter:

* CMLM / NACRF / vanilla NAT: ``task_cfg.noise`` (``random_mask``, the default,
  masks the k lowest-scoring maskable positions, k = n_maskable x u + 1;
  ``full_mask``; ``no_noise``) with <unk>;
* Levenshtein: the model rolls in from its own random word drop;
* insertion: eos becomes pad, a row keeps each word where u < its rate, and
  ``make_slot_targets`` builds the canvas and the soft slot targets.

Every draw is a uniform from the step's ``torch.Generator`` in training, and from
one seeded with 0 on the model's device in evaluation (JAX uses PRNGKey(0) there),
unless the batch hands draws over (``batch["draws"]``: ``noise_scores`` (B, U),
``noise_fractions`` (B,), ``delete_scores`` (B, U + 1), ``delete_fractions`` (B,),
``keep_rates`` (B, 1), ``keep_uniforms`` (B, U)).  ``build_generator`` gives the
insertion decoder or ``IterativeRefinementGenerator`` with
``generation.iter_decode_max_iter`` rounds over min(max_target_positions, 256)
positions.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from s2t_tpu_torch.ops.levenshtein import uniform
from s2t_tpu_torch.registry import register_task
from s2t_tpu_torch.tasks.translation import TranslationTask


def random_mask(tgt, pad=1, bos=0, eos=2, unk=3, generator=None, draws=None):
    """<unk> over the k lowest-scoring maskable positions, k = n_maskable u + 1."""
    draws = draws or {}
    maskable = (tgt != pad) & (tgt != bos) & (tgt != eos)
    u1 = draws.get("noise_scores")
    u1 = uniform(tgt.shape, generator, tgt.device) if u1 is None else u1
    u2 = draws.get("noise_fractions")
    u2 = uniform(tgt.shape[:1], generator, tgt.device) if u2 is None else u2
    score = torch.where(maskable, u1.float(), 2.0)
    k = maskable.sum(dim=1).float() * u2.float() + 1.0
    rank = torch.argsort(torch.argsort(score, dim=1, stable=True), dim=1, stable=True)
    return torch.where((rank < k[:, None].to(torch.int32)) & maskable, unk, tgt)


def full_mask(tgt, pad=1, bos=0, eos=2, unk=3, generator=None, draws=None):
    return torch.where((tgt != pad) & (tgt != bos) & (tgt != eos), unk, tgt)


def no_noise(tgt, generator=None, draws=None, **ids):
    return tgt


NOISERS = {"random_mask": random_mask, "full_mask": full_mask, "no_noise": no_noise}


@register_task("translation_lev")
class TranslationLevTask(TranslationTask):
    default_arch = "cmlm_transformer"

    def build_criterion(self):
        from s2t_tpu_torch.criterions.build import build_criterion

        return build_criterion(self.cfg.criterion or "nat_loss", self.cfg.criterion_cfg)

    def forward_fn(self):
        from s2t_tpu_torch.models.insertion_transformer import (
            InsertionTransformerModel, make_slot_targets)
        from s2t_tpu_torch.models.levenshtein_transformer import LevenshteinTransformerModel

        task_cfg = self.cfg.task_cfg or {}
        noiser = NOISERS[task_cfg.get("noise", "random_mask")]
        tau = task_cfg.get("insertion_tau", 1.0)
        d = self.tgt_dict
        ids = dict(pad=d.pad(), bos=d.bos(), eos=d.eos(), unk=d.unk())
        vocab = len(d)

        def fwd(model, batch: Dict[str, Any], train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
            draws = batch.get("draws") or {}
            tgt = batch["target"].long()
            src, lens = batch["src_tokens"], batch["src_lengths"]
            gen = generator if train else None
            draw_gen = gen if gen is not None else torch.Generator(
                device=model.device).manual_seed(0)
            if isinstance(model, InsertionTransformerModel):
                core = torch.where(tgt == ids["eos"], ids["pad"], tgt)  # eos frames the canvas
                rate = draws.get("keep_rates")
                rate = uniform((tgt.shape[0], 1), draw_gen, tgt.device) if rate is None else rate
                u = draws.get("keep_uniforms")
                u = uniform(core.shape, draw_gen, tgt.device) if u is None else u
                canvas, soft, valid = make_slot_targets(core, u < rate, ids["pad"], vocab, tau,
                                                        ids["bos"], ids["eos"])
                return model(src, lens, canvas, soft, valid, train=train, generator=gen)
            if isinstance(model, LevenshteinTransformerModel):
                return model(src, lens, None, tgt, train=train, generator=gen, draws=draws,
                             draw_generator=draw_gen)
            prev = noiser(tgt, generator=draw_gen, draws=draws, **ids)
            return model(src, lens, prev, tgt, train=train, generator=gen)

        return fwd

    def build_generator(self, model, gen_cfg=None):
        from s2t_tpu_torch.inference.iterative_refinement import IterativeRefinementGenerator
        from s2t_tpu_torch.models.insertion_transformer import (
            InsertionGenerator, InsertionTransformerModel)

        g = gen_cfg or self.cfg.generation
        d = self.tgt_dict
        Tmax = min(self.cfg.dataset.max_target_positions, 256)
        if isinstance(model, InsertionTransformerModel):
            return InsertionGenerator(model, max_iter=max(g.iter_decode_max_iter, 1),
                                      max_target_positions=Tmax, bos_id=d.bos(), pad_id=d.pad(),
                                      eos_id=d.eos(), pad_penalty=g.iter_decode_eos_penalty)
        return IterativeRefinementGenerator(model, max_iter=max(g.iter_decode_max_iter, 1),
                                            max_target_positions=Tmax, bos_id=d.bos(),
                                            pad_id=d.pad(), eos_id=d.eos(), unk_id=d.unk())
