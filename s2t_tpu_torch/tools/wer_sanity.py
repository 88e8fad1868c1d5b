"""Decode-quality check: overfit 16 synthetic utterances, decode them, score WER
(counterpart of ``bench_wer_sanity``, bench.py:425-494).

    python3 -m s2t_tpu_torch.tools.wer_sanity [--device cpu]

Each utterance carries three tokens as blocks of raised features (token j
fills a third of the frames in its own 6 of the 80 channels) under 0.05
noise.  A 2-layer s2t_transformer (d = 64, V = 16, dropout 0) trains 120
steps of label-smoothing-0 CE + CTC 0.3 (AdamW, lr 5e-3, 10 warm-up steps,
clip 5) on the one batch, then decodes it with beam 2; the WER of the real
tokens (ids > 3) against the three references is printed as one JSON line.
The JAX package reads 0.0.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

import numpy as np

B, T, V = 16, 48, 16
STEPS = 120


def corpus():
    """(batch of numpy arrays, reference token lists), as bench.py makes them."""
    rng = np.random.default_rng(7)
    refs = []
    feats = np.zeros((B, T, 80), np.float32)
    for b in range(B):
        toks = [4 + (b + j) % (V - 4) for j in range(3)]
        refs.append(toks)
        for j, tk in enumerate(toks):
            feats[b, j * (T // 3):(j + 1) * (T // 3), (tk - 4) * 6:(tk - 3) * 6] += 2.0
    feats += rng.normal(scale=0.05, size=feats.shape).astype(np.float32)
    targets = np.full((B, 4), 1, np.int32)
    for b, toks in enumerate(refs):
        targets[b, :3] = toks
        targets[b, 3] = 2
    prev = np.roll(targets, 1, 1)
    prev[:, 0] = 2
    batch = {"features": feats, "feat_lengths": np.full((B,), T, np.int32),
             "prev_tokens": prev, "target": targets, "transcript": targets[:, :-1],
             "transcript_lengths": np.full((B,), 3, np.int32), "ntokens": np.float32(B * 4)}
    return batch, refs


def wer_sanity(device="cuda", seed: int = 0) -> Dict[str, float]:
    from s2t_tpu_torch.config import OptimizationConfig
    from s2t_tpu_torch.criterions.build import build_criterion
    from s2t_tpu_torch.inference.generator import SequenceGenerator
    from s2t_tpu_torch.models.s2t_transformer import S2TTransformerConfig, S2TTransformerModel
    from s2t_tpu_torch.trainer import Trainer
    from s2t_tpu_torch.utils.scoring import edit_distance

    batch, refs = corpus()
    cfg = S2TTransformerConfig(
        encoder_embed_dim=64, encoder_ffn_embed_dim=128, encoder_layers=2,
        encoder_attention_heads=2, decoder_embed_dim=64, decoder_ffn_embed_dim=128,
        decoder_layers=1, decoder_attention_heads=2, vocab_size=V, subsampling_filter=64,
        dropout=0.0, attention_dropout=0.0, activation_dropout=0.0, max_target_positions=32)
    model = S2TTransformerModel(cfg, device=device, seed=seed, for_training=True)
    criterion = build_criterion("label_smoothed_cross_entropy_with_ctc",
                                {"label_smoothing": 0.0, "ctc": {"ctc_weight": 0.3}})
    trainer = Trainer(model, criterion, OptimizationConfig(lr=5e-3, warmup_updates=10,
                                                           clip_norm=5.0),
                      device=device, seed=1)
    losses = [float(trainer.train_step(batch)["loss"]) for _ in range(STEPS)]
    model.eval()
    gen = SequenceGenerator(model, beam_size=2, max_len_b=8, max_target_positions=32)
    hyps = gen.generate(batch)[0][:, 0].cpu().numpy()
    w_err = w_len = 0
    for b in range(B):
        hyp = [int(t) for t in hyps[b] if int(t) > 3]
        w_err += edit_distance(refs[b], hyp)
        w_len += len(refs[b])
    return {"wer_sanity": 100.0 * w_err / w_len, "wer_sanity_utts": B, "steps": STEPS,
            "loss_first_last": [losses[0], losses[-1]]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    print(json.dumps(wer_sanity(ap.parse_args(argv).device)))


if __name__ == "__main__":
    main()
