"""Generation CLI with fairseq-format output files
(counterpart of s2t_tpu/cli/generate.py:28-190).

Usage:
    python -m s2t_tpu_torch.cli.generate DATA_DIR --path ckpt.pt \
        [--avg-best N --save-dir DIR] [--config conf.yaml] [--device cpu] \
        generation.beam=5 dataset.gen_subset=test

Decodes ``dataset.gen_subset`` with the task's generator (the beam of
``SequenceGenerator``, over a speech split's features or a translation split's
source tokens, or CTC greedy / prefix-beam decoding of ``CTCGenerator`` for an
encoder-only model; a ``use_audio_input`` split's waveforms go to the encoder as
collated) and writes ``generate-<subset>.txt``
(T-/H-/D- lines and the score line) and ``translation-<subset>.txt`` to
``generation.results_path`` (default ``checkpoint.save_dir``);
``generation.ctc_infer`` adds ``translation-<subset>.txt.ctc``, the greedy CTC
transcript of each utterance from the encoder output the generator returns.  A task
with an ``eval_lang_pair`` (the multilingual Transformer's) decodes that pair's split.
Decoding runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

logger = logging.getLogger("s2t_tpu_torch.generate")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("data", nargs="?", default=None)
    p.add_argument("--path", default=None, help="checkpoint path")
    p.add_argument("--avg-best", type=int, default=0,
                   help="average the N best checkpoints from --save-dir")
    p.add_argument("--save-dir", default=None)
    p.add_argument("--config", action="append", default=[])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("overrides", nargs="*", default=[])
    return p.parse_args(argv)


def load_params(args, cfg) -> Dict[str, torch.Tensor]:
    """The parameters of ``--path``, or the average of the ``--avg-best`` best
    checkpoints of ``--save-dir``."""
    from s2t_tpu_torch.utils.checkpoint import (
        CheckpointManager, average_checkpoints, load_checkpoint)

    if args.avg_best and args.save_dir:
        mgr = CheckpointManager(args.save_dir, best_metric=cfg.checkpoint.best_checkpoint_metric,
                                maximize_best=cfg.checkpoint.maximize_best_checkpoint_metric)
        paths = mgr.best_checkpoints(args.avg_best)
        logger.info("averaging %d checkpoints", len(paths))
        return average_checkpoints(paths)
    tree, _ = load_checkpoint(args.path)
    return tree["params"] if "params" in tree else tree


def main(cfg, params, task=None, device="cuda") -> Dict[str, Any]:
    """Decode ``gen_subset`` with ``params`` (a state dict) and score it."""
    from s2t_tpu_torch.ops.ctc import ctc_greedy_decode
    from s2t_tpu_torch.tasks import setup_task
    from s2t_tpu_torch.utils.scoring import build_scorer

    logging.basicConfig(level=logging.INFO, format="%(asctime)s | %(name)s | %(message)s")
    task = task or setup_task(cfg)
    subset = cfg.dataset.gen_subset
    eval_pair = getattr(task, "eval_lang_pair", None)
    # a multilingual Transformer decodes one pair; training and validation zip them all
    ds = task.load_pair_dataset(subset, eval_pair) if eval_pair else task.load_dataset(subset)
    model = task.build_model(device=device)
    model.load_state_dict(params, strict=True)
    generator = task.build_generator(model)
    itr = task.get_batch_iterator(ds, max_tokens=cfg.dataset.max_tokens,
                                  shuffle=False).next_epoch_itr()

    results: Dict[int, Dict[str, Any]] = {}
    n_utts, gen_time, total_frames = 0, 0.0, 0
    for batch in itr:
        t0 = time.time()
        tokens, scores, enc = generator.generate(batch)
        tokens, scores = tokens.cpu().numpy(), scores.float().cpu().numpy()
        gen_time += time.time() - t0
        ctc_hyps = None
        if cfg.generation.ctc_infer and enc.get("ctc_logits") is not None:
            ctc_hyps = ctc_greedy_decode(enc["ctc_logits"], enc["encoder_lengths"])[0].cpu().numpy()
        B_real = batch["nsentences"]
        n_utts += B_real
        len_key = "feat_lengths" if "feat_lengths" in batch else "src_lengths"
        total_frames += int(np.asarray(batch[len_key])[:B_real].sum())
        for b in range(B_real):
            sid = int(batch["ids"][b])
            hyp_tok = tokens[b, 0]
            entry = {"hyp_tokens": task.tgt_dict.string(hyp_tok),
                     "hyp": task.decode_tokens(hyp_tok), "score": float(scores[b, 0])}
            if "target" in batch:
                tgt = np.asarray(batch["target"])[b]
                entry["ref_tokens"] = task.tgt_dict.string(tgt)
                entry["ref"] = task.decode_tokens(tgt)
            if ctc_hyps is not None:
                entry["ctc"] = getattr(task, "src_dict", task.tgt_dict).string(
                    ctc_hyps[b], bpe_symbol=cfg.generation.post_process)
            results[sid] = entry

    scorer = build_scorer(cfg.generation.scoring)
    for sid in sorted(results):
        if "ref" in results[sid]:
            scorer.add(results[sid]["ref"], results[sid]["hyp"])
    score_str = (scorer.result_string()
                 if results and "ref" in next(iter(results.values())) else "")

    out_dir = Path(cfg.generation.results_path or cfg.checkpoint.save_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / f"generate-{subset}.txt", "w") as f, \
            open(out_dir / f"translation-{subset}.txt", "w") as ft:
        for sid in sorted(results):
            r = results[sid]
            if "ref_tokens" in r:
                f.write(f"T-{sid}\t{r['ref_tokens']}\n")
            f.write(f"H-{sid}\t{r['score']:.4f}\t{r['hyp_tokens']}\n")
            f.write(f"D-{sid}\t{r['score']:.4f}\t{r['hyp']}\n")
            ft.write(r["hyp"] + "\n")
        if score_str:
            f.write(f"Generate {subset} with beam={cfg.generation.beam}: {score_str}\n")
    if any("ctc" in r for r in results.values()):
        with open(out_dir / f"translation-{subset}.txt.ctc", "w") as f:
            for sid in sorted(results):
                f.write(results[sid].get("ctc", "") + "\n")

    # RTF: audio seconds over wall seconds (10 ms frames, or with use_audio_input the
    # collated 16 kHz sample counts)
    data_cfg = getattr(task, "data_cfg", None)
    if getattr(data_cfg, "use_audio_input", False):
        audio_s = total_frames / float(getattr(data_cfg, "sample_rate", 16000))
    else:
        audio_s = total_frames * 0.01
    rtf = audio_s / gen_time if gen_time > 0 else 0.0
    logger.info("decoded %d utterances in %.1fs (%.2f utt/s, RTF %.1fx) | %s",
                n_utts, gen_time, n_utts / max(gen_time, 1e-9), rtf, score_str)
    return {"results": results, "score_str": score_str, "scorer": scorer, "n_utts": n_utts,
            "gen_time": gen_time, "rtf": rtf, "utts_per_sec": n_utts / max(gen_time, 1e-9),
            "out_dir": out_dir}


def cli_main(argv=None):
    from s2t_tpu_torch.cli.train import build_cfg

    args = parse_args(argv)
    cfg = build_cfg(args)
    main(cfg, load_params(args, cfg), device=args.device)


if __name__ == "__main__":
    cli_main()
