"""Training CLI (counterpart of s2t_tpu/cli/train.py:29-389).

Usage:
    python -m s2t_tpu_torch.cli.train DATA_DIR --config conf.yaml \
        [--device cpu] optimization.lr=0.002 arch=s2t_transformer_m

Stacked ``--config`` files merge left to right; trailing ``key.path=value``
pairs override everything.  Training runs on the card unless ``--device cpu``
is given.  Each epoch trains, validates (every scalar log of the criterion),
saves ``checkpoint<epoch>.pt`` / ``checkpoint_last.pt`` / ``checkpoint_best.pt``
and checks patience; ``checkpoint.save_interval_updates`` adds mid-epoch
saves.  A run resumes from ``checkpoint.restore_file`` in ``save_dir`` with
the optimizer and the epoch iterator's state unless they are reset; before
that, ``checkpoint.load_pretrained_encoder_from`` /
``load_pretrained_decoder_from`` transplant a component of another checkpoint
and ``finetune_from_model`` starts from a whole one (no resume then).

Validation can decode as the JAX CLI does: ``eval.eval_ctc_wer`` scores the
greedy CTC transcript of every utterance (``ctc_wer``, ``ctc_cer``; the
batch's features go to ``encode`` as collated, the waveforms of a
``use_audio_input`` split included), and
``eval.eval_wer`` / ``eval_bleu`` score the task's generator (``wer`` or
``bleu``); ``checkpoint.best_checkpoint_metric`` may name any of them.  Under
``reduce_lr_on_plateau`` / ``reduce_on_plateau`` each validation's loss drives
``ReduceOnPlateau`` (``lr_shrink``, ``lr_patience``), whose scale multiplies every
later update and is logged as ``lr_scale`` (s2t_tpu/cli/train.py:293-297, 358-361).
Settings the port does not have raise ``NotImplementedError`` before
anything is built (``config.check_train_supported``).

Under ``torchrun`` (WORLD_SIZE > 1) every process joins the group (NCCL on the
card, each rank on ``cuda:{LOCAL_RANK}``; gloo with ``--device cpu``) and trains
on the mesh that ``distributed.*`` factors (``parallel/mesh.py``), with ``bmuf.*``
as configured; ``distributed.pipeline_parallel`` is copied into the model section
(s2t_tpu/cli/train.py:178-188) and the batches are a multiple of the data ranks.
Every rank collates the same batches; only rank 0 logs and writes checkpoints,
which hold the whole parameters (they load into a one-device run and back).
Decoding validation runs on every rank over a model with the whole parameters (the
replica average under BMUF).
"""

from __future__ import annotations

import argparse
import logging
import math
import time
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

logger = logging.getLogger("s2t_tpu_torch.train")

# batch keys the step does not read
_HOST_KEYS = ("ids", "nsentences", "origin")
# validation logs summed raw and reported as they are, not per sample
_COUNTERS = {"n_correct", "total", "ntokens", "nsentences"}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("data", nargs="?", default=None)
    p.add_argument("--config", action="append", default=[], help="YAML config (repeatable)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("overrides", nargs="*", default=[], help="key.path=value overrides")
    return p.parse_args(argv)


def build_cfg(args):
    from s2t_tpu_torch.config import TrainConfig, apply_overrides, from_dict, load_yaml_stack

    d = apply_overrides(load_yaml_stack(args.config), args.overrides)
    cfg = from_dict(TrainConfig, d)
    if args.data:
        cfg.dataset.data = args.data
    return cfg


def step_batch(batch: Dict[str, Any]) -> Dict[str, Any]:
    """The batch without its host keys, nested ones too (a round-robin zip batch's
    ``{"pairs": {pair: sub-batch}}``)."""
    return {k: step_batch(v) if isinstance(v, dict) else v for k, v in batch.items()
            if k not in _HOST_KEYS}


def _accumulate_ctc_wer(task, model, batch, counts) -> None:
    """Word and character errors of the greedy CTC transcript of ``batch``
    against its transcript (source dictionary) or, without one, its target
    (s2t_tpu/cli/train.py:57-103)."""
    from s2t_tpu_torch.ops.ctc import ctc_greedy_decode
    from s2t_tpu_torch.utils.scoring import edit_distance

    dev = model.device
    with torch.no_grad():
        enc = model.encode(torch.as_tensor(batch["features"], dtype=torch.float32).to(dev),
                           torch.as_tensor(batch["feat_lengths"]).to(dev, torch.long))
    if enc.get("ctc_logits") is None:
        return
    toks = ctc_greedy_decode(enc["ctc_logits"], enc["encoder_lengths"])[0].cpu().numpy()
    if "transcript" in batch:
        key, dic = "transcript", getattr(task, "src_dict", task.tgt_dict)
    else:
        key, dic = "target", task.tgt_dict
    refs = np.asarray(batch[key])
    for b in range(batch["nsentences"]):
        hyp = dic.string(toks[b]).split()
        ref = dic.string(refs[b]).split()
        counts["w_err"] += edit_distance(hyp, ref)
        counts["w_len"] += len(ref)
        counts["c_err"] += edit_distance(list(" ".join(hyp)), list(" ".join(ref)))
        counts["c_len"] += len(" ".join(ref))


def transplant_pretrained(ck, model) -> None:
    """``load_pretrained_encoder_from`` / ``load_pretrained_decoder_from`` copy
    that component of another checkpoint of the port into ``model`` (strictly,
    ``utils.checkpoint.transplant_component``); ``finetune_from_model`` loads a
    whole model and skips the resume (s2t_tpu/cli/train.py:230-254)."""
    from s2t_tpu_torch.utils.checkpoint import load_checkpoint, transplant_component

    for comp, path in (("encoder", ck.load_pretrained_encoder_from),
                       ("decoder", ck.load_pretrained_decoder_from)):
        if path:
            tree, _ = load_checkpoint(path)
            src = tree["params"] if "params" in tree else tree
            model.load_state_dict(transplant_component(model.state_dict(), src, comp),
                                  strict=True)
            logger.info("loaded pretrained %s from %s", comp, path)
    if ck.finetune_from_model:
        tree, _ = load_checkpoint(ck.finetune_from_model)
        model.load_state_dict(tree["params"] if "params" in tree else tree, strict=True)
        logger.info("finetuning from %s", ck.finetune_from_model)


def validate(cfg, task, trainer, valid_ds, generator=None) -> Dict[str, float]:
    """Sample-size-weighted mean of every scalar log over the valid split, and
    with ``eval.eval_ctc_wer`` the greedy CTC ``ctc_wer`` / ``ctc_cer``, with
    ``eval_wer`` or ``eval_bleu`` the ``generator``'s ``wer`` or ``bleu``
    (s2t_tpu/cli/train.py:106-168)."""
    from s2t_tpu_torch.utils.scoring import build_scorer

    itr = task.get_batch_iterator(valid_ds, max_tokens=cfg.dataset.max_tokens,
                                  seed=cfg.common.seed, shuffle=False).next_epoch_itr()
    tot: Dict[str, float] = {}
    n = 0.0
    scorer = None
    if generator is not None and (cfg.eval.eval_wer or cfg.eval.eval_bleu):
        scorer = build_scorer("wer" if cfg.eval.eval_wer else "sacrebleu")
    wer_counts = {"w_err": 0, "w_len": 0, "c_err": 0, "c_len": 0}
    ctc_model = decoding_model(task, trainer, trainer.device) if cfg.eval.eval_ctc_wer else None
    for batch in itr:
        logs = trainer.valid_step(step_batch(batch))
        tot["loss"] = tot.get("loss", 0.0) + float(logs["loss"])
        tot["nll_loss"] = tot.get("nll_loss", 0.0) + float(logs.get("nll_loss", logs["loss"]))
        for k, v in logs.items():
            if k not in ("loss", "nll_loss", "sample_size"):
                tot[k] = tot.get(k, 0.0) + float(v)
        n += float(logs["sample_size"])
        if cfg.eval.eval_ctc_wer:
            _accumulate_ctc_wer(task, ctc_model, batch, wer_counts)
        if scorer is not None:
            hyp_toks = generator.generate(batch)[0][:, 0].cpu().numpy()
            for b in range(batch["nsentences"]):
                scorer.add(task.decode_tokens(np.asarray(batch["target"])[b]),
                           task.decode_tokens(hyp_toks[b]))
    out = {k: (v if k in _COUNTERS else v / max(n, 1.0)) for k, v in tot.items()}
    if "n_correct" in out and out.get("total", 0) > 0:
        out["accuracy"] = out["n_correct"] / out["total"]
    if scorer is not None:
        out["wer" if cfg.eval.eval_wer else "bleu"] = scorer.score()
    if wer_counts["w_len"] > 0:
        out["ctc_wer"] = 100.0 * wer_counts["w_err"] / wer_counts["w_len"]
        out["ctc_cer"] = 100.0 * wer_counts["c_err"] / max(wer_counts["c_len"], 1)
    return out


def decoding_model(task, trainer, device):
    """The model that validation decodes with: the Trainer's own, or under a sharded
    or BMUF Trainer a serving copy with the whole parameters (every rank calls it)."""
    if trainer.sharded is None and trainer.bmuf is None:
        return trainer.model
    params = trainer.state_dict()["params"] if trainer.sharded is not None else \
        {**trainer.model.state_dict(), **trainer.eval_params()}
    model = task.build_model(device=device)
    model.load_state_dict(params, strict=True)
    return model


def main(cfg, task=None, device="cuda") -> Dict[str, Any]:
    """Train as configured.  ``task``: a prebuilt task (for a data config made
    in Python); default ``setup_task(cfg)``.  Returns the validation history,
    the per-step train logs, host-clock timings and the task, model and trainer."""
    from s2t_tpu_torch.config import check_train_supported
    from s2t_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from s2t_tpu_torch.tasks import setup_task
    from s2t_tpu_torch.trainer import Trainer
    from s2t_tpu_torch.utils.checkpoint import CheckpointManager, load_checkpoint
    from s2t_tpu_torch.utils.progress import ProgressLogger

    logging.basicConfig(level=logging.INFO, format="%(asctime)s | %(name)s | %(message)s")
    check_train_supported(cfg)
    init_distributed(device)
    if cfg.distributed.pipeline_parallel > 1:
        # a model-structure choice: the stacked stages (s2t_tpu/cli/train.py:178-188)
        cfg.model = dict(cfg.model or {})
        cfg.model.setdefault("pipeline_parallel", cfg.distributed.pipeline_parallel)
    mesh = make_mesh(cfg.distributed)
    is_main = mesh.rank == 0
    task = task or setup_task(cfg)
    task.device = device
    train_ds = task.load_dataset(cfg.dataset.train_subset, is_train=True)
    valid_ds = task.load_dataset(cfg.dataset.valid_subset)
    model = task.build_model(device=device, for_training=True)
    trainer = Trainer(model, task.build_criterion(), cfg.optimization, device=device,
                      seed=cfg.common.seed, forward_fn=task.forward_fn(), mesh=mesh,
                      dist_cfg=cfg.distributed, bmuf_cfg=cfg.bmuf)
    if mesh.world_size > 1:
        logger.info("mesh: %s | rank %d | bmuf %s", mesh.shape, mesh.rank, cfg.bmuf.active)
    epoch_itr = task.get_batch_iterator(
        train_ds, max_tokens=cfg.dataset.max_tokens, seed=cfg.common.seed,
        shuffle=cfg.dataset.shuffle, buffer_size=cfg.dataset.data_buffer_size,
        batch_size_multiple=mesh.size("data"))
    ck = cfg.checkpoint
    ckpt = CheckpointManager(
        ck.save_dir, keep_last_epochs=ck.keep_last_epochs,
        keep_interval_updates=ck.keep_interval_updates,
        keep_best_checkpoints=ck.keep_best_checkpoints, best_metric=ck.best_checkpoint_metric,
        maximize_best=ck.maximize_best_checkpoint_metric, async_save=ck.async_save)

    transplant_pretrained(ck, model)
    last = Path(ck.save_dir) / (ck.restore_file + ".pt")
    if last.exists() and not ck.finetune_from_model:
        tree, meta = load_checkpoint(last)
        trainer.load_state_dict(tree, params_only=ck.reset_optimizer)
        if not ck.reset_dataloader and "epoch_itr" in meta:
            epoch_itr.load_state_dict(meta["epoch_itr"])
        logger.info("resumed from %s at step %d", last, trainer.step)
    logger.info("arch %s | %s parameters | device %s", cfg.arch,
                f"{sum(p.numel() for p in model.parameters()):,}", trainer.device)

    def build_generator():
        generator = task.build_generator(decoding_model(task, trainer, device))
        # as the JAX CLI does, on whatever build_generator returned: a CTCGenerator never
        # reads beam_size, so a CTC model validates with generation.beam (ROADMAP.md section 3)
        generator.beam_size = cfg.eval.eval_gen_beam
        return generator

    generator = None
    decodes = cfg.eval.eval_wer or cfg.eval.eval_bleu

    progress = ProgressLogger(cfg.common.log_format, cfg.common.tensorboard_logdir,
                              cfg.common.wandb_project, cfg.common.azureml_logging)
    max_epoch = cfg.optimization.max_epoch or math.inf
    max_update = cfg.optimization.max_update or math.inf
    patience_left = cfg.optimization.patience
    best_val = None
    history, train_log = [], []
    plateau = None
    if cfg.optimization.lr_scheduler in ("reduce_on_plateau", "reduce_lr_on_plateau"):
        from s2t_tpu_torch.optim.builders import ReduceOnPlateau

        plateau = ReduceOnPlateau(shrink=cfg.optimization.lr_shrink,
                                  patience=cfg.optimization.lr_patience)
    timing = {"data_s": 0.0, "step_s": 0.0, "valid_s": 0.0, "save_s": 0.0}

    def save(**kw):
        t0 = time.perf_counter()
        state = trainer.state_dict()  # every rank: a sharded Trainer gathers
        if is_main:
            ckpt.save(state, trainer.step, epoch_itr.epoch,
                      extra_meta={"epoch_itr": epoch_itr.state_dict()}, **kw)
        timing["save_s"] += time.perf_counter() - t0

    while epoch_itr.epoch <= max_epoch and trainer.step < max_update:
        itr = iter(epoch_itr.next_epoch_itr())
        t_log = time.time()
        interval: Dict[str, float] = {}
        interval_n = 0
        while True:
            t0 = time.perf_counter()
            batch = next(itr, None)
            t1 = time.perf_counter()
            timing["data_s"] += t1 - t0
            if batch is None:
                break
            metrics = trainer.train_step(step_batch(batch))
            row = {k: float(metrics[k]) for k in ("loss", "gnorm", "lr")}
            timing["step_s"] += time.perf_counter() - t1
            if "origin" in batch:  # a ConcatHomogeneous batch's dataset (semisupervised MT)
                row["origin"] = int(batch["origin"])
            train_log.append({"step": trainer.step, "epoch": epoch_itr.epoch, **row})
            interval_n += 1
            for k in ("loss", "gnorm"):
                interval[k] = interval.get(k, 0.0) + row[k]
            if trainer.step % cfg.common.log_interval == 0 and is_main:
                ups = interval_n / (time.time() - t_log + 1e-9)
                progress.log({"loss": interval["loss"] / interval_n,
                              "gnorm": interval["gnorm"] / interval_n, "lr": row["lr"],
                              "ups": ups}, trainer.step, "train", epoch_itr.epoch)
                interval, interval_n, t_log = {}, 0, time.time()
            if ck.save_interval_updates > 0 and trainer.step % ck.save_interval_updates == 0:
                save(end_of_epoch=False)
            if trainer.step >= max_update:
                break

        t0 = time.perf_counter()
        if decodes and (generator is None or trainer.sharded is not None
                        or trainer.bmuf is not None):
            generator = build_generator()  # a sharded or BMUF run: this epoch's parameters
        val = validate(cfg, task, trainer, valid_ds, generator)
        timing["valid_s"] += time.perf_counter() - t0
        val_metric = val.get(ck.best_checkpoint_metric, val.get("loss"))
        if plateau is not None:
            scale = plateau.step(float(val.get("loss", val_metric)))
            trainer.set_lr_scale(scale)
            val["lr_scale"] = scale
        if is_main:
            progress.log(val, trainer.step, "valid", epoch_itr.epoch)
        history.append({"epoch": epoch_itr.epoch, "step": trainer.step, **val})
        if not ck.no_save:
            save(val_metric=val_metric)
        better = best_val is None or (val_metric > best_val if ck.maximize_best_checkpoint_metric
                                      else val_metric < best_val)
        if better:
            best_val = val_metric
            patience_left = cfg.optimization.patience
        elif cfg.optimization.patience > 0:
            patience_left -= 1
            if patience_left <= 0:
                logger.info("early stop: patience exhausted")
                break
        epoch_itr.next_epoch()

    progress.close()
    return {"history": history, "train_log": train_log, "timing": timing, "task": task,
            "model": model, "trainer": trainer}


def cli_main(argv=None):
    args = parse_args(argv)
    main(build_cfg(args), device=args.device)


if __name__ == "__main__":
    cli_main()
