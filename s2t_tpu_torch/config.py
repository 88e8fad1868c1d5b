"""Typed configuration tree with stacked-YAML merging and CLI overrides
(counterpart of s2t_tpu/config.py).

Plain dataclasses with the JAX names and defaults; YAML files merge left to
right (later files win), then ``key.path=value`` overrides apply, then the
result is materialised into the dataclass tree with type coercion.  Unknown
keys raise.  ``yaml`` is imported inside the functions that read YAML, so
the tree can be built from Python (``from_dict``) where PyYAML is absent.

A non-default value of a setting the port does not have raises
``NotImplementedError`` naming it (``check_supported`` for the optimisation
section, ``check_train_supported`` for the rest).  Settings no branch reads (``stop_min_lr``,
``fp16_init_scale``) are kept for config compatibility.
"""

from __future__ import annotations

import dataclasses
import typing
from dataclasses import dataclass, field, fields, is_dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

PORTED_OPTIMIZERS = ("adam", "adamw", "adafactor", "adagrad", "sgd", "nag", "adadelta",
                     "adamax", "lamb")
PORTED_SCHEDULERS = ("inverse_sqrt", "tri_stage", "polynomial_decay", "cosine", "fixed",
                     "reduce_lr_on_plateau", "reduce_on_plateau", "pass_through", "manual",
                     "triangular")
# the JAX rng_impl knob picks a PRNG implementation: jax.random.key takes any
# registered impl name, and "threefry" or an empty name mean PRNGKey
# (s2t_tpu/trainer.py:144-150).  The port's bits come from torch.Generators seeded
# per step, whichever of these is named, so it takes every one of them.
RNG_IMPLS = ("rbg", "unsafe_rbg", "threefry", "threefry2x32", "")


# --------------------------------------------------------------------------- #
# dict utilities
# --------------------------------------------------------------------------- #


def deep_merge(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    """Recursively merge ``override`` into ``base`` (override wins)."""
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_yaml_stack(paths: List[str | Path]) -> Dict[str, Any]:
    """Load and merge a stack of YAML files, later files winning."""
    merged: Dict[str, Any] = {}
    if not paths:
        return merged
    import yaml

    for p in paths:
        with open(p) as f:
            d = yaml.safe_load(f) or {}
        if not isinstance(d, dict):
            raise ValueError(f"config file {p} must contain a mapping")
        merged = deep_merge(merged, d)
    return merged


def _coerce_scalar(text: str) -> Any:
    """Parse a CLI override value with YAML semantics ('true' -> True, etc.);
    numbers first, so ``lr=5e-3`` is a float (YAML 1.1 would keep a string)."""
    t = text.strip()
    try:
        return int(t)
    except ValueError:
        pass
    try:
        return float(t)
    except ValueError:
        pass
    import yaml

    return yaml.safe_load(text)


def apply_overrides(cfg_dict: Dict[str, Any], overrides: List[str]) -> Dict[str, Any]:
    """Apply ``a.b.c=value`` style overrides onto a nested dict."""
    out = dict(cfg_dict)
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} must be key.path=value")
        key, _, val = ov.partition("=")
        parts = key.strip().split(".")
        node = out
        for p in parts[:-1]:
            nxt = node.get(p)
            nxt = dict(nxt) if isinstance(nxt, dict) else {}
            node[p] = nxt
            node = nxt
        node[parts[-1]] = _coerce_scalar(val)
    return out


# --------------------------------------------------------------------------- #
# dataclass materialisation
# --------------------------------------------------------------------------- #


def _unwrap_optional(tp):
    if typing.get_origin(tp) is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def from_dict(cls, d: Dict[str, Any]):
    """Build dataclass ``cls`` from a (possibly nested) plain dict.  Unknown
    keys raise; values are coerced to the annotated type where simple, nested
    dataclasses recurse."""
    if d is None:
        d = {}
    if not is_dataclass(cls):
        return d
    hints = typing.get_type_hints(cls)
    unknown = set(d) - {f.name for f in fields(cls)}
    if unknown:
        raise ValueError(f"unknown config key(s) for {cls.__name__}: {sorted(unknown)}")
    kwargs = {}
    for f in fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        tp = _unwrap_optional(hints.get(f.name, Any))
        if is_dataclass(tp) and isinstance(v, dict):
            v = from_dict(tp, v)
        elif v is not None:
            origin = typing.get_origin(tp)
            if origin in (tuple, Tuple):
                v = tuple(v)
            elif origin in (list, List) and not isinstance(v, list):
                v = list(v)
            elif tp is float and isinstance(v, int):
                v = float(v)
            elif tp is int and isinstance(v, float) and v == int(v):
                v = int(v)
        kwargs[f.name] = v
    return cls(**kwargs)


def to_dict(cfg) -> Dict[str, Any]:
    """Dataclass tree -> plain nested dict (for checkpoints)."""
    if is_dataclass(cfg) and not isinstance(cfg, type):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    if isinstance(cfg, dict):
        return {k: to_dict(v) for k, v in cfg.items()}
    return cfg


def replace(cfg, **updates):
    return dataclasses.replace(cfg, **updates)


# --------------------------------------------------------------------------- #
# config groups (same fields and defaults as the JAX package)
# --------------------------------------------------------------------------- #


@dataclass
class CommonConfig:
    seed: int = 1
    log_interval: int = 100
    log_format: str = "simple"  # simple | json | none
    tensorboard_logdir: Optional[str] = None
    wandb_project: Optional[str] = None
    azureml_logging: bool = False
    # read by nothing in the JAX package either: the compute dtype is the
    # model section's dtype_str
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    profile: bool = False
    profile_start: int = 10
    profile_steps: int = 5
    user_dir: Optional[str] = None


@dataclass
class DistributedConfig:
    data_parallel: int = -1
    model_parallel: int = 1
    seq_parallel: int = 1
    pipeline_parallel: int = 1
    fsdp: bool = False
    coordinator_address: Optional[str] = None
    num_processes: int = 1
    process_id: int = 0


@dataclass
class BMUFConfig:
    active: bool = False
    block_momentum: float = 0.875
    block_lr: float = 1.0
    sync_interval: int = 50
    warmup_iterations: int = 0
    use_nbm: bool = True
    average_sync: bool = False
    variant: str = "bmuf"
    slowmo_lr: float = 1.0


@dataclass
class DatasetConfig:
    data: str = ""
    train_subset: str = "train"
    valid_subset: str = "dev"
    gen_subset: str = "test"
    max_tokens: Optional[int] = 40000
    batch_size: Optional[int] = None
    max_source_positions: int = 6000
    max_target_positions: int = 1024
    skip_invalid_size_inputs: bool = True
    required_batch_size_multiple: int = 8
    num_buckets: int = 12
    num_workers: int = 4
    data_buffer_size: int = 8
    shuffle: bool = True


@dataclass
class OptimizationConfig:
    max_epoch: int = 0
    max_update: int = 0
    lr: float = 2e-3
    stop_min_lr: float = -1.0
    clip_norm: float = 0.0
    update_freq: int = 1  # gradient accumulation: micro-batches on a leading axis
    # carried with the config; the criterion's own sentence_avg sets the sample size
    sentence_avg: bool = False
    optimizer: str = "adam"
    adam_betas: Tuple[float, float] = (0.9, 0.98)
    adam_eps: float = 1e-8
    weight_decay: float = 0.0
    lr_scheduler: str = "inverse_sqrt"
    warmup_updates: int = 10000
    warmup_init_lr: float = -1.0
    min_lr: float = 0.0
    patience: int = -1
    lr_groups: Dict[str, float] = field(default_factory=dict)
    lr_shrink: float = 0.1
    lr_patience: int = 0
    lr_milestones: Dict[int, float] = field(default_factory=dict)
    rng_impl: str = "rbg"
    quant_noise_p: float = 0.0
    quant_noise_block_size: int = 8
    fp16_init_scale: float = 2.0 ** 15


@dataclass
class CheckpointConfig:
    save_dir: str = "checkpoints"
    save_interval: int = 1  # epochs
    save_interval_updates: int = 0
    keep_last_epochs: int = -1
    keep_interval_updates: int = -1
    keep_best_checkpoints: int = -1
    best_checkpoint_metric: str = "loss"
    maximize_best_checkpoint_metric: bool = False
    no_save: bool = False
    no_save_optimizer_state: bool = False
    reset_optimizer: bool = False
    reset_dataloader: bool = False
    reset_meters: bool = False
    restore_file: str = "checkpoint_last"
    finetune_from_model: Optional[str] = None
    load_pretrained_encoder_from: Optional[str] = None
    load_pretrained_decoder_from: Optional[str] = None
    async_save: bool = True


@dataclass
class GenerationConfig:
    beam: int = 5
    max_len_a: float = 0.0
    max_len_b: int = 200
    min_len: int = 1
    lenpen: float = 1.0
    unkpen: float = 0.0
    temperature: float = 1.0
    no_repeat_ngram_size: int = 0
    sampling: bool = False
    sampling_topk: int = -1
    sampling_topp: float = -1.0
    diverse_beam_groups: int = -1
    diverse_beam_strength: float = 0.5
    diversity_rate: float = -1.0
    prefix_size: int = 0
    constraints: Optional[str] = None
    iter_decode_max_iter: int = 10
    iter_decode_eos_penalty: float = 0.0
    jacobi: bool = False
    kv_cache_dtype: str = "model"  # "model" | "int8"
    infer_ctc_weight: float = 0.0
    ctc_infer: bool = False
    ctc_self_ensemble: bool = False
    ctc_inter_logit: int = 0
    lm_path: Optional[str] = None
    lm_weight: float = 0.0
    scoring: str = "sacrebleu"
    post_process: Optional[str] = "sentencepiece"
    results_path: Optional[str] = None
    quiet: bool = False


@dataclass
class EvalConfig:
    eval_bleu: bool = False
    eval_wer: bool = False
    eval_gen_beam: int = 1
    eval_gen_max_len_a: float = 0.0
    eval_gen_max_len_b: int = 200
    eval_tokenized_bleu: bool = False
    eval_ctc_wer: bool = False
    context_window: int = 0


@dataclass
class TrainConfig:
    task: str = "speech_to_text"
    arch: str = ""
    criterion: str = "label_smoothed_cross_entropy_with_ctc"
    common: CommonConfig = field(default_factory=CommonConfig)
    distributed: DistributedConfig = field(default_factory=DistributedConfig)
    bmuf: BMUFConfig = field(default_factory=BMUFConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    optimization: OptimizationConfig = field(default_factory=OptimizationConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    generation: GenerationConfig = field(default_factory=GenerationConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    # free-form sections read when the task, model and criterion are built
    task_cfg: Dict[str, Any] = field(default_factory=dict)
    model: Dict[str, Any] = field(default_factory=dict)
    criterion_cfg: Dict[str, Any] = field(default_factory=dict)


def build_config(yaml_paths: List[str | Path] | None = None,
                 overrides: List[str] | None = None, cls=TrainConfig):
    d = load_yaml_stack(yaml_paths or [])
    d = apply_overrides(d, overrides or [])
    return from_dict(cls, d)


# --------------------------------------------------------------------------- #
# what the port has
# --------------------------------------------------------------------------- #


def check_supported(cfg: OptimizationConfig) -> None:
    """Raise NotImplementedError on an optimisation setting the port does not have."""
    if cfg.optimizer not in PORTED_OPTIMIZERS:
        raise NotImplementedError(
            f"OptimizationConfig.optimizer={cfg.optimizer!r} is not ported to s2t_tpu_torch "
            f"(only {PORTED_OPTIMIZERS})")
    if cfg.lr_scheduler not in PORTED_SCHEDULERS:
        raise NotImplementedError(
            f"OptimizationConfig.lr_scheduler={cfg.lr_scheduler!r} is not ported to "
            f"s2t_tpu_torch (only {PORTED_SCHEDULERS})")
    if cfg.rng_impl not in RNG_IMPLS:
        raise NotImplementedError(
            f"OptimizationConfig.rng_impl={cfg.rng_impl!r} is not ported to s2t_tpu_torch")
    if cfg.update_freq < 1:
        raise ValueError(f"update_freq must be >= 1, got {cfg.update_freq}")


def _raise_if_set(section, name: str, cfg, what: str = "") -> None:
    default = next(f for f in fields(cfg) if f.name == name)
    default = default.default_factory() if default.default_factory is not dataclasses.MISSING \
        else default.default
    if getattr(cfg, name) != default:
        raise NotImplementedError(
            f"{section}.{name}={getattr(cfg, name)!r} is not ported to s2t_tpu_torch{what}")


def check_train_supported(cfg: TrainConfig) -> None:
    """Raise NotImplementedError on the first setting of the training CLI
    that the port does not have.  BMUF and every ``distributed`` setting are
    ported (``parallel/``, ``optim/bmuf.py``); ``coordinator_address`` /
    ``num_processes`` / ``process_id`` and ``common.user_dir`` are read by
    nothing, in JAX as here (torchrun's environment names the processes)."""
    check_supported(cfg.optimization)
    for name in ("profile", "tensorboard_logdir", "wandb_project", "azureml_logging"):
        _raise_if_set("common", name, cfg.common)
