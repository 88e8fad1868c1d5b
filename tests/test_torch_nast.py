"""``s2t_nast`` and BiL-CTC through the port's entry points against the JAX package on
the CPU, and the census of the recipes that use the CTC research stack.

* a tiny ``s2t_nast`` (4 layers of 32, inter-CTC at 1 / 2 / 3 with the
  ``inter_league`` PAE, XCTC): greedy, beam-5 and self-ensemble XCTC tokens
  through ``CTCGenerator(use_xctc=True)`` identical to the JAX generator's;
* 3 ``Trainer`` steps at dropout 0 against the JAX ``Trainer``: the NAST model
  under reproduction_nast.yaml's criterion (ctc 1, inter 0.5, xctc 1), and a
  BiL-CTC model (reproduction_bil_ctc.yaml's taps and weights at 3 layers) with
  the PAE oracle at ratio 1 on both taps, through each task's ``forward_fn``;
  per step loss, the CTC logs, gnorm and lr within rtol 1e-5, the parameters
  within atol 5e-6 after 3 steps (the bound of tests/test_torch_train_trainer.py);
* ``cli.train`` (one epoch from raw audio, one flax init) and ``cli.generate``
  (``use_xctc`` from the config) of a NAST model section give the JAX CLIs'
  validation losses (rtol 1e-4) and T-/H-/D- lines;
* the recipe census: each of the 50 ``egs/**/*.yaml`` that sets a field or a
  criterion weight of the CTC research stack resolves to the JAX preset's
  fields and the JAX criterion's config, builds at a tiny depth (its taps, its
  textual taps and cross layers kept) and runs a forward with as many taps of
  each kind as the config places.
"""

import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from s2t_tpu.config import OptimizationConfig as JaxOptimizationConfig
from s2t_tpu.config import TrainConfig as JaxTrainConfig
from s2t_tpu.config import from_dict as jax_from_dict
from s2t_tpu.criterions.build import build_criterion as jax_build_criterion
from s2t_tpu.data.dataset import S2TDataConfig as JaxDataConfig
from s2t_tpu.data.dictionary import Dictionary as JaxDictionary
from s2t_tpu.inference.ctc_decoder import CTCDecoder as JaxCTCDecoder
from s2t_tpu.inference.ctc_decoder import CTCGenerator as JaxCTCGenerator
from s2t_tpu.models import s2t_ctc as jctc
from s2t_tpu.parallel.mesh import make_mesh
from s2t_tpu.tasks.speech_to_text import SpeechToTextTask as JaxTask
from s2t_tpu.trainer import Trainer as JaxTrainer
from s2t_tpu_torch.config import OptimizationConfig, TrainConfig, from_dict
from s2t_tpu_torch.criterions.build import build_criterion
from s2t_tpu_torch.data.dataset import S2TDataConfig
from s2t_tpu_torch.data.dictionary import Dictionary
from s2t_tpu_torch.inference.ctc_decoder import CTCDecoder, CTCGenerator
from s2t_tpu_torch.interop.from_flax import load_flax_params, state_dict_to_flax
from s2t_tpu_torch.models import s2t_ctc as tctc
from s2t_tpu_torch.models import s2t_transformer as tst
from s2t_tpu_torch.models.build import build_model
from s2t_tpu_torch.models.pds import PDSConfig
from s2t_tpu_torch.models.sate import CrossStreamTextLayer, SATEConfig
from s2t_tpu_torch.tasks.speech_to_text import SpeechToTextTask
from s2t_tpu_torch.trainer import Trainer
from tests.test_torch_conformer import cli_round_trip, rng_batch
from tests.test_torch_pds_cli import corpus  # noqa: F401  (the shared wav corpus fixture)
from tests.test_torch_sate import _jax_archs
from tests.test_torch_train_trainer import on_mesh
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

ROOT = Path(__file__).resolve().parent.parent
V = 32
NAST = dict(encoder_layers=4, inter_ctc_layers=(1, 2, 3), encoder_embed_dim=32,
            encoder_ffn_embed_dim=64, encoder_attention_heads=2, subsampling_filter=32,
            vocab_size=V, dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
NAST_CRITERION = ("ctc", {"ctc_weight": 1.0, "inter_ctc_weight": 0.5, "xctc_weight": 1.0})
# egs/mustc/st/conf/reproduction_bil_ctc.yaml at 3 encoder layers (taps at 1 and 2), the
# oracle at ratio 1 on both taps
BIL_CTC = dict(encoder_layers=3, decoder_layers=1, encoder_embed_dim=32, decoder_embed_dim=32,
               encoder_ffn_embed_dim=64, decoder_ffn_embed_dim=64, encoder_attention_heads=2,
               decoder_attention_heads=2, subsampling_filter=32, vocab_size=V,
               max_target_positions=64, dropout=0.0, attention_dropout=0.0,
               activation_dropout=0.0, inter_ctc_layers=(1,), ctc_pae="inter_league",
               use_xctc=True, inter_xctc_layers=(2,), xctc_pae="inter_league",
               ctc_pae_ground_truth_ratio=1.0, xctc_pae_ground_truth_ratio=1.0)
BIL_CTC_CRITERION = ("label_smoothed_cross_entropy_with_ctc", {
    "label_smoothing": 0.1, "ctc": {"ctc_weight": 0.3, "inter_ctc_weight": 0.2,
                                    "xctc_weight": 0.3, "inter_xctc_weight": 0.2}})
OPT = dict(lr=1e-3, warmup_updates=3, clip_norm=1.0, adam_eps=1e-6)
PARAM_ATOL = 5e-6


@pytest.fixture(scope="module")
def nast_pair():
    jm = jctc.S2TCTCModel(jctc.s2t_nast(**NAST))
    feats, lens = rng_batch(0)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), feats, lens)["params"])
    tm = load_flax_params(build_model("s2t_nast", NAST, device="cpu"), params)
    return jm, params, tm


@pytest.mark.parametrize("beam,self_ensemble", [(1, False), (5, False), (1, True), (5, True)])
def test_nast_xctc_tokens_identical_to_jax(nast_pair, beam, self_ensemble):
    jm, params, tm = nast_pair
    assert isinstance(tm, tctc.S2TCTCModel) and tm.cfg.use_xctc
    assert tm.cfg.inter_ctc_layers == (1, 2, 3) and tm.encoder.pae is not None
    feats, lens = rng_batch(3)
    batch = {"features": feats, "feat_lengths": lens}
    jt, js, jenc = JaxCTCGenerator(jm, JaxCTCDecoder(beam_size=beam, self_ensemble=self_ensemble),
                                   use_xctc=True).generate(params, batch)
    tt, ts, enc = CTCGenerator(tm, CTCDecoder(beam_size=beam, self_ensemble=self_ensemble),
                               use_xctc=True).generate(batch)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-4, rtol=0)
    # the decoded logits are the XCTC head's
    np.testing.assert_allclose(enc["ctc_logits"].numpy(), np.asarray(jenc["xctc_logits"]),
                               atol=1e-5)
    assert len(enc["inter_ctc_logits"]) == 3


def _batch(rng, B=4, U=6):
    target = rng.integers(4, V, size=(B, U)).astype(np.int32)
    target[:, -1] = 2
    target[1, -2:] = [2, 1]
    prev = np.roll(target, 1, axis=1)
    prev[:, 0] = 2
    return {"features": rng.normal(size=(B, 48, 80)).astype(np.float32),
            "feat_lengths": np.array([48, 40, 33, 21], np.int32), "prev_tokens": prev,
            "target": target, "target_lengths": (target != 1).sum(1).astype(np.int32),
            "transcript": target[:, :-1].copy(),
            "transcript_lengths": np.array([U - 1, U - 2, U - 1, U - 1], np.int32),
            "ntokens": np.float32((target != 1).sum())}


def _tasks(tmp_path, arch, model, criterion):
    (tmp_path / "dict.txt").write_text("".join(f"w{i} 1\n" for i in range(V - 4)))
    d = {"arch": arch, "model": model, "criterion": criterion[0],
         "criterion_cfg": criterion[1], "dataset": {"data": str(tmp_path)}}
    task = SpeechToTextTask(from_dict(TrainConfig, d), S2TDataConfig(),
                            Dictionary.load(tmp_path / "dict.txt"))
    jtask = JaxTask(jax_from_dict(JaxTrainConfig, d), JaxDataConfig(),
                    JaxDictionary.load(tmp_path / "dict.txt"), None)
    return task, jtask


@pytest.mark.parametrize("name", ["nast", "bil_ctc"])
def test_three_trainer_steps_match_jax(name, tmp_path):
    arch, model, criterion = {
        "nast": ("s2t_nast", NAST, NAST_CRITERION),
        "bil_ctc": ("s2t_transformer_s", BIL_CTC, BIL_CTC_CRITERION)}[name]
    task, jtask = _tasks(tmp_path, arch, {k: list(v) if isinstance(v, tuple) else v
                                          for k, v in model.items()}, criterion)
    rng = np.random.default_rng(1)
    steps = [_batch(rng) for _ in range(3)]
    mesh = make_mesh(devices=jax.devices()[:1])
    jtrainer = JaxTrainer(jtask.build_model(), jax_build_criterion(*criterion),
                          JaxOptimizationConfig(**OPT), mesh=mesh, forward_fn=jtask.forward_fn())
    state = on_mesh(jtrainer.init_state(steps[0]), mesh)
    model_t = task.build_model(device="cpu", for_training=True)
    load_flax_params(model_t, jax.tree.map(np.asarray, state.params))
    trainer = Trainer(model_t, build_criterion(*criterion), OptimizationConfig(**OPT),
                      device="cpu", forward_fn=task.forward_fn())
    keys = ("ctc_loss", "inter_ctc_loss", "xctc_loss") + (
        ("inter_xctc_loss", "nll_loss") if name == "bil_ctc" else ())
    for i, batch in enumerate(steps):
        with jax.default_matmul_precision("highest"):
            state, jm = jtrainer.train_step(state, batch)
        m = trainer.train_step(batch)
        size = float(jm["sample_size"])
        assert m["sample_size"].item() == size
        np.testing.assert_allclose(m["loss"].item() * size, float(jm["loss"]), rtol=1e-5,
                                   err_msg=f"loss @ {i}")
        for key in keys:
            np.testing.assert_allclose(m[key].item(), float(jm[key]), rtol=1e-5,
                                       err_msg=f"{key} @ {i}")
        np.testing.assert_allclose(m["gnorm"].item(), float(jm["gnorm"]), rtol=1e-5)
        np.testing.assert_allclose(m["lr"], float(jm["lr"]), rtol=1e-6)
    got = dict(_flat(state_dict_to_flax(model_t.state_dict())))
    want = dict(_flat(jax.tree.map(np.asarray, state.params)))
    assert set(got) == set(want)
    worst = max(np.abs(got[k] - want[k]).max() for k in want)
    assert worst <= PARAM_ATOL, f"max param difference after 3 steps {worst:.3e}"


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def test_bil_ctc_oracle_moves_the_training_forward():
    """With the oracle at ratio 1 the training forward (dropout 0) differs from the
    eval forward only by the substituted posteriors, and the task threads the
    oracle's inputs only in training."""
    from s2t_tpu_torch.tasks.speech_to_text import encoder_inputs

    batch = {k: torch.as_tensor(np.asarray(v)) for k, v in _batch(np.random.default_rng(2)).items()}
    model = tst.S2TTransformerModel(tst.s2t_transformer_s(**BIL_CTC), device="cpu")
    kw = encoder_inputs(model.cfg, {**batch, "_step": 4}, train=True)
    assert set(kw) == {"transcript", "transcript_lengths", "target", "target_lengths"}
    assert (kw["target"] != 2).all() and torch.equal(kw["target_lengths"],
                                                     batch["target_lengths"] - 1)
    assert encoder_inputs(model.cfg, batch, train=False) == {}
    decay = model.cfg.replace(inter_mixup=True, inter_mixup_ratio_decay=True)
    assert encoder_inputs(decay, {**batch, "_step": 4}, True)["num_updates"] == 4
    args = (batch["features"], batch["feat_lengths"].long(), batch["prev_tokens"])
    with torch.no_grad():
        train = model(*args, train=True, generator=torch.Generator().manual_seed(0), **kw)
        plain = model(*args)
    torch.testing.assert_close(train["inter_ctc_logits"][0][1], plain["inter_ctc_logits"][0][1])
    assert not torch.allclose(train["encoder_out"], plain["encoder_out"], atol=1e-3)


# --------------------------------------------------------------------------- #
CLI_MODEL = {"encoder_layers": 2, "inter_ctc_layers": [1], "encoder_embed_dim": 32,
             "encoder_ffn_embed_dim": 64, "encoder_attention_heads": 2, "subsampling_filter": 16,
             "dropout": 0.0, "attention_dropout": 0.0, "activation_dropout": 0.0}


def _cli_cfg(root, save_dir, results):
    return {
        "arch": "s2t_nast", "criterion": "ctc",
        "criterion_cfg": {**NAST_CRITERION[1], "zero_infinity": True},
        "model": dict(CLI_MODEL),
        "dataset": {"data": str(root), "max_tokens": 80000, "max_source_positions": 9000,
                    "max_target_positions": 16, "num_buckets": 2,
                    "required_batch_size_multiple": 2, "gen_subset": "test"},
        "optimization": {"lr": 1e-3, "warmup_updates": 2, "max_epoch": 1},
        "checkpoint": {"save_dir": str(save_dir), "async_save": False, "reset_optimizer": True,
                       "no_save": True},
        "common": {"log_interval": 1},
        "generation": {"beam": 2, "max_len_b": 8, "scoring": "wer", "post_process": None,
                       "results_path": str(results)},
    }


def test_nast_cli_train_and_generate_match_jax(corpus, tmp_path):
    cli_round_trip(corpus, tmp_path, _cli_cfg, ("loss", "ctc_loss", "inter_ctc_loss", "xctc_loss"),
                   (np.zeros((2, 64, 80), np.float32), np.array([64, 40], np.int32)))


# --------------------------------------------------------------------------- #
# the recipe census
STACK_FIELDS = {
    "inter_ctc_layers", "share_inter_ctc", "share_inter_ctc_norm", "share_inter_xctc_norm",
    "ctc_pae", "pae_ctc_temperature", "share_pae_and_ctc", "ctc_pae_ground_truth_ratio",
    "xctc_pae_ground_truth_ratio", "xctc_pae_ground_truth_only_mistake", "pae_oracle_smooth",
    "pae_unnorm_input", "use_xctc", "inter_xctc_layers", "xctc_pae", "share_xctc_and_embed",
    "use_axctc", "inter_axctc_layers", "compression_layers", "compression_threshold",
    "compression_norm", "compression_pos", "inter_mixup", "inter_mixup_layer",
    "inter_mixup_beta", "inter_mixup_prob", "inter_mixup_ratio", "inter_mixup_keep_org",
    "inter_mixup_ratio_decay", "inter_mixup_ratio_decay_params", "layer_out_norm",
    "layer_out_norm_interval", "text_use_xctc", "xctc_cross_attn", "pds_ctc", "pds_xctc"}
STACK_WEIGHTS = {
    "inter_ctc_weight", "xctc_weight", "inter_xctc_weight", "axctc_weight", "inter_axctc_weight",
    "ctc_entropy_weight", "ctc_self_distill_weight", "ctc_mixup_consistent_weight",
    "inter_ctc_mixup_consistent_weight", "inter_ctc_mlo", "mixup_consistent_weight",
    "cal_mixup_loss"}
TAP_FIELDS = ("inter_ctc_layers", "inter_xctc_layers", "inter_axctc_layers", "compression_layers")
def _leaves(d, prefix=""):
    for k, v in (d or {}).items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + ".")
        else:
            yield k, v


def stack_recipes():
    yaml = pytest.importorskip("yaml")
    out = {}
    for path in sorted((ROOT / "egs").glob("**/*.yaml")):
        conf = yaml.safe_load(path.read_text()) or {}
        model = {k: tuple(v) if isinstance(v, list) else v
                 for k, v in (conf.get("model") or {}).items()}
        crit_cfg = conf.get("criterion_cfg") or {}
        if any(k.removeprefix("acoustic_") in STACK_FIELDS for k in model) or \
                any(k in STACK_WEIGHTS for k, _ in _leaves(crit_cfg)):
            # an overlay with no arch or criterion runs on its basis.yaml's
            criterion = conf.get("criterion") or "label_smoothed_cross_entropy_with_ctc"
            out[str(path.relative_to(ROOT))] = (conf.get("arch") or "s2t_transformer_s", model,
                                                criterion, crit_cfg)
    return out


def _tiny(arch, model, cfg):
    """The recipe at its shallowest depth that keeps every tap of its resolved config
    ``cfg`` (one layer past the deepest), one decoder layer; SATE's textual layers up to
    one past its deepest tap, first cross layer and snapshot, and a PDS acoustic
    encoder's stages at one layer each."""
    enc = getattr(cfg, "acoustic", cfg)
    deepest = max([1] + [max(getattr(enc, f, ()) or (0,)) for f in TAP_FIELDS])
    if arch.startswith("s2t_sate") or arch == "s2t_ctc_sate":
        # the textual layers up to one past the deepest tap, the first cross layer and
        # the snapshot
        text = max([1] + [l + 1 for l in cfg.inter_xctc_layers] + (
            [cfg.cross_attn_start_layer, cfg.cross_attn_layer + 1] if cfg.xctc_cross_attn
            else []))
        pds = {"pds_layers": (1,) * cfg.pds.pds_stages} if cfg.pds is not None else {}
        return {**model, "acoustic_encoder_layers": deepest + 1, "text_encoder_layers": text,
                **pds, **({} if arch == "s2t_ctc_sate" else {"acoustic_decoder_layers": 1})}
    if "pds" in arch:
        return {**model, "decoder_layers": 1}
    return {**model, "encoder_layers": deepest + 1,
            **({} if arch in ("s2t_ctc", "s2t_nast") else {"decoder_layers": 1})}


def _same_fields(want, got, where):
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if dataclasses.is_dataclass(w):
            _same_fields(w, g, f"{where}.{f.name}")
        else:
            assert g == w, (where, f.name)


def _inter_ctc_taps(cfg):
    """Inter-CTC taps a forward returns: the acoustic encoder's (SATE) or the model's,
    a PDS encoder's by stage."""
    if isinstance(cfg, SATEConfig):
        cfg = cfg.pds if cfg.acoustic_encoder == "pds" else cfg.acoustic
    if isinstance(cfg, PDSConfig):
        return len(cfg.ctc_stages)
    return len({l for l in cfg.inter_ctc_layers if 1 <= l < cfg.encoder_layers}) \
        if cfg.use_ctc else 0


def test_every_stack_recipe_builds_or_raises_by_item():
    from s2t_tpu.registry import ARCHS as JAX_ARCHS
    from s2t_tpu_torch.registry import ARCHS

    _jax_archs()
    recipes = stack_recipes()
    built = []
    for path, (arch, model, criterion, crit_cfg) in recipes.items():
        cfg = ARCHS.get(arch)[1](**model)
        _same_fields(JAX_ARCHS.get(arch)[1](**model), cfg, path)
        _same_fields(jax_build_criterion(criterion, crit_cfg).cfg,
                     build_criterion(criterion, crit_cfg).cfg, path)
        m = build_model(arch, _tiny(arch, model, cfg), device="cpu", vocab_size=V)
        with torch.no_grad():
            out = m(torch.randn(2, 48, 80), torch.tensor([48, 30]), torch.full((2, 3), 2))
        assert torch.isfinite(out["encoder_out"]).all(), path
        built.append(path)
        assert len(out["inter_ctc_logits"]) == _inter_ctc_taps(m.cfg), path
        if isinstance(m.cfg, SATEConfig):  # the textual taps and cross layers
            text = m.cfg.text_encoder_layers
            assert len(out["inter_xctc_logits"]) == len(
                {l for l in m.cfg.inter_xctc_layers if 1 <= l < text}), path
            cross = [l for l in m.encoder.textual.layers
                     if isinstance(l, CrossStreamTextLayer) and l.s2_attn is not None]
            assert bool(cross) == m.cfg.xctc_cross_attn, path
            if m.cfg.text_use_xctc or m.cfg.inter_xctc_layers:
                assert out["xctc_logits"].shape[-1] == V, path
    assert len(recipes) == 50 and len(built) == 50


def test_chip_smoke_carries_the_stack_recipes():
    """chip_smoke.py phases 22-24 run these recipes' sections (the card has no yaml
    package, so the script carries copies) and count their CTC terms."""
    yaml = pytest.importorskip("yaml")
    import chip_smoke

    def conf(name):
        return yaml.safe_load((ROOT / "egs" / name).read_text())

    nast = conf("mustc/st/conf/reproduction_nast.yaml")
    assert (nast["arch"], nast["criterion"]) == ("s2t_nast", chip_smoke.NAST_CRITERION[0])
    assert nast["criterion_cfg"] == chip_smoke.NAST_CRITERION[1]
    bil = conf("mustc/st/conf/reproduction_bil_ctc.yaml")
    assert bil["model"] == chip_smoke.BIL_CTC_MODEL
    assert bil["criterion_cfg"] == chip_smoke.BIL_CTC_CRITERION[1]
    assert conf("mustc/st/conf/basis.yaml")["criterion"] == chip_smoke.BIL_CTC_CRITERION[0]
    aipa = conf("librispeech/asr/conf/reproduction_purectc_aipa_kd.yaml")
    assert {k: aipa[k] for k in ("arch", "criterion", "criterion_cfg", "model")} == chip_smoke.AIPA
    # the terms a step launches K3 / K4 for: taps of the full-depth configs, twice under mixup
    taps = {"nast": tctc.s2t_nast(),
            "bil": tst.s2t_transformer_s(**chip_smoke.fields(bil["model"])),
            "aipa": tctc.s2t_ctc_base(**chip_smoke.fields(aipa["model"]))}
    assert chip_smoke.NAST_TERMS == 2 + len(taps["nast"].inter_ctc_layers)
    assert chip_smoke.BIL_CTC_TERMS == 2 + len(taps["bil"].inter_ctc_layers) + len(
        taps["bil"].inter_xctc_layers)
    assert chip_smoke.AIPA_TERMS == 2 * (1 + len(taps["aipa"].inter_ctc_layers))
    assert chip_smoke.encoder_layers(taps["nast"]) == 18 and chip_smoke.encoder_layers(
        taps["aipa"]) == 0
