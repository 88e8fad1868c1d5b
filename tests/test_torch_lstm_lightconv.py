"""The LSTM models, the LightConv / DynamicConv models and ``cross_entropy`` against
the JAX package.

Tiny models (widths 8-16, two layers a side; 3 padded source rows and teacher-forced
targets from a numpy seed): the port's seeded weights as a flax tree (``state_dict_to_flax``,
whose paths and shapes must be the JAX model's own init's), perturbed so every leaf
counts, carried back by ``from_flax`` and run by both packages:

* ``lstm`` (bidirectional encoder under ``enc_proj``, 2 input-feeding decoder cells),
  ``lstm_lm``, ``lightconv`` and ``dynamicconv``: forward outputs within 1e-5 of each
  tensor's largest magnitude; ``from_flax`` both ways keeps the tree (the LSTM gates
  fused and split);
* the losses at rtol 1e-4 and every gradient within 1e-4 of its largest entry, the
  LSTM under ``cross_entropy``, the conv models under ``label_smoothed_cross_entropy``;
  ``cross_entropy`` itself against JAX's on seeded logits, its smoothing 0.1 as JAX's;
* ``lstm_lm``'s incremental steps against JAX's ``decode_step``;
* beam-5 tokens identical for the three encoder-decoders;
* the presets' widths and the seeded build (every weight from the seed).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2t_tpu.criterions.build import build_criterion as jax_build_criterion
from s2t_tpu.inference.generator import SequenceGenerator as JaxGenerator
from s2t_tpu.models import lightconv as jlc
from s2t_tpu.models import lstm as jl
from s2t_tpu_torch.criterions.build import build_criterion
from s2t_tpu_torch.inference.generator import SequenceGenerator
from s2t_tpu_torch.interop.from_flax import load_flax_params, state_dict_to_flax
from s2t_tpu_torch.models import lightconv as tlc
from s2t_tpu_torch.models import lstm as tl
from s2t_tpu_torch.models import s2t_transformer
from s2t_tpu_torch.models.build import build_model
from tests.test_torch_train_trainer import flat
from tests.test_torch_wav2vec2 import assert_close, perturb
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

V = 23
LENGTHS = np.array([7, 5, 2], np.int32)
LSTM = dict(encoder_embed_dim=8, encoder_hidden_size=8, encoder_layers=2, decoder_embed_dim=12,
            decoder_hidden_size=12, decoder_layers=2, dropout=0.0, vocab_size=V,
            src_vocab_size=19)
LSTM_LM = dict(decoder_embed_dim=8, decoder_hidden_size=12, decoder_layers=2, dropout=0.0,
               vocab_size=V)
CONV = dict(encoder_embed_dim=8, decoder_embed_dim=8, encoder_conv_dim=8, decoder_conv_dim=8,
            encoder_ffn_embed_dim=16, decoder_ffn_embed_dim=16, encoder_attention_heads=2,
            decoder_attention_heads=2, encoder_kernel_sizes=(3, 5), decoder_kernel_sizes=(3, 5),
            dropout=0.0, attention_dropout=0.0, weight_dropout=0.0, vocab_size=V,
            src_vocab_size=19, max_target_positions=32)
# name -> (the JAX model, the port model), each over its config
MODELS = {
    "lstm": (lambda: jl.LSTMModel(jl.LSTMConfig(**LSTM)),
             lambda: tl.LSTMModel(tl.LSTMConfig(**LSTM), device="cpu", for_training=True)),
    "lightconv": (lambda: jlc.LightConvModel(jlc.lightconv_iwslt(**CONV)),
                  lambda: tlc.LightConvModel(tlc.lightconv_iwslt(**CONV), device="cpu",
                                             for_training=True)),
    "dynamicconv": (lambda: jlc.LightConvModel(jlc.dynamicconv_iwslt(**CONV)),
                    lambda: tlc.LightConvModel(tlc.dynamicconv_iwslt(**CONV), device="cpu",
                                               for_training=True)),
}
CRITERION = {"lstm": ("cross_entropy", {}), "lightconv": ("label_smoothed_cross_entropy", {}),
             "dynamicconv": ("label_smoothed_cross_entropy", {"label_smoothing": 0.2})}


def batch(seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(4, 19, size=(3, 7)).astype(np.int32)
    for b, n in enumerate(LENGTHS):
        src[b, n - 1] = 2
        src[b, n:] = 1
    target = rng.integers(4, V, size=(3, 5)).astype(np.int32)
    target[:, -1] = 2
    target[2, 2] = 2
    target[2, 3:] = 1
    prev = np.concatenate([np.full((3, 1), 2, np.int32), target[:, :-1]], axis=1)
    prev[2, 3:] = 1
    return src, prev, target


def shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(shapes(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


def seeded_pair(jm, port, *init_args, shared_embed=False, **init_kw):
    """(perturbed flax params, the port model holding them): the tree comes from the port's
    seeded build through ``state_dict_to_flax`` and must have the paths and shapes of the
    JAX model's own init (traced by ``jax.eval_shape``, which runs nothing)."""
    want = jax.eval_shape(functools.partial(jm.init, **init_kw), jax.random.PRNGKey(0),
                          *init_args)["params"]
    params = perturb(state_dict_to_flax(port.state_dict(), shared_embed=shared_embed))
    assert shapes(params) == shapes(want)
    return params, load_flax_params(port, params)


@pytest.fixture(scope="module")
def pairs():
    """name -> (JAX model, perturbed flax params, port model), built once each."""
    src, prev, _ = batch()
    out = {}
    for name, (jax_model, port_model) in MODELS.items():
        jm = jax_model()
        out[name] = (jm, *seeded_pair(jm, port_model(), src, LENGTHS, prev))
    return out


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_matches_jax_and_from_flax_keeps_the_tree(pairs, name):
    jm, params, tm = pairs[name]
    src, prev, _ = batch()
    want = jm.apply({"params": params}, src, LENGTHS, prev)
    with torch.no_grad():
        got = tm(torch.from_numpy(src), torch.from_numpy(LENGTHS), torch.from_numpy(prev).long())
    for key in ("encoder_out", "decoder_logits"):
        assert_close(got[key].numpy(), want[key], f"{name} {key}, 1e-5")
    back, tree = dict(flat(state_dict_to_flax(tm.state_dict()))), dict(flat(params))
    assert set(back) == set(tree)
    for k in tree:
        np.testing.assert_array_equal(back[k], tree[k], err_msg=k)


@pytest.mark.parametrize("name", list(MODELS))
def test_loss_and_gradients_match_jax(pairs, name):
    jm, params, tm = pairs[name]
    src, prev, target = batch(1)
    jcrit = jax_build_criterion(*CRITERION[name])

    def jax_loss(p):
        loss, size, _ = jcrit(jm.apply({"params": p}, src, LENGTHS, prev), {"target": target})
        return loss, size

    with jax.default_matmul_precision("highest"):
        (jloss, jsize), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    tm.zero_grad()
    out = tm(torch.from_numpy(src), torch.from_numpy(LENGTHS), torch.from_numpy(prev).long(),
             train=True, generator=torch.Generator().manual_seed(0))
    loss, size, _ = build_criterion(*CRITERION[name])(out, {"target": torch.from_numpy(target)
                                                            .long()})
    loss.backward()
    assert size.item() == float(jsize)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4, err_msg="loss, rtol 1e-4")
    got = dict(flat(state_dict_to_flax({n: p.grad for n, p in tm.named_parameters()})))
    want = dict(flat(jax.tree.map(np.asarray, jgrads)))
    assert set(got) == set(want)
    for k in want:
        assert_close(got[k], want[k], f"{k}, 1e-4", tol=1e-4)


def test_cross_entropy_is_jax_s_label_smoothed_class():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(3, 5, V)).astype(np.float32)
    target = rng.integers(4, V, size=(3, 5)).astype(np.int32)
    target[1, 3:] = 1
    for cfg in ({}, {"label_smoothing": 0.0}):
        jloss, jsize, jlogs = jax_build_criterion("cross_entropy", cfg)(
            {"decoder_logits": jnp.asarray(logits)}, {"target": jnp.asarray(target)})
        crit = build_criterion("cross_entropy", cfg)
        loss, size, logs = crit({"decoder_logits": torch.from_numpy(logits)},
                                {"target": torch.from_numpy(target).long()})
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(logs["nll_loss"].item(), float(jlogs["nll_loss"]), rtol=1e-5)
        assert size.item() == float(jsize) and logs["n_correct"].item() == float(jlogs["n_correct"])
    assert build_criterion("cross_entropy").cfg.label_smoothing == 0.1


def test_lstm_lm_forward_and_steps_match_jax():
    _, prev, _ = batch()
    jm = jl.LSTMLM(jl.LSTMConfig(**LSTM_LM))
    params, tm = seeded_pair(jm, tl.LSTMLM(tl.LSTMConfig(**LSTM_LM), device="cpu",
                                           for_training=True), prev)
    assert "out_to_emb" in params
    with torch.no_grad():
        got = tm(torch.from_numpy(prev).long())["decoder_logits"]
        assert_close(got.numpy(), jm.apply({"params": params}, prev)["decoder_logits"],
                     "lstm_lm logits, 1e-5")
        jcache, cache = jm.apply({"params": params}, 3, 8, method=jm.init_cache), tm.init_cache(3, 8)
        for i in range(3):
            tok = prev[:, i:i + 1]
            want, jcache = jm.apply({"params": params}, jnp.asarray(tok), jcache, i,
                                    method=jm.decode_step)
            step, cache = tm.decode_step(torch.from_numpy(tok).long(), cache, i)
            assert_close(step.numpy(), want, f"step {i} logits, 1e-5")
            assert_close(step.numpy(), got[:, i].numpy(), f"step {i} vs forward, 1e-5")
    back, tree = dict(flat(state_dict_to_flax(tm.state_dict()))), dict(flat(params))
    assert set(back) == set(tree)


@pytest.mark.parametrize("name", list(MODELS))
def test_beam5_tokens_match_jax(pairs, name):
    jm, params, tm = pairs[name]
    src, _, _ = batch(2)
    kw = dict(beam_size=5, max_len_b=8, input_keys=("src_tokens", "src_lengths"))
    tm.eval()
    with torch.no_grad():
        got, _, _ = SequenceGenerator(tm, **kw).generate({"src_tokens": src,
                                                          "src_lengths": LENGTHS})
    want, _ = JaxGenerator(jm, **kw).generate(
        params, {"src_tokens": jnp.asarray(src), "src_lengths": jnp.asarray(LENGTHS)})[:2]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def poison(module):
    for p in module.parameters(recurse=False):
        p.data.fill_(float("nan"))


@pytest.mark.parametrize("arch,kw", [
    ("lstm_wiseman_iwslt_de_en", {"encoder_layers": 2, "decoder_layers": 2}),
    ("lstm_lm", {"decoder_hidden_size": 128}),
    ("lightconv_iwslt_de_en", {"encoder_kernel_sizes": (3, 31), "decoder_kernel_sizes": (3,)}),
    ("dynamicconv_iwslt_de_en", {"encoder_kernel_sizes": (3,), "decoder_kernel_sizes": (31,)})])
def test_presets_and_seeded_build(monkeypatch, arch, kw):
    monkeypatch.setattr(s2t_transformer, "skip_default_init", poison)
    builds = []
    for global_seed in (1, 2):
        torch.manual_seed(global_seed)
        builds.append(build_model(arch, kw, device="cpu", seed=0, for_training=True,
                                  vocab_size=50))
    m = builds[0]
    sd = [b.state_dict() for b in builds]
    assert all(torch.isfinite(t).all() for t in sd[0].values())
    assert all(torch.equal(sd[0][k], sd[1][k]) for k in sd[0])
    if arch.startswith("lstm_w"):
        assert m.cfg.encoder_hidden_size == 256 and m.cfg.decoder_embed_dim == 256
        assert abs(m.src_embed.weight.std().item() - 0.1) < 0.02
    elif arch == "lstm_lm":
        assert not m.cfg.encoder_bidirectional and m.out_to_emb is not None
    else:
        assert m.cfg.encoder_ffn_embed_dim == 1024 and m.cfg.encoder_attention_heads == 4
        assert m.cfg.conv_type == ("dynamic" if arch.startswith("dynamic") else "lightweight")
