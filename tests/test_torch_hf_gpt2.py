"""GPT-2 (``hf_gpt2``) against the JAX package.

A tiny GPT-2 (16 wide, FFN 32, 2 heads, 2 pre-norm layers, 32 positions) over 23
entries; the port's seeded weights as a flax tree with JAX's paths and shapes, perturbed,
carried back by ``from_flax`` (and back again unchanged):

* the logits within 1e-5 of their largest magnitude: tanh GELU, learned positions, the
  tied output, no embedding scale, no cross-attention;
* incremental decoding (``init_cache`` / ``decode_step``) equals the full forward's
  logits at every position, in both packages;
* one ``language_modeling`` Trainer update from JAX's initial state, loss and
  gradient norm at rtol 1e-4 against JAX's Trainer, the updated weights within 2 lr;
* the presets' widths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2t_tpu.config import OptimizationConfig as JaxOptimizationConfig
from s2t_tpu.criterions.build import build_criterion as jax_build_criterion
from s2t_tpu.models import hf_gpt2 as jg
from s2t_tpu.parallel.mesh import make_mesh
from s2t_tpu.tasks.language_modeling import LanguageModelingTask as JaxLMTask
from s2t_tpu.trainer import Trainer as JaxTrainer
from s2t_tpu_torch.config import OptimizationConfig
from s2t_tpu_torch.criterions.build import build_criterion
from s2t_tpu_torch.interop.from_flax import load_flax_params, state_dict_to_flax
from s2t_tpu_torch.models import hf_gpt2 as tg
from s2t_tpu_torch.models.build import build_model
from s2t_tpu_torch.tasks.language_modeling import lm_forward
from s2t_tpu_torch.trainer import Trainer
from tests.test_torch_lstm_lightconv import shapes
from tests.test_torch_train_trainer import flat, on_mesh
from tests.test_torch_wav2vec2 import assert_close, perturb
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

V = 23
TINY = dict(decoder_embed_dim=16, decoder_ffn_embed_dim=32, decoder_layers=2,
            decoder_attention_heads=2, dropout=0.0, attention_dropout=0.0, vocab_size=V,
            max_target_positions=32)
CRIT = ("label_smoothed_cross_entropy", {"label_smoothing": 0.1})


def lm_batch(seed=0, B=3, L=12):
    rng = np.random.default_rng(seed)
    target = rng.integers(4, V, size=(B, L)).astype(np.int32)
    prev = np.roll(target, 1, axis=1)
    prev[:, 0] = 2
    return {"prev_tokens": prev, "target": target,
            "target_lengths": np.full((B,), L, np.int32), "ntokens": np.float32(B * L)}


@pytest.fixture(scope="module")
def gpt2():
    jm = jg.HFGPT2Model(jg.hf_gpt2(**TINY))
    port = tg.HFGPT2Model(tg.hf_gpt2(**TINY), device="cpu", for_training=True)
    want = jax.eval_shape(jm.init, jax.random.PRNGKey(0), lm_batch()["prev_tokens"])["params"]
    params = perturb(state_dict_to_flax(port.state_dict()))
    assert shapes(params) == shapes(want)
    return jm, params, load_flax_params(port, params)


def test_logits_and_incremental_decoding_match_jax(gpt2):
    jm, params, tm = gpt2
    prev = lm_batch(1)["prev_tokens"]
    want = np.asarray(jm.apply({"params": params}, prev)["decoder_logits"])
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(prev).long())["decoder_logits"]
        assert_close(got.numpy(), want, "logits")
        cache = tm.init_cache(prev.shape[0], prev.shape[1])
        for i in range(prev.shape[1]):
            step, cache = tm.decode_step(torch.from_numpy(prev[:, i:i + 1]).long(), cache, i)
            assert_close(step.numpy(), got[:, i].numpy(), f"port step {i}")
    # JAX's own steps, in order, against its full forward (one jit: the index is traced)
    step = jax.jit(lambda p, tok, c, i: jm.apply({"params": p}, tok, c, i, method=jm.decode_step))
    jcache = jm.apply({"params": params}, prev.shape[0], prev.shape[1], method=jm.init_cache)
    for i in range(prev.shape[1]):
        jstep, jcache = step(params, jnp.asarray(prev[:, i:i + 1]), jcache, i)
        assert_close(np.asarray(jstep), want[:, i], f"JAX step {i}")
    back = dict(flat(state_dict_to_flax(tm.state_dict())))
    tree = dict(flat(params))
    assert set(back) == set(tree) and "decoder/embed_positions/embedding" in tree
    for k in tree:
        np.testing.assert_array_equal(back[k], tree[k], err_msg=k)


def test_one_language_modeling_update_matches_jax():
    opt = dict(lr=1e-3, warmup_updates=2, max_update=1, clip_norm=1.0)
    batch = lm_batch(2)
    mesh = make_mesh(devices=jax.devices()[:1])
    jfwd = JaxLMTask.forward_fn(None)
    jt = JaxTrainer(jg.HFGPT2Model(jg.hf_gpt2(**TINY)), jax_build_criterion(*CRIT),
                    JaxOptimizationConfig(**opt), mesh=mesh, forward_fn=jfwd)
    state = on_mesh(jt.init_state(batch), mesh)
    tm = load_flax_params(tg.HFGPT2Model(tg.hf_gpt2(**TINY), device="cpu", for_training=True),
                          jax.tree.map(np.asarray, state.params))
    tt = Trainer(tm, build_criterion(*CRIT), OptimizationConfig(**opt), device="cpu",
                 forward_fn=lm_forward)
    with jax.default_matmul_precision("highest"):
        state, jmet = jt.train_step(state, batch)
    m = tt.train_step(batch)
    np.testing.assert_allclose(float(m["loss"]), float(jmet["loss"]) / float(batch["ntokens"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(m["gnorm"]), float(jmet["gnorm"]), rtol=1e-4)
    # Adam's first update is about lr x sign(g): an entry whose gradient is float noise
    # (a key bias, which softmax ignores) may move the other way, up to 2 lr apart
    got = dict(flat(state_dict_to_flax(tm.state_dict())))
    for k, v in flat(jax.tree.map(np.asarray, state.params)):
        np.testing.assert_allclose(got[k], v, rtol=0, atol=2 * opt["lr"], err_msg=k)


@pytest.mark.parametrize("arch,width,layers,heads", [("hf_gpt2", 768, 12, 12),
                                                     ("hf_gpt2_medium", 1024, 24, 16),
                                                     ("hf_gpt2_large", 1280, 36, 20)])
def test_presets(arch, width, layers, heads):
    m = build_model(arch, {"decoder_layers": 1}, device="cpu", vocab_size=40,
                    max_target_positions=16)
    cfg = m.cfg
    assert (cfg.decoder_embed_dim, cfg.decoder_ffn_embed_dim, cfg.decoder_attention_heads) == \
        (width, 4 * width, heads)
    assert getattr(tg, arch)().decoder_layers == layers and tg.hf_gpt2().vocab_size == 50257
    assert m.decoder.no_cross_attention and m.decoder.no_scale_embedding
    assert list(m.state_dict()).count("decoder.embed_tokens.weight") == 1
