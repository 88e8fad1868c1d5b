"""BART and mBART against the JAX package.

Tiny models at the widths of tests/test_torch_translation.py (16 wide, FFN 32, 2 heads;
2 layers a side, 23 words, a 3-class head), ``bart_base``'s and ``mbart_large``'s
flags: the port's seeded weights as a flax tree with JAX's paths and shapes (the top-level
``shared`` table from the decoder's, which the encoder borrows), perturbed so every leaf
counts, carried back by ``from_flax``:

* the encoder output, the decoder logits and the classification head's logits within
  1e-5 of each tensor's largest magnitude, ``classify`` equal to the forward's head;
  ``from_flax`` both ways keeps the tree;
* ``mbart_large`` is pre-norm (a final LayerNorm a side) and scales its embedding by
  sqrt(D), ``bart_base`` neither: the encoder's input equals JAX's with each flag;
* the label-smoothed loss at rtol 1e-4 and every gradient (the shared table's sums its
  three uses) within 1e-4 of its largest entry;
* 2 Trainer updates: per-step loss and gradient norm at rtol 1e-4 against JAX's;
* beam-5 tokens identical;
* the presets' widths (768 / 3072 / 12 heads; 1024 / 4096 / 16) and one table in the
  state dict.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2t_tpu.config import OptimizationConfig as JaxOptimizationConfig
from s2t_tpu.criterions.build import build_criterion as jax_build_criterion
from s2t_tpu.inference.generator import SequenceGenerator as JaxGenerator
from s2t_tpu.models import bart as jb
from s2t_tpu.parallel.mesh import make_mesh
from s2t_tpu.trainer import Trainer as JaxTrainer
from s2t_tpu_torch.config import OptimizationConfig
from s2t_tpu_torch.criterions.build import build_criterion
from s2t_tpu_torch.inference.generator import SequenceGenerator
from s2t_tpu_torch.interop.from_flax import load_flax_params, state_dict_to_flax
from s2t_tpu_torch.models import bart as tb
from s2t_tpu_torch.models.build import build_model
from s2t_tpu_torch.models.transformer import text_forward
from s2t_tpu_torch.trainer import Trainer
from tests.test_torch_lstm_lightconv import LENGTHS, V, batch, seeded_pair
from tests.test_torch_train_trainer import flat, on_mesh
from tests.test_torch_wav2vec2 import assert_close, perturb
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

TINY = dict(encoder_embed_dim=16, encoder_ffn_embed_dim=32, encoder_layers=2,
            encoder_attention_heads=2, decoder_embed_dim=16, decoder_ffn_embed_dim=32,
            decoder_layers=2, decoder_attention_heads=2, dropout=0.0, vocab_size=V,
            max_source_positions=16, max_target_positions=16, num_classes=3)
PRESETS = {"bart_base": (jb.bart_base, tb.bart_base),
           "mbart_large": (jb.mbart_large, tb.mbart_large)}
CRIT = ("label_smoothed_cross_entropy", {"label_smoothing": 0.1})


@pytest.fixture(scope="module")
def pairs():
    """preset -> (JAX model, perturbed flax params, port model)."""
    src, prev, _ = batch()
    out = {}
    for name, (jax_preset, port_preset) in PRESETS.items():
        jm = jb.BARTModel(jax_preset(**TINY))
        port = tb.BARTModel(port_preset(**TINY), device="cpu", for_training=True)
        out[name] = (jm, *seeded_pair(jm, port, src, LENGTHS, prev, shared_embed="shared",
                                      classification=True))
    return out


def run(tm, src, prev, **kw):
    return tm(torch.from_numpy(src), torch.from_numpy(LENGTHS), torch.from_numpy(prev).long(),
              **kw)


@pytest.mark.parametrize("name", list(PRESETS))
def test_forward_and_head_match_jax(pairs, name):
    jm, params, tm = pairs[name]
    src, prev, _ = batch()
    want = jm.apply({"params": params}, src, LENGTHS, prev, classification=True)
    with torch.no_grad():
        got = run(tm, src, prev, classification=True)
        head = tm.classify(torch.from_numpy(src), torch.from_numpy(LENGTHS))
    for key in ("encoder_out", "decoder_logits", "cls_logits"):
        assert_close(got[key].numpy(), want[key], f"{name} {key}, 1e-5")
    assert got["cls_logits"].shape == (3, 3)
    torch.testing.assert_close(head, got["cls_logits"], rtol=0, atol=0)
    back = dict(flat(state_dict_to_flax(tm.state_dict(), shared_embed="shared")))
    tree = dict(flat(params))
    assert set(back) == set(tree) and "shared/embedding" in tree
    for k in tree:
        np.testing.assert_array_equal(back[k], tree[k], err_msg=k)


def test_mbart_is_pre_norm_with_a_scaled_embedding(pairs):
    """The encoder's embedded input (before its first layer) against JAX's under each
    preset's flags: mBART multiplies the shared table's rows by sqrt(16), BART not."""
    src, _, _ = batch()
    for name, scaled in (("bart_base", False), ("mbart_large", True)):
        jm, params, tm = pairs[name]
        cfg = tm.cfg
        assert cfg.encoder_normalize_before == cfg.decoder_normalize_before == scaled
        assert cfg.no_scale_embedding is not scaled
        assert (tm.encoder.final_norm is not None) == scaled
        assert (tm.decoder.final_norm is not None) == scaled
        assert tm.encoder.embed_tokens is tm.decoder.embed_tokens
        captured = {}
        layer0 = tm.encoder.layers[0]
        hook = layer0.register_forward_pre_hook(lambda m, args: captured.update(x=args[0]))
        with torch.no_grad():
            tm.encode(torch.from_numpy(src), torch.from_numpy(LENGTHS))
        hook.remove()
        table = params["shared"]["embedding"][src] * (4.0 if scaled else 1.0)
        v = (src != 1).astype(np.int32)
        pos = params["encoder"]["embed_positions"]["embedding"][np.cumsum(v, 1) * v + 1]
        x = table + pos
        mu, var = x.mean(-1, keepdims=True), x.var(-1, keepdims=True)
        ln = params["encoder"]["emb_norm"]
        want = (x - mu) / np.sqrt(var + 1e-6) * ln["scale"] + ln["bias"]
        assert_close(captured["x"].numpy(), want, f"{name} embedded input, 1e-5")


def test_loss_and_gradients_match_jax(pairs):
    jm, params, tm = pairs["bart_base"]
    src, prev, target = batch(1)
    jcrit = jax_build_criterion(*CRIT)

    def jax_loss(p):
        loss, size, _ = jcrit(jm.apply({"params": p}, src, LENGTHS, prev), {"target": target})
        return loss, size

    with jax.default_matmul_precision("highest"):
        (jloss, _), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    tm.zero_grad()
    out = run(tm, src, prev, train=True, generator=torch.Generator().manual_seed(0))
    loss, _, _ = build_criterion(*CRIT)(out, {"target": torch.from_numpy(target).long()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4, err_msg="loss, rtol 1e-4")
    got = dict(flat(state_dict_to_flax({n: p.grad for n, p in tm.named_parameters()
                                        if p.grad is not None}, shared_embed="shared")))
    want = dict(flat(jax.tree.map(np.asarray, jgrads)))
    # the head takes no gradient from the seq2seq loss
    assert set(got) == {k for k in want if not k.startswith("cls_")}
    for k in got:
        assert_close(got[k], want[k], f"{k}, 1e-4", tol=1e-4)


def text_batches(n=2, B=3, S=7, U=6):
    rng = np.random.default_rng(4)
    out = []
    for _ in range(n):
        src = rng.integers(4, V, size=(B, S)).astype(np.int32)
        tgt = rng.integers(4, V, size=(B, U)).astype(np.int32)
        src[:, -1] = tgt[:, -1] = 2
        prev = np.concatenate([np.full((B, 1), 2, np.int32), tgt[:, :-1]], axis=1)
        out.append({"src_tokens": src, "src_lengths": np.full((B,), S, np.int32),
                    "prev_tokens": prev, "target": tgt,
                    "target_lengths": np.full((B,), U, np.int32), "ntokens": np.float32(B * U)})
    return out


def test_two_trainer_updates_match_jax():
    cfg = {**TINY, "num_classes": 0}
    opt = dict(lr=1e-3, warmup_updates=2, max_update=2)
    steps = text_batches()

    def jax_forward(model, params, b, deterministic, rngs=None):
        args = (b["src_tokens"], b["src_lengths"], b["prev_tokens"])
        if params is None:
            return model.init(rngs["params"], *args)
        return model.apply({"params": params}, *args, deterministic=deterministic, rngs=rngs)

    mesh = make_mesh(devices=jax.devices()[:1])
    jt = JaxTrainer(jb.BARTModel(jb.bart_base(**cfg)), jax_build_criterion(*CRIT),
                    JaxOptimizationConfig(**opt), mesh=mesh, forward_fn=jax_forward)
    state = on_mesh(jt.init_state(steps[0]), mesh)
    tm = load_flax_params(tb.BARTModel(tb.bart_base(**cfg), device="cpu", for_training=True),
                          jax.tree.map(np.asarray, state.params))
    tt = Trainer(tm, build_criterion(*CRIT), OptimizationConfig(**opt), device="cpu",
                 forward_fn=text_forward)
    for b in steps:
        with jax.default_matmul_precision("highest"):
            state, jmet = jt.train_step(state, b)
        m = tt.train_step(b)
        # JAX logs the summed loss, the port the per-token one
        np.testing.assert_allclose(float(m["loss"]), float(jmet["loss"]) / float(b["ntokens"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(m["gnorm"]), float(jmet["gnorm"]), rtol=1e-4)


@pytest.mark.parametrize("name", list(PRESETS))
def test_beam5_tokens_match_jax(pairs, name):
    jm, params, tm = pairs[name]
    src, _, _ = batch(2)
    kw = dict(beam_size=5, max_len_b=8, input_keys=("src_tokens", "src_lengths"))
    tm.eval()
    with torch.no_grad():
        got, _, _ = SequenceGenerator(tm, **kw).generate({"src_tokens": src,
                                                          "src_lengths": LENGTHS})
    want = JaxGenerator(jm, **kw).generate(
        params, {"src_tokens": jnp.asarray(src), "src_lengths": jnp.asarray(LENGTHS)})[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch,width,ffn,heads", [("bart_base", 768, 3072, 12),
                                                  ("bart_large", 1024, 4096, 16),
                                                  ("mbart_large", 1024, 4096, 16)])
def test_presets_keep_one_table(arch, width, ffn, heads):
    m = build_model(arch, {"encoder_layers": 1, "decoder_layers": 1}, device="cpu",
                    vocab_size=40, max_source_positions=16, max_target_positions=16)
    cfg = m.cfg
    assert (cfg.encoder_embed_dim, cfg.encoder_ffn_embed_dim, cfg.encoder_attention_heads) == \
        (width, ffn, heads) == (cfg.decoder_embed_dim, cfg.decoder_ffn_embed_dim,
                                cfg.decoder_attention_heads)
    assert cfg.activation_fn == "gelu" and cfg.layernorm_embedding and cfg.share_all_embeddings
    tables = [k for k in m.state_dict() if k.endswith("embed_tokens.weight")]
    assert tables == ["decoder.embed_tokens.weight"]
    assert m.encoder.embed_tokens is m.decoder.embed_tokens
