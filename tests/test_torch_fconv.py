"""ConvS2S (``fconv``) and the ``fixed`` scheduler against the JAX package.

A tiny model (embed 16; convs 16/3, 16/3, 24/3 (a residual projection), 24/1
(a window of width 0) on both sides; source vocab 19, target vocab 23, dropout 0)
initialised by flax, perturbed so every leaf counts, carried across by
``from_flax``; 3 padded source rows and teacher-forced targets from a numpy seed:

* the encoder's packed (B, T, 2E) output and the decoder logits within 1e-5 of
  each tensor's largest magnitude, with and without tied output embeddings;
* the label-smoothed CE loss at rtol 1e-4 and every gradient within 1e-4 of its
  largest entry;
* the incremental decoder's step logits and windows against JAX's ``step``;
* beam-5 tokens identical (the rolling windows follow the beam) without a k = 1
  layer, whose width-0 window JAX's beam cannot gather (the port decodes it), and
  the cache reorder's rule: windows gather whole, an unknown leaf raises;
* ``from_flax`` both ways keeps the tree; ``fixed`` at its edge steps;
* ``fconv.yaml``'s optimisation (Adam at lr 0.5 under ``fixed``, clip 0.1) at
  ``fconv_wmt_en_de``'s widths cut to one conv of each width a side: both
  trainers take the same first step, and both losses explode after it.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2t_tpu.criterions.build import build_criterion as jax_build_criterion
from s2t_tpu.inference.generator import SequenceGenerator as JaxGenerator
from s2t_tpu.models import fconv as jf
from s2t_tpu.optim.builders import fixed as jax_fixed
from s2t_tpu.config import OptimizationConfig as JaxOptimizationConfig
from s2t_tpu.parallel.mesh import make_mesh
from s2t_tpu.trainer import Trainer as JaxTrainer
from s2t_tpu_torch.config import OptimizationConfig
from s2t_tpu_torch.criterions.build import build_criterion
from s2t_tpu_torch.inference.beam_search import reorder_cache
from s2t_tpu_torch.inference.generator import SequenceGenerator
from s2t_tpu_torch.interop.from_flax import load_flax_params, state_dict_to_flax
from s2t_tpu_torch.models import fconv as tf
from s2t_tpu_torch.models.build import build_model
from s2t_tpu_torch.models.transformer import text_forward
from s2t_tpu_torch.optim.builders import build_lr_schedule
from s2t_tpu_torch.trainer import Trainer
from tests.test_torch_train_trainer import flat, on_mesh
from tests.test_torch_wav2vec2 import assert_close, perturb
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

CONVS = ((16, 3), (16, 3), (24, 3), (24, 1))
TINY = dict(encoder_embed_dim=16, encoder_convs=CONVS, decoder_embed_dim=16,
            decoder_convs=CONVS, decoder_out_embed_dim=12, dropout=0.0, vocab_size=23,
            src_vocab_size=19, max_source_positions=64, max_target_positions=64)
# the tied case has no k = 1 layer: JAX's beam cannot gather a width-0 window
CASES = {"untied": {}, "tied": dict(share_decoder_input_output_embed=True, decoder_out_embed_dim=16,
                                    encoder_convs=((16, 3), (24, 5)),
                                    decoder_convs=((16, 3), (16, 5), (24, 3)))}
LENGTHS = np.array([7, 5, 2], np.int32)


def batch(seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(4, 19, size=(3, 7)).astype(np.int32)
    for b, n in enumerate(LENGTHS):
        src[b, n - 1] = 2
        src[b, n:] = 1
    target = rng.integers(4, 23, size=(3, 5)).astype(np.int32)
    target[:, -1] = 2
    target[2, 2] = 2
    target[2, 3:] = 1
    prev = np.concatenate([np.full((3, 1), 2, np.int32), target[:, :-1]], axis=1)
    prev[2, 3:] = 1
    return src, prev, target


def make_pair(**kw):
    src, prev, _ = batch()
    jm = jf.FConvModel(jf.FConvConfig(**{**TINY, **kw}))
    params = jm.init(jax.random.PRNGKey(0), src, LENGTHS, prev)["params"]
    params = perturb(jax.tree.map(np.asarray, params))
    tm = load_flax_params(tf.FConvModel(tf.FConvConfig(**{**TINY, **kw}), device="cpu",
                                        for_training=True), params)
    return jm, params, tm


@pytest.fixture(scope="module")
def pairs():
    return {}


def get_pair(pairs, case):
    if case not in pairs:
        pairs[case] = make_pair(**CASES[case])
    return pairs[case]


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(pairs, case):
    jm, params, tm = get_pair(pairs, case)
    src, prev, _ = batch()
    want = jm.apply({"params": params}, src, LENGTHS, prev)
    with torch.no_grad():
        got = tm(torch.from_numpy(src), torch.from_numpy(LENGTHS), torch.from_numpy(prev).long())
    assert got["encoder_out"].shape == (3, 7, 32)
    np.testing.assert_array_equal(got["encoder_lengths"].numpy(), LENGTHS)
    for key in ("encoder_out", "decoder_logits"):
        assert_close(got[key].numpy(), want[key], f"{key}, 1e-5")


def test_loss_and_gradients_match_jax(pairs):
    jm, params, tm = get_pair(pairs, "untied")
    src, prev, target = batch(1)
    crit = ("label_smoothed_cross_entropy", {"label_smoothing": 0.1})
    jcrit = jax_build_criterion(*crit)

    def jax_loss(p):
        loss, size, _ = jcrit(jm.apply({"params": p}, src, LENGTHS, prev), {"target": target})
        return loss, size

    with jax.default_matmul_precision("highest"):
        (jloss, jsize), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    tm.zero_grad()
    out = tm(torch.from_numpy(src), torch.from_numpy(LENGTHS), torch.from_numpy(prev).long(),
             train=True, generator=torch.Generator().manual_seed(0))
    loss, size, _ = build_criterion(*crit)(out, {"target": torch.from_numpy(target).long()})
    loss.backward()
    assert size.item() == float(jsize)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4, err_msg="loss, rtol 1e-4")
    got = dict(flat(state_dict_to_flax({n: p.grad for n, p in tm.named_parameters()})))
    want = dict(flat(jax.tree.map(np.asarray, jgrads)))
    assert set(got) == set(want)
    for k in want:
        assert_close(got[k], want[k], f"{k}, 1e-4", tol=1e-4)


def test_step_logits_and_windows_match_jax(pairs):
    """Three incremental steps against JAX's ``step``; the k = 1 layer's window has width 0."""
    jm, params, tm = get_pair(pairs, "untied")
    src, prev, _ = batch()
    enc = jm.apply({"params": params}, src, LENGTHS, method=jm.encode)
    mask = src != 1
    jcache = jm.apply({"params": params}, 3, 8, method=jm.init_cache)
    tm.eval()
    with torch.no_grad():
        tenc = tm.encode(torch.from_numpy(src), torch.from_numpy(LENGTHS))
        cache = tm.init_cache(3, 8)
        assert cache["conv3"].shape == (3, 0, 24)
        for i in range(3):
            tok = prev[:, i:i + 1]
            want, jcache = jm.apply({"params": params}, jnp.asarray(tok), jcache, i,
                                    enc["encoder_out"], mask, method=jm.decode_step)
            got, cache = tm.decode_step(torch.from_numpy(tok).long(), cache, i,
                                        tenc["encoder_out"], torch.from_numpy(mask))
            assert_close(got.numpy(), want, f"step {i} logits, 1e-5")
            for name in jcache:
                assert cache[name].shape == jcache[name].shape, name
                if jcache[name].size:
                    assert_close(cache[name].numpy(), jcache[name], f"step {i} {name}, 1e-5")


def beam5(jm, params, tm, seed=2):
    src, _, _ = batch(seed)
    kw = dict(beam_size=5, max_len_b=8, input_keys=("src_tokens", "src_lengths"))
    tm.eval()
    got, _, _ = SequenceGenerator(tm, **kw).generate({"src_tokens": src,
                                                      "src_lengths": LENGTHS})
    return got, lambda: JaxGenerator(jm, **kw).generate(
        params, {"src_tokens": jnp.asarray(src), "src_lengths": jnp.asarray(LENGTHS)})[0]


def test_beam5_tokens_match_jax(pairs):
    got, want = beam5(*get_pair(pairs, "tied"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want()))


def test_beam5_decodes_width0_windows_where_jax_fails(pairs):
    """A k = 1 layer's window has width 0 (fconv_wmt_en_de's last two layers): the
    port's beam gathers it whole; JAX's ``_gather_beams`` reshapes it by -1 and fails."""
    got, want = beam5(*get_pair(pairs, "untied"))
    assert got.shape[:2] == (3, 5) and (got[:, 0, 0] != 1).all()
    with pytest.raises(ZeroDivisionError):
        want()


def test_reorder_cache_gathers_windows_whole_and_raises_on_unknown_leaves():
    win = torch.arange(4 * 2 * 3, dtype=torch.float32).reshape(4, 2, 3)
    empty = torch.zeros(4, 0, 3)
    kv = torch.arange(4 * 5, dtype=torch.float32).reshape(4, 5, 1, 1)
    cache = {"conv0": win.clone(), "conv1": empty, "layer0": {"k": kv.clone(), "v": kv.clone()}}
    rows = torch.tensor([2, 2, 0, 3])
    reorder_cache(cache, rows, 3)
    torch.testing.assert_close(cache["conv0"], win[rows])
    torch.testing.assert_close(cache["layer0"]["k"][:, :3], kv[rows, :3])
    torch.testing.assert_close(cache["layer0"]["k"][:, 3:], kv[:, 3:])
    for bad in ("convx", "window", "conv"):
        with pytest.raises(KeyError, match=bad):
            reorder_cache({bad: win.clone()}, rows, 3)


def test_from_flax_round_trip_keeps_the_tree(pairs):
    _, params, tm = get_pair(pairs, "untied")
    back = state_dict_to_flax(tm.state_dict())
    want = dict(flat(params))
    got = dict(flat(back))
    assert set(got) == set(want)
    assert "res2" in params["encoder"] and "res1" not in params["encoder"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_presets_and_seeded_init():
    m = build_model("fconv_wmt_en_de", {"encoder_convs": ((512, 3), (2048, 1)),
                                        "decoder_convs": ((512, 3), (2048, 1))},
                    device="cpu", for_training=True, vocab_size=50, src_vocab_size=40)
    assert m.cfg.encoder_embed_dim == 768 and m.cfg.decoder_out_embed_dim == 512
    assert set(m.encoder.ress) == {"1"}
    assert abs(m.encoder.embed_tokens.weight.std().item() - 0.1) < 0.02
    assert build_model("fconv_iwslt_de_en", device="cpu").cfg.decoder_convs == ((256, 3),) * 3


@pytest.mark.parametrize("step", [0, 1, 7, 1000])
def test_fixed_schedule_matches_optax(step):
    kw = dict(lr=0.5, lr_scheduler="fixed", warmup_updates=4, max_update=10)
    want = float(jax_fixed(JaxOptimizationConfig(**kw))(step))
    assert float(build_lr_schedule(OptimizationConfig(**kw))(torch.tensor(step))) == want


def text_batch(rng, B=2, T=16, V=1000):
    src = rng.integers(4, V, size=(B, T)).astype(np.int32)
    tgt = rng.integers(4, V, size=(B, T)).astype(np.int32)
    src[:, -1] = tgt[:, -1] = 2
    prev = np.concatenate([np.full((B, 1), 2, np.int32), tgt[:, :-1]], axis=1)
    return {"src_tokens": src, "src_lengths": np.full((B,), T, np.int32), "prev_tokens": prev,
            "target": tgt, "target_lengths": np.full((B,), T, np.int32),
            "ntokens": np.float32(B * T)}


def test_the_recipes_lr_explodes_after_one_update_in_jax_and_the_port():
    V = 1000
    convs = ((512, 3), (1024, 3), (2048, 1))  # fconv_wmt_en_de's widths, one conv of each
    kw = dict(encoder_embed_dim=768, encoder_convs=convs, decoder_embed_dim=768,
              decoder_convs=convs, decoder_out_embed_dim=512, dropout=0.0, vocab_size=V,
              src_vocab_size=V, max_source_positions=64, max_target_positions=64)
    opt = dict(lr=0.5, lr_scheduler="fixed", clip_norm=0.1)  # egs/wmt16/mt/conf/fconv.yaml
    crit = ("label_smoothed_cross_entropy", {"label_smoothing": 0.1})
    rng = np.random.default_rng(5)
    steps = [text_batch(rng, V=V) for _ in range(2)]

    def jax_forward(model, params, b, deterministic, rngs=None):
        args = (b["src_tokens"], b["src_lengths"], b["prev_tokens"])
        if params is None:
            return model.init(rngs["params"], *args)
        return model.apply({"params": params}, *args, deterministic=deterministic, rngs=rngs)

    mesh = make_mesh(devices=jax.devices()[:1])
    jt = JaxTrainer(jf.FConvModel(jf.FConvConfig(**kw)), jax_build_criterion(*crit),
                    JaxOptimizationConfig(**opt), mesh=mesh, forward_fn=jax_forward)
    state = on_mesh(jt.init_state(steps[0]), mesh)
    tm = load_flax_params(tf.FConvModel(tf.FConvConfig(**kw), device="cpu", for_training=True),
                          jax.tree.map(np.asarray, state.params))
    tt = Trainer(tm, build_criterion(*crit), OptimizationConfig(**opt), device="cpu",
                 forward_fn=text_forward)
    losses = []
    for b in steps:
        with jax.default_matmul_precision("highest"):
            state, jmet = jt.train_step(state, b)
        m = tt.train_step(b)
        # JAX logs the summed loss, the port the per-token one
        losses.append((float(jmet["loss"]) / float(b["ntokens"]), float(m["loss"])))
        if len(losses) == 1:
            np.testing.assert_allclose(losses[0][1], losses[0][0], rtol=1e-4)
            np.testing.assert_allclose(float(m["gnorm"]), float(jmet["gnorm"]), rtol=1e-4)
    first = losses[0][0]
    assert 5.0 < first < 10.0
    # every weight moves by about lr in Adam's first update: both losses leave any
    # trained range (on the card, at full depth, they overflow to NaN)
    for loss in losses[1]:
        assert not math.isfinite(loss) or loss > 1e6 * first, losses
