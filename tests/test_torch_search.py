"""The port's search options against the JAX generator on the CPU.

A tiny s2t_transformer (2 + 2 layers, d=64, 4 heads, vocab 32, untied output)
is initialised by flax and carried across with ``from_flax``.  For prefix
forcing, diverse beam groups, diverse siblings, sampling (top-k, top-p and
plain, on the same handed-over uniforms), ordered and unordered constraints,
the int8 KV cache and renamed input keys, the tokens must equal JAX's and the scores agree at
1e-5 (sums of the same float32 log-probs).  Without handed-over uniforms,
sampling draws from a ``torch.Generator`` seeded by ``sampling_seed``: its bits
differ from JAX's by design.  Diverse search and sampling have no fairseq
reference here (tests/test_decode_parity.py is red), so they are held to JAX
only.  The KV-cache modes' own tests are tests/test_torch_kv_cache.py.
"""

import jax
import numpy as np
import pytest
import torch

from s2t_tpu.inference.constrained import pack_constraints as jax_pack_constraints
from s2t_tpu.inference.generator import SequenceGenerator as JaxGenerator
from s2t_tpu.models import s2t_transformer as jst
from s2t_tpu_torch.inference.constrained import pack_constraints
from s2t_tpu_torch.inference.generator import SequenceGenerator
from s2t_tpu_torch.interop.from_flax import load_flax_params
from s2t_tpu_torch.models import s2t_transformer as tst
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

SCORE_ATOL = 1e-5
TINY = dict(
    vocab_size=32, encoder_layers=2, decoder_layers=2, encoder_embed_dim=64,
    decoder_embed_dim=64, encoder_ffn_embed_dim=128, decoder_ffn_embed_dim=128,
    encoder_attention_heads=4, decoder_attention_heads=4, subsampling_filter=64,
    max_target_positions=64, dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
    share_decoder_input_output_embed=False,
)
VARIANTS = {"abs": {}, "relative": dict(max_decoder_relative_length=4)}
K, MAX_LEN = 3, 12
NOISE = np.random.default_rng(5).uniform(size=(MAX_LEN, 4 * K)).astype(np.float32)
CONSTRAINTS = [[[5, 6]], [[7], [9, 10]], [[11, 12, 13]], []]


def make_batch(B=4, T=60, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, T, 80)).astype(np.float32)
    lens = np.array([60, 45, 31, 1][:B], np.int32)
    prev = rng.integers(3, 32, size=(B, 7)).astype(np.int32)
    return feats, lens, prev


def build_pair(variant="abs", seed=0, torch_seed=1):
    kw = {**TINY, **VARIANTS[variant]}
    jm = jst.S2TTransformerModel(jst.s2t_transformer_s(**kw))
    feats, lens, prev = make_batch()
    params = jax.tree.map(np.asarray,
                          jax.jit(jm.init)(jax.random.PRNGKey(seed), feats, lens, prev)["params"])
    tm = tst.S2TTransformerModel(tst.s2t_transformer_s(**kw), device="cpu", seed=torch_seed)
    return jm, params, load_flax_params(tm, params)


@pytest.fixture(scope="module")
def pairs():
    return {}


def pair(pairs, variant="abs"):
    if variant not in pairs:
        pairs[variant] = build_pair(variant)
    return pairs[variant]


OPTIONS = {
    "prefix": dict(prefix_size=2),
    "diverse_groups": dict(beam_size=4, diverse_beam_groups=2, diverse_beam_strength=0.7),
    "diverse_siblings": dict(diversity_rate=0.5),
    "sampling_topk": dict(sampling=True, sampling_topk=5, sampling_noise=NOISE),
    "sampling_topp": dict(sampling=True, sampling_topp=0.8, sampling_noise=NOISE),
    "sampling": dict(sampling=True, sampling_noise=NOISE, temperature=1.3),
    "constraints_ordered": dict(constraints_mode="ordered"),
    "constraints_unordered": dict(constraints_mode="unordered"),
    "int8": dict(kv_cache_dtype="int8"),
    "input_keys": dict(input_keys=("fbank", "frames")),
}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_option_tokens_identical_to_jax(pairs, option):
    jm, params, tm = pair(pairs)
    feats, lens, prev = make_batch()
    batch = {"features": feats, "feat_lengths": lens, "target": prev}
    if option == "input_keys":
        batch = {"fbank": feats, "frames": lens}
    jbatch = dict(batch)
    if option.startswith("constraints"):
        batch["constraints"] = pack_constraints(CONSTRAINTS)
        jbatch["constraints"] = jax_pack_constraints(CONSTRAINTS)
        np.testing.assert_array_equal(batch["constraints"], jbatch["constraints"])
    kw = {"beam_size": K, "max_len_b": MAX_LEN, **OPTIONS[option]}
    jt, js, _ = JaxGenerator(jm, **kw).generate(params, jbatch)
    tt, ts, _ = SequenceGenerator(tm, **kw).generate(batch)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=SCORE_ATOL, atol=SCORE_ATOL)
    if option == "prefix":
        np.testing.assert_array_equal(tt.numpy()[:, :, :2], np.repeat(prev[:, None, :2], K, 1))
    if option.startswith("constraints"):
        for b, phrases in enumerate(CONSTRAINTS):
            hyp = tt.numpy()[b, 0].tolist()
            for p in phrases:
                assert any(hyp[s:s + len(p)] == p for s in range(len(hyp))), (b, p, hyp)


def test_sampling_draws_from_the_seeded_generator(pairs):
    _, _, tm = pair(pairs)
    feats, lens, _ = make_batch()
    batch = {"features": feats, "feat_lengths": lens}

    def draw(seed):
        return SequenceGenerator(tm, beam_size=K, max_len_b=MAX_LEN, sampling=True,
                                 sampling_topk=8, sampling_seed=seed).generate(batch)

    (a, sa, _), (b, _, _), (c, _, _) = draw(0), draw(0), draw(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert ((a == 2).sum(dim=-1) == 1).all()  # every sample ends with one EOS
    assert (sa[:, :-1] >= sa[:, 1:]).all()  # best first


def test_chip_smoke_carries_the_ctc_rescore_recipe():
    """chip_smoke.py phase 30 decodes with ctc_rescore.yaml over its basis.yaml (the card
    has no yaml reader): its copies of their generation and dataset sections."""
    import chip_smoke
    from s2t_tpu_torch.config import load_yaml_stack

    conf = load_yaml_stack(["egs/mustc/st/conf/basis.yaml", "egs/mustc/st/conf/ctc_rescore.yaml"])
    assert conf["generation"] == chip_smoke.CTC_RESCORE_GENERATION
    assert conf["dataset"] == chip_smoke.MUSTC_ST_DATASET
