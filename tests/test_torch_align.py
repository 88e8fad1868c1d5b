"""``transformer_align`` and ``label_smoothed_cross_entropy_with_alignment`` against
the JAX package.

A whitespace corpus with seeded Pharaoh alignments (``tests/test_torch_translation.py``'s
words), ``load_alignments`` on; a tiny model (2 + 2 layers of 16, 2 heads) from one
flax init through the translation task's forward adapter:

* the alignment batches equal JAX's;
* ``align_attn`` (layer -1 with one head, layer 0 averaged over two) within 1e-5 of
  JAX's sown cross-attention, the decoder logits too;
* the loss, ``alignment_loss`` and the sample size at rtol 1e-4, every gradient
  within 1e-4 of its largest entry;
* an alignment layer outside the decoder raises; beam-2 tokens equal JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2t_tpu.config import TrainConfig as JaxTrainConfig
from s2t_tpu.config import from_dict as jax_from_dict
from s2t_tpu.tasks import setup_task as jax_setup_task
from s2t_tpu_torch.config import TrainConfig, from_dict
from s2t_tpu_torch.interop.from_flax import load_flax_params, state_dict_to_flax
from s2t_tpu_torch.models.build import build_model
from s2t_tpu_torch.tasks import setup_task
from tests.test_torch_train_trainer import flat
from tests.test_torch_translation import assert_batches_equal, cfg_dict, write_corpus
from tests.test_torch_wav2vec2 import assert_close, perturb
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

CASES = {"last_layer": dict(alignment_layer=-1, alignment_heads=1),
         "first_layer_two_heads": dict(alignment_layer=0, alignment_heads=2)}


def write_aligned(root, n_train=16):
    root = write_corpus(root, n_train=n_train)
    rng = np.random.default_rng(9)
    for split in ("train", "dev", "test"):
        lines = []
        for src, tgt in zip((root / f"{split}.en").read_text().splitlines(),
                            (root / f"{split}.de").read_text().splitlines()):
            S, U = len(src.split()), len(tgt.split())
            lines.append(" ".join(f"{rng.integers(0, S)}-{rng.integers(0, U)}"
                                  for _ in range(int(rng.integers(0, 4)))))
        (root / f"{split}.align").write_text("\n".join(lines) + "\n")
    return root


def align_dict(root, case):
    d = cfg_dict(root, arch="transformer_align",
                 criterion="label_smoothed_cross_entropy_with_alignment",
                 criterion_cfg={"label_smoothing": 0.1, "alignment_lambda": 0.5},
                 task_cfg={"load_alignments": True}, eval={"eval_bleu": False})
    d["model"].update(encoder_layers=2, decoder_layers=2, **CASES[case])
    return d


@pytest.fixture(scope="module")
def setups(tmp_path_factory):
    root = write_aligned(tmp_path_factory.mktemp("align"))
    out = {}
    for case in CASES:
        d = align_dict(root, case)
        task, jtask = setup_task(from_dict(TrainConfig, d)), jax_setup_task(
            jax_from_dict(JaxTrainConfig, d))
        batch = next(iter(task.get_batch_iterator(task.load_dataset("train"), seed=3)
                          .next_epoch_itr()))
        jbatch = {k: np.asarray(v) for k, v in batch.items() if k not in ("ids", "nsentences")}
        jm, jfwd = jtask.build_model(), jtask.forward_fn()
        params = jfwd(jm, None, jbatch, True, {"params": jax.random.PRNGKey(0)})["params"]
        params = perturb(jax.tree.map(np.asarray, params))
        tm = load_flax_params(task.build_model(device="cpu", for_training=True), params)
        out[case] = (task, jtask, jm, jfwd, params, tm, jbatch)
    return out


def test_alignment_batches_match_jax(setups):
    task, jtask = setups["last_layer"][:2]
    assert_batches_equal(task, jtask, "train")


@pytest.mark.parametrize("case", list(CASES))
def test_align_attn_matches_jax(setups, case):
    task, _, jm, jfwd, params, tm, jbatch = setups[case]
    want = jfwd(jm, params, jbatch, True)
    with torch.no_grad():
        got = task.forward_fn()(tm, {k: torch.as_tensor(v) for k, v in jbatch.items()})
    B, U = jbatch["prev_tokens"].shape
    assert got["align_attn"].shape == (B, U, jbatch["src_tokens"].shape[1])
    for key in ("align_attn", "decoder_logits"):
        assert_close(got[key].numpy(), want[key], f"{key}, 1e-5")


@pytest.mark.parametrize("case", list(CASES))
def test_loss_alignment_loss_and_gradients_match_jax(setups, case):
    task, jtask, jm, jfwd, params, tm, jbatch = setups[case]
    jcrit = jtask.build_criterion()

    def jax_loss(p):
        loss, size, logs = jcrit(jfwd(jm, p, jbatch, True), jbatch)
        return loss, (size, logs["alignment_loss"])

    with jax.default_matmul_precision("highest"):
        (jloss, (jsize, jalign)), jgrads = jax.jit(
            jax.value_and_grad(jax_loss, has_aux=True))(params)
    tbatch = {k: torch.as_tensor(v) for k, v in jbatch.items()}
    tm.zero_grad()
    out = task.forward_fn()(tm, tbatch, train=True, generator=torch.Generator().manual_seed(0))
    loss, size, logs = task.build_criterion()(out, tbatch)
    loss.backward()
    assert (jbatch["alignments"][..., 0] >= 0).any()
    assert size.item() == float(jsize)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4, err_msg="loss, rtol 1e-4")
    np.testing.assert_allclose(logs["alignment_loss"].item(), float(jalign), rtol=1e-4)
    got = dict(flat(state_dict_to_flax({n: p.grad for n, p in tm.named_parameters()})))
    want = dict(flat(jax.tree.map(np.asarray, jgrads)))
    assert set(got) == set(want)
    for k in want:
        assert_close(got[k], want[k], f"{k}, 1e-4", tol=1e-4)


def test_alignment_layer_outside_the_decoder_raises():
    with pytest.raises(ValueError, match="alignment_layer 4"):
        build_model("transformer_align", {"decoder_layers": 2, "alignment_layer": 4},
                    device="cpu")
    m = build_model("transformer_wmt_en_de_big_align", {"encoder_layers": 1}, device="cpu",
                    vocab_size=20)
    assert m.align_layer == 4 and m.cfg.decoder_embed_dim == 1024


def test_beam2_tokens_match_jax(setups):
    task, jtask, jm, _, params, tm, jbatch = setups["last_layer"]
    src = {"src_tokens": jbatch["src_tokens"], "src_lengths": jbatch["src_lengths"]}
    want, _, _ = jtask.build_generator(jm).generate(
        params, {k: jnp.asarray(v) for k, v in src.items()})
    tm.eval()
    got, _, _ = task.build_generator(tm).generate(src)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
