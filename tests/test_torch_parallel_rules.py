"""The port's parallel layer without a process group, against JAX on the CPU.

* ``make_mesh``: the factorisation of the world size, each rank's coordinate (JAX's
  device layout) and the error on a mismatch, as JAX's ``make_mesh`` on its 8 virtual
  devices;
* the tensor-parallel / FSDP rule table: the port's ``spec_for`` against JAX's
  ``_spec_for`` on the flax shape trees of an ``s2t_transformer``, a Conformer (its
  pointwise convs and pos_proj) and the pipelined encoder, and ``param_specs`` (the port's
  parameters through ``flax_path``, in the port's layout) carried back to flax;
* JAX's refusals: BMUF beside model / FSDP / pipe / seq parallelism, the pipeline's
  incompatible features and uneven split, the seq path's window and attention dropout,
  and a batch the microbatches do not divide (the same errors and messages);
* the pipelined model on one rank (its stages in order) against JAX's on the stacked
  flax tree: forward within 1e-5 of each tensor's largest magnitude;
* ``shard_batch``'s contiguous rows, and a Trainer that leaves no mesh behind it.
"""

import jax
import numpy as np
import pytest
import torch

from s2t_tpu.config import DistributedConfig as JaxDistributedConfig
from s2t_tpu.models import s2t_transformer as jst
from s2t_tpu.parallel.mesh import make_mesh as jax_make_mesh
from s2t_tpu.parallel.tp_rules import _spec_for
from s2t_tpu.trainer import Trainer as JaxTrainer
from s2t_tpu_torch.config import BMUFConfig, DistributedConfig, OptimizationConfig
from s2t_tpu_torch.criterions.build import build_criterion
from s2t_tpu_torch.interop.from_flax import flax_to_state_dict
from s2t_tpu_torch.models import s2t_transformer as tst
from s2t_tpu_torch.parallel import context
from s2t_tpu_torch.parallel.mesh import Mesh, factor, make_mesh, shard_batch
from s2t_tpu_torch.parallel.tp_rules import _flax_layout, param_specs, spec_for
from s2t_tpu_torch.trainer import Trainer
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)

TINY = dict(vocab_size=32, encoder_layers=2, decoder_layers=1, encoder_embed_dim=32,
            decoder_embed_dim=32, encoder_ffn_embed_dim=64, decoder_ffn_embed_dim=64,
            encoder_attention_heads=4, decoder_attention_heads=4, subsampling_filter=32,
            max_target_positions=64, dropout=0.0, attention_dropout=0.0,
            activation_dropout=0.0)
CONFORMER = dict(TINY, encoder_attention_type="rel_pos", macaron_style=True,
                 use_cnn_module=True, cnn_module_kernel=5)
CRITERION = ("label_smoothed_cross_entropy_with_ctc", {"ctc": {"ctc_weight": 0.3}})
MESHES = [dict(), dict(model_parallel=2), dict(model_parallel=2, seq_parallel=2),
          dict(pipeline_parallel=2), dict(data_parallel=2, model_parallel=2, seq_parallel=2),
          dict(data_parallel=1, model_parallel=4, pipeline_parallel=2)]


def batch(B=4, T=48, U=6, seed=0):
    rng = np.random.default_rng(seed)
    target = rng.integers(4, 32, size=(B, U)).astype(np.int32)
    target[:, -1] = 2
    return {"features": rng.normal(size=(B, T, 80)).astype(np.float32),
            "feat_lengths": np.array([48, 40, 33, 21, 17, 9, 5, 3], np.int32)[:B],
            "prev_tokens": np.roll(target, 1, axis=1), "target": target}


@pytest.mark.parametrize("kw", MESHES)
def test_make_mesh_factors_the_world_as_jax(kw):
    jmesh = jax_make_mesh(JaxDistributedConfig(**kw), devices=jax.devices()[:8])
    shape = factor(DistributedConfig(**kw), 8)
    assert shape == dict(jmesh.shape)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for rank in range(8):  # rank r sits where JAX puts device r
        coords = Mesh(shape, rank).coords
        assert ids[tuple(coords[a] for a in ("data", "model", "seq", "pipe"))] == rank
    assert make_mesh(DistributedConfig(**kw), world_size=8).shape == shape


def test_make_mesh_mismatch_raises_as_jax():
    kw = dict(data_parallel=3)
    with pytest.raises(ValueError) as want:
        jax_make_mesh(JaxDistributedConfig(**kw), devices=jax.devices()[:8])
    with pytest.raises(ValueError) as got:
        factor(DistributedConfig(**kw), 8)
    assert str(got.value) == str(want.value)
    assert make_mesh().world_size == 1  # no process group: one process


def _shape_tree(jm):
    b = batch()
    return jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), b["features"],
                                          b["feat_lengths"], b["prev_tokens"]))["params"]


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), tuple(v.shape)


@pytest.mark.parametrize("model_kw,mesh_kw,tp,fsdp", [
    (TINY, dict(data_parallel=2, model_parallel=2, pipeline_parallel=2), True, True),
    (TINY, dict(data_parallel=4, model_parallel=2), True, False),
    (TINY, dict(data_parallel=8), False, True),
    (CONFORMER, dict(data_parallel=2, model_parallel=4), True, True),
    (dict(TINY, pipeline_parallel=2), dict(data_parallel=2, model_parallel=2,
                                           pipeline_parallel=2), True, True),
], ids=["tiny-tp-fsdp", "tiny-tp", "tiny-fsdp", "conformer", "pipelined"])
def test_rule_table_matches_jax_spec_for(model_kw, mesh_kw, tp, fsdp):
    jmesh = jax_make_mesh(JaxDistributedConfig(**mesh_kw), devices=jax.devices()[:8])
    sizes = dict(jmesh.shape)
    shapes = _shape_tree(jst.S2TTransformerModel(jst.s2t_transformer_s(**model_kw)))
    sharded = 0
    want_by_path = {}
    for path, shape in _leaves(shapes):
        want = tuple(_spec_for(path, shape, jmesh, tp, fsdp))
        want = want + (None,) * (len(shape) - len(want))
        assert spec_for(path, shape, sizes, tp, fsdp) == want, path
        want_by_path[path] = want
        sharded += any(a is not None for a in want)
    assert sharded > 0
    # the port's parameters: their specs in the port's layout, carried back to flax
    model = tst.S2TTransformerModel(tst.s2t_transformer_s(**model_kw), device="cpu")
    specs = param_specs(model, sizes, tp, fsdp)
    for name, p in model.named_parameters():
        path, fshape, perm = _flax_layout(name, tuple(p.shape), False)
        want = want_by_path[path]
        if "pipe_stages" in path:  # the port holds one stage of the stacked leaf
            want = want[1:]
        assert tuple(specs[name][perm[j]] for j in range(len(perm))) == want, name


def test_bmuf_refuses_what_jax_refuses():
    model = tst.S2TTransformerModel(tst.s2t_transformer_s(**TINY), device="cpu",
                                    for_training=True)
    jm = jst.S2TTransformerModel(jst.s2t_transformer_s(**TINY))
    from s2t_tpu.config import BMUFConfig as JaxBMUFConfig
    from s2t_tpu.config import OptimizationConfig as JaxOptimizationConfig
    from s2t_tpu.criterions.build import build_criterion as jax_build_criterion

    for kw in (dict(model_parallel=2), dict(data_parallel=2, fsdp=True),
               dict(pipeline_parallel=2), dict(seq_parallel=2)):
        with pytest.raises(ValueError) as want:
            jcfg = JaxDistributedConfig(**kw)
            JaxTrainer(jm, jax_build_criterion(*CRITERION), JaxOptimizationConfig(),
                       mesh=jax_make_mesh(jcfg, devices=jax.devices()[:2]), dist_cfg=jcfg,
                       bmuf_cfg=JaxBMUFConfig(active=True))
        with pytest.raises(ValueError) as got:
            cfg = DistributedConfig(**kw)
            Trainer(model, build_criterion(*CRITERION), OptimizationConfig(), device="cpu",
                    mesh=make_mesh(cfg, world_size=2), dist_cfg=cfg,
                    bmuf_cfg=BMUFConfig(active=True))
        assert str(got.value) == str(want.value)


REFUSED = {
    "pipe_dlcl": dict(pipeline_parallel=2, use_enc_dlcl=True),
    "pipe_layerdrop": dict(pipeline_parallel=2, encoder_layerdrop=0.1),
    "pipe_seq": dict(pipeline_parallel=2, seq_parallel=True),
    "pipe_inter_ctc": dict(pipeline_parallel=2, inter_ctc_layers=(1,)),
    "pipe_layer_out_norm": dict(pipeline_parallel=2, layer_out_norm=True),
    "pipe_lconv_kernels": dict(pipeline_parallel=2, encoder_attention_type="light",
                               encoder_lconv_kernels=(3, 5)),
    "pipe_uneven": dict(pipeline_parallel=2, encoder_layers=3),
    "seq_window": dict(seq_parallel=True, encoder_attention_window=4),
    "seq_attention_dropout": dict(seq_parallel=True, attention_dropout=0.1),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_parallel_layouts_refuse_what_jax_refuses(case):
    kw = {**TINY, **REFUSED[case]}
    with pytest.raises(ValueError) as want:
        _shape_tree(jst.S2TTransformerModel(jst.s2t_transformer_s(**kw)))
    with pytest.raises(ValueError) as got:
        tst.S2TTransformerModel(tst.s2t_transformer_s(**kw), device="cpu")
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def pipelined_pair():
    kw = dict(TINY, pipeline_parallel=2)
    tm = tst.S2TTransformerModel(tst.s2t_transformer_s(**kw), device="cpu", seed=2)
    jm = jst.S2TTransformerModel(jst.s2t_transformer_s(**kw))
    from s2t_tpu_torch.interop.from_flax import state_dict_to_flax

    params = state_dict_to_flax(tm.state_dict())
    assert jax.tree.map(np.shape, params) == jax.tree.map(lambda s: s.shape, _shape_tree(jm))
    sd = flax_to_state_dict(params)  # the stacked leaves back to one module a stage
    assert all(torch.equal(sd[k], v) for k, v in tm.state_dict().items())
    return jm, params, tm


def test_pipelined_model_on_one_rank_matches_jax(pipelined_pair):
    jm, params, tm = pipelined_pair
    b = batch()
    ref = jax.jit(lambda p: jm.apply({"params": p}, b["features"], b["feat_lengths"],
                                     b["prev_tokens"]))(params)
    with torch.no_grad():
        out = tm(torch.from_numpy(b["features"]), torch.from_numpy(b["feat_lengths"]).long(),
                 torch.from_numpy(b["prev_tokens"]).long())
    for key in ("encoder_out", "ctc_logits", "decoder_logits"):
        want = np.asarray(ref[key])
        np.testing.assert_allclose(out[key].numpy(), want,
                                   atol=1e-5 * max(1.0, np.abs(want).max()), err_msg=key)
    assert len(tm.encoder.pipe_stages) == 2 and len(tm.encoder.layers) == 0


def test_pipelined_batch_must_divide_into_microbatches(pipelined_pair):
    jm, params, tm = pipelined_pair
    b = batch(B=6)  # M = 2 S = 4 microbatches
    with pytest.raises(ValueError) as want:
        jm.apply({"params": params}, b["features"], b["feat_lengths"], b["prev_tokens"])
    with pytest.raises(ValueError) as got:
        tm(torch.from_numpy(b["features"]), torch.from_numpy(b["feat_lengths"]).long(),
           torch.from_numpy(b["prev_tokens"]).long())
    assert str(got.value) == str(want.value)


def test_shard_batch_keeps_each_data_rank_its_contiguous_rows():
    b = {k: torch.as_tensor(v) for k, v in batch(B=8).items()}
    b["ntokens"] = torch.tensor(48.0)
    shape = factor(DistributedConfig(data_parallel=4, model_parallel=2), 8)
    for rank in range(8):
        mesh = Mesh(shape, rank)
        part = shard_batch(b, mesh)
        d = mesh.index("data")
        assert torch.equal(part["features"], b["features"][2 * d:2 * d + 2])
        assert part["ntokens"] is b["ntokens"]  # scalars stay whole
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch({"x": torch.zeros(6)}, Mesh(factor(DistributedConfig(data_parallel=4), 4), 1))


def test_trainer_leaves_no_mesh_behind():
    model = tst.S2TTransformerModel(tst.s2t_transformer_s(**TINY), device="cpu",
                                    for_training=True)
    trainer = Trainer(model, build_criterion(*CRITERION), OptimizationConfig(), device="cpu")
    seen = []
    forward = trainer.forward_fn
    trainer.forward_fn = lambda *a, **k: (seen.append(context.get_mesh()), forward(*a, **k))[1]
    trainer.train_step(batch())
    assert seen == [trainer.mesh] and context.get_mesh() is None
    with pytest.raises(RuntimeError):
        with context.use_mesh(trainer.mesh):
            raise RuntimeError
    assert context.get_mesh() is None
