"""repro_torch's sharding spec logic against the JAX package's
(``repro.distributed.sharding``), on abstract meshes, with no process
group: every parameter leaf of the ten reduced archs, ResNet-14 and
MobileNetV2 gets the spec of its JAX counterpart (its JAX path matched by
the same rules, the JAX leaf's leading stacked axis aside); the batch and
decode-state specs; the rank's rows of a global batch in the JAX
package's microbatch order; the majority vote against JAX's under
``vmap`` with a named axis; and the mesh helpers.  Specs are compared as
tuples, exactly."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.configs import (ARCH_IDS, get_experiment,  # noqa: E402
                                 reduce_experiment)
from repro_torch.configs.paper_cnns import mobilenetv2  # noqa: E402
from repro_torch.distributed import sharding as S  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.training.train_step import init_train_state  # noqa: E402

MESHES = [((2, 4), ("data", "model")), ((4, 2), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model"))]
MODELS = ARCH_IDS + ["resnet14", "mobilenetv2"]


def _experiments(name):
    """(port experiment, JAX experiment) of a reduced arch or a CNN."""
    from repro.configs import get_experiment as jget
    from repro.configs import paper_cnns as jpaper
    from repro.configs import reduce_experiment as jreduce
    from repro.core import config as jc
    if name == "resnet14":              # SMD, SLU (its gate) and PSG on
        exp = tlaunch.experiment(14, 16, 4, 2)
        jexp = jc.Experiment(model=jpaper.cnn_model("resnet14", 14, width=16),
                             e2=jc.E2TrainConfig.full(),
                             train=jpaper.resnet74().train, task="cifar_cnn")
        return exp, jexp
    if name == "mobilenetv2":
        return mobilenetv2(), jpaper.mobilenetv2()
    return (reduce_experiment(get_experiment(name)),
            jreduce(jget(name)))


def _jax_leaves(jexp):
    """{JAX path: shape} of the JAX package's parameters."""
    import jax
    from repro.distributed.sharding import _path_str
    from repro.training.train_step import init_train_state as jinit
    state = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), jexp))
    flat, _ = jax.tree_util.tree_flatten_with_path(state.params)
    return {_path_str(p): tuple(leaf.shape) for p, leaf in flat}


@pytest.mark.parametrize("name", MODELS)
def test_param_specs_equal_the_jax_packages(name):
    from repro.distributed import sharding as J
    exp, jexp = _experiments(name)
    jleaves = _jax_leaves(jexp)
    model = init_train_state(exp, device="cpu").model
    named = dict(model.named_parameters())
    unit = getattr(model, "unit", None) or convert.lm_unit(named)
    seen = set()
    for shape, axes in MESHES:
        jm = J.make_abstract_mesh(shape, axes)
        specs = S.param_specs(named, S.AbstractMesh(shape, axes), unit=unit)
        for k, p in named.items():
            path, idx = convert.jax_path(k, unit)
            path_s = "/".join(path)
            jshape = jleaves[path_s]
            want = tuple(J._spec_for(jshape, J.logical_rules(path_s), jm,
                                     True))
            if idx is not None:         # the JAX leaf's stacked axis
                assert jshape[1:] == tuple(p.shape) and want[0] is None
                want = want[1:]
            else:
                assert jshape == tuple(p.shape), k
            assert specs[k] == want, (k, path_s, specs[k], want)
            seen.add(path_s)
    assert seen == set(jleaves)         # every JAX leaf has its port leaf
    if name == "qwen2_5_3b":            # some leaf is FSDP-sharded
        assert any(S.shard_dim(s) is not None for s in specs.values())


@pytest.mark.parametrize("shape,axes", MESHES)
def test_batch_specs_equal_the_jax_packages(shape, axes):
    from repro.distributed import sharding as J
    jm, m = J.make_abstract_mesh(shape, axes), S.AbstractMesh(shape, axes)
    batches = [
        {"tokens": np.zeros((8, 16)), "labels": np.zeros((8, 16))},
        {"image": np.zeros((8, 32, 32, 3)), "label": np.zeros((8,))},
        {"image": np.zeros((3, 8, 32, 32, 3)), "label": np.zeros((3, 8))},
        {"tokens": np.zeros((1, 16)), "labels": np.zeros((1, 16))},
    ]
    for batch in batches:
        ax = 1 if batch.get("label", np.zeros(1)).ndim == 2 else 0
        for seq in (False, True):
            got = S.batch_sharding(m, batch, seq_shard=seq, batch_axis=ax)
            want = J.batch_sharding(jm, batch, seq_shard=seq, batch_axis=ax)
            assert got == {k: tuple(v.spec) for k, v in want.items()}
    for rank in (1, 2, 4):
        got = S.batch_sharding(m, rank, shape=(8, 16, 4)[:rank])
        want = J.batch_sharding(jm, rank, shape=(8, 16, 4)[:rank])
        assert got == tuple(want.spec)


@pytest.mark.parametrize("arch", ["qwen2_5_3b", "zamba2_1_2b"])
def test_decode_state_specs_equal_the_jax_packages(arch):
    from repro.distributed import sharding as J
    from repro_torch.models.transformer import init_decode_state
    cfg = reduce_experiment(get_experiment(arch)).model
    unit = len(cfg.block_unit or ()) or 1
    tree = convert.decode_state_tree(
        init_decode_state(cfg, 4, 32, torch.float32, "cpu"), unit)
    for shape, axes in MESHES:
        got = S.decode_state_shardings(tree, S.AbstractMesh(shape, axes))
        want = J.decode_state_shardings(tree,
                                        J.make_abstract_mesh(shape, axes))
        paths = list(_tree_paths(tree))
        assert len(paths) > 2
        for p in paths:
            assert _at(got, p) == tuple(_at(want, p).spec), p


def _tree_paths(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_paths(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tree_paths(v, path + (str(i),))
    else:
        yield path


def _at(tree, path):
    for k in path:
        tree = tree[k] if isinstance(tree, dict) else tree[int(k)]
    return tree


def test_placements_and_state_shardings():
    from torch.distributed.tensor import Replicate, Shard
    exp = reduce_experiment(get_experiment("qwen2_5_3b"))
    state = init_train_state(exp, device="cpu")
    m = S.AbstractMesh((2, 1), ("data", "model"))
    pl = S.param_shardings(state.model, m)
    assert pl["embed"] == (Shard(1), Replicate())       # (tp_vocab, fsdp)
    sh = S.state_shardings(state, m)
    for k, v in state.opt.items():
        if isinstance(v, dict):
            assert sh["opt"][k] == {n: pl[n] for n in v}
    assert sh["step"] == (Replicate(), Replicate())
    assert S.placements((("pod", "data"), None),
                        S.AbstractMesh((2, 2), ("pod", "data"))) == \
        (Shard(0), Shard(0))


def test_rank_rows_follow_the_microbatch_order():
    """Rank r's part of global microbatch i is rows i B/m + r B/(m W)
    .. + B/(m W), and split_microbatches of the rank's rows gives them in
    order (the JAX package splits the global batch, then shards each)."""
    from repro_torch.training.train_step import split_microbatches
    B, m, W = 24, 3, 4
    rows = torch.arange(B)
    batch = {"x": rows[:, None].expand(B, 5).clone(), "y": rows,
             "scalar": torch.tensor(7)}
    for r in range(W):
        mine = S.rank_rows(batch, r, W, m)
        assert mine["scalar"] is batch["scalar"]
        for i, mb in enumerate(split_microbatches(
                {k: v for k, v in mine.items() if k != "scalar"}, m)):
            lo = i * B // m + r * B // (m * W)
            assert mb["y"].tolist() == list(range(lo, lo + B // (m * W)))
            assert (mb["x"][:, 0] == mb["y"]).all()
    stacked = {"y": torch.stack([rows, rows + 100])}       # chunk-stacked
    got = S.rank_rows(stacked, 1, 2, 1, batch_axis=1)["y"]
    assert got.tolist() == [list(range(12, 24)), list(range(112, 124))]
    with pytest.raises(ValueError, match="do not split"):
        S.rank_rows({"y": torch.arange(10)}, 0, 4)


def test_majority_vote_equals_the_jax_packages():
    """compress_signs and the int32 vote of majority_vote_psum (one
    process: the sum over a stacked voter axis, the collective's result)
    against the JAX package's under vmap with a named axis."""
    import jax
    import jax.numpy as jnp
    from repro.optim import majority_vote as JMV
    from repro_torch.optim import majority_vote as MV
    rs = np.random.RandomState(0)
    g = rs.normal(size=(5, 7, 3)).astype(np.float32)
    g[0, 0] = 0.0
    jsigns = JMV.compress_signs({"w": jnp.asarray(g)})
    signs = MV.compress_signs({"w": torch.from_numpy(g)})
    np.testing.assert_array_equal(signs["w"].numpy(),
                                  np.asarray(jsigns["w"]))
    assert signs["w"].dtype == torch.int8
    jvote = jax.vmap(lambda t: JMV.majority_vote_psum(t, "v"),
                     axis_name="v")(jsigns)
    total = signs["w"].to(torch.int32).sum(0)
    vote = torch.sign(total.float())
    for v in np.asarray(jvote["w"]):
        np.testing.assert_array_equal(vote.numpy(), v)


def test_hooks_are_identities_and_collectives_outside_a_mesh():
    x = torch.randn(4, 3)
    assert S.hint(x, "batch", None) is x and S.hint_batch(x) is x
    assert S.replicate(x) is x
    assert S.constrain_like_params({"a": x})["a"] is x
    assert S.ctx_mesh_axis_size("model") == 1
    m = S.AbstractMesh((2, 4), ("data", "model"))
    with S.activation_sharding(m):
        assert S.ctx_mesh_axis_size("model") == 4
        assert S.ctx_mesh_axis_size("pod") == 1
        # an abstract mesh reduces nothing: the computation is one rank's
        assert S.data_group() is None and S.data_world() == 1
        assert S.global_max(x) is x and S.global_sum(x) is x
        assert S.global_amax(x) is None
        assert torch.equal(S.global_mean(x, 0), x.mean(0))
    assert S._ACTIVE is None


def test_production_mesh_needs_its_world():
    from repro_torch.launch.mesh import make_production_mesh
    with pytest.raises(ValueError, match="256 ranks; this one has 1"):
        make_production_mesh()
    with pytest.raises(ValueError, match="512 ranks"):
        make_production_mesh(multi_pod=True)


def test_configs_carry_the_mesh_and_the_psg_flags():
    from repro.core import config as jc
    from repro_torch.core import config as tc
    assert dataclasses.asdict(tc.MeshConfig()) == \
        dataclasses.asdict(jc.MeshConfig())
    for f in ("majority_vote", "int8_gather"):
        assert getattr(tc.PSGConfig(), f) is getattr(jc.PSGConfig(), f)
    exp = reduce_experiment(get_experiment("qwen2_5_3b"))
    assert exp.mesh == tc.MeshConfig()
