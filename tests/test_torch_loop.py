"""repro_torch's chunked loop (``training/loop.py``, the chunked mode of
``training/trainer.py``) against the per-step loop and against the JAX
package's loop pieces, on the CPU.

The JAX package's contract (``tests/test_loop.py``): the chunked loop (K=4)
equals the per-step loop bit for bit on the loss curve, ``state.step``, the
executed and dropped counts and the final parameters, for both tasks, also
across a resume at a chunk boundary.  On the CPU a chunk runs the same
device half of the train step eagerly on the same precomputed uniforms and
scalars, so equality is exact (``==``, no tolerance).  Against the JAX
package: the planner's chunks and the device-side SLU decision (``u < p``
on a uniform drawn ahead) equal it exactly, the decision also at p on
float32 boundaries and at the ``min_keep_prob`` floor.  The same on the
card is in ``tests/test_torch_cuda.py`` (marker ``cuda``).
"""
import tempfile

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import config as jc  # noqa: E402
from repro.core import psg as jpsg  # noqa: E402
from repro.training import loop as jloop  # noqa: E402

from repro_torch.configs.paper_cnns import cnn_model  # noqa: E402
from repro_torch.core import config as tc  # noqa: E402
from repro_torch.core import rng  # noqa: E402
from repro_torch.core import slu  # noqa: E402
from repro_torch.data.synthetic import (GaussianImageTask,  # noqa: E402
                                        MarkovLMTask, make_image_batch,
                                        make_lm_batch)
from repro_torch.kernels import graph_cond  # noqa: E402
from repro_torch.training import loop  # noqa: E402
from repro_torch.training.train_step import init_train_state  # noqa: E402
from repro_torch.training.trainer import Trainer  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """These tests run many small steps: one intra-op thread each, so that
    parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _exp(task_name, smd=True, swa=False):
    e2 = tc.E2TrainConfig(smd=tc.SMDConfig(enabled=smd, drop_prob=0.5),
                          slu=tc.SLUConfig(enabled=True, alpha=1e-3),
                          psg=tc.PSGConfig(enabled=True, swa=swa))
    tr = tc.TrainConfig(global_batch=8, seq_len=16, lr=0.05, optimizer="psg",
                        total_steps=8, schedule="constant")
    if task_name == "cifar_cnn":
        return tc.Experiment(model=cnn_model("resnet14", 14, width=8), e2=e2,
                             train=tr, task="cifar_cnn")
    model = tc.ModelConfig(name="t", family="dense", num_layers=2, d_model=32,
                           num_heads=4, num_kv_heads=2, d_ff=64,
                           vocab_size=32, dtype="float32")
    return tc.Experiment(model=model, e2=e2, train=tr, task="lm")


def _mk(exp):
    if exp.task == "cifar_cnn":
        task = GaussianImageTask(num_classes=10, snr=2.0)
        return lambda s, sh: make_image_batch(task, 0, s, sh,
                                              exp.train.global_batch, "cpu")
    task = MarkovLMTask(vocab=exp.model.vocab_size)
    return lambda s, sh: make_lm_batch(task, 0, s, sh, exp.train.global_batch,
                                       exp.train.seq_len, "cpu")


def _trainer(exp, **kw):
    return Trainer(exp, init_train_state(exp, seed=0, device="cpu"),
                   _mk(exp), device="cpu", **kw)


def _curve(hist):
    return [(h["step"], h["total_loss"]) for h in hist]


def _assert_same_state(a, b):
    for (n, x), (_, y) in zip(a.state.model.named_parameters(),
                              b.state.model.named_parameters()):
        assert torch.equal(x, y), n
    for (n, x), (_, y) in zip(a.state.model.named_buffers(),
                              b.state.model.named_buffers()):
        assert torch.equal(x, y), n


@pytest.mark.parametrize("task_name,swa", [("lm", False), ("cifar_cnn", False),
                                           ("cifar_cnn", True)])
def test_chunked_matches_per_step_bitwise(task_name, swa):
    """K=4 chunks: loss curve, SLU flags, step counter, SMD counts, final
    parameters and BatchNorm statistics identical to the per-step loop
    (with SWA: the average and its count too)."""
    steps = 20 if task_name == "cifar_cnn" else 24
    exp = _exp(task_name, swa=swa)
    trA = _trainer(exp)
    hA = trA.run(steps)
    trB = _trainer(exp, chunk_steps=4)
    hB = trB.run(steps)
    assert _curve(hA) == _curve(hB)
    assert [h["slu_executed"] for h in hA] == [h["slu_executed"] for h in hB]
    assert trA.state.step == trB.state.step == steps
    assert (trA.executed_steps, trA.dropped_steps) == \
        (trB.executed_steps, trB.dropped_steps)
    assert trA.dropped_steps > 0
    _assert_same_state(trA, trB)
    if swa:
        assert trA.state.swa["count"] == trB.state.swa["count"] > 0
        for n, a in trA.state.swa["avg"].items():
            assert torch.equal(a, trB.state.swa["avg"][n]), n
    assert trA.energy_report(steps=steps).to_dict() == \
        trB.energy_report(steps=steps).to_dict()


def test_chunked_resume_across_chunk_boundary():
    """A straight chunked run equals one interrupted at a chunk-cadence
    checkpoint and resumed from it."""
    from repro_torch.ft.checkpoint import (latest_step, restore_checkpoint,
                                           resume_chunk_start)
    exp = _exp("lm")
    steps, K = 24, 4
    trA = _trainer(exp, chunk_steps=K)
    hA = trA.run(steps)
    with tempfile.TemporaryDirectory() as d:
        trB = _trainer(exp, chunk_steps=K, checkpoint_dir=d,
                       checkpoint_every=1)
        trB.run(12)
        assert latest_step(d) == 11               # the final save
        start = resume_chunk_start(d)
        assert start == 12
        trC = _trainer(exp, chunk_steps=K)
        restore_checkpoint(d, trC.state)
        assert trC.state.step == start
        hC = trC.run(steps - start)
    assert _curve(trB.history) + _curve(hC) == _curve(hA)
    _assert_same_state(trA, trC)
    assert trB.dropped_steps + trC.dropped_steps == trA.dropped_steps


def test_chunk_cadence_checkpoint_state_is_boundary_state():
    """A cadence save inside a chunked run holds the state at that chunk's
    boundary, not a later one."""
    from repro_torch.ft.checkpoint import restore_checkpoint
    exp = _exp("lm", smd=False)
    with tempfile.TemporaryDirectory() as d:
        tr = _trainer(exp, chunk_steps=4, checkpoint_dir=d,
                      checkpoint_every=4)
        tr.run(12)
        trC = _trainer(exp, chunk_steps=4)
        _, step = restore_checkpoint(d, trC.state, step=3)
        assert step == 3 and trC.state.step == 4
        hC = trC.run(8)
        assert _curve(hC) == _curve(tr.history)[4:]


def test_make_chunk_step_validates_shapes():
    exp = _exp("lm", smd=False)
    mk = _mk(exp)
    state = init_train_state(exp, device="cpu")
    batches = loop.stack_batches([mk(t, 0) for t in range(3)])
    with pytest.raises(ValueError, match="K=4"):
        loop.make_chunk_step(exp, K=4)(state, batches, np.ones(3, np.int32))
    with pytest.raises(ValueError, match="leading axes"):
        loop.make_chunk_step(exp)(state, batches, np.ones(4, np.int32))


def test_chunk_step_metrics_are_stacked():
    exp = _exp("cifar_cnn", smd=False)
    mk = _mk(exp)
    state = init_train_state(exp, device="cpu")
    batches = loop.stack_batches([mk(t, 0) for t in range(3)])
    state, met = loop.make_chunk_step(exp, K=3)(state, batches,
                                                np.array([1, 2, 1]))
    assert state.step == 4
    assert met["total_loss"].shape == (3,)
    assert met[loop.FLAGS].shape == (3, 6)
    assert loop.CHUNK_CONTRACT == jloop.CHUNK_CONTRACT


def test_chunk_planner_increments_and_trailing():
    p = loop.ChunkPlanner(2)
    one = {"x": torch.ones(2)}
    assert p.add(0, None) is None                # drop
    assert p.add(1, one) is None                 # executed, increment 2
    p.drop(2, one)                               # straggler-dropped step
    steps, batches, incs = p.add(3, one)         # executed, increment 2
    assert steps == (1, 3)
    assert incs.tolist() == [2, 2]
    assert batches["x"].shape == (2, 2)
    assert p.add(4, None) is None
    assert p.flush() is None
    assert p.flush_trailing() == 1
    assert (p.executed, p.dropped) == (2, 3)


def test_planner_streams_match_jax():
    """The same ``(step, batch | None)`` stream gives the JAX package's
    chunks: steps, increments and stacked arrays, the tail and the
    trailing drops too."""
    r = np.random.RandomState(0)
    stream = [(s, None if r.rand() < 0.4 else
               {"x": r.randn(3).astype(np.float32),
                "y": r.randint(0, 9, 2).astype(np.int64)})
              for s in range(40)]
    mine, ref = loop.ChunkPlanner(4), jloop.ChunkPlanner(4)
    got, want = [], []
    for s, b in stream:
        tb = None if b is None else {k: torch.from_numpy(v)
                                     for k, v in b.items()}
        got.append(mine.add(s, tb))
        want.append(ref.add(s, b))
    got.append(mine.flush())
    want.append(ref.flush())
    assert [g is None for g in got] == [w is None for w in want]
    for g, w in zip(got, want):
        if g is None:
            continue
        assert g[0] == w[0]
        np.testing.assert_array_equal(g[2], w[2])
        for k in w[1]:
            np.testing.assert_array_equal(g[1][k].numpy(), w[1][k])
    assert mine.flush_trailing() == ref.flush_trailing()
    assert (mine.executed, mine.dropped) == (ref.executed, ref.dropped)


def test_chunked_straggler_drops_at_chunk_granularity():
    exp = _exp("lm", smd=False)
    tr = _trainer(exp, chunk_steps=4, deadline_s=1e-9)
    tr.run(16)
    assert tr.dropped_steps >= 1
    assert tr.executed_steps + tr.dropped_steps == 16
    assert tr.state.step == 16
    assert len(tr.history) == tr.executed_steps


def test_chunked_straggler_deadline_is_per_step():
    """Each executed step over the deadline arms one drop: a chunk of 4
    arms 4, so 24 steps at K=4 drop more than the 4 chunks could."""
    exp = _exp("lm", smd=False)
    tr = _trainer(exp, chunk_steps=4, deadline_s=1e-9)
    tr.run(24)
    assert tr.dropped_steps + tr.executed_steps == 24
    assert tr.state.step == 24
    assert tr.straggler_dropped_steps == tr.dropped_steps
    assert tr.straggler_dropped_steps > 4
    assert len(tr.history) == tr.executed_steps


def test_deadline_nothing_exceeds_changes_nothing():
    exp = _exp("lm")
    trA = _trainer(exp, chunk_steps=4)
    hA = trA.run(16)
    trB = _trainer(exp, chunk_steps=4, deadline_s=1e9)
    hB = trB.run(16)
    assert _curve(hA) == _curve(hB)
    assert trB.straggler_dropped_steps == 0
    _assert_same_state(trA, trB)


def test_chunked_partial_tail_chunk():
    exp = _exp("lm")
    trA = _trainer(exp)
    hA = trA.run(10)
    trB = _trainer(exp, chunk_steps=4)
    hB = trB.run(10)
    assert _curve(hA) == _curve(hB)
    assert trB.state.step == 10


def test_chunked_refuses_the_per_step_test_hook():
    exp = _exp("cifar_cnn")
    with pytest.raises(ValueError, match="per-step"):
        _trainer(exp, chunk_steps=4, keep_schedule=[True] * 8)


def test_cli_chunk_steps_on_the_cpu(capsys):
    from repro_torch.launch import train
    tr = train.run(["--depth", "8", "--width", "4", "--batch", "2",
                    "--steps", "10", "--device", "cpu", "--chunk-steps", "4",
                    "--log-every", "2"])
    out = capsys.readouterr().out
    assert tr.chunk_steps == 4
    assert tr.executed_steps + tr.dropped_steps == 10
    assert "chunked K=4" in out and "energy report" in out
    logged = [line for line in out.splitlines() if line.startswith("step ")]
    assert all(int(line.split()[1].rstrip(":")) % 2 == 0 for line in logged)


# ---------------------------------------------------------------------------
# the SLU decision from uniforms drawn ahead, against jax.random.bernoulli
# ---------------------------------------------------------------------------

MIN_KEEP = jc.SLUConfig().min_keep_prob


def _probabilities():
    r = np.random.RandomState(3)
    edge = np.array([0.0, MIN_KEEP, np.nextafter(np.float32(MIN_KEEP), 1),
                     np.nextafter(np.float32(MIN_KEEP), 0), 0.5,
                     np.nextafter(np.float32(0.5), 0), 1.0,
                     np.nextafter(np.float32(1.0), 0)], np.float32)
    return np.concatenate([edge, r.rand(56).astype(np.float32)])


@pytest.mark.parametrize("step", [0, 7, 123456])
def test_device_decision_matches_jax_bernoulli(step):
    """``u < p`` on the uniform of each block's key equals
    ``jax.random.bernoulli`` on that key, for every p, including p on
    float32 boundaries, at the floor and at the uniform itself."""
    key = rng.fold_in(rng.PRNGKey(0), step)
    ps = _probabilities()
    u = slu.resnet_uniforms(key, len(ps))
    ps[-1] = u[-1]                       # p equal to the uniform: not kept
    ps[-2] = np.nextafter(u[-2], np.float32(1))
    jkey = jax.random.fold_in(jax.random.PRNGKey(0), step)
    want = np.array([bool(jax.random.bernoulli(jax.random.fold_in(jkey, g),
                                               jnp.float32(p)))
                     for g, p in enumerate(ps)])
    got = graph_cond.slu_decide(torch.from_numpy(u), torch.from_numpy(ps))
    np.testing.assert_array_equal(got.numpy().astype(bool), want)
    assert not want[-1] and want[-2]
    forced = graph_cond.slu_decide(torch.from_numpy(u), torch.from_numpy(ps),
                                   force=True)
    assert bool(forced.all())


def test_lm_uniforms_are_the_jax_sub_block_keys():
    key = rng.fold_in(rng.PRNGKey(5), 3)
    jkey = jax.random.fold_in(jax.random.PRNGKey(5), 3)
    # three one-block attn units (the uniforms take the model's config
    # since the SSM slice: its units may hold several blocks)
    u = slu.lm_uniforms(key, tc.ModelConfig("lm", "dense", 3, 64, 4, 4, 96,
                                            128))
    want = []
    for i in range(3):
        for r in jax.random.split(jax.random.fold_in(
                jax.random.fold_in(jkey, i), 0)):
            want.append(np.asarray(jax.random.uniform(r)))
    np.testing.assert_array_equal(u, np.array(want, np.float32))


def test_gated_residual_decides_as_jax_and_floors_at_min_keep():
    """The gated residual keeps exactly where ``bernoulli(key, p)`` does,
    with p from the gate (floored at ``min_keep_prob``), and a skipped
    block returns ``x`` itself."""
    key = rng.fold_in(rng.PRNGKey(1), 2)
    jkey = jax.random.fold_in(jax.random.PRNGKey(1), 2)
    ps = _probabilities()
    u = slu.resnet_uniforms(key, len(ps))
    x = torch.tensor([-0.0, 1.5])
    for g, p in enumerate(ps):
        pt = torch.clamp(torch.tensor(p), MIN_KEEP, 1.0)
        out, ex = slu.gated_residual(lambda t: t * 2, x, pt, u[g], False)
        want = bool(jax.random.bernoulli(jax.random.fold_in(jkey, g),
                                         jnp.maximum(jnp.float32(p),
                                                     MIN_KEEP)))
        assert bool(ex) == want, (g, p)
        if not want:
            assert out is x
        else:
            assert torch.equal(out, x + ((1.0 + pt) - pt) * (x * 2))


@pytest.mark.parametrize("enabled", [True, False])
@pytest.mark.parametrize("fused", [None, True, False])
def test_fused_attention_resolution_matches_jax(enabled, fused):
    """``fused_attention`` resolves as in the JAX package (whose CPU
    backends are not Mosaic): None is the flash path; no config is off."""
    mine = tc.PSGConfig(enabled=enabled, fused_attention=fused)
    ref = jc.PSGConfig(enabled=enabled, fused_attention=fused)
    assert tc.fused_attention_active(mine) is \
        jpsg.fused_attention_active(ref)
    assert tc.fused_attention_active(None) is \
        jpsg.fused_attention_active(None) is False
