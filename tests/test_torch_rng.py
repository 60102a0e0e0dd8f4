"""repro_torch's threefry streams (``core/rng.py``, numpy) against
``jax.random`` on its default threefry2x32 with
``jax_threefry_partitionable=True`` (jax 0.9.0), and every draw of the port
that rides on them.

Keys, ``fold_in``, ``split``, bits, ``uniform``, ``bernoulli`` and
``randint`` must be bit-identical, and so must SMD schedules, image labels,
LM tokens and ResNet SLU decisions.  ``normal`` goes through XLA's float32
``erfinv``, whose ``log1p`` numpy does not reproduce bit for bit: each value
must lie within 4 ulp of JAX's (3 measured over 4e6 draws), so images within
4 ulp of their largest magnitude.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import config as jc  # noqa: E402
from repro.core.smd import smd_schedule as jsmd_schedule  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.core import config as tc  # noqa: E402
from repro_torch.core import rng  # noqa: E402
from repro_torch.core.smd import smd_schedule  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402

NORMAL_ULP = 4
SEEDS = [0, 1, 99, 1234, 2 ** 31 - 1, -1]


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _ulp(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def test_threefry_is_on_the_configuration_this_port_copies():
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_and_split_are_bit_identical(seed):
    jk, tk = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
    _eq(jk, tk)
    for d in (0, 1, 7, 123456, 2 ** 32 - 1):
        _eq(jax.random.fold_in(jk, d), rng.fold_in(tk, d))
    for n in (2, 3, 5):
        _eq(jax.random.split(jk, n), rng.split(tk, n))


@pytest.mark.parametrize("shape", [(), (1,), (7,), (3, 5), (2, 3, 4)])
def test_bits_uniform_and_bernoulli_are_bit_identical(shape):
    jk, tk = jax.random.PRNGKey(42), rng.PRNGKey(42)
    _eq(jax.random.bits(jk, shape), rng.random_bits(tk, shape))
    _eq(jax.random.uniform(jk, shape), rng.uniform(tk, shape))
    _eq(jax.random.uniform(jk, shape, minval=-2.5, maxval=3.0),
        rng.uniform(tk, shape, -2.5, 3.0))
    for p in (0.05, 0.5, 0.93):
        _eq(jax.random.bernoulli(jk, p, shape), rng.bernoulli(tk, p, shape))


@pytest.mark.parametrize("span", [10, 128, 151936, 2 ** 31 - 1])
def test_randint_is_bit_identical(span):
    for seed in (0, 5):
        jk, tk = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
        for lo in (0, -3):
            _eq(jax.random.randint(jk, (4, 257), lo, lo + span),
                rng.randint(tk, (4, 257), lo, lo + span))
    _eq(jax.random.randint(jk, (9,), 4, 4), rng.randint(tk, (9,), 4, 4))


def test_normal_is_within_the_stated_ulp():
    jk, tk = jax.random.PRNGKey(3), rng.PRNGKey(3)
    a = np.asarray(jax.random.normal(jk, (200_000,)))
    b = rng.normal(tk, (200_000,))
    assert int(_ulp(a, b).max()) <= NORMAL_ULP
    assert rng.normal(tk).shape == ()
    e = rng.erfinv_f32(np.array([1.0, -1.0, 0.0], np.float32))
    assert e[0] == np.inf and e[1] == -np.inf and e[2] == 0.0


@pytest.mark.parametrize("seed,p", [(0, 0.5), (7, 0.25)])
def test_smd_schedule_equals_jax(seed, p):
    _eq(jsmd_schedule(jc.SMDConfig(enabled=True, drop_prob=p), seed, 200),
        smd_schedule(tc.SMDConfig(enabled=True, drop_prob=p), seed, 200))


@pytest.mark.parametrize("step,shard", [(0, 0), (3, 1), (41, 0)])
def test_image_batches_equal_jax(step, shard):
    jb = jsyn.make_image_batch(jsyn.GaussianImageTask(snr=2.0), 0, step,
                               shard, 8)
    tb = tsyn.make_image_batch(tsyn.GaussianImageTask(snr=2.0), 0, step,
                               shard, 8, "cpu")
    _eq(jb["label"], tb["label"].numpy())
    ji = np.asarray(jb["image"])
    tol = NORMAL_ULP * np.spacing(np.abs(ji).max())
    np.testing.assert_allclose(tb["image"].numpy(), ji, rtol=0, atol=tol)


@pytest.mark.parametrize("vocab,seq", [(256, 33), (151936, 64)])
def test_lm_batches_equal_jax(vocab, seq):
    jt, tt = jsyn.MarkovLMTask(vocab=vocab), tsyn.MarkovLMTask(vocab=vocab)
    _eq(jt.transition(), tt.transition())
    assert tt.bayes_xent() == jt.bayes_xent()
    for step, shard in ((0, 0), (5, 0), (5, 2)):
        jb = jsyn.make_lm_batch(jt, 0, step, shard, 3, seq)
        tb = tsyn.make_lm_batch(tt, 0, step, shard, 3, seq, "cpu")
        _eq(jb["tokens"], tb["tokens"].numpy())
        _eq(jb["labels"], tb["labels"].numpy())
    with pytest.raises(ValueError):
        tsyn.make_lm_batch(tt, 0, 0, 0, 3, 1, "cpu")


def test_resnet_slu_decisions_equal_jax_without_injection():
    """The port's ResNet forward draws its own keep decisions from the
    step key; they equal the JAX forward's over several steps (depth 14:
    four gated blocks between the forced first and last)."""
    from repro.core import psg as jpsg
    from repro.models import resnet as JR
    from repro_torch.convert import state_dict_from_jax
    from repro_torch.core import psg as tpsg
    from repro_torch.models.resnet import ResNet

    je2 = jc.E2TrainConfig(slu=jc.SLUConfig(enabled=True),
                           psg=jc.PSGConfig(enabled=True, fused_conv=True,
                                            backend="reference"))
    te2 = tc.E2TrainConfig(slu=tc.SLUConfig(enabled=True),
                           psg=tc.PSGConfig(enabled=True))
    params, state = JR.init_resnet(jax.random.PRNGKey(0), 14, e2=je2, width=4)
    model = ResNet(14, 10, te2, width=4)
    model.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)))
    x = np.random.RandomState(0).randn(2, 8, 8, 3).astype(np.float32)

    @jax.jit
    def jfwd(x_, step):
        with jpsg.enable(je2.psg):
            return JR.resnet_fwd(params, state, x_, 14, je2, jax.random.fold_in(
                jax.random.PRNGKey(0), step))[1]

    seen = set()
    for step in range(4):
        aux = jfwd(jnp.asarray(x), step)
        with tpsg.enable(te2.psg, probe=tpsg.zero_probe()):
            _, taux = model(torch.from_numpy(x),
                            key=rng.fold_in(rng.PRNGKey(0), step))
        _eq(aux["slu_executed"], taux["slu_executed"].numpy())
        seen.add(tuple(taux["slu_executed"].tolist()))
    assert len(seen) > 1
