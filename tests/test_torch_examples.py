"""The port's examples (``repro_torch.launch.finetune_split`` and
``quickstart``) against the JAX package's ``examples/``, stage by stage, on
the CPU.

Both packages run each stage short from the same parameters
(``repro_torch.convert``), the JAX side built from the JAX package's own
``Trainer``, ``make_optimizer`` and ``lm_loss`` as the examples build it:

* §4.5 pre-training (sgdm on task A, fp32, no PSG) and head-only
  fine-tuning (every gradient but the head's zeroed, all through sgdm with
  its weight decay): every step's loss within ``1e-4`` relative, and the
  body after head-only fine-tuning equal to the reference's, moved by the
  weight decay alone;
* the E2-Train fine-tuning from the pre-trained body and the reference's
  fresh gates: the same SMD executed and dropped counts, the losses held as
  ``tests/test_torch_loss_curves.py`` holds its PSG curve (``1e-2`` plus
  the reference's own spread under a one-ulp nudge of every parameter);
* quickstart's sgdm baseline within ``1e-4`` at every step and its Tab. 3
  lines within ``1e-12``.
"""
import dataclasses
import os
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from repro.core import config as jc  # noqa: E402
from repro.core.ledger import EnergyLedger as JLedger  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim.api import make_optimizer as jmake_optimizer  # noqa: E402
from repro.training.train_step import init_train_state as jinit  # noqa: E402
from repro.training.trainer import Trainer as JTrainer  # noqa: E402
from repro_torch.convert import lm_state_dict_from_jax  # noqa: E402
from repro_torch.launch import finetune_split as FS  # noqa: E402
from repro_torch.launch import quickstart as QS  # noqa: E402
from repro_torch.models.transformer import TransformerLM  # noqa: E402

LOSS_REL = 1e-4
PRE, HEAD, E2 = 8, 6, 12

JMODEL = jc.ModelConfig(name="ft", family="dense", num_layers=4, d_model=64,
                        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64,
                        dtype="float32")
JTASK_A = jsyn.MarkovLMTask(vocab=64, seed=1234)
JTASK_B = jsyn.MarkovLMTask(vocab=64, seed=5678)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(params, e2=None):
    model = TransformerLM(FS.MODEL, e2)
    model.load_state_dict(lm_state_dict_from_jax(_np(params)))
    return model


def _losses(hist):
    return np.array([h["loss"] for h in hist], np.float64)


def _jax_exp():
    return jc.Experiment(model=JMODEL, train=jc.TrainConfig(
        global_batch=16, seq_len=32, lr=0.1, total_steps=80,
        schedule="constant"))


def _jax_pretrain(steps):
    exp = _jax_exp()
    state = jinit(jax.random.PRNGKey(0), exp)
    init = _np(state.params)
    tr = JTrainer(exp, state, lambda s, sh: jsyn.make_lm_batch(
        JTASK_A, 0, s, sh, 16, 32))
    hist = tr.run(steps)
    return init, _np(tr.state.params), _losses(hist)


def _jax_head_only(base, steps):
    exp = _jax_exp()
    params = jax.tree.map(jnp.asarray, base)
    opt = jmake_optimizer(dataclasses.replace(exp.train, total_steps=60))
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state, batch, i):
        (l, _), g = jax.value_and_grad(
            lambda p: JT.lm_loss(p, batch, JMODEL, remat="none"),
            has_aux=True)(params)
        g = {k: (v if k == "head" else jax.tree.map(jnp.zeros_like, v))
             for k, v in g.items()}
        return *opt.apply(params, g, opt_state, i), l

    losses = []
    for i in range(steps):
        params, opt_state, loss = step(
            params, opt_state,
            jsyn.make_lm_batch(JTASK_B, 1, i, 0, 16, 32), jnp.int32(i))
        losses.append(float(loss))
    return _np(params), np.array(losses)


@pytest.fixture(scope="module")
def pretrained():
    """``(JAX initial params, JAX params after PRE steps, JAX losses, port
    trainer, port losses)``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    init, after, want = _jax_pretrain(PRE)
    trainer, hist = FS.pretrain(PRE, "cpu", init=_port(init))
    torch.set_num_threads(n)
    return init, after, want, trainer, _losses(hist)


def test_pretraining_matches_the_reference(pretrained):
    _, after, want, trainer, got = pretrained
    assert len(got) == PRE
    np.testing.assert_allclose(got, want, rtol=LOSS_REL, atol=0)


def test_head_only_finetuning_matches_the_reference_with_weight_decay(
        pretrained):
    _, after, _, _, _ = pretrained
    want_params, want = _jax_head_only(after, HEAD)
    base = _port(after)
    model, got = FS.head_only(base, HEAD)
    np.testing.assert_allclose(got, want, rtol=LOSS_REL, atol=0)
    # the body moves by weight decay alone (a zero gradient through sgdm),
    # elementwise from the same weights in both packages: equal to fp32
    # rounding, every leaf moved, and towards zero
    ref = lm_state_dict_from_jax(want_params)
    before = base.state_dict()
    body = [n for n in ref if n != "head"]
    for name in body:
        p = model.state_dict()[name]
        np.testing.assert_allclose(p.numpy(), ref[name].numpy(), rtol=1e-6,
                                   atol=0, err_msg=name)
        assert not torch.equal(p, before[name]), name
        assert torch.all(p.abs() <= before[name].abs()), name


def _jax_e2(base, steps, nudge=0):
    """The reference's option 2 from ``base``: a fresh state at
    ``PRNGKey(2)`` with the body merged in (each leaf moved ``nudge`` ulp
    where given)."""
    e2 = jc.E2TrainConfig(smd=jc.SMDConfig(True),
                          slu=jc.SLUConfig(True, alpha=1e-3),
                          psg=jc.PSGConfig(True, swa=False))
    exp = _jax_exp()
    exp2 = exp.replace(e2=e2, train=dataclasses.replace(
        exp.train, optimizer="psg", lr=0.03, total_steps=240))
    st2 = jinit(jax.random.PRNGKey(2), exp2)
    fresh = _np(st2.params)
    merged = dict(st2.params)
    for k, v in base.items():
        merged[k] = jax.tree.map(
            lambda x: jnp.asarray(np.nextafter(x, nudge * np.inf)
                                  if nudge else x), v)
    tr = JTrainer(exp2, st2._replace(params=merged),
                  lambda s, sh: jsyn.make_lm_batch(JTASK_B, 1, s, sh, 16, 32))
    hist = tr.run(steps)
    return fresh, _losses(hist), (tr.executed_steps, tr.dropped_steps)


def test_e2train_finetuning_holds_the_reference_curve(pretrained):
    _, after, _, _, _ = pretrained
    fresh, want, counts = _jax_e2(after, E2)
    spread = np.max([np.abs(_jax_e2(after, E2, d)[1] - want)
                     for d in (1, -1)], axis=0)
    init = _port(fresh, FS.E2)
    trainer, hist = FS.e2_finetune(_port(after), E2, init=init)
    got = _losses(hist)
    assert (trainer.executed_steps, trainer.dropped_steps) == counts
    assert len(got) == len(want) == counts[0]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2 + spread.max())
    assert FS.energy_units(trainer, E2) < counts[0]


def test_quickstart_baseline_and_tab3_match_the_reference():
    jexp = jc.Experiment(model=jc.ModelConfig(
        name="quickstart", family="dense", num_layers=4, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64,
        dtype="float32"), e2=jc.E2TrainConfig(), train=jc.TrainConfig(
        global_batch=16, seq_len=32, lr=0.1, optimizer="sgdm",
        total_steps=PRE, schedule="constant"))
    state = jinit(jax.random.PRNGKey(0), jexp)
    task = jsyn.MarkovLMTask(vocab=64)
    model = TransformerLM(QS.MODEL)
    model.load_state_dict(lm_state_dict_from_jax(_np(state.params)))
    want = _losses(JTrainer(jexp, state, lambda s, sh: jsyn.make_lm_batch(
        task, 0, s, sh, 16, 32)).run(PRE))
    _, hist = QS.train("sgd32", QS.E2TrainConfig(), "sgdm", 0.1, PRE, "cpu",
                       init=model, log_every=0)
    np.testing.assert_allclose(_losses(hist), want, rtol=LOSS_REL, atol=0)
    for skip, comp, paper in QS.table3():
        op = jc.E2TrainConfig(smd=jc.SMDConfig(enabled=True, drop_prob=0.5),
                              slu=jc.SLUConfig(enabled=True,
                                               target_skip=skip),
                              psg=jc.PSGConfig(enabled=True))
        ref = JLedger(jc.Experiment(model=jexp.model, e2=op)).report()
        assert comp == pytest.approx(ref.paper_composition, rel=1e-12)
        assert paper == dict(QS.TAB3)[skip]


def test_cli_runs_on_the_cpu(monkeypatch, capsys):
    """Both launchers end with the reference's last lines (stages cut to a
    few steps)."""
    for mod, args in ((FS, (3, 2, 4)), (QS, (3, 4))):
        orig = mod.run
        monkeypatch.setattr(mod, "run", lambda device, o=orig, a=args:
                            o(device, *a))
        assert mod.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "pre-trained on A; loss on B before FT:" in out
    assert "paper §4.5: E2-Train fine-tuning wins on accuracy AND energy" \
        " -> reproduced:" in out
    assert "=== energy accounting (paper Tab. 3 composition) ===" in out
    assert out.rstrip().endswith("(paper: 90.13%)")
