"""repro_torch's train step, Trainer and energy accounting against the JAX
package's.

One train step: the same parameters (``repro_torch.convert``), batch and
SLU decisions (read from the JAX forward under the step's ``rng``) go
through the JAX ``make_train_step`` on its ``interpret`` backend and the
port's ``make_train_step`` on the CPU, with ``optimizer="psg"`` and SWA
active from step 0.  Tolerances are those of ``test_torch_resnet.py`` and
for the same reason: logits-level quantities at ``rtol=atol=1e-2``, and at
least 90% of each updated parameter tensor equal to 1e-6, since an update is
``lr * (sign + wd * w)`` and differs only where a sign does.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.paper_cnns import cnn_model as jcnn_model  # noqa: E402
from repro.core import config as jc  # noqa: E402
from repro.core import psg as jpsg  # noqa: E402
from repro.core.cost import cnn_cost as jcnn_cost  # noqa: E402
from repro.core.ledger import EnergyLedger as JLedger  # noqa: E402
from repro.core.smd import smd_schedule as jsmd_schedule  # noqa: E402
from repro.models import resnet as JR  # noqa: E402
from repro.training.train_step import init_train_state as jinit  # noqa: E402
from repro.training.train_step import make_train_step as jmake  # noqa: E402
from repro_torch.configs.paper_cnns import cnn_model  # noqa: E402
from repro_torch.convert import state_dict_from_jax  # noqa: E402
from repro_torch.core import config as tc  # noqa: E402
from repro_torch.core.cost import cnn_cost  # noqa: E402
from repro_torch.core.energy import computational_savings  # noqa: E402
from repro_torch.data.synthetic import GaussianImageTask, make_image_batch  # noqa: E402
from repro_torch.models.resnet import ResNet  # noqa: E402
from repro_torch.optim.signsgd import signsgd_init  # noqa: E402
from repro_torch.optim.swa import swa_init  # noqa: E402
from repro_torch.training.train_step import (TrainState, init_train_state,  # noqa: E402
                                             make_train_step)
from repro_torch.training.trainer import Trainer  # noqa: E402

DEPTH, WIDTH, BATCH = 8, 8, 2
TOL = dict(rtol=1e-2, atol=1e-2)


def _configs(smd: bool = False, steps: int = 4):
    """The same experiment in both packages."""
    kw = dict(global_batch=BATCH, lr=0.03, optimizer="psg", total_steps=steps)
    jexp = jc.Experiment(
        model=jcnn_model(f"resnet{DEPTH}", DEPTH, width=WIDTH),
        e2=jc.E2TrainConfig(
            smd=jc.SMDConfig(enabled=smd), slu=jc.SLUConfig(enabled=True),
            psg=jc.PSGConfig(enabled=True, fused_conv=True,
                             backend="interpret", swa_start_frac=0.0)),
        train=jc.TrainConfig(**kw), task="cifar_cnn")
    texp = tc.Experiment(
        model=cnn_model(f"resnet{DEPTH}", DEPTH, width=WIDTH),
        e2=tc.E2TrainConfig(smd=tc.SMDConfig(enabled=smd),
                            slu=tc.SLUConfig(enabled=True),
                            psg=tc.PSGConfig(enabled=True, swa_start_frac=0.0)),
        train=tc.TrainConfig(**kw), task="cifar_cnn")
    return jexp, texp


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_state(texp, jstate):
    model = ResNet(DEPTH, 10, texp.e2, width=WIDTH)
    model.load_state_dict(state_dict_from_jax(_np(jstate.params),
                                              _np(jstate.model_state)))
    params = dict(model.named_parameters())
    return TrainState(model, signsgd_init(params), swa_init(params), 0)


def test_one_train_step_matches_jax():
    jexp, texp = _configs()
    jstate = jinit(jax.random.PRNGKey(0), jexp)
    state = _port_state(texp, jstate)
    r = np.random.RandomState(1)
    batch = {"image": r.randn(BATCH, 32, 32, 3).astype(np.float32),
             "label": r.randint(0, 10, (BATCH,)).astype(np.int32)}
    rng = jax.random.fold_in(jax.random.PRNGKey(jexp.train.seed), 0)
    with jpsg.enable(jexp.e2.psg):
        _, aux, _ = JR.resnet_fwd(jstate.params, jstate.model_state,
                                  jnp.asarray(batch["image"]), DEPTH, jexp.e2,
                                  rng)
    keep = [bool(e) for e in np.asarray(aux["slu_executed"])]

    jnew, jmet = jmake(jexp)(jstate, jax.tree.map(jnp.asarray, batch))
    new, met = make_train_step(texp)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, keep=keep)

    assert new.step == int(jnew.step) == 1
    assert set(met) == set(jmet)
    for k in ("loss", "total_loss", "slu_cost", "slu_exec_ratio"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), **TOL,
                                   err_msg=k)
    assert float(met["grad_norm"]) == float(jmet["grad_norm"]) == 0.0
    # the fallback flags are per (tap, dout block); these small convs all
    # fall back somewhere in every tap in both packages
    assert float(met["psg_fallback_ratio"]) == float(jmet["psg_fallback_ratio"])

    want = state_dict_from_jax(_np(jnew.params), _np(jnew.model_state))
    for name, p in new.model.named_parameters():
        same = np.isclose(p.detach().numpy(), want[name].numpy(), rtol=0,
                          atol=1e-6)
        assert same.mean() >= 0.9, (name, same.mean())
        # SWA from step 0: the average after one update is the update
        np.testing.assert_array_equal(new.swa["avg"][name].numpy(),
                                      p.detach().numpy())
    assert new.swa["count"] == int(jnew.swa["count"]) == 1
    for name, b in new.model.named_buffers():
        np.testing.assert_allclose(b.numpy(), want[name].numpy(), **TOL,
                                   err_msg=name)


def test_trainer_with_injected_smd_schedule_matches_jax_ledger():
    steps = 6
    jexp, texp = _configs(smd=True, steps=steps)
    mask = jsmd_schedule(jexp.e2.smd, jexp.train.seed, steps)
    assert 0 < mask.sum() < steps
    state = init_train_state(texp, seed=0, device="cpu")
    task = GaussianImageTask(snr=2.0)
    trainer = Trainer(texp, state,
                      lambda step, shard: make_image_batch(task, 0, step, shard,
                                                           BATCH, "cpu"),
                      device="cpu", keep_schedule=mask)
    hist = trainer.run(steps)
    assert trainer.executed_steps == len(hist) == int(mask.sum())
    assert trainer.dropped_steps == steps - int(mask.sum())
    assert [h["step"] for h in hist] == list(np.flatnonzero(mask))
    assert trainer.state.step == steps
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert 0.0 <= trainer.measured_psg_fallback() <= 1.0

    led = JLedger(jexp)
    for h in trainer.history:
        led.record_step(h)
    led.executed_steps = trainer.executed_steps
    led.dropped_steps = trainer.dropped_steps
    want = led.report(steps=steps).to_dict()
    assert want.pop("validated_against_hlo") is None
    assert trainer.energy_report(steps=steps).to_dict() == want


@pytest.mark.parametrize("depth", [8, 74, 110, "mobilenetv2"])
def test_cost_table_equals_jax(depth):
    name, depth = (depth, 0) if depth == "mobilenetv2" else \
        (f"resnet{depth}", depth)
    t = cnn_cost(cnn_model(name, depth))
    j = jcnn_cost(jcnn_model(name, depth))
    assert [dataclasses.astuple(l) for l in t.layers] == \
        [dataclasses.astuple(l) for l in j.layers]
    assert t.param_count() == j.param_count()


@pytest.mark.parametrize("skip,saving", [(0.2, 0.8027), (0.4, 0.8520),
                                         (0.6, 0.9013)])
def test_paper_table3_composition(skip, saving):
    assert computational_savings(0.67, skip) == pytest.approx(saving, abs=1e-4)


def test_synthetic_batches_are_keyed_and_class_conditional():
    task = GaussianImageTask(snr=2.0)
    a = make_image_batch(task, 0, 3, 0, 8, "cpu")
    b = make_image_batch(task, 0, 3, 0, 8, "cpu")
    c = make_image_batch(task, 0, 4, 0, 8, "cpu")
    assert torch.equal(a["image"], b["image"]) and torch.equal(a["label"], b["label"])
    assert not torch.equal(a["image"], c["image"])
    assert a["image"].shape == (8, 32, 32, 3) and a["label"].dtype == torch.int64
    from repro.data.synthetic import GaussianImageTask as JTask
    np.testing.assert_array_equal(task.means(), JTask(snr=2.0).means())
    resid = a["image"] - task.snr * torch.from_numpy(task.means())[a["label"]]
    assert abs(float(resid.std()) - 1.0) < 0.05
