"""repro_torch's microbatch accumulation against the JAX package's.

A ``microbatches=2`` train step from the same parameters
(``repro_torch.convert``) and batch (a numpy seed) in both packages, on the
CPU:

* with PSG off under ``sgdm`` (the ResNet with SLU on, its decisions drawn
  by both packages from ``fold_in(step_key, i)``; the reduced LM): loss and
  metrics within ``1e-5`` relative, every updated parameter and BatchNorm
  statistic within ``1e-5`` of its tensor's largest magnitude.  fp32 sums
  in another order, over two microbatches and one optimizer update;
* with PSG on (the ResNet on the fused convs): the tolerances of
  ``test_torch_train.py``, for its reason (an 8-bit activation code can
  flip at a rounding boundary between the two packages' fp32 sums): loss
  at ``rtol=atol=1e-2``, the fallback ratio equal, and at least 90% of each
  updated parameter tensor equal to ``1e-6``; the vote over microbatches is
  exact wherever both packages' integer sums agree;
* the port's ``m=2`` step against its ``m=1`` step under ``sgdm`` on the LM
  with SLU off (the JAX package's ``test_microbatch_equivalence_sgdm``):
  every row holds as many valid labels, so the mean of the microbatch
  means is the batch mean, and the two updates agree to ``1e-5`` of each
  tensor's largest magnitude.
"""
import copy
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_experiment as jget  # noqa: E402
from repro.configs import reduce_experiment as jreduce  # noqa: E402
from repro.configs.paper_cnns import cnn_model as jcnn_model  # noqa: E402
from repro.core import config as jc  # noqa: E402
from repro.training.train_step import init_train_state as jinit  # noqa: E402
from repro.training.train_step import make_train_step as jmake  # noqa: E402
from repro_torch.configs import get_experiment, reduce_experiment  # noqa: E402
from repro_torch.configs.paper_cnns import cnn_model  # noqa: E402
from repro_torch.convert import (lm_state_dict_from_jax,  # noqa: E402
                                 state_dict_from_jax)
from repro_torch.core import config as tc  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.models.resnet import ResNet  # noqa: E402
from repro_torch.models.transformer import TransformerLM  # noqa: E402
from repro_torch.training.train_step import (make_train_step,  # noqa: E402
                                             split_microbatches,
                                             train_state_for)

REL = 1e-5
TOL = dict(rtol=1e-2, atol=1e-2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(a - ref)) / max(np.max(np.abs(ref)), 1e-30))


def _cnn(psg: bool, m: int = 2, batch: int = 4):
    kw = dict(global_batch=batch, microbatches=m, total_steps=4,
              **(dict(optimizer="psg", lr=0.03) if psg else
                 dict(optimizer="sgdm", lr=0.1)))
    jexp = jc.Experiment(
        model=jcnn_model("resnet8", 8, width=8),
        e2=jc.E2TrainConfig(slu=jc.SLUConfig(enabled=not psg),
                            psg=jc.PSGConfig(enabled=psg, fused_conv=True,
                                             backend="interpret")),
        train=jc.TrainConfig(**kw), task="cifar_cnn")
    texp = tc.Experiment(
        model=cnn_model("resnet8", 8, width=8),
        e2=tc.E2TrainConfig(slu=tc.SLUConfig(enabled=not psg),
                            psg=tc.PSGConfig(enabled=psg)),
        train=tc.TrainConfig(**kw), task="cifar_cnn")
    return jexp, texp


def _lm(m: int = 2, slu: bool = True):
    def cut(exp, e2):
        model = dataclasses.replace(exp.model, num_layers=3)
        train = dataclasses.replace(exp.train, optimizer="sgdm", lr=0.1,
                                    global_batch=4, microbatches=m,
                                    remat="none")
        return exp.replace(model=model, e2=e2, train=train)
    jexp = cut(jreduce(jget("qwen2_5_3b")),
               jc.E2TrainConfig(slu=jc.SLUConfig(enabled=slu)))
    texp = cut(reduce_experiment(get_experiment("qwen2_5_3b")),
               tc.E2TrainConfig(slu=tc.SLUConfig(enabled=slu)))
    return jexp, texp


def _steps(jexp, texp, batch):
    """One step of each package from the JAX init; returns the two new
    states' parameters (and buffers) by the port's names, and metrics."""
    jstate = jinit(jax.random.PRNGKey(0), jexp)
    if texp.task == "cifar_cnn":
        model = ResNet(8, 10, texp.e2, width=8)
        model.load_state_dict(state_dict_from_jax(_np(jstate.params),
                                                  _np(jstate.model_state)))
    else:
        model = TransformerLM(texp.model, texp.e2)
        model.load_state_dict(lm_state_dict_from_jax(_np(jstate.params)))
    jnew, jmet = jax.jit(jmake(jexp))(jstate, jax.tree.map(jnp.asarray, batch))
    new, met = make_train_step(texp)(
        train_state_for(texp, model),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    if texp.task == "cifar_cnn":
        want = state_dict_from_jax(_np(jnew.params), _np(jnew.model_state))
    else:
        want = lm_state_dict_from_jax(_np(jnew.params))
    got = {**dict(new.model.named_parameters()),
           **dict(new.model.named_buffers())}
    return got, want, met, jmet


def _images(n=4):
    r = np.random.RandomState(7)
    return {"image": r.randn(n, 32, 32, 3).astype(np.float32),
            "label": r.randint(0, 10, (n,)).astype(np.int32)}


def _tokens(n=4):
    b = tsyn.make_lm_batch(tsyn.MarkovLMTask(vocab=128), 0, 0, 0, n, 16,
                           "cpu")
    return {k: v.numpy().astype(np.int32) for k, v in b.items()}


@pytest.mark.parametrize("task", ["cifar_cnn", "lm"])
def test_microbatch_step_matches_jax_psg_off(task):
    jexp, texp = _cnn(psg=False) if task == "cifar_cnn" else _lm()
    batch = _images() if task == "cifar_cnn" else _tokens()
    got, want, met, jmet = _steps(jexp, texp, batch)
    assert set(met) == set(jmet)
    for k in met:
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=REL,
                                   atol=1e-7, err_msg=k)
    assert 0.0 < float(met["slu_exec_ratio"]) <= 1.0
    assert set(got) == set(want)
    for name, t in got.items():
        assert _rel(t.detach().numpy(), want[name].numpy()) <= REL, name


def test_microbatch_step_matches_jax_psg_on():
    jexp, texp = _cnn(psg=True)
    got, want, met, jmet = _steps(jexp, texp, _images())
    assert set(met) == set(jmet)
    for k in ("loss", "total_loss"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), **TOL,
                                   err_msg=k)
    assert float(met["psg_fallback_ratio"]) == float(jmet["psg_fallback_ratio"])
    for name, t in got.items():
        if name.endswith((".mean", ".var")):
            np.testing.assert_allclose(t.numpy(), want[name].numpy(), **TOL,
                                       err_msg=name)
            continue
        same = np.isclose(t.detach().numpy(), want[name].numpy(), rtol=0,
                          atol=1e-6)
        assert same.mean() >= 0.9, (name, same.mean())


def test_lm_microbatches_equal_the_whole_batch_under_sgdm():
    # SLU off: the two steps would draw their decisions from other keys
    _, t2 = _lm(m=2, slu=False)
    _, t1 = _lm(m=1, slu=False)
    batch = {k: torch.from_numpy(v) for k, v in _tokens().items()}
    valid = (batch["labels"] >= 0).sum(dim=1)
    assert bool((valid == valid[0]).all())     # equal counts per microbatch
    model = TransformerLM(t1.model, t1.e2, seed=3)
    s1, m1 = make_train_step(t1)(train_state_for(t1, copy.deepcopy(model)),
                                 batch)
    s2, m2 = make_train_step(t2)(train_state_for(t2, copy.deepcopy(model)),
                                 batch)
    p0 = dict(model.named_parameters())
    p1, p2 = dict(s1.model.named_parameters()), dict(s2.model.named_parameters())
    for name, p in p1.items():
        assert not torch.equal(p, p0[name]), name       # the update moved it
        assert _rel(p2[name].detach().numpy(), p.detach().numpy()) <= REL, name
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=REL)


def test_batch_that_microbatches_do_not_divide_raises():
    _, texp = _cnn(psg=False, m=3)
    batch = {k: torch.from_numpy(v) for k, v in _images(4).items()}
    with pytest.raises(ValueError, match="does not divide"):
        make_train_step(texp)(train_state_for(
            texp, ResNet(8, 10, texp.e2, width=8)), batch)
    parts = split_microbatches(batch, 2)
    assert [p["image"].shape[0] for p in parts] == [2, 2]
    assert torch.equal(torch.cat([p["label"] for p in parts]), batch["label"])
