"""repro_torch's evaluation against the JAX package's: eval-mode predict,
the SWA weights, BatchNorm recalibration and held-out accuracy.

The same parameters (``repro_torch.convert``), BatchNorm statistics and
inputs, made from a numpy seed, go through both packages on the CPU.
Prediction runs outside ``psg.enable`` in both: plain fp32 products.
Tolerances:

* logits: fp32, the same operations in another summation order (im2col
  products against XLA's convolution), ``1e-5`` of the largest |logit|
  (as ``test_torch_lm.py`` holds its fp32 forward; measured 2e-7 to 4e-7
  at ResNet depths 8, 14 and 26 and on the reduced LM);
* the SWA average: bitwise (the same float32 operations in the same
  order);
* recalibrated BatchNorm statistics: ``1e-5`` of each buffer's largest
  magnitude (train-mode forwards in fp32, as above); the SLU decisions of
  each recalibration batch equal;
* held-out accuracy: equal, on the same weights.
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
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import resnet as JR  # noqa: E402
from repro.optim.swa import swa_init as jswa_init  # noqa: E402
from repro.optim.swa import swa_params as jswa_params  # noqa: E402
from repro.optim.swa import swa_update as jswa_update  # noqa: E402
from repro.tasks import get_task as jget_task  # noqa: E402
from repro.training.train_step import \
    recalibrate_model_state as jrecalibrate  # noqa: E402
from repro_torch.configs import get_experiment, reduce_experiment  # noqa: E402
from repro_torch.configs.paper_cnns import cnn_model  # noqa: E402
from repro_torch.convert import (lm_state_dict_from_jax,  # noqa: E402
                                 state_dict_from_jax)
from repro_torch.core import config as tc  # noqa: E402
from repro_torch.core import rng  # noqa: E402
from repro_torch.models.resnet import ResNet  # noqa: E402
from repro_torch.models.transformer import TransformerLM  # noqa: E402
from repro_torch.optim.swa import swa_update  # noqa: E402
from repro_torch.tasks import get_task, task_names  # noqa: E402
from repro_torch.training import evaluate  # noqa: E402
from repro_torch.training.train_step import (eval_params,  # noqa: E402
                                             init_train_state,
                                             recalibrate_model_state,
                                             train_state_for)

WIDTH, BATCH = 8, 4
RESNET_REL, LM_REL, BN_REL = 1e-5, 1e-5, 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(a - ref)) / max(np.max(np.abs(ref)), 1e-30))


def _cnn(depth, slu=True):
    """The CIFAR ResNet experiment in both packages (SLU on: eval must
    ignore its gate)."""
    kw = dict(global_batch=BATCH, total_steps=4)
    jexp = jc.Experiment(model=jcnn_model(f"resnet{depth}", depth, width=WIDTH),
                         e2=jc.E2TrainConfig(slu=jc.SLUConfig(enabled=slu)),
                         train=jc.TrainConfig(**kw), task="cifar_cnn")
    texp = tc.Experiment(model=cnn_model(f"resnet{depth}", depth, width=WIDTH),
                         e2=tc.E2TrainConfig(slu=tc.SLUConfig(enabled=slu)),
                         train=tc.TrainConfig(**kw), task="cifar_cnn")
    return jexp, texp


def _resnet(depth, seed=0):
    """JAX parameters with BatchNorm statistics drawn from a numpy seed (so
    eval mode reads something other than 0 and 1), and the port's model
    holding the same."""
    jexp, texp = _cnn(depth)
    params, mstate = jget_task("cifar_cnn").init(jax.random.PRNGKey(seed),
                                                 jexp)
    r = np.random.RandomState(seed + depth)
    mstate = jax.tree_util.tree_map_with_path(
        lambda path, x: np.abs(r.randn(*x.shape)).astype(np.float32) + 0.5
        if path[-1].key == "var" else
        (0.3 * r.randn(*x.shape)).astype(np.float32), _np(mstate))
    model = ResNet(depth, 10, texp.e2, width=WIDTH)
    model.load_state_dict(state_dict_from_jax(_np(params), mstate))
    return jexp, texp, params, mstate, model


def _images(seed, n=BATCH):
    r = np.random.RandomState(seed)
    return {"image": r.randn(n, 32, 32, 3).astype(np.float32),
            "label": r.randint(0, 10, (n,)).astype(np.int32)}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("depth", [8, 14])
def test_resnet_predict_matches_jax(depth):
    jexp, texp, params, mstate, model = _resnet(depth)
    batch = _images(depth)
    jlogits = jax.jit(jget_task("cifar_cnn").make_predict(jexp))(
        params, mstate, batch)
    logits = get_task("cifar_cnn").make_predict(texp)(model, _torch(batch))
    assert logits.shape == (BATCH, 10) and not logits.requires_grad
    assert _rel(logits.numpy(), jlogits) <= RESNET_REL


def _lm():
    def cut(exp, e2):
        return exp.replace(e2=e2, model=dataclasses.replace(exp.model,
                                                            num_layers=3))
    jexp = cut(jreduce(jget("qwen2_5_3b")),
               jc.E2TrainConfig(slu=jc.SLUConfig(enabled=True)))
    texp = cut(reduce_experiment(get_experiment("qwen2_5_3b")),
               tc.E2TrainConfig(slu=tc.SLUConfig(enabled=True)))
    params, _ = jget_task("lm").init(jax.random.PRNGKey(0), jexp)
    model = TransformerLM(texp.model, texp.e2)
    model.load_state_dict(lm_state_dict_from_jax(_np(params)))
    return jexp, texp, params, model


def test_lm_predict_matches_jax():
    jexp, texp, params, model = _lm()
    tokens = np.random.RandomState(3).randint(0, 128, (2, 16)).astype(np.int32)
    jlogits = jget_task("lm").make_predict(jexp)(params, None,
                                                 {"tokens": tokens})
    logits = get_task("lm").make_predict(texp)(
        model, {"tokens": torch.from_numpy(tokens)})
    # the padded vocabulary's columns are -1e30 in both; compare the rest
    v = texp.model.vocab_size
    assert _rel(logits.numpy()[..., :v], np.asarray(jlogits)[..., :v]) <= LM_REL


def test_eval_params_is_jax_swa_params_bitwise():
    jexp, texp, params, mstate, model = _resnet(8)
    texp = texp.replace(e2=tc.E2TrainConfig(psg=tc.PSGConfig(enabled=True)))
    state = train_state_for(texp, model)
    assert state.swa is not None
    jswa = jswa_init(params)
    r = np.random.RandomState(11)
    names = [n for n, _ in model.named_parameters()]
    for step in range(5):          # the first update is before the start
        traj = {n: r.randn(*p.shape).astype(np.float32)
                for n, p in model.named_parameters()}
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(torch.from_numpy(traj[n]))
        swa_update(state.swa, dict(model.named_parameters()), step, 1)
        jtraj = jax.tree.map(jnp.asarray, _jax_params(traj, params))
        jswa = jswa_update(jswa, jtraj, step, 1)
    assert state.swa["count"] == int(jswa["count"]) == 4
    want = state_dict_from_jax(_np(jswa_params(jswa, params)), mstate)
    ev = eval_params(state, texp)
    assert ev is not state.model
    for n, p in ev.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[n].numpy(),
                                      err_msg=n)
    # no aliasing: the live weights and the average stay as they are
    live = {n: p.detach().clone() for n, p in model.named_parameters()}
    avg = {n: a.clone() for n, a in state.swa["avg"].items()}
    with torch.no_grad():
        for p in ev.parameters():
            p.add_(1.0)
    for n in names:
        assert torch.equal(dict(model.named_parameters())[n], live[n])
        assert torch.equal(state.swa["avg"][n], avg[n])
    for n, b in ev.named_buffers():
        assert torch.equal(b, dict(model.named_buffers())[n])
    # without SWA the live model is the evaluation model, as in JAX
    plain = train_state_for(_cnn(8)[1], model)
    assert plain.swa is None and eval_params(plain, texp) is model


def _jax_params(named, like):
    """Port-named arrays as the JAX parameter tree (through the converter's
    inverse)."""
    from repro_torch.convert import jax_tree
    tree = jax_tree(named)
    return jax.tree.map(lambda _, x: x, like, tree)


def test_recalibration_matches_jax():
    depth = 14
    jexp, texp, params, mstate, model = _resnet(depth)
    batches = [_images(40 + i, 8) for i in range(3)]
    key = rng.PRNGKey(texp.train.seed)
    # the SLU decisions of each batch: train-mode BatchNorm normalizes with
    # the batch's own statistics, so they do not depend on the recalibration
    executed = []
    for i, b in enumerate(batches):
        k = jax.random.fold_in(jax.random.PRNGKey(jexp.train.seed), i)
        _, jaux, _ = JR.resnet_fwd(params, mstate, jnp.asarray(b["image"]),
                                   depth, jexp.e2, k, train=True)
        with torch.no_grad():
            _, aux = copy.deepcopy(model)(torch.from_numpy(b["image"]),
                                          key=rng.fold_in(key, i))
        np.testing.assert_array_equal(aux["slu_executed"].numpy(),
                                      np.asarray(jaux["slu_executed"]))
        executed.append(np.asarray(jaux["slu_executed"]))
    assert min(e.min() for e in executed) == 0.0   # SLU skips: it is live
    jnew = _np(jrecalibrate(jexp, params, mstate, [
        jax.tree.map(jnp.asarray, b) for b in batches]))
    model.eval()                        # recalibration trains, then restores
    new = recalibrate_model_state(texp, model, [_torch(b) for b in batches])
    assert not model.training
    want = state_dict_from_jax(_np(params), jnew)
    assert set(new) == {n for n, _ in model.named_buffers()}
    for n, b in new.items():
        assert _rel(b.numpy(), want[n].numpy()) <= BN_REL, n
        assert torch.equal(b, dict(model.named_buffers())[n])
    # the LM holds no buffers: a no-op, as JAX's passes None through
    jl, tl, _, lm = _lm()
    assert recalibrate_model_state(tl, lm, [{"tokens": torch.zeros(
        2, 8, dtype=torch.long), "labels": torch.zeros(2, 8,
                                                       dtype=torch.long)}]) == {}


def _jax_accuracy(jexp, params, mstate):
    """The JAX package's held-out protocol (benchmarks/bench_cnn.py and
    benchmarks/common.py eval_accuracy) on its own data."""
    predict = jax.jit(jget_task(jexp.task).make_predict(jexp))
    correct = total = 0
    for i in range(4):
        if jexp.task == "cifar_cnn":
            b = jsyn.make_image_batch(jsyn.GaussianImageTask(num_classes=10,
                                                             snr=2.0),
                                      99, i, 0, 32)
            labels = np.asarray(b["label"])
        else:
            b = jsyn.make_lm_batch(jsyn.MarkovLMTask(
                vocab=jexp.model.vocab_size), 999, i, 0, 16, 32)
            labels = np.asarray(b["labels"])
        pred = np.asarray(jnp.argmax(predict(params, mstate, b), -1))
        m = labels >= 0
        correct += int((pred[m] == labels[m]).sum())
        total += int(m.sum())
    return correct / total


@pytest.mark.parametrize("task", ["cifar_cnn", "lm"])
def test_heldout_accuracy_equals_jax(task):
    if task == "cifar_cnn":
        jexp, texp, params, mstate, model = _resnet(8)
    else:
        jexp, texp, params, model = _lm()
        mstate = None
    acc = evaluate.accuracy(texp, model, "cpu")
    assert acc == _jax_accuracy(jexp, params, mstate)
    assert 0.0 <= acc <= 1.0
    for i in range(evaluate.HELDOUT_BATCHES):
        b = evaluate.heldout_batch(texp, i, "cpu")
        assert len(next(iter(b.values()))) == (32 if task == "cifar_cnn"
                                               else 16)


def test_trainer_evaluation_uses_swa_weights_and_training_batches():
    from repro_torch.launch import train
    trainer = train.build_trainer(8, 4, 2, 2, device="cpu")
    trainer.run(2)
    assert trainer.state.swa is not None
    acc = evaluate.evaluate(trainer)
    assert acc == evaluate.accuracy(trainer.exp, eval_params(
        trainer.state, trainer.exp), "cpu")
    before = {n: b.clone() for n, b in trainer.state.model.named_buffers()}
    batches = [trainer.make_batch(s, 0) for s in range(2)]
    recal = evaluate.evaluate(trainer, batches)
    assert 0.0 <= recal <= 1.0
    for n, b in trainer.state.model.named_buffers():   # the trainer's own
        assert torch.equal(b, before[n])               # stay untouched


@pytest.mark.parametrize("task", ["cifar_cnn", "lm"])
def test_predict_leaves_the_mode_and_the_train_forward_as_found(task):
    if task == "cifar_cnn":
        texp = _cnn(8)[1]
        batch = _torch(_images(5))
        x = batch["image"]
    else:
        texp = _lm()[1]
        batch = {"tokens": torch.from_numpy(np.random.RandomState(5).randint(
            0, 128, (2, 16)))}
        x = batch["tokens"]
    model = get_task(task).init(texp, 0, "cpu")
    predict = get_task(task).make_predict(texp)
    key = rng.PRNGKey(3)
    ref = copy.deepcopy(model)
    with torch.no_grad():
        want, _ = ref(x, key)
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    predict(model, batch)
    assert model.training
    for n, b in model.named_buffers():
        assert torch.equal(b, buffers[n])          # eval moves no statistic
    with torch.no_grad():
        got, _ = model(x, key)
    assert torch.equal(got, want)                  # train mode bit for bit
    model.eval()
    predict(model, batch)
    assert not model.training


def test_task_registry_names_and_unpriced_task():
    from repro_torch import tasks
    assert task_names() == ("cifar_cnn", "lm")
    assert all(get_task(n).make_predict is not None for n in task_names())
    bare = tasks.Task(name="bare_for_test", init=None, make_loss=None)
    tasks._REGISTRY[bare.name] = bare
    try:
        with pytest.raises(ValueError, match="no cost model"):
            tasks.cost_model(_cnn(8)[1].replace(task="bare_for_test"))
    finally:
        del tasks._REGISTRY[bare.name]
    with pytest.raises(KeyError):
        get_task("nope")
    state = init_train_state(_cnn(8)[1], device="cpu")
    assert state.opt.keys() == {"momentum"}
