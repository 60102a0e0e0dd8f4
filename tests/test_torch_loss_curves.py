"""Loss curves of repro_torch against the JAX package over several steps.

Both packages train from the same parameters (``repro_torch.convert``) on
the same batches (the data streams are JAX's threefry draws in both) for
``STEPS`` steps at the training CLI's smoke sizes, and every step's loss is
compared:

* the ResNet with E2-Train off (``--e2train off``: SGD with momentum at lr
  0.1), depth 8, width 8, batch 4: fp32 end to end with no quantization, so
  the two differ only in fp32 summation order (and the images by the few
  ulp of the normal draws); every loss within ``1e-4`` relative.
* the reduced qwen2.5-3b (``--smoke``) with PSG alone (``--e2train psg``:
  signSGD at lr 0.03) through the materialized softmax.  8-bit codes flip
  at rounding boundaries between the two packages' summation orders, and
  every flipped sign moves a weight by 2 lr, so the curves part after a few
  steps.  The reference parts from itself as far: nudging every one of its
  parameters by one ulp up, or down, moves its own loss by up to about 0.03
  within six steps.  So the port is held to ``1e-2`` (the one-step
  tolerance of ``test_torch_lm.py``) plus that measured spread of the
  reference, at every step, and the loss must move the same way from the
  first step to the last in both.  Both curves rise over the first steps at
  this learning rate: that is the reference's behaviour.
"""
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
from repro.training.train_step import init_train_state as jinit  # noqa: E402
from repro.training.trainer import Trainer as JTrainer  # noqa: E402
from repro_torch.convert import (lm_state_dict_from_jax,  # noqa: E402
                                 state_dict_from_jax)
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.launch.train import E2TRAIN, experiment, lm_experiment  # noqa: E402
from repro_torch.models.resnet import ResNet  # noqa: E402
from repro_torch.models.transformer import TransformerLM  # noqa: E402
from repro_torch.training.train_step import train_state_for  # noqa: E402
from repro_torch.training.trainer import Trainer  # noqa: E402

STEPS = 6


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _losses(hist):
    return np.array([h["loss"] for h in hist], np.float64)


def resnet_curves():
    """``(port losses, JAX losses)`` of the PSG-off ResNet, step by step."""
    depth, width, batch = 8, 8, 4
    texp = experiment(depth, width, batch, STEPS, e2=E2TRAIN["off"])
    tc = texp.train
    assert (tc.optimizer, tc.lr) == ("sgdm", 0.1)
    jexp = jc.Experiment(
        model=jcnn_model(f"resnet{depth}", depth, width=width),
        e2=jc.E2TrainConfig(),
        train=jc.TrainConfig(global_batch=batch, lr=tc.lr, total_steps=STEPS,
                             optimizer=tc.optimizer,
                             weight_decay=tc.weight_decay),
        task="cifar_cnn")
    jstate = jinit(jax.random.PRNGKey(0), jexp)
    model = ResNet(depth, 10, texp.e2, width=width)
    model.load_state_dict(state_dict_from_jax(_np(jstate.params),
                                              _np(jstate.model_state)))
    jtask, ttask = jsyn.GaussianImageTask(snr=2.0), tsyn.GaussianImageTask(snr=2.0)
    jhist = JTrainer(jexp, jstate, lambda step, shard: jsyn.make_image_batch(
        jtask, 0, step, shard, batch)).run(STEPS)
    trainer = Trainer(texp, train_state_for(texp, model),
                      lambda step, shard: tsyn.make_image_batch(
                          ttask, 0, step, shard, batch, "cpu"), device="cpu")
    hist = trainer.run(STEPS)
    assert [h["step"] for h in hist] == [h["step"] for h in jhist]
    return _losses(hist), _losses(jhist)


def test_psg_off_resnet_loss_curve_matches_jax():
    got, want = resnet_curves()
    assert len(got) == STEPS
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)


def _jax_lm_losses(jexp, params, tc):
    jstate = jinit(jax.random.PRNGKey(0), jexp)
    jstate = jstate._replace(params=jax.tree.map(jnp.asarray, params))
    task = jsyn.MarkovLMTask(vocab=jexp.model.vocab_size)
    return _losses(JTrainer(jexp, jstate, lambda step, shard: jsyn.make_lm_batch(
        task, tc.seed, step, shard, tc.global_batch, tc.seq_len)).run(STEPS))


def lm_curves():
    """``(port losses, JAX losses, the JAX losses' largest move when every
    parameter moves one ulp)`` of the PSG LM, step by step."""
    texp = lm_experiment("qwen2_5_3b", steps=STEPS, smoke=True,
                         e2=E2TRAIN["psg"], fused_attention=False)
    tc = texp.train
    assert (tc.optimizer, tc.lr) == ("psg", 0.03)
    jbase = jreduce(jget("qwen2_5_3b"))
    jexp = jbase.replace(
        e2=jc.E2TrainConfig(psg=jc.PSGConfig(
            enabled=True, fused_attention=False, backend="interpret")),
        train=dataclasses.replace(jbase.train, optimizer="psg", lr=0.03,
                                  total_steps=STEPS))
    assert (jexp.train.global_batch, jexp.train.seq_len) == \
        (tc.global_batch, tc.seq_len)
    params = _np(jinit(jax.random.PRNGKey(0), jexp).params)
    model = TransformerLM(texp.model, texp.e2)
    model.load_state_dict(lm_state_dict_from_jax(params))
    want = _jax_lm_losses(jexp, params, tc)
    # the reference's own spread: every parameter one ulp up, then down
    spread = np.max([np.abs(_jax_lm_losses(jexp, jax.tree.map(
        lambda a, d=d: np.nextafter(a, d * np.inf), params), tc) - want)
        for d in (1, -1)], axis=0)

    task = tsyn.MarkovLMTask(vocab=texp.model.vocab_size)
    trainer = Trainer(texp, train_state_for(texp, model),
                      lambda step, shard: tsyn.make_lm_batch(
                          task, tc.seed, step, shard, tc.global_batch,
                          tc.seq_len, "cpu"), device="cpu")
    return _losses(trainer.run(STEPS)), want, spread


def test_psg_lm_loss_curve_matches_jax():
    got, want, spread = lm_curves()
    assert len(got) == STEPS
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2 + spread.max())
    assert np.sign(got[-1] - got[0]) == np.sign(want[-1] - want[0])
