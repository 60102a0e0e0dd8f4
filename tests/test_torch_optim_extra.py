"""repro_torch's AdamW and error feedback against the JAX package's, over
three steps from the same parameters and gradients (a numpy seed), and the
optimizer states' layout, which checkpoints share with the JAX package.

Tolerances: the same float32 operations in the same order, with the
AdamW bias corrections as float32 powers of the int32 count in both
packages (numpy's ``pow`` against XLA's): ``rtol=1e-6`` on parameters and
moments.  Error feedback's sign payload is compared exactly, its residual
within ``1e-6`` of the corrected gradient's largest magnitude: a float32
mean of magnitudes, summed in another order, then subtracted from terms of
nearly its size.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.optim import error_feedback as jef  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro.optim import signsgd as jsignsgd  # noqa: E402
from repro_torch.core import config as tc  # noqa: E402
from repro_torch.optim import error_feedback as tef  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.optim import sgd as tsgd  # noqa: E402

SHAPES = {"w": (6, 5), "b": (5,), "e": (3, 4, 2)}
TOL = dict(rtol=1e-6, atol=1e-7)


def _draw(r, scale=1.0):
    return {k: (scale * r.randn(*s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _close(t, j, **tol):
    for k in SHAPES:
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]),
                                   **(tol or TOL), err_msg=k)


def test_adamw_matches_jax_over_three_steps():
    r = np.random.RandomState(0)
    p0 = _draw(r)
    params, jparams = _t(p0), jax.tree.map(jnp.asarray, p0)
    state, jstate = tsgd.adamw_init(params), jsgd.adamw_init(jparams)
    for step in range(3):
        g = _draw(r, 0.1)
        lr = 0.01 * (step + 1)
        tsgd.adamw_apply(params, _t(g), state, lr)
        jparams, jstate = jsgd.adamw_apply(jparams, jax.tree.map(
            jnp.asarray, g), jstate, lr)
        assert state["count"] == int(jstate["count"]) == step + 1
        _close(params, jparams)
        _close(state["mu"], jstate["mu"])
        _close(state["nu"], jstate["nu"])


def test_ef_compress_matches_jax_over_three_steps():
    r = np.random.RandomState(1)
    like = _t(_draw(r))
    state = tef.ef_init(like)
    jstate = jef.ef_init(jax.tree.map(jnp.asarray, {k: v.numpy()
                                                    for k, v in like.items()}))
    assert all(v.dtype == torch.float32 and not v.any()
               for v in state["residual"].values())
    for scale in (1.0, 0.5, 1.0):
        g = _draw(r)
        big = max(float((torch.from_numpy(g[k]) + state["residual"][k])
                        .abs().max()) for k in SHAPES)
        payload, state = tef.ef_compress(_t(g), state, scale)
        jpayload, jstate = jef.ef_compress(jax.tree.map(jnp.asarray, g),
                                           jstate, scale)
        for k in SHAPES:
            np.testing.assert_array_equal(payload[k].numpy(),
                                          np.asarray(jpayload[k]))
        _close(state["residual"], jstate["residual"], rtol=0,
               atol=1e-6 * big)


@pytest.mark.parametrize("name", ["sgdm", "signsgd", "psg", "adamw"])
def test_optimizer_states_keep_the_jax_layout(name):
    cfg = tc.TrainConfig(optimizer=name, lr=0.1, schedule="constant")
    opt = make_optimizer(cfg)
    assert opt.name == name
    r = np.random.RandomState(2)
    p0 = _draw(r)
    params = _t(p0)
    state = opt.init(params)
    jinit = {"sgdm": jsgd.sgd_init, "adamw": jsgd.adamw_init}.get(
        name, jsignsgd.signsgd_init)
    jstate = jinit(jax.tree.map(jnp.asarray, p0))
    assert set(state) == set(jstate)
    for k, v in state.items():
        if isinstance(v, dict):
            assert set(v) == set(jstate[k])
        else:
            assert v == int(jstate[k]) == 0
    g = _draw(r)
    opt.apply(params, _t(g), state, 0)
    jparams = dict(jax.tree.map(jnp.asarray, p0))
    jg = jax.tree.map(jnp.asarray, g)
    if name == "sgdm":
        jparams, jstate = jsgd.sgd_apply(jparams, jg, jstate, 0.1,
                                         momentum=cfg.momentum,
                                         weight_decay=cfg.weight_decay)
    elif name == "adamw":
        jparams, jstate = jsgd.adamw_apply(jparams, jg, jstate, 0.1,
                                           weight_decay=cfg.weight_decay)
    else:
        jparams, jstate = jsignsgd.signsgd_apply(
            jparams, jg, jstate, 0.1,
            momentum=cfg.momentum if name == "signsgd" else 0.0,
            weight_decay=cfg.weight_decay)
    _close(params, jparams)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer(tc.TrainConfig(optimizer="lion"))
