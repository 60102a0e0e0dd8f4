"""repro_torch's ResNet against the JAX package's, on the same parameters.

Parameters come from the JAX init through ``repro_torch.convert``; the SLU
keep decisions of the port are injected from the JAX forward's
``aux["slu_executed"]`` under the same ``rng`` (the two packages draw from
different random streams).  The JAX side runs PSG on its ``reference``
backend: the signs are those of the kernels (element-level Eq. 2 equals the
tile-level select), only the fallback ratio differs, and that is compared
per conv in ``test_torch_conv.py`` and per step in ``test_torch_train.py``.

Tolerances: each conv agrees with the JAX one to about 1e-7 relative
(fp32 sums in another order, ``test_torch_conv.py``), but every conv input
is rounded onto an 8-bit grid, and an activation that lies within that
difference of a rounding boundary takes the neighbouring code: a step of
``max|x| / 127``.  At these sizes a layer holds a few such elements, and
their steps reach the logits at about 1e-3, so logits, loss and BatchNorm
state are compared at ``rtol=atol=1e-2``.  One flipped code also moves
every output gradient by about 1e-3 relative, and a weight-gradient
element that falls back to the full product changes sign when its sum is
that close to zero.  Over 4096 positions such a sum is about 60 times
smaller than the sum of its terms' magnitudes, so a few percent of the
signs can move: at least 90% of each conv's signs must agree (measured:
93-100% at depth 14, 97.7-100% at depth 8).  Each conv taken alone, with
the same output gradient, gives equal signs (``test_torch_conv.py``).
"""
import copy

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import psg as jpsg  # noqa: E402
from repro.core.config import E2TrainConfig as JE2  # noqa: E402
from repro.core.config import PSGConfig as JPSG  # noqa: E402
from repro.core.config import SLUConfig as JSLU  # noqa: E402
from repro.models import resnet as JR  # noqa: E402
from repro_torch.convert import state_dict_from_jax  # noqa: E402
from repro_torch.core import psg as tpsg  # noqa: E402
from repro_torch.core.config import E2TrainConfig, PSGConfig, SLUConfig  # noqa: E402
from repro_torch.models.resnet import ResNet, resnet_loss  # noqa: E402

WIDTH, BATCH, STEP = 8, 4, 0     # step 0 skips a block at depth 14 (seed 0)
JE2_CFG = JE2(slu=JSLU(enabled=True),
              psg=JPSG(enabled=True, fused_conv=True, backend="reference"))
E2_CFG = E2TrainConfig(slu=SLUConfig(enabled=True), psg=PSGConfig(enabled=True))
TOL = dict(rtol=1e-2, atol=1e-2)
SIGN_AGREEMENT = 0.90


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _setup(depth):
    params, state = JR.init_resnet(jax.random.PRNGKey(0), depth, e2=JE2_CFG,
                                   width=WIDTH)
    r = np.random.RandomState(depth)
    batch = {"image": r.randn(BATCH, 32, 32, 3).astype(np.float32),
             "label": r.randint(0, 10, (BATCH,)).astype(np.int32)}
    rng = jax.random.fold_in(jax.random.PRNGKey(0), STEP)
    model = ResNet(depth, 10, E2_CFG, width=WIDTH)
    model.load_state_dict(state_dict_from_jax(_np(params), _np(state)))
    return params, state, batch, rng, model


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("depth", [8, 14])
def test_convert_round_trips_every_leaf(depth):
    params, state, _, _, model = _setup(depth)
    sd = model.state_dict()
    assert sum(p.numel() for p in model.parameters()) == \
        sum(np.size(x) for x in jax.tree.leaves(params))
    assert sum(b.numel() for b in model.buffers()) == \
        sum(np.size(x) for x in jax.tree.leaves(state))
    np.testing.assert_array_equal(sd["stem.w"].numpy(), params["stem"]["w"])
    if depth > 8:
        np.testing.assert_array_equal(
            sd["stages.2.1.conv2.w"].numpy(),
            params["stages"][2]["rest"]["conv2"]["w"][0])


@pytest.mark.parametrize("depth", [8, 14])
def test_forward_loss_and_bn_state_match_jax(depth):
    params, state, batch, rng, model = _setup(depth)
    jb = jax.tree.map(jnp.asarray, batch)
    with jpsg.enable(JE2_CFG.psg):
        jlogits, aux, _ = JR.resnet_fwd(params, state, jb["image"], depth,
                                        JE2_CFG, rng)
        jtotal, (jmet, jstate) = JR.resnet_loss(params, state, jb, depth,
                                                JE2_CFG, rng)
    keep = [bool(e) for e in np.asarray(aux["slu_executed"])]
    if depth == 14:
        assert not all(keep), "the case is meant to skip a block"
    tb = _torch_batch(batch)
    with tpsg.enable(E2_CFG.psg, probe=tpsg.zero_probe()):
        # a copy: each train-mode forward updates the BatchNorm buffers
        logits, taux = copy.deepcopy(model)(tb["image"], keep=keep)
        total, met = resnet_loss(model, tb, keep=keep)
    np.testing.assert_allclose(logits.detach().numpy(), jlogits, **TOL)
    np.testing.assert_array_equal(taux["slu_executed"].numpy(),
                                  aux["slu_executed"])
    np.testing.assert_allclose(taux["slu_keep_probs"].detach().numpy(),
                               aux["slu_keep_probs"], **TOL)
    np.testing.assert_allclose(float(total.detach()), float(jtotal), **TOL)
    for k in ("loss", "slu_cost", "slu_exec_ratio"):
        np.testing.assert_allclose(float(met[k].detach()), float(jmet[k]), **TOL)
    new_state = state_dict_from_jax(_np(params), _np(jstate))
    for name, buf in model.named_buffers():
        np.testing.assert_allclose(buf.numpy(), new_state[name].numpy(),
                                   **TOL, err_msg=name)


@pytest.mark.parametrize("depth", [8, 14])
def test_conv_weight_gradient_signs_agree_with_jax(depth):
    params, state, batch, rng, model = _setup(depth)
    jb = jax.tree.map(jnp.asarray, batch)

    def jloss(p):
        with jpsg.enable(JE2_CFG.psg):
            return JR.resnet_loss(p, state, jb, depth, JE2_CFG, rng)[0]

    with jpsg.enable(JE2_CFG.psg):
        _, aux, _ = JR.resnet_fwd(params, state, jb["image"], depth, JE2_CFG,
                                  rng)
    keep = [bool(e) for e in np.asarray(aux["slu_executed"])]
    jgrads = state_dict_from_jax(_np(jax.grad(jloss)(params)), _np(state))
    probe = tpsg.zero_probe()
    with tpsg.enable(E2_CFG.psg, probe=probe):
        total, _ = resnet_loss(model, _torch_batch(batch), keep=keep)
    names, ps = zip(*model.named_parameters())
    grads = torch.autograd.grad(total, ps, allow_unused=True)
    n_conv = 0
    for name, g, p in zip(names, grads, ps):
        if not name.endswith(".w"):
            continue
        n_conv += 1
        g = torch.zeros_like(p) if g is None else g
        agree = float((g.sign() == jgrads[name].sign()).float().mean())
        assert agree >= SIGN_AGREEMENT, (name, agree)
    assert n_conv == 1 + 3 * 2 * ((depth - 2) // 6) + 2
    skipped = [i for i, k in enumerate(keep) if not k]
    for i in skipped:       # a skipped block gets no PSG gradient at all
        s, b = divmod(i, (depth - 2) // 6)
        assert grads[names.index(f"stages.{s}.{b}.conv1.w")] is None
