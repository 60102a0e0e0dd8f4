"""repro_torch's SSM family against the JAX package's: the Mamba2, mLSTM and
sLSTM mixers (``models/ssm.py``), their decode steps, and the reduced
xlstm-350m and zamba2-1.2b stacks (``models/transformer.py``), on the same
parameters (``repro_torch.convert``), inputs and step keys.

Tolerances:

* each mixer in fp32 at 512 tokens (two chunks carry the state): forward,
  end state and input and weight gradients within ``rtol=1e-5`` and
  ``atol=1e-5 * max|ref|`` (the same fp32 operations in other orders),
  except Mamba2's per-head ``dt_bias`` and ``A_log`` gradients,
  ``atol=1e-4 * max|ref|``: each sums, over every token, terms through
  ``exp`` of differences of 256-term cumulative sums of the log decay, whose
  rounding (up to 2e-5 of a gap near -360) differs between the two
  packages' cumulative sums;
* each mixer in bf16: the largest error within ``2e-2 * max|ref|`` and the
  mean error within ``7e-3 * mean|ref|`` (under two bf16 roundings,
  2^-8 = 3.9e-3, on average; the reference's cast points, other rounding
  orders inside the bf16 products);
* the decode steps against the JAX steps and the prefill-to-decode handoff
  (``*_fwd(S, return_state=True)`` then one step against ``*_fwd(S + 1)``'s
  last output): ``1e-5 * max|ref|``;
* whole reduced models in fp32: logits and gradients within ``1e-5`` of
  each tensor's largest magnitude, the metrics and keep probabilities
  ``rtol=1e-5``, SLU flags equal; but Mamba2's per-head ``dt_bias``,
  ``A_log`` and ``D`` gradients ``1e-4`` (as above; ``D``'s a sum over
  every token of x times a gradient through the layers above), the SLU
  gate's parameters' ``1e-3`` (each
  a sum over every element of a gated branch's output times the stream's
  gradient, through the straight-through factor, which cancels to 1e-4 of
  its terms), zamba2's real 19-block unit ``1e-4`` (18 Mamba layers
  compound the rounding differences: 6e-5 measured with every block run),
  and under PSG zamba2's shared attention ``rtol=atol=1e-2``, as one PSG
  train step (``test_torch_encdec_moe.py``'s tolerances, with 90% of each
  updated tensor equal to 1e-6): an 8-bit code of its input flips at a
  rounding boundary when the Mamba layers before it differ in the last
  bits.
"""
import dataclasses
import tempfile

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_experiment as jget  # noqa: E402
from repro.configs import reduce_experiment as jreduce  # noqa: E402
from repro.core import config as jc  # noqa: E402
from repro.core import energy as jenergy  # noqa: E402
from repro.core import psg as jpsg  # noqa: E402
from repro.core.cost import lm_cost as jlm_cost  # noqa: E402
from repro.ft import checkpoint as jckpt  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim.api import make_optimizer as jmake_optimizer  # noqa: E402
from repro.optim.swa import swa_init as jswa_init  # noqa: E402
from repro.training.train_step import init_train_state as jinit  # noqa: E402
from repro.training.train_step import make_train_step as jmake  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import (ARCH_IDS, get_experiment,  # noqa: E402
                                 reduce_experiment)
from repro_torch.core import config as tc  # noqa: E402
from repro_torch.core import energy  # noqa: E402
from repro_torch.core import psg as tpsg  # noqa: E402
from repro_torch.core import rng  # noqa: E402
from repro_torch.core.cost import lm_cost  # noqa: E402
from repro_torch.core.slu import lm_uniforms  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.ft.checkpoint import (_flatten, restore_checkpoint,  # noqa: E402
                                       save_checkpoint, verify_checkpoint)
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models.transformer import TransformerLM, lm_loss  # noqa: E402
from repro_torch.optim.signsgd import signsgd_init  # noqa: E402
from repro_torch.optim.swa import swa_init  # noqa: E402
from repro_torch.training.train_step import (TrainState,  # noqa: E402
                                             init_train_state,
                                             make_train_step)
from repro_torch.training.trainer import Trainer  # noqa: E402

ARCHS = ["xlstm_350m", "zamba2_1_2b"]
MIXER_ARCH = {"mamba": "zamba2_1_2b", "mlstm": "xlstm_350m",
              "slstm": "xlstm_350m"}
KINDS = list(MIXER_ARCH)
MIX_B, MIX_S = 2, 512
BATCH, SEQ = 2, 16
TOL = dict(rtol=1e-2, atol=1e-2)
# the reduced zamba2 of the whole-model tests: a unit of 2 Mamba blocks and
# one shared-attention call, tiled twice (the shared block called twice)
ZAMBA_UNIT = ("mamba", "mamba", "shared_attn")
MODELS = ["xlstm_350m", "zamba2_1_2b"]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fp32_probabilities(monkeypatch):
    """The shared attention's softmax without its bf16 rounding, in both
    packages (as in ``test_torch_encdec_moe.py``): over layers, a
    probability at a bf16 rounding boundary takes the neighbouring value in
    the other package."""
    monkeypatch.setattr(JL, "_softmax_lowp",
                        lambda s: jax.nn.softmax(s, axis=-1))
    monkeypatch.setattr(L, "SoftmaxLowp", type("Softmax", (), {
        "apply": staticmethod(lambda s: torch.softmax(s, dim=-1))}))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _f64(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().float().numpy()
    return np.asarray(a, np.float64)


def _close(a, ref, rel, what=""):
    a, ref = _f64(a), _f64(ref)
    assert a.shape == ref.shape, what
    assert np.max(np.abs(a - ref)) <= rel * np.max(np.abs(ref)), what


def _allclose(a, ref, atol_rel=1e-5, err_msg=""):
    ref = _f64(ref)
    np.testing.assert_allclose(_f64(a), ref, rtol=1e-5,
                               atol=atol_rel * np.max(np.abs(ref)),
                               err_msg=err_msg)


# ---------------------------------------------------------------------------
# configs and counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_jax_field_for_field(arch, reduced):
    assert arch in ARCH_IDS
    texp, jexp = get_experiment(arch), jget(arch)
    if reduced:
        texp, jexp = reduce_experiment(texp), jreduce(jexp)
    for part in ("model", "train"):
        t, j = getattr(texp, part), getattr(jexp, part)
        for name, v in dataclasses.asdict(t).items():
            assert v == getattr(j, name), (part, name)
    assert texp.model.blocks == jexp.model.blocks
    assert texp.model.is_subquadratic == jexp.model.is_subquadratic is True
    TransformerLM(reduce_experiment(texp).model)


@pytest.mark.parametrize("arch", ARCHS)
def test_counts_equal_jax(arch):
    """``param_count``, ``block_fwd_flops`` of every kind, the cost table
    and the model's forward FLOPs, full and reduced, as the reference's
    (its estimates, zamba2's shared attention counted only under
    ``shared_attn_every``); and under a ``shared_attn_every`` too."""
    for reduce_ in (False, True):
        texp, jexp = get_experiment(arch), jget(arch)
        if reduce_:
            texp, jexp = reduce_experiment(texp), jreduce(jexp)
        t, j = texp.model, jexp.model
        assert t.param_count() == j.param_count()
        for seq in (16, 4096):
            for kind in tc.BLOCK_KINDS:
                if kind == "moe":
                    continue
                assert energy.block_fwd_flops(t, kind, seq) == \
                    jenergy.block_fwd_flops(j, kind, seq), kind
            assert [dataclasses.astuple(x) for x in lm_cost(t, seq).layers] \
                == [dataclasses.astuple(x) for x in jlm_cost(j, seq).layers]
            assert energy.model_fwd_flops(t, 2, seq) == \
                jenergy.model_fwd_flops(j, 2, seq)
        t2 = dataclasses.replace(t, shared_attn_every=6)
        j2 = dataclasses.replace(j, shared_attn_every=6)
        assert t2.param_count() == j2.param_count() > t.param_count()
        assert energy.model_fwd_flops(t2, 2, 64) == \
            jenergy.model_fwd_flops(j2, 2, 64)


# ---------------------------------------------------------------------------
# the mixers
# ---------------------------------------------------------------------------


def _mixer_pair(kind, dtype="float32"):
    arch = MIXER_ARCH[kind]
    jm = dataclasses.replace(jreduce(jget(arch)).model, dtype=dtype)
    tm = dataclasses.replace(reduce_experiment(get_experiment(arch)).model,
                             dtype=dtype)
    jp = _np(getattr(JS, f"init_{kind}")(jax.random.PRNGKey(1), jm))
    mod = S.MIXERS[kind][0](tm, torch.Generator().manual_seed(0))
    mod.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                         for k, v in convert.port_named(jp).items()})
    return jm, tm, jp, mod


def test_mixer_init_laws():
    """The reference's laws: A_log = log(1..nh), b_if = [0]*nh + [3]*nh,
    dt_bias 0, D 1, the conv at fan-in W (scale 1), projections at their
    fan-in, all within +-2 sigma."""
    g = torch.Generator().manual_seed(0)
    cfg = get_experiment("zamba2_1_2b").model
    m = S.Mamba(dataclasses.replace(cfg, d_model=256), g)
    nh = 512 // S.MAMBA_HEAD_DIM
    assert torch.equal(m.A_log, torch.log(torch.arange(1.0, nh + 1)))
    assert torch.equal(m.dt_bias, torch.zeros(nh))
    assert torch.equal(m.D, torch.ones(nh))
    conv, w_in = m.conv.detach(), m.w_in.detach()
    assert conv.shape == (4, 512) and float(conv.abs().max()) <= 1.0
    assert float(conv.std()) > 0.3
    assert float(w_in.abs().max()) <= 2 / 256 ** 0.5
    x = S.MLSTM(reduce_experiment(get_experiment("xlstm_350m")).model, g)
    assert x.b_if.tolist() == [0.0] * 4 + [3.0] * 4
    assert x.wq.shape == (128, 4, 32)


@pytest.mark.parametrize("kind", KINDS)
def test_mixer_fwd_state_and_grads_match_jax(kind):
    jm, tm, jp, mod = _mixer_pair(kind)
    r = np.random.RandomState(0)
    u = r.randn(MIX_B, MIX_S, tm.d_model).astype(np.float32)
    g = r.randn(MIX_B, MIX_S, tm.d_model).astype(np.float32)
    fwd = getattr(JS, f"{kind}_fwd")

    @jax.jit
    def jf(p, x, gy):
        (y, st), vjp = jax.vjp(lambda p_, x_: fwd(p_, x_, jm,
                                                  return_state=True), p, x)
        return y, st, vjp((gy, jax.tree.map(jnp.zeros_like, st)))
    jy, jst, (jdp, jdu) = jf(jax.tree.map(jnp.asarray, jp), jnp.asarray(u),
                             jnp.asarray(g))
    ut = torch.from_numpy(u).requires_grad_()
    y, st = S.MIXERS[kind][1](mod, ut, tm, return_state=True)
    y.backward(torch.from_numpy(g))
    _allclose(y.detach(), jy, err_msg="y")
    assert set(st) == set(jst)
    for k in st:
        assert st[k].dtype == torch.float32
        _allclose(st[k], jst[k], err_msg=k)
    _allclose(ut.grad, jdu, err_msg="du")
    for n, p in mod.named_parameters():
        wide = kind == "mamba" and n in ("dt_bias", "A_log")
        _allclose(p.grad, jdp[n], 1e-4 if wide else 1e-5, err_msg=n)


@pytest.mark.parametrize("kind", KINDS)
def test_mixer_bf16_forward_matches_jax(kind):
    jm, tm, jp, mod = _mixer_pair(kind, "bfloat16")
    r = np.random.RandomState(0)
    u = jnp.asarray(r.randn(MIX_B, MIX_S, tm.d_model), jnp.bfloat16)
    jy = np.asarray(getattr(JS, f"{kind}_fwd")(
        jax.tree.map(jnp.asarray, jp), u, jm).astype(jnp.float32))
    with torch.no_grad():
        y = S.MIXERS[kind][1](mod, torch.from_numpy(
            np.array(u.astype(jnp.float32))).bfloat16(), tm)
    assert y.dtype == torch.bfloat16
    err = np.abs(y.float().numpy() - jy)
    assert err.max() <= 2e-2 * np.abs(jy).max()
    assert err.mean() <= 7e-3 * np.abs(jy).mean()


def test_full_width_slstm_is_chaotic_in_both_packages():
    """At xlstm-350m's widths the reference's sLSTM recurrence is chaotic:
    its recurrent weights' fan-in is the 4 heads (std 0.5 into 256-wide
    sums).  The port keeps that law and so the behaviour: the two
    packages' forwards agree on the first tokens and part within 40, and
    the input gradient grows by more than 20 orders of magnitude back to
    the early tokens of a 256-token sequence in both (to inf in some
    sequences), while the last token's stays small."""
    jm = dataclasses.replace(jget("xlstm_350m").model, dtype="float32")
    tm = dataclasses.replace(get_experiment("xlstm_350m").model,
                             dtype="float32")
    jp = _np(JS.init_slstm(jax.random.PRNGKey(1), jm))
    mod = S.SLSTM(tm, torch.Generator().manual_seed(0))
    mod.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in convert.port_named(jp).items()})
    assert float(mod.r_g.detach().std()) > 0.4       # 1 / sqrt(4), cut
    u = np.random.RandomState(0).randn(1, 256, 1024).astype(np.float32)
    jdu = jax.jit(jax.grad(lambda x: JS.slstm_fwd(
        jax.tree.map(jnp.asarray, jp), x, jm).sum() * 1e-6))(jnp.asarray(u))
    jy = JS.slstm_fwd(jax.tree.map(jnp.asarray, jp), jnp.asarray(u[:, :64]),
                      jm)
    ut = torch.from_numpy(u).requires_grad_()
    (S.slstm_fwd(mod, ut, tm).sum() * 1e-6).backward()
    with torch.no_grad():
        y = S.slstm_fwd(mod, ut[:, :64], tm)
    _close(y[:, :4], jy[:, :4], 1e-5)
    assert np.abs(y[:, 40:].numpy() - np.asarray(jy[:, 40:])).max() > 0.1
    for du in (ut.grad.numpy(), np.asarray(jdu)):
        big = np.where(np.isfinite(du), np.abs(du), np.inf)[0]
        assert big[:16].max() > 1e20 * big[-1].max()
        assert big[-1].max() < 1e-4


def test_sequence_not_a_chunk_multiple_raises():
    for kind in ("mamba", "mlstm"):
        _, tm, _, mod = _mixer_pair(kind)
        with torch.no_grad():
            S.MIXERS[kind][1](mod, torch.zeros(1, 200, tm.d_model), tm)
            with pytest.raises(ValueError, match="divisible by chunk 256"):
                S.MIXERS[kind][1](mod, torch.zeros(1, 300, tm.d_model), tm)


@pytest.mark.parametrize("kind", KINDS)
def test_decode_step_matches_jax_and_continues_prefill(kind):
    """``init_<kind>_state`` equals the reference's; one ``<kind>_step``
    from a prefilled state against the JAX step from the same state; and
    the handoff: ``fwd(S, return_state=True)`` then one step gives
    ``fwd(S + 1)``'s last output, at S = 255 (one chunk) and at S = 512
    (two chunks; against ``fwd(768)`` at position 512)."""
    jm, tm, jp, mod = _mixer_pair(kind)
    jpj = jax.tree.map(jnp.asarray, jp)
    fwd, step = S.MIXERS[kind][1], getattr(S, f"{kind}_step")
    jfwd, jstep = getattr(JS, f"{kind}_fwd"), getattr(JS, f"{kind}_step")
    init = getattr(S, f"init_{kind}_state")(tm, 2)
    jinit_ = getattr(JS, f"init_{kind}_state")(jm, 2)
    assert set(init) == set(jinit_)
    for k in init:
        np.testing.assert_array_equal(init[k].numpy(), np.asarray(jinit_[k]))
    r = np.random.RandomState(5)
    u = r.randn(2, 769, tm.d_model).astype(np.float32)
    ut = torch.from_numpy(u)
    with torch.no_grad():
        for n, whole in ((255, 256), (512, 768)):
            _, st = fwd(mod, ut[:, :n], tm, return_state=True)
            y1, st1 = step(mod, ut[:, n:n + 1], st, tm)
            _close(y1, fwd(mod, ut[:, :whole], tm)[:, n:n + 1], 1e-5)
        jy1, jst1 = jstep(jpj, jnp.asarray(u[:, 512:513]),
                          {k: jnp.asarray(v.numpy()) for k, v in st.items()},
                          jm)
    _close(y1, jy1, 1e-5)
    for k in st1:
        assert st1[k].dtype == torch.float32
        _close(st1[k], jst1[k], 1e-5)


# ---------------------------------------------------------------------------
# whole reduced models
# ---------------------------------------------------------------------------


def _reduced(arch, jax_side):
    exp = jreduce(jget(arch)) if jax_side else \
        reduce_experiment(get_experiment(arch))
    if arch == "zamba2_1_2b":
        exp = exp.replace(model=dataclasses.replace(
            exp.model, block_unit=ZAMBA_UNIT, num_layers=6))
    return exp


def _configs(arch, psg_on=False):
    """The reduced ``arch`` in both packages (zamba2 as :data:`ZAMBA_UNIT`
    tiled twice), SLU on, PSG on (``psg`` at lr 0.03, SWA from step 0) or
    off (``sgdm`` at lr 0.01), ``remat="none"``."""
    opt = dict(optimizer="psg", lr=0.03) if psg_on else \
        dict(optimizer="sgdm", lr=0.01)

    def cut(exp, e2):
        tr = dataclasses.replace(exp.train, total_steps=6, remat="none",
                                 **opt)
        return exp.replace(e2=e2, train=tr)

    jexp = cut(_reduced(arch, True), jc.E2TrainConfig(
        slu=jc.SLUConfig(enabled=True),
        psg=jc.PSGConfig(enabled=psg_on, backend="interpret",
                         fused_attention=False, swa_start_frac=0.0)))
    texp = cut(_reduced(arch, False), tc.E2TrainConfig(
        slu=tc.SLUConfig(enabled=True),
        psg=tc.PSGConfig(enabled=psg_on, fused_attention=False,
                         swa_start_frac=0.0)))
    return jexp, texp


_JSTATES = {}


def _jstate(arch, psg_on=False):
    if (arch, psg_on) not in _JSTATES:
        jexp, _ = _configs(arch, psg_on)
        st = jinit(jax.random.PRNGKey(0), jexp)
        _JSTATES[arch, psg_on] = st._replace(
            opt=jmake_optimizer(jexp.train).init(st.params),
            swa=jswa_init(st.params) if psg_on else None)
    return _JSTATES[arch, psg_on]


def _port_model(texp, jparams):
    model = TransformerLM(texp.model, texp.e2)
    model.load_state_dict(convert.lm_state_dict_from_jax(_np(jparams)))
    return model


def _batch(step=0):
    return tsyn.make_lm_batch(tsyn.MarkovLMTask(vocab=128), 0, step, 0, BATCH,
                              SEQ, "cpu")


def _jbatch(tb):
    return {k: jnp.asarray(v.numpy().astype(np.int32)) for k, v in tb.items()}


def _grad_rel(name):
    """The tolerance of a parameter's gradient (module docstring)."""
    if name.startswith("slu_gate."):
        return 1e-3
    return 1e-4 if name.endswith((".dt_bias", ".A_log", ".D")) else 1e-5


def _grads_by_name(model, jgrads):
    want = convert.port_named(_np(jgrads))
    got = {n: (torch.zeros_like(p) if p.grad is None else p.grad)
           for n, p in model.named_parameters()}
    assert set(want) == set(got)
    return got, want


@pytest.mark.parametrize("arch,psg_on", [
    ("xlstm_350m", False), ("zamba2_1_2b", False), ("zamba2_1_2b", True)],
    ids=["xlstm_350m", "zamba2_1_2b", "zamba2_1_2b-psg_on"])
def test_forward_loss_slu_and_grads_match_jax(arch, psg_on,
                                               fp32_probabilities):
    """Logits, the metrics, ``slu_executed`` (``(units, sub-blocks a
    unit)``: the shared attention's calls executed, never gated),
    ``slu_keep_probs`` and ``slu_cost`` from the same step keys, and (PSG
    off) every parameter's gradient of the total loss, the shared
    attention's summed over its two calls."""
    jexp, texp = _configs(arch, psg_on)
    jparams = _jstate(arch, psg_on).params
    model = _port_model(texp, jparams)
    tb = _batch()
    jb = _jbatch(tb)
    jcfg = jexp.e2.psg if psg_on else None

    @jax.jit
    def jrun(params, batch, jrng):
        with jpsg.enable(jcfg):
            out = JT.lm_fwd(params, batch["tokens"], jexp.model, jexp.e2,
                            jrng, remat="none")
            (total, met), grads = jax.value_and_grad(
                lambda p: JT.lm_loss(p, batch, jexp.model, jexp.e2, jrng,
                                     remat="none"), has_aux=True)(params)
        return out, total, met, grads

    n_units = 1 if arch == "xlstm_350m" else 2
    subs = 4 if arch == "xlstm_350m" else 3
    flips = psg_on         # zamba2's shared attention under PSG: docstring
    rel, tol = (1e-2, TOL) if flips else (1e-5, dict(rtol=1e-5, atol=1e-7))
    flags = set()
    for step in range(2):
        jrng = jax.random.fold_in(jax.random.PRNGKey(0), step)
        key = rng.fold_in(rng.PRNGKey(0), step)
        out, jtotal, jmet, jgrads = jrun(jparams, jb, jrng)
        model.zero_grad()
        with tpsg.enable(texp.e2.psg if psg_on else None,
                         probe=tpsg.zero_probe()):
            logits, aux = model(tb["tokens"], key, remat="none")
            total, met = lm_loss(model, tb, key, remat="none")
        total.backward()
        _close(logits.detach(), out.logits, rel)
        assert aux["slu_executed"].shape == (n_units, subs)
        np.testing.assert_array_equal(aux["slu_executed"].numpy(),
                                      np.asarray(out.slu_executed))
        np.testing.assert_allclose(aux["slu_keep_probs"].detach().numpy(),
                                   np.asarray(out.slu_keep_probs).ravel(),
                                   **tol)
        for k in met:
            np.testing.assert_allclose(float(met[k].detach()),
                                       float(jmet[k]), **tol, err_msg=k)
        np.testing.assert_allclose(float(total.detach()), float(jtotal),
                                   **tol)
        if arch == "zamba2_1_2b":   # the shared calls: kept, probability 1
            assert aux["slu_executed"][:, 2].tolist() == [1.0, 1.0]
            assert aux["slu_keep_probs"].reshape(2, 3)[:, 2].tolist() == \
                [1.0, 1.0]
        flags.add(tuple(aux["slu_executed"].ravel().tolist()))
        if psg_on:
            continue
        got, want = _grads_by_name(model, jgrads)
        for n in got:
            assert np.any(want[n]) or not np.any(got[n].numpy()), n
            if np.any(want[n]):
                _close(got[n], want[n], _grad_rel(n), n)
        if arch == "zamba2_1_2b":
            assert float(model.shared.attn.wq.grad.abs().sum()) > 0
    assert len(flags) == 2 or psg_on


def test_zamba2_reduced_unit_of_19_blocks_forward_matches_jax(
        fp32_probabilities):
    """zamba2's real unit (18 Mamba blocks and the shared attention) at the
    reduced widths, SLU on: logits, flags and keep probabilities; the
    uniforms are one per Mamba block (none for the shared call)."""
    jexp = jreduce(jget("zamba2_1_2b")).replace(
        e2=jc.E2TrainConfig(slu=jc.SLUConfig(enabled=True)))
    texp = reduce_experiment(get_experiment("zamba2_1_2b")).replace(
        e2=tc.E2TrainConfig(slu=tc.SLUConfig(enabled=True)))
    assert texp.model.num_layers == 19
    jparams = jinit(jax.random.PRNGKey(0), jexp).params
    model = _port_model(texp, jparams)
    tb = _batch()
    jrng = jax.random.fold_in(jax.random.PRNGKey(0), 3)
    out = JT.lm_fwd(jparams, _jbatch(tb)["tokens"], jexp.model, jexp.e2,
                    jrng, remat="none")
    key = rng.fold_in(rng.PRNGKey(0), 3)
    assert lm_uniforms(key, texp.model).shape == (18,)
    with torch.no_grad():
        logits, aux = model(tb["tokens"], key, remat="none")
    _close(logits, out.logits, 1e-4)
    assert aux["slu_executed"].shape == (1, 19)
    np.testing.assert_array_equal(aux["slu_executed"].numpy(),
                                  np.asarray(out.slu_executed))
    np.testing.assert_allclose(aux["slu_keep_probs"].numpy(),
                               np.asarray(out.slu_keep_probs).ravel(),
                               rtol=1e-5)
    assert 0.0 in aux["slu_executed"].tolist()[0]


@pytest.mark.parametrize("arch", MODELS)
def test_one_train_step_matches_jax(arch):
    """One ``--e2train``-style step (SLU, PSG with the ``psg`` optimizer
    and SWA) through ``make_train_step`` against the JAX package's."""
    jexp, texp = _configs(arch, True)
    jstate = _jstate(arch, True)
    model = _port_model(texp, jstate.params)
    params = dict(model.named_parameters())
    state = TrainState(model, signsgd_init(params), swa_init(params), 0)
    jnew, jmet = jax.jit(jmake(jexp))(jstate, _jbatch(_batch()))
    new, met = make_train_step(texp)(state, _batch())
    assert new.step == int(jnew.step) == 1
    assert set(met) == set(jmet)
    for k in ("loss", "total_loss", "slu_cost", "slu_exec_ratio"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), **TOL,
                                   err_msg=k)
    # the step's gradient (the port's, which the forward test holds to the
    # JAX package's): an element within 1e-6 of its tensor's largest is the
    # rounding noise of an analytically zero one (the sLSTM input gate's
    # bias where the stabilizer takes that gate), whose sign, the psg
    # optimizer's update, either package may take (a zero one is exact)
    grad_model = _port_model(texp, jstate.params)
    with tpsg.enable(texp.e2.psg, probe=tpsg.zero_probe()):
        lm_loss(grad_model, _batch(), rng.fold_in(rng.PRNGKey(0), 0),
                remat="none")[0].backward()
    want = convert.lm_state_dict_from_jax(_np(jnew.params))
    grads = dict(grad_model.named_parameters())
    for name, p in new.model.named_parameters():
        g = grads[name].grad
        g = np.zeros(p.shape) if g is None else np.abs(g.numpy())
        signed = (g == 0) | (g > 1e-6 * g.max())
        same = np.isclose(p.detach().numpy(), want[name].numpy(), rtol=0,
                          atol=1e-6)[signed]
        assert same.size == 0 or same.mean() >= 0.9, (name, same.mean())


@pytest.mark.parametrize("arch", MODELS)
def test_chunked_loop_equals_per_step_loop(arch):
    """The reduced model through the chunked loop (K = 4) and the per-step
    loop, PSG on: losses, SLU flags and final parameters bit for bit, a
    gated SSM sub-block skipped among them."""
    _, texp = _configs(arch, True)
    texp = texp.replace(train=dataclasses.replace(texp.train, total_steps=12))
    task = tsyn.MarkovLMTask(vocab=128)

    def trainer(**kw):
        return Trainer(texp, init_train_state(texp, seed=0, device="cpu"),
                       lambda s, sh: tsyn.make_lm_batch(task, 0, s, sh, BATCH,
                                                        SEQ, "cpu"),
                       device="cpu", **kw)
    a, b = trainer(), trainer(chunk_steps=4)
    ha, hb = a.run(12), b.run(12)
    assert [(h["step"], h["loss"], h["slu_executed"]) for h in ha] == \
        [(h["step"], h["loss"], h["slu_executed"]) for h in hb]
    assert any(0.0 in h["slu_executed"] for h in ha)
    for (n, x), (_, y) in zip(a.state.model.named_parameters(),
                              b.state.model.named_parameters()):
        assert torch.equal(x, y), n


# ---------------------------------------------------------------------------
# conversion, checkpoints, the CLI
# ---------------------------------------------------------------------------


def test_convert_round_trips_the_19_block_unit():
    """zamba2's reduced 19-block unit: ``jax_tree`` gives the JAX tree's
    structure (its empty ``b18_shared_attn`` kept, the top-level
    ``shared``) and values, leaves in JAX's order (``b10_mamba`` before
    ``b1_mamba``), and ``lm_state_dict_from_jax`` inverts it bit for bit;
    layer ``j`` is ``units.b{j % 19}_{kind}[j // 19]``."""
    jexp = jreduce(jget("zamba2_1_2b"))
    texp = reduce_experiment(get_experiment("zamba2_1_2b"))
    texp = texp.replace(model=dataclasses.replace(texp.model, num_layers=38))
    jexp = jexp.replace(model=dataclasses.replace(jexp.model, num_layers=38))
    want = _np(jinit(jax.random.PRNGKey(0), jexp).params)
    assert want["units"]["b18_shared_attn"] == {}
    model = _port_model(texp, want)
    named = dict(model.named_parameters())
    back = convert.jax_tree(named, model.unit)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    paths = [tuple(str(getattr(k, "key", k)) for k in p)
             for p, _ in jax.tree_util.tree_leaves_with_path(want)]
    assert [p for p, _ in convert.leaves(back)] == paths
    assert paths.index(("units", "b10_mamba", "ln1", "scale")) < \
        paths.index(("units", "b1_mamba", "ln1", "scale"))
    for (path, a), b in zip(convert.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    np.testing.assert_array_equal(
        named["layers.20.mamba.w_in"].detach().numpy(),
        want["units"]["b1_mamba"]["mamba"]["w_in"][1])
    assert not any(n.startswith("layers.18.") for n in named)
    sd = convert.lm_state_dict_from_jax(back)
    for n, p in named.items():
        assert torch.equal(sd[n], p.detach()), n


@pytest.mark.parametrize("arch", MODELS)
def test_checkpoints_cross_load(arch):
    """A port checkpoint (params, signSGD momentum, SWA) restored by the
    JAX package, every leaf equal, and a JAX checkpoint restored by the
    port."""
    _, texp = _configs(arch, True)
    jstate = _jstate(arch, True)
    model = _port_model(texp, jstate.params)
    params = dict(model.named_parameters())
    state = TrainState(model, signsgd_init(params), swa_init(params), 4)
    tree = convert.train_state_tree(state)
    assert jax.tree.structure(tree["params"]) == \
        jax.tree.structure(_np(jstate.params))
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, state, 4)
        assert jckpt.verify_checkpoint(d, 4) == (True, "ok")
        jtree, step = jckpt.restore_checkpoint(d, jstate)
    assert step == 4
    flat, jflat = _flatten(tree), jckpt._flatten(jtree)
    assert set(flat) == set(jflat)
    for k in flat:
        np.testing.assert_array_equal(np.asarray(jflat[k]), flat[k],
                                      err_msg=k)
    with tempfile.TemporaryDirectory() as d:
        jckpt.save_checkpoint(d, jstate, 5)
        assert verify_checkpoint(d, 5) == (True, "ok")
        fresh = init_train_state(texp, device="cpu")
        restored, step = restore_checkpoint(d, fresh)
    assert step == 5
    want = convert.lm_state_dict_from_jax(_np(jstate.params))
    for name, p in restored.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[name].numpy(),
                                      err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_trains_each_arch_on_the_cpu(arch, capsys):
    tr = train.run(["--task", "lm", "--arch", arch, "--smoke", "--steps",
                    "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert tr.exp.model.name == get_experiment(arch).model.name
    assert tr.executed_steps > 0 and "held-out accuracy" in out
    assert ("units of 3 mlstm + 1 slstm" in out) == (arch == "xlstm_350m")
    assert ("1 units of 18 mamba + 1 shared_attn" in out) == \
        (arch == "zamba2_1_2b")
    assert all(np.isfinite(h["loss"]) for h in tr.history)
