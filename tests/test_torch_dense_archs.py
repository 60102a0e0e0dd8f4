"""repro_torch's dense decoder family (llama3-8b, starcoder2-15b,
h2o-danube-3-4b) against the JAX package's, on the same parameters
(``repro_torch.convert``), batches and step keys; the sliding-window and
query-chunked attention paths, ``remat="full"`` and the fault-injection
record.

The JAX side runs PSG on its ``interpret`` backend with
``fused_attention=False`` and ``remat="none"``, as ``test_torch_lm.py``
does, and on the tolerances stated there: ``1e-5`` of the largest
magnitude for fp32 forwards; ``1e-3`` where the bf16 probabilities of the
softmax enter (one probability at a rounding boundary takes the
neighbouring bf16 value in the other package); ``rtol=atol=1e-2`` for the
metrics of one PSG train step and at least 90% of each updated parameter
tensor equal to 1e-6.  The biases (QKV, MLP and layernorm), which the JAX
init sets to zero, are drawn from a numpy seed in both packages, so that
every leaf counts.  The query-chunked path runs at small chunk constants
set in both modules (``monkeypatch``), and once forward at the real ones.
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_experiment as jget  # noqa: E402
from repro.configs import reduce_experiment as jreduce  # noqa: E402
from repro.core import config as jc  # noqa: E402
from repro.core import psg as jpsg  # noqa: E402
from repro.core.cost import lm_cost as jlm_cost  # noqa: E402
from repro.ft import checkpoint as jckpt  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim.api import make_optimizer as jmake_optimizer  # noqa: E402
from repro.optim.swa import swa_init as jswa_init  # noqa: E402
from repro.training.train_step import init_train_state as jinit  # noqa: E402
from repro.training.train_step import make_train_step as jmake  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import (ARCH_IDS, get_experiment,  # noqa: E402
                                 reduce_experiment)
from repro_torch.core import config as tc  # noqa: E402
from repro_torch.core import psg as tpsg  # noqa: E402
from repro_torch.core import rng  # noqa: E402
from repro_torch.core.cost import lm_cost  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.ft.checkpoint import _flatten  # noqa: E402
from repro_torch.launch import bench_ft, bench_run, train  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.transformer import TransformerLM, lm_loss  # noqa: E402
from repro_torch.optim.signsgd import signsgd_init  # noqa: E402
from repro_torch.optim.swa import swa_init  # noqa: E402
from repro_torch.training.train_step import (TrainState,  # noqa: E402
                                             make_train_step)

ARCHS = ["llama3_8b", "starcoder2_15b", "h2o_danube_3_4b"]
LAYERS, BATCH, SEQ, STEPS = 3, 2, 16, 6
TOL = dict(rtol=1e-2, atol=1e-2)
BIASES = ("bias", "bq", "bk", "bv", "b_up", "b_down")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread each, as in ``test_torch_bench_paper.py``: under
    parallel test workers every thread of every worker contends for the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, remat="none"):
    """The reduced ``arch`` in both packages, three layers (the middle one
    SLU-gated), E2-Train full, SWA from step 0."""
    def cut(exp, e2):
        model = dataclasses.replace(exp.model, num_layers=LAYERS)
        tr = dataclasses.replace(exp.train, optimizer="psg", lr=0.03,
                                 total_steps=STEPS, remat=remat)
        return exp.replace(model=model, e2=e2, train=tr)

    jexp = cut(jreduce(jget(arch)), jc.E2TrainConfig(
        slu=jc.SLUConfig(enabled=True),
        psg=jc.PSGConfig(enabled=True, fused_attention=False,
                         backend="interpret", swa_start_frac=0.0)))
    texp = cut(reduce_experiment(get_experiment(arch)), tc.E2TrainConfig(
        slu=tc.SLUConfig(enabled=True),
        psg=tc.PSGConfig(enabled=True, fused_attention=False,
                         swa_start_frac=0.0)))
    return jexp, texp


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _with_biases(params, seed):
    """``params`` with every bias leaf drawn from a numpy seed."""
    r = np.random.RandomState(seed)

    def draw(path, x):
        if getattr(path[-1], "key", None) in BIASES:
            return jnp.asarray(r.randn(*x.shape).astype(np.float32) * 0.1)
        return x
    return jax.tree_util.tree_map_with_path(draw, params)


_JSTATES = {}


def _jstate(arch):
    """The JAX package's initial state of the reduced ``arch`` (biases
    drawn), made once a module."""
    if arch not in _JSTATES:
        jexp, _ = _configs(arch)
        st = jinit(jax.random.PRNGKey(0), jexp)
        params = _with_biases(st.params, 7)
        _JSTATES[arch] = st._replace(
            params=params, opt=jmake_optimizer(jexp.train).init(params),
            swa=jswa_init(params))
    return _JSTATES[arch]


def _port_model(texp, jparams):
    model = TransformerLM(texp.model, texp.e2)
    model.load_state_dict(convert.lm_state_dict_from_jax(_np(jparams)))
    return model


def _port_state(texp, jstate):
    model = _port_model(texp, jstate.params)
    params = dict(model.named_parameters())
    return TrainState(model, signsgd_init(params), swa_init(params), 0)


def _batch(step=0, seq=SEQ, batch=BATCH):
    return tsyn.make_lm_batch(tsyn.MarkovLMTask(vocab=128), 0, step, 0, batch,
                              seq, "cpu")


def _jbatch(tb):
    return {k: jnp.asarray(v.numpy().astype(np.int32)) for k, v in tb.items()}


def _close(a, ref, rel):
    a, ref = np.asarray(a, np.float32), np.asarray(ref, np.float32)
    assert a.shape == ref.shape
    assert np.max(np.abs(a - ref)) <= rel * np.max(np.abs(ref))


# ---------------------------------------------------------------------------
# configs, conversion and cost
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_jax_field_for_field(arch, reduced):
    assert arch in ARCH_IDS
    texp, jexp = get_experiment(arch), jget(arch)
    if reduced:
        texp, jexp = reduce_experiment(texp), jreduce(jexp)
    for part in ("model", "train", "e2"):
        t, j = getattr(texp, part), getattr(jexp, part)
        for name, v in dataclasses.asdict(t).items():
            want = getattr(j, name)
            want = dataclasses.asdict(want) if dataclasses.is_dataclass(want) \
                else want
            if isinstance(v, dict):     # E2TrainConfig's sub-configs
                want = {k: want[k] for k in v}
            assert v == want, (part, name)
    assert texp.task == "lm"
    if arch == "starcoder2_15b":
        assert texp.train.microbatches == (1 if reduced else 4)
    if arch == "h2o_danube_3_4b":
        assert texp.model.sliding_window == (8 if reduced else 4096)


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_loads_every_leaf_and_round_trips(arch):
    jexp, texp = _configs(arch)
    jstate = _jstate(arch)
    model = _port_model(texp, jstate.params)
    want = _np(jstate.params)
    back = convert.jax_tree(dict(model.named_parameters()))
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(back),
                            jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    names = {n.split(".")[-1] for n, _ in model.named_parameters()}
    m = texp.model
    assert ("head" in names) == (not m.tie_embeddings)
    assert ("bias" in names) == (m.norm == "layernorm")
    assert {"b_up", "b_down"} <= names if m.mlp_bias else \
        not {"b_up", "b_down"} & names
    assert {"bq", "bk", "bv"} <= names if m.qkv_bias else \
        not {"bq", "bk", "bv"} & names
    assert ("w_gate" in names) == m.glu
    # the whole train state: the JAX package's checkpoint keys and shapes
    flat = _flatten(convert.train_state_tree(_port_state(texp, jstate)))
    jflat = jckpt._flatten(jstate)
    assert set(flat) == set(jflat)
    for k, v in flat.items():
        assert (v.shape, v.dtype) == (jflat[k].shape, jflat[k].dtype), k


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_cost_table_equals_jax(arch, reduced):
    jexp, texp = jget(arch), get_experiment(arch)
    if reduced:
        jexp, texp = jreduce(jexp), reduce_experiment(texp)
    for seq in (4096, 16384):
        t, j = lm_cost(texp.model, seq), jlm_cost(jexp.model, seq)
        assert [dataclasses.astuple(x) for x in t.layers] == \
            [dataclasses.astuple(x) for x in j.layers]
    assert texp.model.param_count() == jexp.model.param_count()
    assert texp.model.padded_vocab == jexp.model.padded_vocab


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


@pytest.fixture
def fp32_probabilities(monkeypatch):
    """The softmax without its bf16 rounding, in both packages: a
    probability within an fp32 rounding of a bf16 boundary rounds one way
    in one package and the other way in the other, and the 2**-8 step
    reaches every later position through the next layer's keys."""
    monkeypatch.setattr(JL, "_softmax_lowp",
                        lambda s: jax.nn.softmax(s, axis=-1))
    monkeypatch.setattr(L, "SoftmaxLowp", type("Softmax", (), {
        "apply": staticmethod(lambda s: torch.softmax(s, dim=-1))}))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_slu_decisions_match_jax(arch, fp32_probabilities):
    """As ``test_torch_lm.py``'s forward test, with fp32 probabilities in
    both packages (:func:`fp32_probabilities`; the train-step test below
    runs them in bf16)."""
    jexp, texp = _configs(arch)
    jstate = _jstate(arch)
    model = _port_model(texp, jstate.params)
    tb = _batch()
    jb = _jbatch(tb)
    seen = set()

    @jax.jit
    def jfwd(params, batch, jrng):
        with jpsg.enable(jexp.e2.psg):
            out = JT.lm_fwd(params, batch["tokens"], jexp.model, jexp.e2,
                            jrng, remat="none")
            return out, JT.lm_loss(params, batch, jexp.model, jexp.e2, jrng,
                                   remat="none")

    for step in range(3):
        jrng = jax.random.fold_in(jax.random.PRNGKey(0), step)
        key = rng.fold_in(rng.PRNGKey(0), step)
        out, (jtotal, jmet) = jfwd(jstate.params, jb, jrng)
        with tpsg.enable(texp.e2.psg, probe=tpsg.zero_probe()):
            logits, aux = model(tb["tokens"], key, remat="none")
            total, met = lm_loss(model, tb, key, remat="none")
        _close(logits.detach().numpy(), out.logits, 1e-5)
        np.testing.assert_array_equal(aux["slu_executed"].numpy(),
                                      np.asarray(out.slu_executed))
        np.testing.assert_allclose(aux["slu_keep_probs"].detach().numpy(),
                                   np.asarray(out.slu_keep_probs).ravel(),
                                   rtol=1e-5)
        assert set(met) == set(jmet)
        for k in met:
            np.testing.assert_allclose(float(met[k].detach()), float(jmet[k]),
                                       rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(float(total.detach()), float(jtotal),
                                   rtol=1e-5)
        seen.add(tuple(aux["slu_executed"].ravel().tolist()))
    assert len(seen) > 1, "no SLU decision varied over the steps"


_JSTEPS = {}


def _jax_step(arch, remat):
    """The JAX package's first train step of the reduced ``arch`` under
    ``remat`` on batch 0, made once a module."""
    if (arch, remat) not in _JSTEPS:
        jexp, _ = _configs(arch, remat)
        _JSTEPS[arch, remat] = jax.jit(jmake(jexp))(_jstate(arch),
                                                    _jbatch(_batch(0)))
    return _JSTEPS[arch, remat]


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_matches_jax(arch):
    _, texp = _configs(arch)
    state = _port_state(texp, _jstate(arch))
    jnew, jmet = _jax_step(arch, "none")
    new, met = make_train_step(texp)(state, _batch(0))
    assert new.step == int(jnew.step) == 1
    assert set(met) == set(jmet)
    for k in ("loss", "total_loss", "slu_cost", "slu_exec_ratio",
              "psg_fallback_ratio"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), **TOL,
                                   err_msg=k)
    want = convert.lm_state_dict_from_jax(_np(jnew.params))
    for name, p in new.model.named_parameters():
        same = np.isclose(p.detach().numpy(), want[name].numpy(), rtol=0,
                          atol=1e-6)
        assert same.mean() >= 0.9, (name, same.mean())


def test_remat_full_gives_the_gradients_of_remat_none_in_both_packages():
    """The JAX package's ``remat="full"`` checkpoints nothing: its step
    equals its ``"none"`` step bit for bit, and so does the port's."""
    arch = "llama3_8b"
    (jn, jmn), (jf, jmf) = _jax_step(arch, "none"), _jax_step(arch, "full")
    for a, b in zip(jax.tree.leaves(jn), jax.tree.leaves(jf)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert {k: float(v) for k, v in jmn.items()} == \
        {k: float(v) for k, v in jmf.items()}
    out = {}
    for remat in ("none", "full"):
        _, texp = _configs(arch, remat)
        assert texp.train.remat == remat
        new, met = make_train_step(texp)(_port_state(texp, _jstate(arch)),
                                         _batch(0))
        out[remat] = ({k: float(v) for k, v in met.items()},
                      dict(new.model.named_parameters()))
    (mn, pn), (mf, pf) = out["none"], out["full"]
    assert mn == mf
    for name in pn:
        assert torch.equal(pn[name], pf[name]), name


def test_remat_full_and_sliding_windows_are_accepted():
    """Moved here from ``test_torch_lm.py::test_unported_options_raise``:
    both are ported now.  A remat that is none of the three still raises."""
    assert tc.TrainConfig(remat="full").remat == "full"
    with pytest.raises(ValueError, match="remat"):
        tc.TrainConfig(remat="everything")
    _, texp = _configs("llama3_8b")
    model = TransformerLM(dataclasses.replace(texp.model, sliding_window=8))
    assert model.cfg.sliding_window == 8
    logits, _ = model.eval()(_batch(0)["tokens"])
    assert torch.isfinite(logits).all()


def test_lm_experiment_keeps_the_configs_microbatches():
    assert train.lm_experiment("starcoder2_15b").train.microbatches == 4
    assert train.lm_experiment("starcoder2_15b",
                               microbatches=2).train.microbatches == 2
    assert train.lm_experiment("starcoder2_15b",
                               smoke=True).train.microbatches == 1
    assert train.lm_experiment("llama3_8b").train.microbatches == 1


@pytest.mark.parametrize("arch", ["starcoder2_15b", "h2o_danube_3_4b"])
def test_launcher_trains_the_arch(arch, capsys):
    assert train.main(["--task", "lm", "--arch", arch, "--smoke", "--steps",
                       "3", "--device", "cpu", "--log-every", "0"]) == 0
    out = capsys.readouterr().out
    name = get_experiment(arch).model.name
    assert out.startswith(f"model {name} (2 layers")
    assert ("sliding-window (8)" in out) == (arch == "h2o_danube_3_4b")
    assert "held-out accuracy" in out


# ---------------------------------------------------------------------------
# attention: masks, windows, query chunks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,T,offset,window", [
    (16, 16, 0, 0), (16, 16, 0, 8), (8, 37, 24, 0), (8, 37, 32, 5),
    (12, 20, 3, 1)])
def test_causal_mask_equals_jax(S, T, offset, window):
    np.testing.assert_array_equal(
        L.causal_mask(S, T, offset, window).numpy(),
        np.asarray(JL.causal_mask(S, T, offset, window)))


def _attn_cfgs(window, heads=(4, 2, 16)):
    """One attention layer's config in both packages: d_model 64, ``heads``
    = (query heads, kv heads, head dim), fp32."""
    nh, nkv, hd = heads
    kw = dict(name="t", family="dense", num_layers=1, d_model=64,
              num_heads=nh, num_kv_heads=nkv, d_ff=96, vocab_size=128,
              head_dim=hd, sliding_window=window, dtype="float32")
    return jc.ModelConfig(**kw), tc.ModelConfig(**kw)


def _attention_pair(window, S, seed, prefer_chunked=False, grads=True,
                    heads=(4, 2, 16)):
    """The JAX package's and the port's ``attention_fwd`` on one x and one
    set of weights (biases none): outputs, and the gradients of
    ``sum(y * g)`` with respect to x and every weight."""
    jcfg, tcfg = _attn_cfgs(window, heads)
    jp = _np(JL.init_attention(jax.random.PRNGKey(seed), jcfg))
    r = np.random.RandomState(seed)
    x = r.randn(1, S, 64).astype(np.float32)
    g = r.randn(1, S, 64).astype(np.float32)

    def jf(x_, p_):
        return JL.attention_fwd(p_, x_, jcfg, prefer_chunked=prefer_chunked)

    jp_j = jax.tree.map(jnp.asarray, jp)
    attn = L.Attention(tcfg, torch.Generator().manual_seed(0))
    for name, v in jp.items():
        getattr(attn, name).data = torch.tensor(v)
    xt = torch.from_numpy(x).requires_grad_(grads)
    y = L.attention_fwd(attn, xt, tcfg, prefer_chunked)
    if not grads:
        return np.asarray(jf(jnp.asarray(x), jp_j)), y.detach().numpy()
    jy, vjp = jax.vjp(jf, jnp.asarray(x), jp_j)
    jdx, jdp = vjp(jnp.asarray(g))
    y.backward(torch.from_numpy(g))
    pairs = [(y.detach().numpy(), jy), (xt.grad.numpy(), jdx)]
    pairs += [(getattr(attn, n).grad.numpy(), jdp[n]) for n in jp]
    return pairs


@pytest.mark.parametrize("window", [0, 8])
def test_windowed_materialized_attention_matches_jax(window):
    """S 16 over a window of 8 (and none): forward and gradients."""
    assert L.attention_path(_attn_cfgs(window)[1], None, 16) == "materialized"
    for got, want in _attention_pair(window, 16, seed=1):
        _close(got, want, 1e-3)


@pytest.fixture
def small_chunks(monkeypatch):
    """Chunks of 8 queries above 16 tokens, in both packages."""
    for mod in (JL, L):
        monkeypatch.setattr(mod, "ATTN_Q_CHUNK", 8)
        monkeypatch.setattr(mod, "ATTN_CHUNK_THRESHOLD", 16)


@pytest.mark.parametrize("window", [0, 5])
def test_sdpa_qchunked_matches_jax_both_ways(small_chunks, window):
    """S 37 (padded to 40, five chunks), GQA 4 over 2: forward and dq, dk,
    dv of ``_sdpa_qchunked`` against the JAX package's."""
    jcfg, tcfg = _attn_cfgs(window)
    r = np.random.RandomState(3)
    q, k, v = (r.randn(2, 37, n, 16).astype(np.float32) for n in (4, 2, 2))
    g = r.randn(2, 37, 4, 16).astype(np.float32)
    jy, vjp = jax.vjp(lambda *a: JL._sdpa_qchunked(*a, jcfg),
                      *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(g))
    targs = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    y = L._sdpa_qchunked(*targs, tcfg)
    y.backward(torch.from_numpy(g))
    _close(y.detach().numpy(), jy, 1e-3)
    for t, j in zip(targs, jgrads):
        _close(t.grad.numpy(), j, 1e-3)
    # the chunks are the whole softmax: the same as one materialized pass
    whole = L._sdpa(*targs, L.causal_mask(37, 37, 0, window))
    assert torch.equal(y, whole)


@pytest.mark.parametrize("window", [0, 5])
def test_chunked_attention_fwd_matches_jax(small_chunks, window):
    """``attention_fwd`` above the threshold takes the chunked path in both
    packages: forward and the gradients of x and every weight."""
    assert L.attention_path(_attn_cfgs(window)[1], None, 37) == \
        "query-chunked"
    for got, want in _attention_pair(window, 37, seed=4):
        _close(got, want, 1e-3)


PATH_CASES = [  # (window, S, prefer_chunked, fused)
    (0, 16, False, False), (0, 17, False, False), (0, 15, True, False),
    (0, 16, True, False), (0, 17, True, True), (0, 99, False, True),
    (5, 99, False, True), (5, 16, True, True), (5, 12, True, None),
    (0, 12, False, None)]


@pytest.mark.parametrize("window,S,prefer,fused", PATH_CASES)
def test_attention_dispatch_is_the_jax_packages(small_chunks, monkeypatch,
                                                window, S, prefer, fused):
    """Each package's ``attention_fwd`` with its three paths replaced by
    recorders: the same path for each window, length, preference and PSG
    config (``fused``: ``None`` is PSG off)."""
    jcfg, tcfg = _attn_cfgs(window)
    taken = {}

    def record(pkg, path):
        def fn(q, *a, **kw):
            taken[pkg] = path
            return q
        return fn

    for pkg, mod, psgmod in (("jax", JL, jpsg), ("port", L, tpsg)):
        monkeypatch.setattr(mod, "_sdpa_qchunked", record(pkg, "chunked"))
        monkeypatch.setattr(mod, "_sdpa", record(pkg, "materialized"))
        monkeypatch.setattr(psgmod, "attention", record(pkg, "flash"))
    x = np.random.RandomState(5).randn(1, S, 64).astype(np.float32)
    jp = JL.init_attention(jax.random.PRNGKey(0), jcfg)
    jpsg_cfg = None if fused is None else jc.PSGConfig(
        enabled=True, fused_attention=fused, backend="interpret")
    tpsg_cfg = None if fused is None else tc.PSGConfig(
        enabled=True, fused_attention=fused)
    with jpsg.enable(jpsg_cfg):     # traced only: the recorders run
        jax.eval_shape(lambda x_: JL.attention_fwd(
            jp, x_, jcfg, prefer_chunked=prefer), jnp.asarray(x))
    attn = L.Attention(tcfg, torch.Generator().manual_seed(0))
    with tpsg.enable(tpsg_cfg, probe=tpsg.zero_probe()):
        L.attention_fwd(attn, torch.from_numpy(x), tcfg, prefer)
    assert taken["port"] == taken["jax"]
    want = {"chunked": "query-chunked"}.get(taken["jax"], taken["jax"])
    assert L.attention_path(tcfg, tpsg_cfg, S, prefer) == want


def test_chunked_attention_at_the_real_threshold_matches_jax():
    """S = 8192 + 300 at toy width (one head of 8) with the real
    constants (512-query chunks, padded to 8704): forward only."""
    S = L.ATTN_CHUNK_THRESHOLD + 300
    assert (L.ATTN_Q_CHUNK, L.ATTN_CHUNK_THRESHOLD) == \
        (JL.ATTN_Q_CHUNK, JL.ATTN_CHUNK_THRESHOLD) == (512, 8192)
    assert L.attention_path(_attn_cfgs(0)[1], None, S) == "query-chunked"
    assert L.attention_path(_attn_cfgs(0)[1], None, S - 301) == \
        "materialized"
    with torch.no_grad():
        want, got = _attention_pair(0, S, seed=6, grads=False,
                                    heads=(1, 1, 8))
    _close(got, want, 1e-3)


@pytest.mark.parametrize("arch", ["llama3_8b", "h2o_danube_3_4b"])
def test_eval_forward_takes_the_chunked_path_and_matches_jax(
        arch, monkeypatch, fp32_probabilities):
    """At 1024 tokens the eval forward streams query chunks, as the JAX
    package's ``lm_fwd(train=False)``; its logits equal that's (fp32
    probabilities in both, as in the forward test above)."""
    jexp, texp = _configs(arch)
    jstate = _jstate(arch)
    model = _port_model(texp, jstate.params).eval()
    chunked = []
    real = L._sdpa_qchunked
    monkeypatch.setattr(L, "_sdpa_qchunked",
                        lambda *a: chunked.append(1) or real(*a))
    tokens = _batch(0, seq=1024, batch=1)["tokens"]
    with torch.no_grad():
        logits, _ = model(tokens)
    assert len(chunked) == LAYERS
    want = JT.lm_fwd(jstate.params, jnp.asarray(tokens.numpy()), jexp.model,
                     jexp.e2, train=False, remat="none").logits
    _close(logits.numpy(), want, 1e-5)


def test_nested_checkpoints_give_the_gradients_of_remat_none_exactly(
        small_chunks):
    """The reduced h2o-danube-3-4b at 40 tokens (over the threshold of 16,
    its window of 8): each chunk's checkpoint inside each sub-block's
    (``remat="block"``) gives the step of ``remat="none"`` bit for bit."""
    arch = "h2o_danube_3_4b"
    out = {}
    for remat in ("none", "block"):
        _, texp = _configs(arch, remat)
        new, met = make_train_step(texp)(_port_state(texp, _jstate(arch)),
                                         _batch(2, seq=40))
        out[remat] = ({k: float(v) for k, v in met.items()},
                      dict(new.model.named_parameters()))
    (mn, pn), (mb, pb) = out["none"], out["block"]
    assert mn == mb
    for name in pn:
        assert torch.equal(pn[name], pb[name]), name


# ---------------------------------------------------------------------------
# the fault-injection record
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ft_record(tmp_path_factory):
    path = tmp_path_factory.mktemp("ft") / "BENCH_ft.json"
    rc = bench_run.main(["--json-ft", str(path), "--device", "cpu"])
    return rc, json.loads(path.read_text())


def test_ft_record_recovers_every_fault_on_the_cpu(ft_record):
    rc, record = ft_record
    assert rc == 0
    assert record["device"] == "cpu" and record["all_recovered"]
    names = [s["scenario"] for s in record["scenarios"]]
    assert names == ["corrupt_truncate", "corrupt_flip", "corrupt_tamper",
                     "corrupt_partial", "producer_raise",
                     "writer_transient_retry", "writer_terminal_surfaced",
                     "kill_restart"]
    kr = record["scenarios"][-1]
    assert kr["bitwise_match_vs_uninterrupted"] and kr["restarts"] == 1
    assert [a["world"] for a in kr["attempts"]] == [2, 1]
    assert bench_ft.faults.KILL_EXIT_CODE in kr["attempts"][0]["exit_codes"]
    assert kr["final_intact_step"] == kr["steps"] - 1 == 7


def test_bench_run_ft_rows_and_refusals(ft_record, monkeypatch, capsys):
    """``--only ft`` prints the record's rows and exits 0 (the record of the
    fixture's run, not a second one)."""
    monkeypatch.setattr(bench_ft, "ft_json", lambda *a, **kw: ft_record[1])
    assert bench_run.main(["--only", "ft", "--device", "cpu"]) == 0
    rows = capsys.readouterr().out.strip().splitlines()
    assert rows[0] == "name,us_per_call,derived"
    assert rows[-1] == "ft_all,0.0,all_recovered=True"
    assert "ft_kill_restart,0.0,recovered=True" in rows
