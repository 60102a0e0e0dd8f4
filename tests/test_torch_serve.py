"""repro_torch's serving path against the JAX package's: the serving shapes
(``core/config.py``), the KV-cache functions (``models/layers.py``),
``prefill_to_state`` / ``decode_step`` over every block kind
(``models/transformer.py``) and the decode-state conversion
(``convert.py``), on the same parameters (``convert.lm_state_dict_from_
jax``), tokens and frontends.  The engine, the CLI, bf16 and the handoff:
``test_torch_serve_engine.py``.

Tolerances:

* ``init_kv_cache`` and ``fill_kv_cache``: equal (copies of the inputs);
* one ``attention_decode`` step, fp32: output and caches within ``1e-6``
  of max|ref| (one token's products, fp32 sums in other orders);
* prefill and 4 decode steps of each reduced variant, fp32: logits within
  ``1e-5`` of max|ref| at every step, every state leaf within ``rtol=1e-5``
  and ``1e-5`` of its largest magnitude, positions equal (the same fp32
  operations in other orders through a few layers, as the model tests of
  ``test_torch_ssm.py``).

The fp32 comparisons take the softmax's bf16 rounding of the probabilities
out of both packages (``fp32_probabilities``, as in ``test_torch_ssm.py``):
a probability at a bf16 rounding boundary takes the neighbouring value in
the other package, a step of 2^-8 of it.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_experiment as jget  # noqa: E402
from repro.configs import reduce_experiment as jreduce  # noqa: E402
from repro.core import config as jc  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import (ARCH_IDS, get_experiment,  # noqa: E402
                                 reduce_experiment)
from repro_torch.core import config as tc  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

VARIANTS = {"dense": "qwen2_5_3b", "swa": "h2o_danube_3_4b",
            "moe": "deepseek_moe_16b", "xlstm": "xlstm_350m",
            "zamba": "zamba2_1_2b", "whisper": "whisper_small",
            "vlm": "phi_3_vision_4_2b"}
# the reduced zamba2: two units of 2 Mamba blocks and a shared-attention
# call, each call with its own cache (as in test_torch_ssm.py)
ZAMBA_UNIT = ("mamba", "mamba", "shared_attn")
B, S, MAX_LEN, STEPS = 2, 12, 20, 4


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fp32_probabilities(monkeypatch):
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


def _rel(a, ref):
    a, ref = _f64(a), _f64(ref)
    assert a.shape == ref.shape
    return np.max(np.abs(a - ref)) / np.max(np.abs(ref))


def _close(a, ref, rel, what=""):
    assert _rel(a, ref) <= rel, what


def _same_tree(got, want, what):
    """Every leaf of ``got`` (convert's tree of the port's state) against
    the JAX tree ``want``: positions equal, the rest within 1e-5."""
    g = dict(convert.leaves(got))
    w = dict(convert.leaves(_np(want)))
    assert set(g) == set(w), what
    for path, ref in w.items():
        if path == ("pos",):
            np.testing.assert_array_equal(g[path], ref)
            continue
        ref = _f64(ref)
        np.testing.assert_allclose(_f64(g[path]), ref, rtol=1e-5,
                                   atol=1e-5 * np.max(np.abs(ref)),
                                   err_msg=f"{what} {path}")


# ---------------------------------------------------------------------------
# shapes
# ---------------------------------------------------------------------------


def test_shapes_and_serve_config_equal_jax():
    assert {k: dict(v) for k, v in tc.SHAPES.items()} == \
        {k: dict(v) for k, v in jc.SHAPES.items()}
    assert dataclasses.asdict(tc.ServeConfig()) == \
        dataclasses.asdict(jc.ServeConfig())
    for arch in ARCH_IDS:
        for reduced in (False, True):
            texp, jexp = get_experiment(arch), jget(arch)
            if reduced:
                texp, jexp = reduce_experiment(texp), jreduce(jexp)
            assert dataclasses.asdict(texp.serve) == \
                dataclasses.asdict(jexp.serve), arch
            for shape in jc.SHAPES:
                t, j = texp.with_shape(shape), jexp.with_shape(shape)
                for part in ("train", "serve"):   # the port's fields
                    for name, v in dataclasses.asdict(
                            getattr(t, part)).items():
                        assert v == getattr(getattr(j, part), name), \
                            (arch, shape, part, name)
                assert tc.shape_applicable(texp.model, shape) == \
                    jc.shape_applicable(jexp.model, shape), (arch, shape)


# ---------------------------------------------------------------------------
# the KV-cache functions
# ---------------------------------------------------------------------------


def _attn_cfgs(window):
    base = dict(name="t", num_layers=2, d_model=32, num_heads=4,
                num_kv_heads=2, d_ff=64, vocab_size=64, dtype="float32",
                sliding_window=window, qkv_bias=True)
    return jc.ModelConfig(family="dense", **base), \
        tc.ModelConfig(family="dense", **base)


@pytest.mark.parametrize("window", [0, 6], ids=["full", "window6"])
def test_init_and_fill_kv_cache_equal_jax(window):
    """At S = 8 into ``max_len`` 10: the whole prefill, or under a window
    of 6 a ring of 6 slots that has wrapped."""
    jm, tm = _attn_cfgs(window)
    r = np.random.RandomState(0)
    k, v = (r.randn(B, 8, 2, 8).astype(np.float32) for _ in range(2))
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        for got, want in zip(L.init_kv_cache(tm, B, 10, dt),
                             JL.init_kv_cache(jm, B, 10, jdt)):
            assert got.dtype == dt
            np.testing.assert_array_equal(_f64(got), _f64(want))
        got = L.fill_kv_cache(tm, torch.from_numpy(k), torch.from_numpy(v),
                              10, dt)
        want = JL.fill_kv_cache(jm, jnp.asarray(k), jnp.asarray(v), 10, jdt)
        assert got[0].shape == (B, 6 if window else 10, 2, 8)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(_f64(a), _f64(b))


@pytest.mark.parametrize("window", [0, 6], ids=["full", "window6"])
def test_attention_decode_one_step_matches_jax(window, fp32_probabilities):
    """One token at positions 8 and 3 against a cache of ``min(10,
    window)`` slots: under the window the first row's ring has wrapped
    (slot 8 % 6), the second's not; the new k/v land in place."""
    jm, tm = _attn_cfgs(window)
    jp = _np(JL.init_attention(jax.random.PRNGKey(3), jm))
    mod = L.Attention(tm, torch.Generator().manual_seed(0))
    mod.load_state_dict({k: torch.from_numpy(np.array(a))
                         for k, a in convert.port_named(jp).items()})
    T_ = L.kv_cache_len(tm, 10)
    r = np.random.RandomState(1)
    x = r.randn(B, 1, 32).astype(np.float32)
    kc, vc = (r.randn(B, T_, 2, 8).astype(np.float32) for _ in range(2))
    pos = np.array([8, 3], np.int32)
    jy, (jk, jv) = JL.attention_decode(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x), jm,
        (jnp.asarray(kc), jnp.asarray(vc)), jnp.asarray(pos))
    cache = (torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()))
    with torch.no_grad():
        y, (tk, tv) = L.attention_decode(mod, torch.from_numpy(x), tm,
                                         cache, torch.from_numpy(pos))
    assert tk is cache[0] and tv is cache[1]
    for a, b in ((y, jy), (tk, jk), (tv, jv)):
        _close(a, b, 1e-6)


# ---------------------------------------------------------------------------
# prefill and decode of whole reduced models
# ---------------------------------------------------------------------------


def _exps(variant, dtype="float32"):
    arch = VARIANTS[variant]
    jexp, texp = jreduce(jget(arch)), reduce_experiment(get_experiment(arch))
    kw = dict(dtype=dtype)
    if variant == "zamba":
        kw.update(block_unit=ZAMBA_UNIT, num_layers=6)
    return dataclasses.replace(jexp.model, **kw), \
        dataclasses.replace(texp.model, **kw)


def _pair(variant, dtype="float32"):
    jm, tm = _exps(variant, dtype)
    jp = JT.init_lm(jax.random.PRNGKey(0), jm, jc.E2TrainConfig())
    model = T.TransformerLM(tm)
    model.load_state_dict(convert.lm_state_dict_from_jax(_np(jp)))
    return jm, tm, jp, model


def _inputs(tm, seed=0):
    r = np.random.RandomState(seed)
    toks = r.randint(0, tm.vocab_size, (B, S)).astype(np.int32)
    fe = r.randn(B, tm.frontend_tokens, tm.d_model).astype(np.float32) \
        if tm.frontend else None
    return toks, fe


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_and_decode_match_jax(variant, fp32_probabilities):
    """``prefill_to_state`` then 4 greedy ``decode_step``s (the JAX
    package's tokens fed to both), fp32 caches: logits at every step and
    every leaf of the state (through ``convert.decode_state_tree``), whisper
    against its encoder's memory, the VLM with its patches prepended.  The
    first step also runs from the JAX package's prefill state carried in by
    ``convert.decode_state_from_tree``."""
    jm, tm, jp, model = _pair(variant)
    unit = len(T.unit_kinds(tm))
    toks, fe = _inputs(tm)
    jmem = tmem = None
    if tm.encoder_layers:
        jmem = JT.encoder_fwd(jp, jnp.asarray(fe), jm)
        with torch.no_grad():
            tmem = model.encode(torch.from_numpy(fe))
        fe = None
    jprefill = jax.jit(lambda p, t, f, m: JT.prefill_to_state(
        p, t, jm, MAX_LEN, memory=m, frontend_embeds=f,
        cache_dtype=jnp.float32))
    jdecode = jax.jit(lambda p, t, s, m: JT.decode_step(p, t, s, jm, m))
    jlg, jst = jprefill(jp, jnp.asarray(toks),
                        None if fe is None else jnp.asarray(fe), jmem)
    lg, st = T.prefill_to_state(
        model, torch.from_numpy(toks), MAX_LEN, memory=tmem,
        frontend=None if fe is None else torch.from_numpy(fe),
        cache_dtype=torch.float32)
    _close(lg, jlg, 1e-5, "prefill logits")
    _same_tree(convert.decode_state_tree(st, unit), jst, "prefill state")
    carried = convert.decode_state_from_tree(_np(jst))
    for step in range(STEPS):
        nxt = jnp.argmax(jlg[:, 0], -1)[:, None].astype(jnp.int32)
        tok = torch.from_numpy(np.array(nxt))
        if step == 0:
            lg_c, _ = T.decode_step(model, tok, carried, tmem)
        jlg, jst = jdecode(jp, nxt, jst, jmem)
        lg, st = T.decode_step(model, tok, st, tmem)
        _close(lg, jlg, 1e-5, f"step {step} logits")
        _same_tree(convert.decode_state_tree(st, unit), jst,
                   f"step {step} state")
        if step == 0:
            _close(lg_c, jlg, 1e-5, "carried-in state")
    assert st["pos"].tolist() == [S + tm.frontend_tokens * (tm.frontend ==
                                                            "vision")
                                  + STEPS] * B
