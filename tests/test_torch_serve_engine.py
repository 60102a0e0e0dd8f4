"""repro_torch's serving engine and CLI (``serving/engine.py``,
``launch/serve.py``) against the JAX package's engine, the prefill-to-decode
handoff, the state's in-place update, the length rules the reference
refuses, and bf16 serving.

Tolerances:

* the reduced qwen2.5-3b in bf16 (bf16 caches): the logits within
  ``BF16_REL`` = 2e-2 of max|ref| at the prefill and 4 decode steps
  against the JAX package's (measured 7.3e-3 to 9.2e-3 over six prompt
  seeds, 7.6e-3 at this one's: about two bf16 roundings, 2^-8 = 3.9e-3
  each, of activations whose products the two packages sum in other
  orders), and the handoff (``decode_step`` on token S + 1 after
  ``prefill_to_state(S)`` against ``prefill_to_state(S + 1)``) within the
  same limit (0 on the CPU, whose row products do not depend on the row
  count); ``chip_smoke.py`` holds the card's full-width handoff to this
  limit, and its greedy tokens equal wherever the top-2 margin exceeds it;
* the reduced zamba2-1.2b (its real unit: 18 Mamba2 blocks and the shared
  attention) at S = 255: the handoff in fp32 within ``ZAMBA_FP32_REL`` =
  1e-3 (measured 0 to 3e-4 over eight seeds: the chunked SSD of the
  prefill against the recurrent step, over 18 layers); ``chip_smoke.py``
  holds the card's full-width handoff of zamba2-1.2b to this limit in fp32
  activations, since in bf16 both packages' handoffs part by whole
  percents (measured on this model: 4-19% in the port, 4.5-58% in the JAX
  package, against 59-158% with one layer's conv buffer zeroed);
* the JAX package's own handoff test (``tests/test_models.py``), run on the
  port: ``atol=2e-4``, its tolerance;
* the engine: the JAX engine's greedy tokens, equal, with both softmaxes'
  probabilities in fp32 (``fp32_probabilities``, as in
  ``test_torch_serve.py``).
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
from repro.serving.engine import Request as JRequest  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.serving.engine import \
    make_prefill_step as jmake_prefill_step  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_experiment, reduce_experiment  # noqa: E402
from repro_torch.core import config as tc  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving import (Request, ServeEngine,  # noqa: E402
                                 make_prefill_step)

ZAMBA_UNIT = ("mamba", "mamba", "shared_attn")
B, S, MAX_LEN, STEPS = 2, 12, 20, 4
BF16_REL = 2e-2
ZAMBA_FP32_REL = 1e-3


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


def _rel(a, ref):
    a = a.detach().double().numpy() if isinstance(a, torch.Tensor) else a
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    assert a.shape == ref.shape
    return np.max(np.abs(a - ref)) / np.max(np.abs(ref))


def _cfgs(arch, dtype="float32", **kw):
    """The reduced ``arch``'s model config in both packages (``kw``
    replaces fields)."""
    return (dataclasses.replace(jreduce(jget(arch)).model, dtype=dtype, **kw),
            dataclasses.replace(reduce_experiment(get_experiment(arch)).model,
                                dtype=dtype, **kw))


def _pair(arch, dtype="float32", **kw):
    """:func:`_cfgs`, the JAX parameters and the port model loaded from
    them."""
    jm, tm = _cfgs(arch, dtype, **kw)
    jp = JT.init_lm(jax.random.PRNGKey(0), jm, jc.E2TrainConfig())
    model = T.TransformerLM(tm)
    model.load_state_dict(convert.lm_state_dict_from_jax(_np(jp)))
    return jm, tm, jp, model


def _tokens(tm, seed=0):
    return np.random.RandomState(seed).randint(
        0, tm.vocab_size, (B, S)).astype(np.int32)


def test_bf16_prefill_decode_and_handoff_within_bf16_rel():
    """The reduced qwen2.5-3b in bf16 with bf16 caches: the port's logits
    against the JAX package's at the prefill and 4 decode steps, and the
    port's handoff (``decode_step`` on token S + 1 after
    ``prefill_to_state(S)`` against ``prefill_to_state(S + 1)``), each
    within ``BF16_REL`` of max|ref| (module docstring); the greedy tokens
    agree wherever the reference's top-2 margin exceeds that gap."""
    jm, tm, jp, model = _pair("qwen2_5_3b", "bfloat16")
    toks = _tokens(tm)
    jlg, jst = JT.prefill_to_state(jp, jnp.asarray(toks), jm, MAX_LEN,
                                   cache_dtype=jnp.bfloat16)
    lg, st = T.prefill_to_state(model, torch.from_numpy(toks), MAX_LEN)
    assert st["layers"][0]["kv"][0].dtype == torch.bfloat16
    gaps = [_rel(lg, jlg)]
    for _ in range(STEPS):
        nxt = jnp.argmax(jlg[:, 0], -1)[:, None].astype(jnp.int32)
        jlg, jst = JT.decode_step(jp, nxt, jst, jm)
        lg, st = T.decode_step(model, torch.from_numpy(np.array(nxt)), st)
        gaps.append(_rel(lg, jlg))
    assert max(gaps) <= BF16_REL, gaps
    t = torch.from_numpy(toks)
    lg_s, st_s = T.prefill_to_state(model, t[:, :-1], MAX_LEN)
    lg_dec, _ = T.decode_step(model, t[:, -1:], st_s)
    lg_ref, _ = T.prefill_to_state(model, t, MAX_LEN)
    assert _rel(lg_dec, lg_ref) <= BF16_REL
    ref = lg_ref[:, 0].float()
    top2 = ref.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > BF16_REL * ref.abs().max()
    agree = lg_dec[:, 0].argmax(-1) == ref.argmax(-1)
    assert bool(agree[sure].all())


def test_zamba2_handoff_in_fp32_within_limit():
    """The reduced zamba2-1.2b at its real unit, 4 x 255 tokens (the Mamba2
    length rule lets S and S + 1 both through): ``decode_step`` after
    ``prefill_to_state(S)`` against ``prefill_to_state(S + 1)`` within
    ``ZAMBA_FP32_REL`` of max|logit|, greedy tokens equal."""
    tm = reduce_experiment(get_experiment("zamba2_1_2b")).model
    assert tm.num_layers == 19 and tm.dtype == "float32"
    model = T.TransformerLM(tm, seed=0)
    t = torch.from_numpy(np.random.RandomState(0).randint(
        0, tm.vocab_size, (4, 256)).astype(np.int32))
    _, st = T.prefill_to_state(model, t[:, :-1], 300,
                               cache_dtype=torch.float32)
    lg_dec, _ = T.decode_step(model, t[:, -1:], st)
    lg_ref, _ = T.prefill_to_state(model, t, 300, cache_dtype=torch.float32)
    assert _rel(lg_dec, lg_ref.numpy()) <= ZAMBA_FP32_REL
    assert torch.equal(lg_dec.argmax(-1), lg_ref.argmax(-1))


@pytest.mark.parametrize("variant", ["dense", "swa", "xlstm", "zamba"])
def test_prefill_to_state_matches_decode(variant):
    """The JAX package's own handoff test (``tests/test_models.py``) on the
    port: bulk prefill then one step equals token-by-token decode from an
    empty state, at its configs and tolerance."""
    base = dict(name="t", num_layers=4, d_model=32, num_heads=4,
                num_kv_heads=2, d_ff=64, vocab_size=64, dtype="float32")
    cfg = {
        "dense": tc.ModelConfig(family="dense", **base),
        "swa": tc.ModelConfig(family="dense",
                              **{**base, "sliding_window": 6}),
        "xlstm": tc.ModelConfig(family="ssm", **{
            **base, "num_kv_heads": 4, "ssm_state": 8,
            "block_unit": ("mlstm", "mlstm", "mlstm", "slstm")}),
        "zamba": tc.ModelConfig(family="hybrid", **{
            **base, "num_kv_heads": 4, "ssm_state": 8,
            "block_unit": ("mamba", "shared_attn")}),
    }[variant]
    n = 8
    model = T.TransformerLM(cfg, seed=0)
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, 64, (2, n)).astype(np.int32))
    stA = T.init_decode_state(cfg, 2, 32, dtype=torch.float32)
    for t_ in range(n):
        lgA, stA = T.decode_step(model, toks[:, t_:t_ + 1], stA)
    lgB, stB = T.prefill_to_state(model, toks, 32, cache_dtype=torch.float32)
    np.testing.assert_allclose(lgA.numpy(), lgB.numpy(), atol=2e-4)
    nxt = lgB[:, 0].argmax(-1)[:, None].int()
    lgA2, _ = T.decode_step(model, nxt, stA)
    lgB2, _ = T.decode_step(model, nxt, stB)
    np.testing.assert_allclose(lgA2.numpy(), lgB2.numpy(), atol=2e-4)


def test_init_decode_state_equals_jax_and_converts_back():
    """``init_decode_state`` of the reduced zamba2 (per-layer states, two
    shared-attention caches) is the JAX package's tree through
    ``convert``, and ``decode_state_from_tree`` inverts it, dtypes kept."""
    jm, tm = _cfgs("zamba2_1_2b", block_unit=ZAMBA_UNIT, num_layers=6)
    st = T.init_decode_state(tm, B, MAX_LEN)
    assert len(st["layers"]) == tm.num_layers
    tree = convert.decode_state_tree(st, len(ZAMBA_UNIT))
    want = JT.init_decode_state(jm, B, MAX_LEN)
    g, w = dict(convert.leaves(tree)), dict(convert.leaves(_np(want)))
    assert set(g) == set(w)
    for path in w:
        np.testing.assert_array_equal(g[path], np.asarray(w[path], np.float32),
                                      str(path))
    back = convert.decode_state_from_tree(_np(want))
    for a, b in zip(convert.leaves(back), convert.leaves(st)):
        assert a[0] == b[0] and a[1].dtype == b[1].dtype
        assert torch.equal(a[1], b[1])


def test_decode_step_updates_the_state_in_place():
    """The caches keep their storage, the SSM states too, and ``pos``
    advances by 1 in place."""
    _, tm = _cfgs("zamba2_1_2b", block_unit=ZAMBA_UNIT, num_layers=6)
    model = T.TransformerLM(tm)
    toks = _tokens(tm)
    _, st = T.prefill_to_state(model, torch.from_numpy(toks), MAX_LEN)
    before = [(p, t.data_ptr()) for p, t in convert.leaves(st)]
    pos = st["pos"].clone()
    _, st2 = T.decode_step(model, torch.zeros(B, 1, dtype=torch.int32), st)
    assert st2 is st
    assert [(p, t.data_ptr()) for p, t in convert.leaves(st2)] == before
    assert torch.equal(st2["pos"], pos + 1)


@pytest.mark.parametrize("arch,shape", [("zamba2_1_2b", (1, 300)),
                                        ("deepseek_moe_16b", (2, 600))],
                         ids=["mamba2_300_tokens", "moe_1200_tokens"])
def test_prefill_lengths_the_reference_refuses_raise(arch, shape):
    """A Mamba2 prefill above 256 tokens must be a multiple of 256, an MoE
    prefill's tokens above 1,024 a multiple of 1,024 (the JAX package's
    length rules, raised as ``ValueError``)."""
    model = T.TransformerLM(_cfgs(arch)[1])
    with pytest.raises(ValueError, match="divisible"):
        T.prefill_to_state(model, torch.zeros(shape, dtype=torch.int32), 320)


# ---------------------------------------------------------------------------
# the engine and the CLI
# ---------------------------------------------------------------------------


def _requests(cls, vocab):
    r = np.random.RandomState(2)
    return [cls(rid=i, prompt=r.randint(0, vocab, size=3 + i % 3),
                max_new=6 if i % 2 == 0 else 3) for i in range(5)]


def test_engine_tokens_equal_jax_engine(fp32_probabilities):
    """5 requests of 3-5 tokens in waves of 2 slots (left padding; the last
    wave filled with a clone), ``max_new`` 6 and 3: each request's greedy
    tokens are the JAX engine's, exactly its ``max_new`` of them, and the
    clone is dropped."""
    jm, tm, jp, model = _pair("qwen2_5_3b")
    jexp = jreduce(jget("qwen2_5_3b")).replace(model=jm)
    texp = reduce_experiment(get_experiment("qwen2_5_3b")).replace(model=tm)
    jeng = JServeEngine(jexp, jp, batch_slots=2, max_len=16)
    teng = ServeEngine(texp, model, batch_slots=2, max_len=16, device="cpu")
    for eng, cls in ((jeng, JRequest), (teng, Request)):
        for req in _requests(cls, tm.vocab_size):
            eng.submit(req)
    want = {r.rid: r.out for r in jeng.run()}
    done = teng.run()
    assert sorted(r.rid for r in done) == list(range(5))
    assert all(r.done and len(r.out) == r.max_new for r in done)
    assert {r.rid: r.out for r in done} == want


def test_prefill_step_is_the_eval_forwards_last_position(
        fp32_probabilities):
    """``make_prefill_step``: the eval forward's last-position logits, the
    JAX package's ``make_prefill_step`` on the same parameters, and
    ``prefill_to_state``'s logits."""
    jm, tm, jp, model = _pair("qwen2_5_3b")
    jexp = jreduce(jget("qwen2_5_3b")).replace(model=jm)
    texp = reduce_experiment(get_experiment("qwen2_5_3b")).replace(model=tm)
    toks = _tokens(tm)
    got = make_prefill_step(texp)(model, torch.from_numpy(toks))
    assert got.shape == (B, 1, tm.padded_vocab)
    want = jmake_prefill_step(jexp)(jp, jnp.asarray(toks))
    assert _rel(got, np.asarray(want)) <= 1e-5
    lg, _ = T.prefill_to_state(model, torch.from_numpy(toks), MAX_LEN)
    assert _rel(got, lg.numpy()) <= 1e-5


def test_engine_refuses_the_encoder_decoder():
    tm = reduce_experiment(get_experiment("whisper_small")).model
    with pytest.raises(ValueError, match="frontend"):
        ServeEngine(reduce_experiment(get_experiment("whisper_small")),
                    T.TransformerLM(tm), device="cpu")


def test_cli_serves_on_the_cpu(capsys):
    assert serve.main(["--arch", "qwen2_5_3b", "--smoke", "--device", "cpu",
                       "--requests", "3"]) == 0
    out = capsys.readouterr().out
    assert "served 3 requests, 48 tokens in" in out
    assert "tok/s" in out and "rid=0 out[:8]=" in out
