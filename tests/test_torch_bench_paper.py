"""The port's paper benchmarks (``repro_torch.launch.bench_*``,
``bench_run``) against the JAX package's ``benchmarks/``, on the CPU.

* The two repairs: ``E2TrainConfig.full()``/``.off()`` field for field, and
  ``EnergyReport.to_dict()`` with the reference's keys in its order;
  ``validate_against_hlo=True`` stamps the static cost audit's verdict
  (``analysis/audit.py``), ``None`` without it.
* ``run_lm`` against the reference's from the reference's initial
  parameters (``repro_torch.convert``) on the same batches (JAX's threefry
  draws in both): every loss within ``LOSS_REL`` relative (fp32, no
  quantization: summation order only), the same executed steps and history
  length; held-out accuracy equal on the same weights.
* The derived records: the Table 3 sweep within ``1e-12`` relative, the
  8-bit saving and the SMD ratios exactly.
* Every port bench at 2-4 steps gives the reference's row names and derived
  keys, in order; the reference's rows come from its own bench code with
  its training stubbed (no PSG run of the JAX package, whose Pallas
  interpreter is slow).
* ``bench_run``: a bench that raises gives an ``ERROR`` row and exit 1, the
  records go only where they are told; ``--only audit`` runs the static
  cost audit and the linters (``conv`` and ``attn``:
  ``tests/test_torch_bench_bytes.py``).
"""
import dataclasses
import os
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import benchmarks.bench_convergence as jconv  # noqa: E402
import benchmarks.bench_e2train as je2  # noqa: E402
import benchmarks.bench_psg as jpsg  # noqa: E402
import benchmarks.bench_slu as jslu  # noqa: E402
import benchmarks.bench_smd as jsmd  # noqa: E402
import benchmarks.bench_throughput as jthr  # noqa: E402
import benchmarks.common as jcommon  # noqa: E402
from repro.configs.paper_cnns import resnet74 as jresnet74  # noqa: E402
from repro.core import config as jc  # noqa: E402
from repro.core import energy as jenergy  # noqa: E402
from repro.core.ledger import EnergyLedger as JLedger  # noqa: E402
from repro.training.train_step import init_train_state as jinit  # noqa: E402
from repro_torch.configs.paper_cnns import resnet74  # noqa: E402
from repro_torch.convert import lm_state_dict_from_jax  # noqa: E402
from repro_torch.core import config as tc  # noqa: E402
from repro_torch.core.ledger import EnergyLedger  # noqa: E402
from repro_torch.launch import (bench_common, bench_convergence,  # noqa: E402
                                bench_e2train, bench_psg, bench_run,
                                bench_slu, bench_smd, bench_throughput)
from repro_torch.models.transformer import TransformerLM  # noqa: E402

LOSS_REL = 1e-4
RECORD_REL = 1e-12
STEPS = 8


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread each, as in ``test_torch_loop.py``: the benches
    run many small steps, and under parallel test workers every thread of
    every worker contends for the cores (each bench test took 50-160 s so,
    against 1-3 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_port(cfg):
    """A reference E2TrainConfig as the port's (the fields both have)."""
    def conv(src, cls):
        return cls(**{f.name: getattr(src, f.name)
                      for f in dataclasses.fields(cls)})
    return tc.E2TrainConfig(smd=conv(cfg.smd, tc.SMDConfig),
                            slu=conv(cfg.slu, tc.SLUConfig),
                            psg=conv(cfg.psg, tc.PSGConfig))


@pytest.mark.parametrize("preset", ["full", "off"])
def test_e2train_presets_equal_the_reference(preset):
    got = getattr(tc.E2TrainConfig, preset)()
    want = getattr(jc.E2TrainConfig, preset)()
    for part in ("smd", "slu", "psg"):
        g, w = getattr(got, part), getattr(want, part)
        for f in dataclasses.fields(g):
            assert getattr(g, f.name) == getattr(w, f.name), (part, f.name)
    # every field of the reference's is ported, the distribution ones too
    names = lambda c: {f.name for f in dataclasses.fields(c)}
    assert names(want.psg) == names(got.psg)
    assert {"majority_vote", "int8_gather"} <= names(got.psg)
    assert got == _to_port(want)


def _tiny_experiments():
    e2 = jc.E2TrainConfig(smd=jc.SMDConfig(True), slu=jc.SLUConfig(True),
                          psg=jc.PSGConfig(True))
    jexp = jc.Experiment(
        model=jcommon.TINY, e2=e2,
        train=jc.TrainConfig(global_batch=16, seq_len=32, total_steps=60))
    texp = bench_common.lm_experiment(_to_port(e2), 60)
    return jexp, texp


def _experiments(which):
    if which == "resnet74":
        e2 = jc.E2TrainConfig.full()
        return jresnet74(e2=e2), resnet74(e2=_to_port(e2))
    return _tiny_experiments()


@pytest.mark.parametrize("which", ["resnet74", "tiny"])
def test_energy_report_has_the_references_keys_in_order(which):
    jexp, texp = _experiments(which)
    want = JLedger(jexp).report(steps=60).to_dict()
    got = EnergyLedger(texp).report(steps=60).to_dict()
    assert list(got) == list(want)
    assert got["validated_against_hlo"] is None
    for key, value in want.items():
        if isinstance(value, float):
            assert got[key] == pytest.approx(value, rel=RECORD_REL), key
        else:
            assert got[key] == value, key


def test_validate_against_hlo_stamps_the_audit_verdict():
    """``report(validate_against_hlo=True)`` stamps the static cost
    audit's verdict on the ledger's own table: True for ResNet-14, False
    for a table that prices a layer the program never runs; without the
    flag the field stays ``None`` (absent, not false)."""
    from repro_torch.configs.paper_cnns import cnn_model
    from repro_torch.core.cost import LayerCost, TableCostModel

    exp = tc.Experiment(model=cnn_model("resnet14", 14),
                        e2=tc.E2TrainConfig.full(), task="cifar_cnn")
    led = EnergyLedger(exp)
    rep = led.report(validate_against_hlo=True, device="cpu")
    assert rep.validated_against_hlo is True
    assert rep.summary().endswith("cost table validated vs jaxpr/HLO: yes")
    divergent = TableCostModel(led.cost.name, led.cost.layers + (
        LayerCost("ghost", "conv", 1e6, 0, 0.0),))
    bad = EnergyLedger(exp, cost=divergent).report(
        validate_against_hlo=True, device="cpu")
    assert bad.validated_against_hlo is False
    assert bad.summary().endswith("cost table validated vs jaxpr/HLO: NO")
    assert led.report().validated_against_hlo is None
    assert led.report().summary().endswith(
        "cost table validated vs jaxpr/HLO: —")


# ---------------------------------------------------------------------------
# run_lm and eval_accuracy against the reference's
# ---------------------------------------------------------------------------

PARITY = {
    "sgd32": jc.E2TrainConfig(),
    "smd@1.00": jc.E2TrainConfig(smd=jsmd.SMD_CFG),
    "slu_mild": jc.E2TrainConfig(slu=jc.SLUConfig(
        enabled=True, alpha=1e-3, never_skip_first_last=False)),
}


def _port_model(params, e2):
    model = TransformerLM(bench_common.TINY, e2)
    model.load_state_dict(lm_state_dict_from_jax(
        jax.tree.map(np.asarray, params)))
    return model


@pytest.mark.parametrize("name", list(PARITY))
def test_run_lm_matches_the_reference(name):
    e2 = PARITY[name]
    jhist, jtr, _ = jcommon.run_lm(e2, STEPS, total_steps=STEPS)
    jexp = jtr.exp
    params = jinit(jax.random.PRNGKey(0), jexp).params
    te2 = _to_port(e2)
    hist, tr, wall = bench_common.run_lm(
        te2, STEPS, total_steps=STEPS, device="cpu",
        init=_port_model(params, te2))
    assert wall > 0
    assert (tr.executed_steps, tr.dropped_steps) == \
        (jtr.executed_steps, jtr.dropped_steps)
    assert len(hist) == len(jhist) == tr.executed_steps
    assert [h["step"] for h in hist] == [h["step"] for h in jhist]
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in jhist], rtol=LOSS_REL,
                               atol=0)
    assert bench_common.final_loss(hist) == pytest.approx(
        jcommon.final_loss(jhist), rel=LOSS_REL)
    if name == "sgd32":
        # held-out accuracy on the same weights: the reference's final ones
        _, same, _ = bench_common.run_lm(
            te2, 0, device="cpu",
            init=_port_model(jtr.state.params, te2))
        assert bench_common.eval_accuracy(same) == \
            float(jcommon.eval_accuracy(jtr))


# ---------------------------------------------------------------------------
# the derived records
# ---------------------------------------------------------------------------


def test_table3_sweep_and_derived_constants_equal_the_reference():
    got = bench_run.table3_config_derived()
    for skip, row in zip((0.2, 0.4, 0.6), got):
        op = jc.E2TrainConfig(smd=jc.SMDConfig(enabled=True, drop_prob=0.5),
                              slu=jc.SLUConfig(enabled=True, target_skip=skip),
                              psg=jc.PSGConfig(enabled=True))
        want = JLedger(jresnet74(e2=op)).report().to_dict()
        assert list(row) == list(want)
        assert row["validated_against_hlo"] is None
        for key, value in want.items():
            if isinstance(value, float):
                assert row[key] == pytest.approx(value, rel=RECORD_REL), key
            else:
                assert row[key] == value, key
    # the values chip_smoke.py holds the card's record to
    import chip_smoke
    pinned = chip_smoke.table3_pinned()
    for row, want in zip(pinned, got):
        assert set(row) == set(want)
        for key, value in want.items():
            if isinstance(value, float):
                assert row[key] == pytest.approx(value, rel=RECORD_REL), key
            else:
                assert row[key] == value, key
    s8 = 1 - (jenergy.mac_energy_pj(8, 8) + jenergy.mac_energy_pj(16, 8)
              + jenergy.mac_energy_pj(8, 16)) / (3 * jenergy.FP32_MAC_PJ)
    assert bench_psg.FIXED8_SAVING == s8
    assert bench_smd.RATIOS == jsmd.RATIOS


def test_fixed8_takes_the_predictor_everywhere():
    """beta = 0 gives tau = 0: every element is confident (|g_msb| >= 0),
    so no tile falls back (the reference's select, not its comment)."""
    assert bench_psg.FIXED8.psg.beta == 0.0
    _, tr, _ = bench_common.run_lm(bench_psg.FIXED8, 2, lr=0.03,
                                   optimizer="signsgd", device="cpu")
    assert tr.measured_psg_fallback() == 0.0
    assert tr.energy_report(steps=2).psg.measured == 0.0


# ---------------------------------------------------------------------------
# row names and derived keys against the reference's bench code
# ---------------------------------------------------------------------------


class _StubTrainer:
    """What the reference's benches read off a trainer, without training:
    the counts and a real EnergyReport from recorded telemetry."""

    def __init__(self, exp, steps):
        self.exp = exp
        self.executed_steps = steps
        self.history = [{"loss": 1.0}] * steps
        led = JLedger(exp)
        for _ in range(steps):
            led.record_step({"slu_exec_ratio": 0.75,
                             "psg_fallback_ratio": 0.5})
        led.executed_steps, led.dropped_steps = steps, steps
        self._ledger = led

    def energy_report(self, steps=None, validate_against_hlo=False):
        return self._ledger.report(steps=steps)


def _stub_run_lm(e2, steps, *, lr=0.1, optimizer="sgdm", seed=0, alpha=1e-3,
                 total_steps=None, model=jcommon.TINY):
    exp = jc.Experiment(model=model, e2=e2, train=jc.TrainConfig(
        global_batch=16, seq_len=32, lr=lr, optimizer=optimizer,
        total_steps=total_steps or steps, seed=seed))
    tr = _StubTrainer(exp, steps)
    return tr.history, tr, 1.0


def _names_and_keys(rows):
    out = []
    for row in rows:
        name, us, derived = row.split(",", 2)
        float(us)
        out.append((name, [kv.split("=", 1)[0] for kv in derived.split(";")]))
    return out


REFERENCE = {"psg": jpsg, "e2train": je2, "smd": jsmd, "slu": jslu,
             "convergence": jconv}
PORT = {"psg": bench_psg, "e2train": bench_e2train, "smd": bench_smd,
        "slu": bench_slu, "convergence": bench_convergence}
SMALL_STEPS = {"psg": 2, "e2train": 4, "smd": 3, "slu": 2, "convergence": 3}


@pytest.mark.parametrize("bench", list(PORT))
def test_bench_rows_have_the_references_names_and_keys(bench, monkeypatch):
    ref = REFERENCE[bench]
    monkeypatch.setattr(ref, "run_lm", _stub_run_lm)
    if hasattr(ref, "eval_accuracy"):
        monkeypatch.setattr(ref, "eval_accuracy", lambda tr: 0.5)
    want = _names_and_keys(list(ref.run(fast=True)))
    rows = PORT[bench].run(fast=True, device="cpu", steps=SMALL_STEPS[bench])
    assert _names_and_keys(rows) == want
    for row in rows:
        for kv in row.split(",", 2)[2].split(";"):
            key, value = kv.split("=", 1)
            if key == "curve":
                [float(v) for v in value.split("|")]
            elif key == "comp_saving_measured" and value == "":
                continue
            else:
                assert np.isfinite(float(value)), row
    if bench == "psg":
        assert rows[1].endswith(f"energy_saving={bench_psg.FIXED8_SAVING:.3f}")
    if bench == "e2train":
        assert [r.rsplit("paper=", 1)[1] for r in rows] == \
            ["0.8027", "0.8520", "0.9013"]


def test_throughput_rows_and_record_have_the_references_keys(monkeypatch):
    keys = ("per_step_steps_per_s", "chunked_steps_per_s")

    def stub(hw, width, batch, chunk_steps, steps):
        out = {"hw": hw, "width": width, "batch": batch,
               "chunk_steps": chunk_steps, "steps": steps}
        out.update({k: 10.0 for k in keys})
        out["chunk_speedup"] = 1.0
        return out

    monkeypatch.setattr(jthr, "_throughput", stub)
    want_record = jthr.throughput_json(fast=True)
    want = _names_and_keys(list(jthr.run(fast=True)))
    assert bench_throughput.CONFIGS == jthr.CONFIGS
    record = bench_throughput.throughput_json(True, "cpu", steps=2)
    assert {n: list(r) for n, r in record.items()} == \
        {n: list(r) for n, r in want_record.items()}
    assert all(r["steps"] == 2 and r["chunk_speedup"] > 0
               for r in record.values())
    # the rows of that record (measured once: each takes 2K + 2 steps of
    # both loops)
    monkeypatch.setattr(bench_throughput, "throughput_json",
                        lambda fast, device, steps: record)
    rows = bench_throughput.run(True, "cpu", steps=2)
    assert _names_and_keys(rows) == want
    assert rows[0].startswith("throughput_resnet14_cifar,")
    assert f"speedup={record['resnet14_cifar']['chunk_speedup']:.2f}x_" \
        in rows[0]


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------


def test_driver_runs_the_audit_bench_on_the_cpu(monkeypatch, capsys):
    """``--only audit --device cpu`` exits 0 with one row an experiment,
    one a linter and ``audit_all`` (``None``: the kernel lint and the
    hot-loop lint's ``no-host-callback`` run on the card only).  The
    export witness runs for the smoke LM alone here:
    ``tests/test_torch_audit.py`` holds it on a ResNet."""
    from repro_torch.launch import bench_audit
    monkeypatch.setattr(bench_audit, "EXPORT_WITNESS", ("llama3-8b",))
    assert bench_run.main(["--only", "audit", "--device", "cpu"]) == 0
    rows = capsys.readouterr().out.strip().splitlines()
    assert rows[0] == "name,us_per_call,derived"
    assert [r.split(",")[0] for r in rows[1:]] == [
        "audit_resnet74", "audit_resnet110", "audit_mobilenetv2",
        "audit_llama3-8b", "kernel_lint", "repo_lint", "precision",
        "hotloop", "audit_all"]
    assert all(r.split(",")[2].startswith("pass:") for r in rows[1:5])
    assert rows[-1] == "audit_all,0.0,all_passed=None"


def test_driver_reports_a_failing_bench_and_exits_1(monkeypatch, capsys):
    def boom(fast=True, device=None):
        raise RuntimeError("boom")

    monkeypatch.setitem(bench_run.BENCHES, "psg", boom)
    monkeypatch.setitem(bench_run.BENCHES, "smd",
                        lambda fast=True, device=None: ["fig3a/x,1.0,a=1"])
    assert bench_run.main(["--only", "psg,smd", "--device", "cpu"]) == 1
    out = capsys.readouterr().out.splitlines()
    assert out == ["name,us_per_call,derived", "fig3a/x,1.0,a=1",
                   "psg,0.0,ERROR:RuntimeError:boom"]


def test_driver_writes_records_only_where_told(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(bench_throughput, "throughput_json",
                        lambda fast, dev: {"fast": fast})
    out = tmp_path / "out"
    out.mkdir()
    assert bench_run.main(["--json", str(out / "E.json"),
                           "--json-throughput", str(out / "T.json"),
                           "--device", "cpu"]) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == ["out"]
    assert sorted(p.name for p in out.iterdir()) == ["E.json", "T.json"]
    import json
    energy = json.loads((out / "E.json").read_text())
    assert json.loads((out / "T.json").read_text()) == {"fast": True}
    assert list(energy) == ["table3_config_derived", "measured_run"]
    run = energy["measured_run"]
    assert run["validated_against_hlo"] is None
    assert (run["model"], run["steps"], run["batch"]) == ("resnet14", 12, 8)
    assert run["psg"]["measured"] is not None
    want = JLedger(jresnet74()).report().to_dict()
    assert list(run) == list(want)
