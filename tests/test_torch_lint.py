"""The port's linters (``repro_torch.analysis``): the repo linter on the
port and on planted violations, the kernel lint's rules on the launch
table recorded on the H100 (``tests/data/kernel_lint_h100.json``, written by
``chip_smoke.py`` phase 19) and on planted rows, the precision lint on the
shipped plain versions and a planted narrow accumulator, the hot-loop
lint on the CPU and on a planted step-dependent body, and the ``audit``
bench record."""
import copy
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import (hotloop_lint, kernel_lint,  # noqa: E402
                                  precision_lint, repo_lint)
from repro_torch.kernels.dispatch import (kernel_acc_dtypes,  # noqa: E402
                                          shipped_kernels)
from repro_torch.launch import bench_audit  # noqa: E402

TABLE = Path(__file__).resolve().parent / "data" / "kernel_lint_h100.json"

# --------------------------------------------------------------------------
# repo lint
# --------------------------------------------------------------------------


def test_repo_lint_is_clean_on_the_port():
    assert repo_lint.lint_repo() == []


PLANTED = {
    "kernel-outside-kernels": ("models/bad.py", "kernels/ok.py",
                               "import ctypes\nlib = ctypes.CDLL('x.so')\n"),
    "env-read": ("core/bad.py", None,
                 "import os\nv = os.environ.get('REPRO_TORCH_FAST')\n"),
    "host-sync": ("models/bad.py", "training/ok.py",
                  "def f(t):\n    return float(t.abs().max()) + t.item()\n"),
    "swallowed-exception": ("ft/bad.py", None,
                            "try:\n    f()\nexcept Exception:\n    pass\n"),
}


@pytest.mark.parametrize("rule", sorted(PLANTED))
def test_repo_lint_finds_a_planted_violation(rule, tmp_path):
    bad, ok, src = PLANTED[rule]
    for rel in (bad, ok):
        if rel:
            path = tmp_path / "repro_torch" / rel
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(src)
    found = repo_lint.lint_repo(str(tmp_path))
    assert found and {f.rule for f in found} == {rule}
    assert {f.path for f in found} == {f"repro_torch/{bad}"}


def test_repo_lint_allowlists_need_a_justification():
    with pytest.raises(ValueError, match="justification"):
        repo_lint.lint_source("x = 1\n", "repro_torch/a.py",
                              host_sync_allowed={"repro_torch/a.py": " "})
    assert repo_lint.lint_source(
        "def f(t):\n    return t.item()\n", "repro_torch/a.py",
        host_sync_allowed={"repro_torch/a.py": "host-side by design"}) == []


# --------------------------------------------------------------------------
# kernel lint: the rules on the card's table
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def table():
    return json.loads(TABLE.read_text())


def test_kernel_lint_rules_pass_on_the_recorded_card_table(table):
    assert "H100" in table["card"] and table["card"].endswith(" W")
    assert kernel_lint.check_rows(table["rows"]) == []
    assert kernel_lint.check_coverage(table["coverage"]) == []
    # every shipped kernel was linted, and every __global__ of csrc/
    # (24 with tc.cuh's two) was launched and read back
    assert {c["kernel"] for c in table["coverage"]} == set(shipped_kernels())
    globs = {r["global"] for r in table["rows"]}
    declared = {g for k in kernel_acc_dtypes().values() for g in k}
    assert globs == declared and len(globs) == 24


PLANTS = {
    "smem-budget": {"static_smem": 40_000, "dynamic_smem": 200_000,
                    "max_dynamic_smem": 232_448},
    "smem-opt-in": {"dynamic_smem": 60_000, "max_dynamic_smem": 48_000},
    "register-spill": {"local_bytes": 16},
    "occupancy": {"blocks_per_sm": 0},
    "acc-intent": {"global": "unknown_kernel"},
}


@pytest.mark.parametrize("plant", sorted(PLANTS))
def test_kernel_lint_rules_fail_on_a_planted_row(table, plant):
    rows = copy.deepcopy(table["rows"])
    row = next(r for r in rows if r["global"] == "conv_fwd_mma_kernel")
    row.update(PLANTS[plant])
    found = kernel_lint.check_rows(rows)
    rule = "smem-budget" if plant == "smem-opt-in" else plant
    assert [f.rule for f in found] == [rule], found


def test_kernel_lint_coverage_fails_on_an_unwritten_tile(table):
    cov = copy.deepcopy(table["coverage"])
    cov[0]["max_rel"][0] = float("inf")        # a NaN left by the fill
    cov[1]["sentinel_fill"] = False
    cov[2]["launches"] = 0
    rules = sorted(f.rule for f in kernel_lint.check_coverage(cov))
    assert rules == ["acc-intent", "coverage", "coverage"]
    assert kernel_lint.max_rel(torch.tensor([1.0, float("nan")]),
                               torch.tensor([1.0, 2.0])) == float("inf")
    assert kernel_lint.max_rel(torch.tensor([127], dtype=torch.int8),
                               torch.tensor([1], dtype=torch.int8)) == 126.0


def test_kernel_lint_never_passes_off_the_card(monkeypatch):
    with pytest.raises(ValueError, match="card only"):
        kernel_lint.lint_shipped("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        kernel_lint.lint_shipped()


# --------------------------------------------------------------------------
# precision lint
# --------------------------------------------------------------------------


def test_precision_lint_passes_the_shipped_plain_versions_and_train_steps():
    from repro_torch.configs.paper_cnns import mobilenetv2, resnet74
    assert precision_lint.lint_kernels(device="cpu") == []
    for exp in (resnet74(), mobilenetv2()):
        assert precision_lint.lint_experiment(exp, device="cpu") == []


def _planted_registry():
    """The reference's dx backward bug: a tap loop whose accumulator
    takes the operand's dtype."""
    def conv_taps(x, w):
        acc = torch.zeros((x.shape[0], w.shape[2]), dtype=x.dtype)
        for t in range(w.shape[0]):
            acc += x @ w[t]
        return acc

    def make_args(dev):
        g = np.random.default_rng(0)
        return (torch.from_numpy(g.standard_normal((8, 16), np.float32)),
                torch.from_numpy(g.standard_normal((9, 16, 4), np.float32)))

    return {"planted[taps]": (conv_taps, make_args)}


def test_precision_lint_catches_a_narrow_accumulator_under_the_bf16_swap():
    found = precision_lint.lint_kernels(
        device="cpu", registry=_planted_registry(),
        intents={"planted": {"conv_taps": ("float32",)}})
    assert found and all(f.surface == "kernel:planted[taps]~bf16"
                         and f.rule == "narrow-accumulator"
                         and f.acc_dtype == "bfloat16" for f in found)
    assert {f.kind for f in found} == {"dot_general", "add-chain"}
    out, allowed = precision_lint.split_findings(
        found, {"planted": "a test of the allowlist"})
    assert out == [] and len(allowed) == len(found)
    with pytest.raises(ValueError, match="justification"):
        precision_lint.split_findings(found, {"planted": ""})


def test_precision_lint_holds_the_declared_intent(monkeypatch):
    found = precision_lint.intent_findings(
        ["conv_fwd", "mystery"],
        {"conv_fwd": {"conv_fwd_mma_kernel": ("int16",)}})
    assert [f.rule for f in found] == ["acc-intent", "acc-intent-missing"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        precision_lint.lint_kernels()


# --------------------------------------------------------------------------
# hot-loop lint
# --------------------------------------------------------------------------


@pytest.mark.parametrize("which", [0, 1], ids=["resnet14", "smoke_llama3"])
def test_hotloop_lint_passes_on_the_cpu(which):
    exp = hotloop_lint.default_experiments()[which]
    findings, rules = hotloop_lint.lint_chunk(exp, device="cpu")
    assert findings == []
    assert rules.pop("no-host-callback") is None     # not checkable here
    assert all(v is True for v in rules.values())


def test_hotloop_lint_fails_a_step_dependent_body():
    from repro_torch.training.loop import make_chunk_step
    from repro_torch.training.train_step import init_train_state

    exp = hotloop_lint.default_experiments()[1]

    def planted(k):
        chunk = make_chunk_step(exp, k)
        inner = chunk.ts.device_step

        def device_step(state, batch, u, scal, keep=None):
            met, flags = inner(state, batch, u, scal, keep)
            if state.step % 2:           # an op the step's parity adds
                met = {**met, "loss": met["loss"] * 1.0}
            return met, flags

        chunk.ts.device_step = device_step
        return chunk

    findings, rules = hotloop_lint.lint_program(
        planted, lambda: init_train_state(exp, 0, "cpu"),
        hotloop_lint._batches(exp, torch.device("cpu")), 3,
        torch.device("cpu"))
    assert [f.rule for f in findings] == ["shape-stable-body"]
    assert rules["shape-stable-body"] is False


# --------------------------------------------------------------------------
# the audit bench record
# --------------------------------------------------------------------------


def test_audit_record_has_schema_2_and_records_a_crashing_linter(
        monkeypatch):
    from repro_torch.configs.paper_cnns import cnn_model
    from repro_torch.core.config import Experiment

    def boom():
        raise RuntimeError("linter broke")

    monkeypatch.setattr(repo_lint, "repo_report", boom)
    monkeypatch.setattr(bench_audit, "_experiments", lambda: [Experiment(
        model=cnn_model("resnet14", 14), task="cifar_cnn")])
    monkeypatch.setattr(hotloop_lint, "hotloop_report",
                        lambda device=None: {"findings": [], "passed": True})
    record = bench_audit.audit_json(device="cpu")
    assert record["schema_version"] == 2
    assert record["repo_lint"]["error"] == "RuntimeError: linter broke"
    assert record["repo_lint"]["passed"] is False
    assert record["lint_errors"] == ["repo_lint"]
    assert record["all_passed"] is False
    assert record["precision"] == {"findings": [], "allowlisted": [],
                                   "passed": True, "error": None}
    assert record["kernel_lint"]["passed"] is None      # the card's only
    assert record["audits"][0]["passed"] is True
