"""repro_torch stands alone: it imports neither JAX nor the JAX package,
and its entry points run on the card unless told otherwise."""
import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro", "benchmarks"}, roots


def test_every_port_module_imports_without_a_card():
    import importlib
    for path in PORT_FILES[:-1]:
        mod = ".".join(path.relative_to(ROOT / "src").with_suffix("").parts)
        importlib.import_module(mod.removesuffix(".__init__"))


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_the_card_and_raise_without_one(no_card):
    from repro_torch.launch import train
    from repro_torch.training.train_step import init_train_state
    from repro_torch.training.trainer import Trainer

    exp = train.experiment(depth=8, width=4, batch=2, steps=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_train_state(exp)
    state = init_train_state(exp, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(exp, state, lambda step, shard: None)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.run(["--depth", "8", "--width", "4", "--batch", "2",
                    "--steps", "1"])


def test_cli_runs_on_the_cpu_when_asked(capsys):
    from repro_torch.launch import train
    trainer = train.run(["--depth", "8", "--width", "4", "--batch", "2",
                          "--steps", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert trainer.executed_steps + trainer.dropped_steps == 3
    if trainer.executed_steps:
        assert "measured PSG fallback" in out and "energy report" in out


def test_lm_entry_points_default_to_the_card_and_raise_without_one(no_card):
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="CUDA"):
        train.build_lm_trainer("qwen2_5_3b", smoke=True, steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.run(["--task", "lm", "--arch", "qwen2_5_3b", "--smoke",
                    "--steps", "1"])


def test_serve_cli_defaults_to_the_card_and_raises_without_one(no_card):
    from repro_torch.configs import get_experiment, reduce_experiment
    from repro_torch.launch import serve
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.serving import ServeEngine
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "qwen2_5_3b", "--smoke", "--requests", "1"])
    exp = reduce_experiment(get_experiment("qwen2_5_3b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(exp, TransformerLM(exp.model))


def test_lm_cli_runs_on_the_cpu_when_asked(capsys):
    from repro_torch.launch import train
    trainer = train.run(["--task", "lm", "--arch", "qwen2_5_3b", "--smoke",
                          "--seq", "12", "--steps", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert trainer.exp.task == "lm" and trainer.exp.train.seq_len == 12
    assert trainer.executed_steps + trainer.dropped_steps == 3
    assert trainer.executed_steps > 0      # seed 0 keeps step 0
    assert "measured PSG fallback" in out and "energy report" in out
    assert all(np.isfinite(h["loss"]) for h in trainer.history)


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    import subprocess
    import sys
    env_py = [sys.executable, str(ROOT / "chip_smoke.py")]
    proc = subprocess.run(env_py, capture_output=True, text=True, timeout=120,
                          cwd=tmp_path, env={"PATH": "/usr/bin:/bin",
                                             "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chunked_loop_modules_stand_alone():
    """The chunked loop's modules are among the files checked above and
    import without a card."""
    for rel in ("training/loop.py", "data/pipeline.py",
                "kernels/graph_cond.py"):
        assert ROOT / "src" / "repro_torch" / rel in PORT_FILES, rel
    from repro_torch.data import pipeline  # noqa: F401
    from repro_torch.kernels import graph_cond  # noqa: F401
    from repro_torch.training import loop  # noqa: F401


def test_distribution_modules_stand_alone():
    """The distribution layer's modules are among the files checked above
    (no JAX, nothing of the JAX package) and importing them touches no
    process group."""
    import torch.distributed as dist
    for rel in ("distributed/__init__.py", "distributed/sharding.py",
                "distributed/fsdp.py", "launch/mesh.py", "ft/elastic.py",
                "optim/majority_vote.py"):
        assert ROOT / "src" / "repro_torch" / rel in PORT_FILES, rel
    from repro_torch import distributed  # noqa: F401
    from repro_torch.distributed import fsdp, sharding  # noqa: F401
    from repro_torch.ft import elastic  # noqa: F401
    from repro_torch.launch import mesh  # noqa: F401
    assert not dist.is_initialized()
    assert distributed.process_shard() == (0, 1)


def test_analysis_imports_without_jax_and_needs_a_card_or_the_cpu(no_card):
    """The audit, the linters and their bench import with JAX unimportable,
    and each raises without a card unless asked for the CPU."""
    import subprocess
    import sys

    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "import repro_torch.analysis, repro_torch.launch.bench_audit, "
            "repro_torch.launch.export_cost")
    env = {**__import__("os").environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr

    from repro_torch.analysis import audit, hotloop_lint, kernel_lint, \
        precision_lint
    from repro_torch.configs.paper_cnns import resnet74
    from repro_torch.core.ledger import EnergyLedger
    from repro_torch.launch import bench_run
    exp = resnet74()
    for call in (lambda: audit.audit_experiment(exp, batch=2),
                 lambda: EnergyLedger(exp).report(validate_against_hlo=True),
                 lambda: kernel_lint.lint_shipped(),
                 lambda: precision_lint.lint_kernels(),
                 lambda: hotloop_lint.lint_chunk(exp),
                 lambda: bench_run.main(["--only", "audit"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_dry_run_modules_stand_alone():
    """The dry run's modules are among the files checked above, and the
    dry run imports neither JAX nor the JAX package when it runs."""
    import subprocess
    import sys
    for rel in ("launch/specs.py", "launch/dryrun.py",
                "launch/bench_roofline.py"):
        assert ROOT / "src" / "repro_torch" / rel in PORT_FILES, rel
    code = ("import sys; from repro_torch.launch import dryrun, "
            "bench_roofline, specs; "
            "r = dryrun.analyze_cell('qwen2_5_3b', 'long_500k', False); "
            "bench_roofline.render_cnn_analytic(); "
            "assert r['status'] == 'skipped', r; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'benchmarks')]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={"PATH": "/usr/bin:/bin",
                               "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_bench_and_example_launchers_stand_alone():
    """The conv and attention benches and the two example launchers are
    among the files checked above, and running their byte models and
    importing them pulls in neither JAX nor the JAX package."""
    import subprocess
    import sys
    for rel in ("launch/bench_conv.py", "launch/bench_attn.py",
                "launch/finetune_split.py", "launch/quickstart.py"):
        assert ROOT / "src" / "repro_torch" / rel in PORT_FILES, rel
    code = ("import sys; from repro_torch.launch import bench_conv, "
            "bench_attn, finetune_split, quickstart; "
            "bench_conv._paper_totals(depth=8, batch=2); "
            "bench_attn._paper_totals(); quickstart.table3(); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'benchmarks')]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={"PATH": "/usr/bin:/bin",
                               "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr[-2000:]


@pytest.mark.parametrize("mod", ["finetune_split", "quickstart"])
def test_example_launchers_default_to_the_card(mod, no_card):
    import importlib
    launcher = importlib.import_module(f"repro_torch.launch.{mod}")
    with pytest.raises(RuntimeError, match="CUDA"):
        launcher.main([])
