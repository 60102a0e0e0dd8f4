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
    assert not roots & {"jax", "jaxlib", "repro"}, roots


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
