"""repro_torch's fault tolerance: checkpoints in the JAX package's format,
integrity checks against injected corruption, write-failure surfacing, the
straggler policy, bitwise resume, the elastic supervisor, and checkpoints
that cross-load with the JAX package in both directions.

The cases of the JAX package's ``tests/test_ft.py`` and
``tests/test_faults.py`` that need no mesh, on the port's modules; the
kill-and-restart runs the port's launcher on the CPU at depth 8, width 8,
batch 4.  Every comparison here is exact: a checkpoint holds the bits it
was given, and a resumed run on the CPU repeats the uninterrupted one.
"""
import json
import os
import subprocess
import sys
import tempfile

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_experiment as jget  # noqa: E402
from repro.configs import reduce_experiment as jreduce  # noqa: E402
from repro.configs.paper_cnns import cnn_model as jcnn_model  # noqa: E402
from repro.core import config as jc  # noqa: E402
from repro.ft import checkpoint as jckpt  # noqa: E402
from repro.training.train_step import init_train_state as jinit  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_experiment, reduce_experiment  # noqa: E402
from repro_torch.configs.paper_cnns import cnn_model  # noqa: E402
from repro_torch.core import config as tc  # noqa: E402
from repro_torch.ft import faults  # noqa: E402
from repro_torch.ft.checkpoint import (WRITE_RETRIES,  # noqa: E402
                                       CheckpointWriteError, _flatten,
                                       intact_steps,
                                       latest_intact_step, latest_step,
                                       restore_checkpoint, resume_chunk_start,
                                       save_checkpoint, verify_checkpoint,
                                       wait_for_saves)
from repro_torch.ft.supervisor import (RestartPolicy, Supervisor,  # noqa: E402
                                       SupervisorError, free_tcp_port)
from repro_torch.launch import train  # noqa: E402
from repro_torch.training.train_step import init_train_state  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _state():
    return {"params": {"w": torch.arange(6.0).reshape(2, 3),
                       "b": torch.ones(3)},
            "step": np.int32(7)}


# ---------------------------------------------------------------------------
# save / restore
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip_sync():
    st = _state()
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, st, 7)
        out, step = restore_checkpoint(d, st)
        assert step == 7
        assert torch.equal(out["params"]["w"], st["params"]["w"])
        assert out["step"] == 7 and out["step"].dtype == np.int32


def test_checkpoint_async_and_latest():
    st = _state()
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, st, 10, async_save=True)
        save_checkpoint(d, st, 20, async_save=True)
        wait_for_saves()
        assert latest_step(d) == 20
        _, step = restore_checkpoint(d, st)
        assert step == 20
        assert not [f for f in os.listdir(d) if "tmp" in f]


def test_resume_chunk_start_and_shape_validation():
    st = _state()
    with tempfile.TemporaryDirectory() as d:
        assert resume_chunk_start(d) is None
        save_checkpoint(d, st, 23)
        assert resume_chunk_start(d) == 24
        assert resume_chunk_start(d, step=7) == 8
        bad = {"params": {"w": torch.zeros(3, 3), "b": torch.ones(3)},
               "step": np.int32(0)}
        with pytest.raises(ValueError):
            restore_checkpoint(d, bad)


def test_manifest_commits_checkpoint():
    st = _state()
    with tempfile.TemporaryDirectory() as d:
        path = save_checkpoint(d, st, 5)
        with open(path + ".manifest.json") as f:
            manifest = json.load(f)
        assert manifest["step"] == 5
        assert all("crc32" in m and "shape" in m and "dtype" in m
                   for m in manifest["leaves"].values())
        assert verify_checkpoint(d, 5) == (True, "ok")
        assert intact_steps(d) == [5]
        assert latest_intact_step(d) == 5


@pytest.mark.parametrize("mode", faults.CORRUPT_MODES)
def test_corruption_detected_and_fallback(mode):
    stA = _state()
    stB = {"params": {"w": torch.arange(6.0).reshape(2, 3) + 100.0,
                      "b": torch.zeros(3)}, "step": np.int32(8)}
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, stA, 3)
        save_checkpoint(d, stB, 7)
        faults.corrupt_checkpoint(d, 7, mode)
        ok, reason = verify_checkpoint(d, 7)
        assert not ok and reason, f"{mode} not detected"
        assert verify_checkpoint(d, 3) == (True, "ok")
        assert latest_intact_step(d) == 3
        if mode != "partial":
            assert latest_step(d) == 7
        out, step = restore_checkpoint(d, stA)
        assert step == 3
        assert torch.equal(out["params"]["w"], stA["params"]["w"])


def test_tamper_caught_only_by_manifest_crc():
    st = _state()
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, st, 2)
        path = faults.corrupt_checkpoint(d, 2, "tamper")
        with np.load(path) as data:                  # the container reads
            assert set(data.files) == {"params::w", "params::b", "step"}
        ok, reason = verify_checkpoint(d, 2)
        assert not ok and "checksum" in reason
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(ValueError, match="unknown corruption mode"):
            faults.corrupt_checkpoint(d, 0, "gamma-ray")


def test_restore_verify_false_is_legacy_path():
    st = _state()
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, st, 4)
        faults.corrupt_checkpoint(d, 4, "partial")
        with pytest.raises(FileNotFoundError):
            restore_checkpoint(d, st)
        _, step = restore_checkpoint(d, st, verify=False)
        assert step == 4


def test_restore_requested_step_falls_back_at_or_before():
    st = _state()
    with tempfile.TemporaryDirectory() as d:
        for s in (1, 4, 9):
            save_checkpoint(d, st, s)
        faults.corrupt_checkpoint(d, 4, "truncate")
        _, step = restore_checkpoint(d, st, step=4)
        assert step == 1


# ---------------------------------------------------------------------------
# write failures
# ---------------------------------------------------------------------------


def test_failing_writer_retry_then_success():
    st = _state()
    with tempfile.TemporaryDirectory() as d:
        with faults.failing_writer(fails=WRITE_RETRIES - 1) as count:
            save_checkpoint(d, st, 6)
        assert count["n"] == WRITE_RETRIES - 1
        assert verify_checkpoint(d, 6) == (True, "ok")
        assert wait_for_saves() == {}


def test_failing_writer_terminal_sync_raises():
    with tempfile.TemporaryDirectory() as d:
        with faults.failing_writer():
            with pytest.raises(CheckpointWriteError):
                save_checkpoint(d, _state(), 6)
        assert intact_steps(d) == []


def test_failing_writer_terminal_async_surfaces():
    with tempfile.TemporaryDirectory() as d:
        with faults.failing_writer():
            save_checkpoint(d, _state(), 6, async_save=True)
            with pytest.raises(CheckpointWriteError) as ei:
                wait_for_saves()
        assert len(ei.value.failures) == 1
        assert isinstance(next(iter(ei.value.failures.values())), OSError)
        assert wait_for_saves() == {}
        assert latest_intact_step(d) is None


def _trainer(steps=6, **kw):
    return train.build_trainer(8, 4, 2, steps, device="cpu", **kw)


def test_trainer_reports_failed_final_save(capsys):
    with tempfile.TemporaryDirectory() as d:
        tr = _trainer(checkpoint_dir=d)
        with faults.failing_writer():
            hist = tr.run(3)
        assert len(hist) == tr.executed_steps > 0     # training survived
        assert tr.save_errors
        assert all(isinstance(e, OSError) for e in tr.save_errors.values())
        assert latest_intact_step(d) is None
        assert "CHECKPOINT SAVE FAILED" in capsys.readouterr().err
    with tempfile.TemporaryDirectory() as d:
        argv = ["--depth", "8", "--width", "4", "--batch", "2", "--steps",
                "2", "--device", "cpu", "--ckpt", d]
        with faults.failing_writer():
            assert train.main(argv) == 1
        assert train.main(argv) == 0
        assert latest_intact_step(d) == 1


# ---------------------------------------------------------------------------
# the straggler policy
# ---------------------------------------------------------------------------


def test_straggler_becomes_a_counted_drop():
    # every executed step straggles; step 1 is an SMD drop that absorbs
    # the arm of step 0, steps 3 and 5 are forced
    tr = _trainer(deadline_s=1e-9)
    tr.keep_schedule = [True, False, True, True, True, True]
    tr.run(6)
    assert [h["step"] for h in tr.history] == [0, 2, 4]
    assert (tr.executed_steps, tr.dropped_steps,
            tr.straggler_dropped_steps) == (3, 3, 2)
    assert tr.energy_report(steps=6).straggler_dropped == 2
    tr2 = _trainer()
    tr2.run(4)
    assert tr2.straggler_dropped_steps == 0
    assert tr2.energy_report(steps=4).straggler_dropped == 0


# ---------------------------------------------------------------------------
# resume: bitwise on the CPU
# ---------------------------------------------------------------------------


def _flat(state):
    """A port TrainState as the npz entries a checkpoint holds."""
    return _flatten(convert.train_state_tree(state))


def test_resume_is_bitwise_the_uninterrupted_run():
    a = _trainer()
    a.run(6)
    with tempfile.TemporaryDirectory() as d:
        b = _trainer(checkpoint_dir=d)
        b.run(3)
        assert latest_intact_step(d) == 2
        c = _trainer()                       # fresh state from the seed
        restore_checkpoint(d, c.state)
        assert c.state.step == 3
        c.run(3)
    fa, fc = _flat(a.state), _flat(c.state)
    assert fa.keys() == fc.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k], fc[k], err_msg=k)
    assert [h["loss"] for h in a.history if h["step"] >= 3] == \
        [h["loss"] for h in c.history]


# ---------------------------------------------------------------------------
# cross-loading with the JAX package
# ---------------------------------------------------------------------------


def _pair(kind):
    """The same experiment in both packages."""
    if kind.startswith("resnet"):
        psg = kind == "resnet_psg_swa"
        kw = dict(global_batch=4, total_steps=4,
                  optimizer="psg" if psg else "sgdm")
        j = jc.Experiment(model=jcnn_model("resnet14", 14, width=4),
                          e2=jc.E2TrainConfig(slu=jc.SLUConfig(enabled=True),
                                              psg=jc.PSGConfig(enabled=psg)),
                          train=jc.TrainConfig(**kw), task="cifar_cnn")
        t = tc.Experiment(model=cnn_model("resnet14", 14, width=4),
                          e2=tc.E2TrainConfig(slu=tc.SLUConfig(enabled=True),
                                              psg=tc.PSGConfig(enabled=psg)),
                          train=tc.TrainConfig(**kw), task="cifar_cnn")
        return j, t
    opt = "adamw" if kind == "lm_adamw" else "psg"
    j, t = jreduce(jget("qwen2_5_3b")), reduce_experiment(
        get_experiment("qwen2_5_3b"))
    j = j.replace(e2=jc.E2TrainConfig(slu=jc.SLUConfig(enabled=True),
                                      psg=jc.PSGConfig(enabled=opt == "psg")),
                  train=jc.TrainConfig(optimizer=opt))
    t = t.replace(e2=tc.E2TrainConfig(slu=tc.SLUConfig(enabled=True),
                                      psg=tc.PSGConfig(enabled=opt == "psg")),
                  train=tc.TrainConfig(optimizer=opt))
    return j, t


def _randomized(tree, seed):
    """Every float leaf drawn from a numpy seed, every integer leaf 5."""
    r = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: np.asarray(r.randn(*np.shape(x)), np.asarray(x).dtype)
        if np.issubdtype(np.asarray(x).dtype, np.floating)
        else np.asarray(5, np.asarray(x).dtype), tree)


KINDS = ["resnet_sgdm", "resnet_psg_swa", "lm_psg_swa", "lm_adamw"]


@pytest.mark.parametrize("kind", KINDS)
def test_checkpoint_keys_equal_the_jax_package(kind):
    jexp, texp = _pair(kind)
    jflat = jckpt._flatten(jinit(jax.random.PRNGKey(0), jexp))
    flat = _flat(init_train_state(texp, device="cpu"))
    assert set(flat) == set(jflat)
    for k, v in flat.items():
        assert (v.shape, v.dtype) == (jflat[k].shape, jflat[k].dtype), k
    assert any(k.startswith("swa::") for k in flat) == ("swa" in kind)
    assert any(k.startswith("model_state::") for k in flat) == \
        kind.startswith("resnet")


@pytest.mark.parametrize("kind", KINDS)
def test_jax_checkpoint_restores_in_the_port(kind):
    jexp, texp = _pair(kind)
    jstate = _randomized(jinit(jax.random.PRNGKey(0), jexp), 1)
    with tempfile.TemporaryDirectory() as d:
        jckpt.save_checkpoint(d, jstate, 5)
        assert verify_checkpoint(d, 5) == (True, "ok")
        state = init_train_state(texp, device="cpu")
        restored, step = restore_checkpoint(d, state)
        assert restored is state and step == 5 and state.step == 5
        with np.load(os.path.join(d, "step_00000005.npz")) as data:
            want = {k: data[k] for k in data.files}
    got = _flat(state)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("kind", KINDS)
def test_port_checkpoint_restores_in_the_jax_package(kind):
    jexp, texp = _pair(kind)
    jlike = jinit(jax.random.PRNGKey(0), jexp)
    state = init_train_state(texp, device="cpu")
    tree = _randomized(convert.train_state_tree(state), 2)
    convert.load_train_state(state, tree)
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, state, 3)
        assert jckpt.verify_checkpoint(d, 3) == (True, "ok")
        jtree, step = jckpt.restore_checkpoint(d, jlike)
    assert step == 3 and int(jtree.step) == 5
    jflat, flat = jckpt._flatten(jtree), _flat(state)
    assert set(jflat) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(jflat[k], flat[k], err_msg=k)


def test_convert_round_trips_through_state_dict_from_jax():
    _, texp = _pair("resnet_psg_swa")
    state = init_train_state(texp, device="cpu")
    tree = convert.train_state_tree(state)
    sd = convert.state_dict_from_jax(tree["params"], tree["model_state"])
    assert sd.keys() == state.model.state_dict().keys()
    for k, v in state.model.state_dict().items():
        assert torch.equal(sd[k], v), k
    stages = tree["params"]["stages"]
    assert [sorted(s) for s in stages] == [["rest", "trans"]] * 3
    assert "down" not in stages[0]["trans"]
    assert set(stages[1]["trans"]["down"]) == {"conv"}
    assert stages[1]["rest"]["conv1"]["w"].shape[0] == 1   # (14 - 2) / 6 - 1
    _, lexp = _pair("lm_psg_swa")
    lm = init_train_state(lexp, device="cpu")
    ltree = convert.train_state_tree(lm)
    assert list(ltree["params"]["units"]) == ["b0_attn"]
    sd = convert.lm_state_dict_from_jax(ltree["params"])
    for k, v in lm.model.state_dict().items():
        assert torch.equal(sd[k], v), k
    assert ltree["model_state"] is None


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------


def _exit_cmd(code):
    return [sys.executable, "-c", f"import sys; sys.exit({code})"]


def test_supervisor_policy_with_trivial_workers():
    with tempfile.TemporaryDirectory() as d:
        sup = Supervisor(lambda w, r, resume: _exit_cmd(0), world=2,
                         ckpt_dir=d)
        attempts = sup.run()
        assert [a.outcome for a in attempts] == ["ok"]
        assert attempts[0].exit_codes == [0, 0] and attempts[0].wall_s > 0
        assert sup.summary()["restarts"] == 0

        def shrink(world, rank, resume):
            return _exit_cmd(faults.KILL_EXIT_CODE
                             if (world == 2 and rank == 1) else 0)
        sup = Supervisor(shrink, world=2, ckpt_dir=d)
        attempts = sup.run()
        assert [a.world for a in attempts] == [2, 1]
        assert attempts[0].outcome == "worker-died"
        assert faults.KILL_EXIT_CODE in attempts[0].exit_codes
        assert attempts[1].outcome == "ok"
        assert attempts[1].resume_step is None    # no checkpoint landed

        sup = Supervisor(lambda w, r, resume: _exit_cmd(
            5 if r == w - 1 else 0), world=3, ckpt_dir=d,
            policy=RestartPolicy(max_restarts=1))
        with pytest.raises(SupervisorError, match="gave up"):
            sup.run()
        assert [a.world for a in sup.attempts] == [3, 2]
        assert sup.attempts[-1].outcome == "aborted"

        sup = Supervisor(lambda w, r, resume: _exit_cmd(5), world=2,
                         ckpt_dir=d,
                         policy=RestartPolicy(max_restarts=5, min_world=2))
        with pytest.raises(SupervisorError, match="min_world"):
            sup.run()
        assert len(sup.attempts) == 1
    assert 0 < free_tcp_port() < 65536


def _launcher(*args):
    return [sys.executable, "-m", "repro_torch.launch.train", "--depth", "8",
            "--width", "8", "--batch", "4", "--device", "cpu", *args]


def _env():
    # one thread a worker: three run at once, beside the test's own workers
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep \
        + env.get("PYTHONPATH", "")
    return env


def test_kill_and_restart_resumes_bitwise():
    """A worker hard-killed mid-run is detected, the world shrinks 2 -> 1,
    the relaunch resumes from the last intact checkpoint, and the final
    checkpoint equals an uninterrupted run's bit for bit."""
    steps = 10
    with tempfile.TemporaryDirectory() as d:
        ckpt, scratch, ref = (os.path.join(d, n)
                              for n in ("ckpt", "scratch", "ref"))

        def make_cmd(world, rank, resume):
            # the last rank owns the supervised stream, and is the one
            # killed in the first attempt: its saves stop at step 5, so the
            # restart resumes from the middle of the run, whatever the
            # other rank's pace
            args = ["--steps", str(steps), "--ckpt-every", "1",
                    "--ckpt", ckpt if rank == world - 1 else scratch]
            if resume is not None:
                args += ["--resume"]
            elif world > 1 and rank == world - 1:
                args += ["--ft-kill-at-step", "6"]
            return _launcher(*args)

        sup = Supervisor(make_cmd, world=2, ckpt_dir=ckpt, env=_env(),
                         worker_timeout_s=120)
        attempts = sup.run()
        assert [a.world for a in attempts] == [2, 1]
        assert attempts[0].outcome == "worker-died"
        assert faults.KILL_EXIT_CODE in attempts[0].exit_codes
        assert attempts[1].outcome == "ok"
        assert attempts[1].resume_step in (2, 5)   # steps 0, 2, 5 execute
        assert latest_intact_step(ckpt) == steps - 1

        out = subprocess.run(_launcher("--steps", str(steps), "--ckpt-every",
                                       "1", "--ckpt", ref),
                             cwd=REPO, env=_env(), capture_output=True,
                             text=True, timeout=120)
        assert out.returncode == 0, out.stderr[-2000:]
        assert "held-out accuracy" in out.stdout
        a = np.load(os.path.join(ckpt, f"step_{steps - 1:08d}.npz"))
        b = np.load(os.path.join(ref, f"step_{steps - 1:08d}.npz"))
        assert set(a.files) == set(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
