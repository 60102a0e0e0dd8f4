"""repro_torch's data-parallel meshes in 2-rank gloo worlds on the CPU,
against one rank and against the JAX package.

One world of two ranks (this file run as a script, one process a rank,
one thread each, no JAX imported) runs every in-process check and saves
what it computed; the test process computes the one-rank references and,
meanwhile, the JAX package's curve:

* the PSG weight-gradient signs and fallback flags of the matmul and the
  conv (kernels 3-6's wrappers, the int64 sums reduced across ranks) and
  the flash-attention backward (kernel 9's wrapper, global grids and tau),
  each rank on its rows of one global batch: bit for bit the one-rank
  results on the whole batch;
* a ResNet-8 with SLU and PSG trained two steps by ``Trainer(mesh=)``: the
  SLU decisions equal, the losses and BatchNorm statistics within 1e-5,
  and the first step's update signs of every conv equal;
* a PSG-off ResNet-8 in two microbatches: the losses and BatchNorm
  statistics within 1e-5 of one rank's, which holds only with the JAX
  package's microbatch row order;
* the MoE routing groups (a rank's tokens must be whole groups) and its
  global aux loss; ``int8_gather``'s forward bit for bit the plain one;
* a PSG-off ``sgdm`` LM with SMD: its loss curve within the JAX package's
  own mesh tolerance (rtol 2e-3, ``tests/test_loop.py``) of the JAX
  package's single-device ``Trainer``, with equal SMD counts.

The launcher's flags run in worlds of their own (``--devices 2 --mesh-data
2`` and its resume, a killed rank, the elastic 2 -> 1 restart through the
supervisor, ``--distributed`` without a mesh).  Every process and every
group has a timeout.
"""
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 240           # seconds a test's processes may take
GROUP_TIMEOUT = 60      # seconds a collective may wait
LM_STEPS = 8            # nominal steps of the LM curve (SMD drops some)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    return env


def _free_port() -> int:
    from repro_torch.ft.supervisor import free_tcp_port
    return free_tcp_port()


def _run_all(procs):
    """Wait for every process (TIMEOUT in all); kill them all on a
    timeout; returns their (code, stdout, stderr)."""
    out = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=TIMEOUT)
            out.append((p.returncode, so, se))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def _launcher(*args):
    return [sys.executable, "-m", "repro_torch.launch.train", "--device",
            "cpu", *args]


# ---------------------------------------------------------------------------
# inputs, the same in the ranks and in the references
# ---------------------------------------------------------------------------

def _op_inputs():
    rs = np.random.RandomState(0)
    f = lambda *s: torch.from_numpy(rs.normal(size=s).astype(np.float32))
    return {"conv": (f(4, 10, 10, 3), f(4, 8, 8, 16)),       # k 3, stride 1
            "conv_s2": (f(4, 9, 9, 8), f(4, 4, 4, 24)),      # k 3, stride 2
            "matmul": (f(64, 40), f(64, 24) * 1e-3),
            "attn": (f(4, 16, 4, 8), f(4, 16, 2, 8), f(4, 16, 2, 8),
                     f(4, 16, 4, 8))}


def _rows(t, rank, world):
    n = t.shape[0] // world
    return t[rank * n:(rank + 1) * n]


def _op_results(rank=0, world=1):
    """The PSG ops on this rank's rows (the whole batch for one rank)."""
    from repro_torch.core.config import PSGConfig
    from repro_torch.kernels import ops
    cfg = PSGConfig(enabled=True)
    out = {}
    for name, (xp, gy) in ((k, v) for k, v in _op_inputs().items()
                           if k.startswith("conv")):
        stride = 2 if name.endswith("s2") else 1
        out[name] = ops.conv_grad_w(_rows(xp, rank, world),
                                    _rows(gy, rank, world), cfg, 3, stride)
    x, gy = _op_inputs()["matmul"]
    out["matmul"] = ops.psg_grad_w(_rows(x, rank, world),
                                   _rows(gy, rank, world), cfg)
    q, k, v, do = (_rows(t, rank, world) for t in _op_inputs()["attn"])
    o, lse = ops.flash_attention_fwd(q, k, v, causal=True)
    out["attn"] = ops.flash_attention_bwd(q, k, v, o, lse, do, cfg,
                                          causal=True)
    return out


def _cnn_trainer(mesh, steps, e2, microbatches=1, batch=8, **kw):
    import dataclasses
    from repro_torch.launch import train as tl
    exp = tl.experiment(8, 4, batch, steps, e2=e2)
    exp = exp.replace(train=dataclasses.replace(exp.train,
                                                microbatches=microbatches))
    from repro_torch.data import synthetic
    from repro_torch.training.evaluate import data_task
    from repro_torch.training.train_step import init_train_state
    from repro_torch.training.trainer import Trainer
    task = data_task(exp)
    return Trainer(exp, init_train_state(exp, seed=0, device="cpu"),
                   lambda step, shard: synthetic.make_image_batch(
                       task, 0, step, shard, batch, "cpu"),
                   device="cpu", mesh=mesh, **kw)


def _e2(psg: bool):
    from repro_torch.core.config import (E2TrainConfig, PSGConfig,
                                         SLUConfig)
    return E2TrainConfig(slu=SLUConfig(enabled=True, alpha=1e-3),
                         psg=PSGConfig(enabled=psg))


def _cnn_results(trainer):
    trainer.run(trainer.exp.train.total_steps)
    full = trainer.full_state()
    return {"loss": [h["total_loss"] for h in trainer.history],
            "flags": [h["slu_executed"] for h in trainer.history],
            "fallback": [h.get("psg_fallback_ratio") for h in trainer.history],
            "buffers": {k: b.clone() for k, b in
                        full.model.named_buffers()},
            "params": {k: p.detach().clone() for k, p in
                       full.model.named_parameters()}}


def _moe(world=1, rank=0, seq=1024):
    from repro_torch.configs import get_experiment, reduce_experiment
    from repro_torch.models import moe
    cfg = reduce_experiment(get_experiment("deepseek_moe_16b")).model
    m = moe.MoE(cfg, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.RandomState(1).normal(
        size=(2, seq, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        return moe.moe_fwd(m, _rows(x, rank, world), cfg)


def _lm_experiment():
    import dataclasses
    from repro_torch.launch import train as tl
    exp = tl.lm_experiment("qwen2_5_3b", steps=LM_STEPS, smoke=True,
                           e2=tl.E2TRAIN["smd"], fused_attention=False)
    return exp.replace(train=dataclasses.replace(exp.train,
                                                 optimizer="sgdm"))


# ---------------------------------------------------------------------------
# one rank of the world (this file run as a script)
# ---------------------------------------------------------------------------

def _rank_main(rank, world, port, out):
    import datetime

    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
    from repro_torch.core import psg
    from repro_torch.core.config import PSGConfig
    from repro_torch.distributed.sharding import activation_sharding
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((world, 1), ("data", "model"))
    res = {}
    with activation_sharding(mesh):
        res["ops"] = _op_results(rank, world)
        y, aux = _moe(world, rank)
        res["moe"] = (y, aux)
        try:
            _moe(world, rank, seq=512)
            res["moe_raises"] = ""
        except ValueError as e:
            res["moe_raises"] = str(e)
        # int8_gather: the forward equals the gathered-weight one
        rs = np.random.RandomState(2)
        x = torch.from_numpy(rs.normal(size=(6, 16)).astype(np.float32))
        w = torch.from_numpy(rs.normal(size=(16, 12)).astype(np.float32))
        xp = torch.from_numpy(rs.normal(size=(2, 6, 6, 4)).astype(np.float32))
        wc = torch.from_numpy(rs.normal(size=(36, 8)).astype(np.float32))
        outs = []
        for gather in (False, True):
            cfg = PSGConfig(enabled=True, int8_gather=gather)
            with psg.enable(cfg):
                outs.append((psg.matmul(x, w), psg.conv2d(xp, wc)))
        res["int8_gather"] = outs
    res["cnn"] = _cnn_results(_cnn_trainer(mesh, 2, _e2(True)))
    res["micro"] = _cnn_results(_cnn_trainer(mesh, 2, _e2(False), 2))
    # rank 0 writes the mesh's checkpoints; its failed save fails every rank
    import contextlib

    from repro_torch.ft import faults
    with tempfile.TemporaryDirectory() as ck:
        tr = _cnn_trainer(mesh, 1, _e2(False), checkpoint_dir=ck)
        with faults.failing_writer() if rank == 0 else \
                contextlib.nullcontext():
            tr.run(1)
        res["save_errors"] = sorted(tr.save_errors)
    # the LM from the JAX package's parameters, which the test saved
    from repro_torch.data import synthetic
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.training.train_step import train_state_for
    from repro_torch.training.trainer import Trainer
    import time
    exp = _lm_experiment()
    model = TransformerLM(exp.model, exp.e2)
    path, t0 = os.path.join(out, "lm.pt"), time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > TIMEOUT:
            raise TimeoutError("the JAX package's parameters did not come")
        time.sleep(0.1)
    model.load_state_dict(torch.load(path))
    tc = exp.train
    task = synthetic.MarkovLMTask(vocab=exp.model.vocab_size)
    tr = Trainer(exp, train_state_for(exp, model),
                 lambda step, shard: synthetic.make_lm_batch(
                     task, tc.seed, step, shard, tc.global_batch, tc.seq_len,
                     "cpu"), device="cpu", mesh=mesh)
    tr.run(LM_STEPS)
    res["lm"] = {"loss": [h["loss"] for h in tr.history],
                 "executed": tr.executed_steps, "dropped": tr.dropped_steps}
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _jax_lm_curve(out):
    """Save the JAX package's reduced-qwen parameters for the ranks and
    return the JAX package's single-device Trainer's losses and SMD
    counts."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from repro.configs import get_experiment as jget
    from repro.configs import reduce_experiment as jreduce
    from repro.core import config as jc
    from repro.data import synthetic as jsyn
    from repro.training.train_step import init_train_state as jinit
    from repro.training.trainer import Trainer as JTrainer
    from repro_torch.convert import lm_state_dict_from_jax
    jbase = jreduce(jget("qwen2_5_3b"))
    jexp = jbase.replace(
        e2=jc.E2TrainConfig(smd=jc.SMDConfig(enabled=True)),
        train=dataclasses.replace(jbase.train, optimizer="sgdm",
                                  total_steps=LM_STEPS))
    jstate = jax.jit(lambda key: jinit(key, jexp))(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, jstate.params)
    tmp = os.path.join(out, "lm.pt.tmp")
    torch.save(lm_state_dict_from_jax(params), tmp)
    os.replace(tmp, os.path.join(out, "lm.pt"))    # the ranks wait for it
    jstate = jstate._replace(params=jax.tree.map(jnp.asarray, params))
    tc = jexp.train
    task = jsyn.MarkovLMTask(vocab=jexp.model.vocab_size)
    tr = JTrainer(jexp, jstate, lambda step, shard: jsyn.make_lm_batch(
        task, tc.seed, step, shard, tc.global_batch, tc.seq_len))
    hist = tr.run(LM_STEPS)
    return ([float(h["loss"]) for h in hist], tr.executed_steps,
            tr.dropped_steps)


@pytest.fixture(scope="module")
def world():
    """The 2-rank world's results, the JAX curve beside them."""
    with tempfile.TemporaryDirectory() as out:
        port = _free_port()
        procs = [subprocess.Popen(      # the ranks run beside the JAX curve
            [sys.executable, __file__, str(r), "2", str(port), out],
            cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(2)]
        try:
            jax_curve = _jax_lm_curve(out)
        except BaseException:
            for p in procs:
                p.kill()
            _run_all(procs)
            raise
        for code, _, err in _run_all(procs):
            assert code == 0, err[-3000:]
        yield ([torch.load(os.path.join(out, f"rank{r}.pt"),
                           weights_only=False) for r in range(2)], jax_curve)


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))


def test_psg_signs_and_flags_equal_one_rank(world):
    ranks, _ = world
    ref = _op_results()
    for name, want in ref.items():
        if name == "attn":
            dq, dk, dv, ratio = want
            for r, res in enumerate(ranks):
                got = res["ops"]["attn"]
                for a, b in zip(got[:3], (dq, dk, dv)):
                    assert torch.equal(a, _rows(b, r, 2)), name
                assert torch.equal(got[3], ratio)
            continue
        for res in ranks:               # the global sign, on every rank
            assert _same(res["ops"][name], want), name


def test_slu_decisions_bn_statistics_and_first_update_equal_one_rank(world):
    ranks, _ = world
    one = _cnn_results(_cnn_trainer(None, 2, _e2(True)))
    r0, r1 = ranks[0]["cnn"], ranks[1]["cnn"]
    assert r0["flags"] == r1["flags"] == one["flags"]
    assert r0["fallback"] == r1["fallback"]
    np.testing.assert_allclose(r0["loss"], one["loss"], rtol=1e-5)
    np.testing.assert_allclose(r0["fallback"], one["fallback"], rtol=1e-6)
    for k, b in one["buffers"].items():
        assert torch.equal(r0["buffers"][k], r1["buffers"][k])
        np.testing.assert_allclose(r0["buffers"][k], b, rtol=1e-5, atol=1e-6)
    for k, p in one["params"].items():
        assert torch.equal(r0["params"][k], r1["params"][k]), k
        if k.endswith(".w"):            # the PSG convs' signSGD update
            assert torch.equal(r0["params"][k], p), k


def test_microbatches_follow_the_jax_row_order(world):
    ranks, _ = world
    one = _cnn_results(_cnn_trainer(None, 2, _e2(False), 2))
    got = ranks[0]["micro"]
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-5)
    for k, b in one["buffers"].items():
        np.testing.assert_allclose(got["buffers"][k], b, rtol=1e-5, atol=1e-6)


def test_moe_groups_and_aux_loss(world):
    ranks, _ = world
    y, aux = _moe()
    for r, res in enumerate(ranks):
        gy, gaux = res["moe"]
        np.testing.assert_allclose(gy, _rows(y, r, 2), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(gaux, aux, rtol=1e-6)
        assert "not whole routing groups of 1024" in res["moe_raises"]


def test_a_failed_save_on_rank_0_fails_every_rank(world):
    ranks, _ = world
    assert all(res["save_errors"] for res in ranks)


def test_int8_gather_forward_is_the_plain_forward(world):
    ranks, _ = world
    for res in ranks:
        plain, gathered = res["int8_gather"]
        assert _same(plain, gathered)


def test_psg_off_lm_curve_matches_the_jax_single_device_trainer(world):
    ranks, (want, executed, dropped) = world
    got = ranks[0]["lm"]
    assert (got["executed"], got["dropped"]) == (executed, dropped)
    assert executed >= 4
    np.testing.assert_allclose(got["loss"], want, rtol=2e-3)
    assert ranks[1]["lm"] == got


CLI = ("--depth", "8", "--width", "8", "--batch", "4", "--log-every", "0")


def _popen(args):
    return subprocess.Popen(_launcher(*CLI, *args), cwd=ROOT, env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def cli_worlds():
    """Three launcher worlds at once: a 2-rank mesh run (``--devices 2
    --mesh-data 2``), the same with a rank killed, and two ``--distributed``
    ranks without a mesh; their directories and (code, out, err)."""
    with tempfile.TemporaryDirectory() as d:
        dirs = {k: os.path.join(d, k) for k in ("mesh", "kill", "nomesh")}
        port = _free_port()
        procs = [
            _popen(("--ckpt", dirs["mesh"], "--devices", "2",
                    "--mesh-data", "2", "--steps", "4")),
            _popen(("--steps", "8", "--ckpt", dirs["kill"], "--devices",
                    "2", "--mesh-data", "2", "--ft-kill-at-step", "2"))] + [
            _popen(("--steps", "4", "--ckpt", dirs["nomesh"],
                    "--distributed", "--coordinator", f"localhost:{port}",
                    "--num-processes", "2", "--process-id", str(i)))
            for i in range(2)]
        yield dirs, _run_all(procs)


def test_cli_mesh_trains_and_resumes_on_the_mesh(cli_worlds):
    from repro_torch.ft.checkpoint import latest_intact_step
    dirs, runs = cli_worlds
    d = dirs["mesh"]
    code, so, se = runs[0]
    assert code == 0, se[-3000:]
    assert "rank 0 of 2 (gloo), mesh {'data': 2, 'model': 1}" in so
    (code, so, se), = _run_all([_popen(("--ckpt", d, "--devices", "2",
                                        "--mesh-data", "2", "--steps", "6",
                                        "--resume"))])
    assert code == 0, se[-3000:]
    assert "resumed from intact step 3 (counter at 4) on mesh " \
        "{'data': 2, 'model': 1}" in so
    assert latest_intact_step(d) == 5
    assert not os.path.exists(os.path.join(d, "proc000"))


def test_cli_killed_rank_ends_the_world_with_its_code(cli_worlds):
    from repro_torch.ft.faults import KILL_EXIT_CODE
    dirs, runs = cli_worlds
    code, _, se = runs[1]
    assert code == KILL_EXIT_CODE, se[-3000:]
    left = subprocess.run(["pgrep", "-f", dirs["kill"]], capture_output=True,
                          text=True)
    assert left.stdout.strip() == ""            # no rank left running


def test_cli_elastic_2_to_1_restart_through_the_supervisor():
    """Rank 1 of a 2-rank mesh is killed; the supervisor ends rank 0,
    shrinks the world to 1 and resumes from the last intact step, which
    ft/elastic.reshard_state places onto the 1-rank mesh."""
    from repro_torch.ft.checkpoint import latest_intact_step
    from repro_torch.ft.faults import KILL_EXIT_CODE
    from repro_torch.ft.supervisor import RestartPolicy, Supervisor
    steps = 10
    ports = {}
    with tempfile.TemporaryDirectory() as d:
        def make_cmd(world, rank, resume):
            port = ports.setdefault((world, resume), _free_port())
            cmd = _launcher("--depth", "8", "--width", "8", "--batch", "4",
                            "--steps", str(steps), "--e2train", "smd",
                            "--ckpt", d, "--ckpt-every", "1",
                            "--mesh-data", str(world), "--log-every", "0",
                            "--distributed", "--coordinator",
                            f"localhost:{port}", "--num-processes",
                            str(world), "--process-id", str(rank))
            if resume is not None:
                cmd.append("--resume")
            elif rank == 1:
                cmd += ["--ft-kill-at-step", "7"]
            return cmd

        sup = Supervisor(make_cmd, 2, d, RestartPolicy(max_restarts=1),
                         env=_env(), worker_timeout_s=TIMEOUT)
        attempts = sup.run()
        assert [a.world for a in attempts] == [2, 1]
        assert KILL_EXIT_CODE in attempts[0].exit_codes
        assert attempts[-1].outcome == "ok"
        assert latest_intact_step(d) == steps - 1


def test_cli_distributed_ranks_without_a_mesh_keep_their_own_streams(
        cli_worlds):
    from repro_torch.ft.checkpoint import latest_intact_step
    steps = 4
    dirs, runs = cli_worlds
    for code, so, se in runs[2:]:
        assert code == 0, se[-3000:]
        assert "no mesh" in so
    d0, d1 = (os.path.join(dirs["nomesh"], f"proc{i:03d}") for i in range(2))
    assert latest_intact_step(d0) == latest_intact_step(d1) == steps - 1
    a = np.load(os.path.join(d0, f"step_{steps - 1:08d}.npz"))
    b = np.load(os.path.join(d1, f"step_{steps - 1:08d}.npz"))
    assert any(not np.array_equal(a[k], b[k]) for k in a.files)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
               sys.argv[4])
