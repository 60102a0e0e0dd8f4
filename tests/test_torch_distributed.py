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
  global aux loss; ``int8_gather``'s codes of a shard along either
  dimension bit for bit ``codes(w)``, and its forward and gradient those
  of the whole weight;
* a reduced qwen2.5-3b (3 layers: with 2 the first and last blocks, which
  always run, leave SLU nothing to decide) with PSG, SLU, SMD,
  ``remat="block"`` and ``int8_gather`` on sharded parameters
  (``distributed/fsdp.py``): each rank's state between steps exactly the
  reckoned shard bytes (by storage), the gathers' whole bytes alive at
  once within two units', only int8 codes on the wire for the PSG weights,
  a forced skip gathering nothing, the first step's SLU decisions and
  every matmul's PSG signs and flags (replayed on one rank on the ranks'
  rows) bit for bit, the losses within rtol 2e-3 of one rank's run; its
  checkpoint the full logical arrays, a resume on the two ranks bit for
  bit the uninterrupted run, and the elastic 2 -> 1 load the same
  parameters;
* a PSG-off ``sgdm`` LM with SMD, on sharded parameters: its loss curve
  within the JAX package's own mesh tolerance (rtol 2e-3,
  ``tests/test_loop.py``) of the JAX package's single-device ``Trainer``,
  with equal SMD counts.

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


ZERO3_STEPS = 4         # nominal steps of the sharded LM (SMD drops some)
ZERO3_RESUME = 1        # the nominal step its resume restarts after


def _zero3_experiment():
    import dataclasses
    from repro_torch.launch import train as tl
    e2 = tl.E2TRAIN["full"]
    e2 = dataclasses.replace(e2, psg=dataclasses.replace(e2.psg,
                                                         int8_gather=True))
    exp = tl.lm_experiment("qwen2_5_3b", num_layers=3, steps=ZERO3_STEPS,
                           smoke=True, e2=e2, fused_attention=False)
    return exp


def _zero3_trainer(mesh, microbatches=1, **kw):
    import dataclasses
    from repro_torch.data import synthetic
    from repro_torch.training.train_step import init_train_state
    from repro_torch.training.trainer import Trainer
    exp = _zero3_experiment()
    if microbatches > 1:
        exp = exp.replace(train=dataclasses.replace(
            exp.train, microbatches=microbatches,
            global_batch=exp.train.global_batch * microbatches))
    tc = exp.train
    task = synthetic.MarkovLMTask(vocab=exp.model.vocab_size)
    return Trainer(exp, init_train_state(exp, seed=0, device="cpu"),
                   lambda step, shard: synthetic.make_lm_batch(
                       task, tc.seed, step, shard, tc.global_batch,
                       tc.seq_len, "cpu"), device="cpu", mesh=mesh, **kw)


def _state_bytes(state):
    """Bytes of the storages a state's tensors hold, each storage once."""
    ts = list(state.model.parameters()) + [
        t for d in (state.opt, state.swa or {}) for v in d.values()
        if isinstance(v, dict) for t in v.values()]
    return sum({t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in ts}.values())


def _zero3_micro_rank(mesh):
    """The sharded LM in two microbatches, and the same with every
    parameter replicated (``fsdp=False``: whole gradients summed after the
    backward): their losses."""
    from repro_torch.distributed.fsdp import DataParallel
    from repro_torch.ft.elastic import reshard_state
    sharded = _zero3_trainer(mesh, microbatches=2)
    sharded.run(ZERO3_STEPS)
    rep = _zero3_trainer(None, microbatches=2)
    rep.mesh = mesh                     # Trainer(mesh=)'s placement
    rep.state = reshard_state(rep.state, mesh, fsdp=False)
    rep.dp = DataParallel(mesh, rep.state.model, fsdp=False)
    rep.rank, rep.world = rep.dp.rank, rep.dp.world
    rep.run(ZERO3_STEPS)
    return [[h["loss"] for h in t.history] for t in (sharded, rep)]


def _psg_recorder():
    """Wrap the PSG matmul weight-gradient op of the dispatch layer and
    kernel 6's plain version so that, while ``rec["on"]``, each call keeps
    its rows of x and gy, its sign and its fallback flags."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import psg_matmul as PM
    rec = {"on": False, "calls": []}
    op, select = dispatch.psg_grad_w, PM.psg_grad_w_plain

    def flags(*a, **kw):
        sign, stats = select(*a, **kw)
        rec["flags"] = stats
        return sign, stats

    def recorded(x2, gy, cfg):
        sign, fb = op(x2, gy, cfg)
        if rec["on"]:
            rec["calls"].append({"x": x2.detach().clone(),
                                 "g": gy.detach().clone(), "sign": sign,
                                 "flags": rec["flags"]})
        return sign, fb

    dispatch.psg_grad_w, PM.psg_grad_w_plain = recorded, flags
    return rec


def _zero3_rank(mesh, rank, out):
    """The sharded LM on this rank (module doc); the resume and the
    checkpoint's directory ``out/zero3``."""
    from repro_torch.distributed import fsdp
    from repro_torch.ft.checkpoint import restore_checkpoint
    from repro_torch.ft.elastic import reshard_state
    ck = os.path.join(out, "zero3")
    tr = _zero3_trainer(mesh, checkpoint_dir=ck, checkpoint_every=1)
    rec = _psg_recorder()
    res = {"dims": tr.dp.dims, "bytes": [_state_bytes(tr.state)]}
    fsdp.STATS.reset()
    fsdp.STATS.log = []
    res["live_before"] = fsdp.STATS.live    # codes this rank's tests hold
    for step in range(ZERO3_STEPS):
        rec["on"] = not tr.history
        tr.run(1)
        rec["on"] = False
        res["bytes"].append(_state_bytes(tr.state))
    res.update(peak=fsdp.STATS.peak, live=fsdp.STATS.live,
               wire=dict(fsdp.STATS.wire), log=list(fsdp.STATS.log),
               loss=[h["loss"] for h in tr.history],
               flags=[h["slu_executed"] for h in tr.history],
               psg=rec["calls"])
    full = tr.full_state()
    res["full"] = {k: p.detach().clone()
                   for k, p in full.model.named_parameters()}
    # held-out accuracy on the sharded SWA weights, gathered as the forward
    # gathers, and on the gathered full state's
    from repro_torch.tasks import get_task
    from repro_torch.training import evaluate
    from repro_torch.training.train_step import eval_params
    logits = lambda m: get_task("lm").make_predict(tr.exp)(
        m, evaluate.heldout_batch(tr.exp, 0, "cpu"))
    res["eval"] = (evaluate.evaluate(tr),
                   evaluate.accuracy(tr.exp, eval_params(full, tr.exp),
                                     "cpu"),
                   logits(eval_params(tr.state, tr.exp)),
                   logits(eval_params(full, tr.exp)))
    # the resume: a fresh trainer restores the checkpoint of ZERO3_RESUME
    # into its full state, places it on the mesh and runs to the end
    again = _zero3_trainer(mesh)
    full = again.full_state()
    _, at = restore_checkpoint(ck, full, step=ZERO3_RESUME)
    again.state = reshard_state(full, mesh)
    again.run(ZERO3_STEPS - at - 1)
    res["resumed"] = {k: p.detach().clone() for k, p in
                      again.full_state().model.named_parameters()}
    res["resumed_at"] = at
    res["ckpt"] = ck
    # a forced skip: layer 1's MLP, gated, draws 1.0 (kept iff u < p)
    from repro_torch.core import psg
    from repro_torch.distributed.sharding import activation_sharding
    model = tr.state.model
    u = torch.zeros(2 * model.cfg.num_layers)
    u[3] = 1.0
    fsdp.STATS.reset()
    fsdp.STATS.log = []
    tokens = torch.arange(16).reshape(1, 16) + 8 * rank
    with activation_sharding(mesh), psg.enable(tr.exp.e2.psg):
        logits, aux = model(tokens, slu_u=u)
        names = [k for k, _ in model.named_parameters()]
        grads = torch.autograd.grad(logits.float().square().mean(),
                                    list(model.parameters()),
                                    allow_unused=True)
    res["skip"] = {"log": list(fsdp.STATS.log),
                   "executed": aux["slu_executed"].reshape(-1).tolist(),
                   "zero": [k for k, g in zip(names, grads)
                            if g is None or not g.any()]}
    fsdp.STATS.log = None
    return res


# every block kind on sharded parameters: (arch, tokens a row; the MoE's
# rows must hold whole routing groups of 1,024)
BLOCK_ARCHS = (("deepseek_moe_16b", 1024), ("zamba2_1_2b", 32),
               ("xlstm_350m", 16), ("whisper_small", 16),
               ("phi_3_vision_4_2b", 16))


def _block_kinds_rank(mesh, rank):
    """Each reduced arch's loss and gradients on this rank's row, with PSG,
    SLU and ``int8_gather``, from the same parameters sharded and whole:
    the losses, and the sharded leaves whose gradient (summed over the
    ranks, this rank's shard) differs from the whole model's."""
    import torch.distributed as dist
    from repro_torch.configs import get_experiment, reduce_experiment
    from repro_torch.core import psg, rng
    from repro_torch.core.config import E2TrainConfig, PSGConfig, SLUConfig
    from repro_torch.data import synthetic
    from repro_torch.distributed.fsdp import DataParallel
    from repro_torch.distributed.sharding import (activation_sharding,
                                                  rank_rows)
    from repro_torch.models.transformer import TransformerLM, lm_loss
    from repro_torch.training.train_step import TrainState
    e2 = E2TrainConfig(slu=SLUConfig(enabled=True),
                       psg=PSGConfig(enabled=True, int8_gather=True))
    out = {}
    for arch, seq in BLOCK_ARCHS:
        cfg = reduce_experiment(get_experiment(arch)).model
        sharded, whole = (TransformerLM(cfg, e2, seed=0) for _ in range(2))
        dp = DataParallel(mesh, sharded)
        dp.place(TrainState(sharded, {}, None))
        task = synthetic.MarkovLMTask(vocab=cfg.vocab_size)
        batch = rank_rows(synthetic.with_frontend(synthetic.make_lm_batch(
            task, 0, 0, 0, 2, seq, "cpu"), cfg, 0, device="cpu"), rank, 2, 1)
        runs = []
        for m in (sharded, whole):
            names, ps = zip(*m.named_parameters())
            with activation_sharding(mesh), psg.enable(e2.psg):
                loss, _ = lm_loss(m, batch, rng.PRNGKey(0))
                gs = torch.autograd.grad(loss / 2, ps, allow_unused=True)
            runs.append((float(loss), {k: torch.zeros_like(p) if g is None
                                       else g for k, p, g in
                                       zip(names, ps, gs)}))
        (ls, gs), (lw, gw) = runs
        differ = []
        for k, g in gw.items():
            dist.all_reduce(g)
            if dp.dims[k] is None:
                dist.all_reduce(gs[k])
            if not torch.equal(gs[k], dp.shard(k, g)):
                differ.append(k)
        out[arch] = {"loss": (ls, lw), "differ": differ,
                     "sharded": len(dp.sharded())}
    return out


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
        # int8_gather on this rank's shards: the codes, the forward and the
        # gradient those of the whole weight
        from repro_torch.core.quant import codes
        from repro_torch.distributed import fsdp
        plc = fsdp.Placement(mesh.get_group("data"))
        rs = np.random.RandomState(2)
        x = torch.from_numpy(rs.normal(size=(6, 16)).astype(np.float32))
        w = torch.from_numpy(rs.normal(size=(16, 12)).astype(np.float32))
        xp = torch.from_numpy(rs.normal(size=(2, 6, 6, 4)).astype(np.float32))
        wc = torch.from_numpy(rs.normal(size=(36, 8)).astype(np.float32))
        shard = lambda t, d: fsdp.mark_shard(
            plc.narrow(t, d).clone().requires_grad_(), d, plc)
        outs = {}
        for name, wm, wcv in (("whole", w.clone().requires_grad_(),
                               wc.clone().requires_grad_()),
                              ("dim0", shard(w, 0), shard(wc, 0)),
                              ("dim1", shard(w, 1), shard(wc, 1))):
            with psg.enable(PSGConfig(enabled=True,
                                      int8_gather=name != "whole")):
                y, yc = psg.matmul(x, wm), psg.conv2d(xp, wcv)
                g, gc = torch.autograd.grad(y.sum() + yc.sum(), [wm, wcv])
            outs[name] = (y.detach(), yc.detach(), g, gc)
        res["int8_gather"] = {
            "outs": outs, "codes": [
                (fsdp.int8_gather(plc.narrow(t, d), d, plc, 8),
                 codes(t, 8)) for t in (w, wc) for d in (0, 1)]}
    res["zero3"] = _zero3_rank(mesh, rank, out)
    res["block_kinds"] = _block_kinds_rank(mesh, rank)
    res["zero3_micro"] = _zero3_micro_rank(mesh)
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
    from repro_torch.distributed import fsdp
    fsdp.STATS.reset()
    live = fsdp.STATS.live
    tr.run(LM_STEPS)
    res["lm"] = {"loss": [h["loss"] for h in tr.history],
                 "executed": tr.executed_steps, "dropped": tr.dropped_steps,
                 "whole_peak": fsdp.STATS.peak - live,
                 "whole_left": fsdp.STATS.live - live}
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
    for r, res in enumerate(ranks):
        got = res["int8_gather"]
        for gathered, want in got["codes"]:
            assert _same(gathered, want)
        y, yc, g, gc = got["outs"]["whole"]
        for d in (0, 1):
            ys, ycs, gs, gcs = got["outs"][f"dim{d}"]
            assert _same((ys, ycs), (y, yc))
            # the data axis's sum of the global sign, on this rank's shard
            for a, b in ((gs, g), (gcs, gc)):
                assert torch.equal(a, 2 * _rows(b.transpose(0, d), r, 2)
                                   .transpose(0, d))


def test_psg_off_lm_curve_matches_the_jax_single_device_trainer(world):
    ranks, (want, executed, dropped) = world
    got = ranks[0]["lm"]
    assert (got["executed"], got["dropped"]) == (executed, dropped)
    assert executed >= 4
    np.testing.assert_allclose(got["loss"], want, rtol=2e-3)
    assert ranks[1]["lm"] == got
    # on sharded parameters, gathered in fp32 a sub-block at a time: at
    # most one unit's whole bytes, or the tied embedding's, alive at once
    from repro_torch.models.transformer import TransformerLM
    exp = _lm_experiment()
    named = dict(TransformerLM(exp.model, exp.e2,
                               device="meta").named_parameters())
    unit = _whole_bytes({k: p for k, p in named.items()
                         if k.startswith("layers.0.") and p.ndim > 1},
                        "layers.0.")
    assert 0 < got["whole_peak"] <= max(unit, _whole_bytes(named, "embed"))
    assert got["whole_left"] == 0


@pytest.fixture(scope="module")
def zero3_one():
    """The sharded LM's experiment on one rank, no mesh: its trainer after
    the run, and the full state's bytes, each FSDP leaf's (by the rules on
    two ranks) over 2."""
    from repro_torch.distributed import sharding
    tr = _zero3_trainer(None)
    st = tr.state
    named = dict(st.model.named_parameters())
    mesh = sharding.AbstractMesh((2, 1), ("data", "model"))
    dims = {k: sharding.shard_dim(s) for k, s in sharding.param_specs(
        named, mesh, True, st.model.unit).items()}
    ts = list(named.items()) + [(n, t) for d in (st.opt, st.swa or {})
                                for v in d.values() if isinstance(v, dict)
                                for n, t in v.items()]
    reckoned = sum(t.numel() * t.element_size()
                   // (1 if dims[n] is None else 2) for n, t in ts)
    tr.run(ZERO3_STEPS)
    return tr, dims, reckoned


def _whole_bytes(named, prefix):
    return sum(p.numel() * p.element_size() for k, p in named.items()
               if k.startswith(prefix))


def test_zero3_state_between_steps_is_the_reckoned_shards(world,
                                                         zero3_one):
    ranks, _ = world
    _, dims, reckoned = zero3_one
    for res in ranks:
        z = res["zero3"]
        assert z["dims"] == dims            # also from the placed model
        assert z["bytes"] == [reckoned] * (ZERO3_STEPS + 1)
    assert any(d is not None for d in dims.values())


def test_zero3_gathers_keep_two_units_whole_and_send_int8_codes(world,
                                                                zero3_one):
    ranks, _ = world
    tr, dims, _ = zero3_one
    named = dict(tr.state.model.named_parameters())
    sharded = {k: p for k, p in named.items() if dims[k] is not None}
    unit = _whole_bytes(sharded, "layers.0.")
    embed = _whole_bytes(sharded, "embed")
    for res in ranks:
        z = res["zero3"]
        assert z["live"] == z["live_before"]    # nothing whole after
        # within two units' whole bytes; each sub-block's codes freed
        # before the next gathers, the tied embedding's whole alone
        codes = sum(named[k].numel() for k in sharded
                    if k.startswith("layers.0."))
        assert 0 < z["peak"] - z["live_before"] <= min(2 * unit,
                                                       embed + codes)
        log = [n for names in z["log"] for n in names]
        marked = [n[len("int8:"):] for n in log if n.startswith("int8:")]
        # the tied embedding and head, gathered in fp32 at each use; every
        # PSG weight's codes gathered once a pass, half of them received
        assert {n for n in log if not n.startswith("int8:")} == {"embed"}
        assert z["wire"] == {
            "float32": log.count("embed") * embed // 2,
            "int8": sum(named[n].numel() for n in marked) // 2}


def test_zero3_forced_skip_gathers_nothing(world):
    ranks, _ = world
    for res in ranks:
        z = res["zero3"]["skip"]
        assert z["executed"] == [1, 1, 1, 0, 1, 1]
        log = {n for names in z["log"] for n in names}
        assert not any(n.startswith("int8:layers.1.mlp.") for n in log)
        assert "int8:layers.1.attn.wq" in log
        assert {f"layers.1.mlp.{w}" for w in ("w_up", "w_gate", "w_down")} \
            <= set(z["zero"])
        assert not any(n.startswith("layers.1.attn.") for n in z["zero"])


def test_zero3_slu_decisions_and_psg_signs_equal_one_rank(world,
                                                        zero3_one):
    from repro_torch.kernels import ops
    from repro_torch.kernels import psg_matmul as PM
    ranks, _ = world
    tr, _, _ = zero3_one
    a, b = (res["zero3"] for res in ranks)
    assert a["flags"][0] == b["flags"][0] == tr.history[0]["slu_executed"]
    cfg = tr.exp.e2.psg
    assert len(a["psg"]) == len(b["psg"]) > 0
    for ca, cb in zip(a["psg"], b["psg"]):
        assert _same((ca["sign"], ca["flags"]), (cb["sign"], cb["flags"]))
        x = torch.cat([ca["x"], cb["x"]]).float()
        g = torch.cat([ca["g"], cb["g"]]).float()
        xm, gm, xq, gq = ops._wgrad_codes(x, g, cfg)
        pred = PM.predictor_matmul_plain(xm, gm)
        sign, flags = PM.psg_grad_w_plain(pred, xq, gq,
                                          cfg.beta * pred.float().abs().amax())
        assert torch.equal(sign.float(), ca["sign"])
        assert torch.equal(flags, ca["flags"])


def test_zero3_losses_within_the_lm_tolerance_of_one_rank(world, zero3_one):
    ranks, _ = world
    tr, _, _ = zero3_one
    a, b = (res["zero3"] for res in ranks)
    assert a["loss"] == b["loss"] and len(a["loss"]) >= 2
    np.testing.assert_allclose(a["loss"], [h["loss"] for h in tr.history],
                               rtol=2e-3)


def test_zero3_evaluation_gathers_as_the_forward(world):
    ranks, _ = world
    for res in ranks:
        acc, full_acc, logits, full_logits = res["zero3"]["eval"]
        assert acc == full_acc
        assert torch.equal(logits, full_logits)


@pytest.mark.parametrize("arch", [a for a, _ in BLOCK_ARCHS])
def test_zero3_every_block_kind_equals_the_whole_model(world, arch):
    """MoE experts, Mamba2, mLSTM/sLSTM, zamba2's shared attention, the
    encoder and cross-attention, the VLM: gathered per sub-block (int8
    codes for the PSG weights), the loss and every summed gradient are the
    whole model's, bit for bit."""
    ranks, _ = world
    for res in ranks:
        got = res["block_kinds"][arch]
        assert got["sharded"] > 0
        assert got["loss"][0] == got["loss"][1]
        assert got["differ"] == []


def test_zero3_microbatches_accumulate_shards_as_the_replicated_run(world):
    """Two microbatches: each microbatch's gradients summed over the ranks
    and accumulated as shards, against whole gradients accumulated, then
    summed; the sums' order differs, the losses do not (rtol 1e-6)."""
    ranks, _ = world
    for res in ranks:
        sharded, replicated = res["zero3_micro"]
        assert len(sharded) >= 2
        np.testing.assert_allclose(sharded, replicated, rtol=1e-6)
    assert ranks[0]["zero3_micro"] == ranks[1]["zero3_micro"]


def test_zero3_checkpoint_resume_and_elastic_load(world):
    from repro_torch.distributed.sharding import AbstractMesh
    from repro_torch.ft.checkpoint import restore_checkpoint
    from repro_torch.ft.elastic import reshard_state
    from repro_torch.training.train_step import init_train_state
    ranks, _ = world
    for res in ranks:
        z = res["zero3"]
        assert _same(list(z["resumed"].values()), list(z["full"].values()))
    z = ranks[0]["zero3"]
    assert z["resumed_at"] <= ZERO3_RESUME
    # the 2 -> 1 load of the last checkpoint: the full logical arrays
    state = init_train_state(_zero3_experiment(), seed=1, device="cpu")
    _, step = restore_checkpoint(z["ckpt"], state)
    state = reshard_state(state, AbstractMesh((1, 1), ("data", "model")))
    assert step == ZERO3_STEPS - 1
    got = dict(state.model.named_parameters())
    assert got.keys() == z["full"].keys()
    for k, p in z["full"].items():
        assert torch.equal(got[k].detach(), p), k
    assert _same(list(ranks[1]["zero3"]["full"].values()),
                 list(z["full"].values()))


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
