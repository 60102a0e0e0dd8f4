"""The models' partitioned forms on ``DTensor``s against the plain path, in
a real 4-rank gloo world on the CPU over a ``(2, 2)`` ``("data",
"model")`` mesh.

The dry run (``launch/dryrun.py``) prices the programs that run under
``sharding.activation_sharding(mesh, spmd=True)``: the sharded loss head
(``sharding.take_last``, ``logsumexp`` with its own backward, ``embed``),
tensor-parallel attention and MLP (partial sums over heads and ``d_ff``),
the MoE's per-shard dispatch and its expert-parallel or tensor-parallel
expert split, the SSM mixers per batch shard, and decode's per-shard
cache write and split softmax.  Here the same programs run on real
values: one world of four ranks (this file run as a script, one process
a rank, one thread each, no JAX imported) runs every case and rank 0
saves, for each, the plain path's values and the ``DTensor`` path's
gathered whole (``full_tensor()``).  Each case is one test:

* a train step's loss and every parameter's gradient (the trainer's task
  loss, then ``torch.autograd.grad``) of reduced (``reduce_experiment``,
  fp32) qwen2.5-3b, deepseek-moe-16b with 4 experts (expert-parallel over
  the model axis) and with 3 (tensor-parallel over ``d_ff``), both at 4 x
  512 tokens so that the two routing groups shard over the data axis,
  zamba2-1.2b (18 Mamba2 blocks and the shared attention) and
  whisper-small (encoder, cross-attention, frontend);
* one decode step's logits and every updated state leaf of qwen2.5-3b
  with its 2 kv heads sharded over the model axis and with 1 kv head (the
  cache's slots sharded, so the new key lands in one rank's shard, and
  the softmax split over the shards), and of zamba2-1.2b (Mamba2 states
  and the shared attention's cache), on random caches whose rows sit at
  positions past the ring's end and before it.

Each tensor is held at ``max |spmd - plain| <= REL * max |plain|``, with
the materialized softmax's probabilities kept in fp32 in both paths
(``layers.PROBS_DTYPE``; bf16, the JAX package's rounding, moves a
probability by a bf16 step wherever an fp32 reordering crosses a rounding
boundary, which every one of these programs does somewhere).  The
parameters, the batches and the caches are placed by the dry run's rules
(``sharding.param_shardings``, ``batch_sharding``,
``decode_state_shardings``).
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
WORLD, MESH = 4, (2, 2)
TIMEOUT = 240           # seconds the world may take
GROUP_TIMEOUT = 60      # seconds a collective may wait
# of max |plain| a tensor: fp32 rounding, which a reordered sum moves; the
# plain path's own fp32 values sit up to 6.6e-6 of max from a float64 run
# of the same inputs (zamba2's decode, the 16th block's Mamba2 state)
REL = 2e-5

TRAIN = {"qwen": ("qwen2_5_3b", {}, (2, 16)),
         "moe_ep": ("deepseek_moe_16b", {}, (4, 512)),
         "moe_tp": ("deepseek_moe_16b", {"num_experts": 3}, (4, 512)),
         "zamba2": ("zamba2_1_2b", {}, (2, 16)),
         "whisper": ("whisper_small", {}, (2, 16))}
# arch, model changes, the KV cache's dimension the model axis shards
DECODE = {"qwen_heads": ("qwen2_5_3b", {}, 2),
          "qwen_slots": ("qwen2_5_3b", {"num_kv_heads": 1}, 1),
          "zamba2": ("zamba2_1_2b", {}, 2)}
CASES = [f"train_{n}" for n in TRAIN] + [f"decode_{n}" for n in DECODE]


def _experiment(arch, model_kw, rows_seq=None):
    import dataclasses

    from repro_torch.configs import get_experiment, reduce_experiment
    exp = reduce_experiment(get_experiment(arch))
    exp = exp.replace(model=dataclasses.replace(exp.model, **model_kw))
    if rows_seq is not None:
        exp = exp.replace(train=dataclasses.replace(
            exp.train, global_batch=rows_seq[0], seq_len=rows_seq[1]))
    return exp


# ---------------------------------------------------------------------------
# one rank of the world (this file run as a script)
# ---------------------------------------------------------------------------

def _dist(t, mesh, pl):
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t.detach().clone(), mesh, pl)


def _place_model(model, mesh, fsdp):
    """The model's parameters as ``DTensor``s by the rule table, its
    buffers replicated."""
    from torch import nn
    from torch.distributed.tensor import Replicate

    from repro_torch.distributed import sharding as shd
    pl = shd.param_shardings(model, mesh, fsdp)
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        setattr(mod, leaf, nn.Parameter(_dist(p, mesh, pl[name]),
                                        requires_grad=p.requires_grad))
    for name, b in list(model.named_buffers()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        mod._buffers[leaf] = _dist(b, mesh, [Replicate()] * mesh.ndim)
    return model


def _place_batch(batch, mesh):
    from repro_torch.distributed import sharding as shd
    specs = shd.batch_sharding(mesh, batch)
    return {k: _dist(v, mesh, shd.placements(specs[k], mesh))
            for k, v in batch.items()}


def _place_tree(tree, specs, mesh):
    from repro_torch.distributed import sharding as shd
    if isinstance(tree, dict):
        return {k: _place_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_place_tree(v, s, mesh)
                          for v, s in zip(tree, specs))
    return _dist(tree, mesh, shd.placements(specs, mesh))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _leaves(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _leaves(v, f"{prefix}{i}/").items()}
    return {prefix.rstrip("/"): tree}


def _whole(t):
    from torch.distributed.tensor import DTensor
    t = t.full_tensor() if isinstance(t, DTensor) else t
    return t.detach().double().numpy()


def _spmd(mesh):
    import contextlib

    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.dryrun import SpmdViews
    stack = contextlib.ExitStack()
    stack.enter_context(shd.activation_sharding(mesh, spmd=True))
    stack.enter_context(implicit_replication())
    stack.enter_context(SpmdViews().mode())
    return stack


def _train_case(mesh, arch, model_kw, rows_seq):
    """The task loss and every parameter's gradient, plain and on
    ``DTensor``s."""
    import contextlib
    import copy

    from repro_torch.data import synthetic
    from repro_torch.training.train_step import (TrainStep,
                                                 init_train_state)
    exp = _experiment(arch, model_kw, rows_seq)
    tc, cfg = exp.train, exp.model
    step = TrainStep(exp)
    key = step.step_key(0)
    batch = synthetic.make_lm_batch(
        synthetic.MarkovLMTask(vocab=cfg.vocab_size), tc.seed, 0, 0,
        tc.global_batch, tc.seq_len, "cpu")
    batch = synthetic.with_frontend(batch, cfg, 0)
    model = init_train_state(exp, device="cpu").model
    placed = _place_model(copy.deepcopy(model), mesh, exp.mesh.fsdp)
    out = {}
    for name, m, b in (("plain", model, batch),
                       ("spmd", placed, _place_batch(batch, mesh))):
        names, params = zip(*m.named_parameters())
        with _spmd(mesh) if name == "spmd" else contextlib.nullcontext():
            loss, _ = step.task_loss(m, b, key, None, slu_u=None)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        out[f"loss/{name}"] = _whole(loss)
        for n, p, g in zip(names, params, grads):
            out[f"grad.{n}/{name}"] = _whole(torch.zeros_like(p)
                                             if g is None else g)
    return out


def _decode_case(mesh, arch, model_kw, kv_dim):
    """One decode step's logits and updated state, plain and on
    ``DTensor``s, from random caches at positions past and before the
    ring's end."""
    import copy

    from repro_torch.distributed import sharding as shd
    from repro_torch.models import transformer as T
    from repro_torch.training.train_step import init_train_state
    exp = _experiment(arch, model_kw)
    cfg, sv = exp.model, exp.serve
    model = init_train_state(exp, device="cpu").model.eval()
    state = T.init_decode_state(cfg, sv.batch, sv.max_kv_len,
                                dtype=torch.float32)
    gen = torch.Generator().manual_seed(1)
    for t in _leaves(state["layers"]).values():
        t.copy_(torch.randn(t.shape, generator=gen) * 0.5)
    T_len = sv.max_kv_len
    state["pos"].copy_(torch.tensor([T_len + 5, T_len // 2 + 4][:sv.batch],
                                    dtype=torch.int32))
    token = torch.tensor([[5], [7]][:sv.batch])
    specs = shd.decode_state_shardings(state, mesh)
    placed_state = _place_tree(copy.deepcopy(state), specs, mesh)
    caches = [st["kv"][0] for st in placed_state["layers"] if "kv" in st]
    assert {shd.sharded_by(c, "model") for c in caches} == {kv_dim}
    placed = _place_model(copy.deepcopy(model), mesh, exp.mesh.fsdp)
    tok = _place_batch({"t": token}, mesh)["t"]
    out = {}
    with torch.no_grad():
        logits, new = T.decode_step(model, token, state)
        out["logits/plain"] = _whole(logits)
        out.update({f"state.{k}/plain": _whole(v)
                    for k, v in _leaves(new).items()})
        with _spmd(mesh):
            logits, new = T.decode_step(placed, tok, placed_state)
        out["logits/spmd"] = _whole(logits)
        out.update({f"state.{k}/spmd": _whole(v)
                    for k, v in _leaves(new).items()})
    return out


def _rank_main(rank, port, out):
    import datetime

    import torch.distributed as dist

    from repro_torch.models import layers
    torch.set_num_threads(1)
    layers.PROBS_DTYPE = torch.float32      # the module doc
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=WORLD, rank=rank,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(MESH, ("data", "model"))
    res = {}
    for name, (arch, kw, rs) in TRAIN.items():
        res.update({f"train_{name}/{k}": v for k, v in
                    _train_case(mesh, arch, kw, rs).items()})
    for name, (arch, kw, kv_dim) in DECODE.items():
        res.update({f"decode_{name}/{k}": v for k, v in
                    _decode_case(mesh, arch, kw, kv_dim).items()})
    if rank == 0:
        np.savez(os.path.join(out, "spmd.npz"), **res)
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world():
    from repro_torch.ft.supervisor import free_tcp_port
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    port = free_tcp_port()
    with tempfile.TemporaryDirectory() as out:
        procs = [subprocess.Popen(
            [sys.executable, __file__, str(r), str(port), out], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(WORLD)]
        res = []
        try:
            for p in procs:
                so, se = p.communicate(timeout=TIMEOUT)
                res.append((p.returncode, se))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (code, se) in enumerate(res):
            assert code == 0, f"rank {r} exited {code}: {se[-4000:]}"
        with np.load(os.path.join(out, "spmd.npz")) as f:
            return dict(f)


@pytest.mark.parametrize("case", CASES)
def test_spmd_path_equals_the_plain_path(world, case):
    keys = sorted(k[len(case) + 1:-len("/plain")] for k in world
                  if k.startswith(case + "/") and k.endswith("/plain"))
    assert keys, f"no values for {case}"
    if case.startswith("train"):
        assert "loss" in keys and any(k.startswith("grad.") for k in keys)
    else:
        assert "logits" in keys and any(k.startswith("state.") for k in keys)
    bad = {}
    for k in keys:
        plain, spmd = world[f"{case}/{k}/plain"], world[f"{case}/{k}/spmd"]
        assert plain.shape == spmd.shape, (k, plain.shape, spmd.shape)
        assert np.isfinite(plain).all(), k
        err = np.abs(spmd - plain).max() if plain.size else 0.0
        scale = np.abs(plain).max() if plain.size else 0.0
        if err > REL * max(scale, 1e-30):
            bad[k] = (float(err), float(scale))
    assert not bad, f"{len(bad)} of {len(keys)} tensors differ: {bad}"


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
