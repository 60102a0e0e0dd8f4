"""``launch/specs`` and ``launch/dryrun`` against the JAX package's.

* ``input_specs``: every leaf of every admitted (arch x shape) cell at full
  size, on the ``meta`` device, with the JAX package's ``jax.eval_shape``
  keys (port names through ``convert.jax_path``), shapes and dtypes;
* ``analyze_cell`` on a reduced arch (``reduce_experiment``) at the
  production meshes, over a world of fake ranks, at a cut shape cell
  (fewer rows and tokens, the kind the same): a ``2x16x16`` cell is
  ``ok`` over 512 ranks, a skipped cell carries the JAX
  package's reason, a forced exception gives ``error`` and ``main`` exits
  1, and the arguments' local bytes are those reckoned from the JAX
  package's specs and sharding rules (rank 0's shard of each dimension
  ``ceil(dim / n)``).  The cells the dry run must pass are in
  ``test_torch_dryrun_cells.py``.
"""
import dataclasses
import functools
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from repro.configs import get_experiment as jax_experiment  # noqa: E402
from repro.core import config as jconfig  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro_torch.configs import (ARCH_IDS, get_experiment,  # noqa: E402
                                 reduce_experiment)
from repro_torch.convert import jax_path  # noqa: E402
from repro_torch.core import config as tconfig  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402

CELLS = [(a, s) for a in ARCH_IDS for s in tconfig.SHAPES
         if tconfig.shape_applicable(get_experiment(a).model, s)[0]]
# the cut shape cells of the analyze_cell tests (each kind as the real one)
CUT = {"train_4k": dict(kind="train", seq_len=256, global_batch=32),
       "prefill_32k": dict(kind="prefill", seq_len=512, global_batch=32),
       "decode_32k": dict(kind="decode", seq_len=512, global_batch=32)}


def _dtype(d) -> str:
    return str(d).removeprefix("torch.")


def _jax_leaves(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        if leaf is None:
            continue
        out[tuple(jshd._path_str([k]) for k in path)] = (
            tuple(leaf.shape), str(np.dtype(leaf.dtype)))
    return out


def _named(named, unit, prefix):
    """Port names -> the JAX tree's leaves (a stacked per-layer leaf gets
    its layer count in front)."""
    groups = {}
    for name, t in named.items():
        path, i = jax_path(name, unit)
        groups.setdefault(path, []).append(t)
    out = {}
    for path, ts in groups.items():
        shape = tuple(ts[0].shape) if len(ts) == 1 and \
            jax_path(next(n for n in named
                          if jax_path(n, unit)[0] == path), unit)[1] is None \
            else (len(ts),) + tuple(ts[0].shape)
        out[prefix + path] = (shape, _dtype(ts[0].dtype))
    return out


def _port_leaves(cell, kind, unit):
    out, metas = {}, []

    def tensor(key, t):
        metas.append(t)
        out[key] = (tuple(t.shape), _dtype(t.dtype))
    if kind == "train":
        st = cell["state"]
        out.update(_named(dict(st.model.named_parameters()), unit,
                          ("params",)))
        metas.extend(st.model.parameters())
        for k, v in st.opt.items():
            if isinstance(v, dict):
                out.update(_named(v, unit, ("opt", k)))
                metas.extend(v.values())
            else:                               # a host count
                out[("opt", k)] = ((), "int32")
        out[("step",)] = ((), "int32")          # a host integer
        for k, t in cell["batch"].items():
            tensor(("batch", k), t)
    else:
        out.update(_named(dict(cell["params"].named_parameters()), unit,
                          ("params",)))
        metas.extend(cell["params"].parameters())
        for k, t in cell.items():
            if k in ("params", "state"):
                continue
            tensor((k,), t)
    if kind == "decode":
        layers, n = cell["state"]["layers"], len(unit)
        for i in range(n):
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                    layers[i])[0]:
                key = ("state", "units", f"b{i}") + tuple(
                    jshd._path_str([k]) for k in path)
                tensor(key, leaf)
                out[key] = ((len(layers[i::n]),) + tuple(leaf.shape),
                            _dtype(leaf.dtype))
        tensor(("state", "pos"), cell["state"]["pos"])
    return out, metas


_JAX_STATE, _PORT_STATE = jspecs.train_state_specs, specs.train_state_specs


@functools.lru_cache(maxsize=None)
def _jax_state(arch):
    return _JAX_STATE(jax_experiment(arch))


@functools.lru_cache(maxsize=None)
def _port_state(arch):
    return _PORT_STATE(get_experiment(arch))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_the_reference_at_full_size(arch, monkeypatch):
    """Every admitted cell's inputs: the JAX package's keys, shapes and
    dtypes, every port leaf on ``meta`` (the train state, the same for
    every cell of an arch, made once in each package)."""
    monkeypatch.setattr(jspecs, "train_state_specs",
                        lambda exp: _jax_state(arch))
    monkeypatch.setattr(specs, "train_state_specs",
                        lambda exp: _port_state(arch))
    shapes = [s for a, s in CELLS if a == arch]
    assert shapes
    unit = _port_state(arch).model.unit
    for shape in shapes:
        kind = tconfig.SHAPES[shape]["kind"]
        want = _jax_leaves(jspecs.input_specs(jax_experiment(arch), shape))
        cell = specs.input_specs(get_experiment(arch), shape)
        got, metas = _port_leaves(cell, kind, unit)
        if kind == "train":       # the TrainState's fields
            want = {(k[0].split(".")[-1],) + k[1:] if k[0] == "state"
                    else k: v for k, v in want.items()}
            want = {k[1:] if k[0] == "state" else k: v
                    for k, v in want.items()}
        assert got == want, (arch, shape, set(got) ^ set(want))
        assert {t.device.type for t in metas} == {"meta"}, (arch, shape)


def test_specs_of_a_cnn_are_meta_too():
    from repro_torch.configs import paper_cnns
    st = specs.train_state_specs(paper_cnns.resnet110())
    leaves = list(st.model.parameters()) + list(st.model.buffers())
    assert leaves and {t.device.type for t in leaves} == {"meta"}


@pytest.fixture
def cut_shapes(monkeypatch):
    for name, cell in CUT.items():
        monkeypatch.setitem(tconfig.SHAPES, name, cell)
        monkeypatch.setitem(jconfig.SHAPES, name, cell)


def _reduced(arch):
    return reduce_experiment(get_experiment(arch))


def test_multi_pod_cell_is_ok(cut_shapes):
    r = dryrun.analyze_cell("qwen2_5_3b", "train_4k", True,
                            _reduced("qwen2_5_3b"))
    assert r["status"] == "ok", r.get("error")
    assert r["chips"] == 512


def test_skipped_cell_carries_the_reference_reason():
    r = dryrun.analyze_cell("qwen2_5_3b", "long_500k", False)
    ok, why = jconfig.shape_applicable(jax_experiment("qwen2_5_3b").model,
                                       "long_500k")
    assert not ok and r == {"arch": "qwen2_5_3b", "shape": "long_500k",
                            "multi_pod": False, "status": "skipped",
                            "reason": why}


def test_forced_exception_is_an_error_cell_and_main_exits_1(monkeypatch,
                                                            capsys):
    import torch.distributed as dist

    def boom(*a, **kw):
        raise RuntimeError("forced")
    monkeypatch.setattr(dryrun, "build_cell", boom)
    r = dryrun.analyze_cell("qwen2_5_3b", "train_4k", False)
    assert r["status"] == "error" and r["error"] == "RuntimeError: forced"
    assert "Traceback" in r["trace"]
    assert dryrun.main(["--arch", "qwen2_5_3b", "--shape", "train_4k"]) == 1
    out = capsys.readouterr().out.splitlines()
    assert "error" in out[0] and out[-1] == "done: 1 cells, 1 errors"
    assert not dist.is_initialized()


def _local_bytes(shape, spec, sizes, itemsize):
    n = 1
    for dim, axes in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if axes is None else (axes,) if isinstance(axes, str) \
            else axes
        n *= math.ceil(dim / math.prod(sizes[a] for a in axes))
    return n * itemsize


def test_argument_bytes_are_the_reference_specs_sharded(cut_shapes):
    """The train cell's arguments: every array leaf of the JAX package's
    state and batch specs at its rule-table (batch) spec on the production
    mesh, rank 0's shard of each dimension ``ceil(dim / n)`` (the step, a
    host integer in the port, left out)."""
    arch = "qwen2_5_3b"
    r = dryrun.analyze_cell(arch, "train_4k", False, _reduced(arch))
    jexp = dataclasses.replace(
        jax_experiment(arch), model=dataclasses.replace(
            jax_experiment(arch).model, **{
                f.name: getattr(_reduced(arch).model, f.name)
                for f in dataclasses.fields(_reduced(arch).model)
                if f.name != "param_dtype"}))
    cell = jspecs.input_specs(jexp, "train_4k")
    mesh = jshd.make_abstract_mesh((16, 16), ("data", "model"))
    sizes = {"data": 16, "model": 16}
    want = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(cell["state"])[0]:
        if leaf is None or leaf.ndim == 0:
            continue
        spec = jshd._spec_for(tuple(leaf.shape), jshd.logical_rules(
            jshd._path_str(path)), mesh, jexp.mesh.fsdp)
        want += _local_bytes(leaf.shape, spec, sizes, leaf.dtype.itemsize)
    for leaf in cell["batch"].values():
        spec = jshd.batch_sharding(mesh, leaf.ndim, shape=leaf.shape).spec
        want += _local_bytes(leaf.shape, spec, sizes, leaf.dtype.itemsize)
    assert r["bytes_per_device"]["argument"] == want
