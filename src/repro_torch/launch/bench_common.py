"""The benchmarks' shared harness (the JAX package's ``benchmarks/common.py``):
the tiny-but-learnable LM task, timed training runs, held-out accuracy, the
row format and the energy fields.

Every paper table or figure has one module here (``bench_psg`` Tab. 2,
``bench_e2train`` Tab. 3, ``bench_cnn`` Tab. 4, ``bench_smd`` Fig. 3 and
Tab. 1, ``bench_slu`` Fig. 4, ``bench_convergence`` Fig. 5), each a
``run(fast, device)`` that returns ``name,us_per_call,derived`` CSV rows;
``bench_run`` drives them.  The models are reduced, as the reference's are,
and the energy numbers come from the paper's 45nm per-op model
(``core/energy.py``) through the run's ``EnergyReport``.
"""
from __future__ import annotations

import json
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core.config import (E2TrainConfig, Experiment, ModelConfig,
                                     TrainConfig)
from repro_torch.core.device import resolve_device
from repro_torch.data.synthetic import MarkovLMTask, make_lm_batch
from repro_torch.launch.train import _fp32_is_fp32
from repro_torch.training import evaluate
from repro_torch.training.train_step import (eval_params, init_train_state,
                                             train_state_for)
from repro_torch.training.trainer import Trainer

TINY = ModelConfig(name="bench", family="dense", num_layers=4, d_model=64,
                   num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64,
                   dtype="float32")
TASK = MarkovLMTask(vocab=64)
BATCH, SEQ = 16, 32


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def lm_experiment(e2: E2TrainConfig, steps: int, *, lr: float = 0.1,
                  optimizer: str = "sgdm", seed: int = 0,
                  total_steps: Optional[int] = None,
                  model: ModelConfig = TINY) -> Experiment:
    """The bench model's experiment: batch 16 x 32, the step schedule over
    ``total_steps`` (default ``steps``)."""
    return Experiment(
        model=model, e2=e2,
        train=TrainConfig(global_batch=BATCH, seq_len=SEQ, lr=lr,
                          optimizer=optimizer, schedule="step",
                          total_steps=total_steps or steps, seed=seed))


def run_lm(e2: E2TrainConfig, steps: int, *, lr: float = 0.1,
           optimizer: str = "sgdm", seed: int = 0,
           alpha: float = 1e-3, total_steps: Optional[int] = None,
           model: ModelConfig = TINY, device=None,
           init: Optional[nn.Module] = None
           ) -> Tuple[List[Dict], Trainer, float]:
    """Train the bench model for ``steps`` nominal steps on ``device``
    (default: the card); returns ``(history, trainer, wall seconds)``, the
    wall time on the host's clock around the run, ending in a synchronize.

    The model comes from ``seed`` on the device unless ``init`` (a model on
    that device) is given; the data seed is ``seed``.  ``alpha`` is accepted
    and unused, as in the reference (the SLU weight is the config's).
    """
    del alpha
    dev = resolve_device(device)
    _fp32_is_fp32()
    exp = lm_experiment(e2, steps, lr=lr, optimizer=optimizer, seed=seed,
                        total_steps=total_steps, model=model)
    state = init_train_state(exp, seed=seed, device=dev) if init is None \
        else train_state_for(exp, init)
    trainer = Trainer(exp, state, lambda s, sh: make_lm_batch(
        TASK, seed, s, sh, BATCH, SEQ, dev), device=dev)
    sync(dev)
    t0 = time.perf_counter()
    hist = trainer.run(steps)
    sync(dev)
    return hist, trainer, time.perf_counter() - t0


def final_loss(hist: List[Dict], k: int = 5) -> float:
    return float(np.mean([h["loss"] for h in hist[-k:]])) if hist \
        else float("nan")


def eval_accuracy(trainer: Trainer, n_batches: int = 4) -> float:
    """Next-token top-1 accuracy on held-out synthetic batches (data seed
    999, ``training/evaluate.py``'s protocol) of the run's evaluation
    weights."""
    exp = trainer.exp
    return evaluate.accuracy(exp, eval_params(trainer.state, exp),
                             trainer.device, n_batches)


class Term(NamedTuple):
    """One pass of a path over device memory in a byte model
    (``bench_conv``, ``bench_attn``): its component, what it is, its bytes,
    and ``"op"`` (a PyTorch op of the path) or the kernel wrapper whose
    launches (or whose own PyTorch ops on the card) move it."""
    comp: str
    what: str
    nbytes: int
    source: str = "op"


def device_label(dev: torch.device) -> str:
    """``"cpu"``, or the card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (the
    name alone where ``nvidia-smi`` cannot be run)."""
    if dev.type != "cuda":
        return "cpu"
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(dev.index or 0)],
            capture_output=True, text=True, timeout=30)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    return torch.cuda.get_device_name(dev)


def csv_row(name: str, us_per_call: float, derived: str) -> str:
    return f"{name},{us_per_call:.1f},{derived}"


def time_us(fn: Callable, *args, reps: int = 3):
    """``(microseconds per call, last result)``; the first call is a
    warm-up and is not timed.  On the card by CUDA events around the
    ``reps`` calls, ending in a synchronize; on the CPU by the host's
    clock."""
    out = fn(*args)
    dev = next((a.device for a in args if torch.is_tensor(a)), None)
    if dev is not None and dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn(*args)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) * 1e3 / reps, out
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    return (time.perf_counter() - t0) * 1e6 / reps, out


class Launch(NamedTuple):
    """A kernel launch: the kernel's name (namespace, template arguments
    and parameters stripped), its grid, and its block (``None`` where a
    launch model leaves it open)."""
    name: str
    grid: Tuple[int, int, int]
    block: Optional[Tuple[int, int, int]] = None


#: host calls that put work on the card; each must have a device event
_LAUNCH_CALLS = ("LaunchKernel", "Memcpy", "Memset")
#: the Chrome trace's categories of work on the card
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the range that marks the profiled call in a session
_MEASURED = "device_profile.measured"
#: sessions :func:`device_profile` takes before it gives up on a whole one
_PROFILE_SESSIONS = 8


def kernel_name(raw: str) -> str:
    """``void (anonymous namespace)::conv_fwd_mma_kernel<2>(signed char
    const*, ...)`` -> ``conv_fwd_mma_kernel``."""
    s, depth, out = raw.replace("(anonymous namespace)::", ""), 0, []
    for ch in s:                    # template arguments dropped
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(0, depth - 1)
        elif not depth:
            out.append(ch)
    words = "".join(out).split("(")[0].split()
    return words[-1].split("::")[-1] if words else raw


class Profile(NamedTuple):
    """One profiled call: the card's busy ms, the kernels it launched, and
    the sessions thrown away first because their call had lost device
    records."""
    busy_ms: float
    launches: List[Launch]
    discarded: int


def measured_call(events: List[dict]
                  ) -> Tuple[float, List[Launch], List[str]]:
    """The call inside the ``_MEASURED`` range of a session's Chrome trace
    events: its busy ms (the union of the intervals of the device events
    of the host calls in the range: kernels, memsets, copies), its kernel
    launches, and the names of its launching host calls that have no
    device event (matched by correlation id).  The range is taken by
    time over every thread, since autograd's backward launches from a
    thread of its own while the marked thread waits."""
    (mark,) = [e for e in events if e.get("cat") == "user_annotation"
               and e["name"] == _MEASURED]
    lo, hi = mark["ts"], mark["ts"] + mark["dur"]
    calls = {e["args"]["correlation"]: e["name"] for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and any(c in e["name"] for c in _LAUNCH_CALLS)
             and lo <= e["ts"] <= hi}
    dev = [e for e in events if e.get("cat") in _DEVICE_CATS
           and e["args"].get("correlation") in calls]
    lost = sorted(calls[c] for c in
                  set(calls) - {e["args"]["correlation"] for e in dev})
    if not calls:
        lost = ["(no launching host call in the measured range)"]
    busy_us, end, launches = 0.0, float("-inf"), []
    for e in sorted(dev, key=lambda e: e["ts"]):
        a, b = e["ts"], e["ts"] + e["dur"]
        if b > end:
            busy_us += b - max(a, end)
            end = b
        if e["cat"] == "kernel":
            launches.append(Launch(kernel_name(e["name"]),
                                   tuple(e["args"]["grid"]),
                                   tuple(e["args"]["block"])))
    return busy_us / 1e3, launches, lost


def device_profile(fn: Callable, *args) -> Profile:
    """``fn(*args)`` on the card under ``torch.profiler``: the card's busy
    time in ms (unlike :func:`time_us`'s CUDA events it leaves out the
    time the card waits for the host) and the kernels the call launched,
    with their grids and blocks, as the session's Chrome trace gives them.

    The profiler (torch 2.11, CUDA 12.8, H100) drops runs of device
    records at the start of a session at random, in a fresh process too:
    a session's first few launches (up to 39 of them), or every launch of
    one to three sessions in a row.  So session ``i`` makes ``i + 1`` lead
    calls, which take such a loss and build what the call builds, and then
    the measured call inside the ``_MEASURED`` range; a session whose
    measured call lost any device record is thrown away and taken again,
    up to ``_PROFILE_SESSIONS`` sessions, and ``Profile.discarded`` counts
    the ones thrown away.  Raises ``RuntimeError`` when no session is
    whole: it never returns a short busy time."""
    import os
    import sys
    import tempfile

    from torch.profiler import ProfilerActivity, profile, record_function

    lost: List[str] = []
    for session in range(_PROFILE_SESSIONS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(session + 1):
                fn(*args)
            torch.cuda.synchronize()
            with record_function(_MEASURED):
                fn(*args)
                torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        busy_ms, launches, lost = measured_call(events)
        if not lost:
            return Profile(busy_ms, launches, session)
        print(f"device_profile: session {session} thrown away, "
              f"{len(lost)} launching host calls without a device event "
              f"({sorted(set(lost))})", file=sys.stderr, flush=True)
    raise RuntimeError(
        f"no whole profile in {_PROFILE_SESSIONS} sessions: the last lost "
        f"the device events of {len(lost)} launching host calls "
        f"({sorted(set(lost))})")


def check_launches(model: List[Launch], launched: List[Launch],
                   where: str) -> Dict[str, int]:
    """Hold a byte model's launches against the card's: for every kernel
    the model names, the same grids (and blocks, where it gives them), as
    many times.  Returns the launches held, by kernel; raises
    ``RuntimeError`` on any difference."""
    held: Dict[str, int] = {}
    for name in sorted({m.name for m in model}):
        want = sorted(m for m in model if m.name == name)
        got = sorted(x if want[0].block is not None else x._replace(block=None)
                     for x in launched if x.name == name)
        if got != want:
            raise RuntimeError(f"{where}: the model's {name} launches "
                               f"{want}, the card's {got}")
        held[name] = len(got)
    return held


def one_per_kind(shapes):
    """The first ConvShape of each ``kind``: body, stride-2 transition and
    1x1 downsample (the fast-mode sweep subset)."""
    by_kind = {}
    for s in shapes:
        by_kind.setdefault(s.kind, s)
    return list(by_kind.values())


def energy_fields(trainer, steps: Optional[int] = None) -> str:
    """Derived-CSV fragment from the run's EnergyReport.

    ``paper_composition`` is the config-derived Table 3/4 cross-check;
    ``comp_saving_measured`` is the telemetry-driven column (empty when the
    run produced no measurement: absence, not zero).
    """
    rep = trainer.energy_report(steps=steps)
    meas = rep.computational_savings_measured
    return (f"paper_composition={rep.paper_composition:.4f};"
            f"comp_saving_assumed={rep.computational_savings_assumed:.4f};"
            f"comp_saving_measured="
            + ("" if meas is None else f"{meas:.4f}")
            + f";energy_saving_45nm={rep.energy_savings_assumed:.4f}")
