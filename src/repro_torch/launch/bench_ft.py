"""Fault-injection recovery record (the JAX package's
``benchmarks/bench_ft.py``, with its scenarios, rows and record).

Every scenario injects a real fault through ``repro_torch.ft.faults`` and
records whether the recovery machinery did its job:

* ``corrupt_<mode>``, one per corruption mode (truncate, flip, tamper,
  partial): integrity verification must detect the damage and restore must
  fall back to the previous intact step;
* ``producer_raise``: a raising data producer must reach the consumer of
  ``data/pipeline.DataPipeline`` within one step;
* ``writer_transient_retry`` and ``writer_terminal_surfaced``: transient
  write failures are absorbed by retry with backoff; a terminal one
  surfaces as ``CheckpointWriteError``;
* ``kill_restart``: a supervised world of two launcher workers
  (``repro_torch.launch.train --task lm --arch llama3_8b --smoke
  --e2train smd --ckpt-every 1``), whose rank 1 owns the checkpoint
  directory and is hard-killed at step ``steps // 2 + 1``, shrunk to a
  world of one that resumes from the last intact checkpoint; its final
  checkpoint must equal an uninterrupted run's, in another process, bit
  for bit.

The workers run on the card unless ``device="cpu"`` (``bench_run
--device cpu``) is given, which every worker is passed.  ``ft_json``
returns the record; ``bench_run --json-ft`` writes it and exits nonzero
when any scenario did not recover.
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from typing import Iterator

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import DataPipeline
from repro_torch.ft import faults
from repro_torch.ft.checkpoint import (WRITE_RETRIES, CheckpointWriteError,
                                       latest_intact_step, restore_checkpoint,
                                       save_checkpoint, verify_checkpoint,
                                       wait_for_saves)
from repro_torch.ft.supervisor import Supervisor

SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WORKER_TIMEOUT_S = 580


def _tiny_state():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "b": torch.ones(4)},
            "step": np.int32(5)}


def _corrupt_recovery_scenarios():
    rows = []
    for mode in faults.CORRUPT_MODES:
        with tempfile.TemporaryDirectory() as d:
            st = _tiny_state()
            save_checkpoint(d, st, 3)
            save_checkpoint(d, st, 7)
            faults.corrupt_checkpoint(d, 7, mode)
            intact, reason = verify_checkpoint(d, 7)
            detected = not intact
            fell_back = latest_intact_step(d) == 3
            try:
                _, got = restore_checkpoint(d, st)
                restored_ok = got == 3
            except Exception as e:  # noqa: BLE001 - recorded, not swallowed
                restored_ok, reason = False, repr(e)
            rows.append({"scenario": f"corrupt_{mode}",
                         "detected": detected, "fell_back": fell_back,
                         "reason": reason,
                         "recovered": detected and fell_back and restored_ok})
    return rows


def _producer_raise_scenario():
    mk = faults.raising_at_step(lambda s, sh: {"x": np.full((2,), s)}, 3)
    pipe = DataPipeline(mk, None, prefetch=2)
    got, err, t0 = [], None, time.perf_counter()
    try:
        for _ in range(10):
            got.append(next(pipe)[0])
    except RuntimeError as e:
        err = e
    surfaced_s = time.perf_counter() - t0
    pipe.close()
    recovered = err is not None and got == [0, 1, 2] and surfaced_s < 5.0
    return {"scenario": "producer_raise", "good_steps_consumed": got,
            "surfaced_s": round(surfaced_s, 3), "recovered": recovered}


def _failing_writer_scenarios():
    rows = []
    with tempfile.TemporaryDirectory() as d:
        with faults.failing_writer(fails=WRITE_RETRIES - 1) as count:
            save_checkpoint(d, _tiny_state(), 1)
        intact = verify_checkpoint(d, 1)[0]
        rows.append({"scenario": "writer_transient_retry",
                     "injected_failures": count["n"],
                     "recovered": intact and count["n"] == WRITE_RETRIES - 1})
    with tempfile.TemporaryDirectory() as d:
        surfaced = False
        with faults.failing_writer():            # never recovers
            save_checkpoint(d, _tiny_state(), 1, async_save=True)
            try:
                wait_for_saves()
            except CheckpointWriteError:
                surfaced = True
        rows.append({"scenario": "writer_terminal_surfaced",
                     "recovered": surfaced and wait_for_saves() == {}})
    return rows


def _launcher(device: str, *args):
    return [sys.executable, "-m", "repro_torch.launch.train", "--task", "lm",
            "--arch", "llama3_8b", "--smoke", "--log-every", "0",
            "--device", device, *args]


def _env():
    # one host thread a worker: two run at once
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _kill_restart_scenario(fast: bool, device: str):
    steps = 8 if fast else 16
    env = _env()
    with tempfile.TemporaryDirectory() as d:
        ckpt, scratch, ref = (os.path.join(d, n)
                              for n in ("ckpt", "scratch", "ref"))

        def make_cmd(world, rank, resume):
            # the last rank owns the supervised checkpoints and is the one
            # killed: its saves stop at the kill, so the restart resumes
            # from the middle of the run, whatever the other rank's pace
            args = ["--steps", str(steps), "--e2train", "smd",
                    "--ckpt-every", "1",
                    "--ckpt", ckpt if rank == world - 1 else scratch]
            if resume is not None:
                args += ["--resume"]
            elif world > 1 and rank == world - 1:
                args += ["--ft-kill-at-step", str(steps // 2 + 1)]
            return _launcher(device, *args)

        sup = Supervisor(make_cmd, world=2, ckpt_dir=ckpt, env=env,
                         worker_timeout_s=WORKER_TIMEOUT_S)
        err = None
        try:
            sup.run()
        except Exception as e:  # noqa: BLE001 - recorded, not swallowed
            err = repr(e)
        att = sup.summary()
        final_intact = latest_intact_step(ckpt)

        ref_run = subprocess.run(
            _launcher(device, "--steps", str(steps), "--e2train", "smd",
                      "--ckpt-every", "1", "--ckpt", ref),
            env=env, capture_output=True, text=True,
            timeout=WORKER_TIMEOUT_S)
        if ref_run.returncode != 0:
            err = f"uninterrupted run exited {ref_run.returncode}: " \
                + ref_run.stderr[-2000:]

        bitwise = False
        if err is None and final_intact == steps - 1:
            with np.load(os.path.join(ckpt, f"step_{steps - 1:08d}.npz")) \
                    as a, np.load(os.path.join(
                        ref, f"step_{steps - 1:08d}.npz")) as b:
                bitwise = set(a.files) == set(b.files) and all(
                    np.array_equal(a[k], b[k]) for k in a.files)
        row = {"scenario": "kill_restart", "steps": steps,
               "kill_exit_code": faults.KILL_EXIT_CODE,
               "attempts": att["attempts"], "restarts": att["restarts"],
               "final_intact_step": final_intact,
               "bitwise_match_vs_uninterrupted": bitwise,
               "recovered": err is None and bitwise}
        if err is not None:
            row["error"] = err
        return row


def ft_json(fast: bool = True, device=None,
            kill_restart: bool = True) -> dict:
    """The fault-injection recovery record (see the module docstring);
    ``device`` is where the launcher workers train (default: the card);
    ``kill_restart=False`` leaves out the kill-and-restart scenario (its
    supervised launcher workers)."""
    dev = resolve_device(device)
    scenarios = []
    scenarios += _corrupt_recovery_scenarios()
    scenarios.append(_producer_raise_scenario())
    scenarios += _failing_writer_scenarios()
    if kill_restart:
        scenarios.append(_kill_restart_scenario(fast, dev.type))
    return {"device": torch.cuda.get_device_name(dev)
            if dev.type == "cuda" else "cpu",
            "scenarios": scenarios,
            "all_recovered": all(s["recovered"] for s in scenarios)}


def run(fast: bool = True, device=None) -> Iterator[str]:
    """CSV rows for the bench driver."""
    record = ft_json(fast, device)
    for s in record["scenarios"]:
        yield f"ft_{s['scenario']},0.0,recovered={s['recovered']}"
    yield f"ft_all,0.0,all_recovered={record['all_recovered']}"
