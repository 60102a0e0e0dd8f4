"""Deterministic fault injection: every recovery path gets a real fault.

Long-running training sees preemption, node loss, silent storage
corruption and flaky I/O as routine events.  Each injector here is a
deterministic function of the nominal step counter or of an explicit call,
so a recovery test reproduces the same fault at the same point on every
run.  A copy of the JAX package's ``repro.ft.faults``, aimed at this
package's ``ft/checkpoint``.

Injectors:

* :func:`kill_at_step` — hard process death (``os._exit``) the moment the
  data path asks for a given nominal step: simulates preemption/node loss
  mid-run.  Exits with :data:`KILL_EXIT_CODE` so a supervisor can tell an
  injected kill from a clean exit or a Python crash.
* :func:`raising_at_step` — ``make_batch`` raises at a given step: the
  producer-thread death the pipeline must propagate, not swallow.
* :func:`slow_at_step` — a configured delay on given steps: a straggling
  data source / device feeding the per-step deadline machinery.
* :func:`corrupt_checkpoint` — truncation, byte-flip, silent value
  tampering, or a missing-manifest partial save, applied to an on-disk
  checkpoint: everything ``ft/checkpoint.verify_checkpoint`` must catch.
* :func:`failing_writer` — a context manager that makes the checkpoint
  writer's ``savez`` raise ``OSError(ENOSPC)`` for the first N calls:
  disk-full/flaky-storage simulation for the retry-with-backoff and
  error-surfacing paths.
"""
from __future__ import annotations

import contextlib
import errno
import os
import time
from typing import Callable, Dict, Iterable

import numpy as np

from repro_torch.ft import checkpoint as _ckpt

# distinct from any Python/pytest exit code, so the supervisor's restart
# policy can classify worker deaths
KILL_EXIT_CODE = 43

CORRUPT_MODES = ("truncate", "flip", "tamper", "partial")


def kill_at_step(make_batch: Callable[[int, int], Dict], step: int,
                 exit_code: int = KILL_EXIT_CODE
                 ) -> Callable[[int, int], Dict]:
    """Wrap ``make_batch`` to hard-kill the process at nominal ``step``.

    ``os._exit`` — no atexit handlers, no finally blocks, no flushing of
    in-flight async checkpoint writers: the closest a single process gets
    to losing its node.  Triggers on the first *generated* step ``>=
    step`` (an SMD drop never calls ``make_batch``, and a kill scheduled
    on a dropped step must still fire).
    """
    def wrapped(s: int, shard: int) -> Dict:
        if s >= step:
            os._exit(exit_code)
        return make_batch(s, shard)
    return wrapped


def raising_at_step(make_batch: Callable[[int, int], Dict], step: int,
                    exc: Callable[[], BaseException] = None
                    ) -> Callable[[int, int], Dict]:
    """Wrap ``make_batch`` to raise at the first generated step ``>= step``
    — the producer-thread fault ``DataPipeline`` must propagate."""
    def wrapped(s: int, shard: int) -> Dict:
        if s >= step:
            raise (exc() if exc is not None else
                   RuntimeError(f"injected data fault at step {s}"))
        return make_batch(s, shard)
    return wrapped


def slow_at_step(make_batch: Callable[[int, int], Dict],
                 steps: Iterable[int], delay_s: float
                 ) -> Callable[[int, int], Dict]:
    """Wrap ``make_batch`` to sleep ``delay_s`` on the given nominal steps
    (a deterministic straggler)."""
    slow = frozenset(int(s) for s in steps)

    def wrapped(s: int, shard: int) -> Dict:
        if s in slow:
            time.sleep(delay_s)
        return make_batch(s, shard)
    return wrapped


def corrupt_checkpoint(ckpt_dir: str, step: int, mode: str = "truncate"
                       ) -> str:
    """Damage one saved checkpoint in a specific, reproducible way.

    * ``truncate`` — cut the npz to half its size (crash mid-write /
      torn page): ``np.load`` fails, integrity says *unreadable*.
    * ``flip`` — flip one payload byte in place: zip-level CRC breakage.
    * ``tamper`` — rewrite the npz **legitimately** with one leaf's values
      altered (silent bit-rot / wrong-object-version storage): the zip
      container is self-consistent, so ONLY the manifest's per-leaf CRC32
      catches it — the failure mode that justifies checkpoint-level
      checksums over trusting the container format.
    * ``partial`` — delete the manifest: a crash between the npz rename
      and the manifest commit (the save never committed).

    Returns the damaged path.
    """
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    if mode == "truncate":
        size = os.path.getsize(path)
        with open(path, "rb+") as f:
            f.truncate(max(size // 2, 1))
    elif mode == "flip":
        size = os.path.getsize(path)
        with open(path, "rb+") as f:
            f.seek(size // 2)
            b = f.read(1)
            f.seek(size // 2)
            f.write(bytes([b[0] ^ 0xFF]))
    elif mode == "tamper":
        with np.load(path) as data:
            arrs = {k: np.array(data[k]) for k in data.files}
        # alter the first leaf's bytes without changing shape/dtype
        key = sorted(arrs)[0]
        flat = arrs[key].reshape(-1).view(np.uint8)
        flat[0] ^= 0xFF
        np.savez(path, **arrs)
    elif mode == "partial":
        os.remove(path + _ckpt.MANIFEST_SUFFIX)
    else:
        raise ValueError(f"unknown corruption mode {mode!r}; "
                         f"one of {CORRUPT_MODES}")
    return path


@contextlib.contextmanager
def failing_writer(fails: int = 10**9, exc: OSError = None):
    """Make the checkpoint writer's ``savez`` raise for the first ``fails``
    calls (then recover) — disk-full / flaky-storage simulation.

    ``fails`` smaller than the writer's retry budget exercises
    retry-with-backoff success; ``fails`` larger exercises terminal
    failure surfacing (``wait_for_saves`` → ``CheckpointWriteError``).
    """
    err = exc if exc is not None else \
        OSError(errno.ENOSPC, "injected: no space left on device")
    count = {"n": 0}
    real = _ckpt._savez

    def flaky(path, **arrs):
        if count["n"] < fails:
            count["n"] += 1
            raise err
        return real(path, **arrs)

    _ckpt._savez = flaky
    try:
        yield count
    finally:
        _ckpt._savez = real
