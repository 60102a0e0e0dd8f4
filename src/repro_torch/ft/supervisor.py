"""Elastic worker supervision: detect death, shrink the world, resume.

A copy of the JAX package's ``repro.ft.supervisor`` (which imports that
package's checkpoint module).  A :class:`Supervisor` launches a *world* of
worker processes (subprocesses of ``repro_torch.launch.train``, for
example), monitors them, and on a worker death applies the elastic
kill-and-restart policy:

1. **detect**: a worker exiting nonzero (or on a signal) marks the whole
   attempt failed; surviving workers are terminated;
2. **shrink**: the next attempt's world is the survivor count
   (``world - deaths``), bounded below by ``RestartPolicy.min_world``;
3. **resume**: the restart resumes from the **last intact checkpoint**
   (``ft/checkpoint.latest_intact_step``: integrity-verified, so a save
   torn by the kill is skipped, never loaded);
4. **give up**: after ``max_restarts`` restarts or when the world would
   fall below ``min_world``.

Batches and SMD decisions are counter-based functions of ``(seed, step,
shard)``, so the resumed counter stream is the uninterrupted run's by
construction.  Workers are opaque commands built by a ``make_cmd(world,
rank, resume_step)`` template; each :class:`Attempt` records its wall
time.
"""
from __future__ import annotations

import signal
import subprocess
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.ft.checkpoint import latest_intact_step


@dataclass(frozen=True)
class RestartPolicy:
    """When and how to restart after a worker death."""

    max_restarts: int = 2       # restart attempts after the first launch
    min_world: int = 1          # smallest mesh worth re-forming
    backoff_s: float = 0.0      # pause before a relaunch (storm damping)


@dataclass
class Attempt:
    """One launch of the full world (for reporting)."""

    world: int
    resume_step: Optional[int]          # intact step resumed from (None=fresh)
    exit_codes: List[Optional[int]] = field(default_factory=list)
    outcome: str = "running"            # "ok" | "worker-died" | "aborted"
    wall_s: float = 0.0                 # launch to the last worker's exit

    def to_dict(self) -> dict:
        return {"world": self.world, "resume_step": self.resume_step,
                "exit_codes": list(self.exit_codes), "outcome": self.outcome,
                "wall_s": self.wall_s}


class SupervisorError(RuntimeError):
    """The run could not be completed under the restart policy."""

    def __init__(self, message: str, attempts: List[Attempt]):
        super().__init__(message)
        self.attempts = attempts


class Supervisor:
    """Launch, monitor and elastically restart a world of workers.

    ``make_cmd(world, rank, resume_step)`` returns the argv for one
    worker.  ``resume_step`` is ``None`` on the first attempt and the
    last *intact* checkpoint step on restarts — the command template
    decides how to translate that into flags (``--resume``) and how the
    world size shapes the worker's mesh.
    """

    def __init__(self, make_cmd: Callable[[int, int, Optional[int]],
                                          Sequence[str]],
                 world: int, ckpt_dir: str,
                 policy: RestartPolicy = RestartPolicy(),
                 env: Optional[Dict[str, str]] = None,
                 poll_s: float = 0.05,
                 worker_timeout_s: float = 600.0):
        self.make_cmd = make_cmd
        self.world = world
        self.ckpt_dir = ckpt_dir
        self.policy = policy
        self.env = env
        self.poll_s = poll_s
        self.worker_timeout_s = worker_timeout_s
        self.attempts: List[Attempt] = []

    # -- one attempt ------------------------------------------------------

    def _launch(self, world: int, resume_step: Optional[int]
                ) -> List[subprocess.Popen]:
        procs = []
        for rank in range(world):
            cmd = list(self.make_cmd(world, rank, resume_step))
            procs.append(subprocess.Popen(cmd, env=self.env))
        return procs

    def _reap(self, procs: List[subprocess.Popen]) -> List[Optional[int]]:
        """Wait until every worker exits or any worker dies (then the
        survivors are killed — a torn SPMD world cannot continue)."""
        deadline = time.monotonic() + self.worker_timeout_s
        while True:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes):
                return codes
            if any(c is not None and c != 0 for c in codes):
                # one dead rank tears the attempt: terminate survivors
                for p in procs:
                    if p.poll() is None:
                        p.terminate()
                for p in procs:
                    try:
                        p.wait(timeout=10)
                    except subprocess.TimeoutExpired:
                        p.kill()
                        p.wait()
                return [p.poll() for p in procs]
            if time.monotonic() > deadline:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
                raise SupervisorError(
                    f"worker timeout after {self.worker_timeout_s}s",
                    self.attempts)
            time.sleep(self.poll_s)

    # -- the policy loop --------------------------------------------------

    def run(self) -> List[Attempt]:
        """Drive the world to completion under the restart policy.

        Returns the attempt history (last outcome ``"ok"``); raises
        :class:`SupervisorError` when the policy gives up.
        """
        world = self.world
        resume: Optional[int] = None
        restarts = 0
        while True:
            att = Attempt(world=world, resume_step=resume)
            self.attempts.append(att)
            t0 = time.perf_counter()
            procs = self._launch(world, resume)
            att.exit_codes = self._reap(procs)
            att.wall_s = time.perf_counter() - t0
            if all(c == 0 for c in att.exit_codes):
                att.outcome = "ok"
                return self.attempts
            att.outcome = "worker-died"
            deaths = sum(1 for c in att.exit_codes
                         if c not in (0, -signal.SIGTERM))
            new_world = world - max(deaths, 1)
            if restarts >= self.policy.max_restarts:
                att.outcome = "aborted"
                raise SupervisorError(
                    f"gave up after {restarts} restart(s): "
                    f"exit codes {att.exit_codes}", self.attempts)
            if new_world < self.policy.min_world:
                att.outcome = "aborted"
                raise SupervisorError(
                    f"world {new_world} below min_world="
                    f"{self.policy.min_world}", self.attempts)
            # resume from the last INTACT checkpoint: a save torn by the
            # kill fails checksum verification and is skipped here
            resume = latest_intact_step(self.ckpt_dir)
            restarts += 1
            world = new_world
            if self.policy.backoff_s:
                time.sleep(self.policy.backoff_s)

    def summary(self) -> dict:
        return {"attempts": [a.to_dict() for a in self.attempts],
                "final_world": self.attempts[-1].world if self.attempts
                else self.world,
                "restarts": max(len(self.attempts) - 1, 0)}


def free_tcp_port() -> int:
    """A free localhost port (for a ``torch.distributed`` rendezvous)."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]
