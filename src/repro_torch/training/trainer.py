"""Per-step training loop with SMD drops, checkpoints, the straggler
policy and run telemetry.

The counterpart of the JAX package's ``training/trainer.py`` in its
per-step mode: one train step per executed step, metrics read back to the
host every step.

* An SMD-dropped step advances ``state.step`` without compute or a data
  fetch.  The keep decisions come from ``core/smd.py`` unless a mask is
  injected (``keep_schedule``, for parity tests).
* With ``checkpoint_dir`` and ``checkpoint_every``, an async save
  (``ft/checkpoint.py``) follows executed step ``s`` when ``(s + 1) %
  checkpoint_every == 0``; with ``checkpoint_dir``, a final save at
  ``state.step - 1`` ends every ``run``.  A failed write is reported in
  ``save_errors`` (and on stderr), never claimed as success.
* With ``deadline_s``, an executed step over the deadline arms one forced
  drop, which the next step consumes: a kept step is dropped and counted in
  ``straggler_dropped_steps`` (which ``energy_report()`` surfaces), an SMD
  drop absorbs it.

The chunked mode and meshes are not ported.
"""
from __future__ import annotations

import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.config import Experiment
from repro_torch.core.device import resolve_device
from repro_torch.core.smd import smd_keep_host
from repro_torch.training.train_step import TrainState, make_train_step


class Trainer:
    def __init__(self, exp: Experiment, state: TrainState,
                 make_batch: Callable[[int, int], Dict[str, torch.Tensor]],
                 shard: int = 0, device=None,
                 keep_schedule: Optional[Sequence[bool]] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 0, deadline_s: float = 0.0):
        self.device = resolve_device(device)
        on = next(state.model.parameters()).device
        if on.type != self.device.type:
            raise ValueError(f"the model is on {on}, the trainer on "
                             f"{self.device}")
        self.exp = exp
        self.state = state
        self.make_batch = make_batch
        self.shard = shard
        self.keep_schedule = keep_schedule
        self.step_fn = make_train_step(exp)
        self.ckpt_dir = checkpoint_dir
        self.ckpt_every = checkpoint_every
        self.deadline_s = deadline_s
        self.history: List[Dict[str, float]] = []
        self.executed_steps = 0
        self.dropped_steps = 0
        self.straggler_dropped_steps = 0    # a subset of dropped_steps
        self._straggler_pending = 0         # armed forced drops
        self.save_errors: Dict[str, BaseException] = {}
        self.save_s: List[float] = []       # each save's time on the loop

    def keeps(self, step: int) -> bool:
        """Whether nominal step ``step`` executes (the SMD decision)."""
        smd = self.exp.e2.smd
        if not smd.enabled:
            return True
        if self.keep_schedule is not None:
            return bool(self.keep_schedule[step])
        return smd_keep_host(self.exp.train.seed, step, smd.drop_prob)

    def run(self, num_steps: int, log_every: int = 0) -> List[Dict[str, float]]:
        for _ in range(num_steps):
            step = self.state.step
            drop = not self.keeps(step)
            forced = False
            if self._straggler_pending:       # straggler -> SMD-style drop
                forced = not drop             # an otherwise-kept step
                drop = True                   # (an SMD drop absorbs the arm)
                self._straggler_pending -= 1
            if drop:
                self.state.step += 1
                self.dropped_steps += 1
                self.straggler_dropped_steps += int(forced)
                continue
            batch = self.make_batch(step, self.shard)
            t0 = time.perf_counter()
            self.state, metrics = self.step_fn(self.state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}  # syncs
            dt = time.perf_counter() - t0
            metrics["step"] = step
            metrics["wall_s"] = dt
            self.history.append(metrics)
            self.executed_steps += 1
            if self.deadline_s and dt > self.deadline_s:
                self._straggler_pending += 1
            if self.ckpt_dir and self.ckpt_every and \
                    (step + 1) % self.ckpt_every == 0:
                self._save(step)
            if log_every and step % log_every == 0:
                print(f"step {step}: loss={metrics['total_loss']:.4f} "
                      f"({dt * 1e3:.0f} ms)")
        self._final_save()
        return self.history

    def _save(self, step: int) -> None:
        from repro_torch.ft.checkpoint import save_checkpoint
        t0 = time.perf_counter()
        save_checkpoint(self.ckpt_dir, self.state, step, async_save=True)
        self.save_s.append(time.perf_counter() - t0)

    def _final_save(self) -> bool:
        """The final checkpoint; returns whether every pending save landed.
        A failed write is reported in ``save_errors`` and on stderr; the
        run's history and telemetry stay either way."""
        if not self.ckpt_dir:
            return True
        self._save(self.state.step - 1)
        # async writers are daemon threads: join them, or the process exit
        # leaves a stale tmp file and no checkpoint
        from repro_torch.ft.checkpoint import wait_for_saves
        failures = wait_for_saves(raise_on_error=False)
        if failures:
            self.save_errors.update(failures)
            for path, err in failures.items():
                print(f"CHECKPOINT SAVE FAILED (post-retry): {path}: {err!r}",
                      file=sys.stderr)
            return False
        return True

    def steps_per_s(self) -> Optional[float]:
        """Executed-step throughput over the run's measured wall time."""
        wall = sum(h["wall_s"] for h in self.history)
        if not self.history or wall <= 0:
            return None
        return len(self.history) / wall

    def measured_psg_fallback(self) -> Optional[float]:
        """Mean measured PSG fallback-tile ratio over executed steps;
        ``None`` when no PSG step ran."""
        vals = [h["psg_fallback_ratio"] for h in self.history
                if "psg_fallback_ratio" in h]
        return float(np.mean(vals)) if vals else None

    def energy_report(self, steps: Optional[int] = None):
        """The run's :class:`~repro_torch.core.ledger.EnergyReport`."""
        from repro_torch.core.ledger import EnergyLedger
        return EnergyLedger.from_trainer(self).report(steps=steps)
