"""Training loop with SMD drops, checkpoints, the straggler policy and run
telemetry, in the JAX package's two modes (its ``training/trainer.py``):

* **per-step** (``chunk_steps=1``): one train step per executed step,
  metrics read back to the host every step;
* **chunked** (``chunk_steps=K>1``): batches come from
  ``data/pipeline.DataPipeline``'s prefetch thread as host tensors, K
  executed steps go to the device at once (``training/loop.py``: on the
  card, replays of one captured CUDA graph; on the CPU the same steps
  eagerly), and metrics sync once per chunk, while the next chunk is
  being assembled (one chunk in flight).

* An SMD-dropped step advances ``state.step`` without compute or a data
  fetch.  The keep decisions come from ``core/smd.py`` unless a mask is
  injected (``keep_schedule``, for parity tests).
* With ``checkpoint_dir`` and ``checkpoint_every``, an async save
  (``ft/checkpoint.py``) follows executed step ``s`` when ``(s + 1) %
  checkpoint_every == 0``; with ``checkpoint_dir``, a final save at
  ``state.step - 1`` ends every ``run``.  A failed write is reported in
  ``save_errors`` (and on stderr), never claimed as success.
  In chunked mode the cadence is read at chunk granularity and a save
  lands on the chunk's boundary, its last executed step
  (``ft/checkpoint.resume_chunk_start``).
* With ``deadline_s``, an executed step over the deadline arms one forced
  drop, which the next step consumes: a kept step is dropped and counted in
  ``straggler_dropped_steps`` (which ``energy_report()`` surfaces), an SMD
  drop absorbs it.  In chunked mode the per-step time is the step's device
  time between CUDA events around its replay (the counterpart of the JAX
  package's ``step_timer`` callback), read at the chunk's sync; on the CPU,
  and for the warm-up step, the chunk's mean wall time per step.
* A chunked step's ``wall_s`` is its chunk's time over its steps: on the
  card the interval between the ends of consecutive chunks on the
  device's clock (so a chunk that waits for its batches counts the wait),
  for a run's first chunk and on the CPU the host's clock.

With ``mesh=`` (a ``DeviceMesh`` of ``launch/mesh.make_mesh``, one rank a
process), as in the JAX package: the state is placed by
``state_shardings`` (``ft/elastic.reshard_state``): between steps each rank
holds only its shard of every FSDP leaf, parameters, moments and SWA
average alike, and the LM makes each sub-block's weights whole while it
runs (``distributed/fsdp.py``; a CNN's parameters are all replicated).
Every rank draws the *global* batch, ``make_batch(step, 0)``, and keeps
its rows of it (``sharding.rank_rows``, in the JAX package's microbatch
order), and the run goes through the chunked loop inside
``activation_sharding``, where the step computes the global batch's loss
and each rank's shards of its gradients (``training/train_step.py``).
Evaluation on the mesh (``training/evaluate.py``) runs every rank on the
whole held-out batches, gathering as the forward does.  Where the data
axis has more than one rank
and its group is gloo's, a chunk's steps run eagerly (gloo's collectives
cannot be captured in a CUDA graph); with one rank the step is the
non-mesh one, bit for bit.  The straggler deadline reads the chunk-mean
clock, as the JAX package's mesh runs do, and arms from the MAX over the
ranks, so every rank takes the same forced drops.  Checkpoints hold the
full logical state, gathered and written once, by rank 0; every rank
learns of a failed save.

The JAX package's ``donate_chunk_state`` has no counterpart: the port's
state is updated in place, one copy of it.
"""
from __future__ import annotations

import contextlib
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.config import Experiment
from repro_torch.core.device import resolve_device
from repro_torch.core.smd import smd_keep_host
from repro_torch.distributed.sharding import rank_rows
from repro_torch.training.loop import (FLAGS, ChunkPlanner, device_times,
                                       make_chunk_step)
from repro_torch.training.train_step import TrainState, make_train_step


class Trainer:
    def __init__(self, exp: Experiment, state: TrainState,
                 make_batch: Callable[[int, int], Dict[str, torch.Tensor]],
                 shard: int = 0, device=None,
                 keep_schedule: Optional[Sequence[bool]] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 0, deadline_s: float = 0.0,
                 chunk_steps: int = 1, prefetch: int = 2,
                 make_host_batch: Optional[Callable[[int, int], Dict[
                     str, torch.Tensor]]] = None,
                 mesh: Optional[Any] = None):
        """``make_batch(step, shard)`` gives a batch on the trainer's
        device (the per-step loop); ``make_host_batch`` the same batch as
        host tensors, pinned for the card (the chunked loop's prefetch
        thread; on the CPU ``make_batch`` serves)."""
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
        self.chunk_steps = max(int(chunk_steps), 1)
        self.prefetch = prefetch
        self.make_host_batch = make_host_batch
        if self.chunk_steps > 1:
            if keep_schedule is not None:
                raise ValueError("keep_schedule is a per-step test hook")
            if self.device.type == "cuda" and make_host_batch is None:
                raise ValueError("the chunked loop on the card needs "
                                 "make_host_batch (host tensors, pinned)")
        self._chunk_fn = None               # built at the first chunked run
        self._last_sync_t = 0.0
        self._last_done = None              # the last chunk's end event
        self.mesh = mesh
        self.dp = None                      # DataParallel, > 1 data ranks
        self.rank, self.world = 0, 1
        if mesh is not None:
            self._place(mesh)

    def _place(self, mesh) -> None:
        from repro_torch.distributed import sharding
        from repro_torch.ft.elastic import reshard_state
        if self.keep_schedule is not None:
            raise ValueError("keep_schedule is a per-step test hook")
        self.state = reshard_state(self.state, mesh)
        self.world = sharding.mesh_shape(mesh).get("data", 1)
        if self.world > 1:
            from repro_torch.distributed.fsdp import DataParallel
            self.dp = DataParallel(mesh, self.state.model)
            self.rank = self.dp.rank
        tc = self.exp.train
        if tc.global_batch % (self.world * max(tc.microbatches, 1)):
            raise ValueError(
                f"global batch {tc.global_batch} does not split into "
                f"{max(tc.microbatches, 1)} microbatch(es) over "
                f"{self.world} ranks")

    def keeps(self, step: int) -> bool:
        """Whether nominal step ``step`` executes (the SMD decision)."""
        smd = self.exp.e2.smd
        if not smd.enabled:
            return True
        if self.keep_schedule is not None:
            return bool(self.keep_schedule[step])
        return smd_keep_host(self.exp.train.seed, step, smd.drop_prob)

    def run(self, num_steps: int, log_every: int = 0) -> List[Dict[str, float]]:
        if self.chunk_steps > 1 or self.mesh is not None:
            return self._run_chunked(num_steps, log_every)
        return self._run_per_step(num_steps, log_every)

    def _run_per_step(self, num_steps: int,
                      log_every: int = 0) -> List[Dict[str, float]]:
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
            metrics, flags = self.step_fn.step(self.state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}  # syncs
            metrics[FLAGS] = flags.tolist()
            dt = time.perf_counter() - t0
            self._record(step, metrics, dt, log_every)
            if self.deadline_s and dt > self.deadline_s:
                self._straggler_pending += 1
            if self.ckpt_dir and self.ckpt_every and \
                    (step + 1) % self.ckpt_every == 0:
                self._save(step)
        self._final_save()
        return self.history

    def _record(self, step: int, metrics: Dict, dt: float,
                log_every: int) -> None:
        metrics["step"] = step
        metrics["wall_s"] = dt
        self.history.append(metrics)
        self.executed_steps += 1
        if log_every and step % log_every == 0:
            print(f"step {step}: loss={metrics['total_loss']:.4f} "
                  f"({dt * 1e3:.0f} ms)")

    # ------------------------------------------------------------------
    # chunked loop: K executed steps per dispatch, prefetched host data,
    # one metrics sync per chunk
    # ------------------------------------------------------------------

    def _run_chunked(self, num_steps: int,
                     log_every: int = 0) -> List[Dict[str, float]]:
        from repro_torch.data.pipeline import DataPipeline

        if self._chunk_fn is None:
            self._chunk_fn = make_chunk_step(self.exp)
            self._chunk_fn.ts.dp = self.dp
            # gloo's collectives cannot be captured in a CUDA graph
            self._chunk_fn.eager = self.dp is not None and \
                torch.distributed.get_backend(self.dp.group) != "nccl"
        planner = ChunkPlanner(self.chunk_steps)
        self._last_sync_t = 0.0
        self._last_done = None
        start = self.state.step
        draw = self.make_host_batch or self.make_batch
        if self.mesh is not None:
            # every rank draws the global batch and keeps its rows
            m = max(self.exp.train.microbatches, 1)
            fn = draw
            draw = lambda step, shard: rank_rows(fn(step, 0), self.rank,
                                                 self.world, m)
        pipe = DataPipeline(draw, self.exp.e2.smd, seed=self.exp.train.seed,
                            shard=self.shard, prefetch=self.prefetch,
                            start_step=start)
        in_flight = None                  # (steps, t0, host metrics, ...)
        try:
            for _ in range(num_steps):
                step, batch = next(pipe)
                if step != start + planner.executed + planner.dropped:
                    raise RuntimeError("the pipeline is out of lockstep with "
                                       "the SMD schedule")
                if self._straggler_pending:
                    # as in the per-step loop: each armed drop is consumed
                    # by the next step whatever it is; an SMD drop absorbs
                    # it, a kept step is dropped (its batch discarded)
                    self._straggler_pending -= 1
                    if batch is not None:
                        planner.drop(step, batch)
                        self.straggler_dropped_steps += 1
                        continue
                chunk = planner.add(step, batch)
                if chunk is not None:
                    in_flight = self._dispatch(chunk, in_flight, log_every)
            tail = planner.flush()
            if tail is not None:
                in_flight = self._dispatch(tail, in_flight, log_every)
            if in_flight is not None:
                self._finalize(in_flight, log_every)
        finally:
            pipe.close()
            # executed steps count as their metrics are recorded; the drops
            # as the planner saw them, also when a run is interrupted
            self.dropped_steps += planner.dropped
        trailing = planner.flush_trailing()
        self.state.step += trailing
        self._final_save()
        return self.history

    def _dispatch(self, chunk, in_flight, log_every):
        """Launch one chunk, then sync the previous one (one chunk in
        flight); a cadence save waits for this chunk and lands on its
        boundary."""
        steps, batches, incs = chunk
        t0 = time.perf_counter()
        with self._mesh_ctx():
            self.state, stacked = self._chunk_fn(self.state, batches, incs)
        host = None
        if self.device.type == "cuda":
            host = {k: v.to("cpu", non_blocking=True)
                    for k, v in stacked.items()}
            done = torch.cuda.Event(enable_timing=True)
            done.record()
            events = self._chunk_fn.take_events()
        else:
            host, done, events = stacked, None, []
        if in_flight is not None:
            self._finalize(in_flight, log_every)
        in_flight = (steps, t0, host, done, events)
        if self.ckpt_dir and self.ckpt_every and any(
                (s + 1) % self.ckpt_every == 0 for s in steps):
            # the cadence at chunk granularity: sync this chunk and save
            # its boundary, its last executed step, where resume restarts
            # (ft/checkpoint.resume_chunk_start)
            self._finalize(in_flight, log_every)
            self._save(steps[-1])
            in_flight = None
        return in_flight

    def _finalize(self, in_flight, log_every) -> None:
        """The chunk boundary: one sync for the chunk's stacked metrics,
        then the bookkeeping of its steps."""
        steps, t0, host, done, events = in_flight
        if done is not None:
            done.synchronize()
        sync_t = time.perf_counter()
        if done is not None and self._last_done is not None:
            # on the card: the time between the ends of consecutive chunks
            # on the device's clock, which the host's late look at the
            # previous chunk (it was launching this one) cannot shorten
            dt = self._last_done.elapsed_time(done) / 1e3
        else:
            # the chunk was launched while the previous one ran: count from
            # the previous sync so that overlapped time is not counted twice
            dt = sync_t - max(t0, self._last_sync_t)
        self._last_sync_t = sync_t
        self._last_done = done
        per_step_s = dt / max(len(steps), 1)
        dev_s = device_times(events)
        for i, step in enumerate(steps):
            metrics = {k: (v[i].tolist() if k == FLAGS else float(v[i]))
                       for k, v in host.items()}
            if i in dev_s:
                metrics["device_s"] = dev_s[i]
            self._record(step, metrics, per_step_s, log_every)
            if self.deadline_s and self.mesh is None and \
                    dev_s.get(i, per_step_s) > self.deadline_s:
                self._straggler_pending += 1
        if self.deadline_s and self.mesh is not None:
            # the chunk-mean clock, the slowest rank's: one arm a chunk,
            # the same on every rank
            slowest = per_step_s if self.dp is None else \
                self.dp.all_max(per_step_s)
            if slowest > self.deadline_s:
                self._straggler_pending += 1

    def _mesh_ctx(self):
        if self.mesh is None:
            return contextlib.nullcontext()
        from repro_torch.distributed.sharding import activation_sharding
        return activation_sharding(self.mesh)

    def full_state(self) -> TrainState:
        """The state with its full logical arrays: ``state`` itself, or
        under a mesh of several ranks the gathered one (every rank must
        call it)."""
        return self.state if self.dp is None else \
            self.dp.full_state(self.state)

    def _save(self, step: int) -> None:
        """An async save of ``step``; under a mesh of several ranks, of the
        gathered full state, by rank 0."""
        from repro_torch.ft.checkpoint import save_checkpoint
        t0 = time.perf_counter()
        state = self.full_state()
        if self.rank == 0:
            save_checkpoint(self.ckpt_dir, state, step, async_save=True)
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
        if self.dp is not None and \
                self.dp.all_max(float(bool(failures))) and not failures:
            failures = {self.ckpt_dir: RuntimeError(
                "rank 0's save of the mesh's state failed")}
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

    def energy_report(self, steps: Optional[int] = None,
                      validate_against_hlo: bool = False):
        """The run's :class:`~repro_torch.core.ledger.EnergyReport`;
        ``validate_against_hlo`` also runs the static cost audit
        (``analysis/audit.py``, cached per configuration) on the trainer's
        device and stamps its verdict into ``validated_against_hlo``."""
        from repro_torch.core.ledger import EnergyLedger
        return EnergyLedger.from_trainer(self).report(
            steps=steps, validate_against_hlo=validate_against_hlo,
            device=self.device)
