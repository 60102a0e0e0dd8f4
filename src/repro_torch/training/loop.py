"""The chunked training loop: K executed steps per dispatch, metrics read
back once per chunk.

The counterpart of the JAX package's ``training/loop.py``.  There, K
executed steps compile into one ``lax.scan`` program and SLU's skip is a
``lax.cond`` on the device.  Here, on the card, the train step
(``training/train_step.TrainStep``'s device half) is captured once into a
CUDA graph in which every unforced gated block is an IF conditional node
set on the device (``core/slu.gated_residual``, ``kernels/graph_cond.py``),
and a chunk replays that graph k times: before each replay, device copies
put slot i of the chunk's stacked inputs (the batch, the SLU uniforms, the
step's float32 scalars) into the graph's static input buffers; after it, a
device copy puts the step's metrics into row i of the stacked metrics.  On
the CPU the same device half runs eagerly on the same inputs, so a chunk
equals the per-step loop bit for bit there.

* SMD decisions stay on the host and counter-based: a dropped step never
  reaches the device and draws no data.  What a chunk holds is only its
  executed steps.
* Each executed step carries a ``step_increment`` = 1 + the drops just
  before it, so ``state.step`` (the key of the step's SLU draws, the
  schedule's step) is the per-step loop's at every step.  The host
  counters (the step, AdamW's and SWA's counts) advance on the host as the
  chunk's inputs are drawn: they never depend on the device.
* Metrics come back stacked ``(k, ...)`` on the device; the caller syncs
  once per chunk.

Trailing drops (after the chunk's last executed step) are not part of the
chunk: they go into the next chunk's first increment, or to
:meth:`ChunkPlanner.flush_trailing` at the end of the run.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.config import Experiment
from repro_torch.training.train_step import TrainState, TrainStep

# The chunk's contract, the JAX package's five rule names, each as it
# reads in the port:
#
# * no-host-callback        — no device-to-host sync inside a captured
#                             step: no .item(), float(tensor) or
#                             bool(tensor), no copy from pageable host
#                             memory; a sync inside capture fails it.
# * static-trip-count       — a chunk is k replays of one graph captured
#                             once; the host loop's trip count is the
#                             chunk's length, never a device value.
# * shape-stable-body       — the captured step's kernels and shapes do not
#                             depend on the step: everything that changes
#                             per step (the batch, the uniforms, the
#                             scalars) is copied into static buffers.
# * device-resident-metrics — metrics are copied into stacked (k, ...)
#                             device tensors; the caller syncs once per
#                             chunk.
# * no-donation-default     — nothing to donate: the state is updated in
#                             place (one copy of it exists), which the
#                             JAX package reaches only with donation.
CHUNK_CONTRACT = (
    "no-host-callback",
    "static-trip-count",
    "shape-stable-body",
    "device-resident-metrics",
    "no-donation-default",
)

FLAGS = "slu_executed"      # the stacked SLU flags beside the metrics


def stack_batches(batches: Sequence[Dict[str, torch.Tensor]]
                  ) -> Dict[str, torch.Tensor]:
    """Stack per-step host batches into the chunk's leading-k layout, on the
    host, pinned where the batches are: the chunk then reaches the card in
    one non-blocking copy per key."""
    out = {}
    for k in batches[0]:
        xs = [torch.as_tensor(b[k]) for b in batches]
        t = torch.stack(xs)
        out[k] = t.pin_memory() if xs[0].is_pinned() else t
    return out


class ChunkPlanner:
    """Groups a stream of ``(step, batch_or_None)`` items into chunks.

    Feed items in nominal-step order (``data/pipeline.DataPipeline``
    yields exactly this); ``None`` means the step was SMD-dropped before
    generation.  ``add`` returns a completed ``(steps, batches,
    increments)`` chunk once ``chunk_steps`` executed steps accumulated,
    else ``None``.  ``flush`` returns the final partial chunk;
    ``flush_trailing`` returns drops after the last executed step (the
    caller advances the step counter by that much once, at the end).
    """

    def __init__(self, chunk_steps: int):
        self.chunk_steps = chunk_steps
        self._steps: List[int] = []
        self._batches: List[Any] = []
        self._incs: List[int] = []
        self._pending_drops = 0
        self.dropped = 0
        self.executed = 0

    def add(self, step: int, batch):
        if batch is None:
            self._pending_drops += 1
            self.dropped += 1
            return None
        self._steps.append(step)
        self._batches.append(batch)
        self._incs.append(self._pending_drops + 1)
        self._pending_drops = 0
        self.executed += 1
        if len(self._steps) == self.chunk_steps:
            return self._emit()
        return None

    def drop(self, step: int, batch) -> None:
        """Force-drop a kept step (straggler policy): the generated batch is
        discarded and the step is accounted exactly like an SMD drop."""
        del step, batch
        self._pending_drops += 1
        self.dropped += 1

    def flush(self):
        """The final partial chunk, or ``None`` if no executed step is
        buffered (trailing drops stay pending for ``flush_trailing``)."""
        if not self._steps:
            return None
        return self._emit()

    def flush_trailing(self) -> int:
        n, self._pending_drops = self._pending_drops, 0
        return n

    def _emit(self):
        steps = tuple(self._steps)
        batches = stack_batches(self._batches)
        incs = np.asarray(self._incs, np.int32)
        self._steps, self._batches, self._incs = [], [], []
        return steps, batches, incs


def _stack_metrics(rows: List[Dict[str, torch.Tensor]]
                   ) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


class ChunkStep:
    """``(state, batches, step_increment) -> (state, stacked_metrics)``,
    built by :func:`make_chunk_step`.

    On the card the first call runs its first step eagerly as the warm-up
    (timed apart, ``warmup_s``), captures the step into a CUDA graph
    (``capture_s``) and replays it for every later step of every chunk;
    there is no eager fallback: a capture that fails raises.  Each replay
    is bracketed by CUDA events (:meth:`take_events`, read by
    :func:`device_times` once the chunk has synced), and the stacked metrics hold the step's SLU flags
    under ``"slu_executed"``.  On the CPU every step runs eagerly, and so
    does it on the card with ``eager`` set (a mesh whose collectives are
    gloo's, which a CUDA graph cannot hold), its inputs copied to the card.
    """

    def __init__(self, exp: Experiment, K: Optional[int] = None):
        self.exp = exp
        self.K = K
        self.ts = TrainStep(exp)
        self.eager = False
        self.graph = None
        self.cond = None
        self.warmup_s: Optional[float] = None
        self.capture_s: Optional[float] = None
        self._static: Dict[str, torch.Tensor] = {}
        self._out: Optional[Tuple[Dict[str, torch.Tensor], torch.Tensor]] = None
        self._events: List[Tuple[int, Any, Any]] = []

    def _validate(self, batches: Dict[str, torch.Tensor],
                  step_increment) -> int:
        k = len(step_increment)
        if self.K is not None and k != self.K:
            raise ValueError(f"chunk declared K={self.K} but got {k} steps")
        lead = {v.shape[0] for v in batches.values()}
        if lead != {k}:
            raise ValueError(f"stacked batch leading axes {lead} != k={k}")
        return k

    def _host_inputs(self, state: TrainState, incs) -> Tuple[list, list]:
        """Each executed step's uniforms and scalars, the host counters
        advanced over the chunk (the drops before each step, the step)."""
        us, scals = [], []
        for inc in incs:
            state.step += int(inc) - 1
            u, scal = self.ts.host_inputs(state)
            us.append(u)
            scals.append(scal)
            self.ts.advance(state)
        return us, scals

    def __call__(self, state: TrainState, batches: Dict[str, torch.Tensor],
                 step_increment) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        k = self._validate(batches, step_increment)
        device = next(state.model.parameters()).device
        if device.type != "cuda" or self.eager:
            rows = []
            for i, inc in enumerate(step_increment):
                state.step += int(inc) - 1
                u, scal = self.ts.host_inputs(state)
                batch = {n: v[i].to(device) for n, v in batches.items()}
                met, flags = self.ts.device_step(
                    state, batch,
                    # the uniforms stay on the host, as in the per-step loop
                    None if u is None else torch.from_numpy(u),
                    torch.from_numpy(scal).to(device))
                rows.append({**met, FLAGS: flags})
                self.ts.advance(state)
            return state, _stack_metrics(rows)
        return state, self._run_graphed(state, batches, step_increment, k,
                                         device)

    # -- the card ---------------------------------------------------------

    def _run_graphed(self, state, batches, incs, k, device):
        us, scals = self._host_inputs(state, incs)
        nb = lambda a: torch.from_numpy(np.stack(a)).pin_memory().to(
            device, non_blocking=True)
        dev_b = {n: v.to(device, non_blocking=True) for n, v in
                 batches.items()}
        dev_u = nb(us) if us[0] is not None else None
        dev_s = nb(scals)
        rows: List[Dict[str, torch.Tensor]] = []
        self._events = []
        for i in range(k):
            first = self.graph is None
            if first:
                self._make_static(dev_b, dev_u, dev_s)
            for n, v in dev_b.items():
                self._static[n].copy_(v[i])
            if dev_u is not None:
                self._static["__u"].copy_(dev_u[i])
            self._static["__scal"].copy_(dev_s[i])
            if first:
                rows.append(self._warm_up_and_capture(state, device))
                continue
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            self.graph.replay()
            t1.record()
            self._events.append((i, t0, t1))
            met, flags = self._out
            rows.append({**{n: v.clone() for n, v in met.items()},
                         FLAGS: flags.clone()})
        return _stack_metrics(rows)

    def _make_static(self, dev_b, dev_u, dev_s) -> None:
        self._static = {n: torch.empty_like(v[0]) for n, v in dev_b.items()}
        if dev_u is not None:
            self._static["__u"] = torch.empty_like(dev_u[0])
        self._static["__scal"] = torch.empty_like(dev_s[0])

    def _device_step(self, state):
        st = self._static
        batch = {n: v for n, v in st.items() if not n.startswith("__")}
        return self.ts.device_step(state, batch, st.get("__u"), st["__scal"])

    def _warm_up_and_capture(self, state, device) -> Dict[str, torch.Tensor]:
        """The first step eagerly on a side stream (its metrics are the
        step's), then the capture of the step; nothing runs at capture."""
        from repro_torch.kernels import graph_cond
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            met, flags = self._device_step(state)
            row = {**met, FLAGS: flags}
        torch.cuda.synchronize(device)
        self.warmup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.cond = graph_cond.CondGraph(device)
        graph = torch.cuda.CUDAGraph()
        with graph_cond.capturing(self.cond), \
                torch.cuda.graph(graph, stream=side,
                                 capture_error_mode="thread_local"):
            # a read back to the host inside the step raises here
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                self._out = self._device_step(state)
            finally:
                torch.cuda.set_sync_debug_mode(prev)
        torch.cuda.synchronize(device)
        self.capture_s = time.perf_counter() - t0
        self.graph = graph
        torch.cuda.current_stream(device).wait_stream(side)
        return row

    def take_events(self) -> List[Tuple[int, Any, Any]]:
        """The last chunk's CUDA events around each replay, by slot; read
        them with :func:`device_times` once the chunk has synced."""
        events, self._events = self._events, []
        return events

    def release(self) -> None:
        """Drop the graph and give its bodies' memory back."""
        self.graph = None
        self._out = None
        if self.cond is not None:
            self.cond.release()
            self.cond = None


def device_times(events: List[Tuple[int, Any, Any]]) -> Dict[int, float]:
    """Seconds of each replayed step on the device, by its slot in the
    chunk (:meth:`ChunkStep.take_events`)."""
    return {i: a.elapsed_time(b) / 1e3 for i, a, b in events}


def make_chunk_step(exp: Experiment, K: Optional[int] = None) -> ChunkStep:
    """Build ``(state, batches, step_increment) -> (state, stacked_metrics)``.

    ``batches`` is the chunk's executed-step batches stacked along a new
    leading axis (host tensors, :func:`stack_batches`); ``step_increment``
    is an int ``(k,)`` vector (see the module doc).  ``K`` is an optional
    declared chunk length: when given, calls are validated against it (the
    tail chunk of a run may be shorter: pass ``K=None`` to accept any
    length).  Metrics come back as device ``(k, ...)`` tensors, with the
    steps' SLU flags under ``"slu_executed"``.
    """
    return ChunkStep(exp, K)
