"""Host-side data pipeline: background prefetch with SMD decided before
generation, a copy of the JAX package's ``data/pipeline.py``.

A producer thread keeps ``prefetch`` items ready, each ``(step, batch)``
or ``(step, None)`` for a step SMD drops: the drop is decided before
generation, so a dropped step costs nothing.  ``make_batch`` must make
HOST batches (CPU tensors, pinned where they go to the card): a CUDA
tensor made on the producer thread would be a pageable copy ordered on
that thread's stream, serialized against the training stream.  An
exception in ``make_batch`` is re-raised in the consumer, never lost with
the thread.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, Iterator, Optional

from repro_torch.core.config import SMDConfig
from repro_torch.core.smd import smd_keep_host


class DataPipeline:
    def __init__(self, make_batch: Callable[[int, int], Dict],
                 smd: Optional[SMDConfig] = None,
                 seed: int = 0, shard: int = 0,
                 prefetch: int = 2, start_step: int = 0):
        """make_batch(step, shard) -> host batch dict."""
        self._make = make_batch
        self._smd = smd or SMDConfig()
        self._seed = seed
        self._shard = shard
        self._step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        # a make_batch exception must not die with the producer thread: it
        # is kept here and re-raised in the consumer (__next__), so the
        # trainer sees it within one get-timeout instead of waiting on an
        # empty queue forever
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self):
        step = self._step
        while not self._stop.is_set():
            try:
                if self._smd.enabled and not smd_keep_host(
                        self._seed, step, self._smd.drop_prob):
                    item = (step, None)             # SMD drop: no generation
                else:
                    item = (step, self._make(step, self._shard))
            except BaseException as e:              # surfaced, never swallowed
                self._error = e
                return
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        while True:
            if self._stop.is_set():
                raise StopIteration
            try:
                return self._q.get(timeout=0.1)     # (step, batch | None)
            except queue.Empty:
                if self._error is not None:
                    # the producer died on this exception; the queue is
                    # drained, so every batch made before it was consumed:
                    # re-raise the original exception at the call site
                    self._stop.set()
                    raise self._error
                continue

    def close(self, timeout: float = 5.0) -> bool:
        """Stop the producer and join it.

        Draining the queue once is not enough: the producer may be parked in
        ``put`` with a ready item and complete the put right after the
        drain, then go generate the next batch.  So: signal stop, then
        alternate drain and a short join until the thread exits (it checks
        the stop flag at least every 0.1 s put timeout).  Returns whether
        the producer terminated within ``timeout``.
        """
        self._stop.set()
        deadline = time.monotonic() + timeout
        while self._thread.is_alive():
            self._drain()
            self._thread.join(timeout=0.05)
            if time.monotonic() > deadline:
                break
        self._drain()                    # a put that landed after the join
        return not self._thread.is_alive()

    def _drain(self):
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
