"""Serving: the prefill and decode step functions and a wave-batched engine
(the JAX package's ``serving/engine.py``).

``make_prefill_step`` / ``make_decode_step`` return the functions a serving
step runs: the eval forward's last-position logits, and one token against
a decode state (``models/transformer.decode_step``).

``ServeEngine`` batches requests in *waves*: up to ``batch_slots`` prompts
are left-padded to a common length with repeats of their first token (the
pads are context: they take positions and no mask hides them, as in the
JAX package), prefilled in one ``prefill_to_state`` (the KV caches and
recurrent states handed to the decode loop), then decoded greedily until
every request in the wave has its ``max_new`` tokens.  A short wave is
filled with clones of its first request (``rid = -1``), dropped from
``finished``.  The greedy tokens stay on the device between steps and are
read to the host once a wave, so that the host enqueues each decode step
without waiting for the one before.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.config import Experiment
from repro_torch.core.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.tasks import eval_logits


def make_prefill_step(exp: Experiment):
    """``prefill(model, tokens, frontend=None)``: the eval forward's
    logits at the last position, (B, 1, V) fp32."""

    def prefill(model, tokens, frontend=None):
        return eval_logits(model, tokens, frontend=frontend)[:, -1:]

    return prefill


def make_decode_step(exp: Experiment):
    """``decode(model, token, state, memory=None)``: one token against
    ``state`` (updated in place) -> ``(logits, state)``."""

    def decode(model, token, state, memory=None):
        return T.decode_step(model, token, state, memory)

    return decode


@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int = 32
    out: List[int] = field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Wave-batched greedy serving of ``model`` (a
    ``models/transformer.TransformerLM`` of ``exp.model``) on ``device``
    (default: the card).  ``prefill`` and ``decode`` are the two steps it
    calls; the KV caches are fp32 for an fp32 model, else bf16."""

    def __init__(self, exp: Experiment, model: T.TransformerLM,
                 batch_slots: int = 4, max_len: int = 512,
                 device: Optional[str] = None):
        self.exp, self.cfg = exp, exp.model
        if self.cfg.encoder_layers:
            raise ValueError(f"{self.cfg.name}: the engine serves text "
                             "prompts only; an enc-dec model needs its "
                             "frontend embeddings (the encoder's input), "
                             "which a Request does not carry")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.slots = batch_slots
        self.max_len = max_len
        cdt = torch.float32 if self.cfg.dtype == "float32" \
            else torch.bfloat16
        self.decode = make_decode_step(exp)
        self.prefill = lambda model, tokens: T.prefill_to_state(
            model, tokens, max_len, cache_dtype=cdt)
        self.queue: List[Request] = []
        self.finished: List[Request] = []

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _run_wave(self, wave: List[Request]) -> None:
        plen = max(len(r.prompt) for r in wave)
        toks = np.zeros((self.slots, plen), np.int32)
        for s, r in enumerate(wave):            # left-pad with token repeats
            pr = np.asarray(r.prompt, np.int32)
            toks[s, plen - len(pr):] = pr
            toks[s, :plen - len(pr)] = pr[0]
        logits, state = self.prefill(
            self.model, torch.from_numpy(toks).to(self.device))
        cur = logits[:, 0].argmax(-1)
        out = [cur]
        for _ in range(max(r.max_new for r in wave) - 1):
            logits, state = self.decode(self.model, cur[:, None].int(),
                                        state)
            cur = logits[:, 0].argmax(-1)
            out.append(cur)
        tokens = torch.stack(out, dim=1).cpu().tolist()    # one read a wave
        for s, r in enumerate(wave):
            r.out.extend(tokens[s][:r.max_new])
            r.done = True
            self.finished.append(r)

    def run(self) -> List[Request]:
        while self.queue:
            wave = [self.queue.pop(0)
                    for _ in range(min(self.slots, len(self.queue)))]
            while len(wave) < self.slots:       # fill the wave with clones
                wave.append(Request(rid=-1, prompt=wave[0].prompt,
                                    max_new=wave[0].max_new))
            self._run_wave(wave)
            self.finished = [r for r in self.finished if r.rid != -1]
        return self.finished
