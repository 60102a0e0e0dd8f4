"""Hot-loop lint: the chunked loop's contract, checked on a running chunk.

The counterpart of the JAX package's ``analysis/hotloop_lint.py``, which
traces the ``lax.scan`` chunk program.  The port's chunk
(``training/loop.ChunkStep``) is K replays of one captured CUDA graph on
the card and K eager steps on the CPU, so this lint runs chunks of a real
experiment and checks each rule of ``training/loop.CHUNK_CONTRACT`` as the
port reads it:

==========================  ===============================================
rule                        check
==========================  ===============================================
``no-host-callback``        on the card, a chunk replayed under
                            ``torch.cuda.set_sync_debug_mode("error")``
                            raises at no read back to the host (the
                            capture already runs under it); on the CPU
                            there is no device to wait for: ``None``
``static-trip-count``       on the card, the first chunk warms up and
                            captures once and replays K - 1 times, the
                            second replays the same graph K times with no
                            capture; on the CPU each chunk runs K eager
                            steps
``shape-stable-body``       the histogram of the ops (with their shapes and
                            dtypes) each device step dispatches is the
                            same at every step, and the same at K and at
                            K + 1: nothing of the step or of the chunk
                            length reaches the body
``device-resident-metrics`` every metric comes back stacked ``(K, ...)``
                            on the state's device
``no-donation-default``     the state is updated in place (every parameter
                            keeps its storage over a chunk: one copy of it
                            exists), and ``Trainer`` has no donation
                            option that defaults on
==========================  ===============================================

A rule that cannot be checked on the device given reports ``None``, never
a pass.  Run as a module (``python -m repro_torch.analysis.hotloop_lint
[--device cpu]``) it lints the chunk of a CIFAR CNN (ResNet-14) and of the
smoke LM and exits nonzero on any finding.
"""
from __future__ import annotations

import inspect
import sys
from collections import Counter
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.op_cost import op_name
from repro_torch.core.device import resolve_device
from repro_torch.training.loop import CHUNK_CONTRACT, stack_batches


@dataclass(frozen=True)
class HotloopFinding:
    rule: str           # a CHUNK_CONTRACT entry
    site: str
    message: str

    def __str__(self) -> str:
        return f"{self.site}: [{self.rule}] {self.message}"


class OpHistogram(TorchDispatchMode):
    """Counts the ops dispatched inside, by name, output shapes and
    dtypes."""

    def __init__(self):
        super().__init__()
        self.counts: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        sig = tuple((tuple(t.shape), str(t.dtype))
                    for t in tree_flatten(out)[0]
                    if isinstance(t, torch.Tensor))
        self.counts[(op_name(func), sig)] += 1
        return out


def _recorded(chunk) -> List[Counter]:
    """Record the op histogram of each device step ``chunk`` runs from now
    on (the warm-up and the capture on the card, every step on the CPU)."""
    steps: List[Counter] = []
    inner = chunk.ts.device_step

    def device_step(*args, **kwargs):
        hist = OpHistogram()
        with hist:
            out = inner(*args, **kwargs)
        steps.append(hist.counts)
        return out

    chunk.ts.device_step = device_step
    return steps


def _diff(a: Counter, b: Counter) -> Dict:
    return {k[0]: (a.get(k, 0), b.get(k, 0))
            for k in set(a) | set(b) if a.get(k) != b.get(k)}


def _params(state) -> Dict[str, int]:
    return {n: p.untyped_storage().data_ptr()
            for n, p in state.model.named_parameters()}


def lint_program(make_chunk: Callable[[int], object],
                 make_state: Callable[[], object],
                 make_batches: Callable[[int, int], Dict[str, torch.Tensor]],
                 K: int, device: torch.device, name: str = "chunk"
                 ) -> Tuple[List[HotloopFinding], Dict[str, Optional[bool]]]:
    """Check one chunk program against ``CHUNK_CONTRACT``: ``(findings,
    {rule: True / False / None})``.  ``make_chunk(K)`` builds a chunk
    step (``training/loop.make_chunk_step``), ``make_state()`` a fresh
    train state on ``device``, ``make_batches(first_step, k)`` the stacked
    host batches of k executed steps."""
    findings: List[HotloopFinding] = []
    card = device.type == "cuda"
    ok: Dict[str, Optional[bool]] = {r: True for r in CHUNK_CONTRACT}

    def bad(rule: str, site: str, msg: str) -> None:
        ok[rule] = False
        findings.append(HotloopFinding(rule, site, msg))

    incs = np.ones(K, np.int64)
    state = make_state()
    before = _params(state)
    chunk = make_chunk(K)
    steps = _recorded(chunk)
    state, met = chunk(state, make_batches(0, K), incs)
    first = (len(steps), len(chunk.take_events()) if card else 0,
             getattr(chunk, "graph", None))
    state, met2 = chunk(state, make_batches(K, K), incs)
    second = (len(steps) - first[0],
              len(chunk.take_events()) if card else 0,
              getattr(chunk, "graph", None))
    if card:
        torch.cuda.synchronize(device)

    # static-trip-count
    if card:
        if first[:2] != (2, K - 1) or second[:2] != (0, K) \
                or first[2] is None or second[2] is not first[2]:
            bad("static-trip-count", name,
                f"first chunk {first[0]} eager steps and {first[1]} "
                f"replays, second {second[0]} and {second[1]} (want 2 and "
                f"{K - 1}, then 0 and {K}, of one captured graph)")
    elif (first[0], second[0]) != (K, K):
        bad("static-trip-count", name,
            f"chunks of K={K} ran {first[0]} and {second[0]} steps")

    # shape-stable-body: every step alike, at K and at K + 1
    chunk2 = make_chunk(K + 1)
    steps2 = _recorded(chunk2)
    chunk2(make_state(), make_batches(0, K + 1), np.ones(K + 1, np.int64))
    if card:
        torch.cuda.synchronize(device)
    ref = steps[0]
    for i, h in enumerate(steps[1:] + steps2, start=1):
        if h != ref:
            bad("shape-stable-body", f"{name}/step{i}",
                f"the step's op mix differs from step 0's: {_diff(ref, h)} "
                "— something of the step or of K reaches the body")
            break
    if hasattr(chunk2, "release"):
        chunk2.release()

    # device-resident-metrics
    for m in (met, met2):
        for key, v in m.items():
            if not (isinstance(v, torch.Tensor) and v.dim() >= 1
                    and v.shape[0] == K and v.device.type == device.type):
                bad("device-resident-metrics", f"{name}/metrics[{key}]",
                    f"metric {key!r} is {type(v).__name__} "
                    f"{tuple(getattr(v, 'shape', ()))} on "
                    f"{getattr(v, 'device', None)}, want ({K}, ...) on "
                    f"{device.type}")

    # no-donation-default
    moved = [n for n, p in _params(state).items() if before[n] != p]
    if moved:
        bad("no-donation-default", name,
            f"{len(moved)} parameters changed storage over the chunks "
            f"({moved[:3]}): the state is not updated in place")
    for f in lint_trainer_default():
        bad(f.rule, f.site, f.message)

    # no-host-callback
    if card:
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            chunk(state, make_batches(2 * K, K), incs)
        except RuntimeError as e:
            bad("no-host-callback", name, f"a replayed chunk reads back to "
                f"the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        torch.cuda.synchronize(device)
    else:
        ok["no-host-callback"] = None
    if hasattr(chunk, "release"):
        chunk.release()
    return findings, ok


def lint_trainer_default() -> List[HotloopFinding]:
    """``Trainer`` may not take a donation option that defaults on."""
    from repro_torch.training.trainer import Trainer

    param = inspect.signature(Trainer.__init__).parameters.get(
        "donate_chunk_state")
    if param is not None and param.default is not False:
        return [HotloopFinding(
            "no-donation-default", "Trainer.__init__",
            f"donate_chunk_state defaults to {param.default!r}")]
    return []


def _batches(exp, device: torch.device):
    from repro_torch.data.synthetic import host_image_batch, host_lm_batch
    from repro_torch.training.evaluate import data_task

    task, tc = data_task(exp), exp.train
    pin = device.type == "cuda"

    def host(step):
        if exp.task == "lm":
            return host_lm_batch(task, tc.seed, step, 0, tc.global_batch,
                                 tc.seq_len, pin=pin)
        return host_image_batch(task, 0, step, 0, tc.global_batch, pin=pin)

    return lambda first, k: stack_batches([host(first + i)
                                           for i in range(k)])


def lint_chunk(exp, K: int = 3, device=None
               ) -> Tuple[List[HotloopFinding], Dict[str, Optional[bool]]]:
    """Lint one experiment's real chunk program on ``device`` (the card
    unless ``"cpu"``; raises without one)."""
    from repro_torch.training.loop import make_chunk_step
    from repro_torch.training.train_step import init_train_state

    dev = resolve_device(device)
    return lint_program(lambda k: make_chunk_step(exp, k),
                        lambda: init_train_state(exp, seed=0, device=dev),
                        _batches(exp, dev), K, dev,
                        name=f"chunk:{exp.model.name}")


def default_experiments():
    """ResNet-14 (width 16, batch 8, no E2-Train technique) and the smoke
    llama3-8b, the reference's two."""
    from repro_torch.configs import smoke_experiment
    from repro_torch.configs.paper_cnns import cnn_model
    from repro_torch.core.config import (E2TrainConfig, Experiment,
                                         TrainConfig)

    cnn = Experiment(
        model=cnn_model("resnet14", 14), e2=E2TrainConfig(),
        train=TrainConfig(global_batch=8, lr=0.1, total_steps=100,
                          optimizer="sgdm"),
        task="cifar_cnn")
    return [cnn, smoke_experiment("llama3_8b")]


def hotloop_report(exps=None, device=None) -> dict:
    """The bench record's ``hotloop`` section: the findings and each rule's
    verdict by chunk (``None``: not checkable on this device)."""
    findings: List[HotloopFinding] = []
    rules = {}
    for exp in (exps if exps is not None else default_experiments()):
        f, ok = lint_chunk(exp, device=device)
        findings += f
        rules[exp.model.name] = ok
    unchecked = sorted({r for ok in rules.values()
                        for r, v in ok.items() if v is None})
    return {"findings": [str(f) for f in findings], "rules": rules,
            "unchecked": unchecked,
            "passed": False if findings else (None if unchecked else True)}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = argv[argv.index("--device") + 1] if "--device" in argv else None
    rep = hotloop_report(device=device)
    for f in rep["findings"]:
        print(f)
    print(f"hotloop lint: {len(rep['findings'])} finding(s); not checked "
          f"on this device: {rep['unchecked'] or 'none'}")
    return 1 if rep["findings"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
