"""Task registry: what the training stack needs to know about a model
family.  This package registers ``"cifar_cnn"`` (the CIFAR ResNets and
MobileNetV2) and ``"lm"`` (the transformer LMs).

* ``init(exp, seed, device) -> nn.Module`` — parameters and buffers
  (BatchNorm running statistics) on ``device``.
* ``make_loss(exp) -> loss(model, batch, key, keep=None, slu_u=None)``
  returning ``(total_loss, metrics)`` with 0-d tensor metrics; ``key`` is
  the step's threefry key (``core/rng.py``), ``slu_u`` the uniforms of its
  SLU draws where they were drawn ahead (``slu_uniforms``), ``keep`` a test
  hook that injects SLU decisions where the task takes one.
* ``slu_uniforms(exp, key) -> np.ndarray`` — the fp32 uniforms of a step's
  SLU keep draws, one per gated position in network order (empty for a
  model without gates).
* ``make_predict(exp) -> predict(model, batch)`` — eval-mode logits:
  stored statistics, no RNG, no SLU, no PSG (the plain products); under
  ``torch.no_grad()``, and the model is left in the mode it was found in.
* ``cost(exp) -> TableCostModel`` — the per-layer op counts the energy
  ledger prices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.config import Experiment
from repro_torch.core.cost import TableCostModel


@dataclass(frozen=True)
class Task:
    name: str
    init: Callable
    make_loss: Callable
    make_predict: Optional[Callable] = None
    slu_uniforms: Optional[Callable] = None
    cost: Optional[Callable[[Experiment], TableCostModel]] = None


_REGISTRY: Dict[str, Task] = {}


def register(task: Task) -> Task:
    if task.name in _REGISTRY:
        raise ValueError(f"task {task.name!r} already registered")
    _REGISTRY[task.name] = task
    return task


def get_task(name: str) -> Task:
    _ensure_builtin()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown task {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def task_names() -> Tuple[str, ...]:
    _ensure_builtin()
    return tuple(sorted(_REGISTRY))


def cost_model(exp: Experiment) -> TableCostModel:
    """The experiment's per-layer cost model, resolved through its task; a
    task without one cannot be priced, and that is an error."""
    task = get_task(exp.task)
    if task.cost is None:
        raise ValueError(f"task {task.name!r} registered no cost model; "
                         "energy accounting cannot price this experiment")
    return task.cost(exp)


def eval_logits(model, *args, **kwargs):
    """``model(*args, **kwargs)[0]`` in eval mode under ``torch.no_grad()``,
    the model's mode restored after."""
    was = model.training
    model.eval()
    try:
        with torch.no_grad():
            return model(*args, **kwargs)[0]
    finally:
        model.train(was)


def _ensure_builtin() -> None:
    from repro_torch.tasks import cifar_cnn, lm  # noqa: F401  (register)
