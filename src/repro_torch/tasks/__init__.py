"""Task registry: what the training stack needs to know about a model
family.  This package registers ``"cifar_cnn"`` (the CIFAR ResNets) and
``"lm"`` (the dense transformer LM).

* ``init(exp, seed, device) -> nn.Module`` — parameters and buffers
  (BatchNorm running statistics) on ``device``.
* ``make_loss(exp) -> loss(model, batch, key, keep=None)`` returning
  ``(total_loss, metrics)`` with 0-d tensor metrics; ``key`` is the step's
  threefry key (``core/rng.py``), ``keep`` a test hook that injects SLU
  decisions where the task takes one.
* ``cost(exp) -> TableCostModel`` — the per-layer op counts the energy
  ledger prices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

from repro_torch.core.config import Experiment
from repro_torch.core.cost import TableCostModel


@dataclass(frozen=True)
class Task:
    name: str
    init: Callable
    make_loss: Callable
    cost: Callable[[Experiment], TableCostModel]


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


def cost_model(exp: Experiment) -> TableCostModel:
    """The experiment's per-layer cost model, resolved through its task."""
    return get_task(exp.task).cost(exp)


def _ensure_builtin() -> None:
    from repro_torch.tasks import cifar_cnn, lm  # noqa: F401  (register)
