"""Elastic restart: place a checkpointed state onto a different mesh (the
JAX package's ``ft/elastic.py``).

Checkpoints hold full logical arrays (``ft/checkpoint.py``) and shardings
are derived from the rule table (``distributed/sharding.py``), never
stored, so resharding is placing a full state by the new mesh's
``state_shardings``: this rank keeps its shard of each FSDP-sharded
parameter, of its moments and of its SWA average
(``distributed/fsdp.DataParallel.place``).
The divisibility fallback guarantees a placement for any mesh, and the
counter-based data path keys on ``(seed, step, shard)``, so a restart on a
different world replays the global batches of the uninterrupted run.
"""
from __future__ import annotations

from typing import Any

from repro_torch.distributed import sharding


def reshard_state(state: Any, new_mesh, fsdp: bool = True) -> Any:
    """Place a full (host-resident or whole-on-device) ``TrainState`` onto
    ``new_mesh``, in place; returns it.  A state already placed on
    ``new_mesh`` is returned as it is; one placed on another mesh raises
    (gather it first: ``DataParallel.full_state``)."""
    placed = getattr(state, "mesh", None)
    if placed is new_mesh:
        return state
    if placed is not None:
        raise ValueError("the state is placed on another mesh: gather its "
                         "full state first")
    if sharding.mesh_shape(new_mesh).get("data", 1) == 1:
        state.mesh = new_mesh
        return state
    from repro_torch.distributed.fsdp import DataParallel
    return DataParallel(new_mesh, state.model, fsdp).place(state)
