"""Data-parallel meshes over ``torch.distributed`` (the JAX package's
``repro.distributed``): the rule-table shardings (``sharding.py``), the
collectives of the global computation, and the sharded train state
(``fsdp.py``)."""
from __future__ import annotations

from typing import Tuple

from repro_torch.distributed.sharding import (batch_sharding, logical_rules,
                                              param_shardings,
                                              state_shardings)


def process_shard() -> Tuple[int, int]:
    """``(shard, num_shards)`` for the counter-based data path: the rank
    and world size of the default process group, or ``(0, 1)`` without
    one.  Each process of a world without a mesh draws only its shard,
    ``make_batch(step, shard)``, a pure function of ``(seed, step,
    shard)``, so shards never overlap and need no exchange of data."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1
