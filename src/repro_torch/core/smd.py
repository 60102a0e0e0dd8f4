"""Stochastic Mini-batch Dropping (SMD, paper §3.1).

Each step is dropped with probability ``drop_prob``.  The decision is the
JAX package's threefry draw ``uniform(fold_in(PRNGKey(seed), step)) >=
drop_prob`` (``core/rng.py``), so every host computes it alone, a dropped
step costs neither compute nor a data fetch, and the schedule is the JAX
package's step for step.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core import rng
from repro_torch.core.config import SMDConfig


def smd_keep_host(seed: int, step: int, drop_prob: float) -> bool:
    """Whether step ``step`` runs (decided on the host, before any fetch)."""
    u = rng.uniform(rng.fold_in(rng.PRNGKey(seed), step))
    return bool(u >= np.float32(drop_prob))


def smd_schedule(cfg: SMDConfig, seed: int, total_steps: int) -> np.ndarray:
    """Boolean keep-mask for a whole run."""
    if not cfg.enabled:
        return np.ones((total_steps,), bool)
    return np.array([smd_keep_host(seed, t, cfg.drop_prob)
                     for t in range(total_steps)])


def expected_energy_ratio(cfg: SMDConfig,
                          epochs_multiplier: Optional[float] = None) -> float:
    """Energy of SMD training relative to standard training: ``m * (1 -
    p)`` for ``m`` times the nominal iterations (paper Fig. 3a: m=4/3, p=0.5
    gives 0.67)."""
    if not cfg.enabled:
        return 1.0 if epochs_multiplier is None else epochs_multiplier
    m = cfg.epochs_multiplier if epochs_multiplier is None else epochs_multiplier
    return m * (1.0 - cfg.drop_prob)
