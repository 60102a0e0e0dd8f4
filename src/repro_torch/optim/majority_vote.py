"""Sign aggregation.  PSG gradients are already signs; ``sign()`` of the
(mean-reduced) gradient is the majority vote of distributed SignSGD."""
from __future__ import annotations

from typing import Dict

import torch


def majority_vote_tree(grads: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    return {k: torch.sign(g.float()) for k, g in grads.items()}
