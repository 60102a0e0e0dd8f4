"""Sign aggregation (the JAX package's ``optim/majority_vote.py``).

PSG gradients are already signs; ``sign()`` of the (summed) gradient is
the majority vote of distributed SignSGD [Bernstein et al. 2018].
:func:`compress_signs` clamps a gradient dict to int8 signs and
:func:`majority_vote_psum` sums such signs over a process group in int32
and takes the sign of the sum, in fp32: the 1-bit all-reduce
``PSGConfig.majority_vote`` names (a voter that sends zeros abstains).
"""
from __future__ import annotations

from typing import Dict

import torch


def compress_signs(grads: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """Clamp a (possibly already sign-valued) gradient dict to int8
    signs."""
    return {k: torch.sign(g.float()).to(torch.int8) for k, g in grads.items()}


def majority_vote_psum(sign_grads: Dict[str, torch.Tensor], group=None
                       ) -> Dict[str, torch.Tensor]:
    """The int32 sum of each int8 sign tensor over ``group`` (a
    ``torch.distributed`` group; ``None`` the default one), then its sign
    in fp32, in {-1, 0, +1}."""
    import torch.distributed as dist

    def vote(g):
        total = g.to(torch.int32)
        dist.all_reduce(total, group=group)
        return torch.sign(total.float())

    return {k: vote(g) for k, g in sign_grads.items()}


def majority_vote_tree(grads: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    return {k: torch.sign(g.float()) for k, g in grads.items()}
