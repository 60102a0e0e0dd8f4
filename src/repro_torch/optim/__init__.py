"""Optimizers on dictionaries of named tensors, updated in place."""
from repro_torch.optim.api import Optimizer, make_optimizer
from repro_torch.optim.majority_vote import (compress_signs,
                                             majority_vote_psum,
                                             majority_vote_tree)
from repro_torch.optim.swa import swa_init, swa_params, swa_update
