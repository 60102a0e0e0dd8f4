"""zamba2-1.2b (the JAX package's ``configs/zamba2_1_2b.py``): 38 blocks,
d_model 2048, 32 heads (kv 32), d_ff 8192, ssm_state 64, vocab 32000;
units of 18 Mamba2 blocks and one call of the weight-shared attention
block, tiled twice; the shared block is never SLU-gated.  Trains in 4
microbatches."""
from repro_torch.core.config import (BLOCK_MAMBA, BLOCK_SHARED_ATTN,
                                     Experiment, ModelConfig, TrainConfig)


def get_config() -> Experiment:
    unit = (BLOCK_MAMBA,) * 18 + (BLOCK_SHARED_ATTN,)
    return Experiment(model=ModelConfig(
        name="zamba2-1.2b", family="hybrid",
        num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
        d_ff=8192, vocab_size=32000, ssm_state=64,
        block_unit=unit,
    ), train=TrainConfig(optimizer="sgdm", microbatches=4))
