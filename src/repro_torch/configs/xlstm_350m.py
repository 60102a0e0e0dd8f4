"""xlstm-350m (the JAX package's ``configs/xlstm_350m.py``): 24 layers,
d_model 1024, 4 heads, no MLP (d_ff 0), vocab 50304; units of three mLSTM
blocks and one sLSTM block."""
from repro_torch.core.config import (BLOCK_MLSTM, BLOCK_SLSTM, Experiment,
                                     ModelConfig, TrainConfig)


def get_config() -> Experiment:
    return Experiment(model=ModelConfig(
        name="xlstm-350m", family="ssm",
        num_layers=24, d_model=1024, num_heads=4, num_kv_heads=4,
        d_ff=0, vocab_size=50304, glu=False,
        block_unit=(BLOCK_MLSTM, BLOCK_MLSTM, BLOCK_MLSTM, BLOCK_SLSTM),
    ), train=TrainConfig(optimizer="sgdm"))
