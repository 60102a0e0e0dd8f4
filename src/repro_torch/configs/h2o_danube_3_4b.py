"""h2o-danube-3-4b (the JAX package's ``configs/h2o_danube_3_4b.py``): 24
layers, d_model 3840, 32 heads (GQA, 8 KV heads, head_dim 120), d_ff 10240,
vocab 32000; sliding-window attention over 4096 keys, rope theta 1e4."""
from repro_torch.core.config import Experiment, ModelConfig, TrainConfig


def get_config() -> Experiment:
    return Experiment(model=ModelConfig(
        name="h2o-danube-3-4b", family="dense",
        num_layers=24, d_model=3840, num_heads=32, num_kv_heads=8,
        d_ff=10240, vocab_size=32000,
        sliding_window=4096, rope_theta=10000.0,
    ), train=TrainConfig(optimizer="sgdm"))
