"""starcoder2-15b (the JAX package's ``configs/starcoder2_15b.py``): 40
layers, d_model 6144, 48 heads (GQA, 4 KV heads, head_dim 128), d_ff 24576,
vocab 49152; layernorm, a non-gated gelu MLP with biases, QKV bias, rope
theta 1e5, trained in 4 microbatches."""
from repro_torch.core.config import Experiment, ModelConfig, TrainConfig


def get_config() -> Experiment:
    return Experiment(model=ModelConfig(
        name="starcoder2-15b", family="dense",
        num_layers=40, d_model=6144, num_heads=48, num_kv_heads=4,
        d_ff=24576, vocab_size=49152,
        norm="layernorm", act="gelu", glu=False,
        qkv_bias=True, mlp_bias=True, rope_theta=100000.0,
    ), train=TrainConfig(optimizer="sgdm", microbatches=4))
