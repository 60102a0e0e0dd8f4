"""qwen2.5-3b (the JAX package's ``configs/qwen2_5_3b.py``): 36 layers,
d_model 2048, 16 heads (GQA, 2 KV heads, head_dim 128), d_ff 11008, vocab
151936; QKV bias, tied embeddings, rope theta 1e6."""
from repro_torch.core.config import Experiment, ModelConfig, TrainConfig


def get_config() -> Experiment:
    return Experiment(model=ModelConfig(
        name="qwen2.5-3b", family="dense",
        num_layers=36, d_model=2048, num_heads=16, num_kv_heads=2,
        d_ff=11008, vocab_size=151936,
        qkv_bias=True, tie_embeddings=True, rope_theta=1000000.0,
    ), train=TrainConfig(optimizer="sgdm"))
