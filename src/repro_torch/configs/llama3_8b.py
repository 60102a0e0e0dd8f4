"""llama3-8b (the JAX package's ``configs/llama3_8b.py``): 32 layers,
d_model 4096, 32 heads (GQA, 8 KV heads, head_dim 128), d_ff 14336, vocab
128256 with an untied head; rope theta 5e5."""
from repro_torch.core.config import Experiment, ModelConfig, TrainConfig


def get_config() -> Experiment:
    return Experiment(model=ModelConfig(
        name="llama3-8b", family="dense",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=14336, vocab_size=128256, rope_theta=500000.0,
    ), train=TrainConfig(optimizer="sgdm"))
