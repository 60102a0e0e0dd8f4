"""deepseek-moe-16b (the JAX package's ``configs/deepseek_moe_16b.py``): 28
layers, d_model 2048, 16 heads (kv 16, head_dim 128), vocab 102400; a
fine-grained MoE FFN in every layer: 64 routed experts of d_ff 1408, top-6,
and 2 shared experts."""
from repro_torch.core.config import Experiment, ModelConfig, TrainConfig


def get_config() -> Experiment:
    return Experiment(model=ModelConfig(
        name="deepseek-moe-16b", family="moe",
        num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
        d_ff=1408, moe_d_ff=1408, vocab_size=102400,
        num_experts=64, num_shared_experts=2, top_k=6,
        rope_theta=10000.0,
    ), train=TrainConfig(optimizer="sgdm"))
