"""grok-1-314b (the JAX package's ``configs/grok_1_314b.py``): 64 layers,
d_model 6144, 48 heads (GQA, 8 kv heads, head_dim 128), vocab 131072; an
MoE FFN of 8 experts of d_ff 32768, top-2, in every layer.  Parameters
(and their optimizer state) in bf16, and 8 microbatches a step, as the
JAX package's config."""
from repro_torch.core.config import Experiment, ModelConfig, TrainConfig


def get_config() -> Experiment:
    return Experiment(model=ModelConfig(
        name="grok-1-314b", family="moe",
        num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8,
        d_ff=32768, moe_d_ff=32768, vocab_size=131072,
        num_experts=8, num_shared_experts=0, top_k=2,
        rope_theta=10000.0,
        param_dtype="bfloat16",
    ), train=TrainConfig(optimizer="sgdm", microbatches=8))
