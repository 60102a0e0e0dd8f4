"""phi-3-vision-4.2b (the JAX package's ``configs/phi_3_vision_4_2b.py``):
the phi3-mini text backbone, 32 layers, d_model 3072, 32 heads (kv 32,
head_dim 96), d_ff 8192, vocab 32064.  The CLIP tower is a stub, as in the
JAX package: 576 precomputed patch embeddings ``(B, 576, d)`` are
prepended to the token stream."""
from repro_torch.core.config import Experiment, ModelConfig, TrainConfig

PATCH_TOKENS = 576    # 24x24 CLIP-ViT-L/14 at 336px


def get_config() -> Experiment:
    return Experiment(model=ModelConfig(
        name="phi-3-vision-4.2b", family="vlm",
        num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
        d_ff=8192, vocab_size=32064,
        frontend="vision", frontend_tokens=PATCH_TOKENS,
        rope_theta=10000.0,
    ), train=TrainConfig(optimizer="sgdm"))
