"""whisper-small (the JAX package's ``configs/whisper_small.py``): an
encoder-decoder of 12 + 12 layers, d_model 768, 12 heads (head_dim 64),
d_ff 3072, vocab 51865 (51968 padded), layernorm and a non-gated gelu MLP,
cross-attention in every decoder layer.  The audio frontend is a stub, as
in the JAX package: the encoder takes precomputed frame embeddings ``(B,
1500, d)``; RoPE replaces the learned positions."""
from repro_torch.core.config import Experiment, ModelConfig, TrainConfig

AUDIO_FRAMES = 1500   # 30 s at the whisper frame rate


def get_config() -> Experiment:
    return Experiment(model=ModelConfig(
        name="whisper-small", family="audio",
        num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
        d_ff=3072, vocab_size=51865,
        norm="layernorm", act="gelu", glu=False,
        encoder_layers=12, cross_attention=True,
        frontend="audio", frontend_tokens=AUDIO_FRAMES,
    ), train=TrainConfig(optimizer="sgdm"))
