"""qwen3-0.6b [dense] — 28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936.

qk_norm + GQA; head_dim=128 (q proj widens 1024 -> 2048).  The paper's own
evaluation family (Qwen3).  [hf:Qwen/Qwen3-8B; hf]
"""
from repro_torch.configs.base import ModelConfig, register


@register("qwen3-0.6b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b", family="dense",
        n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8,
        d_ff=3072, vocab=151936, head_dim=128,
        act="swiglu", qk_norm=True, rope="rope", rope_theta=1e6,
        tie_embeddings=True, full_attention=True,
    )
