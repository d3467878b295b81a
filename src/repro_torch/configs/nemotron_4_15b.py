"""nemotron-4-15b [dense] — 32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000.

GQA + squared-ReLU MLP (no GLU).  [arXiv:2402.16819; unverified]
"""
from repro_torch.configs.base import ModelConfig, register


@register("nemotron-4-15b")
def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b", family="dense",
        n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=24576, vocab=256000, head_dim=128,
        act="squared_relu", rope="rope", full_attention=True,
    )
