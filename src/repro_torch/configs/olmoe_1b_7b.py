"""olmoe-1b-7b [moe] — 16L d_model=2048 16H (GQA kv=16) d_ff=1024, 64e top-8.

Every layer is MoE: 64 experts, top-8 routing.  [arXiv:2409.02060; hf]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register


@register("olmoe-1b-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b", family="moe",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1024, vocab=50304, head_dim=128,
        act="swiglu", qk_norm=True, rope="rope",
        moe=MoEConfig(n_experts=64, top_k=8, d_ff_expert=1024,
                      every=1, capacity_factor=2.0),
        full_attention=True,
    )
