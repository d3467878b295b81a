"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8) d_ff=8192.

MoE 128 experts top-1 + 1 shared expert on every other layer (interleaved
dense FFN d_ff=16384), early fusion, vocab=202048.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register


@register("llama4-maverick-400b-a17b")
def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=8192, vocab=202048, head_dim=128,
        act="swiglu", rope="rope",
        moe=MoEConfig(n_experts=128, top_k=1, d_ff_expert=8192,
                      every=2, d_ff_dense=16384, n_shared_experts=1,
                      capacity_factor=1.25),
        full_attention=True,
    )
