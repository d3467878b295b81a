"""qwen2-vl-72b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.

M-RoPE + dynamic resolution; the vision patch frontend is a STUB
(input_specs provides precomputed patch/token embeddings).
[arXiv:2409.12191; hf]
"""
from repro_torch.configs.base import ModelConfig, register


@register("qwen2-vl-72b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b", family="vlm",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=29568, vocab=152064, head_dim=128,
        act="swiglu", rope="mrope", rope_theta=1e6, full_attention=True,
    )
