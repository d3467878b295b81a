"""zamba2-2.7b [hybrid] — 54L d_model=2560 Mamba2 + shared attention block.

54 Mamba2 (SSD, state=64) layers; one *weight-shared* transformer block
(32H kv=32, d_ff=10240) applied every 6 layers.  Sub-quadratic overall:
runs long_500k (attention caches exist only for the 9 shared-block call
sites).  [arXiv:2411.15242; hf]
"""
from repro_torch.configs.base import HybridConfig, ModelConfig, SSMConfig, register


@register("zamba2-2.7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid",
        n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
        d_ff=10240, vocab=32000, head_dim=80,
        act="swiglu", rope="rope",
        ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64,
                      chunk=256, version=2),
        hybrid=HybridConfig(attn_every=6, shared_d_ff=10240),
        full_attention=False,
    )
