"""falcon-mamba-7b [ssm] — 64L d_model=4096 attention-free, ssm_state=16.

Mamba1 selective-scan architecture; vocab=65024.  Sub-quadratic: runs
long_500k.  [arXiv:2410.05355; unverified]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register


@register("falcon-mamba-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b", family="ssm",
        n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1,
        d_ff=0, vocab=65024,
        act="swiglu", rope="none",
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, chunk=256, version=1),
        full_attention=False,
    )
