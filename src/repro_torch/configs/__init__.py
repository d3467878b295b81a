"""Arch registry: importing this package registers all assigned architectures."""
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, MoEConfig, SSMConfig, HybridConfig, EncDecConfig,
    get_config, list_archs, reduced_config, torch_dtype,
)
from repro_torch.configs import (  # noqa: F401
    stablelm_3b, qwen3_0_6b, nemotron_4_15b, phi3_mini_3_8b,
    falcon_mamba_7b, qwen2_vl_72b, llama4_maverick_400b_a17b,
    olmoe_1b_7b, whisper_small, zamba2_2_7b,
)

ALL_ARCHS = list_archs()
