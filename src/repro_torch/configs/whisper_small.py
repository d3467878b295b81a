"""whisper-small [audio] — 12L enc + 12L dec, d_model=768 12H d_ff=3072.

Enc-dec; the conv/mel frontend is a STUB per the assignment (input_specs
provides precomputed frame embeddings).  vocab=51865, GELU MLP.
[arXiv:2212.04356; unverified]
"""
from repro_torch.configs.base import EncDecConfig, ModelConfig, register


@register("whisper-small")
def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small", family="audio",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
        d_ff=3072, vocab=51865, head_dim=64,
        act="gelu", rope="none",
        encdec=EncDecConfig(n_enc_layers=12),
        full_attention=True,
    )
