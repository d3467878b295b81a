"""Config system: model configs and the arch registry.

A framework-free copy of ``src/repro/configs/base.py`` (which pulls in
``jax.numpy`` for its dtype helper); the dataclasses and the registry are
field-for-field identical, so a config built here equals its JAX twin.

Every assigned architecture is a ``ModelConfig`` instance registered under its
``--arch`` id.  (The dry-run's ``ShapeSpec`` registry is not ported yet.)
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    # Apply MoE every `every` layers (1 = every layer).  Non-MoE layers use a
    # dense FFN of width `d_ff_dense`.
    every: int = 1
    d_ff_dense: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    # mamba2/SSD only:
    head_dim: int = 64
    chunk: int = 256
    version: int = 1  # 1 = mamba1 selective scan, 2 = mamba2 SSD


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    # zamba2-style: a single *shared* transformer block applied every N layers.
    attn_every: int = 6
    shared_d_ff: int = 0


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    n_enc_layers: int = 12
    # decoder layer count reuses ModelConfig.n_layers


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | ssm | moe | vlm | audio | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    act: str = "swiglu"          # swiglu | squared_relu | gelu
    qk_norm: bool = False
    rope: str = "rope"           # rope | mrope | none
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    dtype: str = "bfloat16"
    # Whether this arch has *any* full-attention path (drives long_500k skip).
    full_attention: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.resolved_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model-flops in roofline)."""
        d, hd = self.d_model, self.resolved_head_dim
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        n = emb
        if self.family == "ssm" and self.ssm is not None:
            di = self.ssm.expand * d
            per = (d * 2 * di               # in_proj (x, z)
                   + di * self.ssm.d_conv   # depthwise conv
                   + di * (2 * self.ssm.d_state + max(1, d // 16))  # B,C,dt proj
                   + max(1, d // 16) * di   # dt up-proj
                   + di * self.ssm.d_state  # A
                   + di                     # D
                   + di * d)                # out_proj
            n += self.n_layers * (per + d)
            return n
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.act in ("swiglu",):
            ffn_dense = 3 * d * self.d_ff
        else:
            ffn_dense = 2 * d * self.d_ff
        if self.moe is not None:
            m = self.moe
            per_exp = (3 if self.act == "swiglu" else 2) * d * m.d_ff_expert
            n_moe = self.n_layers // m.every
            n_dense = self.n_layers - n_moe
            ffn_total = (n_moe * (m.n_experts + m.n_shared_experts) * per_exp
                         + n_moe * d * m.n_experts  # router
                         + n_dense * ((3 if self.act == "swiglu" else 2) * d * (m.d_ff_dense or self.d_ff)))
        else:
            ffn_total = self.n_layers * ffn_dense
        if self.family == "hybrid" and self.ssm is not None and self.hybrid is not None:
            di = self.ssm.expand * d
            per = (d * 2 * di + di * self.ssm.d_conv + di * 2 * self.ssm.d_state
                   + di + di + di * d)
            n += self.n_layers * (per + d)
            # one shared attention+mlp block
            n += attn + (3 * d * (self.hybrid.shared_d_ff or self.d_ff)) + 2 * d
            return n
        n += self.n_layers * (attn + 2 * d) + ffn_total
        if self.encdec is not None:
            # encoder layers + decoder cross-attention
            n += self.encdec.n_enc_layers * (attn + ffn_dense + 2 * d)
            n += self.n_layers * attn  # cross-attn per decoder layer
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE-aware) for 6*N_active*D flops."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        d = self.d_model
        per_exp = (3 if self.act == "swiglu" else 2) * d * m.d_ff_expert
        n_moe = self.n_layers // m.every
        inactive = n_moe * (m.n_experts - m.top_k) * per_exp
        return self.param_count() - inactive


_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(arch_id: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[arch_id] = fn
        return fn
    return deco


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _REGISTRY:
        # import registers all configs
        from repro_torch import configs  # noqa: F401
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]()


def list_archs():
    from repro_torch import configs  # noqa: F401
    return sorted(_REGISTRY)


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    kw = dict(
        name=cfg.name + "-smoke", family=cfg.family,
        n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16, d_ff=128, vocab=256,
        act=cfg.act, qk_norm=cfg.qk_norm, rope=cfg.rope,
        tie_embeddings=cfg.tie_embeddings, dtype="float32",
        full_attention=cfg.full_attention,
    )
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(
            n_experts=4, top_k=min(cfg.moe.top_k, 2), d_ff_expert=32,
            every=cfg.moe.every, d_ff_dense=64,
            n_shared_experts=cfg.moe.n_shared_experts)
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(d_state=8, d_conv=4, expand=2, head_dim=16,
                              chunk=8, version=cfg.ssm.version)
    if cfg.hybrid is not None:
        kw["hybrid"] = HybridConfig(attn_every=2, shared_d_ff=128)
    if cfg.encdec is not None:
        kw["encdec"] = EncDecConfig(n_enc_layers=2)
    return ModelConfig(**kw)


def torch_dtype(cfg: ModelConfig):
    """The activation/parameter dtype ``cfg.dtype`` names, as a torch dtype."""
    import torch
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
