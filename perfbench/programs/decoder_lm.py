"""The system under test for a decoder-only language model: the port's
``ServeEngine`` (``repro_torch.serve.engine``) over the dense or MoE
transformer, run with its defaults.

This is the one module of the benchmark that imports the program.  It
turns a configuration file into the port's ``ModelConfig``, makes the
weights on the device from the seed in the layout the port's model
functions take, builds the engine and lets the runner watch the engine's
two model calls (their inputs, their logits and host spans; nothing in
the program changes)."""
from __future__ import annotations

import dataclasses
import math

import torch

# the CUDA sources the serve path launches: K1 paged attention, K2 rmsnorm
SERVE_KERNELS = ("paged_attention", "rmsnorm")


def model_config(conf: dict):
    """The port's ``ModelConfig`` of a configuration file.  Raises where
    the file states something the port does not compute, so a cell never
    runs other than its file says.  An MoE is routed without dropping a
    token, as the published models are: the port's prefill dispatch gets
    a capacity of a call's whole length (``capacity_factor`` =
    ``num_experts``); its decode gathers every token's experts."""
    from repro_torch.configs.base import ModelConfig, MoEConfig
    if conf.get("hidden_act") != "silu":
        raise ValueError(f"{conf['name']}: the port's MLP is SwiGLU; "
                         f"hidden_act {conf.get('hidden_act')!r}")
    if conf.get("qk_norm", "per_head") != "per_head":
        raise ValueError(f"{conf['name']}: the port's qk-norm is per head")
    if conf.get("attention_bias") or conf.get("use_sliding_window") \
            or conf.get("mlp_only_layers") \
            or conf.get("decoder_sparse_step", 1) != 1:
        raise ValueError(f"{conf['name']}: the port runs full attention "
                         "without biases, every layer of one kind")
    moe = None
    if "num_experts" in conf:
        if not conf.get("norm_topk_prob", False):
            raise ValueError(f"{conf['name']}: the port renormalises the "
                             "top-k gates; the source does not")
        moe = MoEConfig(n_experts=conf["num_experts"],
                        top_k=conf["num_experts_per_tok"],
                        d_ff_expert=conf.get("moe_intermediate_size")
                        or conf["intermediate_size"], every=1,
                        capacity_factor=float(conf["num_experts"]))
    d, h = conf["hidden_size"], conf["num_attention_heads"]
    return ModelConfig(
        name=conf["name"], family="moe" if moe else "dense",
        n_layers=conf["num_hidden_layers"], d_model=d, n_heads=h,
        n_kv_heads=conf["num_key_value_heads"],
        d_ff=conf["intermediate_size"], vocab=conf["vocab_size"],
        head_dim=conf.get("head_dim") or d // h, act="swiglu",
        qk_norm="qk_norm" in conf, rope="rope",
        rope_theta=float(conf["rope_theta"]),
        norm_eps=float(conf["rms_norm_eps"]),
        tie_embeddings=bool(conf["tie_word_embeddings"]), moe=moe,
        dtype=conf["torch_dtype"], full_attention=True)


def build_kernels() -> None:
    """Compile the serve path's CUDA sources (each one ``nvcc`` at once;
    a library already under ``build/repro_torch/`` is reused)."""
    from repro_torch.kernels import build
    build.build(*SERVE_KERNELS)


def _draw(gen, shape, scale: float, dtype, device) -> torch.Tensor:
    """N(0, 1) clamped to [-2, 2], times ``scale``: one call for a whole
    stack of layers."""
    t = torch.empty(shape, dtype=dtype, device=device)
    t.normal_(0.0, 1.0, generator=gen)
    return t.clamp_(-2.0, 2.0).mul_(scale)


def make_weights(cfg, seed: int, device, weights: dict) -> dict:
    """The port's parameter tree (``transformer.init_lm``'s layout), drawn
    from ``seed`` on ``device`` in the configuration's dtype, one draw per
    kind of weight over all layers; every layer's leaf is a view of its
    stack.  Projections take the port's init scales; ``weights`` (the
    configuration file's) sets the head's scale so the logits spread with
    std ``head_logit_std``, and with ``residual_init`` "gpt2" scales the
    output projections of attention and the MLP or experts by a further
    1/sqrt(2 * layers), so no layer's output swamps the residual stream.

    At the port's own init (output projections 1/sqrt(fan_in), a head that
    gives logits a spread of ~32) attention averages its context layer
    after layer, every position's hidden state collapses onto one
    direction, the router sends most tokens to a few experts, and the best
    logit leads the next by ~100, so no rounding could ever change a
    greedy token."""
    from repro_torch.configs.base import torch_dtype
    dtype = torch_dtype(cfg)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    n, d, hd = cfg.n_layers, cfg.d_model, cfg.resolved_head_dim
    qd, kvd = cfg.q_dim, cfg.kv_dim

    def stack(shape, fan_in, gain=1.0):
        return _draw(gen, (n, *shape), gain / math.sqrt(fan_in), dtype,
                     device)

    def ones(shape):
        return torch.ones((n, *shape), dtype=dtype, device=device)

    out = 1.0 / math.sqrt(2 * n) if weights["residual_init"] == "gpt2" \
        else 1.0
    wq, wk, wv = stack((d, qd), d), stack((d, kvd), d), stack((d, kvd), d)
    wo = stack((qd, d), qd, out)
    ln1, ln2, qn, kn = ones((d,)), ones((d,)), ones((hd,)), ones((hd,))
    if cfg.moe is not None:
        e, f = cfg.moe.n_experts, cfg.moe.d_ff_expert
        router = _draw(gen, (n, d, e), 1.0 / math.sqrt(d), torch.float32,
                       device)
        gate, up = stack((e, d, f), d), stack((e, d, f), d)
        down = stack((e, f, d), f, out)
    else:
        gate, up = stack((d, cfg.d_ff), d), stack((d, cfg.d_ff), d)
        down = stack((cfg.d_ff, d), cfg.d_ff, out)
    layers = []
    for i in range(n):
        attn = {"wq": wq[i], "wk": wk[i], "wv": wv[i], "wo": wo[i]}
        if cfg.qk_norm:
            attn["q_norm"], attn["k_norm"] = qn[i], kn[i]
        ffn = {"wi_gate": gate[i], "wi_up": up[i], "wo": down[i]}
        layer = {"ln1": ln1[i], "ln2": ln2[i], "attn": attn}
        if cfg.moe is not None:
            layer["moe"] = dict(ffn, router=router[i])
        else:
            layer["mlp"] = ffn
        layers.append(layer)
    head = weights["head_logit_std"] / math.sqrt(d)
    embed = {"embed": _draw(gen, (cfg.vocab, d),
                            head if cfg.tie_embeddings else 1.0, dtype,
                            device)}
    if not cfg.tie_embeddings:
        embed["unembed"] = _draw(gen, (d, cfg.vocab), head, dtype, device)
    return {"embed": embed,
            "final_norm": torch.ones((d,), dtype=dtype, device=device),
            "layers": layers}


def make_engine(cfg, params, serve: dict):
    """The port's serve engine with the configuration's serve settings and
    every other argument at its default."""
    from repro_torch.serve.engine import ServeEngine
    return ServeEngine(cfg, params, max_batch=serve["max_batch"],
                       max_len=serve["max_len"],
                       block_size=serve["block_size"],
                       prefill_chunk_tokens=serve["prefill_chunk_tokens"])


def request(rid: int, prompt, max_new: int, on_token, on_finish):
    """A greedy request of the port's engine."""
    from repro_torch.serve.engine import Request
    return Request(rid=rid, prompt=prompt, max_new=max_new,
                   on_token=on_token, on_finish=on_finish)


def kv_invariant_violations(engine) -> int:
    """The engine's own block-accounting check at a step boundary (the
    number of violations; 0 is healthy)."""
    return len(engine.check_invariants())


def observe_model_calls(engine, on_prefill, on_decode) -> None:
    """Wrap the engine's two model calls, each run inside a
    ``torch.profiler.record_function`` span of its name:
    ``on_prefill(start, end, tokens, logits)`` and ``on_decode(seq_lens,
    block_tables, tokens, logits)`` are called with each call's inputs (the
    engine's device tensors) and its logits, once it returns."""
    from torch.profiler import record_function
    fns = engine.fns
    prefill, decode = fns.prefill_chunk, fns.decode_paged

    def prefill_chunk(params, cache, batch, **kw):
        with record_function("model.prefill_chunk"):
            cache, logits = prefill(params, cache, batch, **kw)
        on_prefill(int(batch["start"]), int(batch["prompt_len"]),
                   batch["tokens"], logits)
        return cache, logits

    def decode_paged(params, cache, batch, **kw):
        with record_function("model.decode_paged"):
            cache, logits = decode(params, cache, batch, **kw)
        on_decode(batch["seq_lens"], batch["block_tables"], batch["token"],
                  logits)
        return cache, logits

    engine.fns = dataclasses.replace(fns, prefill_chunk=prefill_chunk,
                                     decode_paged=decode_paged)
