"""The yardstick's arithmetic: the H100's published peaks and the
operations and bytes a call or a token needs, from a configuration file's
widths and each call's own context (never from padding).

A kernel's least time is the larger of its operations over the peak rate
and its bytes over the memory bandwidth; each input byte is counted read
once and each output byte written once, whatever the kernel reads again.
"""
from __future__ import annotations

from typing import Iterable, Tuple

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

BF16 = 2   # bytes a value of the served dtype


def dims(conf: dict) -> dict:
    """The widths the counts use, from a configuration file (``ff`` is
    an expert's width in an MoE)."""
    h = conf["num_attention_heads"]
    return {"layers": conf["num_hidden_layers"], "d": conf["hidden_size"],
            "heads": h, "kv": conf["num_key_value_heads"],
            "hd": conf.get("head_dim") or conf["hidden_size"] // h,
            "vocab": conf["vocab_size"],
            "ff": conf.get("moe_intermediate_size")
            or conf["intermediate_size"],
            "experts": conf.get("num_experts", 0),
            "top_k": conf.get("num_experts_per_tok", 0)}


def least_time(flops: float, nbytes: float) -> float:
    """Seconds the chip needs at least for ``flops`` and ``nbytes``."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


# -- K1, paged attention (all layers of one model call) -----------------------

def k1_decode(conf: dict, contexts: Iterable[int],
              kv_positions: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one decode call's K1 launches over every layer:
    each row attends ``ctx`` positions (its written K/V and the new
    token); per layer the call reads the K and V of ``kv_positions``
    distinct positions once (rows sharing a prefix share its blocks) and
    each row's q, and writes each row's output."""
    g = dims(conf)
    ctxs = list(contexts)
    flops = 4.0 * sum(ctxs) * g["heads"] * g["hd"]
    nbytes = (2.0 * kv_positions * g["kv"] * g["hd"]
              + 2.0 * len(ctxs) * g["heads"] * g["hd"]) * BF16
    return flops * g["layers"], nbytes * g["layers"]


def k1_chunk(conf: dict, start: int, end: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one prefill chunk's K1 launches over every layer:
    the prompt rows [start, end), row p attending positions 0..p; K and V
    of [0, end) read once, the rows' q read and outputs written."""
    g = dims(conf)
    span = end * (end + 1) // 2 - start * (start + 1) // 2
    flops = 4.0 * span * g["heads"] * g["hd"]
    nbytes = (2.0 * end * g["kv"] * g["hd"]
              + 2.0 * (end - start) * g["heads"] * g["hd"]) * BF16
    return flops * g["layers"], nbytes * g["layers"]


# -- whole model: FLOPs a token --------------------------------------------------

def matmul_params(conf: dict) -> float:
    """Weights a token multiplies by in one forward pass, all layers,
    without the head: attention projections, and the MLP or the router and
    the top-k experts."""
    g = dims(conf)
    d, hd = g["d"], g["hd"]
    attn = d * g["heads"] * hd * 2 + d * g["kv"] * hd * 2
    if g["experts"]:
        ffn = d * g["experts"] + g["top_k"] * 3 * d * g["ff"]
    else:
        ffn = 3 * d * g["ff"]
    return float(g["layers"] * (attn + ffn))


def head_flops(conf: dict) -> float:
    g = dims(conf)
    return 2.0 * g["d"] * g["vocab"]


def token_flops(conf: dict, ctx: int) -> float:
    """Forward FLOPs of one token attending ``ctx`` positions (itself
    included), without the head."""
    g = dims(conf)
    return 2.0 * matmul_params(conf) \
        + 4.0 * ctx * g["heads"] * g["hd"] * g["layers"]


def prefill_flops(conf: dict, start: int, end: int) -> float:
    """Forward FLOPs of prompt positions [start, end), without the head."""
    g = dims(conf)
    span = end * (end + 1) // 2 - start * (start + 1) // 2
    return 2.0 * matmul_params(conf) * (end - start) \
        + 4.0 * span * g["heads"] * g["hd"] * g["layers"]


# -- K3, flash attention; the training step ------------------------------------

def attention_pairs(seq: int, causal: bool) -> int:
    """(query, key) pairs one head of one sequence scores."""
    return seq * (seq + 1) // 2 if causal else seq * seq


def k3_forward(conf: dict, batch: int, seq: int,
               causal: bool = True) -> Tuple[float, float]:
    """(FLOPs, bytes) of one layer's K3 forward over ``batch`` sequences:
    q·kᵀ and p·v over the scored pairs; q, k, v read, o written (the row
    statistics are left out, under 1% of the bytes at hd 128)."""
    g = dims(conf)
    flops = 4.0 * batch * g["heads"] * g["hd"] * attention_pairs(seq, causal)
    nbytes = 2.0 * batch * seq * g["hd"] * (g["heads"] + g["kv"]) * BF16
    return flops, nbytes


def k3_backward(conf: dict, batch: int, seq: int,
                causal: bool = True) -> Tuple[float, float]:
    """(FLOPs, bytes) of one layer's K3 backward: the four products dV,
    dP, dQ and dK over the scored pairs (the recomputed q·kᵀ is not the
    algorithm's: a kernel that recomputes it reads lower); q, k, v, o, dO
    read, dQ, dK, dV written."""
    g = dims(conf)
    flops = 8.0 * batch * g["heads"] * g["hd"] * attention_pairs(seq, causal)
    nbytes = (4.0 * g["heads"] + 4.0 * g["kv"]) * batch * seq * g["hd"] \
        * BF16
    return flops, nbytes


def train_step_flops(conf: dict, batch: int, seq: int,
                     causal: bool = True) -> float:
    """Model FLOPs of one training step over ``batch`` x ``seq`` tokens:
    forward and backward (3x the forward) of every multiplied weight and
    the head, and of attention over its scored pairs; remat's recomputed
    forward is not counted."""
    g = dims(conf)
    tokens = batch * seq
    dense = 6.0 * (matmul_params(conf) + g["d"] * g["vocab"]) * tokens
    attn = 3.0 * k3_forward(conf, batch, seq, causal)[0] * g["layers"]
    return dense + attn
