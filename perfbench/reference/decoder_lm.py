"""Plain reference of a decoder-only language model, dense or MoE, in
float32 (TF32 off): the forward pass a configuration file describes,
written from the file alone in plain PyTorch.  It imports nothing of the
program and uses no kernel, cache or batching of it.

What it computes, by the file's keys: token embedding; per layer a
pre-norm (RMSNorm, ``rms_norm_eps``) grouped-query attention with q/k
RMSNorm per head over ``head_dim`` (Qwen3's; ``qk_norm`` "per_head"),
rotate-half RoPE at ``rope_theta``, causal softmax at 1/sqrt(head_dim);
then a pre-norm SwiGLU MLP, or an MoE of ``num_experts`` SwiGLU experts:
a float32 router, softmax, the top ``num_experts_per_tok`` experts with
their gates divided by their sum (``norm_topk_prob``).  Then the final
norm and the head (the embedding's transpose where
``tie_word_embeddings``).

Every token goes to its top experts: no capacity, no token dropped, as
the published models route.  Departures from them: none in the
arithmetic; the weights are the benchmark's, drawn from the seed.

``precision="fp8"`` is the control: every matrix product's inputs (weights
per output column, activations, attention's q, k, v and probabilities per
row) rounded to float8 e4m3 with a float32 scale, products and sums in
float32, norms, softmax and the router as in float32.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
Q_BLOCK = 512


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one float32 scale a slice along
    ``dim`` (its absolute maximum maps to e4m3's largest value)."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class _Prec:
    def __init__(self, precision: str):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision {precision!r} is not f32 or fp8")
        self.fp8 = precision == "fp8"

    def w(self, w: torch.Tensor) -> torch.Tensor:
        """A (K, N) weight in f32, or its fp8 rounding per output column."""
        w = w.float()
        return _fp8(w, 0) if self.fp8 else w

    def a(self, x: torch.Tensor) -> torch.Tensor:
        """Activations entering a product, rounded per row in the control."""
        return _fp8(x, -1) if self.fp8 else x


@contextlib.contextmanager
def _exact_f32():
    """TF32 off for the reference's float32 products."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * w.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE of x (L, heads, hd) at positions 0..L-1."""
    length, hd = x.shape[0], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = torch.arange(length, dtype=torch.float32, device=x.device)[:, None] \
        * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(conf: dict, p: Dict, h: torch.Tensor, pr: _Prec
              ) -> torch.Tensor:
    """Causal grouped-query attention of the normed input h (L, d)."""
    length = h.shape[0]
    nh, nkv = conf["num_attention_heads"], conf["num_key_value_heads"]
    hd = conf.get("head_dim") or conf["hidden_size"] // nh
    eps = float(conf["rms_norm_eps"])
    ha = pr.a(h)
    q = (ha @ pr.w(p["wq"])).view(length, nh, hd)
    k = (ha @ pr.w(p["wk"])).view(length, nkv, hd)
    v = (ha @ pr.w(p["wv"])).view(length, nkv, hd)
    if "q_norm" in p:
        q, k = rms_norm(q, p["q_norm"], eps), rms_norm(k, p["k_norm"], eps)
    theta = float(conf["rope_theta"])
    q, k = pr.a(rope(q, theta)), pr.a(rope(k, theta))
    v = pr.a(v)
    rep = nh // nkv
    k = k.repeat_interleave(rep, dim=1).transpose(0, 1)      # (H, L, hd)
    v = v.repeat_interleave(rep, dim=1).transpose(0, 1)
    q = q.transpose(0, 1)
    out = torch.empty_like(q)
    pos = torch.arange(length, device=h.device)
    for lo in range(0, length, Q_BLOCK):
        hi = min(length, lo + Q_BLOCK)
        s = (q[:, lo:hi] @ k[:, :hi].transpose(1, 2)) / math.sqrt(hd)
        s = s.masked_fill(pos[None, lo:hi, None] < pos[None, None, :hi],
                          float("-inf"))
        out[:, lo:hi] = pr.a(torch.softmax(s, dim=-1)) @ v[:, :hi]
    o = out.transpose(0, 1).reshape(length, nh * hd)
    return pr.a(o) @ pr.w(p["wo"])


def swiglu(x: torch.Tensor, wg, wu, wo, pr: _Prec) -> torch.Tensor:
    xa = pr.a(x)
    return pr.a(F.silu(xa @ pr.w(wg)) * (xa @ pr.w(wu))) @ pr.w(wo)


def moe(conf: dict, p: Dict, h: torch.Tensor, pr: _Prec) -> torch.Tensor:
    """The expert layer of the normed input h (L, d), every token's top
    experts each computing it."""
    e, k = conf["num_experts"], conf["num_experts_per_tok"]
    probs = torch.softmax(h @ p["router"].float(), dim=-1)
    idx = torch.topk(probs, k, dim=-1, sorted=True).indices
    gates = probs.gather(1, idx)
    gates = gates / gates.sum(-1, keepdim=True)
    y = torch.zeros_like(h)
    for x in range(e):
        hit = idx == x
        rows = hit.any(1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        g = (gates * hit)[rows].sum(1, keepdim=True)
        y[rows] += g * swiglu(h[rows], p["wi_gate"][x], p["wi_up"][x],
                              p["wo"][x], pr)
    return y


def logits_at(conf: dict, params: Dict, sequences: Sequence[Sequence[int]],
              positions: Sequence[Sequence[int]],
              precision: str = "f32") -> List[torch.Tensor]:
    """The logits (n_i, V) in float32 at ``positions[i]`` of each token
    sequence, computed layer by layer over all sequences (one layer's
    weights at a time in float32; an MoE layer's experts over the tokens
    of every sequence at once).  ``params`` is the weight tree the
    benchmark made (``embed``, ``layers``, ``final_norm``), on the device
    the computation runs on."""
    pr = _Prec(precision)
    eps = float(conf["rms_norm_eps"])
    dev = params["final_norm"].device
    with torch.no_grad(), _exact_f32():
        emb = params["embed"]["embed"]
        xs = []
        for seq in sequences:
            t = torch.as_tensor(list(seq), dtype=torch.long, device=dev)
            x = emb[t].float()
            xs.append(_fp8(x, -1) if pr.fp8 else x)
        lens = [x.shape[0] for x in xs]
        for lp in params["layers"]:
            xs = [x + attention(conf, lp["attn"], rms_norm(x, lp["ln1"], eps),
                                pr) for x in xs]
            x = torch.cat(xs)
            h = rms_norm(x, lp["ln2"], eps)
            if "moe" in lp:
                x = x + moe(conf, lp["moe"], h, pr)
            else:
                m = lp["mlp"]
                x = x + swiglu(h, m["wi_gate"], m["wi_up"], m["wo"], pr)
            xs = list(torch.split(x, lens))
        if conf["tie_word_embeddings"]:
            head = pr.w(params["embed"]["embed"].t())
        else:
            head = pr.w(params["embed"]["unembed"])
        out = []
        for x, pos in zip(xs, positions):
            sel = torch.as_tensor(list(pos), dtype=torch.long, device=dev)
            out.append(pr.a(rms_norm(x[sel], params["final_norm"], eps))
                       @ head)
    return out
