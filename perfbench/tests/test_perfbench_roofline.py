"""The yardstick's counts against hand-worked numbers, the model's
multiplied weights against the port's own parameter count, and the
training step's FLOPs against the port's own analysis of the step."""
import json
from pathlib import Path

import pytest

from perfbench import roofline

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
DATA = Path(__file__).resolve().parent / "data"
QWEN = json.loads((CONFIGS / "qwen3-0.6b.json").read_text())
MOE = json.loads((CONFIGS / "qwen3-30b-a3b.json").read_text())


def test_k1_decode_by_hand():
    # qwen: 16 heads, 8 kv heads, hd 128, 28 layers; two rows of 10 and
    # 30 positions, 25 distinct K/V positions between them
    flops, nbytes = roofline.k1_decode(QWEN, [10, 30], 25)
    assert flops == 4 * 40 * 16 * 128 * 28
    assert nbytes == (2 * 25 * 8 * 128 + 2 * 2 * 16 * 128) * 2 * 28


def test_k1_chunk_by_hand():
    # rows 2..4 attend 3, 4 and 5 positions; K/V of 5 positions
    flops, nbytes = roofline.k1_chunk(QWEN, 2, 5)
    assert flops == 4 * (3 + 4 + 5) * 16 * 128 * 28
    assert nbytes == (2 * 5 * 8 * 128 + 2 * 3 * 16 * 128) * 2 * 28


def test_least_time_takes_the_binding_bound():
    assert roofline.least_time(989e12, 0) == pytest.approx(1.0)
    assert roofline.least_time(0, 3.35e12) == pytest.approx(1.0)
    assert roofline.least_time(989e9, 3.35e12) == pytest.approx(1.0)


def test_token_and_prefill_flops_agree():
    one = sum(roofline.token_flops(QWEN, p + 1) for p in range(100, 108))
    assert roofline.prefill_flops(QWEN, 100, 108) == pytest.approx(one)


def test_matmul_params_against_the_ports_count():
    from perfbench.programs import decoder_lm
    for conf in (QWEN, MOE):
        cfg = decoder_lm.model_config(conf)
        d, n = cfg.d_model, cfg.n_layers
        emb = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
        # the port counts the norms (2 d a layer) and the embeddings; the
        # yardstick counts the weights a token multiplies by, no head
        # (the port's active count keeps the whole router, d x E, as the
        # yardstick does)
        active = cfg.active_param_count() - emb - 2 * d * n
        assert roofline.matmul_params(conf) == active
        assert roofline.head_flops(conf) == 2 * d * cfg.vocab


def test_k3_by_hand():
    # qwen: 16 heads over 8, hd 128; 2 sequences of 4 positions, causal:
    # 10 scored pairs a head and sequence
    flops, nbytes = roofline.k3_forward(QWEN, 2, 4)
    assert flops == 4 * 2 * 16 * 128 * 10
    assert nbytes == 2 * 2 * 4 * 128 * (16 + 8) * 2
    flops, nbytes = roofline.k3_backward(QWEN, 2, 4, causal=False)
    assert flops == 8 * 2 * 16 * 128 * 16
    assert nbytes == (4 * 16 + 4 * 8) * 2 * 4 * 128 * 2


@pytest.mark.parametrize("name", ["tiny-dense", "tiny-moe"])
def test_train_step_flops_against_the_ports_analysis(name):
    """The port's own count of one train step (``analyze_step``, remat
    off) at a tiny width: it scores attention's whole rectangle, as the
    JAX reference's dots do, and runs each expert over its capacity
    buffer (a call's whole length, so that no token is dropped), so it
    exceeds the model FLOPs by the padded experts alone."""
    import torch

    from perfbench.programs import decoder_lm
    from repro_torch.launch.hlo_analysis import analyze_step
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import opt_config
    conf = json.loads((DATA / f"{name}.json").read_text())
    conf["torch_dtype"] = "float32"
    cfg = decoder_lm.model_config(conf)
    cpu = torch.device("cpu")
    params = decoder_lm.make_weights(cfg, 3, cpu, conf["weights"])
    step, opt = make_train_step(cfg, opt_config(3e-4, 100), remat=False,
                                device=cpu)
    b, s = 2, 32
    toks = torch.randint(0, cfg.vocab, (b, s + 1),
                         generator=torch.Generator().manual_seed(3))
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    counted = analyze_step(step, params, opt.init(params), batch)["flops"]
    padded = 0.0
    if "num_experts" in conf:
        g = roofline.dims(conf)
        padded = (g["experts"] - 1) * 6 * g["top_k"] * 3 \
            * g["d"] * g["ff"] * g["layers"] * b * s
    assert counted == roofline.train_step_flops(conf, b, s, causal=False) \
        + padded
    assert roofline.train_step_flops(conf, b, s) < \
        roofline.train_step_flops(conf, b, s, causal=False)
