"""The plain reference against the port at tiny widths on the CPU, in
float32: the dense and MoE decoders' logits at every position (the MoE
routed with no token dropped, a prompt longer than the experts' fair
share so that a capacity would bind), and the fp8 control reading other
logits."""
import dataclasses
import json
from pathlib import Path

import torch

from perfbench.programs import decoder_lm
from perfbench.reference import decoder_lm as ref

DATA = Path(__file__).resolve().parent / "data"


def port_logits(cfg, params, tokens):
    from repro_torch.models.layers import logits_from_hidden
    from repro_torch.models.transformer import forward_hidden
    t = torch.as_tensor([tokens])
    emb = params["embed"]["embed"][t]
    pos = torch.arange(len(tokens))[None, :]
    with torch.no_grad():
        h, _ = forward_hidden(cfg, params, emb, pos)
        return logits_from_hidden(cfg, params["embed"], h)[0].float()


def relative_err(name, seed, capacity_factor=None):
    """The reference's logits against the port's at every position of a
    48-token prompt, largest gap over the largest logit; the port's MoE at
    ``capacity_factor`` where one is given."""
    conf = json.loads((DATA / f"{name}.json").read_text())
    conf["torch_dtype"] = "float32"
    n = 48
    conf["serve"] = dict(conf["serve"], prefill_chunk_tokens=n)
    cfg = decoder_lm.model_config(conf)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    params = decoder_lm.make_weights(cfg, seed, torch.device("cpu"),
                                     conf["weights"])
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (n,), generator=g).tolist()
    want = port_logits(cfg, params, tokens)
    (got,) = ref.logits_at(conf, params, [tokens], [list(range(n))])
    return float((got - want).abs().max() / want.abs().max())


def check(name, seed):
    err = relative_err(name, seed)
    assert err < 1e-5, err


def test_dense_reference_matches_the_port():
    for seed in (1, 2):
        check("tiny-dense", seed)


def test_moe_reference_matches_the_port_dropless():
    # 48 tokens over 8 experts: a capacity of a few times the fair share
    # of 6 would drop some; the port is run with none dropped
    for seed in (1, 2, 3, 4):
        check("tiny-moe", seed)
    # the comparison sees a capacity that drops tokens: at 1.0 (6 tokens
    # an expert a slot) the port departs from the reference
    assert max(relative_err("tiny-moe", seed, 1.0)
               for seed in (1, 2, 3, 4)) > 1e-3


def test_fp8_control_reads_other_logits():
    conf = json.loads((DATA / "tiny-dense.json").read_text())
    conf["torch_dtype"] = "float32"
    cfg = decoder_lm.model_config(conf)
    params = decoder_lm.make_weights(cfg, 3, torch.device("cpu"),
                                     conf["weights"])
    tokens = list(range(5, 37))
    pos = [list(range(32))]
    (a,) = ref.logits_at(conf, params, [tokens], pos)
    (b,) = ref.logits_at(conf, params, [tokens], pos, "fp8")
    rel = float((a - b).abs().max() / a.abs().max())
    assert 1e-3 < rel < 0.5
