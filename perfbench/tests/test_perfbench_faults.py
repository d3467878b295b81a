"""A whole run on the CPU at tiny widths, the chip check skipped: the
harness's result line, and ``correct`` coming out false with the timed
path broken underneath (a token altered where it is produced; a decode
step that returns its state unchanged, the previous step's logits; half
of the decode rows left out), and the fp8 control in the program's place
reading above the limit on three seeds.  (The one-chip cell has no
exchange between chips to leave out.)"""
import json
import time
from pathlib import Path

import pytest

from perfbench import harness

DATA = Path(__file__).resolve().parent / "data"
SPEC = json.loads((harness.HERE.parent / "BENCHMARK.json").read_text())


def tiny_cell(config, seed=7, trace=False, seconds=2.0):
    conf = json.loads((DATA / f"{config}.json").read_text())
    mix = json.loads((DATA / "tiny_chat.json").read_text())
    return harness.Cell(
        name="qwen3-30b-a3b.chat_shared", conf=conf, mix=mix,
        limits=json.loads((DATA / "tiny.limits.json").read_text()),
        seed=seed, seconds=seconds, trace=trace, device="cpu",
        t_start=time.monotonic(),
        program=harness._module("programs", "decoder_lm"),
        reference=harness._module("reference", "decoder_lm"),
        runner=harness._module("runners", "serve_closed_loop"))


def run_line(cell):
    run = cell.runner.run(cell)
    return harness.result(SPEC, cell, run, {"platform": "cpu"}), run


@pytest.mark.parametrize("config", ["tiny-dense", "tiny-moe"])
def test_a_sound_run_is_correct_and_well_formed(config):
    line, run = run_line(tiny_cell(config))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"decode_tokens_per_s", "itl_p99_ms",
                                    "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert run.info["served_tokens"] > 0
    json.dumps(line)


def test_the_traced_line_has_its_per_layer_metrics():
    line, _ = run_line(tiny_cell("tiny-moe", trace=True))
    assert {"decode_rows_mean.serve", "prefix_hit_share.serve",
            "mfu.serve", "ttft_p95_ms.moe"} <= set(line["metrics"])
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("config", ["tiny-dense", "tiny-moe"])
def test_a_token_altered_where_it_is_produced_is_caught(config, monkeypatch):
    from repro_torch.serve.engine import ServeEngine
    sample = ServeEngine._sample

    def altered(logits_row, sp, n_emitted):
        tok = sample(logits_row, sp, n_emitted)
        return (tok + 1) % logits_row.size if n_emitted == 3 else tok
    monkeypatch.setattr(ServeEngine, "_sample", staticmethod(altered))
    line, _ = run_line(tiny_cell(config))
    assert line["correct"] is False
    assert line["checks"]["served_not_best"]["value"] > 0


@pytest.mark.parametrize("config", ["tiny-dense", "tiny-moe"])
def test_a_decode_step_that_returns_its_state_unchanged_is_caught(
        config, monkeypatch):
    from repro_torch.models import transformer
    step = transformer.lm_decode_step_paged
    last = {}

    def unchanged(cfg, params, cache, batch, shard=None):
        cache, logits = step(cfg, params, cache, batch, shard=shard)
        prev = last.get("logits")
        last["logits"] = logits
        return cache, logits if prev is None else prev
    monkeypatch.setattr(transformer, "lm_decode_step_paged", unchanged)
    line, _ = run_line(tiny_cell(config))
    assert line["correct"] is False
    assert line["checks"]["logit_err_worst"]["value"] > \
        line["checks"]["logit_err_worst"]["limit"]


@pytest.mark.parametrize("config", ["tiny-dense", "tiny-moe"])
def test_half_of_the_decode_rows_left_out_is_caught(config, monkeypatch):
    """The decode step computes the first half of its rows; the others'
    logits are never written (zeros)."""
    from repro_torch.models import transformer
    step = transformer.lm_decode_step_paged

    def half(cfg, params, cache, batch, shard=None):
        cache, logits = step(cfg, params, cache, batch, shard=shard)
        logits = logits.clone()
        logits[logits.shape[0] // 2:] = 0
        return cache, logits
    monkeypatch.setattr(transformer, "lm_decode_step_paged", half)
    line, _ = run_line(tiny_cell(config))
    assert line["correct"] is False
    assert line["checks"]["logit_err_worst"]["value"] > \
        line["checks"]["logit_err_worst"]["limit"]


@pytest.mark.parametrize("config", ["tiny-dense", "tiny-moe"])
def test_the_fp8_control_in_the_programs_place_is_not_correct(config):
    """The control on three seeds: the reference in fp8, judged by the
    run's own checks in the program's place, comes out not correct, where
    the program on the same sample reads under the limit."""
    for seed in (11, 12, 13):
        cell = tiny_cell(config, seed=seed)
        cell.control = True
        line, run = run_line(cell)
        limit = line["checks"]["logit_err_worst"]["limit"]
        assert line["correct"] is False, line["checks"]
        assert line["checks"]["logit_err_worst"]["value"] > limit
        assert run.info["program_logit_err_worst"] < limit
