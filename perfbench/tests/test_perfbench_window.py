"""The window's arithmetic: rates and tails over all the work and time of
the window, so a planted stall moves them; a request still waiting at the
close counts its wait."""
import importlib.util
from pathlib import Path

import pytest

from perfbench import window
from perfbench.runners.serve_closed_loop import Rec, Run

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def reader(name):
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def steady_run(stall_at=None, stall=0.0, step=0.1, seconds=10.0):
    """8 clients each emitting a token a step from t=-1; a request every 20
    tokens, the clients out of step; ``stall`` seconds added inside the
    first step from ``stall_at`` on that admits a request."""
    run = Run(conf={}, mix={}, seconds=seconds, t_open=0.0, t_close=seconds)
    t, k = -1.0, 0
    # clients out of step: client c's first request is c + 13 tokens long
    live = [Rec(client=c, prompt=[], prompt_len=100, max_new=20,
                times=[t] * (7 + c)) for c in range(8)]
    while t <= seconds + step:
        fresh = False
        for c in range(8):
            if live[c] is None or len(live[c].times) >= 20:
                fresh = True
                live[c] = Rec(client=c, prompt=[], prompt_len=100, max_new=20,
                              t_submit=t)
                run.recs.append(live[c])
                k += 1
        if stall_at is not None and t >= stall_at and fresh:
            # the step stalls after the submissions: their first tokens,
            # and every row's next token, wait
            t += stall
            stall_at = None
        for c in range(8):
            live[c].times.append(t + step)
        t += step
    return run


def test_rate_counts_tokens_inside_the_window():
    run = steady_run()
    # 8 tokens a step, 100 steps in 10 s
    assert window.decode_tokens_per_s(run) == pytest.approx(80.0, rel=0.02)


def test_rate_takes_the_step_that_runs_past_the_due_time():
    """Steps of 0.9 s from the opening, 10 s asked for: the window closes
    with the step that ends at 10.8 s, and the rate is a step's tokens
    over a step's time, not whole steps over 10 s."""
    run = Run(conf={}, mix={}, seconds=10.0, t_open=0.0, t_close=10.8)
    run.recs = [Rec(client=c, prompt=[], prompt_len=1, max_new=12,
                    times=[0.9 * k for k in range(1, 13)]) for c in range(8)]
    assert run.window_s == pytest.approx(10.8)
    assert window.decode_tokens_per_s(run) == pytest.approx(8 / 0.9)
    # a step 1% slower moves the rate by 1%, with no step of 8 tokens
    times = [0.909 * k for k in range(1, 13)]
    slow = Run(conf={}, mix={}, seconds=10.0, t_open=0.0, t_close=times[-1])
    slow.recs = [Rec(client=c, prompt=[], prompt_len=1, max_new=12,
                     times=list(times)) for c in range(8)]
    assert window.decode_tokens_per_s(slow) == pytest.approx(
        window.decode_tokens_per_s(run) / 1.01)


def test_a_stall_moves_the_rate_and_the_tails():
    base, stalled = steady_run(), steady_run(stall_at=5.0, stall=2.0)
    assert window.decode_tokens_per_s(stalled) < \
        0.85 * window.decode_tokens_per_s(base)
    gaps0, gaps1 = window.token_gaps_s(base), window.token_gaps_s(stalled)
    assert max(gaps1) >= 2.0 > max(gaps0)
    assert reader("ttft_p95_ms.moe")(base) == pytest.approx(100.0, rel=0.01)
    assert reader("itl_p99_ms")(base) == pytest.approx(100.0, rel=0.01)
    assert reader("itl_p99_ms")(stalled) > 100.0
    assert reader("decode_tokens_per_s")(stalled) < \
        0.85 * reader("decode_tokens_per_s")(base)
    # the requests submitted at the stalled step wait for it
    assert max(window.ttfts_s(stalled)) >= 2.0
    assert window.percentile(window.ttfts_s(stalled), 99) > \
        10 * window.percentile(window.ttfts_s(base), 99)


def test_a_request_waiting_at_the_close_counts_its_wait():
    run = Run(conf={}, mix={}, seconds=10.0, t_open=0.0, t_close=10.0)
    run.recs = [Rec(client=0, prompt=[], prompt_len=1, max_new=1,
                    t_submit=4.0),
                Rec(client=1, prompt=[], prompt_len=1, max_new=1,
                    t_submit=1.0, times=[1.5]),
                Rec(client=2, prompt=[], prompt_len=1, max_new=1,
                    t_submit=9.0, times=[10.5])]
    assert sorted(window.ttfts_s(run)) == pytest.approx([0.5, 1.0, 6.0])


def test_requests_submitted_before_the_window_are_not_counted():
    run = Run(conf={}, mix={}, seconds=10.0, t_open=0.0, t_close=10.0)
    run.recs = [Rec(client=0, prompt=[], prompt_len=1, max_new=1,
                    t_submit=-3.0, times=[5.0])]
    assert window.ttfts_s(run) == []
    assert window.tokens(run) == 1


def test_counter_readers():
    run = Run(conf={}, mix={}, seconds=10.0,
              counters_open={"steps": 10, "decode_tokens": 100,
                             "prefill_tokens": 500, "re_prefill_avoided": 0},
              counters_close={"steps": 30, "decode_tokens": 2100,
                              "prefill_tokens": 1500,
                              "re_prefill_avoided": 3000})
    assert reader("decode_rows_mean.serve")(run) == 100.0
    assert reader("prefix_hit_share.serve")(run) == 75.0
    assert reader("k1_roofline.serve")(run) is None
    assert reader("device_idle_share.serve")(run) is None
