"""The traffic generator: deterministic in the seed, the same work for
every seed, in rounds that each hold the pool's length distribution."""
import json
from pathlib import Path

import numpy as np
import pytest

from perfbench import traffic

MIX = json.loads((Path(__file__).resolve().parents[1] / "traffic"
                  / "chat_shared.json").read_text())
VOCAB, MAX_LEN = 151936, 4096


def take(seed, n):
    t = traffic.Traffic(MIX, VOCAB, seed, MAX_LEN)
    return [t.take() for _ in range(n)]


def test_same_seed_same_requests():
    a, b = take(2**31 + 5, 40), take(2**31 + 5, 40)
    assert [(p, m) for p, m, _ in a] == [(p, m) for p, m, _ in b]


def test_seeds_differ_in_tokens_not_in_sizes():
    a, b = take(1, 40), take(2, 40)
    assert all(pa != pb for (pa, _, _), (pb, _, _) in zip(a, b))
    n = MIX["pool_requests"]
    sizes = [[(it.prefix, it.turn, it.max_new) for _, _, it in take(s, n + 9)]
             for s in (3, 4, 2**32 + 1)]
    assert sizes[0] == sizes[1] == sizes[2]
    assert sorted(sizes[0][:n]) == sorted((it.prefix, it.turn, it.max_new)
                                          for it in traffic.pool(MIX))


def test_each_round_holds_one_request_a_stratum():
    s = traffic.strata(MIX)
    per = MIX["pool_requests"] // s
    outs = sorted(it.max_new for it in traffic.pool(MIX))
    strata = [outs[k * per:(k + 1) * per] for k in range(s)]
    got = take(9, 3 * s)
    for r in range(3):
        rnd = sorted(m for _, m, _ in got[r * s:(r + 1) * s])
        # one member of each length stratum, so the round's sorted lengths
        # lie stratum by stratum
        for k, m in enumerate(rnd):
            assert strata[k][0] <= m <= strata[k][-1]


def test_prompts_are_prefix_then_turn_and_fit():
    t = traffic.Traffic(MIX, VOCAB, 11, MAX_LEN)
    for _ in range(50):
        prompt, max_new, it = t.take()
        assert prompt[:MIX["prefixes"]["tokens"]] == \
            t.prefixes[it.prefix].tolist()
        assert len(prompt) == MIX["prefixes"]["tokens"] + it.turn
        assert len(prompt) + max_new <= MAX_LEN
        assert all(0 <= x < VOCAB for x in prompt)


def test_a_second_cycle_draws_fresh_turns():
    n = MIX["pool_requests"]
    got = take(5, 2 * n)
    assert {tuple(p) for p, _, _ in got[:n]}.isdisjoint(
        {tuple(p) for p, _, _ in got[n:]})


def test_zipf_counts_and_quantiles():
    c = traffic.zipf_counts(8, 1.0, 512)
    assert c.sum() == 512 and list(c) == sorted(c, reverse=True)
    assert c[0] == pytest.approx(512 / sum(1 / k for k in range(1, 9)), abs=1)
    q = traffic.lognormal_quantiles({"median": 256, "sigma": 0.8, "min": 32,
                                     "max": 1024}, 513)
    assert q[256] == 256 and q.min() >= 32 and q.max() <= 1024
    assert np.all(np.diff(q) >= 0)


def test_a_mix_longer_than_max_len_is_refused():
    with pytest.raises(ValueError, match="max_len"):
        traffic.Traffic(MIX, VOCAB, 1, 2048)
