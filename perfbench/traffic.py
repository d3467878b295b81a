"""The one traffic generator: a mix's parameters (a data file under
``traffic/``) and the run's seed give the sequence of requests.

The mix fixes the sizes and their order, and the seed draws every token
id uniformly from the vocabulary: two seeds do the same work, so what a
window covers does not depend on the seed.  A mix names the published
statistics its lengths come from (``source``) and what it assumes.
Lengths are the quantiles of their lognormal (not draws), user turns are
paired with outputs by a permutation fixed by the mix, and prefixes are
dealt out in the Zipf proportions.  The pool is ordered in rounds that
each hold one request of every output-length stratum, so any stretch of
whole rounds has the pool's length distribution.
"""
from __future__ import annotations

import dataclasses
from statistics import NormalDist
from typing import List

import numpy as np

# stream tags: the prefix tokens and each request's tokens come from
# independent streams of the run's seed, the orders from the mix's
_PREFIX, _ORDER, _REQUEST = 1, 2, 3
# the mix's own seed, which fixes its pairings and orders
MIX_SEED = 0


@dataclasses.dataclass(frozen=True)
class Item:
    """One request of the pool: which prefix, how long a user turn, how
    many tokens to generate."""
    prefix: int
    turn: int
    max_new: int


def lognormal_quantiles(spec: dict, n: int) -> np.ndarray:
    """``n`` lengths at the quantiles (i + 0.5) / n of a lognormal with
    ``spec``'s median and sigma, rounded and clipped to [min, max]."""
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    vals = np.round(spec["median"] * np.exp(spec["sigma"] * z))
    return np.clip(vals, spec["min"], spec["max"]).astype(np.int64)


def zipf_counts(count: int, exponent: float, n: int) -> np.ndarray:
    """How many of ``n`` requests each of ``count`` prefixes gets under Zipf
    with ``exponent`` (largest remainders first, so they sum to n)."""
    w = 1.0 / np.arange(1, count + 1) ** exponent
    share = w / w.sum() * n
    c = np.floor(share).astype(np.int64)
    for i in np.argsort(-(share - c), kind="stable")[:n - c.sum()]:
        c[i] += 1
    return c


def pool(mix: dict) -> List[Item]:
    """The mix's pool, sorted by output length (the strata are runs of
    equal size in this order).  The same for every seed."""
    n = int(mix["pool_requests"])
    turns = lognormal_quantiles(mix["user_turn"], n)
    outs = lognormal_quantiles(mix["output"], n)
    fixed = np.random.default_rng(MIX_SEED)
    turns = turns[fixed.permutation(n)]
    pre = mix["prefixes"]
    prefix_ids = np.repeat(np.arange(pre["count"]),
                           zipf_counts(pre["count"], pre["zipf_exponent"], n))
    prefix_ids = prefix_ids[fixed.permutation(n)]
    return [Item(int(p), int(t), int(o))
            for p, t, o in zip(prefix_ids, turns, outs)]


def strata(mix: dict) -> int:
    """Strata a round holds one request of (a round is that many requests)."""
    return int(mix.get("strata", 32))


def longest_prompt(mix: dict) -> int:
    return mix["prefixes"]["tokens"] + mix["user_turn"]["max"]


class Traffic:
    """The run's request sequence: ``take()`` gives the next (prompt,
    max_new) in the mix's order, without end (a pool used up starts again
    in a new order, with fresh token ids)."""

    def __init__(self, mix: dict, vocab: int, seed: int, max_len: int):
        if longest_prompt(mix) + mix["output"]["max"] > max_len:
            raise ValueError(
                f"traffic {mix['name']!r}: the longest request "
                f"({longest_prompt(mix)} + {mix['output']['max']} tokens) "
                f"does not fit the configuration's max_len {max_len}")
        self.mix, self.vocab, self.seed = mix, vocab, int(seed)
        self.items = pool(mix)
        n, s = len(self.items), strata(mix)
        if n % s:
            raise ValueError(f"traffic {mix['name']!r}: pool_requests {n} "
                             f"is not a multiple of strata {s}")
        pre = mix["prefixes"]
        rng = np.random.default_rng([self.seed, _PREFIX])
        self.prefixes = rng.integers(0, vocab, (pre["count"], pre["tokens"]),
                                     dtype=np.int64)
        self.taken = 0
        self._order: List[int] = []

    def _cycle_order(self, cycle: int) -> List[int]:
        """Pool indices in the order of ``cycle``: rounds of one request a
        stratum (strata are consecutive runs of the length-sorted pool),
        each stratum's members and each round's order shuffled by the
        mix's seed."""
        n, s = len(self.items), strata(self.mix)
        per = n // s
        rng = np.random.default_rng([MIX_SEED, _ORDER, cycle])
        members = [rng.permutation(per) + k * per for k in range(s)]
        out: List[int] = []
        for r in range(per):
            out += [int(members[k][r]) for k in rng.permutation(s)]
        return out

    def take(self):
        """(prompt token ids, max_new, the pool item) of the next request."""
        k = self.taken
        n = len(self.items)
        if k % n == 0:
            self._order = self._cycle_order(k // n)
        item = self.items[self._order[k % n]]
        self.taken += 1
        rng = np.random.default_rng([self.seed, _REQUEST, k])
        turn = rng.integers(0, self.vocab, item.turn, dtype=np.int64)
        prompt = np.concatenate([self.prefixes[item.prefix], turn])
        return prompt.tolist(), item.max_new, item
