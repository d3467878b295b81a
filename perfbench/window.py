"""The window's arithmetic, on the host's clock: every rate and tail is
taken over all the work and all the time of the window, so a stall
anywhere in it moves them."""
from __future__ import annotations

from typing import List

import numpy as np


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile (linear between order statistics)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def tokens(run) -> int:
    """Output tokens delivered inside the window."""
    return sum(1 for r in run.recs for t in r.times if run.in_window(t))


def decode_tokens_per_s(run) -> float:
    """Over the window's whole steps: the step that runs past the
    requested length counts, with its time."""
    return tokens(run) / run.window_s


def ttfts_s(run) -> List[float]:
    """Submit to first token of every request submitted in the window; a
    request without a token when the window closes counts the time it has
    waited."""
    out = []
    for r in run.submitted_in_window():
        first = r.t_first
        end = first if 0 < first <= run.t_close else run.t_close
        out.append(end - r.t_submit)
    return out


def token_gaps_s(run) -> List[float]:
    """Every gap between consecutive tokens of one request that ends in
    the window."""
    return [b - a for r in run.recs for a, b in zip(r.times, r.times[1:])
            if run.in_window(b)]
