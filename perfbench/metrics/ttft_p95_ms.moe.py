"""95th percentile of submit-to-first-token over every request submitted
in the window (one still waiting at the close counts its wait), in ms: a
reading of the engine's admission and prefill queue.  The MoE cell
submits too few requests in a window (about 30) for a tail that decides a
change, so it is read here and not bounded."""
from perfbench import window


def read(run):
    t = window.ttfts_s(run)
    return 1e3 * window.percentile(t, 95) if t else None
