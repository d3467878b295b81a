"""Decode rows an engine step over the window: the engine's own counters
of decode tokens and steps, read at the window's edges."""


def read(run):
    steps = run.counters_close["steps"] - run.counters_open["steps"]
    toks = run.counters_close["decode_tokens"] \
        - run.counters_open["decode_tokens"]
    return toks / steps if steps else None
