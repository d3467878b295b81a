"""99th percentile of every gap between consecutive tokens of one request,
over all gaps that end in the window, in ms."""
from perfbench import window


def read(run):
    gaps = window.token_gaps_s(run)
    return 1e3 * window.percentile(gaps, 99) if gaps else None
