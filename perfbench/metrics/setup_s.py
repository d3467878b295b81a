"""Seconds from process start to the window's opening: imports, the card's
start, the kernel build (first run in a checkout only), the weights, the
engine and the warm-up until every client has had its first token."""


def read(run):
    return run.setup_s
