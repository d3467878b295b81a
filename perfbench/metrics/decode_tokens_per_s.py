"""Output tokens delivered inside the window over the window's length,
which ends with the last step that started within ``--seconds``."""
from perfbench import window


def read(run):
    return window.decode_tokens_per_s(run)
