"""K1 (paged attention) against its roofline over the traced slice, in %:
the least time of every K1 call in the slice (decode steps at each row's
context over the distinct K/V blocks the rows read, prefill chunks over
their rows; ``roofline``) over K1's device
time in the trace."""
from perfbench import roofline

K1 = ("paged_split_kernel", "paged_combine_kernel", "paged_chunk_mma_kernel")


def read(run):
    if run.trace is None:
        return None
    spent = run.trace.seconds(K1)
    if spent <= 0:
        return None
    least = 0.0
    for t, start, end in run.prefill_calls:
        if t >= run.slice_open:
            least += roofline.least_time(*roofline.k1_chunk(run.conf, start,
                                                            end))
    for t, ctxs, kv_positions in run.decode_calls:
        if t >= run.slice_open:
            least += roofline.least_time(
                *roofline.k1_decode(run.conf, ctxs, kv_positions))
    return 100.0 * least / spent
