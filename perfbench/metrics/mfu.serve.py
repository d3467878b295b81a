"""Model FLOPs of the window's prefill and decode tokens over the window
times the bf16 peak, in %: each prefilled position and each decoded token
at its own context, the head only where a token is delivered
(``roofline``)."""
from perfbench import roofline


def read(run):
    if not run.prefill_calls and not run.decode_calls:
        return None
    conf = run.conf
    flops = sum(roofline.prefill_flops(conf, s, e)
                for t, s, e in run.prefill_calls if run.in_window(t))
    head = roofline.head_flops(conf)
    for r in run.recs:
        for i, t in enumerate(r.times):
            if run.in_window(t):
                flops += head
                if i:
                    flops += roofline.token_flops(conf, r.prompt_len + i)
    return 100.0 * flops / (run.window_s * roofline.PEAK_BF16_FLOPS)
