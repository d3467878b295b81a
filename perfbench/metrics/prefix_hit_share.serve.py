"""Share of the prompt tokens the window admitted that the prefix cache
served (the engine's ``re_prefill_avoided`` against that plus its
``prefill_tokens``, both over the window), in %."""


def read(run):
    c0, c1 = run.counters_open, run.counters_close
    avoided = c1["re_prefill_avoided"] - c0["re_prefill_avoided"]
    run_ = c1["prefill_tokens"] - c0["prefill_tokens"]
    return 100.0 * avoided / (avoided + run_) if avoided + run_ else None
