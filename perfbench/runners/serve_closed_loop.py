"""Serving runner: a closed loop of clients over the port's serve engine.

Each client sends its next request when its previous one finishes, so as
many requests are in flight as there are clients (``clients_per_slot``
times the engine's ``max_batch``).  The runner submits, calls
``engine.step()`` and reads each token as the engine's ``on_token`` hook
hands it over, on the host's monotonic clock.

Set-up runs from process start until every client has had its first
token: the window then opens on a full batch with the prefixes
registered.  The window takes every engine step that starts within
``seconds`` of its opening and closes, on the clock, when the last of
them has ended, so a rate is taken over whole steps and all their time;
with ``trace`` its last ``trace_slice.seconds`` run under
``torch.profiler``, with host spans
around the loop and the engine's two model calls.  After the window the
peak memory is read, the engine is freed and the served tokens of a
sample of finished requests are held against the plain reference."""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from typing import List, Optional

import torch

from perfbench import correct, roofline, traffic


@dataclasses.dataclass
class Rec:
    """One request as the benchmark saw it."""
    client: int
    prompt: List[int]
    prompt_len: int
    max_new: int
    t_submit: float = 0.0
    times: List[float] = dataclasses.field(default_factory=list)
    t_done: float = 0.0
    status: str = ""
    out: List[int] = dataclasses.field(default_factory=list)

    @property
    def t_first(self) -> float:
        return self.times[0] if self.times else 0.0


@dataclasses.dataclass
class Run:
    """What a serving run recorded, for the metric readers."""
    conf: dict
    mix: dict
    seconds: float
    setup_s: float = 0.0
    t_open: float = 0.0
    t_close: float = 0.0
    recs: List[Rec] = dataclasses.field(default_factory=list)
    counters_open: dict = dataclasses.field(default_factory=dict)
    counters_close: dict = dataclasses.field(default_factory=dict)
    # traced runs: the engine's calls in the window, (t, start, end) and
    # (t, contexts of the rows, K/V positions of the distinct blocks read)
    prefill_calls: list = dataclasses.field(default_factory=list)
    decode_calls: list = dataclasses.field(default_factory=list)
    slice_open: float = 0.0
    trace: Optional[object] = None
    memory_peak_bytes: int = 0
    checks: dict = dataclasses.field(default_factory=dict)
    info: dict = dataclasses.field(default_factory=dict)

    @property
    def window_s(self) -> float:
        """From the opening to the end of the last step that started
        within ``seconds`` of it."""
        return self.t_close - self.t_open

    def in_window(self, t: float) -> bool:
        return self.t_open < t <= self.t_close

    def submitted_in_window(self) -> List[Rec]:
        return [r for r in self.recs if self.in_window(r.t_submit)]


def _counters(engine) -> dict:
    m = engine.metrics()
    return {"steps": engine.steps, "decode_tokens": m.decode_tokens,
            "prefill_tokens": m.prefill_tokens,
            "re_prefill_avoided": m.re_prefill_avoided,
            "preemptions": m.preemptions}


def run(cell) -> Run:
    """Set up, measure the window and check the sample (see the module's
    docstring).  ``cell`` carries the configuration, the mix, the seed,
    the window length, whether to trace, the device and the program and
    reference modules."""
    prog, conf, mix = cell.program, cell.conf, cell.mix
    dev = torch.device(cell.device)
    cuda = dev.type == "cuda"
    if cuda:
        prog.build_kernels()
    cfg = prog.model_config(conf)
    params = prog.make_weights(cfg, cell.seed, dev, conf["weights"])
    serve = conf["serve"]
    engine = prog.make_engine(cfg, params, serve)
    feed = traffic.Traffic(mix, conf["vocab_size"], cell.seed,
                           serve["max_len"])
    out = Run(conf=conf, mix=mix, seconds=cell.seconds)
    clients = int(mix["clients_per_slot"]) * serve["max_batch"]

    done: List[int] = []
    tracing = [False]

    def span(name):
        if tracing[0]:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def submit(client: int) -> None:
        prompt, max_new, _ = feed.take()
        rec = Rec(client=client, prompt=prompt, prompt_len=len(prompt),
                  max_new=max_new)

        def on_token(tok, idx, rec=rec):
            rec.times.append(time.monotonic())

        def on_finish(req, rec=rec):
            rec.t_done = time.monotonic()
            rec.status = req.finish_reason
            rec.out = req.out
            done.append(rec.client)

        req = prog.request(len(out.recs), prompt, max_new, on_token,
                           on_finish)
        out.recs.append(rec)
        engine.submit(req)
        rec.t_submit = req.t_submit

    capture = correct.Capture(conf["vocab_size"],
                              int(mix["correct_sample"]["logit_ids"]),
                              cell.seed, dev)

    def observe_prefill(start, end, tokens, logits):
        capture.on_prefill(start, end, tokens, logits)
        if cell.trace:
            out.prefill_calls.append((time.monotonic(), start, end))

    def observe_decode(seq_lens, block_tables, tokens, logits):
        capture.on_decode(seq_lens, tokens, logits)
        if cell.trace:
            out.decode_calls.append((time.monotonic(), seq_lens,
                                     block_tables))

    prog.observe_model_calls(engine, observe_prefill, observe_decode)

    def loop_once():
        with span("bench.loop"):
            pending = done[:]
            done.clear()
            for c in pending:
                submit(c)
            with span("bench.step"):
                engine.step()

    # set-up: the first request of every client, until each has a token
    for c in range(clients):
        submit(c)
    first = list(out.recs)
    prof = None
    while not all(r.times for r in first):
        loop_once()
        if cell.trace and prof is None and cuda:
            # start the profiler once in set-up, so the traced slice does
            # not pay CUPTI's first start
            prof = _profiler()
            prof.start()
            loop_once()
            prof.stop()
    if cuda:
        torch.cuda.synchronize()
    out.t_open = time.monotonic()
    out.setup_s = out.t_open - cell.t_start
    out.counters_open = _counters(engine)
    out.prefill_calls.clear()
    out.decode_calls.clear()

    # the window
    t_due = out.t_open + cell.seconds
    slice_s = min(float(mix["trace_slice"]["seconds"]), cell.seconds / 2)
    prof = None
    while True:
        now = time.monotonic()
        if now >= t_due:
            break
        if cell.trace and prof is None and now >= t_due - slice_s:
            prof = _profiler(cuda)
            prof.start()
            tracing[0] = True
            out.slice_open = now
        loop_once()
    if cuda:
        torch.cuda.synchronize()
    out.t_close = time.monotonic()
    if prof is not None:
        tracing[0] = False
        prof.stop()
    out.counters_close = _counters(engine)
    out.info.update(_held(conf, engine, params))
    out.memory_peak_bytes = torch.cuda.max_memory_allocated(dev) if cuda \
        else 0
    out.checks["kv_invariant_violations"] = (
        prog.kv_invariant_violations(engine), 0)
    out.decode_calls = [_decode_call(t, lens, tables, serve["block_size"])
                        for t, lens, tables in out.decode_calls]
    capture.to_host()
    if prof is not None:
        from perfbench.trace import summarize
        out.trace = summarize(prof)
        del prof

    # the comparison, once the engine's state is freed
    finished = [r for r in out.recs
                if r.status == "length" and out.in_window(r.t_done)]
    picked = correct.sample(finished, int(mix["correct_sample"]["requests"]),
                            cell.seed)
    del engine, feed
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    lim = cell.limits
    failed = [r for r in out.submitted_in_window()
              if r.status not in ("", "length")]
    out.checks["failed_requests"] = (len(failed), 0)
    short = [r for r in picked if len(r.out) != r.max_new]
    out.checks["short_answers"] = (len(short), 0)
    if not picked:
        out.checks["sample_missing"] = (1, 0)
        return out
    got = correct.served_readings(cell.reference, conf, params, picked,
                                  capture, control=cell.control)
    out.checks["served_not_best"] = (got.pop("served_not_best"), 0)
    out.checks["served_unmatched"] = (got.pop("served_unmatched"), 0)
    out.checks["logit_err_worst"] = (got.pop("logit_err_worst"),
                                     lim["logit_err_worst"]["limit"])
    out.info.update(got, sampled_requests=len(picked))
    return out


def _held(conf: dict, engine, params) -> dict:
    """What the run held on the card beside its peak: the weights' bytes,
    and the K/V blocks in use at their most (the engine's
    ``peak_blocks_used``) with their bytes at the configuration's
    widths."""
    g = roofline.dims(conf)
    block = 2 * g["layers"] * conf["serve"]["block_size"] * g["kv"] \
        * g["hd"] * roofline.BF16
    peak = int(engine.metrics().peak_blocks_used)
    leaves, seen = [], set()

    def walk(t):
        if isinstance(t, (dict, list)):
            for v in (t.values() if isinstance(t, dict) else t):
                walk(v)
        elif isinstance(t, torch.Tensor):
            base = t._base if t._base is not None else t
            if id(base) not in seen:
                seen.add(id(base))
                leaves.append(base.numel() * base.element_size())
    walk(params)
    return {"weights_bytes": sum(leaves), "kv_blocks_peak": peak,
            "kv_blocks_pool": int(engine.pool.num_blocks),
            "kv_bytes_peak": peak * block}


def _decode_call(t: float, seq_lens, tables, block_size: int) -> tuple:
    """(t, each row's context, the K/V positions of the distinct blocks the
    rows read): rows that share a prefix read its blocks once."""
    ctxs = [int(x) + 1 for x in seq_lens.tolist()]
    tab = tables.tolist()
    used = {}
    for c, row in zip(ctxs, tab):
        n = -(-c // block_size)
        for j, b in enumerate(row[:n]):
            fill = block_size if j < n - 1 else c - (n - 1) * block_size
            used[b] = max(used.get(b, 0), fill)
    return t, ctxs, sum(used.values())


def _profiler(cuda: bool = True):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)
