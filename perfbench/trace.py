"""Reading a ``torch.profiler`` trace in memory (no chrome trace file):
the device operations of a traced slice, the union of their intervals,
the longest idle gaps named by the benchmark's own host spans, and the
device time by kernel name.

Host spans are ``record_function`` ranges the runner opens around its own
loop and around the engine's calls; they share the profiler's clock with
the device events.  The device's copy of a range (a "gpu user
annotation") is left out of the operations."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

# host spans, innermost last; what the host did during an idle gap is the
# innermost span open at the gap's middle
SPANS = {
    "bench.loop": "benchmark loop (submissions, bookkeeping)",
    "bench.step": "engine.step outside the model calls (admission, "
                  "logit copy, host sampling, retire)",
    "model.prefill_chunk": "host issuing the prefill chunk's launches",
    "model.decode_paged": "host issuing the decode step's launches",
}
TOP = 10


@dataclasses.dataclass
class Summary:
    window_s: float                       # the traced slice's wall time
    busy_s: float                         # union of device intervals
    by_name: Dict[str, float]             # device seconds a name
    gaps: List[Tuple[str, float]]         # longest idle gaps, labelled

    def seconds(self, fragments) -> float:
        """Device seconds of the operations whose name holds one of
        ``fragments``."""
        return sum(s for n, s in self.by_name.items()
                   if any(f in n for f in fragments))

    def breakdown(self) -> dict:
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n, s] for n, s in top],
                "idle_gaps": [[n, s] for n, s in self.gaps[:TOP]]}


def _events(prof):
    """(device intervals [(start_us, end_us, name)], host spans [(start_us,
    end_us, name)]) of a finished profile."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.events():
        t0, t1 = e.time_range.start, e.time_range.end
        if e.name in SPANS:
            if e.device_type == DeviceType.CPU:
                host.append((t0, t1, e.name))
            continue
        if e.device_type == DeviceType.CUDA and t1 > t0:
            dev.append((t0, t1, e.name))
    return dev, host


def summarize(prof) -> Summary:
    dev, host = _events(prof)
    loops = [(a, b) for a, b, n in host if n == "bench.loop"]
    if not loops:
        raise RuntimeError("the traced slice holds no bench.loop span")
    lo, hi = min(a for a, _ in loops), max(b for _, b in loops)
    by_name: Dict[str, float] = {}
    for a, b, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e6
    merged = []
    for a, b, _ in sorted(dev):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    gaps = []
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((_label(host, (a + b) / 2), (b - a) / 1e6))
    gaps.sort(key=lambda g: -g[1])
    return Summary(window_s=(hi - lo) / 1e6, busy_s=busy / 1e6,
                   by_name=by_name, gaps=gaps)


def _label(host, t: float) -> str:
    """What the host was doing at ``t``: its innermost open span."""
    open_ = [(b - a, n) for a, b, n in host if a <= t <= b]
    if not open_:
        return "outside the benchmark's spans"
    return SPANS[min(open_)[1]]
