"""How ``correct`` is decided for a served model.

During the run every model call's logits are reduced on the device
(``Capture``): each row's four best logits and its logits at a fixed set of
token ids drawn from the seed.  Once the window has closed, a sample of
the requests it finished, drawn from the seed with the longest among
them, is run through the plain reference: each prompt with its served
tokens, teacher-forced.  Two numbers are compared:

- ``served_not_best``: served tokens that are not the best of the
  program's own logits at their position (exact: limit 0).  A token
  altered where it is produced reads here.
- ``logit_err_worst``: at each served position the root mean square,
  over the id set, of the program's logits less the reference's; the
  median over each request's positions; the largest of the sample's
  requests.  A computation in a lower precision, a stale or wrong cache,
  a skipped layer read here, and so does a fault in some rows of the
  batch alone, unless no sampled request sat in those rows (for half the
  rows, a chance of one in 2 ** the sample's size).

The widest gap of a served token's reference logit below the reference's
best is reported beside them, not compared.  The control
(``served_readings(..., control=True)``) puts the reference in fp8 in the
program's place: its logits at the same positions, reduced as ``Capture``
reduces the program's, each position's token the one it puts first, go
through the same comparison, so the same checks judge it."""
from __future__ import annotations

import bisect
import random
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

TOP = 4
# seed-stream tag of the compared id set
_IDS = 4


class Capture:
    """The program's logits at every model call, reduced on the device as
    they come (no copy to the host inside the window): each row's ``TOP``
    best values and ids, and its values at ``n_ids`` token ids drawn from
    the seed."""

    def __init__(self, vocab: int, n_ids: int, seed: int, device):
        rng = np.random.default_rng([int(seed), _IDS])
        self.ids = torch.as_tensor(
            np.sort(rng.choice(vocab, n_ids, replace=False)), device=device)
        self.prefill: list = []   # (t, start, end, tokens, topv, topi, sub)
        self.decode: list = []    # (t, seq_lens, tokens, topv, topi, sub)

    def _reduce(self, logits: torch.Tensor):
        v, i = torch.topk(logits, TOP, dim=-1)
        return v, i, logits.index_select(-1, self.ids)

    def on_prefill(self, start, end, tokens, logits) -> None:
        self.prefill.append((time.monotonic(), start, end, tokens[0],
                             *self._reduce(logits[0])))

    def on_decode(self, seq_lens, tokens, logits) -> None:
        self.decode.append((time.monotonic(), seq_lens, tokens[:, 0],
                            *self._reduce(logits)))

    def to_host(self) -> None:
        def host(x):
            return x.float().cpu() if isinstance(x, torch.Tensor) else x
        self.prefill = [tuple(host(x) for x in c) for c in self.prefill]
        self.decode = [tuple(host(x) for x in c) for c in self.decode]

    def rows(self, rec) -> List[Optional[tuple]]:
        """(best values, best ids, values at the id set) of the program's
        logits that chose each served token of ``rec``: the first from the
        prefill chunk that ended its prompt, each later one from the
        decode call before it, in the row at its position whose input is
        the token before; None where no row or several match."""
        out = []
        plen = rec.prompt_len
        pt = [c[0] for c in self.prefill]
        dt = [c[0] for c in self.decode]
        for k, t in enumerate(rec.times[:len(rec.out)]):
            if k == 0:
                j = bisect.bisect_left(pt, t) - 1
                hit = None
                while j >= 0 and hit is None:
                    _, start, end, toks, v, i, sub = self.prefill[j]
                    if end == plen and int(toks[plen - 1 - start]) \
                            == rec.prompt[-1]:
                        r = plen - 1 - start
                        hit = (v[r], i[r], sub[r])
                    j -= 1
                out.append(hit)
                continue
            j = bisect.bisect_left(dt, t) - 1
            if j < 0:
                out.append(None)
                continue
            _, lens, toks, v, i, sub = self.decode[j]
            match = ((lens == plen + k - 1) & (toks == rec.out[k - 1])) \
                .nonzero()[:, 0]
            out.append((v[match[0]], i[match[0]], sub[match[0]])
                       if len(match) == 1 else None)
        return out


def sample(finished: Sequence, n: int, seed: int) -> List:
    """The longest finished request (prompt and served tokens) and n - 1
    more drawn with the seed, longest first."""
    if not finished:
        return []
    ranked = sorted(finished, key=lambda r: -(r.prompt_len + len(r.out)))
    rest = ranked[1:]
    rng = random.Random(int(seed))
    return [ranked[0]] + rng.sample(rest, min(n - 1, len(rest)))


def _sequences(picked):
    """Reference inputs: each prompt and its served tokens but the last,
    and the positions whose logits chose a served token (the prompt's
    last, then each served token's but the last)."""
    seqs = [list(r.prompt) + list(r.out[:-1]) for r in picked]
    pos = [list(range(r.prompt_len - 1, r.prompt_len - 1 + len(r.out)))
           for r in picked]
    return seqs, pos


def _gaps(logits, tokens) -> tuple:
    """(widest gap below the reference's best over ``tokens``, positions
    where it is not the best)."""
    widest, off = 0.0, 0
    for lg, toks in zip(logits, tokens):
        t = torch.as_tensor(toks, dtype=torch.long, device=lg.device)
        gap = lg.max(-1).values - lg.gather(1, t[:, None])[:, 0]
        widest = max(widest, float(gap.max()))
        off += int((gap > 0).sum())
    return widest, off


def _compare(ref, rows, tokens, ids) -> Dict[str, float]:
    """The compared numbers of rows (best values, best ids, values at the
    id set; None where no captured row matched) that chose ``tokens``,
    against the reference's logits ``ref``, one list a request."""
    errs, medians, not_best, unmatched = [], [], 0, 0
    for lg, rr, toks in zip(ref, rows, tokens):
        mine = []
        for k, row in enumerate(rr):
            if row is None:
                unmatched += 1
                continue
            v, i, sub = row
            best = {int(x) for x, y in zip(i, v) if y == v[0]}
            not_best += toks[k] not in best
            d = sub.to(lg.device) - lg[k, ids]
            mine.append(float(d.square().mean().sqrt()))
        if mine:
            medians.append(float(np.median(mine)))
        errs += mine
    widest, off = _gaps(ref, tokens)
    return {"served_not_best": not_best, "served_unmatched": unmatched,
            "logit_err_worst": max(medians) if medians else None,
            "logit_err_median": float(np.median(errs)) if errs else None,
            "logit_err_max": max(errs) if errs else None,
            "served_tokens": sum(len(t) for t in tokens),
            "max_logit_gap": widest, "served_not_ref_best": off}


def served_readings(reference, conf: dict, params, picked,
                    capture: Capture, control: bool = False
                    ) -> Dict[str, float]:
    """The compared numbers of the sample (see the module's docstring),
    with what stands beside them: positions compared, positions no
    captured row matched, the widest reference gap.  With ``control`` the
    fp8 reference is judged in the program's place, and the program's own
    ``logit_err_worst`` on the same sample stands beside it."""
    seqs, pos = _sequences(picked)
    ref = reference.logits_at(conf, params, seqs, pos)
    ids = capture.ids.to(ref[0].device)
    rows = [capture.rows(r) for r in picked]
    got = _compare(ref, rows, [list(r.out) for r in picked], ids)
    if not control:
        return got
    ctl = reference.logits_at(conf, params, seqs, pos, precision="fp8")
    rows = [list(zip(*torch.topk(c, TOP, dim=-1), c[:, ids])) for c in ctl]
    tokens = [[int(i[0]) for _, i, _ in rr] for rr in rows]
    out = _compare(ref, rows, tokens, ids)
    out["program_logit_err_worst"] = got["logit_err_worst"]
    return out
