"""Deterministic synthetic-corpus data pipeline (a copy of
``src/repro/train/data.py``: numpy only, so its batches are bitwise the JAX
package's; the trainer moves them to its device).

Produces sharded token batches with background prefetch.  The "corpus" is a
seeded Zipfian token stream with injected n-gram structure so that a trained
LM's loss actually decreases (pure-uniform tokens have no learnable signal).
Determinism is keyed on (seed, step) so restarts resume mid-epoch exactly —
the trainer's checkpoint only needs the step counter.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


class TokenPipeline:
    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, family: str = "dense", d_model: int = 0,
                 prefetch: int = 2):
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.family = family
        self.d_model = d_model
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- synthetic corpus ----------------------------------------------------
    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        b, s, v = self.global_batch, self.seq_len, self.vocab
        # Zipf-ish marginal + strong bigram structure: tok[t+1] ~ f(tok[t])
        base = rng.zipf(1.3, size=(b, s)).astype(np.int64) % (v - 2) + 1
        shift = (base * 31 + 7) % (v - 2) + 1
        mask = rng.random((b, s)) < 0.7
        toks = base.copy()
        toks[:, 1:][mask[:, 1:]] = shift[:, :-1][mask[:, 1:]]
        tokens = toks.astype(np.int32)
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = 0
        batch = {"tokens": tokens, "labels": labels}
        if self.family == "vlm":
            emb = rng.standard_normal((b, s, self.d_model), dtype=np.float32) * 0.02
            pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None, None],
                                  (3, b, s)).copy()
            batch = {"embeds": emb, "positions": pos, "labels": labels}
        elif self.family == "audio":
            frames = rng.standard_normal((b, s, self.d_model),
                                         dtype=np.float32) * 0.02
            batch = {"frames": frames, "tokens": tokens, "labels": labels}
        return batch

    # -- prefetch ------------------------------------------------------------
    def start(self, start_step: int = 0):
        def worker():
            step = start_step
            while not self._stop.is_set():
                try:
                    self._q.put((step, self.batch_at(step)), timeout=0.5)
                    step += 1
                except queue.Full:
                    continue
        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)

    def __iter__(self) -> Iterator:
        while True:
            yield self._q.get()
