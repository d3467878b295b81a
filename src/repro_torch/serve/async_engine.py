"""Asyncio front-end over ``ServeEngine`` (the port of
``src/repro/serve/async_engine.py``): submit/cancel/stream decoupled from
the engine's step loop.

``ServeEngine`` is a closed-loop batch harness — ``run_until_done()`` owns
the caller's thread until every request retires.  Production traffic is the
opposite shape: concurrent requests arriving at arbitrary times, each
wanting its tokens the moment they are sampled.  ``AsyncServeEngine``
bridges the two:

  * a **background stepper thread** owns the engine exclusively and drives
    ``step()`` continuously (the engine is not thread-safe; nothing else may
    touch it).  When the engine drains, the thread parks on an event with a
    ``REPRO_GATEWAY_IDLE_MS`` timeout so an idle gateway burns no CPU and a
    fresh submit wakes it immediately;
  * callers talk to the stepper through a lock-guarded **command inbox**
    (submit/cancel are O(1) appends — never blocked behind a decode step);
  * tokens flow the other way through per-request ``asyncio.Queue``s: the
    engine's ``Request.on_token`` hook fires inside the step loop and the
    stepper forwards each token onto the caller's event loop with
    ``call_soon_threadsafe``, so SSE bytes leave the process while the next
    decode step is still running.

Determinism carries over from the engine: sampling is keyed on (seed, token
index), so a stream is byte-identical to what ``run_until_done()`` would
have produced for the same request — ``tests/test_torch_async_engine.py``
holds the two against each other.  Under legacy drop-and-restart preemption
(``REPRO_KV_SWAP=0``) a replayed request re-fires ``on_token`` for indices
already delivered; the stepper dedupes on index so consumers never see a
duplicate.

PyTorch keeps grad mode and the current CUDA device per thread, so the
stepper sets its own: it runs the engine under ``torch.no_grad()`` (the
kernel wrappers refuse grad-requiring inputs when grad mode is on) with the
engine's device current, whatever the thread that built the engine had set.

On a serve mesh this runs on rank 0 only, over rank 0's engine: its
``step_guarded`` carries every submit and cancel to the other ranks, which
replay the steps in ``serve.engine.follow_all`` and run no stepper and no
HTTP.  The engines of several async engines on one mesh take their steps
one at a time (``serve.engine.MESH_LOCK``), and ``stop()`` closes the
engine, which releases the other ranks from following it.
"""
from __future__ import annotations

import asyncio
import contextlib
import itertools
import sys
import threading
from collections import deque
from typing import AsyncIterator, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.perf import perf
from repro_torch.serve.engine import (GREEDY, Request, SamplingParams,
                                      ServeEngine)

# terminal queue item kinds (first tuple element)
TOKEN = "token"
DONE = "done"


class TokenStream:
    """One request's live token feed: ``async for token in stream``.

    ``finish_reason`` is set once the stream is exhausted: ``"length"``
    (ran to max_new / max_len), ``"cancelled"``, ``"rejected"`` (with
    ``reject_reason``), or ``"shutdown"`` when the engine stopped underneath
    the request.
    """

    def __init__(self, rid: int, req: Request,
                 queue: "asyncio.Queue[Tuple[str, object]]"):
        self.rid = rid
        self.req = req
        self.queue = queue
        self.finish_reason: str = ""
        # stepper-thread-side state: tokens forwarded so far (dedupe index
        # for legacy-preemption replays); touched only by the stepper.
        self.delivered = 0

    def __aiter__(self) -> AsyncIterator[int]:
        return self

    async def __anext__(self) -> int:
        if self.finish_reason:
            raise StopAsyncIteration
        kind, payload = await self.queue.get()
        if kind == DONE:
            self.finish_reason = str(payload)
            raise StopAsyncIteration
        return int(payload)  # kind == TOKEN

    async def drain(self) -> List[int]:
        """Collect the rest of the stream (non-streaming completions)."""
        toks = [t async for t in self]
        return toks


class AsyncServeEngine:
    """Async multiplexer over one ``ServeEngine``.

    Lifecycle: ``await start()`` binds the running event loop and spawns the
    stepper thread; ``submit()`` returns a ``TokenStream`` immediately;
    ``await stop()`` finishes the stepper (in-flight streams are terminated
    with ``finish_reason="shutdown"``).  One instance serves many concurrent
    callers on the same loop — the engine's continuous batching is what
    interleaves them.
    """

    def __init__(self, engine: ServeEngine, model_id: str = "model",
                 idle_s: Optional[float] = None):
        self.engine = engine
        self.model_id = model_id
        self.idle_s = (perf().gateway_idle_ms / 1e3) if idle_s is None \
            else idle_s
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._inbox: deque = deque()          # (kind, payload) commands
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stopping = False
        self._rids = itertools.count()
        # live streams, keyed by rid; owned by the stepper thread except for
        # the read in ``stats`` (len is atomic enough for a gauge)
        self._live: Dict[int, TokenStream] = {}
        # what killed the stepper thread, if an exception escaped the
        # engine's own crash isolation (its streams then end "shutdown")
        self.fault: Optional[str] = None

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> "AsyncServeEngine":
        assert self._thread is None, "start() called twice"
        self._loop = asyncio.get_running_loop()
        self._thread = threading.Thread(
            target=self._stepper, name=f"stepper-{self.model_id}",
            daemon=True)
        self._thread.start()
        return self

    async def stop(self) -> None:
        """Terminate the stepper; live streams get ``finish_reason=
        "shutdown"``.  Idempotent."""
        if self._thread is None:
            return
        self._stopping = True
        self._wake.set()
        await asyncio.get_running_loop().run_in_executor(
            None, self._thread.join)
        self._thread = None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # -- request API (event-loop side) -------------------------------------
    def submit(self, prompt: Sequence[int], max_new: int = 16,
               sampling: SamplingParams = GREEDY,
               deadline_ms: Optional[float] = None,
               adapter_id: Optional[str] = None) -> TokenStream:
        """Enqueue a generation; returns its ``TokenStream`` immediately.
        The request enters the engine's admission queue at the stepper's
        next iteration — this call never waits on a decode step.

        After ``stop()`` (or a dead stepper thread) the inbox would never
        drain, so the stream terminates immediately with
        ``finish_reason="shutdown"`` instead of hanging its consumer."""
        assert self._loop is not None, "submit() before start()"
        rid = next(self._rids)
        req = Request(rid=rid, prompt=list(prompt), max_new=max_new,
                      sampling=sampling, deadline_ms=deadline_ms,
                      adapter_id=adapter_id)
        stream = TokenStream(rid, req, asyncio.Queue())
        if self._stopping or not self.running:
            # called on the event loop thread: enqueue the terminal directly
            stream.queue.put_nowait((DONE, "shutdown"))
            return stream
        with self._lock:
            self._inbox.append(("submit", stream))
        self._wake.set()
        return stream

    def cancel(self, rid: int) -> None:
        """Abort ``rid`` mid-stream; its KV blocks are freed inside the
        stepper's next iteration and its stream ends with
        ``finish_reason="cancelled"``."""
        with self._lock:
            self._inbox.append(("cancel", rid))
        self._wake.set()

    async def generate(self, prompt: Sequence[int], max_new: int = 16,
                       sampling: SamplingParams = GREEDY,
                       deadline_ms: Optional[float] = None,
                       adapter_id: Optional[str] = None) -> List[int]:
        """Submit and await the full output (the non-streaming path)."""
        return await self.submit(prompt, max_new, sampling,
                                 deadline_ms=deadline_ms,
                                 adapter_id=adapter_id).drain()

    def stats(self) -> Dict[str, object]:
        eng = self.engine
        return {
            "model": self.model_id,
            "live_requests": len(self._live),
            "queued": len(eng.queue),
            "running": self.running,
            "degraded": eng.degraded,
            "step_crashes": eng._step_crashes,
            "requests_errored": len(eng.errored),
            "requests_expired": len(eng.expired),
            "requests_shed": len(eng.shed) + eng._gateway_shed,
            "pool_blocks_used": eng.pool.num_used,
            "pool_blocks": eng.pool.usable_blocks,
            "engine_steps": eng.steps,
        }

    # -- stepper thread ----------------------------------------------------
    def _emit(self, stream: TokenStream, item: Tuple[str, object]) -> None:
        """Forward one queue item onto the caller's event loop.  A closed
        loop (interpreter teardown mid-stream) drops the item — the consumer
        is gone with it."""
        try:
            self._loop.call_soon_threadsafe(stream.queue.put_nowait, item)
        except RuntimeError:
            pass

    def _register(self, stream: TokenStream) -> None:
        """Wire the engine hooks for one request and hand it to the engine.
        Runs on the stepper thread, so the hooks it installs only ever fire
        on this thread too."""
        req = stream.req

        def on_token(tok: int, idx: int) -> None:
            if idx < stream.delivered:
                return              # legacy-preemption replay; already sent
            stream.delivered = idx + 1
            self._emit(stream, (TOKEN, tok))

        def on_finish(r: Request) -> None:
            reason = r.finish_reason or "length"
            if r.rejected and r.reject_reason:
                reason = f"rejected: {r.reject_reason}"
            self._emit(stream, (DONE, reason))
            self._live.pop(stream.rid, None)

        req.on_token = on_token
        req.on_finish = on_finish
        self._live[stream.rid] = stream
        self.engine.submit(req)

    def _drain_inbox(self) -> None:
        with self._lock:
            cmds = list(self._inbox)
            self._inbox.clear()
        for kind, payload in cmds:
            if kind == "submit":
                self._register(payload)
            elif kind == "cancel":
                self.engine.cancel(payload)   # no-op if already finished

    def _stepper(self) -> None:
        # step_guarded (not raw step) is the crash-isolation boundary: an
        # exception inside the engine quarantines the poison request with
        # finish_reason="error" and the loop keeps serving everyone else.
        # The finally still runs if this thread dies some *other* way, so
        # live streams and racing submits always get a terminal event.
        dev = self.engine.device
        on_card = torch.cuda.device(dev) if dev.type == "cuda" \
            else contextlib.nullcontext()
        try:
            with torch.no_grad(), on_card:
                while True:
                    self._drain_inbox()
                    if self._stopping:
                        break
                    worked = self.engine.step_guarded()
                    if not worked:
                        # drained: park until a submit/cancel/stop wakes us
                        # (the timeout covers a race where work arrived
                        # after step()).  On a mesh each idle poll is one
                        # broadcast and one digest gather, so the other
                        # ranks, waiting in the next broadcast, hear from
                        # rank 0 every idle_s, well inside the collective
                        # timeout
                        self._wake.wait(self.idle_s)
                        self._wake.clear()
                # on a mesh: release the other ranks from this engine
                self.engine.close()
        except BaseException as e:
            self.fault = f"{type(e).__name__}: {e}"
            print(f"async-engine {self.model_id}: stepper thread died: "
                  f"{self.fault}", file=sys.stderr)
            raise
        finally:
            # terminate whatever was still in flight so consumers unblock —
            # including submits that raced into the inbox after the last
            # drain (their streams were never registered with the engine)
            with self._lock:
                cmds = list(self._inbox)
                self._inbox.clear()
            for kind, payload in cmds:
                if kind == "submit":
                    self._emit(payload, (DONE, "shutdown"))
            for stream in list(self._live.values()):
                self._emit(stream, (DONE, "shutdown"))
            self._live.clear()
