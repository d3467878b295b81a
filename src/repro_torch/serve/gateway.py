"""OpenAI-compatible HTTP gateway over ``AsyncServeEngine`` (the port of
``src/repro/serve/gateway.py``; framework-free apart from its imports, so
the port keeps its own copy, and every card, chunk and usage block has the
reference's JSON shape field for field).

The Ray-Serve-LLM split, stdlib-only: an ``LLMServer``-shaped per-model
handle (``GatewayModel`` — one engine, one tokenizer, one stepper thread)
behind an ``LLMRouter``-shaped ingress (``Router`` + ``Gateway`` — one
asyncio socket server multiplexing every model in the process).  Endpoints:

  ``GET  /v1/models``            list the router's models
  ``GET  /v1/models/{id}``       one model's card
  ``POST /v1/completions``       text completion; ``"stream": true`` for SSE
  ``POST /v1/chat/completions``  chat; same streaming contract
  ``GET  /health``               readiness + per-model stats (CI polls this)

Streaming is Server-Sent Events: one ``data: {json}`` chunk per emitted
text piece (each carries the raw ``token_ids`` it covers, an extension the
CI oracle-identity gate consumes), a final chunk bearing ``finish_reason``
and an OpenAI ``usage`` block, then the ``data: [DONE]`` terminator.  Every
response carries an ``x-request-id`` header.  Stop sequences are honoured
mid-stream: matched text is never emitted and the engine request is
**cancelled** the same moment, returning its KV blocks to the pool — the
same path a client disconnect takes.

The HTTP layer is deliberately minimal (asyncio streams, one request per
connection, ``Connection: close``): no framework dependency, and every
byte on the wire is visible in this one file.

Tokenization: the repro has no trained tokenizer, so the default
``ByteTokenizer`` maps latin-1 bytes onto the model's vocab (reversible for
ids the encoder can produce).  ``prompt`` may also be a raw token-id list —
benchmarks and the CI gate use that form to bypass text entirely.
"""
from __future__ import annotations

import asyncio
import dataclasses
import json
import sys
import time
import uuid
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.perf import perf
from repro_torch.serve.async_engine import AsyncServeEngine, TokenStream
from repro_torch.serve.engine import SamplingParams


# ---------------------------------------------------------------------------
# Tokenization
# ---------------------------------------------------------------------------

class ByteTokenizer:
    """Latin-1 bytes <-> token ids, offset by 1 so id 0 (the engine's pad)
    is never produced by text.  Bytes beyond ``vocab - 2`` clamp (lossy only
    when the vocab is smaller than the byte range); decoding clamps back
    into latin-1 so any generated id renders as exactly one char."""

    def __init__(self, vocab: int):
        assert vocab >= 2, "vocab too small to carry any byte"
        self.vocab = vocab

    def encode(self, text: str) -> List[int]:
        data = text.encode("latin-1", errors="replace")
        return [1 + min(b, self.vocab - 2) for b in data]

    def decode(self, ids: Sequence[int]) -> str:
        return "".join(chr(min(max(int(t) - 1, 0), 255)) for t in ids)


class StopDetector:
    """Incremental stop-sequence scanner over streamed text.

    ``feed`` returns the text that is now safe to emit; it holds back up to
    ``max(len(stop)) - 1`` trailing chars so a stop sequence split across
    token boundaries is still caught before any of it escapes to the
    client.  Once ``stopped`` flips, the held text up to the match was
    returned and everything from the stop sequence on is discarded.
    """

    def __init__(self, stops: Sequence[str]):
        self.stops = [s for s in stops if s]
        self.hold = max((len(s) for s in self.stops), default=1) - 1
        self.pending = ""
        self.stopped = False

    def feed(self, piece: str) -> str:
        self.pending += piece
        for s in self.stops:
            i = self.pending.find(s)
            if i >= 0:
                self.stopped = True
                out, self.pending = self.pending[:i], ""
                return out
        if len(self.pending) > self.hold:
            cut = len(self.pending) - self.hold
            out, self.pending = self.pending[:cut], self.pending[cut:]
            return out
        return ""

    def flush(self) -> str:
        out, self.pending = self.pending, ""
        return out


# ---------------------------------------------------------------------------
# Router: multiplex several models/engines in one process
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GatewayModel:
    """One served model: the async engine plus everything the HTTP layer
    needs to speak text about it.

    ``adapters`` declares the LoRA tenants this deployment serves: clients
    address them as ``model="{model_id}:{adapter}"``, each gets its own
    ``/v1/models`` card, and the first request for one lazily loads it into
    the engine's ``AdapterStore`` (bounded by REPRO_LORA_MAX_ADAPTERS;
    undeclared adapters 404 rather than materializing arbitrary tenants)."""
    model_id: str
    async_engine: AsyncServeEngine
    tokenizer: ByteTokenizer
    adapters: List[str] = dataclasses.field(default_factory=list)
    created: int = dataclasses.field(default_factory=lambda: int(time.time()))

    @property
    def engine(self):
        return self.async_engine.engine

    def card(self) -> Dict:
        # family-agnostic: clients see which serving substrate backs the
        # model (dense/moe attention KV, ssm state slab, hybrid mixed layout)
        return {"id": self.model_id, "object": "model",
                "created": self.created, "owned_by": "repro",
                "family": self.engine.cfg.family,
                "max_model_len": self.engine.max_len,
                "adapters": list(self.adapters)}

    def adapter_card(self, name: str) -> Dict:
        return {"id": f"{self.model_id}:{name}", "object": "model",
                "created": self.created, "owned_by": "repro",
                "parent": self.model_id, "adapter": name,
                "max_model_len": self.engine.max_len,
                "loaded": self.engine.adapters.is_loaded(name)}

    def serves_adapter(self, name: str) -> bool:
        """Declared on this deployment, or already in the engine's store
        (loaded programmatically via ``ServeEngine.load_adapter``)."""
        return name in self.adapters or self.engine.adapters.known(name)


class Router:
    """Model-id -> ``GatewayModel``; the single-process stand-in for the
    Ray Serve ``LLMRouter`` deployment."""

    def __init__(self, models: Sequence[GatewayModel] = ()):
        self._models: Dict[str, GatewayModel] = {}
        for m in models:
            self.add(m)

    def add(self, model: GatewayModel) -> None:
        if model.model_id in self._models:
            raise ValueError(f"duplicate model id {model.model_id!r}")
        self._models[model.model_id] = model

    def get(self, model_id: str) -> Optional[GatewayModel]:
        return self._models.get(model_id)

    def resolve(self, model_id: Optional[str]) -> Optional[GatewayModel]:
        """Missing/empty model falls through to a sole deployed model —
        single-model gateways shouldn't force clients to know the id."""
        if model_id:
            return self.get(model_id)
        if len(self._models) == 1:
            return next(iter(self._models.values()))
        return None

    def split_adapter(self, model_id: Optional[str]
                      ) -> Tuple[Optional[str], Optional[str]]:
        """``"base:adapter"`` -> (base, adapter); plain ids pass through as
        (id, None).  An empty base (``":tenant"``) keeps the sole-model
        fallback working for adapter asks too."""
        if not model_id or ":" not in model_id:
            return model_id, None
        base, _, adapter = model_id.partition(":")
        return base or None, adapter or None

    def models(self) -> List[GatewayModel]:
        return list(self._models.values())

    async def start(self) -> None:
        for m in self.models():
            if not m.async_engine.running:
                await m.async_engine.start()

    async def stop(self) -> None:
        for m in self.models():
            await m.async_engine.stop()


# ---------------------------------------------------------------------------
# HTTP plumbing (stdlib asyncio streams; one request per connection)
# ---------------------------------------------------------------------------

class _BadRequest(Exception):
    def __init__(self, message: str, status: int = 400,
                 retry_after: Optional[int] = None):
        super().__init__(message)
        self.status = status
        # seconds for a Retry-After header (load-shed 429/503 responses)
        self.retry_after = retry_after


_STATUS = {200: "OK", 400: "Bad Request", 404: "Not Found",
           405: "Method Not Allowed", 429: "Too Many Requests",
           500: "Internal Server Error", 503: "Service Unavailable"}


async def _read_request(reader: asyncio.StreamReader
                        ) -> Optional[Tuple[str, str, Dict[str, str], bytes]]:
    line = await reader.readline()
    if not line:
        return None
    parts = line.decode("latin-1").split()
    if len(parts) < 3:
        raise _BadRequest("malformed request line")
    method, target = parts[0].upper(), parts[1]
    headers: Dict[str, str] = {}
    while True:
        h = await reader.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        key, _, val = h.decode("latin-1").partition(":")
        headers[key.strip().lower()] = val.strip()
    try:
        n = int(headers.get("content-length", "0") or "0")
    except ValueError as e:
        raise _BadRequest("bad content-length") from e
    body = await reader.readexactly(n) if n else b""
    return method, target.split("?", 1)[0], headers, body


def _headers(status: int, req_id: str, content_type: str,
             length: Optional[int] = None,
             extra: Optional[Dict[str, str]] = None) -> bytes:
    lines = [f"HTTP/1.1 {status} {_STATUS.get(status, 'OK')}",
             f"Content-Type: {content_type}",
             f"x-request-id: {req_id}",
             "Cache-Control: no-cache",
             "Connection: close"]
    for k, v in (extra or {}).items():
        lines.append(f"{k}: {v}")
    if length is not None:
        lines.append(f"Content-Length: {length}")
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


async def _send_json(writer: asyncio.StreamWriter, status: int, obj: Dict,
                     req_id: str,
                     extra: Optional[Dict[str, str]] = None) -> None:
    body = json.dumps(obj).encode("utf-8")
    writer.write(_headers(status, req_id, "application/json", len(body),
                          extra=extra))
    writer.write(body)
    await writer.drain()


def _error(message: str, err_type: str = "invalid_request_error") -> Dict:
    return {"error": {"message": message, "type": err_type,
                      "param": None, "code": None}}


async def _sse_open(writer: asyncio.StreamWriter, req_id: str) -> None:
    writer.write(_headers(200, req_id, "text/event-stream"))
    await writer.drain()


async def _sse_event(writer: asyncio.StreamWriter, obj: Union[Dict, str]
                     ) -> None:
    data = obj if isinstance(obj, str) else json.dumps(obj)
    writer.write(f"data: {data}\n\n".encode("utf-8"))
    await writer.drain()


# ---------------------------------------------------------------------------
# OpenAI request/response shaping
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Completion:
    """A parsed, validated completion ask (shared by both endpoints)."""
    model: GatewayModel
    prompt_ids: List[int]
    max_tokens: int
    sampling: SamplingParams
    stream: bool
    stops: List[str]
    echo_text: str = ""       # prompt text, for completions' echo=true
    deadline_ms: Optional[float] = None   # request "timeout" (body field,
    #                                       seconds) -> engine deadline
    adapter_id: Optional[str] = None      # LoRA tenant ("base:adapter" asks)

    @property
    def served_id(self) -> str:
        """The model id responses echo back — adapter asks keep their tag
        so a client can verify which tenant actually answered."""
        return self.model.model_id + (f":{self.adapter_id}"
                                      if self.adapter_id else "")


def _parse_prompt(model: GatewayModel, prompt) -> Tuple[List[int], str]:
    tok = model.tokenizer
    if isinstance(prompt, str):
        return tok.encode(prompt), prompt
    if isinstance(prompt, list) and prompt and \
            all(isinstance(t, int) and not isinstance(t, bool) for t in prompt):
        vocab = model.engine.cfg.vocab
        bad = [t for t in prompt if not 0 <= t < vocab]
        if bad:
            raise _BadRequest(f"prompt token id(s) {bad[:3]} outside "
                              f"vocab [0, {vocab})")
        return list(prompt), tok.decode(prompt)
    raise _BadRequest("prompt must be a string or a flat list of token ids")


def _parse_body(router: Router, body: bytes, chat: bool) -> _Completion:
    try:
        d = json.loads(body.decode("utf-8") or "{}")
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise _BadRequest(f"body is not valid JSON: {e}") from e
    if not isinstance(d, dict):
        raise _BadRequest("body must be a JSON object")
    base_id, adapter_id = router.split_adapter(d.get("model"))
    model = router.resolve(base_id)
    if model is None:
        known = ", ".join(m.model_id for m in router.models()) or "none"
        raise _BadRequest(f"model {d.get('model')!r} not found "
                          f"(deployed: {known})", status=404)
    if adapter_id is not None and not model.serves_adapter(adapter_id):
        declared = ", ".join(model.adapters) or "none"
        raise _BadRequest(
            f"adapter {adapter_id!r} not found on model "
            f"{model.model_id!r} (declared: {declared})", status=404)
    if int(d.get("n", 1)) != 1:
        raise _BadRequest("n > 1 is not supported")

    if chat:
        messages = d.get("messages")
        if not isinstance(messages, list) or not messages:
            raise _BadRequest("messages must be a non-empty list")
        lines = [f"{m.get('role', 'user')}: {m.get('content', '')}"
                 for m in messages]
        text = "\n".join(lines) + "\nassistant:"
        prompt_ids, echo = model.tokenizer.encode(text), text
    else:
        if "prompt" not in d:
            raise _BadRequest("prompt is required")
        prompt_ids, echo = _parse_prompt(model, d["prompt"])
    if not prompt_ids:
        raise _BadRequest("prompt is empty")

    eng = model.engine
    room = eng.max_len - len(prompt_ids)
    if room < 1:
        raise _BadRequest(f"prompt of {len(prompt_ids)} tokens leaves no "
                          f"room under max_model_len {eng.max_len}")
    asked = d.get("max_tokens", 16)
    try:
        asked = int(asked)
    except (TypeError, ValueError) as e:
        raise _BadRequest("max_tokens must be an integer") from e
    if asked < 1:
        raise _BadRequest("max_tokens must be >= 1")
    max_tokens = min(asked, perf().gateway_max_new, room)

    stops = d.get("stop") or []
    if isinstance(stops, str):
        stops = [stops]
    if not isinstance(stops, list) or \
            not all(isinstance(s, str) for s in stops):
        raise _BadRequest("stop must be a string or list of strings")

    # per-request deadline: OpenAI clients pass "timeout" in seconds; the
    # engine-wide REPRO_SERVE_DEADLINE_MS default applies when absent
    deadline_ms: Optional[float] = None
    if "timeout" in d and d["timeout"] is not None:
        try:
            timeout_s = float(d["timeout"])
        except (TypeError, ValueError) as e:
            raise _BadRequest("timeout must be a number (seconds)") from e
        if timeout_s <= 0:
            raise _BadRequest("timeout must be > 0 seconds")
        deadline_ms = timeout_s * 1e3

    sampling = SamplingParams(
        temperature=float(d.get("temperature", 0.0)),
        top_k=int(d.get("top_k", 0)),
        seed=int(d.get("seed", 0)))
    return _Completion(model=model, prompt_ids=prompt_ids,
                       max_tokens=max_tokens, sampling=sampling,
                       stream=bool(d.get("stream", False)), stops=stops,
                       echo_text=echo, deadline_ms=deadline_ms,
                       adapter_id=adapter_id)


def _usage(prompt_tokens: int, completion_tokens: int) -> Dict:
    return {"prompt_tokens": prompt_tokens,
            "completion_tokens": completion_tokens,
            "total_tokens": prompt_tokens + completion_tokens}


def _finish_reason(engine_reason: str, stopped: bool) -> str:
    if stopped:
        return "stop"
    return "length" if engine_reason in ("", "length") else engine_reason


def _completion_chunk(req_id: str, model_id: str, created: int, text: str,
                      token_ids: Optional[List[int]],
                      finish_reason: Optional[str] = None,
                      usage: Optional[Dict] = None, chat: bool = False,
                      first: bool = False) -> Dict:
    if chat:
        delta: Dict = {}
        if first:
            delta["role"] = "assistant"
        if text:
            delta["content"] = text
        choice: Dict = {"index": 0, "delta": delta,
                        "finish_reason": finish_reason}
    else:
        choice = {"index": 0, "text": text, "logprobs": None,
                  "finish_reason": finish_reason}
    if token_ids is not None:
        choice["token_ids"] = token_ids
    out = {"id": req_id, "created": created, "model": model_id,
           "object": "chat.completion.chunk" if chat else "text_completion",
           "choices": [choice]}
    if usage is not None:
        out["usage"] = usage
    return out


# ---------------------------------------------------------------------------
# Gateway server
# ---------------------------------------------------------------------------

class Gateway:
    """The asyncio socket server fronting a ``Router``.

    ``await start()`` binds (port 0 picks an ephemeral port, read it back
    from ``.port``) and starts every model's stepper; ``await stop()``
    closes the listener and stops the steppers.  Use as an async context
    manager in tests.
    """

    def __init__(self, router: Router, host: str = "127.0.0.1",
                 port: int = 8000):
        self.router = router
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None

    async def start(self) -> "Gateway":
        await self.router.start()
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        await self.router.stop()

    async def __aenter__(self) -> "Gateway":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # -- connection handling ----------------------------------------------
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        req_id = f"req-{uuid.uuid4().hex[:24]}"
        try:
            parsed = await _read_request(reader)
            if parsed is None:
                return
            method, path, headers, body = parsed
            await self._route(method, path, body, writer, req_id)
        except _BadRequest as e:
            extra = {"Retry-After": str(e.retry_after)} \
                if e.retry_after is not None else None
            err_type = "overloaded_error" if e.status in (429, 503) \
                else "invalid_request_error"
            try:
                await _send_json(writer, e.status, _error(str(e), err_type),
                                 req_id, extra=extra)
            except (ConnectionError, RuntimeError):
                pass
        except (asyncio.IncompleteReadError, ConnectionError):
            pass  # client went away mid-request; stream handlers cancelled
        except Exception as e:  # noqa: BLE001 — one bad conn must not kill the server
            # never swallowed silently: the operator sees what the client got
            print(f"gateway: unhandled {type(e).__name__} serving {req_id}: "
                  f"{e}", file=sys.stderr)
            try:
                await _send_json(writer, 500,
                                 _error(f"{type(e).__name__}: {e}",
                                        "internal_error"), req_id)
            except (ConnectionError, RuntimeError):
                pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, RuntimeError):
                pass

    async def _route(self, method: str, path: str, body: bytes,
                     writer: asyncio.StreamWriter, req_id: str) -> None:
        if path == "/health" and method == "GET":
            stats = [m.async_engine.stats() for m in self.router.models()]
            # non-200 when any stepper is dead or its engine crossed the
            # consecutive-crash threshold — orchestrators key restarts on this
            healthy = all(s["running"] and not s["degraded"] for s in stats)
            status = "ok" if healthy else "degraded"
            await _send_json(writer, 200 if healthy else 503,
                             {"status": status, "models": stats}, req_id)
        elif path == "/v1/models" and method == "GET":
            cards = []
            for m in self.router.models():
                cards.append(m.card())
                # one card per tenant: declared adapters plus any loaded
                # programmatically straight into the engine's store
                names = list(dict.fromkeys(
                    list(m.adapters) + m.engine.adapters.loaded()))
                cards.extend(m.adapter_card(n) for n in names)
            await _send_json(writer, 200,
                             {"object": "list", "data": cards}, req_id)
        elif path.startswith("/v1/models/") and method == "GET":
            asked = path[len("/v1/models/"):]
            base_id, adapter_id = self.router.split_adapter(asked)
            m = self.router.get(base_id) if base_id else None
            if m is None:
                raise _BadRequest("model not found", status=404)
            if adapter_id is not None:
                if not m.serves_adapter(adapter_id):
                    raise _BadRequest("adapter not found", status=404)
                await _send_json(writer, 200, m.adapter_card(adapter_id),
                                 req_id)
            else:
                await _send_json(writer, 200, m.card(), req_id)
        elif path == "/v1/completions" and method == "POST":
            await self._completion(body, writer, req_id, chat=False)
        elif path == "/v1/chat/completions" and method == "POST":
            await self._completion(body, writer, req_id, chat=True)
        elif path in ("/v1/completions", "/v1/chat/completions", "/health",
                      "/v1/models"):
            raise _BadRequest(f"method {method} not allowed here", status=405)
        else:
            raise _BadRequest(f"no route for {path}", status=404)

    # -- the two completion endpoints -------------------------------------
    async def _completion(self, body: bytes, writer: asyncio.StreamWriter,
                          req_id: str, chat: bool) -> None:
        ask = _parse_body(self.router, body, chat=chat)
        aeng = ask.model.async_engine
        if not aeng.running:
            raise _BadRequest("engine is not running", status=503,
                              retry_after=1)
        # load shedding: refuse at the door (429 + Retry-After) while the
        # submit queue is full or the block pool is past the pressure
        # threshold — cheaper for everyone than queueing work that will
        # miss its deadline anyway
        reason = aeng.engine.overload_reason()
        if reason:
            aeng.engine.note_gateway_shed()
            raise _BadRequest(f"overloaded: {reason}", status=429,
                              retry_after=1)
        if ask.adapter_id is not None \
                and not aeng.engine.adapters.known(ask.adapter_id):
            # first ask for a declared tenant: lazy-load its adapter.  Safe
            # from this (event-loop) thread: the slab write only touches a
            # slot no in-flight row references (in-flight rows hold refs, and
            # only refcount-0 slots are evicted/overwritten).
            from repro_torch.serve.adapters import AdapterStoreFull
            try:
                aeng.engine.load_adapter(ask.adapter_id)
            except AdapterStoreFull as e:
                raise _BadRequest(f"adapter store full: {e}", status=429,
                                  retry_after=1) from e
            except NotImplementedError as e:
                raise _BadRequest(str(e)) from e
        req_id = ("chatcmpl-" if chat else "cmpl-") + uuid.uuid4().hex[:24]
        created = int(time.time())
        stream = aeng.submit(
            ask.prompt_ids, max_new=ask.max_tokens, sampling=ask.sampling,
            deadline_ms=ask.deadline_ms, adapter_id=ask.adapter_id)
        if ask.stream:
            await self._stream_response(ask, stream, writer, req_id, created,
                                        chat)
        else:
            await self._full_response(ask, stream, writer, req_id, created,
                                      chat)

    async def _consume(self, ask: _Completion, stream: TokenStream,
                       detector: StopDetector):
        """Drive one generation to its end (stop sequence, length, or
        engine-side termination), yielding (text, token_ids) pieces.  When a
        stop sequence lands the engine request is cancelled immediately —
        its KV blocks go back to the pool without waiting for max_tokens."""
        tok = ask.model.tokenizer
        pending_ids: List[int] = []
        async for t in stream:
            pending_ids.append(t)
            piece = detector.feed(tok.decode([t]))
            if piece:
                ids, pending_ids = pending_ids, []
                yield piece, ids
            if detector.stopped:
                ask.model.async_engine.cancel(stream.rid)
                return
        piece = detector.flush()
        if piece:
            yield piece, pending_ids

    async def _full_response(self, ask: _Completion, stream: TokenStream,
                             writer: asyncio.StreamWriter, req_id: str,
                             created: int, chat: bool) -> None:
        detector = StopDetector(ask.stops)
        texts: List[str] = []
        all_ids: List[int] = []
        async for piece, ids in self._consume(ask, stream, detector):
            texts.append(piece)
            all_ids.extend(ids)
        if stream.finish_reason.startswith("rejected"):
            raise _BadRequest(stream.finish_reason)
        reason = "stop" if detector.stopped \
            else _finish_reason(stream.finish_reason, False)
        text = "".join(texts)
        usage = _usage(len(ask.prompt_ids), len(all_ids))
        if chat:
            choice: Dict = {"index": 0,
                            "message": {"role": "assistant", "content": text},
                            "finish_reason": reason}
        else:
            choice = {"index": 0, "text": text, "logprobs": None,
                      "finish_reason": reason, "token_ids": all_ids}
        obj = {"id": req_id,
               "object": "chat.completion" if chat else "text_completion",
               "created": created, "model": ask.served_id,
               "choices": [choice], "usage": usage}
        await _send_json(writer, 200, obj, req_id)

    async def _stream_response(self, ask: _Completion, stream: TokenStream,
                               writer: asyncio.StreamWriter, req_id: str,
                               created: int, chat: bool) -> None:
        mid = ask.served_id
        detector = StopDetector(ask.stops)
        await _sse_open(writer, req_id)
        n_tokens = 0
        first = True
        try:
            async for piece, ids in self._consume(ask, stream, detector):
                n_tokens += len(ids)
                await _sse_event(writer, _completion_chunk(
                    req_id, mid, created, piece, ids, chat=chat,
                    first=first))
                first = False
            if stream.finish_reason.startswith("rejected"):
                await _sse_event(writer, _error(stream.finish_reason))
                await _sse_event(writer, "[DONE]")
                return
            reason = "stop" if detector.stopped \
                else _finish_reason(stream.finish_reason, False)
            await _sse_event(writer, _completion_chunk(
                req_id, mid, created, "", None, finish_reason=reason,
                usage=_usage(len(ask.prompt_ids), n_tokens),
                chat=chat, first=first))
            await _sse_event(writer, "[DONE]")
        except (ConnectionError, RuntimeError):
            # client went away mid-stream: free the request's KV now
            if not stream.finish_reason:
                ask.model.async_engine.cancel(stream.rid)
            raise


# ---------------------------------------------------------------------------
# Construction helpers
# ---------------------------------------------------------------------------

def build_model(cfg, params, model_id: Optional[str] = None,
                adapters: Sequence[str] = (),
                **engine_kwargs) -> GatewayModel:
    """One ``GatewayModel`` from a config + params: builds the
    ``ServeEngine`` (on the device ``params`` live on) and wraps it (the
    stepper starts with the router).  ``adapters`` declares the LoRA
    tenants clients may address as ``model="{id}:{adapter}"`` — loaded
    lazily on first use."""
    from repro_torch.serve.engine import ServeEngine
    return wrap_engine(ServeEngine(cfg, params, **engine_kwargs), model_id,
                       adapters)


def wrap_engine(eng, model_id: Optional[str] = None,
                adapters: Sequence[str] = ()) -> GatewayModel:
    """A built ``ServeEngine`` as a ``GatewayModel`` (rank 0 of a serve
    mesh wraps its engines; the other ranks follow them unwrapped)."""
    mid = model_id or eng.cfg.name
    return GatewayModel(model_id=mid,
                        async_engine=AsyncServeEngine(eng, model_id=mid),
                        tokenizer=ByteTokenizer(eng.cfg.vocab),
                        adapters=list(adapters))
