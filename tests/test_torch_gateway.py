"""The port's OpenAI-compatible gateway on the CPU at the reduced configs:
the HTTP and SSE contract of ``tests/test_gateway.py`` (oracle identity,
stop sequences, chat, 400/404/405, degraded health, 429 shedding with
Retry-After, the ``timeout`` field, quarantined streams), ``base:adapter``
routing, the stateful families' refusal of adapters, and the port held
against the JAX gateway: on bridged weights the same greedy requests stream
the same ``token_ids`` in the same SSE event shapes (apart from ``id`` and
``created``), the model cards agree, and ``ByteTokenizer`` and
``StopDetector`` give the reference's outputs."""
import asyncio
import json

import pytest
import torch

from _torch_parity import bridged_params
from repro_torch.serve.async_engine import AsyncServeEngine
from repro_torch.serve.engine import Request, SamplingParams, ServeEngine
from repro_torch.serve.gateway import (ByteTokenizer, Gateway, GatewayModel,
                                       Router, StopDetector)
from tools.gateway_smoke_torch import check_sse, sse_request

torch.set_num_threads(1)

SCENARIO_S = 60.0
PROMPT = [3, 5, 7, 11]


@pytest.fixture(scope="module")
def setup():
    return bridged_params("qwen3-0.6b")


def _engine(cfg, params, **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_len", 32)
    kw.setdefault("block_size", 4)
    kw.setdefault("plan_kernels", False)
    return ServeEngine(cfg, params, **kw)


def _http_model(cfg, params, model_id="m", adapters=(), **kw):
    eng = _engine(cfg, params, **kw)
    return GatewayModel(model_id=model_id,
                        async_engine=AsyncServeEngine(eng, model_id=model_id),
                        tokenizer=ByteTokenizer(cfg.vocab),
                        adapters=list(adapters))


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, SCENARIO_S))


def _oracle(cfg, params, specs, adapters=()):
    eng = _engine(cfg, params)
    for a in adapters:
        eng.load_adapter(a)
    reqs = [Request(rid=i, prompt=list(p), max_new=n, sampling=sp,
                    adapter_id=ad) for i, (p, n, sp, ad) in enumerate(specs)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done(max_steps=500)
    assert all(r.finish_reason == "length" for r in reqs)
    return [list(r.out) for r in reqs]


async def _raw(gw, method, path, payload=None):
    """One HTTP exchange: (status, headers, body)."""
    got = await sse_request(gw.host, gw.port,
                            payload if method == "POST" else None, path=path)
    return got["status"], got["headers"], got["raw"]


def _completion(model, prompt=PROMPT, max_tokens=6, stream=True, **extra):
    return {"model": model, "prompt": prompt, "max_tokens": max_tokens,
            "stream": stream, **extra}


# ---------------------------------------------------------------------------
# HTTP layer
# ---------------------------------------------------------------------------

def test_http_stream_matches_oracle_and_sse_shape(setup):
    _, cfg, _, params = setup
    sp = SamplingParams(temperature=0.7, top_k=20, seed=5)
    [want] = _oracle(cfg, params, [(PROMPT, 6, sp, None)])

    async def go():
        async with Gateway(Router([_http_model(cfg, params)]), port=0) as gw:
            st, headers, data = await _raw(gw, "POST", "/v1/completions",
                                           _completion(
                                               "m", temperature=0.7,
                                               top_k=20, seed=5))
            st2, _, models = await _raw(gw, "GET", "/v1/models")
            st404, _, _ = await _raw(gw, "GET", "/nope")
            st405, _, _ = await _raw(gw, "GET", "/v1/completions")
            return st, headers, data, st2, models, st404, st405

    st, headers, data, st2, models, st404, st405 = _run(go())
    assert st == 200
    assert headers["content-type"].startswith("text/event-stream")
    assert "x-request-id" in headers
    got = check_sse(data, prompt_tokens=len(PROMPT))
    assert got["errors"] == []
    assert got["token_ids"] == want and got["finish_reason"] == "length"
    assert got["usage"]["completion_tokens"] == 6
    assert st2 == 200
    assert [m["id"] for m in json.loads(models)["data"]] == ["m"]
    assert st404 == 404 and st405 == 405


def test_http_stop_sequence_truncates(setup):
    _, cfg, _, params = setup

    async def go():
        async with Gateway(Router([_http_model(cfg, params)]), port=0) as gw:
            async def completion(extra):
                _, _, data = await _raw(gw, "POST", "/v1/completions",
                                        _completion("m", max_tokens=8,
                                                    stream=False, **extra))
                return json.loads(data)
            free = await completion({})
            text = free["choices"][0]["text"]
            stop = text[2:4]
            stopped = await completion({"stop": [stop]})
            return text, stop, stopped

    text, stop, stopped = _run(go())
    choice = stopped["choices"][0]
    assert choice["finish_reason"] == "stop"
    assert stop not in choice["text"]
    assert choice["text"] == text[:text.find(stop)]


def test_http_chat_stream_has_role_delta(setup):
    _, cfg, _, params = setup

    async def go():
        async with Gateway(Router([_http_model(cfg, params)]), port=0) as gw:
            _, _, data = await _raw(
                gw, "POST", "/v1/chat/completions",
                {"model": "m", "stream": True, "max_tokens": 4,
                 "messages": [{"role": "user", "content": "hi"}]})
            return data

    got = check_sse(_run(go()), chat=True)
    assert got["errors"] == [] and got["finish_reason"] == "length"


def test_http_bad_requests(setup):
    _, cfg, _, params = setup

    async def go():
        async with Gateway(Router([_http_model(cfg, params)]), port=0) as gw:
            return [await _raw(gw, "POST", "/v1/completions", body)
                    for body in ({"model": "ghost", "prompt": "hi"},
                                 {"model": "m", "prompt": [99999]},
                                 {"model": "m", "prompt": "hi", "n": 2},
                                 {"model": "m", "prompt": "hi",
                                  "max_tokens": 0},
                                 {"model": "m"})]

    (st1, _, b1), (st2, _, b2), (st3, _, _), (st4, _, _), (st5, _, _) = \
        _run(go())
    assert st1 == 404 and b"ghost" in b1
    assert st2 == 400 and b"vocab" in b2
    assert st3 == st4 == st5 == 400


def test_max_tokens_clamped_to_knob_and_room(setup, monkeypatch):
    """``max_tokens`` is cut to REPRO_GATEWAY_MAX_NEW and to the room the
    prompt leaves under max_model_len."""
    _, cfg, _, params = setup
    monkeypatch.setenv("REPRO_GATEWAY_MAX_NEW", "3")

    async def go():
        async with Gateway(Router([_http_model(cfg, params)]), port=0) as gw:
            knob = await _raw(gw, "POST", "/v1/completions",
                              _completion("m", max_tokens=50))
            monkeypatch.setenv("REPRO_GATEWAY_MAX_NEW", "128")
            room = await _raw(gw, "POST", "/v1/completions",
                              _completion("m", prompt=list(range(1, 29)),
                                          max_tokens=50))
            return knob, room

    (_, _, knob), (_, _, room) = _run(go())
    assert len(check_sse(knob)["token_ids"]) == 3
    assert len(check_sse(room)["token_ids"]) == 32 - 28


# ---------------------------------------------------------------------------
# fault tolerance surface
# ---------------------------------------------------------------------------

def test_health_degraded_answers_503(setup):
    _, cfg, _, params = setup
    model = _http_model(cfg, params)

    async def go():
        async with Gateway(Router([model]), port=0) as gw:
            ok = await _raw(gw, "GET", "/health")
            model.engine.degraded = True
            bad = await _raw(gw, "GET", "/health")
            model.engine.degraded = False
            return ok, bad

    (st_ok, _, body_ok), (st_bad, _, body_bad) = _run(go())
    assert st_ok == 200 and json.loads(body_ok)["status"] == "ok"
    assert st_bad == 503
    health = json.loads(body_bad)
    assert health["status"] == "degraded"
    assert health["models"][0]["degraded"] is True


def test_overloaded_gateway_sheds_with_429_and_retry_after(setup):
    _, cfg, _, params = setup
    model = _http_model(cfg, params)

    async def go():
        async with Gateway(Router([model]), port=0) as gw:
            model.engine.overload_reason = lambda: "admission queue full"
            try:
                shed = await _raw(gw, "POST", "/v1/completions",
                                  {"model": "m", "prompt": [3, 5, 7]})
            finally:
                del model.engine.overload_reason
            ok = await _raw(gw, "POST", "/v1/completions",
                            {"model": "m", "prompt": [3, 5, 7],
                             "max_tokens": 2})
            return shed, ok, model.async_engine.stats()

    (st, headers, body), (st_ok, _, _), stats = _run(go())
    assert st == 429
    assert headers.get("retry-after") == "1"
    err = json.loads(body)["error"]
    assert err["type"] == "overloaded_error"
    assert "queue full" in err["message"]
    assert model.engine.metrics().requests_shed == 1
    assert stats["requests_shed"] == 1
    assert st_ok == 200


def test_request_timeout_field_expires_via_engine_reaper(setup):
    _, cfg, _, params = setup

    async def go():
        async with Gateway(Router([_http_model(cfg, params)]), port=0) as gw:
            st, _, data = await _raw(gw, "POST", "/v1/completions",
                                     _completion("m", prompt=[3, 5, 7],
                                                 max_tokens=8,
                                                 timeout=1e-6))
            bad = await _raw(gw, "POST", "/v1/completions",
                             {"model": "m", "prompt": [3, 5, 7],
                              "timeout": -1})
            return st, data, bad

    st, data, (st_bad, _, body_bad) = _run(go())
    assert st == 200
    assert check_sse(data)["finish_reason"] == "expired"
    assert st_bad == 400 and b"timeout" in body_bad


def test_stream_of_quarantined_request_ends_with_error(setup):
    from repro_torch.serve.faults import FaultInjector

    _, cfg, _, params = setup
    model = _http_model(cfg, params,
                        fault_injector=FaultInjector.parse("step:exc=1"))

    async def go():
        async with Gateway(Router([model]), port=0) as gw:
            return await _raw(gw, "POST", "/v1/completions",
                              _completion("m", prompt=[3, 5, 7],
                                          max_tokens=4))

    st, _, data = _run(go())
    assert st == 200
    got = check_sse(data)
    assert got["errors"] == [] and got["finish_reason"] == "error"
    assert model.engine.metrics().step_crashes == 1
    assert model.engine.check_invariants() == []


# ---------------------------------------------------------------------------
# base:adapter routing
# ---------------------------------------------------------------------------

def test_gateway_routes_adapters_end_to_end(setup):
    """``m:tenant`` resolves per request and loads the tenant on first use,
    ``/v1/models`` lists adapter cards under their parent, unknown adapters
    404, every stream echoes the tenant-qualified tag, each tenant's stream
    equals the oracle engine's under that tenant, and every ref is returned
    once the streams drained."""
    _, cfg, _, params = setup
    model = _http_model(cfg, params, adapters=["tenant-a", "tenant-b"])
    sp = SamplingParams()
    want = _oracle(cfg, params, [(PROMPT, 5, sp, "tenant-a"),
                                 (PROMPT, 5, sp, "tenant-b"),
                                 (PROMPT, 5, sp, None)],
                   adapters=["tenant-a", "tenant-b"])

    async def go():
        async with Gateway(Router([model]), port=0) as gw:
            async def ask(mid):
                return await _raw(gw, "POST", "/v1/completions",
                                  _completion(mid, max_tokens=5))
            models = await _raw(gw, "GET", "/v1/models")
            card = await _raw(gw, "GET", "/v1/models/m:tenant-a")
            got = [await ask(mid) for mid in ("m:tenant-a", "m:tenant-b",
                                              "m", ":tenant-a", "m:nope")]
            return models, card, got

    (st_m, _, models), (st_c, _, card), got = _run(go())
    assert st_m == 200 and st_c == 200
    cards = {c["id"]: c for c in json.loads(models)["data"]}
    assert "m" in cards and not cards["m"].get("parent")
    assert cards["m:tenant-a"]["parent"] == "m"
    assert cards["m:tenant-a"]["adapter"] == "tenant-a"
    assert json.loads(card)["loaded"] is False      # lazy: not asked yet
    streams = [check_sse(raw) for _, _, raw in got[:4]]
    assert [g[0] for g in got] == [200, 200, 200, 200, 404]
    assert all(s["errors"] == [] for s in streams)
    assert [s["model"] for s in streams] == ["m:tenant-a", "m:tenant-b", "m",
                                             "m:tenant-a"]
    assert [s["token_ids"] for s in streams] == want + [want[0]]
    assert len({tuple(w) for w in want}) == 3
    eng = model.engine
    assert eng.adapters.refcount("tenant-a") == 0
    assert eng.adapters.refcount("tenant-b") == 0


@pytest.mark.parametrize("declared", [False, True])
def test_stateful_model_refuses_adapter_asks(declared):
    """An adapter ask to an ssm engine never streams base tokens: an
    undeclared tenant is a 404, a declared one a rejected stream (the
    engine refuses adapters on stateful families); the same gateway still
    serves the base model."""
    from repro_torch.configs.base import get_config, reduced_config
    from repro_torch.models import build_model

    cfg = reduced_config(get_config("falcon-mamba-7b"))
    params = build_model(cfg, "cpu").init(0)
    model = _http_model(cfg, params, model_id="s",
                        adapters=["t0"] if declared else [],
                        max_len=64, block_size=8)

    async def go():
        async with Gateway(Router([model]), port=0) as gw:
            ask = await _raw(gw, "POST", "/v1/completions",
                             _completion("s:t0", max_tokens=4))
            base = await _raw(gw, "POST", "/v1/completions",
                              _completion("s", max_tokens=4))
            return ask, base

    (st, _, raw), (st_base, _, raw_base) = _run(go())
    if not declared:
        assert st == 404
    else:
        assert st == 200 and check_sse(raw)["finish_reason"].startswith(
            "rejected: LoRA adapters are served for the dense family only")
    assert b"token_ids" not in raw
    assert st_base == 200 and check_sse(raw_base)["finish_reason"] == "length"
    assert model.engine.check_invariants() == []


# ---------------------------------------------------------------------------
# against the JAX gateway
# ---------------------------------------------------------------------------

def _shape(raw):
    """The SSE events with ``id`` and ``created`` taken out."""
    events = []
    for ln in raw.split(b"\n"):
        if not ln.startswith(b"data: "):
            continue
        body = ln[len(b"data: "):]
        if body == b"[DONE]":
            events.append("[DONE]")
            continue
        chunk = json.loads(body)
        chunk.pop("id", None)
        chunk.pop("created", None)
        events.append(chunk)
    return events


def test_port_gateway_streams_the_jax_gateways_greedy_tokens(setup):
    """The same greedy requests (token-id and text prompts, completions and
    chat, streamed and not) to the JAX gateway and to the port's, each over
    the same bridged weights: identical ``token_ids`` and identical events
    and bodies apart from ``id`` and ``created``; the model cards agree
    apart from ``created``."""
    from repro.serve.async_engine import AsyncServeEngine as JAsync
    from repro.serve.engine import ServeEngine as JServeEngine
    from repro.serve.gateway import ByteTokenizer as JTok
    from repro.serve.gateway import Gateway as JGateway
    from repro.serve.gateway import GatewayModel as JModel
    from repro.serve.gateway import Router as JRouter

    jcfg, cfg, jparams, params = setup
    kw = dict(max_batch=2, max_len=32, block_size=4, plan_kernels=False)
    jmodel = JModel(model_id="m", async_engine=JAsync(
        JServeEngine(jcfg, jparams, **kw), model_id="m"),
        tokenizer=JTok(jcfg.vocab))
    tmodel = _http_model(cfg, params, **kw)
    asks = [("/v1/completions", _completion("m", max_tokens=6)),
            ("/v1/completions", _completion("m", prompt=[9, 2, 12, 13, 14],
                                            max_tokens=5)),
            ("/v1/completions", _completion("m", prompt="hello", stream=False,
                                            max_tokens=4)),
            ("/v1/chat/completions",
             {"model": "m", "stream": True, "max_tokens": 4,
              "messages": [{"role": "user", "content": "hi"}]})]

    async def serve(model, gateway):
        async with gateway(Router([model]) if gateway is Gateway
                           else JRouter([model]), port=0) as gw:
            out = [await _raw(gw, "POST", path, body) for path, body in asks]
            out.append(await _raw(gw, "GET", "/v1/models"))
            return out

    jgot = _run(serve(jmodel, JGateway))
    tgot = _run(serve(tmodel, Gateway))
    for (path, body), (jst, _, jraw), (tst, _, traw) in zip(asks, jgot,
                                                            tgot):
        assert jst == tst == 200
        if body.get("stream"):
            chat = "chat" in path
            assert check_sse(traw, chat=chat)["token_ids"] == \
                check_sse(jraw, chat=chat)["token_ids"]
            assert _shape(traw) == _shape(jraw)
        else:
            tbody, jbody = json.loads(traw), json.loads(jraw)
            for b in (tbody, jbody):
                b.pop("id")
                b.pop("created")
            assert tbody == jbody
    tcards, jcards = (json.loads(tgot[-1][2]), json.loads(jgot[-1][2]))
    for c in tcards["data"] + jcards["data"]:
        c.pop("created")
    assert tcards == jcards


# ---------------------------------------------------------------------------
# pure helpers, against the reference's
# ---------------------------------------------------------------------------

TEXTS = ["", "hello", "héllo wörld", "aEND", "\x00\xff", "x" * 40]


@pytest.mark.parametrize("vocab", [16, 257, 151936])
def test_byte_tokenizer_matches_reference(vocab):
    from repro.serve.gateway import ByteTokenizer as JTok
    tok, ref = ByteTokenizer(vocab), JTok(vocab)
    for text in TEXTS:
        assert tok.encode(text) == ref.encode(text)
        assert tok.decode(tok.encode(text)) == ref.decode(ref.encode(text))
    ids = list(range(0, min(vocab, 300)))
    assert tok.decode(ids) == ref.decode(ids)
    assert ByteTokenizer(257).decode(ByteTokenizer(257).encode("héllo")) \
        == "héllo"
    assert all(0 < t < 16 for t in ByteTokenizer(16).encode("hello"))


@pytest.mark.parametrize("stops", [["END"], ["xyz"], ["a", "bc"], [],
                                   ["", "D"]])
def test_stop_detector_matches_reference(stops):
    from repro.serve.gateway import StopDetector as JStop
    pieces = ["aE", "N", "Db", "c", "xy", "zq", "bcd"]
    d, ref = StopDetector(stops), JStop(stops)
    outs = [(d.feed(p), ref.feed(p)) for p in pieces]
    assert [a for a, _ in outs] == [b for _, b in outs]
    assert d.stopped == ref.stopped
    assert d.flush() == ref.flush()


def test_stop_detector_split_across_tokens():
    d = StopDetector(["END"])
    out = d.feed("aE") + d.feed("N") + d.feed("Db")
    assert out == "a" and d.stopped


def test_split_adapter_and_resolve():
    r = Router()
    assert r.split_adapter("m:t") == ("m", "t")
    assert r.split_adapter(":t") == (None, "t")
    assert r.split_adapter("m") == ("m", None)
    assert r.split_adapter(None) == (None, None)
    assert r.resolve(None) is None
