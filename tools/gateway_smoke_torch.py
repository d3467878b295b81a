"""Live-gateway smoke client of the PyTorch port: strict SSE framing and
batch-oracle identity.

    # terminal 1: the gateway, full-width qwen3-0.6b on the card
    PYTHONPATH=src python -m repro_torch.launch.gateway --arch qwen3-0.6b \
        --device cuda --port 8011
    # terminal 2
    PYTHONPATH=src python -m tools.gateway_smoke_torch \
        --url http://127.0.0.1:8011 --arch qwen3-0.6b --device cuda

    # on the CPU, at the reduced size: the gateway with --smoke --device cpu
    # --no-plan-kernels --max-batch 2 --max-len 64 --block-size 8, and this
    # client with --smoke --device cpu --max-batch 2 --max-len 64
    # --block-size 8

Drives a *running* gateway over real HTTP (stdlib only: one raw-socket
asyncio client, ``sse_request``, for the JSON endpoints and the SSE stream,
so framing is checked on the wire, not through a parser that would paper
over malformed events) and asserts:

  * ``/health`` and ``/v1/models`` answer with well-formed JSON;
  * a streamed ``/v1/completions`` emits only ``data: <json>`` events,
    each a valid ``text_completion`` chunk, terminated by exactly one
    ``data: [DONE]``, with ``finish_reason`` and a usage block on the
    final chunk (``check_sse``);
  * the streamed ``token_ids`` are **identical** to what a fresh
    ``ServeEngine.run_until_done()`` produces for the same request on the
    same weights (random from seed 0, as the launcher makes them) and the
    same device;
  * a streamed ``/v1/chat/completions`` opens with a role delta and ends
    with ``[DONE]``.

Exit status is the number of failed checks (0 = ok).  The same client
(``sse_request``, with ``open_loop`` and ``latency_summary``) also drives a
gateway that runs in the same process: ``chip_smoke.py``'s gateway phases
and ``tools.chaos_smoke_torch`` use it.  Nothing here imports JAX or the
JAX package.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple
from urllib.parse import urlparse

import numpy as np

# the request both sides generate: mixed sampling, long enough to cross a
# block boundary at the smoke block_size
PROMPT = [3, 5, 7, 11, 13, 17]
MAX_TOKENS = 12
SAMPLING = {"temperature": 0.7, "top_k": 20, "seed": 5}


class Deadline:
    """Whole-run wall-clock budget for a smoke client.

    A wedged gateway (a stream that never sends its terminal event) would
    otherwise park the SSE read loops forever.  ``remaining`` bounds each
    request's ``asyncio.wait_for``; ``tools.chaos_smoke_torch`` reuses this
    for its no-hung-streams assertion.
    """

    def __init__(self, seconds: Optional[float] = None):
        self.seconds = seconds
        self._t0 = time.monotonic()

    @property
    def remaining(self) -> float:
        if self.seconds is None:
            return float("inf")
        return self.seconds - (time.monotonic() - self._t0)


# ---------------------------------------------------------------------------
# The SSE contract, checked on raw bytes
# ---------------------------------------------------------------------------

def sse_payloads(raw: bytes) -> Tuple[List[bytes], List[str]]:
    """Split an SSE body strictly: every non-blank line is ``data: ...``,
    and exactly one ``[DONE]`` ends the stream.  Returns (payloads without
    the ``data: `` prefix, framing errors)."""
    errs = []
    payloads = []
    for line in raw.split(b"\n"):
        line = line.rstrip(b"\r")
        if not line:
            continue
        if not line.startswith(b"data: "):
            errs.append(f"malformed SSE line {line[:80]!r}")
            continue
        payloads.append(line[len(b"data: "):])
    if payloads.count(b"[DONE]") != 1 or not payloads \
            or payloads[-1] != b"[DONE]":
        errs.append("stream not terminated by exactly one [DONE]: "
                    f"{[p[:40] for p in payloads[-3:]]}")
    return payloads, errs


def check_sse(raw: bytes, chat: bool = False,
              prompt_tokens: Optional[int] = None) -> Dict:
    """Hold one streamed completion to the gateway's SSE contract: strict
    framing, every chunk of the right ``object`` with one ``id``, ``model``
    and ``created``, a terminal chunk with ``finish_reason`` and a usage
    block whose counts add up (``completion_tokens`` the number of streamed
    token ids), nothing after it but ``[DONE]``; a chat stream opens with a
    role delta.  A rejected request ends with an error event instead.
    Returns ``token_ids``, ``finish_reason`` (``"rejected: ..."`` for an
    error event), ``model``, ``usage`` and ``errors``."""
    payloads, errs = sse_payloads(raw)
    want_obj = "chat.completion.chunk" if chat else "text_completion"
    token_ids: List[int] = []
    finish, usage, model = "", None, None
    ids, created = set(), set()
    body = [p for p in payloads if p != b"[DONE]"]
    for k, p in enumerate(body):
        try:
            chunk = json.loads(p)
        except json.JSONDecodeError as e:
            errs.append(f"chunk {k} is not JSON: {e}")
            continue
        if "error" in chunk:
            # the gateway's error event carries the stream's "rejected: ..."
            msg = str(chunk["error"].get("message"))
            finish = msg if msg.startswith("rejected") else f"rejected: {msg}"
            if k != len(body) - 1:
                errs.append("events after the error event")
            break
        if finish:
            errs.append(f"chunk {k} after the terminal chunk")
        if chunk.get("object") != want_obj:
            errs.append(f"chunk {k}: object {chunk.get('object')!r}")
        ids.add(chunk.get("id"))
        created.add(chunk.get("created"))
        model = chunk.get("model", model)
        choices = chunk.get("choices") or [{}]
        if len(choices) != 1 or choices[0].get("index") != 0:
            errs.append(f"chunk {k}: choices {choices}")
        choice = choices[0]
        if chat and k == 0 and \
                choice.get("delta", {}).get("role") != "assistant":
            errs.append(f"first chat delta carries no role: {chunk}")
        token_ids.extend(choice.get("token_ids") or [])
        if choice.get("finish_reason"):
            finish = choice["finish_reason"]
            usage = chunk.get("usage")
    if len(ids) > 1 or len(created) > 1:
        errs.append(f"chunks disagree on id/created: {ids} {created}")
    if finish and not finish.startswith("rejected"):
        if not usage or usage.get("completion_tokens") != len(token_ids) \
                or usage.get("total_tokens") != usage.get(
                    "prompt_tokens", 0) + usage.get("completion_tokens", 0):
            errs.append(f"bad usage block on the final chunk: {usage}")
        elif prompt_tokens is not None \
                and usage.get("prompt_tokens") != prompt_tokens:
            errs.append(f"usage counts {usage.get('prompt_tokens')} prompt "
                        f"tokens, want {prompt_tokens}")
    if not finish:
        errs.append("no terminal chunk (finish_reason or error)")
    return {"token_ids": token_ids, "finish_reason": finish, "model": model,
            "usage": usage, "errors": errs}


# ---------------------------------------------------------------------------
# The smoke checks (a gateway in another process)
# ---------------------------------------------------------------------------

def _request(host: str, port: int, payload: Optional[dict], path: str,
             deadline: Optional[Deadline] = None) -> Dict:
    """One ``sse_request`` on its own event loop, cut at the deadline
    (``TimeoutError``)."""
    left = float("inf") if deadline is None else deadline.remaining
    return asyncio.run(asyncio.wait_for(
        sse_request(host, port, payload, path=path),
        None if left == float("inf") else max(left, 0.1)))


def _get_json(host: str, port: int, path: str,
              deadline: Optional[Deadline] = None) -> dict:
    got = _request(host, port, None, path, deadline)
    assert got["status"] == 200, \
        f"GET {path} -> {got['status']}: {got['raw'][:200]!r}"
    return json.loads(got["raw"])


def _stream(host: str, port: int, path: str, payload: dict,
            deadline: Optional[Deadline] = None) -> Tuple[bytes, dict]:
    """POST a streaming request; return (raw SSE body, response headers),
    and print its time to the first token."""
    got = _request(host, port, payload, path, deadline)
    assert got["status"] == 200, \
        f"POST {path} -> {got['status']}: {got['raw'][:200]!r}"
    assert got["headers"].get("content-type", "").startswith(
        "text/event-stream"), f"not SSE: {got['headers']}"
    if got["ttft_s"] is not None:
        print(f"{path} ttft_ms: {got['ttft_s'] * 1e3:.2f}")
    return got["raw"], got["headers"]


def check_completions(host: str, port: int, model_id: str,
                      oracle: List[int],
                      deadline: Optional[Deadline] = None) -> List[str]:
    raw, headers = _stream(host, port, "/v1/completions", {
        "model": model_id, "prompt": PROMPT, "max_tokens": MAX_TOKENS,
        "stream": True, **SAMPLING}, deadline=deadline)
    got = check_sse(raw, prompt_tokens=len(PROMPT))
    errs = list(got["errors"])
    if "x-request-id" not in headers:
        errs.append("stream response missing x-request-id header")
    if got["finish_reason"] != "length":
        errs.append(f"finish_reason {got['finish_reason']!r}, want 'length'")
    if got["token_ids"] != oracle:
        errs.append(f"streamed tokens {got['token_ids']} != batch oracle "
                    f"{oracle}")
    else:
        print(f"stream == oracle over {len(oracle)} tokens: "
              f"{got['token_ids']}")
    return errs


def check_chat(host: str, port: int, model_id: str,
               deadline: Optional[Deadline] = None) -> List[str]:
    raw, _ = _stream(host, port, "/v1/chat/completions", {
        "model": model_id, "stream": True, "max_tokens": 4,
        "messages": [{"role": "user", "content": "hi"}]}, deadline=deadline)
    got = check_sse(raw, chat=True)
    errs = list(got["errors"])
    if got["finish_reason"] != "length":
        errs.append(f"chat finish_reason {got['finish_reason']!r}")
    return errs


def build_oracle(arch: str, smoke: bool, device: str, max_batch: int,
                 max_len: int, block_size: int) -> List[int]:
    """What ``run_until_done`` emits for the smoke request: a fresh engine
    on the weights ``repro_torch.launch.gateway`` makes (random, seed 0) on
    the same device."""
    from repro_torch.configs.base import get_config, reduced_config
    from repro_torch.device import resolve_device
    from repro_torch.models import build_model
    from repro_torch.serve.engine import Request, SamplingParams, ServeEngine

    dev = resolve_device(device)
    cfg = get_config(arch)
    if smoke:
        cfg = reduced_config(cfg)
    params = build_model(cfg, dev).init(0)
    eng = ServeEngine(cfg, params, max_batch=max_batch, max_len=max_len,
                      block_size=block_size, plan_kernels=False)
    req = Request(rid=0, prompt=list(PROMPT), max_new=MAX_TOKENS,
                  sampling=SamplingParams(**SAMPLING))
    eng.submit(req)
    eng.run_until_done()
    return list(req.out)


# ---------------------------------------------------------------------------
# asyncio client (a gateway on this process's event loop)
# ---------------------------------------------------------------------------

async def sse_request(host: str, port: int, payload: Optional[dict],
                      path: str = "/v1/completions",
                      close_after: Optional[int] = None) -> Dict:
    """One POST of ``payload`` (a GET when it is None) over a raw socket.
    Returns ``status``, ``headers``, the raw
    body (``raw``), the arrival time of each streamed token id
    (``stamps``, monotonic seconds), ``ttft_s`` (first token id after the
    request bytes were flushed: queueing, admission and prefill, what a
    caller sees), ``itl_s`` (gaps between token ids) and ``wall_s``.
    ``close_after=k`` drops the connection once k token ids have arrived
    (a client that goes away mid-stream); ``closed_early`` says it did."""
    if payload is None:
        head, body = f"GET {path} HTTP/1.1\r\nHost: client\r\n", b""
    else:
        body = json.dumps(payload).encode("utf-8")
        head = (f"POST {path} HTTP/1.1\r\nHost: client\r\n"
                "Content-Type: application/json\r\n"
                f"Content-Length: {len(body)}\r\n")
    reader, writer = await asyncio.open_connection(host, port)
    stamps: List[float] = []
    closed_early = False
    try:
        writer.write(head.encode() + b"\r\n" + body)
        await writer.drain()
        t0 = time.monotonic()
        parts = (await reader.readline()).split()
        status = int(parts[1]) if len(parts) > 1 else 0
        headers = {}
        while True:
            line = await reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            k, _, v = line.decode("latin-1").partition(":")
            headers[k.strip().lower()] = v.strip()
        raw = b""
        if not headers.get("content-type", "").startswith(
                "text/event-stream"):
            raw = await reader.read()
        else:
            while True:
                line = await reader.readline()
                if not line:
                    break
                raw += line
                if line.startswith(b"data: {"):
                    chunk = json.loads(line[len(b"data: "):])
                    n = len((chunk.get("choices") or [{}])[0]
                            .get("token_ids") or [])
                    stamps.extend([time.monotonic()] * n)
                if line.rstrip(b"\r\n") == b"data: [DONE]":
                    break
                if close_after is not None and len(stamps) >= close_after:
                    closed_early = True
                    break
        wall = time.monotonic() - t0
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionError, RuntimeError):
            pass
    return {"status": status, "headers": headers, "raw": raw,
            "stamps": stamps, "closed_early": closed_early,
            "ttft_s": stamps[0] - t0 if stamps else None,
            "itl_s": [b - a for a, b in zip(stamps, stamps[1:])],
            "wall_s": wall}


def completion_payload(model_id: str, prompt: Sequence[int], max_new: int,
                       sampling) -> dict:
    """The streamed ``/v1/completions`` body of one engine ``Request``'s
    fields (token-id prompt, its sampling)."""
    return {"model": model_id, "prompt": list(prompt),
            "max_tokens": max_new, "stream": True,
            "temperature": sampling.temperature, "top_k": sampling.top_k,
            "seed": sampling.seed}


async def open_loop(host: str, port: int, payloads: Sequence[dict],
                    arrivals: Sequence[float]) -> Tuple[List[Dict], float]:
    """Fire ``payloads[i]`` at ``arrivals[i]`` seconds after the start
    (Poisson arrivals come from ``poisson_arrivals``), all streamed
    concurrently; returns each request's ``sse_request`` result and the
    wall seconds from the start to the last stream's end."""
    t_start = time.monotonic()

    async def one(i):
        await asyncio.sleep(float(arrivals[i]))
        return await sse_request(host, port, payloads[i])
    results = await asyncio.gather(*[one(i) for i in range(len(payloads))])
    return list(results), time.monotonic() - t_start


def poisson_arrivals(n: int, qps: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / qps, size=n))


def latency_summary(results: Sequence[Dict], wall_s: float) -> Dict:
    """TTFT and inter-token latency percentiles (ms) over streamed
    results, delivered tokens/s over ``wall_s``."""
    ttfts = [r["ttft_s"] for r in results if r["ttft_s"] is not None]
    itls = [x for r in results for x in r["itl_s"]]
    tokens = sum(len(r["stamps"]) for r in results)

    def pct(xs, q):
        return float(np.percentile(xs, q)) * 1e3 if xs else 0.0
    return {"requests": len(results), "wall_s": wall_s,
            "tokens": tokens, "tokens_per_sec": tokens / wall_s,
            "ttft_p50_ms": pct(ttfts, 50), "ttft_p99_ms": pct(ttfts, 99),
            "ttft_max_ms": max(ttfts) * 1e3 if ttfts else 0.0,
            "itl_p50_ms": pct(itls, 50), "itl_p99_ms": pct(itls, 99)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--url", default="http://127.0.0.1:8011")
    ap.add_argument("--arch", default="qwen3-0.6b",
                    help="arch the gateway serves")
    ap.add_argument("--model", default=None,
                    help="the model card to ask (default: the first base "
                         "card; a router of several archs names the one "
                         "--arch builds the oracle of)")
    ap.add_argument("--smoke", action="store_true",
                    help="the gateway serves the reduced config")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the gateway's engine runs (the oracle runs "
                         "there too)")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--deadline-s", type=float, default=120.0,
                    help="whole-run wall-clock budget (0 = unlimited)")
    args = ap.parse_args()
    u = urlparse(args.url)
    host, port = u.hostname, u.port or 80
    deadline = Deadline(args.deadline_s or None)

    health = _get_json(host, port, "/health", deadline)
    print(f"health: {health}")
    models = _get_json(host, port, "/v1/models", deadline)
    assert models["object"] == "list" and models["data"], models
    # the base card (a multi-LoRA gateway also lists `base:adapter` cards,
    # marked with a parent; the oracle replays the base model only)
    bases = [m["id"] for m in models["data"] if not m.get("parent")]
    assert bases, f"no base model card in {models}"
    model_id = args.model or bases[0]
    assert model_id in bases, f"no base card {model_id!r} in {bases}"
    print(f"models: {[m['id'] for m in models['data']]}")

    oracle = build_oracle(args.arch, args.smoke, args.device, args.max_batch,
                          args.max_len, args.block_size)
    try:
        errs = check_completions(host, port, model_id, oracle,
                                 deadline=deadline)
        errs += check_chat(host, port, model_id, deadline=deadline)
    except TimeoutError as e:
        errs = [f"hung stream: {e}"]
    for e in errs:
        print(f"gateway_smoke_torch: FAIL: {e}", file=sys.stderr)
    if not errs:
        print("gateway_smoke_torch: all checks passed")
    return len(errs)


if __name__ == "__main__":
    sys.exit(main())
