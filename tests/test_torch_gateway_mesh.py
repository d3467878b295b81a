"""The async engine and the OpenAI-compatible gateway over a serve mesh,
on the CPU: two ``gloo`` ranks; rank 0 runs one in-process ``Gateway``
over a router of reduced qwen3-0.6b and reduced olmoe-1b-7b, both engines
on the one 2-rank mesh (KV pools on kv-heads), each stepped by its own
thread under the engine's mesh lock; rank 1 follows both engines
(``serve.engine.follow_all``).  Eight streams over HTTP, four a model, one
closed by its client mid-stream, and a ``step`` fault seeded alike on both
ranks' olmoe engines (``tests/_torch_mesh_ranks.py::gateway_mesh``)."""
import json

import pytest
import torch

import _torch_mesh_ranks as ranks
from repro_torch.launch.mesh import spawn_ranks
from tools.gateway_smoke_torch import check_sse, sse_payloads

torch.set_num_threads(1)

# (model index, prompt, max_new, temperature, top_k, seed)
SPECS = [(0, [3, 5, 7, 11], 8, 0.0, 0, 0),
         (1, [4, 8, 15, 16, 23], 8, 0.0, 0, 0),
         (0, [9, 9, 2], 6, 0.8, 16, 3),
         (1, [1, 2, 3, 4, 5, 6, 7, 8, 9], 7, 0.0, 0, 0),
         (0, [3, 5, 7, 11, 13, 17], 12, 0.0, 0, 0),
         (1, [42, 7], 9, 0.7, 8, 5),
         (0, [2, 4, 6, 8, 10, 12, 14, 16, 18], 8, 0.0, 0, 0),
         (1, [99, 98, 97], 6, 0.0, 0, 0)]
CANCEL = (4, 3)                 # stream 4 closed by its client after 3 ids
FAULT = "step:after=6"          # olmoe's 7th dispatch crashes on both ranks


@pytest.fixture(scope="module")
def outs():
    return spawn_ranks(ranks.gateway_mesh, 2, args=(SPECS, CANCEL, FAULT))


def test_streams_equal_a_plain_engine(outs):
    """Every stream over HTTP passes the SSE contract with its tokens equal
    to a plain engine's run of the same request, but the one its client
    closed (a prefix of the plain tokens) and the one the fault
    quarantined (an error finish, a prefix)."""
    rank0 = outs[0]
    assert rank0["faults"] == [None, None]
    errored = rank0["engines"][1]["errored"]
    assert len(errored) == 1
    for i, (s, want) in enumerate(zip(rank0["streams"], rank0["plain"])):
        assert s["status"] == 200, (i, s["raw"][:200])
        if i == CANCEL[0]:
            assert s["closed_early"]
            payloads, _ = sse_payloads(s["raw"])
            ids = [t for p in payloads if p != b"[DONE]"
                   for t in json.loads(p)["choices"][0]["token_ids"]]
            assert ids == want[:len(ids)] and len(ids) >= CANCEL[1]
            continue
        sse = check_sse(s["raw"], prompt_tokens=len(SPECS[i][1]))
        assert sse["errors"] == [], (i, sse["errors"])
        if sse["finish_reason"] == "error":
            continue
        assert sse["finish_reason"] == "length", (i, sse["finish_reason"])
        assert sse["token_ids"] == want, (i, sse["token_ids"], want)
    n_error = sum(check_sse(s["raw"])["finish_reason"] == "error"
                  for i, s in enumerate(rank0["streams"]) if i != CANCEL[0])
    assert n_error == 1


def test_both_ranks_agree_on_cancel_and_quarantine(outs):
    """The cancel and the fault's quarantine land alike on both ranks: the
    same cancelled and errored ids an engine, the same finished tokens, the
    invariants clean."""
    for k in range(2):
        a, b = (o["engines"][k] for o in outs)
        assert a["finished"] == b["finished"]
        assert a["cancelled"] == b["cancelled"]
        assert a["errored"] == b["errored"]
        assert a["invariants"] == [] and b["invariants"] == []
    assert len(outs[0]["engines"][0]["cancelled"]) == 1
    assert outs[0]["engines"][1]["errored"] and \
        outs[0]["engines"][0]["errored"] == []


def test_shutdown_releases_the_followers(outs):
    """Stopping the gateway closes both engines on rank 0, and rank 1
    leaves ``follow_all`` with both closed (the ranks returned at all:
    otherwise the group would have outlived its timeout)."""
    assert all(e["closed"] for o in outs for e in o["engines"])
    assert outs[1]["steps"] > 0
