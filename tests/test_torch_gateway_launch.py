"""The port's gateway launcher: ``python -m repro_torch.launch.gateway
--smoke --device cpu --port 0`` boots, answers ``/health``, passes
``tools.gateway_smoke_torch`` (strict SSE framing, tokens equal to a fresh
engine's) and shuts down cleanly on SIGTERM; ``--mesh 2`` serves two models
over a 2-rank gloo mesh and leaves no process; ``--device cuda`` without a
card raises."""
import asyncio
import http.client
import json
import os
import pathlib
import re
import signal
import subprocess
import sys
import time

import pytest
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENGINE = ["--max-batch", "2", "--max-len", "64", "--block-size", "8"]
BOOT_S = 120.0


def _env():
    return dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}",
                OMP_NUM_THREADS="1")


def _listening(proc) -> str:
    """The launcher's ``gateway listening on`` line, read within BOOT_S."""
    t0 = time.monotonic()
    line = ""
    while "gateway listening on" not in line:
        assert time.monotonic() - t0 < BOOT_S, "gateway did not boot"
        line = proc.stdout.readline()
        assert line or proc.poll() is None, proc.stderr.read()
    return line


def test_gateway_boots_serves_and_shuts_down_cleanly(monkeypatch, capsys):
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.gateway", "--smoke",
         "--device", "cpu", "--port", "0", "--no-plan-kernels", *ENGINE],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = _listening(proc)
        url = re.search(r"http://\S+", line).group(0)
        host, port = url[len("http://"):].rsplit(":", 1)
        conn = http.client.HTTPConnection(host, int(port), timeout=30)
        conn.request("GET", "/health")
        resp = conn.getresponse()
        health = json.loads(resp.read())
        conn.close()
        assert resp.status == 200 and health["status"] == "ok"
        assert health["models"][0]["model"] == "qwen3-0.6b-smoke"

        from tools import gateway_smoke_torch
        monkeypatch.setattr(sys, "argv", [
            "gateway_smoke_torch", "--url", url, "--smoke", "--device", "cpu",
            *ENGINE, "--deadline-s", "60"])
        assert gateway_smoke_torch.main() == 0
        assert "all checks passed" in capsys.readouterr().out

        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert "gateway shut down cleanly" in out


def test_mesh_is_refused_naming_a10():
    """(Named for the refusal it pinned until ``--mesh`` was ported.)
    ``--mesh 2 --smoke --device cpu`` with qwen3-0.6b and olmoe-1b-7b behind
    one router over one 2-rank gloo mesh: it listens, ``/health`` lists both
    models, a streamed completion of each comes back whole, SIGTERM to the
    launcher stops rank 0's gateway and releases the other rank, the
    launcher exits 0 with the shutdown line, and no process of its session
    is left running (``tools.session_leftovers``)."""
    from tools.gateway_smoke_torch import check_sse, sse_request
    from tools.session_leftovers import live_processes
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.gateway", "--mesh", "2",
         "--smoke", "--device", "cpu", "--port", "0", "--no-plan-kernels",
         "--arch", "qwen3-0.6b", "--arch", "olmoe-1b-7b", *ENGINE],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        line = _listening(proc)
        assert "over a 2-rank mesh" in line, line
        url = re.search(r"http://\S+", line).group(0)
        host, port = url[len("http://"):].rsplit(":", 1)
        conn = http.client.HTTPConnection(host, int(port), timeout=30)
        conn.request("GET", "/health")
        resp = conn.getresponse()
        health = json.loads(resp.read())
        conn.close()
        assert resp.status == 200 and health["status"] == "ok"
        assert [m["model"] for m in health["models"]] == [
            "qwen3-0.6b-smoke", "olmoe-1b-7b-smoke"]
        for model in ("qwen3-0.6b-smoke", "olmoe-1b-7b-smoke"):
            got = asyncio.run(asyncio.wait_for(sse_request(
                host, int(port), {"model": model, "prompt": [3, 5, 7],
                                  "max_tokens": 4, "stream": True}), 60))
            sse = check_sse(got["raw"], prompt_tokens=3)
            assert got["status"] == 200 and sse["errors"] == [], sse
            assert len(sse["token_ids"]) == 4 \
                and sse["finish_reason"] == "length"
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    assert proc.returncode == 0, err
    assert "gateway shut down cleanly" in out
    assert "2 ranks over gloo on cpu" in out
    left = [cmd for _, _, sid, cmd in live_processes() if sid == proc.pid]
    assert left == [], left


def test_cuda_without_a_card_raises(monkeypatch):
    from repro_torch.launch.gateway import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        main(["--smoke", "--device", "cuda", "--port", "0"])
