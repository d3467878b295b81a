"""The port's gateway launcher: ``python -m repro_torch.launch.gateway
--smoke --device cpu --port 0`` boots, answers ``/health``, passes
``tools.gateway_smoke_torch`` (strict SSE framing, tokens equal to a fresh
engine's) and shuts down cleanly on SIGTERM; ``--mesh 2`` is refused naming
ROADMAP A10, and ``--device cuda`` without a card raises."""
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


def test_gateway_boots_serves_and_shuts_down_cleanly(monkeypatch, capsys):
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.gateway", "--smoke",
         "--device", "cpu", "--port", "0", "--no-plan-kernels", *ENGINE],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        t0 = time.monotonic()
        line = ""
        while "gateway listening on" not in line:
            assert time.monotonic() - t0 < BOOT_S, "gateway did not boot"
            line = proc.stdout.readline()
            assert line or proc.poll() is None, proc.stderr.read()
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


def test_mesh_is_refused_naming_a10(capsys):
    from repro_torch.launch.gateway import main
    with pytest.raises(SystemExit) as e:
        main(["--smoke", "--device", "cpu", "--mesh", "2"])
    assert e.value.code != 0
    assert "A10" in capsys.readouterr().err


def test_cuda_without_a_card_raises(monkeypatch):
    from repro_torch.launch.gateway import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        main(["--smoke", "--device", "cuda", "--port", "0"])
