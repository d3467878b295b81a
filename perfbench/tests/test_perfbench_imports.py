"""What a run loads: nothing whose top-level module is ``jax``, ``jaxlib``,
``flax`` or the JAX package ``repro`` (whole names: ``repro_torch`` is
the port), and the plain reference nothing of the port.  The measured
path refuses to run without a card."""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
ENV = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT),
                                                  str(ROOT / "src")]))

RUN_TINY = '''
import json, sys, time
from pathlib import Path
from perfbench import harness
data = Path("perfbench/tests/data")
conf = json.loads((data / "tiny-moe.json").read_text())
mix = json.loads((data / "tiny_chat.json").read_text())
cell = harness.Cell(name="qwen3-30b-a3b.chat_shared", conf=conf, mix=mix,
    limits=json.loads((data / "tiny.limits.json").read_text()), seed=3,
    seconds=1.0, trace=True, device="cpu", t_start=time.monotonic(),
    program=harness._module("programs", "decoder_lm"),
    reference=harness._module("reference", "decoder_lm"),
    runner=harness._module("runners", "serve_closed_loop"))
cell.runner.run(cell)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
'''

REFERENCE_ONLY = '''
import json, sys
import perfbench.reference.decoder_lm
import perfbench.correct, perfbench.roofline, perfbench.window
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
'''


def top_modules(code):
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=ENV,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_jax_package():
    loaded = top_modules(RUN_TINY)
    assert "repro_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_port():
    loaded = top_modules(REFERENCE_ONLY)
    assert not loaded & {"repro_torch", "repro", "jax"}


def test_forbidden_names_are_compared_whole():
    from perfbench import harness
    saved = dict(sys.modules)
    try:
        sys.modules.pop("repro", None)
        sys.modules["repro_torch_lookalike"] = sys
        assert "repro" not in harness.forbidden_modules()
        sys.modules["repro.serve"] = sys
        assert "repro" in harness.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_the_measured_path_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        return
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "qwen3-30b-a3b.chat_shared", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       env=ENV, capture_output=True, text=True, timeout=600)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr
