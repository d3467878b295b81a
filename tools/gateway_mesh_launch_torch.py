"""Run the gateway launcher over a serve mesh end to end and check it: boot
``repro_torch.launch.gateway --mesh N`` in a session of its own, wait for
its ``gateway listening on`` line, run ``tools.gateway_smoke_torch``
against each served model (streamed tokens equal to a fresh engine's on
the same weights and device, the chat stream, the time to the first
token), send SIGTERM, and check that the launcher printed ``gateway shut
down cleanly``, exited 0 and left no process of its session running.

    # on the card, full width: two gloo ranks on cuda:0
    PYTHONPATH=src python -m tools.gateway_mesh_launch_torch --mesh 2 \
        --device cuda --arch qwen3-0.6b --arch olmoe-1b-7b
    # on the CPU, reduced
    PYTHONPATH=src python -m tools.gateway_mesh_launch_torch --mesh 2 \
        --device cpu --smoke --arch qwen3-0.6b --arch olmoe-1b-7b

The launcher's output goes to ``--log``.  The last line is a JSON summary;
the exit status is the number of failed checks (0 = ok).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import signal
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", type=int, default=2)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--port", type=int, default=8011)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--boot-s", type=float, default=600.0)
    ap.add_argument("--log", default="gateway_mesh_launch.log")
    args = ap.parse_args()
    from repro_torch.configs.base import get_config, reduced_config
    from tools.session_leftovers import live_processes
    archs = args.arch or ["qwen3-0.6b"]
    engine = ["--max-batch", str(args.max_batch), "--max-len",
              str(args.max_len), "--block-size", str(args.block_size)]
    smoke = ["--smoke"] if args.smoke else []
    cmd = [sys.executable, "-m", "repro_torch.launch.gateway", "--mesh",
           str(args.mesh), "--device", args.device, "--port",
           str(args.port), *smoke, *engine]
    for a in archs:
        cmd += ["--arch", a]
    errs, summary = [], {"command": " ".join(cmd[1:]), "models": {}}
    t0 = time.monotonic()
    with open(args.log, "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            line = ""
            while "gateway listening on" not in line:
                if proc.poll() is not None or \
                        time.monotonic() - t0 > args.boot_s:
                    raise RuntimeError("the gateway did not boot")
                time.sleep(1.0)
                with open(args.log) as f:
                    line = next((ln for ln in f
                                 if "gateway listening on" in ln), "")
            summary["boot_s"] = time.monotonic() - t0
            url = re.search(r"http://\S+", line).group(0)
            for a in archs:
                cfg = get_config(a)
                mid = reduced_config(cfg).name if args.smoke else cfg.name
                run = subprocess.run(
                    [sys.executable, "-m", "tools.gateway_smoke_torch",
                     "--url", url, "--arch", a, "--model", mid, "--device",
                     args.device, *smoke, *engine, "--deadline-s", "600"],
                    capture_output=True, text=True)
                ttft = [float(m) for m in re.findall(
                    r"/v1/completions ttft_ms: ([0-9.]+)", run.stdout)]
                summary["models"][mid] = {
                    "rc": run.returncode, "ttft_ms": ttft,
                    "tokens_equal": "stream == oracle" in run.stdout}
                print(run.stdout, end="")
                if run.returncode != 0:
                    errs.append(f"{mid}: gateway_smoke_torch rc "
                                f"{run.returncode}: {run.stderr[-2000:]}")
            t1 = time.monotonic()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=300)
            summary["shutdown_s"] = time.monotonic() - t1
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    with open(args.log) as f:
        text = f.read()
    summary["rc"] = rc
    summary["clean_line"] = "gateway shut down cleanly" in text
    peaks = re.search(r"peak device bytes by rank (\[[^\]]*\])", text)
    summary["peak_device_bytes_by_rank"] = json.loads(peaks.group(1)) \
        if peaks else None
    left = [cmd for _, _, sid, cmd in live_processes() if sid == proc.pid]
    summary["left"] = left
    if rc != 0 or not summary["clean_line"]:
        errs.append(f"launcher rc {rc}, clean line "
                    f"{summary['clean_line']}:\n{text[-2000:]}")
    if left:
        errs.append(f"processes left running: {left}")
    for e in errs:
        print(f"gateway_mesh_launch_torch: FAIL: {e}", file=sys.stderr)
    summary["ok"] = not errs
    print(json.dumps(summary))
    return len(errs)


if __name__ == "__main__":
    sys.exit(main())
