#!/usr/bin/env python3
"""Probes behind the stateful families' training numbers.

    python3 tools/stateful_train_probe.py k7
    python3 tools/stateful_train_probe.py moments
    python3 tools/stateful_train_probe.py grad-spread

Needs one NVIDIA card and nvcc.  Each prints one JSON line per case.

- ``k7``: builds ``csrc/ssm_scan.cu`` and holds the checkpointing forward
  and the backward against the plain versions (da, db and dh0 bitwise, dc
  row by row, two launches bitwise) at small shapes, N from 1 to 32, and
  falcon-mamba-7b's training shape (B 8, T 512, D 8,192, N 16), where it
  also times the scan, the checkpointing scan and the backward (CUDA
  events over 5 eager calls).
- ``moments``: falcon-mamba-7b at full width, bf16, B 8 x S 512, five
  steps of ``Trainer`` under the CLI's schedule, at 16 layers with f32 and
  int8 moments and lr 3e-4 and 1e-4, and at 64 layers with int8 moments
  and lr 1e-4: losses, gradient norms, step seconds, peak memory.
- ``grad-spread``: zamba2-2.7b at full width, 2 segments (12 Mamba2
  layers), f32, B 2 x S 512: the loss and every gradient leaf on the card
  (remat "dots"), on the CPU at 8 threads and at 1 thread (remat off), and
  on the card with the shared block's attention on the plain path instead
  of K3; each pair's largest leaf gap over the leaf's largest value.
"""
from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def _events_ms(torch, fn, reps=5):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def k7(torch):
    import chip_smoke as cs
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import ssm_scan as k7s
    t0 = time.perf_counter()
    build.build("ssm_scan")
    k7s.load_kernels()
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, t, d, n in ((2, 37, 40, 8), (1, 1, 64, 16), (2, 300, 256, 16),
                       (2, 33, 64, 1), (2, 33, 64, 4), (2, 33, 64, 32),
                       (8, 512, 8192, 16)):
        a, bb, c, h0 = cs._ssm_inputs(torch, gen, b, t, d, n)
        dy = torch.randn((b, t, d), generator=gen, device="cuda")
        dh = torch.randn((b, d, n), generator=gen, device="cuda")
        y, hl, ck = k7s.ssm_scan_ckpt_kernel(a, bb, c, h0)
        _, _, rk = ref.ssm_scan_ckpt_ref(a, bb, c, h0, k7s.WINDOW)
        got = k7s.ssm_scan_bwd_kernel(a, bb, c, ck, dy, dh)
        again = k7s.ssm_scan_bwd_kernel(a, bb, c, ck, dy, dh)
        want = ref.ssm_scan_bwd_ref(a, bb, c, h0, dy, dh)
        out = {"shape": [b, t, d, n], "ckpt_bitwise": bool(torch.equal(ck, rk)),
               **{nm: {"bitwise_plain": bool(torch.equal(x, w)),
                       "row_rel_err": ref.row_rel_err(x, w)[1],
                       "two_launches_bitwise": bool(torch.equal(x, x2))}
                  for nm, x, x2, w in zip(("da", "db", "dc", "dh0"), got,
                                          again, want)}}
        del got, again, want
        if t == 512:
            out.update(
                scan_ms=_events_ms(torch, lambda: k7s.ssm_scan_kernel(
                    a, bb, c, h0)),
                ckpt_scan_ms=_events_ms(torch, lambda: k7s.ssm_scan_ckpt_kernel(
                    a, bb, c, h0)),
                bwd_ms=_events_ms(torch, lambda: k7s.ssm_scan_bwd_kernel(
                    a, bb, c, ck, dy, dh)),
                peak_device_bytes=torch.cuda.max_memory_allocated())
        print(json.dumps(out), flush=True)
        del a, bb, c, h0, dy, dh, y, hl, ck, rk
        torch.cuda.empty_cache()


def moments(torch):
    from repro_torch.configs.base import get_config
    from repro_torch.launch.train import opt_config
    from repro_torch.train.trainer import Trainer, TrainerConfig
    base = get_config("falcon-mamba-7b")
    for layers, opt_state, lr in ((16, "f32", 3e-4), (16, "int8", 3e-4),
                                  (16, "f32", 1e-4), (16, "int8", 1e-4),
                                  (64, "int8", 1e-4)):
        cfg = dataclasses.replace(base, n_layers=layers)
        trainer = Trainer(cfg, TrainerConfig(seq_len=512, global_batch=8,
                                             steps=5, log_every=1),
                          opt_config(lr, 5, opt_state), device="cuda")
        torch.cuda.reset_peak_memory_stats()
        log = trainer.train()["log"]
        print(json.dumps({
            "layers": layers, "opt_state": opt_state, "lr": lr,
            "losses": [e["loss"] for e in log],
            "grad_norms": [e["grad_norm"] for e in log],
            "step_s": [e["sec"] for e in log],
            "peak_device_bytes": torch.cuda.max_memory_allocated()}),
            flush=True)
        del trainer, log
        torch.cuda.empty_cache()


def grad_spread(torch):
    import chip_smoke as cs
    from repro_torch.configs.base import get_config
    from repro_torch.models import attention as attn
    from repro_torch.models import build_model
    from repro_torch.train.data import TokenPipeline
    cfg = dataclasses.replace(get_config("zamba2-2.7b"), n_layers=12,
                              dtype="float32")
    gpu = build_model(cfg, "cuda").init(0)
    cpu = cs._to(gpu, "cpu")
    batch = TokenPipeline(cfg.vocab, 512, 2, seed=5).batch_at(0)

    def names(tree, pre=""):
        if isinstance(tree, dict):
            return [x for k, v in tree.items() for x in names(v, f"{pre}.{k}")]
        if isinstance(tree, list):
            return [x for i, v in enumerate(tree)
                    for x in names(v, f"{pre}[{i}]")]
        return [pre]
    leaf_names = names(gpu)
    runs = {"card": cs._loss_and_grads(torch, cfg, gpu, batch, True)}
    threads = torch.get_num_threads()
    runs[f"cpu{threads}"] = cs._loss_and_grads(torch, cfg, cpu, batch, False)
    torch.set_num_threads(1)
    runs["cpu1"] = cs._loss_and_grads(torch, cfg, cpu, batch, False)
    torch.set_num_threads(threads)
    block = attn.attention_block
    attn.attention_block = lambda *a, impl=None, **k: block(*a, impl=None,
                                                              **k)
    runs["card_plain_attention"] = cs._loss_and_grads(torch, cfg, gpu, batch,
                                                      True)
    attn.attention_block = block
    for x, y in (("card", f"cpu{threads}"), ("cpu1", f"cpu{threads}"),
                 ("card", "cpu1"), ("card_plain_attention", "card")):
        (lx, gx), (ly, gy) = runs[x], runs[y]
        gaps = cs._leaf_gaps(gx, gy)
        top = sorted(range(len(gaps)), key=lambda i: -gaps[i])[:6]
        print(json.dumps({"pair": f"{x} vs {y}",
                          "loss_rel": abs(lx - ly) / abs(ly),
                          "leaf_max": max(gaps),
                          "leaves_over_1e-3": sum(g > 1e-3 for g in gaps),
                          "top": [[leaf_names[i], gaps[i]] for i in top]}),
              flush=True)


def main() -> int:
    import torch
    if len(sys.argv) != 2 or sys.argv[1] not in ("k7", "moments",
                                                 "grad-spread"):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("stateful_train_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    {"k7": k7, "moments": moments, "grad-spread": grad_spread}[sys.argv[1]](
        torch)
    import chip_smoke as cs
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
