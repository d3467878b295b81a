#!/usr/bin/env python3
"""Time K3's bf16 tensor-core kernels under other tile configurations.

    python3 tools/k3_tune.py [--hd 128] [--reps 20]

Needs one NVIDIA card and nvcc.  Builds ``csrc/flash_attention.cu`` once
more with an extra C entry point that launches its forward, dK/dV or dQ
kernel template at each configuration listed below (no other code: the
kernels are the source's own), gates each against the plain versions at
qwen3-0.6b's training shape (B 8 x 16 heads over 8 KV heads, S 512,
causal), and prints one JSON line per configuration with its device time
(calls captured in a CUDA graph, replayed between CUDA events) beside the
configuration ``dispatch_bf16`` uses at head_dim 128 (the first of each
list).  The kernels' registers and spills are printed from ptxas.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# (BK,): kv tile of the forward and dQ (64-row q tiles, 4 warps)
ROW_CONFIGS = [(64,), (32,), (16,)]
# (BQ, HS): q tile and head_dim split of dK/dV (64-key tiles, 4 HS warps)
KEY_CONFIGS = [(64, 1), (32, 1), (16, 1), (64, 2)]


def source(hd: int) -> str:
    cases = []
    for i, (bk,) in enumerate(ROW_CONFIGS):
        cases.append(f"    case {i}: return (int)launch_fwd_mma<{hd}, {bk}>"
                     "(a);")
        cases.append(f"    case {200 + i}: return (int)launch_dq_mma<{hd}, "
                     f"{bk}>(a);")
    for i, (bq, hs) in enumerate(KEY_CONFIGS):
        cases.append(f"    case {100 + i}: return (int)launch_dkdv_mma<{hd}, "
                     f"{bq}, {hs}>(a);")
    src = ROOT / "src/repro_torch/kernels/csrc/flash_attention.cu"
    return f'''#include "{src}"
extern "C" int k3_tune(int which, const void* q, const void* k,
                       const void* v, const void* o, void* out, void* lse,
                       const void* dout, void* dq, void* dk, void* dv,
                       void* D, int BH, int BKV, int Sq, int Skv, int hd,
                       void* stream) {{
  Args a{{}};
  a.q = q; a.k = k; a.v = v; a.o = o; a.out = out; a.lse = lse;
  a.dout = dout; a.dq = dq; a.dk = dk; a.dv = dv; a.D = D;
  a.BH = BH; a.BKV = BKV;
  a.s = make_shape(BH, BKV, Sq, Skv, hd, 1, 0);
  a.stream = static_cast<cudaStream_t>(stream);
  switch (which) {{
    case 300: return (int)launch_dot<bf16>(a);
{chr(10).join(cases)}
  }}
  return (int)cudaErrorInvalidValue;
}}
'''


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--hd", type=int, default=128)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k3_tune: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as k3
    out_dir = build.BUILD_DIR / "k3_tune"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, lib = out_dir / "k3_tune.cu", out_dir / "libk3_tune.so"
    cu.write_text(source(args.hd))
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                           str(cu)], capture_output=True, text=True)
    print(proc.stdout + proc.stderr if proc.returncode else "", end="")
    assert proc.returncode == 0, "nvcc failed"
    entry = None
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry function" in line and "mma_kernel" in line:
            entry = line.split("'")[1][-60:]
        elif entry and ("registers" in line or "spill stores" in line):
            print(json.dumps({"ptxas": entry, "line": line.strip()}))
    fn = ctypes.CDLL(str(lib)).k3_tune
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 11 \
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    print(json.dumps({"card": chip_smoke.nvidia_smi(),
                      "torch": torch.__version__}))

    b, h, kvh, sq, hd = 8, 16, 8, 512, args.hd
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, do = (torch.randn((b * h, sq, hd), generator=gen, device="cuda")
             .bfloat16() for _ in range(2))
    k, v = (torch.randn((b * kvh, sq, hd), generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    o, lse = k3.flash_attention_kernel(q, k, v, True, 0)
    ro, _ = ref.flash_attention_ref(q, k, v, True, 0)
    rdq, rdk, rdv = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, True, 0)
    D = torch.empty((b * h, sq), dtype=torch.float32, device="cuda")
    out, lse2 = torch.empty_like(o), torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)

    def call(which):
        err = fn(which, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 o.data_ptr(), out.data_ptr(), lse2.data_ptr(),
                 do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 D.data_ptr(), b * h, b * kvh, sq, sq, hd,
                 torch.cuda.current_stream().cuda_stream)
        assert err == 0, (which, err)

    call(300)
    # D needs lse's pointer for nothing; dK/dV and dQ read the product's lse
    lse2.copy_(lse)
    groups = [("forward", 0, ROW_CONFIGS, lambda: [(out, ro)]),
              ("dkdv", 100, KEY_CONFIGS, lambda: [(dk, rdk), (dv, rdv)]),
              ("dq", 200, ROW_CONFIGS, lambda: [(dq, rdq)])]
    for kind, base, configs, outs in groups:
        for i, cfg in enumerate(configs):
            if kind == "forward":
                call(base + i)
            else:
                # the backward kernels read lse from the ``lse`` argument
                lse2.copy_(lse)
                call(base + i)
            torch.cuda.synchronize()
            errs = [ref.row_rel_err(g, w, 0.0 if kind == "forward"
                                    else ref.GRAD_ROW_FLOOR)[1]
                    for g, w in outs()]
            ms = chip_smoke.graph_ms(lambda: call(base + i), reps=args.reps)
            print(json.dumps({"kernel": kind, "config": cfg,
                              "default": i == 0, "ms": ms,
                              "row_rel_err": max(errs),
                              "ok": max(errs) <= ref.ROW_TOL[torch.bfloat16]}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
