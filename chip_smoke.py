#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check every kernel.

    python3 chip_smoke.py

Phases, each printing JSON objects one per line:

1. card     — nvidia-smi's name and power limit, torch and CUDA versions.
2. build    — nvcc builds the CUDA kernels (paged attention, matmul, LoRA
              shrink and expand, selective scan) from the repo's sources for
              sm_90a, one nvcc process per source, all started together, and
              prints ptxas's register and spill lines; Triton compiles the
              rmsnorm kernel (its registers and spills are printed per width
              in the kernel lines).
3. kernels  — each kernel against its plain PyTorch version on the card at
              the shapes its path gives it (f32 and bf16), row by row
              (``ref.row_rel_err``), and planted faults that the same gate
              must reject; device times (calls captured in a CUDA graph and
              replayed between CUDA events) of the kernel, the plain version
              and one PyTorch library call that computes the same function
              (a yardstick the port never calls), the kernel wrapper's
              host-inclusive time, and the least time the card could take
              (bytes moved over 3.35 TB/s or operations over the type's peak
              rate).  Paged attention runs at both head layouts that serve
              (qwen3-0.6b: 16 heads over 8 KV heads, head_dim 128; zamba2's
              shared block: 32 heads over 32, head_dim 80), through the
              model-facing ``ops`` entries.  The LoRA kernels run at the
              serve path's shapes (T = 8
              decode rows and a 256-row prefill chunk, every projection's
              widths, rank 16, 8 slots, block_out 128) under four slot mixes;
              base rows must be exact zeros and the expand output bitwise the
              same for block_out 33, 128 and 256; their yardstick is
              ``torch.bmm`` over per-row factors gathered before the call.
              The selective scan (K7) runs at the ssm path's shapes (a
              decode step of 8 rows, a 256-step prefill chunk, a 300-step
              prefill, d_inner 8,192, state 16, f32): y and h_last row by
              row, one launch bitwise equal to the engine's split into
              chunks of 256 (state carried, identity-padded tail), and three
              planted faults (h0 ignored, the last step dropped, one tile of
              d unwritten); it has no library call.  rmsnorm also runs at
              the ssm and hybrid widths (4,096, 2,560 and the gated norm's
              5,120) at decode and prefill-chunk rows.
4. compile  — ``repro_torch.pipeline.compile()`` with the H100 record on the
              serve engine's full-width decode attention term, a full-width
              qwen3-0.6b SwiGLU MLP term (not vectorized, so its products stay
              logical) and the prefill-chunk term (default options: the packed
              path); bf16 inputs on the card, each compiled program against
              the same term compiled with kernels off (or evaluated plainly),
              with the matmul kernel's launches counted; each report's
              summary, the H100 kernel plan and the engine's pages_per_fetch.
5. serve    — the port's ServeEngine (kernel planning on, the default)
              serves 16 requests of full-width qwen3-0.6b in bf16 (random
              weights from seed 0); every kernel's launch count is zeroed
              just before and read just after.  A short greedy run with
              planning off must give the same tokens as one with it on.
   lora     — the same engine with four synthesized tenants loaded serves the
              same 16 requests, every fifth one base and the others spread
              over the tenants: every request finishes, the invariants hold
              after every step, the adapter slab is the size its shape gives,
              and each LoRA kernel launches exactly once per adapted
              projection and layer of every dispatch that holds an adapter
              row.
   lora_identity — greedy tokens: base requests on an engine with tenants
              loaded and pinned equal an adapter-free engine's (with no LoRA
              launch), a rank-0 tenant gives the base tokens, and one prompt
              under two tenants gives two streams, neither adopting the
              other's prefix.
   profile  — torch.profiler over 12 steps of a second engine: device busy
              time by kernel against the window's wall time, and each
              kernel's device time per launch on the main path.
6. oracle   — teacher-forced logits of the paged path (kernels) against the
              dense prefill + decode path (plain attention), f32 and bf16;
              and one tenant's request (a 256-token prompt chunk and 8 decode
              steps, full width, 2 layers, f32) through the paged path with
              the kernels on the card against the same path with the plain
              versions on the CPU.
7. ssm_serve, hybrid_serve — the serve workload through full-width
              falcon-mamba-7b and zamba2-2.7b in bf16 (random weights from
              seed 0): every request finishes, the invariants hold after
              every step, the state slab is empty at the end, the
              attention-free engine allocates no KV block, and each dispatch
              launches K7 once per Mamba1 layer (64, ssm) or never (hybrid)
              and K1 once per shared-block call site (9, hybrid) or never
              (ssm).  ssm_swap_resume: a greedy request preempted by swap
              resumes from the slab's host tier with the unpreempted run's
              tokens.  ssm_profile, hybrid_profile: a profiled window each.
8. ssm_oracle, hybrid_oracle — one request (a 256-token prompt chunk and 8
              decode steps, full width, f32; 2 Mamba1 layers, or 2 hybrid
              segments) through the paged path with the kernels on the card
              against the same path with the plain versions on the CPU;
              then the same tokens through the dense path (plain attention,
              no K1) on the card against the CPU.

Then a ``{"kernels": [...]}`` summary line (each row's launches from the
main path that gives its shape, named in its ``path``), nvidia-smi's line, and, last,
``{"ok": true, "device": {...}}``.  Any failed check raises and exits
non-zero before that line.  Without a CUDA device, or without the repo's
``src/`` beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
DEV = "cuda"
HBM_BYTES_PER_S = 3.35e12            # H100 SXM device memory
PEAK_OPS_PER_S = {"float32": 67e12,  # f32 outside the tensor cores
                  "bfloat16": 989e12}  # bf16 dense tensor-core rate
BF16_ORACLE_TOL = 5e-2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def rel_err(got, want) -> tuple:
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    return err, err / max(1.0, float(want.abs().max()))


def host_ms(fn, reps: int = 5, samples: int = 21) -> float:
    """Median over ``samples`` of the mean time of ``reps`` back-to-back
    eager calls, from CUDA events, after a warm-up: host dispatch included,
    which is what a small kernel costs on the eager main path."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def graph_ms(fn, reps: int = 20, samples: int = 21) -> float:
    """Device time of one call: ``reps`` calls captured in one CUDA graph,
    replayed ``samples`` times between CUDA events, median per call.  The
    replay needs no host, so this is the time of the call's kernels on the
    card (and the graph's gaps between them), not of their dispatch."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    del graph
    return statistics.median(times)


def gate(name, got, want, faults, margin=4.0) -> dict:
    """Hold a kernel's output to its plain version row by row, and check
    that each planted fault (a wrong output at the same shape) fails the
    same gate by ``margin`` times its tolerance."""
    from repro_torch.kernels import ref
    import torch
    tol = ref.ROW_TOL[want.dtype]
    assert torch.isfinite(got.float()).all(), f"{name}: non-finite output"
    err, rel = ref.row_rel_err(got, want)
    assert rel <= tol, f"{name}: row rel err {rel} > {tol}"
    planted = {k: ref.row_rel_err(f, want)[1] for k, f in faults.items()}
    for k, r in planted.items():
        assert r > margin * tol, \
            f"{name}: planted fault {k} passes the gate ({r})"
    return dict(max_abs_err=err, row_rel_err=rel, tol=tol,
                planted_fault_row_rel_err=planted)


def bound(nbytes: float, ops: float, dtype: str) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def counters() -> dict:
    """Each kernel's launch counter: name -> (wrapper module, attribute)."""
    from repro_torch.kernels import (lora, matmul, paged_attention, rmsnorm,
                                     ssm_scan)
    return {"paged_attention": (paged_attention, "launches"),
            "rmsnorm": (rmsnorm, "launches"),
            "matmul": (matmul, "launches"),
            "lora_shrink": (lora, "shrink_launches"),
            "lora_expand": (lora, "expand_launches"),
            "ssm_scan": (ssm_scan, "launches")}


def zero_counts() -> None:
    for mod, attr in counters().values():
        setattr(mod, attr, 0)


def read_counts() -> dict:
    return {k: getattr(mod, attr) for k, (mod, attr) in counters().items()}


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _pool(torch, gen, n, bs, kv, hd, dtype):
    k = torch.randn((n, bs, kv, hd), generator=gen, device=DEV) * 0.5
    v = torch.randn((n, bs, kv, hd), generator=gen, device=DEV) * 0.5
    return k.to(dtype), v.to(dtype)


def _tables(torch, lens, m, bs, n, rng):
    """Distinct live blocks per row, null-padded past ceil(len/bs)."""
    perm = rng.permutation(np.arange(1, n))
    tables = np.zeros((len(lens), m), np.int32)
    at = 0
    for i, ln in enumerate(lens):
        used = -(-ln // bs)
        tables[i, :used] = perm[at:at + used]
        at += used
    return torch.from_numpy(tables).to(DEV)


# paged attention's head layouts, each with the main path that gives it:
# qwen3-0.6b (16 query heads over 8 KV heads, head_dim 128) and zamba2-2.7b's
# shared block (32 heads, one per KV head, head_dim 80)
PAGED_SHAPES = (("serve", 16, 8, 128), ("hybrid_serve", 32, 32, 80))


def check_paged_attention(torch, results):
    for path, h, kv, hd in PAGED_SHAPES:
        _check_paged_attention(torch, results, path, h, kv, hd)


def _check_paged_attention(torch, results, path, h, kv, hd):
    """K1 through ``ops.paged_attention`` / ``ops.paged_attention_chunk``
    (so the callers' grouping copies are covered) at one head layout: a
    decode batch of 8 rows over ragged spans up to 2,048 and a 256-token
    prefill chunk at two offsets, f32 and bf16."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.models.attention import paged_gather
    b, bs, max_len = 8, 16, 2048
    m = max_len // bs
    n = b * m + 1
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=DEV).manual_seed(0)
    lens_list = [1, 17, 255, 512, 1000, 1537, 2000, 2048]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        esize = torch.finfo(dtype).bits // 8
        kp, vp = _pool(torch, gen, n, bs, kv, hd, dtype)

        # decode: q (B,1,H,hd) over ragged spans with null-padded tables
        tables = _tables(torch, lens_list, m, bs, n, rng)
        lens = torch.tensor(lens_list, dtype=torch.int32, device=DEV)
        q = (torch.randn((b, 1, h, hd), generator=gen, device=DEV)
             * 0.5).to(dtype)
        got = ops.paged_attention(q, kp, vp, tables, lens)
        want = ref.paged_attention_ref(q, kp, vp, tables, lens)
        zeroed = got.clone()
        zeroed[lens > 255] = 0
        skip = torch.where(lens > bs, (lens - 1) // bs * bs, lens)
        checked = gate(f"paged_attention decode {dname}", got, want, {
            "zero_spans_over_255": zeroed,
            "skip_last_page": ops.paged_attention(q, kp, vp, tables, skip)})
        kg = paged_gather(kp, tables).repeat_interleave(h // kv, dim=2) \
            .transpose(1, 2)
        vg = paged_gather(vp, tables).repeat_interleave(h // kv, dim=2) \
            .transpose(1, 2)
        mask = (torch.arange(m * bs, device=DEV)[None, :]
                < lens[:, None])[:, None, None, :]
        qh = q.transpose(1, 2)
        live = sum(lens_list)
        nbytes = 2 * q.numel() * esize + tables.numel() * 4 + b * 4 \
            + 2 * live * kv * hd * esize
        t_bound, by = bound(nbytes, 4.0 * h * hd * live, dname)
        results.append(dict(
            name="paged_attention/decode", dtype=dname, path=path,
            shape=f"B={b} H={h} KV={kv} hd={hd} bs={bs} lens={lens_list}",
            **checked,
            kernel_ms=graph_ms(lambda: ops.paged_attention(
                q, kp, vp, tables, lens)),
            host_ms=host_ms(lambda: ops.paged_attention(
                q, kp, vp, tables, lens)),
            plain_ms=graph_ms(lambda: ref.paged_attention_ref(
                q, kp, vp, tables, lens)),
            library_ms=graph_ms(lambda: F.scaled_dot_product_attention(
                qh, kg, vg, attn_mask=mask)),
            bound_ms=t_bound, bound_by=by))

        # prefill chunk: C = 256 query tokens (R = 512 rows per KV head)
        c = 256
        for start in (0, 512):
            kv_len = start + c
            tables = _tables(torch, [kv_len], m, bs, n, rng)
            cpos = torch.arange(start, start + c, dtype=torch.int32,
                                device=DEV)
            kvl = torch.tensor([kv_len], dtype=torch.int32, device=DEV)
            q = (torch.randn((1, c, h, hd), generator=gen, device=DEV)
                 * 0.5).to(dtype)
            got = ops.paged_attention_chunk(q, kp, vp, tables, cpos, kvl)
            want = ref.paged_attention_chunk_ref(q, kp, vp, tables, cpos, kvl)
            zeroed = got.clone()
            zeroed[:, -1] = 0
            checked = gate(f"paged_attention chunk@{start} {dname}", got,
                           want, {
                               "zero_last_token": zeroed,
                               "skip_last_page": ops.paged_attention_chunk(
                                   q, kp, vp, tables, cpos,
                                   (kvl - 1) // bs * bs)})
            kg = paged_gather(kp, tables).repeat_interleave(h // kv, dim=2) \
                .transpose(1, 2)
            vg = paged_gather(vp, tables).repeat_interleave(h // kv, dim=2) \
                .transpose(1, 2)
            kpos = torch.arange(m * bs, device=DEV)
            cmask = ((kpos[None, :] <= cpos[:, None].long())
                     & (kpos[None, :] < kv_len))[None, None]
            qh = q.transpose(1, 2)
            pairs = sum(start + i + 1 for i in range(c))
            nbytes = 2 * q.numel() * esize + tables.numel() * 4 + c * 4 + 4 \
                + 2 * kv_len * kv * hd * esize
            t_bound, by = bound(nbytes, 4.0 * h * hd * pairs, dname)
            results.append(dict(
                name="paged_attention/prefill_chunk", dtype=dname,
                path=path,
                shape=f"C={c} start={start} H={h} KV={kv} hd={hd} bs={bs}",
                **checked,
                kernel_ms=graph_ms(lambda: ops.paged_attention_chunk(
                    q, kp, vp, tables, cpos, kvl)),
                host_ms=host_ms(lambda: ops.paged_attention_chunk(
                    q, kp, vp, tables, cpos, kvl)),
                plain_ms=graph_ms(lambda: ref.paged_attention_chunk_ref(
                    q, kp, vp, tables, cpos, kvl)),
                library_ms=graph_ms(lambda: F.scaled_dot_product_attention(
                    qh, kg, vg, attn_mask=cmask)),
                bound_ms=t_bound, bound_by=by))
        del kp, vp


# rmsnorm's shapes, at decode and prefill-chunk rows: qwen3-0.6b's norms
# (d 1,024, the q/k norms at 128), falcon-mamba-7b's layer norms (4,096),
# zamba2-2.7b's layer and shared-block norms (2,560) and its Mamba2 gated
# norm over d_inner (5,120); and the main path that gives each width
RMSNORM_SHAPES = ((8, 1024), (256, 1024), (8 * 16, 128), (256 * 16, 128),
                  (8, 4096), (256, 4096), (8, 2560), (256, 2560),
                  (8, 5120), (256, 5120))
RMSNORM_PATH = {1024: "serve", 128: "serve", 4096: "ssm_serve",
                2560: "hybrid_serve", 5120: "hybrid_serve"}


def triton_registers(torch, x, w, eps):
    """Registers and spills of the Triton rmsnorm kernel compiled for x's
    width: one direct launch, whose compiled kernel reports them (None
    where this Triton version does not)."""
    from repro_torch.kernels._rmsnorm_triton import rmsnorm_rows
    from repro_torch.kernels.rmsnorm import _block_shape
    n, d = x.shape
    block_d, rows = _block_shape(d)
    ck = rmsnorm_rows[(-(-n // rows),)](x, w, torch.empty_like(x), n, d,
                                       float(eps), BLOCK_D=block_d,
                                       ROWS=rows, num_warps=4)
    return {"block_d": block_d, "rows": rows,
            "registers": getattr(ck, "n_regs", None),
            "spills": getattr(ck, "n_spills", None)}


def check_rmsnorm(torch, results):
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm_kernel
    gen = torch.Generator(device=DEV).manual_seed(1)
    eps = 1e-6
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        esize = torch.finfo(dtype).bits // 8
        for rows, d in RMSNORM_SHAPES:
            x = torch.randn((rows, d), generator=gen, device=DEV).to(dtype)
            w = (1 + 0.1 * torch.randn((d,), generator=gen,
                                       device=DEV)).to(dtype)
            got = rmsnorm_kernel(x, w, eps)
            want = ref.rmsnorm_ref(x, w, eps)
            tail = got.clone()
            tail[:, -d // 8:] = 0
            checked = gate(f"rmsnorm ({rows},{d}) {dname}", got, want,
                           {"zero_tail_columns": tail})
            lib = (lambda: F.rms_norm(x, (d,), w, eps)) \
                if hasattr(F, "rms_norm") else None
            t_bound, by = bound((2 * rows * d + d) * esize, 4.0 * rows * d,
                                dname)
            results.append(dict(
                name=f"rmsnorm/d{d}", dtype=dname, shape=f"({rows}, {d})",
                path=RMSNORM_PATH[d],
                **checked, triton=triton_registers(torch, x, w, eps),
                kernel_ms=graph_ms(lambda: rmsnorm_kernel(x, w, eps)),
                host_ms=host_ms(lambda: rmsnorm_kernel(x, w, eps)),
                plain_ms=graph_ms(lambda: ref.rmsnorm_ref(x, w, eps)),
                library_ms=graph_ms(lib) if lib else None,
                bound_ms=t_bound, bound_by=by))


# the matmul kernel's shapes on the compile path: the decode term's two
# products, the prefill chunk's first, the SwiGLU MLP's two
MATMUL_SHAPES = ((1, 128, 2048), (1, 2048, 128), (256, 128, 2048),
                 (256, 1024, 3072), (256, 3072, 1024))
MATMUL_BK = 32      # csrc/matmul.cu's k step


def check_matmul(torch, results):
    from repro_torch.kernels import ref
    from repro_torch.kernels.matmul import matmul_kernel
    gen = torch.Generator(device=DEV).manual_seed(2)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        esize = torch.finfo(dtype).bits // 8
        for m, k, n in MATMUL_SHAPES:
            a = torch.randn((m, k), generator=gen, device=DEV).to(dtype)
            b = torch.randn((k, n), generator=gen, device=DEV).to(dtype)
            got = matmul_kernel(a, b)
            want = ref.matmul_ref(a, b)
            kk = (k - 1) // MATMUL_BK * MATMUL_BK
            zeroed = got.clone()
            zeroed[:, (n - 1) // 64 * 64:] = 0
            # the k-skip fault moves a row by about sqrt(32 / K) of its
            # largest value (0.10 at K = 3072): a margin of 2 keeps it clear
            # of the bf16 tolerance at every shape here
            checked = gate(f"matmul ({m},{k})@({k},{n}) {dname}", got, want, {
                "skip_last_k_tile": matmul_kernel(a[:, :kk].contiguous(),
                                                  b[:kk].contiguous()),
                "zero_last_column_tile": zeroed}, margin=2.0)
            t_bound, by = bound((m * k + k * n + m * n) * esize,
                                2.0 * m * n * k, dname)
            results.append(dict(
                name="matmul", dtype=dname, shape=f"({m},{k})@({k},{n})",
                path="compile",
                **checked,
                kernel_ms=graph_ms(lambda: matmul_kernel(a, b)),
                host_ms=host_ms(lambda: matmul_kernel(a, b)),
                plain_ms=graph_ms(lambda: ref.matmul_ref(a, b)),
                library_ms=graph_ms(lambda: torch.matmul(a, b)),
                bound_ms=t_bound, bound_by=by))


# the LoRA kernels' shapes on the serve path: rows of a decode step and of a
# prefill chunk; the projections' input and output widths at qwen3-0.6b
# (q, k/v, o, gate/up, down); the store's rank slot and slot count; the H100
# plan's expand tile
LORA_ROWS = (8, 256)
LORA_D_IN = (1024, 2048, 3072)
LORA_D_OUT = (1024, 2048, 3072)
LORA_RANK, LORA_SLOTS, LORA_BLOCK_OUT = 16, 8, 128


def lora_mixes(t):
    """Slot mixes of ``t`` rows: repeats of three adapters, all base rows,
    base and adapter rows interleaved, and one row alone."""
    return {"repeats": [i % 3 for i in range(t)],
            "all_base": [-1] * t,
            "interleaved": [-1 if i % 2 else (i // 2) % LORA_SLOTS
                            for i in range(t)],
            "single_row": [1]}


def check_lora(torch, results):
    """K5 and K6 against their plain versions at the serve path's shapes:
    every mix in f32 and bf16 through the row gate, exact zeros on base
    rows, the expand output bitwise the same for three tiles, and two
    planted faults per kernel (every row reads slot 0; the last rank block
    or output tile left zero).  The "repeats" mix is timed."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.lora import lora_expand_kernel, lora_shrink_kernel
    gen = torch.Generator(device=DEV).manual_seed(4)
    r, s = LORA_RANK, LORA_SLOTS
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        esize = torch.finfo(dtype).bits // 8
        for t in LORA_ROWS:
            for mix, idx_list in lora_mixes(t).items():
                idx = torch.tensor(idx_list, dtype=torch.int32, device=DEV)
                rows = len(idx_list)
                live = idx >= 0
                slot0 = torch.where(live, 0, idx)
                n_live = int(live.sum())
                n_adapters = len({i for i in idx_list if i >= 0})
                for d in LORA_D_IN:
                    x = torch.randn((rows, d), generator=gen,
                                    device=DEV).to(dtype)
                    a = (torch.randn((s, d, r), generator=gen, device=DEV)
                         * 0.1).to(dtype)
                    got = lora_shrink_kernel(x, a, idx)
                    want = ref.lora_shrink_ref(x, a, idx)
                    assert torch.equal(got[~live], torch.zeros_like(
                        got[~live])), "lora_shrink: base rows not zero"
                    faults = {}
                    if bool((idx > 0).any()):
                        tail = got.clone()
                        tail[:, -8:] = 0
                        faults = {"every_row_reads_slot_0":
                                  lora_shrink_kernel(x, a, slot0),
                                  "last_rank_block_zero": tail}
                    checked = gate(f"lora_shrink T={rows} d={d} {mix} "
                                   f"{dname}", got, want, faults)
                    if mix != "repeats":
                        continue
                    a_rows = a[idx.clamp_min(0).long()]
                    t_bound, by = bound(
                        (rows * d + n_adapters * d * r) * esize
                        + rows * 4 + rows * r * 4,
                        2.0 * n_live * d * r, dname)
                    results.append(dict(
                        name="lora_shrink", dtype=dname, path="lora_serve",
                        shape=f"T={rows} d={d} R={r} S={s} {mix}", **checked,
                        kernel_ms=graph_ms(lambda: lora_shrink_kernel(
                            x, a, idx)),
                        host_ms=host_ms(lambda: lora_shrink_kernel(
                            x, a, idx)),
                        plain_ms=graph_ms(lambda: ref.lora_shrink_ref(
                            x, a, idx)),
                        library_ms=graph_ms(lambda: torch.bmm(
                            x[:, None, :], a_rows)),
                        library="torch.bmm over per-row A gathered before "
                                "the call (yardstick)",
                        bound_ms=t_bound, bound_by=by))
                for o in LORA_D_OUT:
                    h = torch.randn((rows, r), generator=gen, device=DEV)
                    b = (torch.randn((s, r, o), generator=gen, device=DEV)
                         * 0.1).to(dtype)
                    got = lora_expand_kernel(h, b, idx, LORA_BLOCK_OUT)
                    want = ref.lora_expand_ref(h, b, idx, dtype)
                    assert torch.equal(got[~live], torch.zeros_like(
                        got[~live])), "lora_expand: base rows not zero"
                    for bo in (33, 256):
                        assert torch.equal(lora_expand_kernel(h, b, idx, bo),
                                           got), \
                            f"lora_expand: block_out {bo} changed the output"
                    faults = {}
                    if bool((idx > 0).any()):
                        tail = got.clone()
                        tail[:, (o - 1) // LORA_BLOCK_OUT
                             * LORA_BLOCK_OUT:] = 0
                        faults = {"every_row_reads_slot_0":
                                  lora_expand_kernel(h, b, slot0,
                                                     LORA_BLOCK_OUT),
                                  "last_output_tile_unwritten": tail}
                    checked = gate(f"lora_expand T={rows} O={o} {mix} "
                                   f"{dname}", got, want, faults)
                    if mix != "repeats":
                        continue
                    b_rows = b[idx.clamp_min(0).long()]
                    hb = h.to(dtype)[:, None, :]
                    t_bound, by = bound(
                        rows * r * 4 + n_adapters * r * o * esize + rows * 4
                        + rows * o * esize, 2.0 * n_live * r * o, dname)
                    results.append(dict(
                        name="lora_expand", dtype=dname, path="lora_serve",
                        shape=f"T={rows} O={o} R={r} S={s} "
                              f"block_out={LORA_BLOCK_OUT} {mix}", **checked,
                        kernel_ms=graph_ms(lambda: lora_expand_kernel(
                            h, b, idx, LORA_BLOCK_OUT)),
                        host_ms=host_ms(lambda: lora_expand_kernel(
                            h, b, idx, LORA_BLOCK_OUT)),
                        plain_ms=graph_ms(lambda: ref.lora_expand_ref(
                            h, b, idx, dtype)),
                        library_ms=graph_ms(lambda: torch.bmm(hb, b_rows)),
                        library="torch.bmm over per-row B gathered before "
                                "the call (yardstick)",
                        bound_ms=t_bound, bound_by=by))


# the selective scan's shapes on the ssm path (falcon-mamba-7b: d_inner
# 8,192, state 16): a decode step of 8 rows, one 256-token prefill chunk, and
# a 300-token prefill (one launch over all 300 steps, held bitwise against
# the engine's split into chunks of 256 with an identity-padded tail)
SSM_D, SSM_N, SSM_CHUNK = 8192, 16, 256
SSM_CASES = (("decode", 8, 1), ("prefill_chunk", 1, 256),
             ("chunked_ragged", 1, 300))
SSM_LIBRARY = ("none: no single PyTorch call computes a linear recurrence "
               "(torch.cumsum/cumprod are associative scans of one operator)")


def _ssm_inputs(torch, gen, b, t, d, n):
    """The layer's own distributions: a = exp(dt A) with dt = softplus(~-4.6)
    and A = -(1..N), b = dt B x, c = C, a non-zero h0."""
    import torch.nn.functional as F
    dt = F.softplus(torch.randn((b, t, d), generator=gen, device=DEV) * 0.5
                    - 4.6)
    A = -torch.arange(1, n + 1, dtype=torch.float32, device=DEV)
    a = torch.exp(dt[..., None] * A)
    bb = dt[..., None] * torch.randn((b, t, 1, n), generator=gen, device=DEV) \
        * torch.randn((b, t, d, 1), generator=gen, device=DEV)
    c = torch.randn((b, t, n), generator=gen, device=DEV)
    h0 = torch.randn((b, d, n), generator=gen, device=DEV) * 0.5
    return a.contiguous(), bb.contiguous(), c, h0


def _split_scan(torch, a, bb, c, h0, chunk):
    """The scan as the engine's chunked prefill runs it: one launch per
    ``chunk`` steps, each resuming from the last launch's h_last, the
    ragged last chunk padded to ``chunk`` steps with identity steps (a = 1,
    b = 0, as ``mamba1_chunk`` makes a masked position)."""
    from repro_torch.kernels import ops
    bsz, t, d, n = a.shape
    ys, h = [], h0
    for s in range(0, t, chunk):
        at, bt, ct = a[:, s:s + chunk], bb[:, s:s + chunk], c[:, s:s + chunk]
        pad = chunk - at.shape[1]
        if pad:
            at = torch.cat([at, at.new_ones((bsz, pad, d, n))], dim=1)
            bt = torch.cat([bt, bt.new_zeros((bsz, pad, d, n))], dim=1)
            ct = torch.cat([ct, ct.new_zeros((bsz, pad, n))], dim=1)
        y, h = ops.ssm_scan(at, bt, ct, h)
        ys.append(y[:, :chunk - pad])
    return torch.cat(ys, dim=1), h


def check_ssm_scan(torch, results):
    """K7 against its plain sequential version at the ssm path's shapes, row
    by row for y and h_last; one launch bitwise equal to the engine's split
    into chunks (state carried, identity-padded tail); three planted faults
    (h0 ignored, the last step dropped, one tile of d left unwritten) must
    fail the same gate.  Times: the kernel and the plain version from graph
    replay, the wrapper eagerly; bound = bytes of a, b, c, h0, y and h_last
    over 3.35 TB/s."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=DEV).manual_seed(9)
    d, n = SSM_D, SSM_N
    tile = 256 // n                  # the d values one block of the kernel owns
    for case, b, t in SSM_CASES:
        a, bb, c, h0 = _ssm_inputs(torch, gen, b, t, d, n)
        chunk = SSM_CHUNK if case == "chunked_ragged" else t

        def run(a=a, bb=bb, c=c, h0=h0):
            return ops.ssm_scan_chunked(a, bb, c, h0, chunk=chunk)
        y, h = run()
        ry, rh = ref.ssm_scan_ref(a, bb, c, h0)
        split_y, split_h = _split_scan(torch, a, bb, c, h0, chunk)
        bitwise = bool(torch.equal(y, split_y) and torch.equal(h, split_h))
        assert bitwise, f"ssm_scan {case}: one launch differs from the " \
            f"engine's split into chunks of {chunk}"
        fy0, fh0 = ops.ssm_scan(a, bb, c, torch.zeros_like(h0))
        a_drop, b_drop = a.clone(), bb.clone()
        a_drop[:, -1] = 1.0
        b_drop[:, -1] = 0.0
        fyd, fhd = ops.ssm_scan(a_drop, b_drop, c, h0)
        skip_y, skip_h = y.clone(), h.clone()
        skip_y[..., d // 2:d // 2 + tile] = 0
        skip_h[:, d // 2:d // 2 + tile] = 0
        gy = gate(f"ssm_scan {case} y", y, ry, {
            "h0_ignored": fy0, "last_step_dropped": fyd,
            "d_tile_skipped": skip_y})
        gh = gate(f"ssm_scan {case} h_last", h, rh, {
            "h0_ignored": fh0, "last_step_dropped": fhd,
            "d_tile_skipped": skip_h})
        nbytes = 4 * (2 * a.numel() + c.numel() + 2 * h0.numel() + y.numel())
        t_bound, by = bound(nbytes, 4.0 * a.numel() + 2.0 * y.numel() * n,
                            "float32")
        plain_reps = 20 if t == 1 else 2
        results.append(dict(
            name=f"ssm_scan/{case}", dtype="float32", path="ssm_serve",
            shape=f"B={b} T={t} D={d} N={n} chunk={chunk}",
            max_abs_err=max(gy["max_abs_err"], gh["max_abs_err"]),
            row_rel_err=max(gy["row_rel_err"], gh["row_rel_err"]),
            tol=gy["tol"], y_gate=gy, h_last_gate=gh,
            one_launch_bitwise_split=bitwise,
            h_last_bitwise_plain=bool(torch.equal(h, rh)),
            kernel_ms=graph_ms(run), host_ms=host_ms(run),
            plain_ms=graph_ms(lambda: ref.ssm_scan_chunked_ref(
                a, bb, c, h0, chunk), reps=plain_reps),
            library_ms=None, library=SSM_LIBRARY,
            bound_ms=t_bound, bound_by=by))
        del a, bb, c, h0, a_drop, b_drop


# ---------------------------------------------------------------------------
# Phase 4: compile
# ---------------------------------------------------------------------------

def _term_inputs(torch, term, gen, dtype, scale=0.1):
    shapes = {}

    def walk(t):
        if t.op == "input":
            shapes[t.attr("name")] = t.attr("shape")
        for c in t.children:
            walk(c)
    walk(term)
    return {n: (torch.randn(s, generator=gen, device=DEV) * scale).to(dtype)
            for n, s in shapes.items()}


def compile_phase(torch, cfg, calls=4):
    """The compile pipeline's entry point on the H100 record: the engine's
    full-width decode attention term and a SwiGLU MLP term with kernels on
    run the matmul kernel (two launches per call each); the prefill-chunk
    term compiles to the packed path.  Every program is held to the same
    term with kernels off, row by row in bf16."""
    from repro_torch.core.codegen import compile_term, paged_pages_per_fetch
    from repro_torch.core.tensor_ir import inp, matmul, unary
    from repro_torch.kernels import ref
    from repro_torch.kernels import matmul as mm_mod
    from repro_torch.pipeline import CompileOptions, CompileTarget, Compiler
    from repro_torch.serve.engine import (chunked_prefill_attention_term,
                                          paged_decode_attention_term)
    hd, span, chunk = cfg.resolved_head_dim, 2048, 256
    x = inp("x", (chunk, cfg.d_model))
    mlp = matmul(unary(matmul(x, inp("w_up", (cfg.d_model, cfg.d_ff))),
                       kind="silu"), inp("w_down", (cfg.d_ff, cfg.d_model)))
    engine_opts = dict(extraction="greedy", schedule_iterations=10)
    cases = (
        ("decode", paged_decode_attention_term(span, hd),
         CompileOptions(**engine_opts), 2),
        ("mlp", mlp, CompileOptions(vectorize=False, **engine_opts), 2),
        ("prefill", chunked_prefill_attention_term(chunk, span, hd),
         CompileOptions(), 0),
    )
    gen = torch.Generator(device=DEV).manual_seed(3)
    compiler = Compiler(cache_dir=None)
    dtype = torch.bfloat16
    zero_counts()
    compiled = []
    out = {"phase": "compile", "hardware": CompileTarget().hardware.name,
           "terms": {}}
    for name, term, opts, per_call in cases:
        on = compiler.compile(term, target=CompileTarget(use_kernels=True),
                              options=opts)
        off = compiler.compile(term, target=CompileTarget(), options=opts)
        env = _term_inputs(torch, term, gen, dtype)
        plain = compile_term(term)(**env)
        n0 = mm_mod.launches
        for _ in range(calls):
            got = on(**env)
        torch.cuda.synchronize()
        launched = mm_mod.launches - n0
        assert launched == per_call * calls, (name, launched)
        want = off(**env)
        assert got.shape == want.shape and torch.isfinite(got.float()).all()
        err, rel = ref.row_rel_err(got, want)
        tol = ref.ROW_TOL[dtype]
        assert rel <= tol, f"compile {name}: row rel err {rel} > {tol}"
        rel_plain = ref.row_rel_err(got, plain)[1]
        assert rel_plain <= tol, f"compile {name}: vs plain {rel_plain}"
        rep = on.report
        out["terms"][name] = {
            "options": repr(opts), "packed": on.term != on.logical_term,
            "matmul_launches_per_call": launched / calls,
            "row_rel_err_vs_kernels_off": rel,
            "row_rel_err_vs_plain": rel_plain, "max_abs_err": err,
            "compile_s": rep.total_seconds, "pass_s": rep.pass_times,
            "modeled_speedup": rep.modeled_speedup,
            "schedule": {k: v for k, v in (rep.schedule or {}).items()
                         if k != "groups"},
            "kernel_plan": repr(rep.kernel_plan),
            "summary": rep.summary().splitlines()}
        compiled.append((name, on, off, env))
    launches = read_counts()
    assert launches["matmul"] > 0, launches
    plan = compiled[0][1].report.kernel_plan
    out.update(launches=launches,
               pages_per_fetch=paged_pages_per_fetch(plan, 16, span // 16))
    # device time of each compiled program, kernels on and off (after the
    # counts are read: timing launches do not count)
    for name, on, off, env in compiled:
        out["terms"][name]["kernels_on_ms"] = graph_ms(lambda: on(**env))
        out["terms"][name]["kernels_off_ms"] = graph_ms(lambda: off(**env))
    emit(out)
    return launches


# ---------------------------------------------------------------------------
# Phase 5: serve
# ---------------------------------------------------------------------------

def workload(vocab, n=16, seed=0, tenants=(None,)):
    """``n`` requests, prompts of 128-1024 tokens, every third opening with
    one shared 256-token prefix, every third sampled, 32 new tokens each;
    request i is served by ``tenants[i % len(tenants)]``."""
    from repro_torch.serve.engine import Request, SamplingParams
    rng = np.random.default_rng(seed)
    shared = rng.integers(1, vocab, size=256).tolist()
    reqs = []
    for i in range(n):
        plen = int(rng.integers(128, 1025))
        prompt = rng.integers(1, vocab, size=plen).tolist()
        if i % 3 == 0:
            prompt = shared + prompt[256:] if plen > 256 else shared[:plen]
        sp = SamplingParams(temperature=0.8, top_k=40, seed=i) \
            if i % 3 == 1 else SamplingParams()
        reqs.append(Request(rid=i, prompt=prompt, max_new=32, sampling=sp,
                            adapter_id=tenants[i % len(tenants)]))
    return reqs


def serve_engine(cfg, params, **kw):
    from repro_torch.serve.engine import ServeEngine
    return ServeEngine(cfg, params, max_batch=8, max_len=2048, block_size=16,
                       prefill_chunk_tokens=256, **kw)


def run_workload(torch, eng, reqs, counted=None):
    """Warm the engine up on two short requests (cuBLAS handles, Triton's
    specialisations, the LoRA kernels for a tenant's warm-up request), zero
    every launch count, serve ``reqs`` checking the KV invariants after
    every step, and read the counts.  Each dispatch goes through
    ``counted(kind, batch, call)`` ("prefill" or "decode"), which must
    return ``call()``."""
    from repro_torch.serve.engine import Request
    vocab = eng.cfg.vocab
    for i, r in enumerate(reqs[:2]):
        eng.submit(Request(rid=1000 + i, max_new=4, adapter_id=r.adapter_id,
                           prompt=[1 + t % (vocab - 1)
                                   for t in range(300 + i)]))
    eng.run_until_done()
    eng.release_prefix_cache()
    eng.reset_metrics()
    if counted is not None:
        fns = eng.fns

        def prefill(p, c, b, m_used=None):
            return counted("prefill", b, lambda: fns.prefill_chunk(
                p, c, b, m_used=m_used))

        def decode(p, c, b):
            return counted("decode", b, lambda: fns.decode_paged(p, c, b))
        eng.fns = dataclasses.replace(fns, prefill_chunk=prefill,
                                      decode_paged=decode)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    check_s = 0.0
    while eng.step():
        t1 = time.perf_counter()
        violations = eng.check_invariants()
        check_s += time.perf_counter() - t1
        assert violations == [], violations
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    m = eng.metrics()
    assert all(r.done and not r.rejected and len(r.out) == r.max_new
               for r in reqs), [r.finish_reason for r in reqs]
    assert m.requests_finished == len(reqs)
    # a stateful engine's slab holds no slot once every request retired
    assert eng.state_store is None \
        or eng.state_store.device.pool.num_used == 0
    return launches, m, {
        "requests": len(reqs), "engine_steps": eng.steps, "wall_s": wall,
        "invariant_check_s": check_s, "tokens_per_sec": m.tokens_per_sec,
        "ttft_mean_s": m.ttft_mean_s, "ttft_max_s": m.ttft_max_s,
        "itl_mean_s": m.itl_mean_s, "prefill_tokens": m.prefill_tokens,
        "decode_tokens": m.decode_tokens,
        "peak_blocks_used": m.peak_blocks_used,
        "pool_blocks": m.pool_blocks, "shared_blocks": m.shared_blocks,
        "re_prefill_avoided": m.re_prefill_avoided,
        "preemptions": m.preemptions,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches,
        "launches_per_step": {k: v / eng.steps for k, v in launches.items()}}


def serve_phase(torch, cfg, params):
    """The main path: 16 base requests, every kernel of the path launched."""
    eng = serve_engine(cfg, params)
    assert eng.kernel_plan is not None
    launches, _, out = run_workload(torch, eng, workload(cfg.vocab))
    assert launches["paged_attention"] > 0 and launches["rmsnorm"] > 0, \
        launches
    assert launches["lora_shrink"] == launches["lora_expand"] == 0, launches
    emit({"phase": "serve", "arch": cfg.name, "dtype": cfg.dtype, **out,
          "pages_per_fetch": eng.pages_per_fetch,
          "kernel_plan": repr(eng.kernel_plan),
          "compile_report_decode": eng.compile_report.summary().splitlines()})
    del eng
    torch.cuda.empty_cache()
    return launches, out


TENANTS = ("tenant-0", "tenant-1", "tenant-2", "tenant-3")
# at qwen3-0.6b's widths: launches of each LoRA kernel per dispatch with an
# adapter row (7 adapted projections x 28 layers), and the adapter slab of
# the store's defaults (8 slots x 28 layers x rank 16 x 22,528 summed
# d_in + d_out of the 7 projections x 2 B)
LORA_PER_DISPATCH = 7 * 28
LORA_SLAB_BYTES = 8 * 28 * 16 * 22528 * 2


def lora_serve_phase(torch, cfg, params, base):
    """Multi-LoRA serving: the serve phase's engine with four tenants
    loaded (rank 8, alpha 16) serves the same 16 requests, every fifth one
    base; the LoRA kernels launch once per adapted projection and layer of
    every dispatch that holds an adapter row, and never otherwise."""
    eng = serve_engine(cfg, params)
    for name in TENANTS:
        eng.load_adapter(name, rank=8, alpha=16.0)
    dispatches = {"lora": 0, "base": 0}

    def counted(kind, batch, call):
        dispatches["lora" if "lora" in batch else "base"] += 1
        return call()
    launches, m, out = run_workload(
        torch, eng, workload(cfg.vocab, tenants=(None,) + TENANTS), counted)
    per = len(eng.adapters.projs) * cfg.n_layers
    assert per == LORA_PER_DISPATCH, per
    assert dispatches["lora"] > 0, dispatches
    assert launches["lora_shrink"] == launches["lora_expand"] \
        == per * dispatches["lora"], (launches, dispatches)
    assert launches["paged_attention"] > 0 and launches["rmsnorm"] > 0
    assert m.adapter_device_bytes == LORA_SLAB_BYTES, m.adapter_device_bytes
    assert sorted(m.per_tenant) == sorted(("base",) + TENANTS), m.per_tenant
    emit({"phase": "lora_serve", "arch": cfg.name, "dtype": cfg.dtype, **out,
          "tenants": list(TENANTS), "lora_block_out": eng.lora_block_out,
          "rank_cap": eng.adapters.rank_cap,
          "adapter_device_bytes": m.adapter_device_bytes,
          "dispatches": dispatches, "lora_launches_per_lora_dispatch": per,
          "per_tenant": m.per_tenant,
          "base_serve": {k: base[k] for k in (
              "engine_steps", "wall_s", "tokens_per_sec", "ttft_mean_s",
              "ttft_max_s", "itl_mean_s", "launches_per_step")}})
    del eng
    torch.cuda.empty_cache()
    return launches


def lora_identity_phase(torch, cfg, params):
    """Greedy, 4 requests x 12 tokens: base rows with tenants loaded and
    pinned equal an adapter-free engine's with no LoRA launch; a rank-0
    tenant gives the base tokens; one prompt under two tenants gives two
    streams and neither adopts the other's prefix."""
    from repro_torch.serve.engine import Request, ServeEngine
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, cfg.vocab, size=int(n)).tolist()
               for n in (150, 300, 520, 700)]

    def engine():
        return ServeEngine(cfg, params, max_batch=4, max_len=1024,
                           block_size=16, prefill_chunk_tokens=256)

    def serve(eng, adapter_id=None, ps=prompts):
        reqs = [Request(rid=i, prompt=list(p), max_new=12,
                        adapter_id=adapter_id) for i, p in enumerate(ps)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        assert all(r.done and not r.rejected for r in reqs)
        return [r.out for r in reqs]

    base = serve(engine())
    eng = engine()
    for name in TENANTS:
        eng.load_adapter(name, rank=8, alpha=16.0)
        eng.adapters.pin(name)
    zero_counts()
    with_tenants = serve(eng)
    torch.cuda.synchronize()
    n = read_counts()
    assert with_tenants == base, "base tokens moved with tenants loaded"
    assert n["lora_shrink"] == n["lora_expand"] == 0, n
    eng.load_adapter("null-tenant", rank=0)
    rank0 = serve(eng, "null-tenant")
    assert rank0 == base, "a rank-0 tenant changed the base tokens"
    del eng
    eng = engine()
    for name in TENANTS[:2]:
        eng.load_adapter(name, rank=8, alpha=16.0)
    hits = []
    outs = []
    for name in (TENANTS[0], TENANTS[1], TENANTS[0]):
        eng.reset_metrics()
        outs.append(serve(eng, name, prompts[1:2])[0])
        m = eng.metrics()
        hits.append({"tenant": name, "shared_blocks": m.shared_blocks,
                     "re_prefill_avoided": m.re_prefill_avoided})
    assert outs[0] != outs[1], "two tenants gave the same tokens"
    assert hits[1]["shared_blocks"] == hits[1]["re_prefill_avoided"] == 0, \
        hits
    assert hits[2]["re_prefill_avoided"] > 0, hits
    emit({"phase": "lora_identity", "requests": len(prompts),
          "tokens_each": 12, "base_identical_with_tenants": True,
          "lora_launches_on_base_requests": n["lora_shrink"]
          + n["lora_expand"], "rank0_identical": True,
          "two_tenants_differ": True, "prefix_hits": hits,
          "same_tenant_reuse_identical": outs[2] == outs[0]})
    del eng
    torch.cuda.empty_cache()


def plan_identity(torch, cfg, params):
    """Greedy tokens with kernel planning on and off: the paged kernel takes
    the plan's pages_per_fetch and does not use it, so they must be equal."""
    from repro_torch.serve.engine import Request, ServeEngine
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab, size=int(n)).tolist()
               for n in (150, 300, 520, 700)]
    outs, ppf = [], []
    for plan in (True, False):
        eng = ServeEngine(cfg, params, max_batch=4, max_len=1024,
                          block_size=16, prefill_chunk_tokens=256,
                          plan_kernels=plan)
        reqs = [Request(rid=i, prompt=p, max_new=12)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        outs.append([r.out for r in reqs])
        ppf.append(eng.pages_per_fetch)
        del eng
    emit({"phase": "plan_identity", "pages_per_fetch_on_off": ppf,
          "requests": len(prompts), "tokens_each": 12,
          "identical": outs[0] == outs[1]})
    assert outs[0] == outs[1], "planning changed greedy tokens"


def profile_phase(torch, cfg, params=None, steps=12, phase="profile"):
    """Device busy time by kernel over a steady window of engine steps
    (torch.profiler), against the window's host wall time.  Builds the
    arch's weights from seed 0 unless ``params`` is given."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import build_model
    from repro_torch.serve.engine import ServeEngine
    if params is None:
        params = build_model(cfg, DEV).init(0)
    eng = ServeEngine(cfg, params, max_batch=8, max_len=2048, block_size=16,
                      prefill_chunk_tokens=256)
    for r in workload(cfg.vocab, n=12, seed=1):
        eng.submit(r)
    for _ in range(6):
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels, counts = {}, {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels[e.key] = kernels.get(e.key, 0.0) + us
        counts[e.key] = counts.get(e.key, 0) + e.count
    groups = {"paged_attention": 0.0, "rmsnorm": 0.0, "ssm_scan": 0.0,
              "gemm": 0.0, "other": 0.0}
    ported = {"paged_attention": 0, "rmsnorm": 0, "ssm_scan": 0}
    for name, us in kernels.items():
        low = name.lower()
        hit = next((k for k in ported if k in low), None)
        if hit is not None:
            groups[hit] += us
            ported[hit] += counts[name]
        elif any(t in low for t in ("gemm", "cutlass", "xmma", "nvjet",
                                    "cublas")):
            groups["gemm"] += us
        else:
            groups["other"] += us
    busy = sum(groups.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    emit({"phase": phase, "arch": cfg.name, "steps": steps,
          "wall_ms": wall_us / 1e3,
          "device_busy_ms": busy / 1e3,
          "device_idle_share": 1 - busy / wall_us if wall_us else None,
          "busy_ms_by_group": {k: v / 1e3 for k, v in groups.items()},
          "ported_kernels": {k: {"launches": n,
                                 "device_us_per_launch":
                                 groups[k] / n if n else None}
                             for k, n in ported.items()},
          "top_kernels_ms": [[k[:80], v / 1e3] for k, v in top]})
    del eng, params
    torch.cuda.empty_cache()


SSM_ARCH, HYBRID_ARCH = "falcon-mamba-7b", "zamba2-2.7b"


def stateful_serve_phase(torch, cfg, params):
    """ssm_serve / hybrid_serve: the serve workload through the full-width
    ssm or hybrid arch.  Every request finishes with the invariants clean
    after every step and the slab empty at the end; per dispatch, K7
    launches once per Mamba1 layer (ssm) or never (hybrid), K1 once per
    shared-block call site (hybrid) or never (ssm), K2 at least once; the
    attention-free engine allocates no KV block."""
    eng = serve_engine(cfg, params)
    ssm = cfg.family == "ssm"
    sites = 0 if ssm else cfg.n_layers // cfg.hybrid.attn_every
    # a prefill chunk launches K7 once per layer, over all its positions
    want = {"prefill": {"ssm_scan": cfg.n_layers if ssm else 0,
                        "paged_attention": sites},
            "decode": {"ssm_scan": cfg.n_layers if ssm else 0,
                       "paged_attention": sites}}
    per = {"prefill": [], "decode": []}

    def counted(kind, batch, call):
        n0 = read_counts()
        out = call()
        n1 = read_counts()
        per[kind].append({k: n1[k] - n0[k] for k in n1})
        return out
    launches, m, out = run_workload(torch, eng, workload(cfg.vocab), counted)
    for kind, deltas in per.items():
        assert deltas, f"{cfg.name}: no {kind} dispatch"
        for dl in deltas:
            assert all(dl[k] == v for k, v in want[kind].items()) \
                and dl["rmsnorm"] > 0, (kind, dl, want)
    assert launches["ssm_scan"] == sum(
        want[k]["ssm_scan"] * len(v) for k, v in per.items()), launches
    assert launches["lora_shrink"] == launches["matmul"] == 0, launches
    if ssm:
        assert m.peak_blocks_used == 0 and eng.kernel_plan is None, m
    slab = sum(t.numel() * t.element_size()
               for t in (eng.cache.values() if ssm
                         else eng.cache["ssm"].values()))
    emit({"phase": f"{cfg.family}_serve", "arch": cfg.name,
          "dtype": cfg.dtype, **out,
          "prefill_chunk_tokens": eng.prefill_chunk_tokens,
          "dispatches": {k: len(v) for k, v in per.items()},
          "launches_per_dispatch": want, "state_slots": eng.state_slots,
          "state_slab_bytes": slab,
          "param_bytes": eng.param_bytes_per_device})
    del eng
    torch.cuda.empty_cache()
    return launches


def swap_resume_phase(torch, cfg, params, preempt_at=4):
    """One greedy request (300-token prompt, 12 new tokens) preempted by
    swap after ``preempt_at`` tokens: its state parks on the slab's host
    tier, comes back, and the request gives the unpreempted run's tokens."""
    from repro_torch.serve.engine import Request
    prompt = np.random.default_rng(10).integers(1, cfg.vocab,
                                                size=300).tolist()

    def serve(at):
        eng = serve_engine(cfg, params)
        r = Request(rid=0, prompt=list(prompt), max_new=12)
        eng.submit(r)
        tier = None
        while eng.step():
            assert eng.check_invariants() == []
            if at and tier is None and len(r.out) >= at:
                eng._requeue(next(a for a in eng.slots if a is not None))
                tier = eng._parked[0].state.tier
        m = eng.metrics()
        assert r.done and eng.state_store.device.pool.num_used == 0
        del eng
        return r.out, tier, m
    base, _, _ = serve(0)
    resumed, tier, m = serve(preempt_at)
    emit({"phase": f"{cfg.family}_swap_resume", "arch": cfg.name,
          "preempted_after_tokens": preempt_at, "parked_tier": tier,
          "swap_out_blocks": m.swap_out_blocks,
          "swap_in_blocks": m.swap_in_blocks,
          "identical": resumed == base})
    assert tier == "host" and m.swap_out_blocks >= 1 \
        and m.swap_in_blocks >= 1, (tier, m)
    assert resumed == base, "swap-resume changed the greedy tokens"
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 6: oracle
# ---------------------------------------------------------------------------

def oracle_phase(torch, cfg):
    from repro_torch.models import build_model
    fns = build_model(cfg, DEV)
    params = fns.init(0)
    bs, chunk, steps = 16, 256, 16
    rng = np.random.default_rng(7)
    out = {"phase": "oracle", "dtype": cfg.dtype, "prompts": []}
    worst = 0.0
    for plen in (200, 700):
        prompt = rng.integers(1, cfg.vocab, size=plen).tolist()
        tokens = torch.tensor([prompt], device=DEV)
        cache1, ref_logits = fns.prefill(params, {"tokens": tokens})
        dense = fns.make_cache(1, plen + steps)
        for k in dense:
            dense[k][:, :, :plen] = cache1[k]
        nb = -(-(plen + steps) // bs)
        paged = fns.make_paged_cache(nb + 1, bs)
        table = torch.arange(1, nb + 1, dtype=torch.int32,
                             device=DEV)[None, :]
        for start in range(0, plen, chunk):
            end = min(plen, start + chunk)
            ids = prompt[start:end] + [0] * (chunk - (end - start))
            paged, logits = fns.prefill_chunk(
                params, paged,
                {"tokens": torch.tensor([ids], device=DEV),
                 "block_table": table, "start": start, "prompt_len": end},
                m_used=-(-end // bs))
        got = logits[:, plen - 1 - start]
        gaps, agree = [], 0
        for i in range(steps + 1):
            if i:
                tok = torch.tensor([[forced]], device=DEV)
                dense, ref_logits = fns.decode_step(
                    params, dense, {"token": tok, "cur_len": plen + i - 1})
                paged, got = fns.decode_paged(
                    params, paged,
                    {"token": tok, "block_tables": table,
                     "seq_lens": torch.tensor([plen + i - 1],
                                              dtype=torch.int32,
                                              device=DEV)})
            _, rel = rel_err(got[0], ref_logits[0])
            gaps.append(rel)
            forced = int(ref_logits[0].float().argmax())
            agree += int(int(got[0].float().argmax()) == forced)
        out["prompts"].append({"prompt_len": plen, "max_rel_gap": max(gaps),
                               "greedy_agreement": agree / (steps + 1)})
        worst = max(worst, max(gaps))
    tol = 1e-3 if cfg.dtype == "float32" else BF16_ORACLE_TOL
    out.update(max_rel_gap=worst, tol=tol)
    emit(out)
    assert worst <= tol, f"oracle {cfg.dtype}: rel gap {worst} > {tol}"
    del params, paged, dense
    torch.cuda.empty_cache()


def lora_oracle_phase(torch, cfg, steps=8, chunk=256, bs=16):
    """One tenant's request teacher-forced through the paged path: a
    ``chunk``-token prompt and ``steps`` decode steps at full width, 2
    layers, f32; the LoRA kernels and K1/K2 on the card against the plain
    versions on the CPU, on the same weights and adapter."""
    from repro_torch.models import build_model
    from repro_torch.serve.adapters import AdapterStore
    cfg = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    out = {"phase": "lora_oracle", "layers": cfg.n_layers, "dtype": cfg.dtype,
           "prompt_len": chunk, "decode_steps": steps}
    gpu = build_model(cfg, DEV)
    params = gpu.init(0)
    sides = {}
    for dev in (DEV, "cpu"):
        fns = build_model(cfg, dev)
        p = params if dev == DEV else _to(params, "cpu")
        store = AdapterStore(cfg, device=dev)
        slot = store.load(TENANTS[0], rank=8, alpha=16.0)
        nb = -(-(chunk + steps) // bs)
        sides[dev] = (fns, p, fns.make_paged_cache(nb + 1, bs), store, slot)
    rng = np.random.default_rng(8)
    prompt = rng.integers(1, cfg.vocab, size=chunk).tolist()
    nb = -(-(chunk + steps) // bs)
    gaps, logits = [], {}
    zero_counts()
    for i in range(steps + 1):
        for dev, (fns, p, cache, store, slot) in sides.items():
            table = torch.arange(1, nb + 1, dtype=torch.int32,
                                 device=dev)[None, :]
            lora = {"ids": torch.tensor([slot], dtype=torch.int32,
                                        device=dev),
                    "slabs": store.slabs()}
            if i == 0:
                batch = {"tokens": torch.tensor([prompt], device=dev),
                         "block_table": table, "start": 0,
                         "prompt_len": chunk, "lora": lora,
                         "lora_block_out": LORA_BLOCK_OUT}
                _, lg = fns.prefill_chunk(p, cache, batch, m_used=nb)
                logits[dev] = lg[0, chunk - 1]
            else:
                batch = {"token": torch.tensor([[forced]], device=dev),
                         "block_tables": table,
                         "seq_lens": torch.tensor([chunk + i - 1],
                                                  dtype=torch.int32,
                                                  device=dev),
                         "lora": lora, "lora_block_out": LORA_BLOCK_OUT}
                _, lg = fns.decode_paged(p, cache, batch)
                logits[dev] = lg[0]
        want = logits["cpu"]
        gaps.append(rel_err(logits[DEV].cpu(), want)[1])
        forced = int(want.argmax())
    torch.cuda.synchronize()
    n = read_counts()
    per = len(sides[DEV][3].projs) * cfg.n_layers
    assert n["lora_shrink"] == n["lora_expand"] == per * (steps + 1), n
    tol = 1e-3
    out.update(max_rel_gap=max(gaps), gaps=gaps, tol=tol,
               lora_launches=n["lora_shrink"] + n["lora_expand"])
    emit(out)
    assert max(gaps) <= tol, f"lora oracle: rel gap {max(gaps)} > {tol}"
    del sides, params
    torch.cuda.empty_cache()


def stateful_oracle_phase(torch, cfg, n_layers, steps=8, chunk=256, bs=16):
    """One request teacher-forced through the paged path of the ssm or the
    hybrid arch: a ``chunk``-token prompt into slab slot 1 and ``steps``
    decode steps, full width, ``n_layers`` layers, f32; the kernels on the
    card (K7 on every Mamba1 layer; K1 at head_dim 80 and K2 for the
    hybrid) against the plain versions on the CPU, on the same weights.
    Then the same tokens through the dense path (whole-prompt prefill and
    decode steps, plain attention: no K1) on the card against the CPU, so
    that a gap the paged path shares with it is not K1's."""
    from repro_torch.models import build_model
    cfg = dataclasses.replace(cfg, n_layers=n_layers, dtype="float32")
    out = {"phase": f"{cfg.family}_oracle", "arch": cfg.name,
           "layers": cfg.n_layers, "dtype": cfg.dtype, "prompt_len": chunk,
           "decode_steps": steps}
    params = build_model(cfg, DEV).init(0)
    nb = -(-(chunk + steps) // bs)
    sides = {}
    for dev in (DEV, "cpu"):
        fns = build_model(cfg, dev)
        p = params if dev == DEV else _to(params, "cpu")
        sides[dev] = (fns, p, fns.make_paged_cache(nb + 1, bs, state_slots=2))
    prompt = np.random.default_rng(11).integers(1, cfg.vocab,
                                                size=chunk).tolist()
    gaps, logits, forced_tokens = [], {}, []
    zero_counts()
    for i in range(steps + 1):
        for dev, (fns, p, cache) in sides.items():
            table = torch.arange(1, nb + 1, dtype=torch.int32,
                                 device=dev)[None, :]
            if i == 0:
                batch = {"tokens": torch.tensor([prompt], device=dev),
                         "block_table": table, "state_slot": 1, "start": 0,
                         "prompt_len": chunk}
                _, lg = fns.prefill_chunk(p, cache, batch, m_used=nb)
                logits[dev] = lg[0, chunk - 1]
            else:
                batch = {"token": torch.tensor([[forced]], device=dev),
                         "block_tables": table,
                         "seq_lens": torch.tensor([chunk + i - 1],
                                                  dtype=torch.int32,
                                                  device=dev),
                         "state_slots": torch.tensor([1], dtype=torch.int32,
                                                     device=dev)}
                _, lg = fns.decode_paged(p, cache, batch)
                logits[dev] = lg[0]
        want = logits["cpu"]
        gaps.append(rel_err(logits[DEV].cpu(), want)[1])
        forced = int(want.argmax())
        forced_tokens.append(forced)
    torch.cuda.synchronize()
    n = read_counts()
    if cfg.family == "ssm":
        # one launch per layer for the prompt chunk and per decode step
        assert n["ssm_scan"] == cfg.n_layers * (1 + steps), n
    else:
        sites = cfg.n_layers // cfg.hybrid.attn_every
        assert n["ssm_scan"] == 0 and n["rmsnorm"] > 0 \
            and n["paged_attention"] == sites * (steps + 1), n
    dense_gaps = _dense_oracle_gaps(torch, cfg, sides, prompt,
                                    forced_tokens[:-1])
    tol = 1e-3
    out.update(max_rel_gap=max(gaps), gaps=gaps, tol=tol, launches=n,
               dense_path_max_rel_gap=max(dense_gaps),
               dense_path_gaps=dense_gaps)
    emit(out)
    assert max(gaps) <= tol, f"{cfg.name} oracle: rel gap {max(gaps)} > {tol}"
    assert max(dense_gaps) <= tol, \
        f"{cfg.name} dense oracle: rel gap {max(dense_gaps)} > {tol}"
    del sides, params
    torch.cuda.empty_cache()


def _dense_oracle_gaps(torch, cfg, sides, prompt, forced_tokens):
    """The stateful arch's dense path (whole-prompt prefill, then one decode
    step per forced token) on the card against the CPU: each step's largest
    logit gap over the CPU's largest logit."""
    caps = len(prompt) + len(forced_tokens)
    logits, caches = {}, {}
    for dev, (fns, p, _) in sides.items():
        cache, logits[dev] = fns.prefill(
            p, {"tokens": torch.tensor([prompt], device=dev)})
        if cfg.family == "hybrid":
            big = fns.make_cache(1, caps)
            for k in ("k", "v"):
                big[k][:, :, :len(prompt)] = cache[k]
            cache = dict(big, ssm=cache["ssm"])
        caches[dev] = cache
    gaps = [rel_err(logits[DEV][0].cpu(), logits["cpu"][0])[1]]
    for i, tok in enumerate(forced_tokens):
        for dev, (fns, p, _) in sides.items():
            caches[dev], lg = fns.decode_step(
                p, caches[dev], {"token": torch.tensor([[tok]], device=dev),
                                 "cur_len": len(prompt) + i})
            logits[dev] = lg[0]
        gaps.append(rel_err(logits[DEV].cpu(), logits["cpu"])[1])
    del caches
    return gaps


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


# ---------------------------------------------------------------------------

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import lora as lora_mod
    from repro_torch.kernels import matmul as mm_mod
    from repro_torch.kernels import paged_attention as pa_mod
    from repro_torch.kernels import rmsnorm as rn_mod
    from repro_torch.kernels import ssm_scan as k7_mod
    from repro_torch.models import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()

    # 1. card
    emit({"phase": "card", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    # 2. build
    t0 = time.perf_counter()
    build.build("paged_attention", "matmul", "lora", "ssm_scan")
    pa_mod.load_kernel()
    mm_mod.load_kernel()
    lora_mod.load_kernels()
    k7_mod.load_kernel()
    nvcc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x = torch.ones((16, 1024), device=DEV)
    rn_mod.rmsnorm_kernel(x, torch.ones(1024, device=DEV))
    torch.cuda.synchronize()
    emit({"phase": "build", "nvcc_s": nvcc_s,
          "triton_first_launch_s": time.perf_counter() - t0,
          "ptxas": {n: [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for n, log in build.BUILD_LOG.items()}})

    # 3. kernels against their plain versions
    results = []
    check_paged_attention(torch, results)
    check_rmsnorm(torch, results)
    check_matmul(torch, results)
    check_lora(torch, results)
    check_ssm_scan(torch, results)
    for r in results:
        emit({"phase": "kernel", **r})

    cfg = get_config("qwen3-0.6b")
    # 4. the compile pipeline at full width, kernels on the card
    compile_launches = compile_phase(torch, cfg)
    # 5. serve, full width, bf16: the base workload, then the same workload
    # spread over four tenants; identity runs; a profiled window
    params = build_model(cfg, DEV).init(0)
    launches, base = serve_phase(torch, cfg, params)
    plan_identity(torch, cfg, params)
    lora_launches = lora_serve_phase(torch, cfg, params, base)
    lora_identity_phase(torch, cfg, params)
    del params
    torch.cuda.empty_cache()
    profile_phase(torch, cfg)
    # 6. oracles: dense in f32 and bf16, one tenant's request in f32
    oracle_phase(torch, dataclasses.replace(cfg, dtype="float32"))
    oracle_phase(torch, cfg)
    lora_oracle_phase(torch, cfg)

    # 7. the stateful families at full width, bf16, one at a time: the serve
    # workload, a swap-resume (ssm) and a profiled window each
    ssm_cfg = get_config(SSM_ARCH)
    params = build_model(ssm_cfg, DEV).init(0)
    ssm_launches = stateful_serve_phase(torch, ssm_cfg, params)
    swap_resume_phase(torch, ssm_cfg, params)
    profile_phase(torch, ssm_cfg, params, steps=8, phase="ssm_profile")
    del params
    torch.cuda.empty_cache()
    hy_cfg = get_config(HYBRID_ARCH)
    params = build_model(hy_cfg, DEV).init(0)
    hybrid_launches = stateful_serve_phase(torch, hy_cfg, params)
    profile_phase(torch, hy_cfg, params, steps=8, phase="hybrid_profile")
    del params
    torch.cuda.empty_cache()
    # 8. their oracles: 2 Mamba1 layers; 2 hybrid segments
    stateful_oracle_phase(torch, ssm_cfg, n_layers=2)
    stateful_oracle_phase(torch, hy_cfg,
                          n_layers=2 * hy_cfg.hybrid.attn_every)

    # each row's launches come from the main path that gives its shape
    # (the row's ``path``): the qwen3-0.6b serve workload (K1 at head_dim
    # 128, K2 at 1,024 and 128), the compile phase (K4), the multi-LoRA
    # workload (K5/K6), the ssm workload (K7, K2 at 4,096) and the hybrid
    # workload (K1 at head_dim 80, K2 at 2,560 and 5,120)
    path_launches = {"serve": launches, "compile": compile_launches,
                     "lora_serve": lora_launches, "ssm_serve": ssm_launches,
                     "hybrid_serve": hybrid_launches}
    sources = {
        "paged_attention": (
            "cuda", "src/repro_torch/kernels/csrc/paged_attention.cu",
            "src/repro/kernels/paged_attention.py:113"),
        "rmsnorm": ("triton", "src/repro_torch/kernels/_rmsnorm_triton.py",
                    "src/repro/kernels/rmsnorm.py:19"),
        "matmul": ("cuda", "src/repro_torch/kernels/csrc/matmul.cu",
                   "src/repro/kernels/matmul.py:33"),
        "lora_shrink": ("cuda", "src/repro_torch/kernels/csrc/lora.cu",
                        "src/repro/kernels/lora.py:64"),
        "lora_expand": ("cuda", "src/repro_torch/kernels/csrc/lora.cu",
                        "src/repro/kernels/lora.py:98"),
        "ssm_scan": ("cuda", "src/repro_torch/kernels/csrc/ssm_scan.cu",
                     "src/repro/kernels/ssm_scan.py:33")}
    summary = []
    for r in results:
        # the bf16 rows, and K7's, whose path is f32 only
        if r["dtype"] != "bfloat16" and not r["name"].startswith("ssm_scan"):
            continue
        kernel = r["name"].split("/")[0]
        route, source, replaces = sources[kernel]
        summary.append({
            "name": f"{r['name']} {r['shape']}", "route": route,
            "source": source, "replaces": replaces, "path": r["path"],
            "launches": path_launches[r["path"]][kernel],
            "max_abs_err": r["max_abs_err"],
            "row_rel_err": r["row_rel_err"], "ms": r["kernel_ms"],
            "host_ms": r["host_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    assert {k["source"] for k in summary} >= {v[1] for v in sources.values()}
    assert all(k["launches"] > 0 for k in summary), \
        [k["name"] for k in summary if not k["launches"]]
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
