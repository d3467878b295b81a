#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check every kernel.

    python3 chip_smoke.py

Phases, each printing JSON objects one per line:

1. card     — nvidia-smi's name and power limit, torch and CUDA versions.
2. build    — nvcc builds the CUDA kernels (paged attention, matmul, LoRA
              shrink and expand, selective scan, flash attention forward
              and backward) from the repo's sources for
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
              5,120) at decode and prefill-chunk rows, and at the training
              step's rows (4,096 x 1,024, the q norms' 65,536 x 128 and the
              k norms' 32,768 x 128); each K2 row also times RMSNormFn's
              host cost beside the wrapper's (grad on, inputs needing
              none, as the serve engine calls ops.rmsnorm).  Flash
              attention (K3) at the training step's shape (B 8 x 16 query
              heads over 8 KV heads, read grouped by the kernel, S 512,
              head_dim 128, causal; f32 and bf16): o, lse, dq, dk and
              dv row by row (gradient rows floored at 1e-2 of the largest
              and held to 1e-4 in f32, ``ref.GRAD_ROW_FLOOR`` and
              ``GRAD_ROW_TOL``), two launches bitwise equal, planted
              faults (a kv tile dropped, the causal mask flipped, dO rows
              zeroed, lse shifted, D from a zero O); its yardstick is SDPA
              (with ``enable_gqa``), forward and backward, both from graph
              replay.  Each K3 row carries ``sass_mma``, the tensor-core
              instructions ``cuobjdump -sass`` finds in its kernels: bf16
              must have them, f32 must have none.  A
              ``flash_attention_grad_witness`` line holds the f32 kernel and
              the f32 plain versions each against the plain versions in f64
              at the training shape.  The same gates, untimed, non-causal,
              with q_offset (128 queries after 512 keys), ragged (S 300),
              at head_dim 256, at head_dim 80 (zamba2's shared block, 32
              heads over 32), with 8 query heads a KV head, and at head_dim
              40 (ragged, q_offset 3).
              ``rmsnorm_grad`` lines: RMSNormFn's dx and dw (torch ops, not
              a kernel) against autograd of the plain rmsnorm at the
              training rows.
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
9. train    — full-width qwen3-0.6b in bf16 through ``Trainer`` (B 8 x S
              512, 10 steps, AdamW as the train CLI builds it, remat on):
              losses finite and falling, step seconds, tokens/s without step
              0, peak memory, and exactly 56 K3 forward, 28 K3 backward and
              225 K2 launches a step (no serve kernel); train_int8: three
              steps with int8 moments, finite and falling.  train_restart:
              2 layers at full width, 8 steps checkpointed every 4, a failure
              at step 6; the final loss equals a clean run's bit for bit.
              train_oracle: 2 layers at full width, f32, loss and every
              gradient leaf on the card against the CPU's plain versions
              (1e-4 relative, 1e-3 of each leaf's largest value), and remat
              off / dots / nothing agreeing on the card.  train_remat: four
              full-width steps under each REPRO_REMAT_POLICY, step time and
              peak memory.  train_profile:
              torch.profiler over 3 steps, busy time by group and the idle
              share.

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


def gate(name, got, want, faults, margin=4.0, floor=0.0, tols=None) -> dict:
    """Hold a kernel's output to its plain version row by row, and check
    that each planted fault (a wrong output at the same shape) fails the
    same gate by ``margin`` times its tolerance.  ``floor`` and ``tols``
    (limits by dtype, default ``ref.ROW_TOL``): gradients take
    ``ref.GRAD_ROW_FLOOR`` and ``ref.GRAD_ROW_TOL``."""
    from repro_torch.kernels import ref
    import torch
    tol = (tols or ref.ROW_TOL)[want.dtype]
    assert torch.isfinite(got.float()).all(), f"{name}: non-finite output"
    err, rel = ref.row_rel_err(got, want, floor)
    assert rel <= tol, f"{name}: row rel err {rel} > {tol}"
    planted = {k: ref.row_rel_err(f, want, floor)[1]
               for k, f in faults.items()}
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
    from repro_torch.kernels import (flash_attention, lora, matmul,
                                     paged_attention, rmsnorm, ssm_scan)
    return {"paged_attention": (paged_attention, "launches"),
            "rmsnorm": (rmsnorm, "launches"),
            "matmul": (matmul, "launches"),
            "lora_shrink": (lora, "shrink_launches"),
            "lora_expand": (lora, "expand_launches"),
            "ssm_scan": (ssm_scan, "launches"),
            "flash_attention": (flash_attention, "launches"),
            "flash_attention_bwd": (flash_attention, "bwd_launches")}


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
# norm over d_inner (5,120); then qwen3-0.6b's training step (B 8 x S 512
# rows at 1,024, times 16 query heads and 8 key heads at 128); and the main
# path that gives each
RMSNORM_SHAPES = ((8, 1024), (256, 1024), (8 * 16, 128), (256 * 16, 128),
                  (8, 4096), (256, 4096), (8, 2560), (256, 2560),
                  (8, 5120), (256, 5120), (4096, 1024), (4096 * 16, 128),
                  (4096 * 8, 128))
RMSNORM_PATH = {1024: "serve", 128: "serve", 4096: "ssm_serve",
                2560: "hybrid_serve", 5120: "hybrid_serve"}
RMSNORM_TRAIN_SHAPES = ((4096, 1024), (4096 * 16, 128), (4096 * 8, 128))


def rmsnorm_path(rows, d):
    return "train" if (rows, d) in RMSNORM_TRAIN_SHAPES else RMSNORM_PATH[d]


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
    """K2 against its plain version at every path's rows.  ``host_ms`` is
    the wrapper's eager cost, ``function_host_ms`` that of ``RMSNormFn``
    with grad on and inputs needing none (how the serve engine reaches
    ``ops.rmsnorm``): what the Function adds to a serve step's norms."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import RMSNormFn, rmsnorm_kernel
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
                path=rmsnorm_path(rows, d),
                **checked, triton=triton_registers(torch, x, w, eps),
                kernel_ms=graph_ms(lambda: rmsnorm_kernel(x, w, eps)),
                host_ms=host_ms(lambda: rmsnorm_kernel(x, w, eps)),
                function_host_ms=host_ms(lambda: RMSNormFn.apply(x, w, eps)),
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


# qwen3-0.6b's training step through K3: B 8 x 16 query heads over 8 KV
# heads (q 128 rows, k/v 64, GQA read in the kernel), S 512, head_dim 128,
# causal; then the gates at other shapes the kernel takes (no main path
# gives them, so they carry no times): zamba2's shared attention block
# (32 heads over 32, head_dim 80), a group of 8 among them, and head_dim 40
# (the bf16 kernels' zero columns up to their 64-wide tile).  Each entry:
# (q rows B*H, k/v rows B*KV, Sq, Skv, head_dim, causal, q_offset).
FLASH_TRAIN = (8 * 16, 8 * 8, 512, 512, 128, True, 0)
FLASH_GATES = (("non_causal", 32, 16, 512, 512, 128, False, 0),
               ("q_offset", 32, 16, 128, 640, 128, True, 512),
               ("ragged", 32, 16, 300, 300, 128, True, 0),
               ("head_dim_256", 8, 8, 200, 200, 256, True, 0),
               ("head_dim_80", 2 * 32, 2 * 32, 512, 512, 80, True, 0),
               ("group_8", 64, 8, 512, 512, 128, True, 0),
               ("head_dim_40", 8, 4, 100, 100, 40, True, 3))
# SASS function-name fragments of K3's kernels by dtype and direction
K3_SASS = {("bfloat16", "forward"): ("flash_fwd_mma_kernel",),
           ("bfloat16", "backward"): ("flash_bwd_dkdv_mma_kernel",
                                      "flash_bwd_dq_mma_kernel"),
           ("float32", "forward"): ("flash_fwd_kernelIf",),
           ("float32", "backward"): ("flash_bwd_dkdv_kernelIf",
                                     "flash_bwd_dq_kernelIf")}


def cuobjdump() -> str:
    """The CUDA toolkit's cuobjdump, else the copy in Triton's package."""
    import importlib.util
    import shutil
    found = shutil.which("cuobjdump")
    if found:
        return found
    from repro_torch.kernels import build
    path = Path(build.nvcc()).parent / "cuobjdump"
    if path.exists():
        return str(path)
    spec = importlib.util.find_spec("triton")
    assert spec is not None, "no cuobjdump in the CUDA toolkit or Triton"
    path = Path(spec.origin).parent / "backends/nvidia/bin/cuobjdump"
    assert path.exists(), f"no cuobjdump at {path}"
    return str(path)


def sass_mma(name: str) -> dict:
    """Tensor-core instructions (HMMA, HGMMA) in each kernel of the built
    library ``name``, from ``cuobjdump -sass``: {function: count}."""
    from repro_torch.kernels import build
    out = subprocess.run([cuobjdump(), "-sass",
                          str(build.library_path(name))], check=True,
                         capture_output=True, text=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and "MMA" in line and \
                ("HMMA" in line or "HGMMA" in line):
            counts[fn] += 1
    return counts


def _k3_sass(counts, dname, direction) -> dict:
    """K3's tensor-core instruction counts for one row: each kernel of the
    row's dtype and direction, summed over its head_dim instances."""
    return {frag: sum(c for f, c in counts.items() if frag in f)
            for frag in K3_SASS[(dname, direction)]}


def _flash_case(torch, name, dtype, bh, bkv, sq, skv, hd, causal, off, gen):
    """Gate K3's forward (o, lse) and backward (dq, dk, dv) against the
    plain versions, with planted faults: the last kv tile dropped and the
    causal mask flipped (forward); the last 64 rows of dO zeroed, lse
    shifted by 0.5 and D computed from a zero O (backward; D does not reach
    dV).  q has ``bh`` rows and k/v ``bkv`` (GQA).  Two launches of each
    must be bitwise equal."""
    from repro_torch.kernels import flash_attention as k3, ref
    q, k, v, do = ((torch.randn((rows, n, hd), generator=gen, device=DEV))
                   .to(dtype) for rows, n in ((bh, sq), (bkv, skv),
                                              (bkv, skv), (bh, sq)))
    dname = str(dtype).split(".")[1]
    o, lse = k3.flash_attention_kernel(q, k, v, causal, off)
    ro, rlse = ref.flash_attention_ref(q, k, v, causal, off)
    cut = (skv - 1) // 64 * 64
    fo_cut, flse_cut = k3.flash_attention_kernel(
        q, k[:, :cut].contiguous(), v[:, :cut].contiguous(), causal, off)
    fo_flip, flse_flip = k3.flash_attention_kernel(q, k, v, not causal, off)
    go = gate(f"flash_attention {name} o {dname}", o, ro, {
        "last_kv_tile_dropped": fo_cut, "causal_flipped": fo_flip})
    gl = gate(f"flash_attention {name} lse {dname}", lse, rlse, {
        "last_kv_tile_dropped": flse_cut, "causal_flipped": flse_flip})
    grads = k3.flash_attention_bwd_kernel(q, k, v, o, lse, do, causal, off)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal, off)
    do_cut = do.clone()
    do_cut[:, -64:] = 0
    faults = (k3.flash_attention_bwd_kernel(q, k, v, o, lse, do_cut, causal,
                                            off),
              k3.flash_attention_bwd_kernel(q, k, v, o, lse + 0.5, do, causal,
                                            off),
              k3.flash_attention_bwd_kernel(q, k, v, torch.zeros_like(o), lse,
                                            do, causal, off))
    gg = {}
    for i, g in enumerate(("dq", "dk", "dv")):
        planted = {"do_last_rows_zeroed": faults[0][i],
                   "lse_shifted": faults[1][i]}
        if g != "dv":
            planted["D_from_zero_o"] = faults[2][i]
        gg[g] = gate(f"flash_attention {name} {g} {dname}", grads[i],
                     want[i], planted, floor=ref.GRAD_ROW_FLOOR,
                     tols=ref.GRAD_ROW_TOL)
    o2, lse2 = k3.flash_attention_kernel(q, k, v, causal, off)
    again = k3.flash_attention_bwd_kernel(q, k, v, o, lse, do, causal, off)
    bitwise = bool(torch.equal(o, o2) and torch.equal(lse, lse2)
                   and all(torch.equal(a, b) for a, b in zip(grads, again)))
    assert bitwise, f"flash_attention {name} {dname}: two launches differ"
    shape = f"BH={bh} BKV={bkv} Sq={sq} Skv={skv} hd={hd} " \
        f"causal={causal} q_offset={off}"
    fwd = dict(name="flash_attention/forward", dtype=dname, shape=shape,
               o_gate=go, lse_gate=gl, two_launches_bitwise=bitwise,
               max_abs_err=max(go["max_abs_err"], gl["max_abs_err"]),
               row_rel_err=go["row_rel_err"], tol=go["tol"])
    bwd = dict(name="flash_attention/backward", dtype=dname, shape=shape,
               counter="flash_attention_bwd", two_launches_bitwise=bitwise,
               max_abs_err=max(x["max_abs_err"] for x in gg.values()),
               row_rel_err=max(x["row_rel_err"] for x in gg.values()),
               tol=gg["dq"]["tol"], floor=ref.GRAD_ROW_FLOOR,
               **{f"{g}_gate": x for g, x in gg.items()})
    return (q, k, v, do, o, lse), fwd, bwd


def _worst_row(torch, got, exact, floor):
    """(row_rel_err per row against ``exact`` with the floor) -> the worst
    row's (bh, row), its exact largest value, and how many rows exceed 2e-5
    and 4e-5."""
    diff = (got.double() - exact).abs().amax(-1)
    scale = exact.abs().amax(-1).clamp_min(floor * float(exact.abs().max()))
    rel = diff / scale.clamp_min(1e-300)
    j = int(rel.argmax())
    return {"worst_row": list(divmod(j, rel.shape[1])),
            "worst_row_exact_max": float(exact.abs().amax(-1).flatten()[j]),
            "rows_over_2e-5": int((rel > 2e-5).sum()),
            "rows_over_4e-5": int((rel > 4e-5).sum())}


def grad_witness(torch, q, k, v, do, o, lse, causal, off):
    """The f32 kernel and the f32 plain versions each against the plain
    versions in f64 on the same inputs (the kernel's o and lse widened for
    the backward), row by row with the gradient floor: the error of each
    f32 side alone, where each side's worst row lies and how many rows pass
    2e-5 and 4e-5; and, apart, how far the f32 rounding of o and lse moves
    the f64 backward (against one given the f64 forward's o and lse).  The
    kernel may be at most twice as far from f64 as the plain f32 version
    is, and within the gates' limits."""
    from repro_torch.kernels import flash_attention as k3, ref
    wide = [x.double() for x in (q, k, v, do, o, lse)]
    o64, lse64 = ref.flash_attention_ref(*wide[:3], causal, off)
    po, plse = ref.flash_attention_ref(q, k, v, causal, off)
    pairs = {"o": (o, po, o64, 0.0), "lse": (lse, plse, lse64, 0.0)}
    g64 = ref.flash_attention_bwd_ref(*wide[:3], wide[4], wide[5], wide[3],
                                      causal, off)
    g64f = ref.flash_attention_bwd_ref(*wide[:3], o64, lse64, wide[3],
                                       causal, off)
    g32 = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal, off)
    gk = k3.flash_attention_bwd_kernel(q, k, v, o, lse, do, causal, off)
    for i, name in enumerate(("dq", "dk", "dv")):
        pairs[name] = (gk[i], g32[i], g64[i], ref.GRAD_ROW_FLOOR)
    line = {}
    for name, (kern, plain, exact, floor) in pairs.items():
        line[name] = {
            "kernel_vs_f64": ref.row_rel_err(kern, exact, floor)[1],
            "plain_f32_vs_f64": ref.row_rel_err(plain, exact, floor)[1],
            "kernel_vs_plain_f32": ref.row_rel_err(kern, plain, floor)[1]}
        if name.startswith("d"):
            i = ("dq", "dk", "dv").index(name)
            line[name].update(
                kernel=_worst_row(torch, kern, exact, floor),
                plain_f32=_worst_row(torch, plain, exact, floor),
                f64_from_f32_forward_vs_f64_forward=ref.row_rel_err(
                    exact, g64f[i], floor)[1])
    emit({"phase": "flash_attention_grad_witness",
          "shape": f"BH={q.shape[0]} S={q.shape[1]} hd={q.shape[2]} "
                   f"causal={causal}", "floor": ref.GRAD_ROW_FLOOR, **line})
    for name, r in line.items():
        tol = (ref.GRAD_ROW_TOL if name.startswith("d")
               else ref.ROW_TOL)[torch.float32]
        assert r["kernel_vs_f64"] <= max(2 * r["plain_f32_vs_f64"], tol / 4), \
            f"flash_attention {name}: kernel {r['kernel_vs_f64']} from f64 " \
            f"against the plain f32 version's {r['plain_f32_vs_f64']}"
    del wide, g64, g64f, g32, gk
    torch.cuda.empty_cache()


def check_flash_attention(torch, results):
    """K3 at the training shape (f32 and bf16, timed) and at the gate-only
    shapes.  Times: kernel and plain version from graph replay, the wrapper
    eagerly; the library yardstick is SDPA (causal) on the same tensors
    viewed as (B, H, S, hd) and (B, KV, S, hd) with ``enable_gqa`` (or,
    where this torch lacks it, on K/V repeated to every head before the
    timed call), its forward and its forward + backward (``autograd.grad``
    of a fresh forward) from graph replay, the backward alone their
    difference.  Bound: q and o at the query heads, k and v at the KV heads
    (and lse) moved once over 3.35 TB/s forward; q, o, dO, dQ, k, v, dK,
    dV and lse backward; against 4 hd flops per visible (query, key) pair
    forward, 10 hd backward (S recomputed, dP, dV, dK, dQ), at the type's
    peak.  Each row carries ``sass_mma``: the tensor-core instructions in
    its dtype's kernels (bf16 must have them; f32 must not, or it would be
    TF32)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as k3, ref
    gen = torch.Generator(device=DEV).manual_seed(3)
    bh, bkv, sq, skv, hd, causal, off = FLASH_TRAIN
    b, h, kvh = 8, bh // 8, bkv // 8
    counts = sass_mma("flash_attention")
    # SDPA is a builtin without a signature; its docstring names the option
    gqa = "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or "")
    extra = {"enable_gqa": True} if gqa else {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        esize = torch.finfo(dtype).bits // 8
        (q, k, v, do, o, lse), fwd, bwd = _flash_case(
            torch, "train", dtype, bh, bkv, sq, skv, hd, causal, off, gen)
        pairs = bh * sum(min(skv, off + i + 1) for i in range(sq))
        nq, nkv = bh * sq * hd, bkv * skv * hd
        f_bound, f_by = bound((2 * nq + 2 * nkv) * esize + bh * sq * 4,
                              4.0 * hd * pairs, dname)
        b_bound, b_by = bound((4 * nq + 4 * nkv) * esize + bh * sq * 4,
                              10.0 * hd * pairs, dname)
        if dtype == torch.float32:
            grad_witness(torch, q, k, v, do, o, lse, causal, off)
        q4, do4 = (x.view(b, h, -1, hd) for x in (q, do))
        k4, v4 = (x.view(b, kvh, -1, hd) if gqa
                  else x.view(b, kvh, -1, hd).repeat_interleave(h // kvh, 1)
                  for x in (k, v))
        ql, kl, vl = (x.detach().clone().requires_grad_()
                      for x in (q4, k4, v4))
        lib_fwd_grad = graph_ms(lambda: F.scaled_dot_product_attention(
            ql, kl, vl, is_causal=True, **extra), reps=5)
        lib_fwd_bwd = graph_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                           **extra),
            (ql, kl, vl), do4), reps=5)
        library = "SDPA enable_gqa" if gqa else "SDPA on K/V repeated"
        fwd_ms = graph_ms(lambda: k3.flash_attention_kernel(q, k, v, causal,
                                                            off))
        bwd_ms = graph_ms(lambda: k3.flash_attention_bwd_kernel(
            q, k, v, o, lse, do, causal, off), reps=5)
        fwd.update(
            path="train", kernel_ms=fwd_ms,
            host_ms=host_ms(lambda: k3.flash_attention_kernel(
                q, k, v, causal, off)),
            plain_ms=graph_ms(lambda: ref.flash_attention_ref(
                q, k, v, causal, off), reps=2),
            library_ms=graph_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=True, **extra)), library=library,
            bound_ms=f_bound, bound_by=f_by, flops=4.0 * hd * pairs)
        bwd.update(
            path="train", kernel_ms=bwd_ms, fwd_plus_bwd_ms=fwd_ms + bwd_ms,
            host_ms=host_ms(lambda: k3.flash_attention_bwd_kernel(
                q, k, v, o, lse, do, causal, off), reps=2),
            plain_ms=graph_ms(lambda: ref.flash_attention_bwd_ref(
                q, k, v, o, lse, do, causal, off), reps=2),
            library_ms=lib_fwd_bwd - lib_fwd_grad,
            library_fwd_bwd_ms=lib_fwd_bwd, library=library,
            bound_ms=b_bound, bound_by=b_by, flops=10.0 * hd * pairs)
        results.extend([fwd, bwd])
        del q, k, v, do, o, lse, ql, kl, vl, q4, k4, v4, do4
        for name, *shape in FLASH_GATES:
            _, fwd, bwd = _flash_case(torch, name, dtype, *shape, gen)
            results.extend([dict(fwd, path=None), dict(bwd, path=None)])
    for r in results:
        if r["name"].startswith("flash_attention/"):
            r["sass_mma"] = _k3_sass(counts, r["dtype"],
                                     r["name"].split("/")[1])
            if r["dtype"] == "bfloat16":
                assert all(r["sass_mma"].values()), r["sass_mma"]
            else:
                assert not any(r["sass_mma"].values()), r["sass_mma"]
    torch.cuda.empty_cache()


# RMSNormFn's backward (torch ops, not a kernel) at the training step's norm
# rows: the layer norms (4,096 x 1,024), the q norms (65,536 x 128) and the
# k norms (32,768 x 128)
RMSNORM_GRAD_SHAPES = RMSNORM_TRAIN_SHAPES


def check_rmsnorm_grad(torch):
    """RMSNormFn's dx and dw against autograd of the plain rmsnorm, with
    planted faults (the output gradient's rows shifted by one; dw summed
    without the last quarter of the rows).  The backward is torch ops, so
    its lines are not kernel rows; its time from graph replay beside
    autograd of the plain version, eagerly."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import RMSNormFn, rmsnorm_bwd
    gen = torch.Generator(device=DEV).manual_seed(4)
    eps = 1e-6
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for rows, d in RMSNORM_GRAD_SHAPES:
            x = torch.randn((rows, d), generator=gen, device=DEV).to(dtype)
            w = (1 + 0.5 * torch.randn((d,), generator=gen, device=DEV)) \
                .to(dtype)
            g = torch.randn((rows, d), generator=gen, device=DEV).to(dtype)
            xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
            dx, dw = torch.autograd.grad(RMSNormFn.apply(xg, wg, eps),
                                         (xg, wg), g)
            xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
            rdx, rdw = torch.autograd.grad(ref.rmsnorm_ref(xr, wr, eps),
                                           (xr, wr), g)
            sdx, sdw = rmsnorm_bwd(x, w, g.roll(1, 0), eps)
            _, qdw = rmsnorm_bwd(x[:3 * rows // 4], w, g[:3 * rows // 4], eps)
            gx = gate(f"rmsnorm grad dx ({rows},{d}) {dname}", dx, rdx,
                      {"g_rows_shifted": sdx})
            gw = gate(f"rmsnorm grad dw ({rows},{d}) {dname}", dw[None],
                      rdw[None], {"g_rows_shifted": sdw[None],
                                  "last_quarter_dropped": qdw[None]})
            emit({"phase": "rmsnorm_grad", "dtype": dname,
                  "shape": f"({rows}, {d})", "not_a_kernel": True,
                  "dx_gate": gx, "dw_gate": gw,
                  "backward_ms": graph_ms(lambda: rmsnorm_bwd(x, w, g, eps)),
                  "plain_autograd_ms": host_ms(lambda: torch.autograd.grad(
                      ref.rmsnorm_ref(xr, wr, eps), (xr, wr), g))})


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


# ---------------------------------------------------------------------------
# Phase 9: training
# ---------------------------------------------------------------------------

TRAIN_STEPS = 10
TRAIN_LR = 3e-4


def _trainer(cfg, steps, opt_state="f32", **kw):
    from repro_torch.launch.train import opt_config
    from repro_torch.train.trainer import Trainer, TrainerConfig
    tcfg = TrainerConfig(seq_len=512, global_batch=8, steps=steps,
                         log_every=1, **kw)
    return Trainer(cfg, tcfg, opt_config(TRAIN_LR, steps, opt_state),
                   device=DEV)


def _losses(res, steps):
    losses = [e["loss"] for e in res["log"]]
    assert len(losses) == steps, res["log"]
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    return losses


def train_phase(torch, cfg):
    """The training path: full-width qwen3-0.6b in bf16 through ``Trainer``
    (B 8 x S 512, AdamW as the train CLI builds it, remat on), every count
    zeroed just before and read just after.  Each step launches K3's forward
    twice a layer (the forward and the rematerialised recompute), its
    backward once a layer and K2 eight times a layer plus the final norm
    (ln1, ln2, q and k norms, forward and recompute); no serve kernel.  The
    loss is finite and falls.  Then three steps with int8 moments."""
    trainer = _trainer(cfg, TRAIN_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    res = trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    losses = _losses(res, TRAIN_STEPS)
    layers = cfg.n_layers
    want = {"flash_attention": 2 * layers, "flash_attention_bwd": layers,
            "rmsnorm": 8 * layers + 1}
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
    assert {k: per_step[k] for k in want} == want, per_step
    assert all(v == 0 for k, v in launches.items() if k not in want), \
        launches
    secs = [e["sec"] for e in res["log"]]
    toks = 8 * 512
    emit({"phase": "train", "arch": cfg.name, "dtype": cfg.dtype,
          "layers": layers, "batch": 8, "seq_len": 512,
          "steps": TRAIN_STEPS, "losses": losses,
          "grad_norms": [e["grad_norm"] for e in res["log"]],
          "step_s": secs, "wall_s": wall,
          "tokens_per_s_after_step0": toks * (TRAIN_STEPS - 1)
          / sum(secs[1:]),
          "peak_device_bytes": torch.cuda.max_memory_allocated(),
          "launches": launches, "launches_per_step": per_step})
    del trainer, res
    torch.cuda.empty_cache()
    res8 = _trainer(cfg, 3, "int8").train()
    emit({"phase": "train_int8", "arch": cfg.name, "steps": 3,
          "losses": _losses(res8, 3),
          "step_s": [e["sec"] for e in res8["log"]]})
    del res8
    torch.cuda.empty_cache()
    return launches


def train_remat_phase(torch, cfg, steps=4):
    """What REPRO_REMAT_POLICY selects: four full-width bf16 steps under
    "dots" and under "nothing", each with its step time (median after step
    0) and peak device memory.  The policy changes what is kept, not what
    is computed, so the losses are equal."""
    import os
    runs = {}
    for policy in ("dots", "nothing"):
        os.environ["REPRO_REMAT_POLICY"] = policy
        try:
            trainer = _trainer(cfg, steps)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            res = trainer.train()
            torch.cuda.synchronize()
        finally:
            os.environ.pop("REPRO_REMAT_POLICY")
        secs = [e["sec"] for e in res["log"]]
        runs[policy] = {"losses": _losses(res, steps), "step_s": secs,
                        "median_step_s_after_step0":
                            statistics.median(secs[1:]),
                        "peak_device_bytes":
                            torch.cuda.max_memory_allocated()}
        del trainer, res
        torch.cuda.empty_cache()
    emit({"phase": "train_remat", "arch": cfg.name, "dtype": cfg.dtype,
          "layers": cfg.n_layers, "batch": 8, "seq_len": 512,
          "steps": steps, **runs})
    assert runs["dots"]["losses"] == runs["nothing"]["losses"], runs


def train_restart_phase(torch, cfg):
    """Checkpoint/restart on the card: 2 layers at full width, bf16, 8
    steps checkpointed every 4 with a failure injected at step 6 (restore
    step 4, replay); the final loss equals a clean run's bit for bit (the
    reference bounds the gap at 5e-3)."""
    import tempfile
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        res = _trainer(cfg2, 8, workdir=d, checkpoint_every=4) \
            .train(fail_at=6)
        failed_s = time.perf_counter() - t0
        assert res["final_step"] == 8
        from repro_torch.train.checkpoint import list_checkpoints
        ckpts = [s for s, _ in list_checkpoints(d)]
    clean = _trainer(cfg2, 8).train()
    gap = abs(res["log"][-1]["loss"] - clean["log"][-1]["loss"])
    emit({"phase": "train_restart", "arch": cfg.name, "layers": 2,
          "steps": 8, "checkpoint_every": 4, "fail_at": 6,
          "checkpoints": ckpts, "replayed_steps": [e["step"]
                                                  for e in res["log"]],
          "final_loss": res["log"][-1]["loss"],
          "clean_final_loss": clean["log"][-1]["loss"], "gap": gap,
          "bitwise": gap == 0.0, "run_with_failure_s": failed_s})
    assert res["log"][-1]["step"] == clean["log"][-1]["step"] == 7
    assert gap == 0.0, f"restart replay differs from the clean run by {gap}"
    torch.cuda.empty_cache()


def _loss_and_grads(torch, cfg, params, batch, remat):
    from repro_torch.models import build_model
    from repro_torch.train.tree import leaves, map_tree
    ps = map_tree(lambda t: t.detach().clone().requires_grad_(), params)
    dev = leaves(ps)[0].device
    loss = build_model(cfg, dev).loss(
        ps, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()},
        remat=remat)
    loss.backward()
    return float(loss), [p.grad.detach() for p in leaves(ps)]


def train_oracle_phase(torch, cfg):
    """2 layers at full width, f32: ``lm_loss`` and every gradient leaf on
    the card (K2, K3 forward and backward) against the CPU's (their plain
    versions) from the same weights and batch (B 2 x S 512): loss within
    1e-4 relative, each leaf within 1e-3 of its largest value.  On the card,
    remat off, "dots" and "nothing" give the same loss and gradients."""
    import os
    from repro_torch.models import build_model
    from repro_torch.train.data import TokenPipeline
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    params = build_model(cfg2, "cpu").init(0)
    batch = TokenPipeline(cfg2.vocab, 512, 2, seed=5).batch_at(0)
    t0 = time.perf_counter()
    cpu_loss, cpu_grads = _loss_and_grads(torch, cfg2, params, batch, False)
    cpu_s = time.perf_counter() - t0
    gpu = _to(params, DEV)
    runs = {}
    for mode in ("off", "dots", "nothing"):
        os.environ["REPRO_REMAT_POLICY"] = "nothing" if mode == "nothing" \
            else "dots"
        runs[mode] = _loss_and_grads(torch, cfg2, gpu, batch, mode != "off")
    os.environ.pop("REPRO_REMAT_POLICY")
    loss, grads = runs["dots"]
    loss_rel = abs(loss - cpu_loss) / abs(cpu_loss)
    leaf_rel = [float((g.cpu() - w).abs().max() / w.abs().max().clamp_min(
        1e-30)) for g, w in zip(grads, cpu_grads)]
    remat_gap = 0.0
    bitwise = True
    for mode in ("off", "nothing"):
        other_loss, other = runs[mode]
        remat_gap = max(remat_gap, abs(other_loss - loss) / abs(loss),
                        *(float((a - b).abs().max()
                                / b.abs().max().clamp_min(1e-30))
                          for a, b in zip(other, grads)))
        bitwise = bitwise and other_loss == loss and all(
            torch.equal(a, b) for a, b in zip(other, grads))
    emit({"phase": "train_oracle", "arch": cfg.name, "layers": 2,
          "dtype": "float32", "batch": 2, "seq_len": 512, "loss": loss,
          "cpu_loss": cpu_loss, "loss_rel_err": loss_rel,
          "grad_leaves": len(grads), "grad_leaf_rel_err_max": max(leaf_rel),
          "remat_off_dots_nothing_gap": remat_gap,
          "remat_bitwise": bitwise, "cpu_s": cpu_s})
    assert loss_rel <= 1e-4, loss_rel
    assert max(leaf_rel) <= 1e-3, leaf_rel
    assert remat_gap <= 1e-6, remat_gap
    del gpu, runs, grads
    torch.cuda.empty_cache()


def train_profile_phase(torch, cfg, steps=3):
    """torch.profiler over 3 full-width bf16 train steps (after one warm-up
    step): the device's idle share of the window and busy time by group
    (K3 forward, K3 backward, GEMMs, K2, everything else)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    trainer = _trainer(cfg, steps + 1)
    state = trainer.init_state()
    batches = [{k: torch.from_numpy(v).to(DEV)
                for k, v in trainer.pipeline.batch_at(i).items()}
               for i in range(steps + 1)]
    params, opt, _ = trainer._step(state["params"], state["opt"], batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[1:]:
            params, opt, m = trainer._step(params, opt, b)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    groups = {"flash_attention_fwd": 0.0, "flash_attention_bwd": 0.0,
              "gemm": 0.0, "rmsnorm": 0.0, "other": 0.0}
    counts = dict.fromkeys(groups, 0)
    kernels = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        low = e.key.lower()
        if "flash_fwd" in low:
            g = "flash_attention_fwd"
        elif "flash_bwd" in low:
            g = "flash_attention_bwd"
        elif "rmsnorm" in low:
            g = "rmsnorm"
        elif any(t in low for t in ("gemm", "cutlass", "xmma", "nvjet",
                                    "cublas")):
            g = "gemm"
        else:
            g = "other"
        groups[g] += us
        counts[g] += e.count
        kernels[e.key] = kernels.get(e.key, 0.0) + us
    busy = sum(groups.values())
    assert groups["flash_attention_fwd"] > 0 and groups["gemm"] > 0, groups
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    emit({"phase": "train_profile", "arch": cfg.name, "steps": steps,
          "wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
          "device_idle_share": 1 - busy / wall_us,
          "busy_ms_by_group": {k: v / 1e3 for k, v in groups.items()},
          "launches_by_group": counts,
          "top_kernels_ms": [[k[:90], v / 1e3] for k, v in top]})
    del trainer, state, params, opt
    torch.cuda.empty_cache()


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
    from repro_torch.kernels import flash_attention as fa_mod
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
    build.build("paged_attention", "matmul", "lora", "ssm_scan",
                "flash_attention")
    pa_mod.load_kernel()
    mm_mod.load_kernel()
    lora_mod.load_kernels()
    k7_mod.load_kernel()
    fa_mod.load_kernels()
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
    check_flash_attention(torch, results)
    for r in results:
        emit({"phase": "kernel", **r})
    check_rmsnorm_grad(torch)

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

    # 9. training: full-width qwen3-0.6b bf16 through the Trainer (K3
    # forward and backward, K2 through RMSNormFn), int8 moments, a restart,
    # the card's gradients against the CPU's, a profiled window
    train_launches = train_phase(torch, cfg)
    train_remat_phase(torch, cfg)
    train_restart_phase(torch, cfg)
    train_oracle_phase(torch, cfg)
    train_profile_phase(torch, cfg)

    # each row's launches come from the main path that gives its shape
    # (the row's ``path``): the qwen3-0.6b serve workload (K1 at head_dim
    # 128, K2 at 1,024 and 128), the compile phase (K4), the multi-LoRA
    # workload (K5/K6), the ssm workload (K7, K2 at 4,096) and the hybrid
    # workload (K1 at head_dim 80, K2 at 2,560 and 5,120) and the training
    # run (K3 forward and backward, K2 at the training rows)
    path_launches = {"serve": launches, "compile": compile_launches,
                     "lora_serve": lora_launches, "ssm_serve": ssm_launches,
                     "hybrid_serve": hybrid_launches,
                     "train": train_launches}
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
                     "src/repro/kernels/ssm_scan.py:33"),
        "flash_attention": (
            "cuda", "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:65")}
    summary = []
    for r in results:
        # the bf16 rows, and K7's, whose path is f32 only; not the
        # gate-only shapes no path gives
        if r["dtype"] != "bfloat16" and not r["name"].startswith("ssm_scan"):
            continue
        if r["path"] is None:
            continue
        kernel = r["name"].split("/")[0]
        route, source, replaces = sources[kernel]
        summary.append({
            "name": f"{r['name']} {r['shape']}", "route": route,
            "source": source, "replaces": replaces, "path": r["path"],
            "launches": path_launches[r["path"]][r.get("counter", kernel)],
            "max_abs_err": r["max_abs_err"],
            "row_rel_err": r["row_rel_err"], "ms": r["kernel_ms"],
            "host_ms": r["host_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **({"sass_mma": r["sass_mma"]} if "sass_mma" in r else {})})
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
