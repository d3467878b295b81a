#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check every kernel.

    python3 chip_smoke.py

Phases, each printing JSON objects one per line:

1. card     — nvidia-smi's name and power limit, torch and CUDA versions.
2. build    — nvcc builds the CUDA kernels (paged attention, matmul) from
              the repo's sources for sm_90a, one nvcc process per source, all
              started together, and prints ptxas's register and spill lines;
              Triton compiles the rmsnorm kernel.
3. kernels  — each kernel against its plain PyTorch version on the card at
              the shapes its path gives it (f32 and bf16), row by row
              (``ref.row_rel_err``), and planted faults that the same gate
              must reject; device times (calls captured in a CUDA graph and
              replayed between CUDA events) of the kernel, the plain version
              and one PyTorch library call that computes the same function
              (a yardstick the port never calls), the kernel wrapper's
              host-inclusive time, and the least time the card could take
              (bytes moved over 3.35 TB/s or operations over the type's peak
              rate).
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
   profile  — torch.profiler over 12 steps of a second engine: device busy
              time by kernel against the window's wall time, and each
              kernel's device time per launch on the main path.
6. oracle   — teacher-forced logits of the paged path (kernels) against the
              dense prefill + decode path (plain attention), f32 and bf16.

Then a ``{"kernels": [...]}`` summary line, nvidia-smi's line, and, last,
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


def check_paged_attention(torch, results):
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.models.attention import paged_gather
    b, h, kv, hd, bs, max_len = 8, 16, 8, 128, 16, 2048
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
            name="paged_attention/decode", dtype=dname,
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


def check_rmsnorm(torch, results):
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm_kernel
    gen = torch.Generator(device=DEV).manual_seed(1)
    eps = 1e-6
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        esize = torch.finfo(dtype).bits // 8
        for rows, d in ((8, 1024), (256, 1024), (8 * 16, 128),
                        (256 * 16, 128)):
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
                **checked,
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
                **checked,
                kernel_ms=graph_ms(lambda: matmul_kernel(a, b)),
                host_ms=host_ms(lambda: matmul_kernel(a, b)),
                plain_ms=graph_ms(lambda: ref.matmul_ref(a, b)),
                library_ms=graph_ms(lambda: torch.matmul(a, b)),
                bound_ms=t_bound, bound_by=by))


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


def compile_phase(torch, cfg, counters, calls=4):
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
    for c in counters:
        c.launches = 0
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
    launches = {c.__name__.rsplit(".", 1)[1]: c.launches for c in counters}
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

def workload(vocab, n=16, seed=0):
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
        reqs.append(Request(rid=i, prompt=prompt, max_new=32, sampling=sp))
    return reqs


def serve_phase(torch, cfg, counters, path_counters):
    from repro_torch.models import build_model
    from repro_torch.serve.engine import Request, ServeEngine
    params = build_model(cfg, DEV).init(0)
    eng = ServeEngine(cfg, params, max_batch=8, max_len=2048, block_size=16,
                      prefill_chunk_tokens=256)
    assert eng.kernel_plan is not None
    # warm-up: cuBLAS handles and Triton's shape specialisations
    for i in range(2):
        eng.submit(Request(rid=1000 + i, max_new=4,
                           prompt=[1 + t % (cfg.vocab - 1)
                                   for t in range(300 + i)]))
    eng.run_until_done()
    eng.release_prefix_cache()
    eng.reset_metrics()
    reqs = workload(cfg.vocab)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
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
    launches = {c.__name__.rsplit(".", 1)[1]: c.launches for c in counters}
    m = eng.metrics()
    assert all(r.done and not r.rejected and len(r.out) == r.max_new
               for r in reqs), [r.finish_reason for r in reqs]
    assert all(launches[c.__name__.rsplit(".", 1)[1]] > 0
               for c in path_counters), launches
    assert m.requests_finished == len(reqs)
    emit({"phase": "serve", "arch": cfg.name, "dtype": cfg.dtype,
          "requests": len(reqs), "engine_steps": eng.steps,
          "wall_s": wall, "invariant_check_s": check_s,
          "tokens_per_sec": m.tokens_per_sec,
          "ttft_mean_s": m.ttft_mean_s, "ttft_max_s": m.ttft_max_s,
          "itl_mean_s": m.itl_mean_s, "prefill_tokens": m.prefill_tokens,
          "decode_tokens": m.decode_tokens,
          "peak_blocks_used": m.peak_blocks_used,
          "pool_blocks": m.pool_blocks, "shared_blocks": m.shared_blocks,
          "re_prefill_avoided": m.re_prefill_avoided,
          "preemptions": m.preemptions,
          "peak_device_bytes": torch.cuda.max_memory_allocated(),
          "launches": launches,
          "launches_per_step": {k: v / eng.steps for k, v in launches.items()},
          "pages_per_fetch": eng.pages_per_fetch,
          "kernel_plan": repr(eng.kernel_plan),
          "compile_report_decode": eng.compile_report.summary().splitlines()})
    del eng
    torch.cuda.empty_cache()
    plan_identity(torch, cfg, params)
    del params
    torch.cuda.empty_cache()
    return launches


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


def profile_phase(torch, cfg, steps=12):
    """Device busy time by kernel over a steady window of engine steps
    (torch.profiler), against the window's host wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import build_model
    from repro_torch.serve.engine import ServeEngine
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
    groups = {"paged_attention": 0.0, "rmsnorm": 0.0, "gemm": 0.0,
              "other": 0.0}
    ported = {"paged_attention": 0, "rmsnorm": 0}
    for name, us in kernels.items():
        low = name.lower()
        if "paged_attention" in low:
            groups["paged_attention"] += us
            ported["paged_attention"] += counts[name]
        elif "rmsnorm" in low:
            groups["rmsnorm"] += us
            ported["rmsnorm"] += counts[name]
        elif any(t in low for t in ("gemm", "cutlass", "xmma", "nvjet",
                                    "cublas")):
            groups["gemm"] += us
        else:
            groups["other"] += us
    busy = sum(groups.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    emit({"phase": "profile", "steps": steps, "wall_ms": wall_us / 1e3,
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
    from repro_torch.kernels import matmul as mm_mod
    from repro_torch.kernels import paged_attention as pa_mod
    from repro_torch.kernels import rmsnorm as rn_mod
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
    build.build("paged_attention", "matmul")
    pa_mod.load_kernel()
    mm_mod.load_kernel()
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
    for r in results:
        emit({"phase": "kernel", **r})

    counters = [pa_mod, rn_mod, mm_mod]
    cfg = get_config("qwen3-0.6b")
    # 4. the compile pipeline at full width, kernels on the card
    compile_launches = compile_phase(torch, cfg, counters)
    # 5. serve, full width, bf16, and a profiled window of a second engine
    launches = serve_phase(torch, cfg, counters, [pa_mod, rn_mod])
    launches["matmul"] = compile_launches["matmul"]
    profile_phase(torch, cfg)
    # 6. oracle in f32 and bf16
    oracle_phase(torch, dataclasses.replace(cfg, dtype="float32"))
    oracle_phase(torch, cfg)

    sources = {"paged_attention": (
        "cuda", "src/repro_torch/kernels/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention.py:113", "paged_attention"),
        "rmsnorm": ("triton", "src/repro_torch/kernels/_rmsnorm_triton.py",
                    "src/repro/kernels/rmsnorm.py:19", "rmsnorm"),
        "matmul": ("cuda", "src/repro_torch/kernels/csrc/matmul.cu",
                   "src/repro/kernels/matmul.py:33", "matmul")}
    summary = []
    for r in results:
        if r["dtype"] != "bfloat16":
            continue
        route, source, replaces, counter = sources[r["name"].split("/")[0]]
        summary.append({
            "name": f"{r['name']} {r['shape']}", "route": route,
            "source": source, "replaces": replaces,
            "launches": launches[counter],
            "max_abs_err": r["max_abs_err"],
            "row_rel_err": r["row_rel_err"], "ms": r["kernel_ms"],
            "host_ms": r["host_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
