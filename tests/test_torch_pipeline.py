"""``repro_torch.pipeline`` against ``repro.pipeline``.

Under the reference-constant hardware record the port's ``compile()`` must
report exactly what the reference reports: costs, modeled speedup,
saturation statistics, schedule, kernel plan and buffer plan, on the terms
the reference's pipeline test and serve engine compile.  Also: the cache
(hits, disk, key sensitivity, and never a pickle of the other package), the
kernel-plan loop-name caveat (ROADMAP C0) pinned in both packages, and the
H100 record's schedules fitting 227 KB or being reported infeasible.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import reference_hardware
from repro import pipeline as rp
from repro.core import codegen as r_cg
from repro.core import tensor_ir as r_ir
from repro.serve import engine as r_engine
from repro_torch import pipeline as tp
from repro_torch.core import codegen as t_cg
from repro_torch.core import tensor_ir as t_ir
from repro_torch.core.hardware import H100
from repro_torch.kernels import ref
from repro_torch.serve import engine as t_engine

torch.set_num_threads(1)

REF = reference_hardware()
ROOT = Path(__file__).resolve().parents[1]
ENGINE_OPTS = dict(extraction="greedy", schedule_iterations=10)


def fig3(ir, n=1024, d=128):
    Q, K, V = ir.inp("Q", (n, d)), ir.inp("K", (d, n)), ir.inp("V", (n, d))
    return ir.matmul(ir.unary(ir.matmul(Q, K), kind="exp"), V)


def mlp(ir, t=256, d=1024, f=3072):
    x, w1, w2 = ir.inp("x", (t, d)), ir.inp("w1", (d, f)), ir.inp("w2", (f, d))
    return ir.matmul(ir.unary(ir.matmul(x, w1), kind="silu"), w2)


CASES = {
    "fig3-wpmaxsat": (lambda ir: fig3(ir, 256), {}),
    "fig3-greedy": (lambda ir: fig3(ir), dict(extraction="greedy")),
    "decode-term": (lambda ir: r_engine.paged_decode_attention_term(2048, 128)
                    if ir is r_ir else
                    t_engine.paged_decode_attention_term(2048, 128),
                    ENGINE_OPTS),
    "prefill-term": (lambda ir: r_engine.chunked_prefill_attention_term(
        256, 512, 128) if ir is r_ir else
        t_engine.chunked_prefill_attention_term(256, 512, 128), ENGINE_OPTS),
    "mlp-no-vectorize": (lambda ir: mlp(ir, 64, 256, 512),
                         dict(extraction="greedy", vectorize=False,
                              schedule_iterations=5)),
    "bnb-no-schedule": (lambda ir: fig3(ir, 256),
                        dict(extraction="branch-and-bound", schedule=False,
                             buffer_plan="optimal")),
}


def _report_fields(rep):
    sched = None
    if rep.schedule is not None:
        sched = dict(rep.schedule)
        if "vmem_peak" in sched:
            sched["smem_peak"] = sched.pop("vmem_peak")
        sched.pop("feasible", None)
    plan = dataclasses.asdict(rep.kernel_plan) if rep.kernel_plan else None
    return (rep.egraph, rep.extraction_backend, rep.baseline_cost,
            rep.optimized_cost, rep.modeled_speedup, sched, plan, rep.buffer,
            sorted(rep.pass_times))


@pytest.mark.parametrize("case", sorted(CASES))
def test_report_matches_reference(case):
    build, opts = CASES[case]
    r = rp.Compiler(cache_dir=None).compile(build(r_ir),
                                            options=rp.CompileOptions(**opts))
    t = tp.Compiler(cache_dir=None).compile(
        build(t_ir), target=tp.CompileTarget(hardware=REF),
        options=tp.CompileOptions(**opts))
    assert _report_fields(r.report) == _report_fields(t.report)
    assert repr(r.term) == repr(t.term)
    assert repr(r.logical_term) == repr(t.logical_term)


def test_engine_terms_and_bridge_match_reference():
    for rt, tt in ((r_engine.attention_block_term(64, 16),
                    t_engine.attention_block_term(64, 16)),
                   (fig3(r_ir), fig3(t_ir)), (mlp(r_ir), mlp(t_ir))):
        assert repr(rt) == repr(tt)
        assert repr(rp.tile_graph_from_term(rt)) == \
            repr(tp.tile_graph_from_term(tt))
    bad = t_ir.transpose(t_ir.inp("x", (64, 32)), (1, 0))
    assert tp.tile_graph_from_term(bad) is None


def test_kernel_plan_loop_name_caveat_pinned():
    """The bridge names loops l0, l1, ... and ``kernel_plan`` looks up
    i, j, k, l: in both packages the engine's plan is the record's defaults,
    whatever tiles the schedule chose (ROADMAP C0)."""
    from repro.core.schedule import auto_schedule
    r = rp.Compiler(cache_dir=None).compile(
        r_engine.paged_decode_attention_term(2048, 128),
        options=rp.CompileOptions(**ENGINE_OPTS))
    _, sched, _ = auto_schedule(rp.tile_graph_from_term(r.logical_term),
                                iterations=10)
    loops = {name for tiles in sched.tiles.values() for name in tiles}
    assert loops and loops.isdisjoint({"i", "j", "k", "l"})
    assert r.report.kernel_plan == r_cg.KernelPlan()
    for hw in (REF, H100):
        t = tp.Compiler(cache_dir=None).compile(
            t_engine.paged_decode_attention_term(2048, 128),
            target=tp.CompileTarget(hardware=hw),
            options=tp.CompileOptions(**ENGINE_OPTS))
        assert t.report.kernel_plan == t_cg.kernel_plan(
            t_cg.Schedule({}, 0.0, 0.0, 0.0, 0), hw=hw)
        if hw is REF:
            assert dataclasses.asdict(t.report.kernel_plan) == \
                dataclasses.asdict(r_cg.KernelPlan())


@pytest.mark.parametrize("name", ["decode", "prefill", "mlp"])
def test_h100_schedule_fits_shared_memory_or_is_infeasible(name):
    term = {"decode": t_engine.paged_decode_attention_term(2048, 128),
            "prefill": t_engine.chunked_prefill_attention_term(256, 2048,
                                                               128),
            "mlp": mlp(t_ir)}[name]
    res = tp.Compiler(cache_dir=None).compile(
        term, options=tp.CompileOptions(**ENGINE_OPTS))
    s = res.report.schedule
    assert s["feasible"] == (s["smem_peak"] <= H100.onchip_bytes)
    assert s["feasible"]
    assert "smem peak" in res.report.summary()
    assert res.report.kernel_plan == t_cg.KernelPlan()


def test_no_tiling_fits_is_reported_infeasible():
    tiny = dataclasses.replace(H100, name="tiny", onchip_bytes=8)
    res = tp.Compiler(cache_dir=None).compile(
        t_engine.paged_decode_attention_term(256, 64),
        target=tp.CompileTarget(hardware=tiny),
        options=tp.CompileOptions(**ENGINE_OPTS))
    s = res.report.schedule
    assert not s["feasible"] and s["latency"] == float("inf")
    # kernel_plan of a schedule with no tiles: the record's defaults
    assert res.report.kernel_plan == t_cg.KernelPlan()


def test_compiled_term_runs_on_torch_and_matches_plain():
    term = fig3(t_ir, 256)
    rng = np.random.default_rng(0)
    env = {n: torch.from_numpy((rng.normal(size=s) * 0.1).astype(np.float32))
           for n, s in (("Q", (256, 128)), ("K", (128, 256)),
                        ("V", (256, 128)))}
    plain = t_cg.compile_term(term)(**env)
    for kernels in (False, True):
        res = tp.Compiler(cache_dir=None).compile(
            term, target=tp.CompileTarget(use_kernels=kernels))
        assert res.report.modeled_speedup > 1.0 and res.term != term
        assert ref.row_rel_err(res(**env), plain)[1] <= 1e-5


def test_cache_hit_disk_and_key_sensitivity(tmp_path):
    term = fig3(t_ir, 256)
    opts = tp.CompileOptions(extraction="greedy")
    c = tp.Compiler(cache_dir=str(tmp_path))
    first, second = c.compile(term, options=opts), c.compile(term, options=opts)
    assert not first.report.cache_hit and second.report.cache_hit
    assert c.stats == {"hits": 1, "misses": 1}
    fresh = tp.Compiler(cache_dir=str(tmp_path))
    assert fresh.compile(term, options=opts).report.cache_hit
    base = tp.cache_key(term, tp.CompileTarget(), opts)
    assert base != tp.cache_key(term, tp.CompileTarget(hardware=REF), opts)
    assert base != tp.cache_key(term, tp.CompileTarget(use_kernels=True), opts)
    assert base != tp.cache_key(term, tp.CompileTarget(),
                                tp.CompileOptions())
    assert base == tp.cache_key(fig3(t_ir, 256), tp.CompileTarget(), opts)
    small = t_ir.matmul(t_ir.inp("a", (64, 64)), t_ir.inp("b", (64, 64)))
    sopts = tp.CompileOptions(extraction="greedy", schedule=False)
    tp.compile(small, options=sopts)
    assert tp.compile(small, options=sopts).report.cache_hit
    with pytest.raises(ValueError):
        tp.CompileOptions(extraction="magic")
    with pytest.raises(TypeError):
        tp.Compiler().compile("not a term")


def test_cache_never_crosses_packages(tmp_path):
    """One REPRO_CACHE_DIR shared by both packages: each writes its own
    entries and neither reads the other's, even for the same term, target
    fields and options; a port process whose cache dir holds only the
    reference's pickles misses and imports nothing of ``repro``."""
    opts = dict(extraction="greedy", schedule=False)
    rdir = tmp_path / "shared"
    rp.Compiler(cache_dir=str(rdir)).compile(fig3(r_ir, 256),
                                             options=rp.CompileOptions(**opts))
    ref_files = set(os.listdir(rdir))
    assert len(ref_files) == 1
    t = tp.Compiler(cache_dir=str(rdir))
    res = t.compile(fig3(t_ir, 256), target=tp.CompileTarget(hardware=REF),
                    options=tp.CompileOptions(**opts))
    assert not res.report.cache_hit and t.stats["misses"] == 1
    port_files = set(os.listdir(rdir)) - ref_files
    assert len(port_files) == 1
    r2 = rp.Compiler(cache_dir=str(rdir))
    assert r2.compile(fig3(r_ir, 256),
                      options=rp.CompileOptions(**opts)).report.cache_hit
    with open(rdir / port_files.pop(), "rb") as f:
        assert type(pickle.load(f)["packed"]).__module__ == \
            "repro_torch.core.tensor_ir"
    probe = (
        "import sys\n"
        "from repro_torch import pipeline as tp\n"
        "from repro_torch.core import tensor_ir as ir\n"
        "Q, K, V = ir.inp('Q', (256, 128)), ir.inp('K', (128, 256)), "
        "ir.inp('V', (256, 128))\n"
        "t = ir.matmul(ir.unary(ir.matmul(Q, K), kind='exp'), V)\n"
        "c = tp.Compiler()\n"
        "r = c.compile(t, options=tp.CompileOptions(extraction='greedy', "
        "schedule=False))\n"
        "bad = [m for m in sys.modules if m == 'repro' or "
        "m.startswith('repro.') or m.split('.')[0] == 'jax']\n"
        "print(r.report.cache_hit, c.stats['misses'], bad)\n")
    only_ref = tmp_path / "only_ref"
    rp.Compiler(cache_dir=str(only_ref)).compile(
        fig3(r_ir, 256), options=rp.CompileOptions(**opts))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_CACHE_DIR=str(only_ref))
    out = subprocess.run([sys.executable, "-c", probe], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "1", "[]"]
