"""Port layers, attention blocks and the dense transformer against the JAX
package on the CPU, on the same bridged weights and numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (DENSE_ARCHS, LOGITS_TOL, MODULE_TOL, assert_close,
                           bridged_params, reduced)
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf

torch.set_num_threads(1)


def _attn_params(arch="qwen3-0.6b", seed=0):
    jcfg, tcfg = reduced(arch)
    jp = jattn.init_attention(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jcfg, tcfg, jp, tp


def _pool(cfg, n, bs, seed):
    rng = np.random.default_rng(seed)
    shape = (n, bs, cfg.n_kv_heads, cfg.resolved_head_dim)
    return (rng.normal(size=shape).astype(np.float32) * 0.3,
            rng.normal(size=shape).astype(np.float32) * 0.3, rng)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "phi3-mini-3.8b"])
def test_qkv_project_matches_jax(arch):
    """Projections, qk-norm (qwen3) and RoPE."""
    jcfg, tcfg, jp, tp = _attn_params(arch, seed=1)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, jcfg.d_model)).astype(np.float32)
    pos = np.asarray([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]], np.int32)
    jq = jattn.qkv_project(jcfg, jp, jnp.asarray(x), jnp.asarray(pos))
    tq = tattn.qkv_project(tcfg, tp, torch.from_numpy(x),
                           torch.from_numpy(pos))
    for name, got, want in zip("qkv", tq, jq):
        assert_close(got, want, MODULE_TOL, name)


@pytest.mark.parametrize("act", ["swiglu", "squared_relu", "gelu"])
def test_mlp_and_rms_norm_match_jax(act):
    import dataclasses
    jcfg, tcfg = reduced("qwen3-0.6b")
    jcfg, tcfg = (dataclasses.replace(c, act=act) for c in (jcfg, tcfg))
    jp = jlayers.init_mlp(jcfg, jax.random.PRNGKey(3), jcfg.d_ff, jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 3, jcfg.d_model)).astype(np.float32)
    w = rng.normal(size=(jcfg.d_model,)).astype(np.float32)
    assert_close(tlayers.apply_mlp(tcfg, tp, torch.from_numpy(x)),
                 jlayers.apply_mlp(jcfg, jp, jnp.asarray(x)), MODULE_TOL, act)
    assert_close(tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
                 jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w)), MODULE_TOL,
                 "rms_norm")


def test_paged_scatter_token_matches_jax():
    """Live rows land where JAX puts them; a dead row (null table) writes
    only the null block."""
    jcfg, _ = reduced("qwen3-0.6b")
    kp, _, rng = _pool(jcfg, 9, 4, seed=2)
    tables = np.asarray([[3, 5], [0, 0], [7, 1]], np.int32)
    pos = np.asarray([5, 0, 2], np.int32)
    vals = rng.normal(size=(3, jcfg.n_kv_heads,
                            jcfg.resolved_head_dim)).astype(np.float32)
    want = np.asarray(jattn.paged_scatter_token(
        jnp.asarray(kp), jnp.asarray(tables), jnp.asarray(pos),
        jnp.asarray(vals)))
    got = torch.from_numpy(kp.copy())
    out = tattn.paged_scatter_token(got, torch.from_numpy(tables),
                                    torch.from_numpy(pos),
                                    torch.from_numpy(vals))
    assert out is got, "the port scatters in place"
    np.testing.assert_array_equal(got.numpy()[1:], want[1:])


@pytest.mark.parametrize("mode", ["gather", "kernel"])
def test_attention_decode_block_paged_matches_jax(mode, monkeypatch):
    """Both REPRO_PAGED_ATTN paths: JAX's interpret-mode Pallas kernel
    against the port's kernel wrapper (plain version on CPU tensors)."""
    monkeypatch.setenv("REPRO_PAGED_ATTN", mode)
    jcfg, tcfg, jp, tp = _attn_params(seed=4)
    b, m, bs = 3, 4, 8
    kp, vp, rng = _pool(jcfg, b * m + 1, bs, seed=8)
    tables = rng.permutation(np.arange(1, b * m + 1)).reshape(b, m) \
        .astype(np.int32)
    x = rng.normal(size=(b, 1, jcfg.d_model)).astype(np.float32) * 0.3
    lens = np.asarray([0, 9, 26], np.int32)
    jo, jk, jv = jattn.attention_decode_block_paged(
        jcfg, jp, jnp.asarray(x), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lens))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    to, _, _ = tattn.attention_decode_block_paged(
        tcfg, tp, torch.from_numpy(x), tk, tv, torch.from_numpy(tables),
        torch.from_numpy(lens))
    assert_close(to, jo, MODULE_TOL, "out")
    assert_close(tk[1:], np.asarray(jk)[1:], MODULE_TOL, "k pages")
    assert_close(tv[1:], np.asarray(jv)[1:], MODULE_TOL, "v pages")


@pytest.mark.parametrize("mode", ["gather", "kernel"])
def test_attention_prefill_chunk_block_matches_jax(mode, monkeypatch):
    """A chunk that runs past the prompt (padding to the null block), with
    the attended span bounded by m_used."""
    monkeypatch.setenv("REPRO_PAGED_ATTN", mode)
    jcfg, tcfg, jp, tp = _attn_params(seed=5)
    m, bs, c = 4, 8, 8
    kp, vp, rng = _pool(jcfg, m + 3, bs, seed=9)
    table = np.asarray([[2, 5, 1, 0]], np.int32)
    start, prompt_len = 8, 13
    x = rng.normal(size=(1, c, jcfg.d_model)).astype(np.float32) * 0.3
    cpos = np.arange(start, start + c, dtype=np.int32)
    m_used = -(-(start + c) // bs)
    jo, jk, jv = jattn.attention_prefill_chunk_block(
        jcfg, jp, jnp.asarray(x), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(cpos), jnp.int32(prompt_len),
        m_used=m_used)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    to, _, _ = tattn.attention_prefill_chunk_block(
        tcfg, tp, torch.from_numpy(x), tk, tv, torch.from_numpy(table),
        torch.from_numpy(cpos), torch.tensor(prompt_len), m_used=m_used)
    real = prompt_len - start
    assert_close(to[:, :real], np.asarray(jo)[:, :real], MODULE_TOL, "out")
    assert_close(tk[1:], np.asarray(jk)[1:], MODULE_TOL, "k pages")
    assert_close(tv[1:], np.asarray(jv)[1:], MODULE_TOL, "v pages")


PROMPT = [3, 5, 7, 11, 13, 17, 19]
FORCED = [23, 29, 31, 37]      # teacher-forced decode tokens


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_dense_oracle_logits_match_jax(arch):
    """lm_prefill + teacher-forced lm_decode_step, logits per step."""
    jcfg, tcfg, jparams, tparams = bridged_params(arch)
    s = len(PROMPT)
    cap = s + len(FORCED)
    jc, jl = jtf.lm_prefill(jcfg, jparams,
                            {"tokens": jnp.asarray([PROMPT], jnp.int32)})
    tc, tl = ttf.lm_prefill(tcfg, tparams,
                            {"tokens": torch.tensor([PROMPT])})
    assert_close(tl, jl, LOGITS_TOL, "prefill logits")
    assert_close(tc["k"], jc["k"], MODULE_TOL, "prefill k cache")
    jcache = jtf.make_decode_cache(jcfg, 1, cap, jnp.float32)
    jcache = {k: v.at[:, :, :s].set(jc[k]) for k, v in jcache.items()}
    tcache = ttf.make_decode_cache(tcfg, 1, cap, torch.float32, "cpu")
    for k in tcache:
        tcache[k][:, :, :s] = tc[k]
    for i, tok in enumerate(FORCED):
        jcache, jl = jtf.lm_decode_step(
            jcfg, jparams, jcache, {"token": jnp.asarray([[tok]], jnp.int32),
                                    "cur_len": jnp.int32(s + i)})
        tcache, tl = ttf.lm_decode_step(
            tcfg, tparams, tcache, {"token": torch.tensor([[tok]]),
                                    "cur_len": s + i})
        assert_close(tl, jl, LOGITS_TOL, f"decode step {i}")


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_paged_logits_match_jax(arch):
    """lm_prefill_chunk (3-token chunks, m_used) + teacher-forced
    lm_decode_step_paged with a dead second row, logits per step, and the
    paged caches afterwards (null block excluded)."""
    jcfg, tcfg, jparams, tparams = bridged_params(arch, seed=1)
    bs, n, c = 4, 8, 3
    table = np.asarray([[4, 2, 6, 0]], np.int32)
    jcache = jtf.make_paged_cache(jcfg, n, bs, jnp.float32)
    tcache = ttf.make_paged_cache(tcfg, n, bs, torch.float32, "cpu")
    plen = len(PROMPT)
    for start in range(0, plen, c):
        end = min(plen, start + c)
        chunk = PROMPT[start:end] + [0] * (c - (end - start))
        m_used = -(-end // bs)
        jcache, jl = jtf.lm_prefill_chunk(
            jcfg, jparams, jcache,
            {"tokens": jnp.asarray([chunk], jnp.int32),
             "block_table": jnp.asarray(table), "start": jnp.int32(start),
             "prompt_len": jnp.int32(end)}, m_used=m_used)
        tcache, tl = ttf.lm_prefill_chunk(
            tcfg, tparams, tcache,
            {"tokens": torch.tensor([chunk]),
             "block_table": torch.from_numpy(table), "start": start,
             "prompt_len": end}, m_used=m_used)
        real = end - start
        assert_close(tl[:, :real], np.asarray(jl)[:, :real], LOGITS_TOL,
                     f"chunk at {start}")
    tables = np.concatenate([table, np.zeros_like(table)])
    for i, tok in enumerate(FORCED):
        batch = {"token": np.asarray([[tok], [0]], np.int32),
                 "block_tables": tables,
                 "seq_lens": np.asarray([plen + i, 0], np.int32)}
        jcache, jl = jtf.lm_decode_step_paged(
            jcfg, jparams, jcache, {k: jnp.asarray(v) for k, v in batch.items()})
        tcache, tl = ttf.lm_decode_step_paged(
            tcfg, tparams, tcache,
            {k: torch.from_numpy(v) for k, v in batch.items()})
        assert_close(tl[:1], np.asarray(jl)[:1], LOGITS_TOL, f"decode {i}")
    for k in ("k", "v"):
        assert_close(tcache[k][:, 1:], np.asarray(jcache[k])[:, 1:],
                     MODULE_TOL, f"paged {k} cache")
