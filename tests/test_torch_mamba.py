"""The port's Mamba1 and Mamba2 blocks, the ssm LM and the hybrid against
the JAX package on the CPU, on the same bridged weights and numpy inputs.

The port's Mamba1 runs the selective scan sequentially (the plain version
of K7 on the CPU); the JAX package runs an associative scan inside each
``cfg.ssm.chunk``-step chunk.  The two agree to float32 reassociation, so
every comparison is relative to the reference's largest value: module
outputs and states within ``MODULE_TOL``, logits within ``LOGITS_TOL``
(1e-5, the f32 bound set for this slice)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import MODULE_TOL, assert_close, bridged_params, reduced
from repro.models import attention as jattn
from repro.models import hybrid as jhy
from repro.models import mamba as jmb
from repro.models import ssm_lm as jssm
from repro_torch import bridge
from repro_torch.models import attention as tattn
from repro_torch.models import hybrid as thy
from repro_torch.models import mamba as tmb
from repro_torch.models import ssm_lm as tssm

torch.set_num_threads(1)

LOGITS_TOL = 1e-5
SSM, HYBRID = "falcon-mamba-7b", "zamba2-2.7b"
PROMPT = [5, 17, 3, 99, 42, 7, 250, 11, 64, 128, 2, 31, 77, 9, 200, 1, 13,
          6, 240]
FORCED = [8, 150, 33, 4, 201]


def _layer(arch, version, seed=0):
    """(JAX cfg, port cfg, JAX params, port params) of one Mamba layer."""
    jcfg, tcfg = reduced(arch)
    init = jmb.init_mamba1 if version == 1 else jmb.init_mamba2
    jp = init(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    tp = {k: bridge.tensor_from_numpy(np.asarray(v)) for k, v in jp.items()}
    return jcfg, tcfg, jp, tp


def _state(cfg, version, b, seed):
    rng = np.random.default_rng(seed)
    di = cfg.ssm.expand * cfg.d_model
    if version == 1:
        h = rng.normal(size=(b, di, cfg.ssm.d_state)) * 0.3
    else:
        h = rng.normal(size=(b, di // cfg.ssm.head_dim, cfg.ssm.head_dim,
                             cfg.ssm.d_state)) * 0.3
    conv = rng.normal(size=(b, cfg.ssm.d_conv - 1, di)) * 0.5
    return {"h": h.astype(np.float32), "conv": conv.astype(np.float32)}


def _both(tree):
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in tree.items()})


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).normal(
        size=(b, s, cfg.d_model)).astype(np.float32)


FNS = {1: (jmb.mamba1_forward, tmb.mamba1_forward, jmb.mamba1_chunk,
           tmb.mamba1_chunk, jmb.mamba1_decode_step, tmb.mamba1_decode_step),
       2: (jmb.mamba2_forward, tmb.mamba2_forward, jmb.mamba2_chunk,
           tmb.mamba2_chunk, jmb.mamba2_decode_step, tmb.mamba2_decode_step)}
ARCH = {1: SSM, 2: HYBRID}


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("s", [5, 19])
def test_forward_matches_jax(version, s):
    """Whole-sequence forward: output, final scan state and conv window
    (19 steps cross two scan chunks of the reduced config)."""
    jcfg, tcfg, jp, tp = _layer(ARCH[version], version, seed=s)
    jf, tf = FNS[version][:2]
    x = _x(jcfg, 2, s, seed=1)
    jo, jst = jf(jcfg, jp, jnp.asarray(x))
    to, tst = tf(tcfg, tp, torch.from_numpy(x))
    assert_close(to, jo, MODULE_TOL, "out")
    for k in ("h", "conv"):
        assert_close(tst[k], jst[k], MODULE_TOL, k)


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("valid_len", [8, 5, 0])
def test_chunk_matches_jax(version, valid_len):
    """One prompt chunk from a carried state with ``valid_len`` real
    positions (the rest masked to identity steps): the real outputs, the
    state after the last real token and the next conv carry."""
    jcfg, tcfg, jp, tp = _layer(ARCH[version], version, seed=3)
    jc, tc = FNS[version][2:4]
    x = _x(jcfg, 1, 8, seed=2)
    jst, tst = _both(_state(jcfg, version, 1, seed=4))
    jo, jst2 = jc(jcfg, jp, jnp.asarray(x), jst, jnp.int32(valid_len))
    to, tst2 = tc(tcfg, tp, torch.from_numpy(x), tst, valid_len)
    if valid_len:
        assert_close(to[:, :valid_len], np.asarray(jo)[:, :valid_len],
                     MODULE_TOL, "out")
    for k in ("h", "conv"):
        assert_close(tst2[k], jst2[k], MODULE_TOL, k)
    if valid_len == 0:
        assert torch.equal(tst2["h"], tst["h"]), "a masked chunk moved h"


@pytest.mark.parametrize("version", [1, 2])
def test_decode_step_matches_jax(version):
    jcfg, tcfg, jp, tp = _layer(ARCH[version], version, seed=5)
    jd, td = FNS[version][4:6]
    x = _x(jcfg, 3, 1, seed=6)
    jst, tst = _both(_state(jcfg, version, 3, seed=7))
    jo, jst2 = jd(jcfg, jp, jnp.asarray(x), jst)
    to, tst2 = td(tcfg, tp, torch.from_numpy(x), tst)
    assert_close(to, jo, MODULE_TOL, "out")
    for k in ("h", "conv"):
        assert_close(tst2[k], jst2[k], MODULE_TOL, k)


def test_attention_block_matches_jax():
    jcfg, tcfg = reduced(HYBRID)
    jp = jattn.init_attention(jcfg, jax.random.PRNGKey(2), jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = _x(jcfg, 2, 7, seed=8)
    pos = np.broadcast_to(np.arange(7)[None], (2, 7)).astype(np.int32)
    assert_close(tattn.attention_block(tcfg, tp, torch.from_numpy(x),
                                       torch.from_numpy(pos)),
                 jattn.attention_block(jcfg, jp, jnp.asarray(x),
                                       jnp.asarray(pos)),
                 MODULE_TOL, "attention_block")


def _grow(small, cap):
    """A prompt-sized hybrid cache grown to capacity ``cap`` (K/V written
    at positions 0..S-1), in each package's own layout."""
    if isinstance(small["k"], torch.Tensor):
        out = {"ssm": small["ssm"]}
        for k in ("k", "v"):
            v = small[k]
            big = torch.zeros(v.shape[:2] + (cap,) + v.shape[3:], dtype=v.dtype)
            big[:, :, :v.shape[2]] = v
            out[k] = big
        return out
    out = {"ssm": small["ssm"]}
    for k in ("k", "v"):
        v = small[k]
        big = jnp.zeros(v.shape[:2] + (cap,) + v.shape[3:], v.dtype)
        out[k] = big.at[:, :, :v.shape[2]].set(v)
    return out


@pytest.mark.parametrize("arch", [SSM, HYBRID])
def test_dense_oracle_logits_match_jax(arch):
    """prefill + teacher-forced decode_step, logits per step, of the ssm LM
    and the hybrid (and their caches after the prompt)."""
    jcfg, tcfg, jparams, tparams = bridged_params(arch)
    jm = {SSM: (jssm.ssm_lm_prefill, jssm.ssm_lm_decode_step),
          HYBRID: (jhy.hybrid_prefill, jhy.hybrid_decode_step)}[arch]
    tm = {SSM: (tssm.ssm_lm_prefill, tssm.ssm_lm_decode_step),
          HYBRID: (thy.hybrid_prefill, thy.hybrid_decode_step)}[arch]
    s = len(PROMPT)
    jc, jl = jm[0](jcfg, jparams, {"tokens": jnp.asarray([PROMPT], jnp.int32)})
    tc, tl = tm[0](tcfg, tparams, {"tokens": torch.tensor([PROMPT])})
    assert_close(tl, jl, LOGITS_TOL, "prefill logits")
    hs = (tc, jc) if arch == SSM else (tc["ssm"], jc["ssm"])
    assert_close(hs[0]["h"], hs[1]["h"], MODULE_TOL, "prefill state")
    if arch == HYBRID:
        assert_close(tc["k"], jc["k"], MODULE_TOL, "prefill k")
        tc, jc = _grow(tc, s + len(FORCED)), _grow(jc, s + len(FORCED))
    for i, tok in enumerate(FORCED):
        jb = {"token": jnp.asarray([[tok]], jnp.int32),
              "cur_len": jnp.int32(s + i)}
        tb = {"token": torch.tensor([[tok]]), "cur_len": s + i}
        jc, jl = jm[1](jcfg, jparams, jc, jb)
        tc, tl = tm[1](tcfg, tparams, tc, tb)
        assert_close(tl, jl, LOGITS_TOL, f"decode step {i}")


# (prefill chunk, paged decode) of each package
PAGED = {SSM: ((jssm.ssm_lm_prefill_chunk, tssm.ssm_lm_prefill_chunk),
               (jssm.ssm_lm_decode_step_paged, tssm.ssm_lm_decode_step_paged)),
         HYBRID: ((jhy.hybrid_prefill_chunk, thy.hybrid_prefill_chunk),
                  (jhy.hybrid_decode_step_paged,
                   thy.hybrid_decode_step_paged))}


@pytest.mark.parametrize("arch", [SSM, HYBRID])
def test_paged_logits_match_jax(arch):
    """The paged functions on a slab (slot 2 of 3) and, for the hybrid, a
    block pool: 8-token prefill chunks from a recycled (non-zero) slot, then
    teacher-forced decode with a padded second row on the null slot."""
    jcfg, tcfg, jparams, tparams = bridged_params(arch, seed=1)
    bs, n, c, slot = 4, 10, 8, 2
    (jfill, tfill), (jdec, tdec) = PAGED[arch]
    if arch == SSM:
        jcache = jssm.make_ssm_paged_cache(jcfg, 3, jnp.float32)
        tcache = tssm.make_ssm_paged_cache(tcfg, 3, torch.float32, "cpu")
    else:
        jcache = jhy.make_hybrid_paged_cache(jcfg, n, bs, 3, jnp.float32)
        tcache = thy.make_hybrid_paged_cache(tcfg, n, bs, 3, torch.float32,
                                             "cpu")
    # a recycled slot: prefill at start 0 must read it as zeros
    junk = jax.tree.map(lambda v: v + 1.0, jcache)
    jcache = junk
    tcache = bridge.paged_cache_from_numpy(jax.tree.map(np.asarray, junk))
    table = np.asarray([[4, 2, 6, 8, 9, 0, 0]], np.int32)
    plen = len(PROMPT)
    for start in range(0, plen, c):
        end = min(plen, start + c)
        chunk = PROMPT[start:end] + [0] * (c - (end - start))
        batch = {"tokens": np.asarray([chunk], np.int32), "block_table": table,
                 "state_slot": slot, "start": start, "prompt_len": end}
        kw = {} if arch == SSM else {"m_used": -(-end // bs)}
        jcache, jl = jfill(jcfg, jparams, jcache,
                           {k: jnp.asarray(v, jnp.int32)
                            for k, v in batch.items()}, **kw)
        tb = dict(batch, tokens=torch.from_numpy(batch["tokens"]),
                  block_table=torch.from_numpy(table))
        tcache, tl = tfill(tcfg, tparams, tcache, tb, **kw)
        real = end - start
        assert_close(tl[:, :real], np.asarray(jl)[:, :real], LOGITS_TOL,
                     f"chunk at {start}")
    tables = np.concatenate([table, np.zeros_like(table)])
    for i, tok in enumerate(FORCED):
        batch = {"token": np.asarray([[tok], [0]], np.int32),
                 "block_tables": tables,
                 "seq_lens": np.asarray([plen + i, 0], np.int32),
                 "state_slots": np.asarray([slot, 0], np.int32)}
        jcache, jl = jdec(jcfg, jparams, jcache,
                          {k: jnp.asarray(v) for k, v in batch.items()})
        tcache, tl = tdec(tcfg, tparams, tcache,
                          {k: torch.from_numpy(v) for k, v in batch.items()})
        assert_close(tl[:1], np.asarray(jl)[:1], LOGITS_TOL, f"decode {i}")
    jslab = jcache if arch == SSM else jcache["ssm"]
    tslab = tcache if arch == SSM else tcache["ssm"]
    axis = 1 if arch == SSM else 2
    for k in ("h", "conv"):
        assert_close(tslab[k].select(axis, slot),
                     np.take(np.asarray(jslab[k]), slot, axis=axis),
                     MODULE_TOL, f"slot state {k}")
