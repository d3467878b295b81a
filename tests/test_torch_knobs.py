"""Reference knobs that change what runs, in the port: those it honours and
those it refuses.  ``REPRO_SERVE_MESH`` and ``REPRO_SERVE_TP`` ask for a
sharded serve engine: in a process without the ``torch.distributed`` group
such an engine needs, ``ServeEngine`` raises instead of serving on one
device (``tests/test_torch_serve_sharded.py`` serves on ranks);
``REPRO_ATTN_CHUNK`` sets the q chunk of the plain attention path, as in
the reference."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import multi_head_attention as jax_mha
from repro_torch.configs.base import get_config, reduced_config
from repro_torch.models import attention, build_model
from repro_torch.perf import perf
from repro_torch.serve.engine import ServeEngine

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def small():
    cfg = reduced_config(get_config("qwen3-0.6b"))
    return cfg, build_model(cfg, "cpu").init(0)


def _engine(small):
    cfg, params = small
    return ServeEngine(cfg, params, max_batch=2, max_len=32, block_size=4,
                       fault_injector=False)


@pytest.mark.parametrize("name,value", [("REPRO_SERVE_MESH", "2"),
                                        ("REPRO_SERVE_MESH", "auto"),
                                        ("REPRO_SERVE_TP", "1")])
def test_sharded_serve_knobs_raise(small, monkeypatch, name, value):
    """A mesh knob with no process group, or TP with no mesh, raises."""
    monkeypatch.delenv("REPRO_SERVE_MESH", raising=False)
    monkeypatch.setenv(name, value)
    with pytest.raises((RuntimeError, ValueError),
                       match="process group|needs a serve mesh"):
        _engine(small)


@pytest.mark.parametrize("env", [{}, {"REPRO_SERVE_MESH": "0"},
                                 {"REPRO_SERVE_MESH": ""},
                                 {"REPRO_SERVE_MESH": "off"},
                                 {"REPRO_SERVE_TP": "0"}])
def test_default_serve_knobs_build_an_engine(small, monkeypatch, env):
    monkeypatch.delenv("REPRO_SERVE_MESH", raising=False)
    monkeypatch.delenv("REPRO_SERVE_TP", raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert _engine(small).max_batch == 2


def test_attn_chunk_default_and_refusal(monkeypatch):
    monkeypatch.delenv("REPRO_ATTN_CHUNK", raising=False)
    assert perf().attn_chunk == 1024 == attention.Q_CHUNK
    monkeypatch.setenv("REPRO_ATTN_CHUNK", "0")
    with pytest.raises(ValueError, match="REPRO_ATTN_CHUNK"):
        perf()


@pytest.mark.parametrize("causal,off", [(True, 0), (True, 64), (False, 0)])
def test_attn_chunk_is_honoured(monkeypatch, causal, off):
    """REPRO_ATTN_CHUNK=64 on 256 queries (more than twice the chunk, which
    divides them) takes the chunked branch, four blocks where the default
    takes one, with the default's output and the reference's under the same
    setting."""
    rng = np.random.default_rng(0)
    q = (rng.normal(size=(2, 256, 4, 16)) * 0.3).astype(np.float32)
    k = (rng.normal(size=(2, 256 + off, 2, 16)) * 0.3).astype(np.float32)
    v = (rng.normal(size=(2, 256 + off, 2, 16)) * 0.3).astype(np.float32)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    blocks = []
    attend = attention._attend_block

    def spy(qb, *rest):
        blocks.append(qb.shape[2])
        return attend(qb, *rest)

    monkeypatch.setattr(attention, "_attend_block", spy)
    monkeypatch.delenv("REPRO_ATTN_CHUNK", raising=False)
    whole = attention.multi_head_attention(tq, tk, tv, causal=causal,
                                           q_offset=off)
    assert blocks == [256]
    monkeypatch.setenv("REPRO_ATTN_CHUNK", "64")
    blocks.clear()
    chunked = attention.multi_head_attention(tq, tk, tv, causal=causal,
                                             q_offset=off)
    assert blocks == [64] * 4
    # an explicit chunk is the caller's, whatever the knob says
    blocks.clear()
    attention.multi_head_attention(tq, tk, tv, causal=causal, q_offset=off,
                                   chunk=128)
    assert blocks == [256]
    torch.testing.assert_close(chunked, whole, rtol=0, atol=1e-6)
    want = jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal, q_offset=off)
    np.testing.assert_allclose(chunked.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("mode", [None, "gather", "dispatch"])
def test_moe_decode_knob_picks_the_decode_path(monkeypatch, mode):
    """REPRO_MOE_DECODE (gather by default, as in the reference) is read
    at each MoE layer of a decode step: the layers of reduced olmoe run
    the path it names and never the other; prefill dispatches either way."""
    from repro_torch.models import moe
    cfg = reduced_config(get_config("olmoe-1b-7b"))
    fns = build_model(cfg, "cpu")
    params = fns.init(0)
    if mode is None:
        monkeypatch.delenv("REPRO_MOE_DECODE", raising=False)
    else:
        monkeypatch.setenv("REPRO_MOE_DECODE", mode)
    assert perf().moe_decode == (mode or "gather")
    calls = {"gather": 0, "dispatch": 0, "prefill": 0}
    for name, fn in (("gather", "apply_moe_decode"),
                     ("dispatch", "apply_moe_decode_dispatch"),
                     ("prefill", "apply_moe")):
        real = getattr(moe, fn)
        monkeypatch.setattr(moe, fn, lambda *a, _n=name, _f=real: (
            calls.__setitem__(_n, calls[_n] + 1), _f(*a))[1])
    cache, _ = fns.prefill(params, {"tokens": torch.tensor([[3, 5, 7]])})
    big = fns.make_cache(1, 8)
    for k in ("k", "v"):
        big[k][:, :, :3] = cache[k]
    fns.decode_step(params, big, {"token": torch.tensor([[9]]),
                                  "cur_len": 3})
    n = cfg.n_layers
    want = {"gather": 0, "dispatch": 0, "prefill": n}
    want[mode or "gather"] = n
    assert calls == want


def test_moe_decode_bad_value_raises(monkeypatch):
    monkeypatch.setenv("REPRO_MOE_DECODE", "all_to_all")
    with pytest.raises(ValueError, match="REPRO_MOE_DECODE"):
        perf()


@pytest.mark.parametrize("name", ["REPRO_SEQ_PARALLEL", "REPRO_WEIGHT_AG"])
def test_mesh_training_knobs_default_off_and_refuse_bad_values(monkeypatch,
                                                              name):
    """The mesh-training knobs read 0 by default, as the reference's, and
    a value other than 0 or 1 raises."""
    from repro_torch.perf import perf
    field = {"REPRO_SEQ_PARALLEL": "seq_parallel",
             "REPRO_WEIGHT_AG": "weight_ag"}[name]
    monkeypatch.delenv(name, raising=False)
    assert getattr(perf(), field) is False
    monkeypatch.setenv(name, "1")
    assert getattr(perf(), field) is True
    monkeypatch.setenv(name, "yes")
    with pytest.raises(ValueError, match=name):
        perf()
