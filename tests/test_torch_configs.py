"""The port's config copy equals the JAX package's, arch by arch, at full
width and under ``reduced_config``."""
import dataclasses

import pytest
import torch

from repro.configs import base as jbase
from repro_torch.configs import base as tbase

torch.set_num_threads(1)


def test_same_registered_archs():
    assert tbase.list_archs() == jbase.list_archs()


@pytest.mark.parametrize("arch", jbase.list_archs())
def test_config_fields_equal(arch):
    jcfg, tcfg = jbase.get_config(arch), tbase.get_config(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tbase.reduced_config(tcfg)) == \
        dataclasses.asdict(jbase.reduced_config(jcfg))
    assert tcfg.param_count() == jcfg.param_count()


def test_torch_dtype():
    cfg = tbase.get_config("qwen3-0.6b")
    assert tbase.torch_dtype(cfg) == torch.bfloat16
    assert tbase.torch_dtype(tbase.reduced_config(cfg)) == torch.float32
