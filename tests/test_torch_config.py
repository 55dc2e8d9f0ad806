"""The port's config copy against the JAX package's: the model registry is
equal entry for entry, and the ServingConfig pool formulas give the same
numbers (exact integer equality) for the two models the serving slice
runs, pythia-14m and tiny-llama-1.1b."""

import dataclasses

import pytest
import torch

from mdi_llm_tpu import config as jcfg
from mdi_llm_tpu_torch import config as tcfg

torch.set_num_threads(1)

MODELS = ["pythia-14m", "tiny-llama-1.1b"]
SERVING = [
    dict(),
    dict(block_size=8, max_batch=2, prefill_chunk=32),
    dict(block_size=16, max_batch=8, token_budget=72, decode_chunk=4),
    dict(block_size=16, max_blocks=300, double_buffer=False),
    dict(block_size=32, max_batch=4, kv_dtype="float32"),
]


def test_registry_is_equal():
    assert tcfg.configs == jcfg.configs
    assert tcfg.name_to_config == jcfg.name_to_config


@pytest.mark.parametrize("name", MODELS + ["Llama-3-8B-Instruct", "NanoLlama"])
def test_from_name_fields_are_equal(name):
    assert (dataclasses.asdict(tcfg.Config.from_name(name))
            == dataclasses.asdict(jcfg.Config.from_name(name)))


@pytest.mark.parametrize("knobs", SERVING, ids=[str(i) for i in range(len(SERVING))])
@pytest.mark.parametrize("name", MODELS)
def test_serving_pool_formulas_agree(name, knobs):
    cfg_t, cfg_j = tcfg.Config.from_name(name), jcfg.Config.from_name(name)
    st, sj = tcfg.ServingConfig(**knobs), jcfg.ServingConfig(**knobs)
    assert st.resolved_token_budget() == sj.resolved_token_budget()
    assert st.reserve_headroom_blocks() == sj.reserve_headroom_blocks()
    for seq in (128, 2048, cfg_t.block_size):
        assert st.num_pool_blocks(seq) == sj.num_pool_blocks(seq)
    for dt in ("bfloat16", "float32"):
        assert st.block_bytes(cfg_t, dt) == sj.block_bytes(cfg_j, dt)
        assert st.pool_bytes(cfg_t, 2048, dt) == sj.pool_bytes(cfg_j, 2048, dt)


@pytest.mark.parametrize("name", ["bfloat16", "float32", "int8", "float8_e5m2", "f16"])
def test_dtype_bytes_agree(name):
    assert tcfg.dtype_bytes(name) == jcfg.dtype_bytes(name)


def test_tiny_llama_full_pool_size():
    """The issue's sizing of the serve run: 2048 tokens, 8 slots, 16-token
    blocks -> 1025 blocks of 22 layers x K,V x 4 groups x 64 x 2 bytes."""
    cfg = tcfg.Config.from_name("tiny-llama-1.1b")
    sc = tcfg.ServingConfig(block_size=16, max_batch=8)
    assert sc.num_pool_blocks(2048) == 1025
    assert sc.pool_bytes(cfg, 2048) == 1025 * 16 * 22 * 2 * 4 * 64 * 2
