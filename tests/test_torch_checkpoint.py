"""The port's checkpoint pipeline (`mdi_llm_tpu_torch/utils/checkpoint.py`)
against the JAX package's and against `transformers`, on the CPU.

- Tiny HF snapshots are written by `transformers` for every family the JAX
  checkpoint tests cover: llama (MHA and GQA), gpt2, gpt_neox, falcon (the
  7b layout and the new decoder), phi, gemma and mixtral.  Both packages'
  `convert_hf_checkpoint` run in float32, and the two param trees must be
  equal leaf by leaf (exactly).
- For every family, mixtral's experts included, the port's float32
  forward on the converted weights gives HF's logits within 2e-4.
- `convert_to_hf_state_dict` gives back every original tensor exactly,
  from float32 and from bfloat16 snapshots, and from sharded ones; the
  QKV interleave is an exact permutation at 1, G < H and H KV groups.
- The port's safetensors reader returns what `safetensors.safe_open`
  returns (bfloat16 included) and works with the library blocked; the
  library loads the port's writer output unchanged.
- `params.pt` + `model_config.yaml` round-trip; the load's cast leaves
  integer and "scale" leaves alone.
"""

import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdi_llm_tpu.utils import checkpoint as jck
from mdi_llm_tpu_torch.config import Config
from mdi_llm_tpu_torch.models import transformer
from mdi_llm_tpu_torch.utils import checkpoint as ck

torch.set_num_threads(1)
transformers = pytest.importorskip("transformers")

# family -> (HF config class, model class, config kwargs, seed)
FAMILIES = {
    "llama-mha": ("LlamaConfig", "LlamaForCausalLM", dict(
        vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=64,
        tie_word_embeddings=False), 0),
    "llama-gqa": ("LlamaConfig", "LlamaForCausalLM", dict(
        vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
        tie_word_embeddings=False), 0),
    "gpt2": ("GPT2Config", "GPT2LMHeadModel", dict(
        vocab_size=96, n_positions=64, n_embd=32, n_layer=2, n_head=4), 1),
    "neox": ("GPTNeoXConfig", "GPTNeoXForCausalLM", dict(
        vocab_size=96, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=128, rotary_pct=0.25, max_position_embeddings=64,
        use_parallel_residual=True), 2),
    "falcon": ("FalconConfig", "FalconForCausalLM", dict(
        vocab_size=96, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        new_decoder_architecture=False, multi_query=True, parallel_attn=True,
        bias=False, tie_word_embeddings=False), 4),
    "falcon-new": ("FalconConfig", "FalconForCausalLM", dict(
        vocab_size=96, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        num_kv_heads=2, new_decoder_architecture=True, bias=False,
        tie_word_embeddings=False), 8),
    "phi": ("PhiConfig", "PhiForCausalLM", dict(
        vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, partial_rotary_factor=0.5, max_position_embeddings=64,
        tie_word_embeddings=False), 5),
    "gemma": ("GemmaConfig", "GemmaForCausalLM", dict(
        vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=1, head_dim=8,
        max_position_embeddings=64), 6),
    "mixtral": ("MixtralConfig", "MixtralForCausalLM", dict(
        vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, num_local_experts=4,
        num_experts_per_tok=2, max_position_embeddings=64,
        tie_word_embeddings=False), 7),
}
TOKENS = [[1, 5, 9, 44, 63, 2, 17]]


def hf_model(family, dtype=torch.float32):
    cfg_cls, model_cls, kw, seed = FAMILIES[family]
    torch.manual_seed(seed)
    model = getattr(transformers, model_cls)(getattr(transformers, cfg_cls)(**kw)).eval()
    return model.to(dtype)


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    """family -> (HF model, snapshot dir written by save_pretrained)."""
    out = {}
    for family in FAMILIES:
        d = tmp_path_factory.mktemp(family)
        model = hf_model(family)
        model.save_pretrained(d / "hf")
        out[family] = (model, d)
    return out


def port_convert(src, out, dtype=torch.float32):
    return ck.load_checkpoint(ck.convert_hf_checkpoint(src, dtype=dtype, out_dir=out))


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("family", list(FAMILIES))
def test_converted_tree_equals_the_jax_packages(snapshots, family):
    _model, d = snapshots[family]
    jcfg, jparams = jck.load_checkpoint(
        jck.convert_hf_checkpoint(d / "hf", dtype=jnp.float32, out_dir=d / "jax"))
    cfg, params = port_convert(d / "hf", d / "port")
    # hf_config (the registry's download coordinates) defaults to {} in the
    # port's Config and to None in the JAX package's
    assert {**cfg.asdict(), "hf_config": None} == jcfg.asdict()
    want, got = dict(leaves(jparams)), dict(leaves(params))
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        assert t.dtype == torch.float32, name
        np.testing.assert_array_equal(t.numpy(), np.asarray(want[name]), err_msg=name)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_port_forward_on_converted_weights_matches_hf_logits(snapshots, family):
    model, d = snapshots[family]
    cfg, params = port_convert(d / "hf", d / "port-fwd")
    toks = torch.tensor(TOKENS)
    with torch.no_grad():
        ref = model(toks).logits
        got = transformer.forward(cfg, params, toks, torch.zeros(1, dtype=torch.long))
    V = model.config.vocab_size
    np.testing.assert_allclose(got[..., :V].numpy(), ref.numpy(), rtol=2e-4, atol=2e-4)


def _assert_state_dict_roundtrip(model, sd):
    """Every tensor the reverse map emits equals the original bit for bit,
    and nothing real is dropped (tied heads and buffers aside)."""
    ref = model.state_dict()
    for k, v in sd.items():
        assert v.dtype == ref[k].dtype, k
        assert torch.equal(v, ref[k]), k
    for k in set(ref) - set(sd):
        assert "rotary" in k or "masked_bias" in k or ".attn.bias" in k or (
            k == "lm_head.weight" and model.config.tie_word_embeddings), k


@pytest.mark.parametrize("family", list(FAMILIES))
def test_reverse_map_roundtrips_exactly(snapshots, family):
    model, d = snapshots[family]
    cfg, params = port_convert(d / "hf", d / "port-rev")
    _assert_state_dict_roundtrip(model, ck.convert_to_hf_state_dict(cfg, params))


@pytest.mark.parametrize("family", ["llama-gqa", "gpt2", "falcon-new", "phi", "gemma"])
def test_bf16_sharded_snapshot_roundtrips_bit_identically(tmp_path, family):
    """A bfloat16 model written by the port's own shard writer (with its
    index and config.json), converted in bfloat16 and mapped back, gives
    every original tensor bit for bit; the .bin route converts the same."""
    model = hf_model(family, torch.bfloat16)
    hf_dir = tmp_path / "shards"
    hf_dir.mkdir()
    model.config.to_json_file(hf_dir / "config.json")
    sd = {k: v for k, v in model.state_dict().items()
          if not (k == "lm_head.weight" and model.config.tie_word_embeddings)}
    paths = ck.write_hf_shards(sd, hf_dir, shard_bytes=8 << 10)
    assert len(paths) > 1
    index = json.loads((hf_dir / "model.safetensors.index.json").read_text())
    assert set(index["weight_map"]) == set(sd)
    cfg, params = port_convert(hf_dir, None, dtype=torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for _, t in leaves(params))
    _assert_state_dict_roundtrip(model, ck.convert_to_hf_state_dict(cfg, params))

    model.save_pretrained(tmp_path / "bin", safe_serialization=False)
    assert not list((tmp_path / "bin").glob("*.safetensors"))
    _cfg, from_bin = port_convert(tmp_path / "bin", None, dtype=torch.bfloat16)
    for (name, a), (_, b) in zip(leaves(params), leaves(from_bin)):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("G", [1, 2, 4], ids=["mqa", "gqa", "mha"])
def test_qkv_interleave_is_an_exact_permutation(G):
    """fuse_qkv equals the JAX package's on the same float32 inputs, and
    split_qkv inverts it bit for bit in bfloat16 (weights and biases)."""
    cfg = Config(name="t", n_layer=1, n_head=4, n_embd=32, n_query_groups=G,
                 block_size=16, vocab_size=64, padded_vocab_size=64)
    hs = cfg.head_size
    g = torch.Generator().manual_seed(G)
    q = torch.randn(4 * hs, 32, generator=g)
    k, v = (torch.randn(G * hs, 32, generator=g) for _ in range(2))
    fused = ck.fuse_qkv(cfg, q, k, v)
    want = jck.fuse_qkv(_jax_cfg(cfg), q.numpy(), k.numpy(), v.numpy())
    np.testing.assert_array_equal(fused.numpy(), want)
    for a, b in zip(ck.split_qkv(cfg, fused.bfloat16()), (q, k, v)):
        assert torch.equal(a, b.bfloat16())
    bias = ck._fuse_qkv_bias(cfg, q[:, 0], k[:, 0], v[:, 0])
    for a, b in zip(ck._split_qkv_bias(cfg, bias), (q[:, 0], k[:, 0], v[:, 0])):
        assert torch.equal(a, b)


def _jax_cfg(cfg):
    from mdi_llm_tpu.config import Config as JConfig

    return JConfig(**cfg.asdict())


def _tensors():
    g = torch.Generator().manual_seed(3)
    return {
        "bf16": torch.randn(3, 5, generator=g).bfloat16(),
        "f32": torch.randn(7, generator=g),
        "f16": torch.randn(2, 2, generator=g).half(),
        "i64": torch.arange(6, dtype=torch.int64).reshape(2, 3),
        "i8": torch.tensor([-128, 0, 127], dtype=torch.int8),
        "u8": torch.tensor([0, 255], dtype=torch.uint8),
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros(0, 4),
    }


def test_safetensors_reader_matches_the_library(tmp_path):
    from safetensors import safe_open
    from safetensors.torch import save_file

    src = _tensors()
    save_file(src, tmp_path / "lib.safetensors", metadata={"format": "pt"})
    got = ck.read_safetensors(tmp_path / "lib.safetensors")
    with safe_open(tmp_path / "lib.safetensors", framework="pt") as f:
        assert sorted(f.keys()) == sorted(got)
        for name in f.keys():
            want = f.get_tensor(name)
            assert got[name].dtype == want.dtype and got[name].shape == want.shape, name
            assert torch.equal(got[name], want), name


def test_safetensors_writer_output_loads_in_the_library(tmp_path):
    from safetensors import safe_open
    from safetensors.torch import load_file

    src = _tensors()
    ck.write_safetensors(src, tmp_path / "port.safetensors", metadata={"format": "pt"})
    got = load_file(tmp_path / "port.safetensors")
    assert sorted(got) == sorted(src)
    for name, t in src.items():
        assert got[name].dtype == t.dtype and torch.equal(got[name], t), name
    with safe_open(tmp_path / "port.safetensors", framework="pt") as f:
        assert f.metadata() == {"format": "pt"}


def test_safetensors_reader_needs_no_library(tmp_path, monkeypatch):
    src = _tensors()
    ck.write_safetensors(src, tmp_path / "x.safetensors")
    for name in [m for m in sys.modules if m.split(".")[0] == "safetensors"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "safetensors", None)  # import now fails
    with pytest.raises(ImportError):
        import safetensors  # noqa: F401
    got = ck.read_safetensors(tmp_path / "x.safetensors")
    for name, t in src.items():
        assert torch.equal(got[name], t), name


def test_save_load_roundtrip_and_quantization_aware_cast(tmp_path):
    cfg = Config.from_name("pythia-14m", n_layer=2)
    params = transformer.init_params(cfg, 0)
    params["extra"] = {"weight_q": torch.tensor([[-3, 4]], dtype=torch.int8),
                       "scale": torch.tensor([0.125, 0.3])}
    ck.save_checkpoint(params, cfg, tmp_path)
    assert ck.has_checkpoint(tmp_path)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["model_config.yaml", "params.pt"]
    cfg2, same = ck.load_checkpoint(tmp_path)
    assert cfg2 == cfg
    for (name, a), (_, b) in zip(leaves(params), leaves(same)):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    _, cast = ck.load_checkpoint(tmp_path, dtype=torch.bfloat16)
    assert cast["extra"]["weight_q"].dtype == torch.int8
    assert cast["extra"]["scale"].dtype == torch.float32
    assert torch.equal(cast["extra"]["scale"], params["extra"]["scale"])
    assert cast["blocks"]["attn"]["qkv"]["weight"].dtype == torch.bfloat16
    assert not ck.has_checkpoint(tmp_path / "nothing")


def test_conversion_refuses_a_directory_without_weights(tmp_path):
    with pytest.raises(FileNotFoundError, match="no \\*.safetensors or \\*.bin"):
        ck.convert_hf_checkpoint(tmp_path)
