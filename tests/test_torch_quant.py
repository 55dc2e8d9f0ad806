"""The port's weight quantization (`mdi_llm_tpu_torch/ops/quant.py`) against
the JAX package's (`mdi_llm_tpu/ops/quant.py`), on the CPU.

- the quantizers' int8 bytes, packed int4 nibbles and float32 scales are
  identical for the same float32 or bfloat16 input, all-zero rows and
  odd group sizes included; `quantize_params` trees have the same keys,
  shapes, dtypes and bytes;
- `quantized_einsum` (w8, w8a8, w4) within 1e-5 relative of the JAX one for
  the linear and head specs; w8a8's int8 contraction adds its operations
  to the kernels' tally, so a step report counts the bf16 step's flops;
- `Generator(quantize=...)`: float32 logits within 1e-4 of the JAX
  Generator's in the same mode, identical greedy streams from `generate`
  and from `serve`; the cache dtype follows the float weights, never a
  scale (the `param_dtype` repair);
- `prepare_model --quantize` writes the JAX quantizer's tree, which the
  CLIs load with `--quantize none`; sample, serve and chat take
  `--quantize`.
"""

import io
import json
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mdi_llm_tpu.config import Config as JConfig
from mdi_llm_tpu.generation import Generator as JGenerator
from mdi_llm_tpu.models import transformer as jtf
from mdi_llm_tpu.ops import quant as jq
from mdi_llm_tpu_torch import kernels
from mdi_llm_tpu_torch.cli import chat as chat_cli
from mdi_llm_tpu_torch.cli import prepare_model
from mdi_llm_tpu_torch.cli import sample as sample_cli
from mdi_llm_tpu_torch.cli import serve as serve_cli
from mdi_llm_tpu_torch.config import Config as TConfig
from mdi_llm_tpu_torch.convert import params_from_numpy
from mdi_llm_tpu_torch.generation import Generator as TGenerator
from mdi_llm_tpu_torch.models import transformer as ttf
from mdi_llm_tpu_torch.ops import quant as tq
from mdi_llm_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(1)

MODES = ("int8", "w8a8", "int4")

TINY = dict(
    name="test-tiny", block_size=128, vocab_size=128, padded_vocab_size=128,
    n_layer=3, n_head=4, n_embd=32, n_query_groups=2, rotary_percentage=1.0,
    parallel_residual=False, bias=False, norm_class_name="RMSNorm",
    mlp_class_name="LLaMAMLP", intermediate_size=64,
)
# GPT-NeoX form: biases, a LayerNorm with bias, the fc/proj MLP, a tied head
NEOX = dict(
    name="test-neox", block_size=128, vocab_size=96, padded_vocab_size=96,
    n_layer=2, n_head=4, n_embd=32, rotary_percentage=0.25, parallel_residual=True,
    bias=True, norm_class_name="LayerNorm", mlp_class_name="GptNeoxMLP",
    intermediate_size=64, tie_embeddings=True,
)


def _bytes(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _same(t: torch.Tensor, a) -> bool:
    a = np.asarray(a)
    return (tuple(t.shape) == a.shape and str(t.dtype).replace("torch.", "") == str(a.dtype)
            and np.array_equal(_bytes(t.numpy()), _bytes(a)))


# ---------------------------------------------------------------------------
# the quantizers
# ---------------------------------------------------------------------------


def _weights(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(shape) * rng.uniform(0.01, 3.0)).astype(np.float32)
    w[..., 0, :] = 0.0  # an all-zero row: scale 0, divided by 1
    w.reshape(-1)[1] = 0.5 * np.float32(w.reshape(-1)[2])  # exact halves occur too
    if dtype == "bf16":
        wj = w.astype(ml_dtypes.bfloat16)
        return wj, torch.from_numpy(wj.astype(np.float32)).to(torch.bfloat16)
    return w, torch.from_numpy(w.copy())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(3, 24, 96), (5, 6), (2, 7, 128), (4, 256), (3, 5, 10)],
                         ids=["stacked", "narrow", "group128", "wide", "odd-group"])
def test_quantizer_bytes_and_scales_equal_jax(shape, dtype):
    wj, wt = _weights(shape, dtype, seed=shape[-1])
    q, s = tq.quantize_tensor(wt)
    jq_, js = jq.quantize_tensor(wj)
    assert _same(q, jq_) and _same(s, js)
    assert np.array_equal(tq.dequantize_tensor(q, s).numpy(), jq.dequantize_tensor(jq_, js))
    for group in (128, 4, 2):
        assert tq.w4_group_size(shape[-1], group) == jq.w4_group_size(shape[-1], group)
        q4, s4 = tq.quantize_tensor4(wt, group)
        jq4, js4 = jq.quantize_tensor4(wj, group)
        assert _same(q4, jq4) and _same(s4, js4)
        assert np.array_equal(tq.unpack_w4(q4, s4, torch.float32).numpy(),
                              np.asarray(jq.unpack_w4(jnp.asarray(jq4), jnp.asarray(js4),
                                                      jnp.float32)))


def test_int4_needs_an_even_input_dim_and_modes_are_checked():
    with pytest.raises(ValueError, match="even input dim"):
        tq.quantize_tensor4(torch.ones(3, 5))
    with pytest.raises(ValueError, match="unknown quantization mode"):
        tq.quantize_params({"a": {"weight": torch.ones(2, 2)}}, mode="w2")
    assert tq.FLAG_TO_MODE == jq.FLAG_TO_MODE and tq.SKIP_KEYS == jq.SKIP_KEYS


@pytest.fixture(scope="module", params=["llama", "neox"])
def trees(request):
    """(JAX config, port config, the JAX params, the port's copy)."""
    kw = TINY if request.param == "llama" else NEOX
    jc, tc = JConfig(**kw), TConfig(**kw)
    jp = jtf.init_params(jc, jax.random.PRNGKey(0))
    return jc, tc, jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k in sorted(tree) for k2, v2 in _flat(tree[k], f"{prefix}/{k}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("mode", ["w8", "w8a8", "w4"])
def test_quantize_params_trees_equal_jax(trees, mode):
    _jc, tc, jp, tp = trees
    want = _flat(jq.quantize_params(jax.tree_util.tree_map(np.asarray, jp), mode=mode))
    got = _flat(tq.quantize_params(tp, mode=mode))
    assert list(got) == list(want)
    for k in want:
        assert _same(got[k], want[k]), k
    assert tq.tree_has_quantized(tq.quantize_params(tp, mode=mode))
    assert not tq.tree_has_quantized(tp)
    assert ("/lm_head/scale" in got) == (not tc.tie_embeddings)  # an untied head is quantized
    assert "/wte/weight" in got and "/ln_f/weight" in got


def test_init_quantized_params_has_the_jax_layout():
    cfg = TConfig(**TINY)
    jc = JConfig(**TINY)
    for mode in ("w8", "w8a8", "w4"):
        got = _flat(tq.init_quantized_params(cfg, seed=0, mode=mode, dtype=torch.float32))
        want = _flat(jq.init_quantized_params(jc, seed=0, mode=mode, dtype=np.float32))
        assert list(got) == list(want)
        for k in want:
            assert tuple(got[k].shape) == np.asarray(want[k]).shape, k
    # MoE: a quantized (L, E, D) gate and expert stacks with leading (L, E)
    moe = {**TINY, "mlp_class_name": "LLaMAMoE", "n_expert": 4, "n_expert_per_token": 2}
    for mode in ("w8", "w8a8", "w4"):
        got = _flat(tq.init_quantized_params(TConfig(**moe), seed=0, mode=mode,
                                             dtype=torch.float32))
        want = _flat(jq.init_quantized_params(JConfig(**moe), seed=0, mode=mode,
                                              dtype=np.float32))
        assert list(got) == list(want)
        for k in want:
            assert tuple(got[k].shape) == np.asarray(want[k]).shape, k
        assert got["/blocks/mlp/experts/fc_1/scale"].shape[:2] == (3, 4)


# ---------------------------------------------------------------------------
# the quantized contractions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["w8", "w8a8", "w4"])
@pytest.mark.parametrize("spec,xshape,wshape", [
    ("...i,oi->...o", (2, 5, 64), (48, 64)), ("...i,oi->...o", (3, 96), (32, 96)),
    ("...d,vd->...v", (1, 7, 64), (40, 64)),
], ids=["linear", "linear-2d", "head"])
def test_quantized_einsum_within_1e5_of_jax(mode, spec, xshape, wshape):
    rng = np.random.default_rng(7)
    x = rng.standard_normal(xshape).astype(np.float32)
    w = (rng.standard_normal(wshape) * 0.1).astype(np.float32)
    jp = jq.quantize_params({"l": {"weight": w}}, mode=mode)["l"]
    tp = tq.quantize_params({"l": {"weight": torch.from_numpy(w)}}, mode=mode)["l"]
    want = np.asarray(jq.quantized_einsum(spec, jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, jp)))
    got = tq.quantized_einsum(spec, torch.from_numpy(x), tp).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_w8a8_contraction_is_tallied_as_the_bf16_products():
    """`FlopCounterMode` does not count `torch._int_mm`: the w8a8 route adds
    2·M·N·K to the kernels' tally, so a counted forward of a quantized
    model equals the float one (row padding not counted)."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = TConfig(**TINY)
    params = ttf.init_params(cfg, 0)
    toks, pos = torch.randint(1, 100, (2, 5)), torch.zeros(2, dtype=torch.long)
    counts = {}
    for mode in (None, "w8", "w8a8"):
        p = params if mode is None else tq.quantize_params(params, mode=mode)
        with FlopCounterMode(display=False) as fc, kernels.flop_tally() as tally:
            ttf.forward(cfg, p, toks, pos)
        counts[mode] = fc.get_total_flops() + tally.flops
        if mode == "w8a8":
            assert tally.flops > 0 and fc.get_total_flops() < counts[None]
    assert counts["w8"] == counts["w8a8"] == counts[None]


# ---------------------------------------------------------------------------
# Generator, generate and serve
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def llama():
    jc, tc = JConfig(**TINY), TConfig(**TINY)
    jp = jtf.init_params(jc, jax.random.PRNGKey(0))
    return jc, tc, jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, TINY["vocab_size"], int(n)).tolist() for n in lens]


@pytest.mark.parametrize("mode", MODES)
def test_quantized_generator_logits_and_streams_equal_jax(llama, mode):
    jc, tc, jp, tp = llama
    jg = JGenerator(jc, jp, cache_dtype=jnp.float32, quantize=mode, use_flash=False)
    tg = TGenerator(tc, tp, cache_dtype=torch.float32, device="cpu", quantize=mode)
    assert tg.quantized and tq.tree_has_quantized(tg.params)
    toks = np.random.default_rng(1).integers(1, 128, (2, 9))
    want, _kv = jtf.forward(jc, jg.params, jnp.asarray(toks), jnp.zeros((2,), jnp.int32))
    want = np.asarray(want)
    got = ttf.forward(tc, tg.params, torch.from_numpy(toks), torch.zeros(2, dtype=torch.long))
    assert np.abs(got.numpy() - want).max() <= 1e-4
    prompts = _prompts(3, (5, 9, 17))
    jouts, _ = jg.generate(prompts, 8, temperature=0.0, chunk_size=4)
    touts, _ = tg.generate(prompts, 8, temperature=0.0, chunk_size=4)
    assert touts == jouts


@pytest.mark.parametrize("mode", MODES)
def test_quantized_serve_gives_the_jax_engines_tokens(llama, mode):
    jc, tc, jp, tp = llama
    jg = JGenerator(jc, jp, cache_dtype=jnp.float32, quantize=mode)
    tg = TGenerator(tc, tp, cache_dtype=torch.float32, device="cpu", quantize=mode)
    trace = [(f"r{i}", p, n) for i, (p, n) in enumerate(zip(_prompts(5, (3, 9, 17, 5)), (8, 6, 10, 7)))]
    out = []
    for gen in (jg, tg):
        engine = gen.serve(block_size=4, max_batch=3, prefill_chunk=8, decode_chunk=4)
        for rid, p, n in trace:
            engine.add_request(rid, p, n)
        out.append(engine.run())
    (jres, jstats), (tres, tstats) = out
    assert tres == jres
    assert tstats.host_syncs == jstats.host_syncs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cache_dtype_follows_the_float_weights_never_a_scale(llama, dtype):
    """A quantized tree's f32 "scale" leaves come first in sorted-key order;
    `param_dtype` skips them, so a bf16 model gets bf16 caches and pools."""
    _jc, tc, _jp, tp = llama
    params = ttf.cast_params(tp, dtype)
    quantized = tq.quantize_params(params, mode="w8")
    assert ttf.param_dtype(quantized) == dtype
    assert quantized["blocks"]["attn"]["qkv"]["scale"].dtype == torch.float32
    assert ttf.cast_params(quantized, dtype)["blocks"]["attn"]["qkv"]["weight_q"].dtype == torch.int8
    for q in ("int8", "int4"):
        gen = TGenerator(tc, params, device="cpu", quantize=q)
        assert gen.cache_dtype == dtype
        assert gen.serve(block_size=4, max_batch=2)._kv["k"].dtype == dtype
    pre = TGenerator(tc, quantized, device="cpu")  # pre-quantized, quantize=None
    assert pre.quantized and pre.cache_dtype == dtype
    assert not TGenerator(tc, params, device="cpu", quantize="none").quantized


def test_generator_refuses_unknown_quantize_modes(llama):
    _jc, tc, _jp, tp = llama
    with pytest.raises(ValueError, match="unknown quantize mode"):
        TGenerator(tc, tp, device="cpu", quantize="int2")


# ---------------------------------------------------------------------------
# prepare_model --quantize and the CLIs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def checkpoint(llama, tmp_path_factory):
    """The llama weights as a float32 checkpoint of the port, with a
    word-level tokenizer (ids "w0" ... "w127") beside them."""
    _jc, tc, _jp, tp = llama
    d = tmp_path_factory.mktemp("quant") / "tiny"
    tck.save_checkpoint(tp, tc, d)
    tokenizers = pytest.importorskip("tokenizers")
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace

    vocab = {"<s>": 0, "</s>": 1, **{f"w{i}": i for i in range(2, 128)}}
    tok = tokenizers.Tokenizer(WordLevel(vocab, unk_token="</s>"))
    tok.pre_tokenizer = Whitespace()
    tok.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(
        json.dumps({"bos_token": "<s>", "eos_token": "</s>", "add_bos_token": True}))
    return d


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_prepare_model_quantize_writes_the_jax_quantizers_tree(llama, checkpoint, mode):
    _jc, tc, jp, _tp = llama
    prepare_model.main([str(checkpoint), "--quantize", mode])
    sibling = checkpoint.parent / f"{checkpoint.name}-{mode}"
    assert {"params.pt", "model_config.yaml", "tokenizer.json", "tokenizer_config.json"} <= {
        p.name for p in sibling.iterdir()}
    cfg, got = tck.load_checkpoint(sibling, dtype=torch.bfloat16)
    assert cfg.name == tc.name
    want = _flat(jq.quantize_params(jax.tree_util.tree_map(np.asarray, jp),
                                    mode=jq.FLAG_TO_MODE[mode]))
    got = _flat(got)
    assert list(got) == list(want)
    for k, v in want.items():
        if k.endswith(("weight_q", "weight_q4", "scale")):
            assert _same(got[k], v), k  # int8 and f32 scales kept through a bf16 load
        else:
            assert got[k].dtype == torch.bfloat16


def _serve_results(argv):
    _trace, results, _stats, engine, _tok = serve_cli.serve(serve_cli.build_parser().parse_args(
        ["--device", "cpu", "--dtype", "float32", "--synthetic", "3", "--max-batch", "2",
         "--n-tokens", "6", "--sequence-length", "64", "--block-size", "8",
         "--no-device-obs", *argv]))
    return results, engine


def test_quantized_sibling_loads_with_quantize_none_and_serves_the_same(llama, checkpoint):
    jc, _tc, jp, _tp = llama
    prepare_model.main([str(checkpoint), "--quantize", "int8"])
    sibling = checkpoint.parent / f"{checkpoint.name}-int8"
    got, engine = _serve_results(["--ckpt", str(sibling)])
    assert engine.gen.quantized and engine.gen.cache_dtype == torch.float32
    want, flagged = _serve_results(["--ckpt", str(checkpoint), "--quantize", "int8"])
    assert flagged.gen.quantized and got == want
    # and the JAX engine's tokens over the same quantized weights
    jengine = JGenerator(jc, jp, cache_dtype=jnp.float32, quantize="int8",
                         max_seq_length=64).serve(block_size=8, max_batch=2)
    trace = serve_cli.synthetic_trace(3, jc.vocab_size, 64, 6)
    for rid, p, n in trace:
        jengine.add_request(rid, p, n)
    assert jengine.run()[0] == got


@pytest.mark.parametrize("mode", MODES)
def test_sample_cli_quantize_gives_the_jax_generators_tokens(llama, checkpoint, mode, capsys):
    jc, _tc, jp, _tp = llama
    outs = sample_cli.main(["--device", "cpu", "--ckpt", str(checkpoint), "--dtype", "float32",
                            "--sequence-length", "64", "--greedy", "--n-tokens", "6",
                            "--prompt", "w5 w17 w33", "--quantize", mode])
    ids = outs[0][: len(outs[0]) - 6]
    want, _ = JGenerator(jc, jp, max_seq_length=64, quantize=mode).generate(
        [ids], 6, temperature=0.0)
    assert outs == want


def test_chat_cli_quantize_gives_the_jax_sessions_replies(llama, checkpoint, monkeypatch):
    jc, _tc, jp, _tp = llama
    monkeypatch.setattr(sys, "stdin", io.StringIO("w5 w6 w7\nw9 w10\n"))
    session = chat_cli.main(["--device", "cpu", "--ckpt", str(checkpoint), "--dtype", "float32",
                             "--sequence-length", "64", "--temperature", "0", "--n-tokens", "6",
                             "--quantize", "w8a8"])
    from mdi_llm_tpu_torch.utils.prompts import style_for_model
    from mdi_llm_tpu_torch.utils.tokenizer import Tokenizer

    tok, style = Tokenizer(checkpoint), style_for_model(jc.name)
    jsess = JGenerator(jc, jp, max_seq_length=64, quantize="w8a8").chat_session()
    for turn in ("w5 w6 w7", "w9 w10"):
        list(jsess.send(tok.encode(style.apply(turn)).tolist(), 6, temperature=0.0,
                        stop_sequences=style.stop_tokens(tok)))
    assert session.history == jsess.history


def test_serve_cli_quantize_counts_the_stored_weight_bytes():
    """The roofline's weight bytes are the stored widths: int8 and w8a8
    below bf16, int4 below int8."""
    from mdi_llm_tpu_torch.obs.roofline import param_bytes

    sizes = {}
    for mode in ("none",) + MODES:
        args = serve_cli.build_parser().parse_args(
            ["--device", "cpu", "--model", "pythia-14m", "--synthetic", "2", "--max-batch", "2",
             "--n-tokens", "4", "--sequence-length", "64", "--block-size", "8",
             "--quantize", mode])
        _trace, _results, stats, engine, _tok = serve_cli.serve(args)
        assert stats.requests_finished == 2 and engine.gen.quantized == (mode != "none")
        sizes[mode] = param_bytes(engine.gen.params)
    assert sizes["int4"] < sizes["int8"] == sizes["w8a8"] < sizes["none"]
