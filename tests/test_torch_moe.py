"""The port's mixture-of-experts layers against the JAX package's, on the
CPU, in float32.

JAX `init_params` weights of `tests/test_model.py`'s tiny MoE config (4
experts, top 2) and of the same config with 8 experts go through
`params_from_numpy` into the port:

- `moe_forward` within 1e-5 and its load-balancing aux within 1e-6; the
  forward's logits within 1e-4 and its layer-summed aux within 1e-6, with
  and without remat (the aux comes back through the checkpointed block);
- greedy `Generator.generate` streams and `ServingEngine` streams
  identical to the JAX package's, over float32, int8 and e4m3 pools,
  under chunked decode and with n-gram speculative serving;
- quantized (w8, w8a8, int4) MoE layers within 1e-5 (relative to the
  largest output) of the JAX package's, the w8a8 expert contractions
  equal to the JAX package's int32 products, `quantize_params` giving the
  JAX package's tree, int4's row blocks changing no value;
- `cross_entropy_loss` with the aux within 1e-6 (relative) of the JAX
  package's, and its gradient with respect to the router;
- `init_params` and `init_quantized_params` in the JAX package's layout;
- the CLIs' `--override KEY=VALUE` on a tiny Mixtral: the serve CLI gives
  the JAX engine's streams over the same weights, the train CLI trains it
  (with an MoE capacity factor on an ep mesh too), bad overrides are
  refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdi_llm_tpu import training as jtr
from mdi_llm_tpu.config import Config as JConfig
from mdi_llm_tpu.generation import Generator as JGenerator
from mdi_llm_tpu.models import transformer as jtf
from mdi_llm_tpu.ops import quant as jq
from mdi_llm_tpu_torch import training as ttr
from mdi_llm_tpu_torch.config import Config as TConfig
from mdi_llm_tpu_torch.convert import params_from_numpy
from mdi_llm_tpu_torch.generation import Generator as TGenerator
from mdi_llm_tpu_torch.models import transformer as ttf
from mdi_llm_tpu_torch.ops import quant as tq
from tests.test_model import CONFIG_VARIANTS, tiny_config

torch.set_num_threads(1)
VARIANTS = {"E4": CONFIG_VARIANTS["moe"], "E8": dict(CONFIG_VARIANTS["moe"], n_expert=8)}
QMODES = ("w8", "w8a8", "w4")
GREEDY = dict(temperature=0.0)


class Pair:
    def __init__(self, name, **kw):
        self.jc = tiny_config(**VARIANTS[name], **kw)
        self.tc = TConfig(**self.jc.asdict())
        self.jp = jtf.init_params(self.jc, jax.random.PRNGKey(0))
        self.tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, self.jp))


@pytest.fixture(scope="module", params=list(VARIANTS))
def pair(request):
    return Pair(request.param)


@pytest.fixture(scope="module")
def e4():
    return Pair("E4", block_size=128)


def layer(tree, i=0):
    return jax.tree_util.tree_map(lambda a: a[i], tree)


def tlayer(tree, i=0):
    return ttf.tree_map(lambda a: a[i], tree)


def tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, shape).astype(np.int32)


def test_moe_forward_and_aux_match_jax(pair):
    x = np.random.default_rng(1).standard_normal((2, 7, pair.jc.n_embd)).astype(np.float32)
    for i in range(pair.jc.n_layer):
        want, waux = jtf.moe_forward(pair.jc, layer(pair.jp["blocks"]["mlp"], i),
                                     jnp.asarray(x), with_aux=True)
        got, gaux = ttf.moe_forward(pair.tc, tlayer(pair.tp["blocks"]["mlp"], i),
                                    torch.from_numpy(x), with_aux=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
        np.testing.assert_allclose(gaux.item(), float(waux), atol=1e-6, rtol=0)
        assert gaux.dtype == torch.float32 and float(gaux) >= 1.0 - 1e-6
        plain = ttf.moe_forward(pair.tc, tlayer(pair.tp["blocks"]["mlp"], i), torch.from_numpy(x))
        assert torch.equal(plain, got)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_forward_logits_and_layer_summed_aux_match_jax(pair, remat):
    toks = tokens(pair.jc, (2, 12), 2)
    zero = np.zeros(2, np.int32)
    want, _kv = jtf.forward(pair.jc, pair.jp, jnp.asarray(toks), jnp.asarray(zero))
    got = ttf.forward(pair.tc, pair.tp, torch.from_numpy(toks), torch.from_numpy(zero))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    jl, _kv, jaux = jtf.forward(pair.jc, pair.jp, jnp.asarray(toks), jnp.asarray(zero),
                                collect_moe_aux=True)
    tp = ttf.tree_map(lambda a: a.clone().requires_grad_(True), pair.tp)
    tl, taux = ttf.forward(pair.tc, tp, torch.from_numpy(toks), torch.from_numpy(zero),
                           remat=remat, collect_moe_aux=True)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    np.testing.assert_allclose(taux.item(), float(jaux), atol=1e-6 * pair.jc.n_layer, rtol=0)
    # the aux reaches the router through the mean probabilities
    (g,) = torch.autograd.grad(taux, [tp["blocks"]["mlp"]["gate"]["weight"]])
    assert g.abs().sum() > 0


def test_collect_moe_aux_is_refused_with_a_cache_and_on_dense_configs(e4):
    kv = ttf.init_kv_cache(e4.tc, 1, 16, dtype=torch.float32)
    toks, zero = torch.ones(1, 4, dtype=torch.long), torch.zeros(1, dtype=torch.long)
    with pytest.raises(ValueError, match="training path"):
        ttf.forward(e4.tc, e4.tp, toks, zero, kv, collect_moe_aux=True)
    dense = TConfig(**tiny_config().asdict())
    with pytest.raises(ValueError, match="requires an MoE config"):
        ttf.forward(dense, ttf.init_params(dense, 0), toks, zero, collect_moe_aux=True)


def _prompts(cfg, seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, int(n)).tolist() for n in lens]


def test_generate_streams_equal_jax(e4):
    jg = JGenerator(e4.jc, e4.jp, cache_dtype=jnp.float32, use_flash=False)
    tg = TGenerator(e4.tc, e4.tp, cache_dtype=torch.float32, device="cpu")
    prompts = _prompts(e4.jc, 3, (5, 9, 17))
    jouts, _ = jg.generate(prompts, 10, chunk_size=4, **GREEDY)
    touts, _ = tg.generate(prompts, 10, chunk_size=4, **GREEDY)
    assert touts == jouts


@pytest.mark.parametrize("knobs", [
    dict(decode_chunk=1), dict(decode_chunk=1, kv_dtype="int8"),
    dict(decode_chunk=4, double_buffer=True), dict(decode_chunk=4, cache="float8"),
    dict(decode_chunk=4, spec_k=4),
], ids=["f32-pool", "int8-pool", "chunked-decode", "e4m3-pool", "ngram-spec"])
def test_serve_streams_equal_jax(e4, knobs):
    knobs = dict(knobs)
    f8 = knobs.pop("cache", None) == "float8"
    jg = JGenerator(e4.jc, e4.jp, cache_dtype=jnp.float8_e4m3fn if f8 else jnp.float32)
    tg = TGenerator(e4.tc, e4.tp, cache_dtype=torch.float8_e4m3fn if f8 else torch.float32,
                    device="cpu")
    prompts, news = _prompts(e4.jc, 5, (3, 9, 17, 5, 33)), (8, 12, 6, 10, 7)
    if "spec_k" in knobs:  # long greedy runs of a tiny random model cycle: the lookup drafts
        prompts, news = _prompts(e4.jc, 6, (5, 5, 5)), (40, 35, 30)
    trace = [(f"r{i}", p, m) for i, (p, m) in enumerate(zip(prompts, news))]
    out = []
    for gen in (jg, tg):
        engine = gen.serve(block_size=4, max_batch=3, prefill_chunk=8, **knobs)
        for rid, p, m in trace:
            engine.add_request(rid, p, m)
        out.append(engine.run())
    (jres, jstats), (tres, tstats) = out
    assert tres == jres
    assert tstats.host_syncs == jstats.host_syncs
    assert tstats.tokens_generated == jstats.tokens_generated
    if "spec_k" in knobs:
        assert tstats.spec_drafted == jstats.spec_drafted > 0


# ---------------------------------------------------------------------------
# quantized experts
# ---------------------------------------------------------------------------


def _quantized(pair, mode):
    jp = jq.quantize_params(jax.tree_util.tree_map(np.asarray, pair.jp), mode=mode)
    return jp, tq.quantize_params(pair.tp, mode=mode)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree.numpy() if isinstance(tree, torch.Tensor) else tree)}


@pytest.mark.parametrize("mode", QMODES)
def test_quantize_params_gives_the_jax_moe_tree(pair, mode):
    jp, tp = _quantized(pair, mode)
    want, got = _flat(jp), _flat(tp)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert "/blocks/mlp/gate/scale" in got and "/blocks/mlp/experts/proj/scale" in got


@pytest.mark.parametrize("mode", QMODES)
def test_quantized_moe_layer_within_1e5_of_jax(pair, mode):
    jp, tp = _quantized(pair, mode)
    x = np.random.default_rng(4).standard_normal((2, 9, pair.jc.n_embd)).astype(np.float32)
    for i in range(pair.jc.n_layer):
        jl = jax.tree_util.tree_map(jnp.asarray, layer(jp["blocks"]["mlp"], i))
        want, waux = jtf.moe_forward(pair.jc, jl, jnp.asarray(x), with_aux=True)
        got, gaux = ttf.moe_forward(pair.tc, tlayer(tp["blocks"]["mlp"], i),
                                    torch.from_numpy(x), with_aux=True)
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
        np.testing.assert_allclose(gaux.item(), float(waux), atol=1e-6, rtol=0)
    toks = tokens(pair.jc, (2, 9), 5)
    zero = np.zeros(2, np.int32)
    want, _kv = jtf.forward(pair.jc, jax.tree_util.tree_map(jnp.asarray, jp),
                            jnp.asarray(toks), jnp.asarray(zero))
    got = ttf.forward(pair.tc, tp, torch.from_numpy(toks), torch.from_numpy(zero))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("spec", [tq.EXPERT_UP, tq.EXPERT_DOWN], ids=["up", "down"])
def test_w8a8_expert_contractions_equal_the_jax_int32_products(pair, spec):
    E, I, D = pair.jc.n_expert, pair.jc.intermediate_size, pair.jc.n_embd
    rng = np.random.default_rng(6)
    wshape, xshape = ((E, I, D), (3, 5, D)) if spec == tq.EXPERT_UP else ((E, D, I), (3, 5, E, I))
    xq = rng.integers(-127, 128, xshape).astype(np.int8)
    wq = rng.integers(-127, 128, wshape).astype(np.int8)
    want = np.asarray(jnp.einsum(spec, jnp.asarray(xq), jnp.asarray(wq),
                                 preferred_element_type=jnp.int32))
    got = tq.w8a8_int(spec, torch.from_numpy(xq), torch.from_numpy(wq)).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape
    assert np.array_equal(got, want)
    # and through quantized_einsum, scales and all
    w = (rng.standard_normal(wshape) * 0.1).astype(np.float32)
    x = rng.standard_normal(xshape).astype(np.float32)
    jw = jq.quantize_params({"l": {"weight": w}}, mode="w8a8")["l"]
    tw = tq.quantize_params({"l": {"weight": torch.from_numpy(w)}}, mode="w8a8")["l"]
    want = np.asarray(jq.quantized_einsum(spec, jnp.asarray(x),
                                          jax.tree_util.tree_map(jnp.asarray, jw)))
    got = tq.quantized_einsum(spec, torch.from_numpy(x), tw).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("spec", [tq.EXPERT_UP, tq.EXPERT_DOWN], ids=["up", "down"])
def test_int4_row_blocks_change_no_value(pair, spec, monkeypatch):
    E, I, D = pair.jc.n_expert, pair.jc.intermediate_size, pair.jc.n_embd
    rng = np.random.default_rng(8)
    wshape, xshape = ((E, I, D), (4, 6, D)) if spec == tq.EXPERT_UP else ((E, D, I), (4, 6, E, I))
    p = tq.quantize_params({"l": {"weight": torch.from_numpy(
        (rng.standard_normal(wshape) * 0.1).astype(np.float32))}}, mode="w4")["l"]
    x = torch.from_numpy(rng.standard_normal(xshape).astype(np.float32))
    whole = tq.quantized_einsum(spec, x, p)
    n_out = (E * I if spec == tq.EXPERT_UP else E * D) * p["scale"].shape[-1]
    monkeypatch.setattr(tq, "W4_Z_BYTES", 5 * n_out * 4)  # 5 rows a block of 24
    blocks = tq.quantized_einsum(spec, x, p)
    assert blocks.shape == whole.shape
    np.testing.assert_allclose(blocks.numpy(), whole.numpy(), atol=1e-6, rtol=0)


def test_param_layouts_equal_the_jax_packages(pair):
    mine = _flat(ttf.init_params(pair.tc, seed=0))
    want = _flat(jax.tree_util.tree_map(np.asarray, pair.jp))
    assert list(mine) == list(want)
    for k in want:
        assert mine[k].shape == want[k].shape, k
    for mode in QMODES:
        got = _flat(tq.init_quantized_params(pair.tc, seed=0, mode=mode, dtype=torch.float32))
        jwant = _flat(jq.init_quantized_params(JConfig(**pair.jc.asdict()), seed=0, mode=mode,
                                               dtype=np.float32))
        assert list(got) == list(jwant)
        for k in jwant:
            assert got[k].shape == jwant[k].shape and got[k].dtype == jwant[k].dtype, (mode, k)


def test_init_params_draws_expert_stacks_per_matrix(e4):
    """Each (layer, expert) matrix is its own draw at the init's std (the
    output projection's scaled by 1/sqrt(2L)), so no float32 copy of a
    whole stack is made; dense leaves keep their draws."""
    p = ttf.init_params(e4.tc, seed=3)
    ex = p["blocks"]["mlp"]["experts"]
    L, E = e4.tc.n_layer, e4.tc.n_expert
    assert ex["fc_1"]["weight"].shape == (L, E, e4.tc.intermediate_size, e4.tc.n_embd)
    assert abs(ex["fc_1"]["weight"].std().item() - 0.02) < 2e-3
    assert abs(ex["proj"]["weight"].std().item() - 0.02 / (2 * L) ** 0.5) < 1e-3
    assert not torch.equal(ex["fc_1"]["weight"][0, 0], ex["fc_1"]["weight"][0, 1])
    dense = TConfig(**tiny_config().asdict())
    a, b = ttf.init_params(dense, seed=3), ttf.init_params(dense, seed=3)
    assert all(torch.equal(x, y) for x, y in zip(ttf.tree_leaves(a), ttf.tree_leaves(b)))


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weight", [0.0, 0.01, 0.5])
def test_cross_entropy_with_aux_matches_jax(pair, weight):
    toks = tokens(pair.jc, (2, 16), 9)
    tgts = tokens(pair.jc, (2, 16), 10)
    want = float(jtr.cross_entropy_loss(pair.jc, pair.jp, jnp.asarray(toks), jnp.asarray(tgts),
                                        remat=False, moe_aux_weight=weight))
    got = ttr.cross_entropy_loss(pair.tc, pair.tp, torch.from_numpy(toks),
                                 torch.from_numpy(tgts), remat=True, moe_aux_weight=weight)
    assert abs(got.item() - want) <= 1e-6 * abs(want)
    if weight:
        plain = ttr.cross_entropy_loss(pair.tc, pair.tp, torch.from_numpy(toks),
                                       torch.from_numpy(tgts), remat=False)
        assert got.item() > plain.item()  # the aux is >= 1 per layer


# ---------------------------------------------------------------------------
# the CLIs with --override
# ---------------------------------------------------------------------------

TINY_MIXTRAL = ["--model", "Mixtral-8x7B-v0.1", "--override", "n_layer=2",
                "--override", "n_embd=32", "--override", "n_head=4",
                "--override", "n_query_groups=2", "--override", "intermediate_size=64",
                "--override", "vocab_size=96", "--override", "padded_vocab_size=96",
                "--device", "cpu", "--dtype", "float32"]


def test_serve_cli_override_gives_the_jax_engines_streams():
    """`cli.serve --model Mixtral-8x7B-v0.1 --override ...` builds the
    registry config with those fields and serves a synthetic trace; the JAX
    engine over the same weights gives the same greedy streams."""
    from mdi_llm_tpu_torch.cli import serve as serve_cli

    args = serve_cli.build_parser().parse_args(
        TINY_MIXTRAL + ["--synthetic", "3", "--max-batch", "2", "--n-tokens", "6",
                        "--sequence-length", "64", "--block-size", "4"])
    trace, results, _stats, engine, _tok = serve_cli.serve(args)
    cfg = engine.gen.cfg
    assert cfg == TConfig.from_name("Mixtral-8x7B-v0.1", n_layer=2, n_embd=32, n_head=4,
                                    n_query_groups=2, intermediate_size=64, vocab_size=96,
                                    padded_vocab_size=96)
    assert cfg.n_expert == 8 and cfg.mlp_class_name == "LLaMAMoE"
    jc = JConfig(**{**cfg.asdict(), "hf_config": None})
    jp = jax.tree_util.tree_map(jnp.asarray, ttf.tree_map(lambda x: x.numpy(), engine.gen.params))
    jengine = JGenerator(jc, jp, max_seq_length=64, cache_dtype=jnp.float32).serve(
        block_size=4, max_batch=2)
    for rid, prompt, new in trace:
        jengine.add_request(rid, prompt, new)
    want, _ = jengine.run()
    assert results == want


@pytest.mark.parametrize("flags,match", [
    (["--override", "n_layers=2"], "KEY a Config field"),
    (["--override", "n_layer"], "KEY=VALUE"),
], ids=["unknown-key", "no-value"])
def test_override_is_checked(flags, match):
    from mdi_llm_tpu_torch.cli import sample as sample_cli

    with pytest.raises(SystemExit, match=match):
        sample_cli.run(sample_cli.build_parser().parse_args(TINY_MIXTRAL + flags))


def test_override_is_refused_with_a_checkpoint(tmp_path):
    from mdi_llm_tpu_torch.cli import sample as sample_cli

    args = sample_cli.build_parser().parse_args(
        ["--ckpt", str(tmp_path), "--override", "n_layer=1", "--device", "cpu"])
    with pytest.raises(SystemExit, match="goes with --model"):
        sample_cli.run(args)


def test_train_cli_trains_a_tiny_mixtral_and_refuses_a_capacity_factor(tmp_path):
    from mdi_llm_tpu_torch.cli import train as train_cli

    ds = tmp_path / "ds"
    ds.mkdir()
    rng = np.random.default_rng(0)
    rng.integers(0, 96, 4096).astype(np.uint16).tofile(ds / "train.bin")
    argv = [a for a in TINY_MIXTRAL] + ["--dataset", str(ds), "--ckpt", str(tmp_path / "ck"),
                                        "--batch-size", "2", "--block-size", "16",
                                        "--max-iters", "2", "--log-interval", "1"]
    result, trainer = train_cli.main(argv)
    assert trainer.cfg.mlp_class_name == "LLaMAMoE" and trainer.moe_aux_weight == 0.01
    assert [h["iter"] for h in result["history"] if "loss" in h] == [1, 2]
    # the capacity factor, once refused, bounds the dispatch of an ep mesh
    fresh = [a if a != str(tmp_path / "ck") else str(tmp_path / "ck2") for a in argv]
    result, trainer = train_cli.main(fresh + ["--moe-capacity-factor", "1.25",
                                              "--mesh", "ep=2"])
    assert trainer.layout.ep == 2 and trainer.tc.moe_capacity_factor == 1.25
    assert [h["iter"] for h in result["history"] if "loss" in h] == [1, 2]


@pytest.mark.parametrize("extra", [[], ["--init", "resume"]], ids=["saved-config", "resume"])
def test_train_cli_refuses_an_override_it_would_not_apply(tmp_path, extra):
    """Once the out dir holds a checkpoint and model_config.yaml (or with
    --init resume), the config comes from there: an --override is refused,
    as `load_model` refuses it with --ckpt, never dropped."""
    from mdi_llm_tpu_torch.cli import train as train_cli

    ds = tmp_path / "ds"
    ds.mkdir()
    np.random.default_rng(0).integers(0, 96, 2048).astype(np.uint16).tofile(ds / "train.bin")
    argv = TINY_MIXTRAL + ["--dataset", str(ds), "--ckpt", str(tmp_path / "ck"),
                           "--batch-size", "2", "--block-size", "16", "--max-iters", "1"]
    if not extra:
        train_cli.main(argv)
        assert (tmp_path / "ck" / "model_config.yaml").exists()
    with pytest.raises(SystemExit, match="goes with --model"):
        train_cli.main(argv + extra)
