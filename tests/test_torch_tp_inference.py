"""The port's tensor/data-parallel generation (`parallel/mesh.py`,
`parallel/sharding.py`, `parallel/collectives.py`,
`models/transformer.sharded_forward`, `Generator(mesh=make_mesh(...))`)
against the JAX package, on the CPU.

One counterpart for each test of `tests/test_tp_inference.py`, on the same
float32 weights (JAX `init_params`, moved over by `params_from_numpy`) of
`tiny_config`, every mesh position on the CPU:

- greedy streams of tp = 2 and 4 and of dp x tp = 2 x 2 equal the port's
  single device and the JAX tp Generator's on its virtual CPU devices;
  f32 logits of the sharded forward agree with the JAX tp forward's
  within 1e-4; GQA with stop sequences; pythia-style blocks (biases, made
  non-zero here, and the parallel residual, shared norm or not); an MoE
  config with its experts split over tp; int8, w8a8 and int4 weights
  (int4 also where the tp size does not divide the row-parallel scale
  groups); prefills through K2's plain version; `ChatSession`;
- the rule table, `adapt_specs_to_tree`, `shard_params`' slices (leaf by
  leaf against `jax.device_put(..., NamedSharding)`'s addressable shards),
  `make_mesh`'s errors and `validate_tp_divisibility`'s against the JAX
  package's; the collectives;
- the refusals (a ragged batch under dp, streaming and chat under dp,
  indivisible heads, ep/sp meshes naming their ROADMAP item), generate on
  a pipeline mesh (over stage 0's tp ranks), and the sample and chat
  CLIs' `--tp-devices` with the JAX CLI's flag exclusions.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdi_llm_tpu.generation import Generator as JGenerator
from mdi_llm_tpu.models import transformer as jtf
from mdi_llm_tpu.ops.quant import quantize_params as jquantize
from mdi_llm_tpu.parallel import mesh as jmesh
from mdi_llm_tpu.parallel import sharding as jsharding
from mdi_llm_tpu_torch.config import Config as TConfig
from mdi_llm_tpu_torch.convert import params_from_numpy
from mdi_llm_tpu_torch.generation import Generator
from mdi_llm_tpu_torch.models import transformer as ttf
from mdi_llm_tpu_torch.ops import flash as tflash
from mdi_llm_tpu_torch.ops.quant import FLAG_TO_MODE, quantize_params
from mdi_llm_tpu_torch.parallel import collectives, sharding
from mdi_llm_tpu_torch.parallel.mesh import Mesh, make_mesh, pipeline_mesh
from tests.test_model import CONFIG_VARIANTS, tiny_config

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PROMPTS = [[3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8, 9, 7], [2, 7, 1]]
GREEDY = dict(temperature=0.0)


def _pair(seed=0, perturb_bias=False, **kw):
    """(JAX cfg, JAX params, port cfg, port params) of one tiny config;
    `perturb_bias` draws every bias from a seed, so a bias added once per
    rank instead of once would show."""
    jc = tiny_config(**kw)
    jp = jtf.init_params(jc, jax.random.PRNGKey(seed))
    if perturb_bias:
        rng = np.random.default_rng(seed)
        flat, treedef = jax.tree_util.tree_flatten_with_path(jp)
        leaves = [jnp.asarray(rng.standard_normal(x.shape).astype(np.float32) * 0.1)
                  if "bias" in jax.tree_util.keystr(path) else x for path, x in flat]
        jp = jax.tree_util.tree_unflatten(treedef, leaves)
    tc = TConfig(**jc.asdict())
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    return jc, jp, tc, tp


def _gen(tc, tp, axes=None, **kw):
    mesh = None if axes is None else make_mesh(axes, ["cpu"])
    return Generator(tc, tp, cache_dtype=torch.float32, device="cpu", mesh=mesh, **kw)


@pytest.fixture(scope="module")
def model():
    return _pair(block_size=128, n_layer=4)


@pytest.fixture(scope="module")
def single(model):
    _, _, tc, tp = model
    return _gen(tc, tp)


# ---------------------------------------------------------------------------
# counterparts of tests/test_tp_inference.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_matches_single_device(model, single, devices, tp):
    """tp = 2 and 4 generate the single device's greedy streams and the
    JAX tp Generator's."""
    jc, jp, tc, tpar = model
    want, _ = single.generate(PROMPTS, 12, **GREEDY)
    got, _ = _gen(tc, tpar, {"tp": tp}).generate(PROMPTS, 12, **GREEDY)
    jeng = JGenerator(jc, jp, cache_dtype=jnp.float32,
                      mesh=jmesh.make_mesh({"tp": tp}, devices[:tp]))
    jgot, _ = jeng.generate(PROMPTS, 12, **GREEDY)
    assert got == want == jgot


def test_dp_tp_matches_single_device(model, single):
    _, _, tc, tp = model
    want, _ = single.generate(PROMPTS, 10, **GREEDY)
    eng = _gen(tc, tp, {"dp": 2, "tp": 2})
    got, _ = eng.generate(PROMPTS, 10, **GREEDY)
    assert got == want
    assert eng.dp == 2 and eng.tp == 2 and len(eng._replicas) == 2


def test_tp_gqa_with_stop_sequences():
    """GQA group split (G=2 over tp=2) + host-side stop detection."""
    _, _, tc, tp = _pair(1, block_size=128, n_layer=3, **CONFIG_VARIANTS["gqa"])
    ref = _gen(tc, tp)
    free, _ = ref.generate(PROMPTS[:2], 10, **GREEDY)
    stop = [free[0][len(PROMPTS[0]) + 2]]
    want, _ = ref.generate(PROMPTS[:2], 10, stop_sequences=[stop], **GREEDY)
    got, _ = _gen(tc, tp, {"tp": 2}).generate(PROMPTS[:2], 10, stop_sequences=[stop],
                                              **GREEDY)
    assert got == want


def test_tp_rejects_indivisible_heads(devices):
    """The same refusal and message as the JAX Generator's."""
    jc, jp, tc, tp = _pair(2, n_head=3, n_query_groups=3, n_embd=48)
    with pytest.raises(ValueError, match="n_head") as theirs:
        JGenerator(jc, jp, cache_dtype=jnp.float32,
                   mesh=jmesh.make_mesh({"tp": 2}, devices[:2]))
    with pytest.raises(ValueError, match="n_head") as mine:
        _gen(tc, tp, {"tp": 2})
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("mode,wkey", [
    ("int8", "weight_q"), ("w8a8", "weight_q8"), ("int4", "weight_q4"),
])
def test_tp_quantized_decode_parity(model, mode, wkey):
    """Quantized weights over a tp mesh: the rank trees carry the adapted
    layouts (column-parallel qkv splits its weight and per-channel scale,
    row-parallel proj keeps its int8 scale whole), and the streams are
    the single device's quantized streams."""
    _, _, tc, tp = model
    want, _ = _gen(tc, tp, quantize=mode).generate(PROMPTS, 10, **GREEDY)
    eng = _gen(tc, tp, {"tp": 2}, quantize=mode)
    got, _ = eng.generate(PROMPTS, 10, **GREEDY)
    assert got == want
    full = eng.params["blocks"]["attn"]
    rank = eng._shards[1]["blocks"]["attn"]
    assert rank["qkv"][wkey].shape[1] * 2 == full["qkv"][wkey].shape[1]
    if mode in ("int8", "w8a8"):
        assert rank["qkv"]["scale"].shape[1] * 2 == full["qkv"]["scale"].shape[1]
        assert rank["proj"]["scale"].shape == full["proj"]["scale"].shape


def test_dp_tp_quantized_parity(model):
    _, _, tc, tp = model
    want, _ = _gen(tc, tp, quantize="int8").generate(PROMPTS, 8, **GREEDY)
    got, _ = _gen(tc, tp, {"dp": 2, "tp": 2}, quantize="int8").generate(PROMPTS, 8, **GREEDY)
    assert got == want


def test_dp_rejects_ragged_batch(model, devices):
    jc, jp, tc, tp = model
    with pytest.raises(ValueError, match="divisible") as theirs:
        JGenerator(jc, jp, cache_dtype=jnp.float32,
                   mesh=jmesh.make_mesh({"dp": 2}, devices[:2])).generate(PROMPTS[:3], 4,
                                                                          **GREEDY)
    with pytest.raises(ValueError, match="divisible") as mine:
        _gen(tc, tp, {"dp": 2}).generate(PROMPTS[:3], 4, **GREEDY)
    assert str(mine.value) == str(theirs.value)


def test_cli_tp_flag_exclusions():
    """The JAX CLI's exclusions: tp with sp, ep with the other flags (sample),
    one streaming backend at a time (chat); `--tp-devices` with
    `--pipeline-stages`, once refused, runs the pipe x tp ring and prints
    the single device's greedy streams."""
    from mdi_llm_tpu_torch.cli import chat as chat_cli
    from mdi_llm_tpu_torch.cli import sample as sample_cli

    base = ["--device", "cpu", "--model", "pythia-14m", "--n-samples", "1", "--n-tokens", "4"]
    with pytest.raises(SystemExit, match="exclusive"):
        sample_cli.main(base + ["--tp-devices", "2", "--sp-devices", "2"])
    with pytest.raises(SystemExit, match="standalone expert-parallel"):
        sample_cli.main(base + ["--tp-devices", "2", "--ep-devices", "2"])
    f32 = base + ["--greedy", "--dtype", "float32"]
    assert sample_cli.main(f32 + ["--tp-devices", "2", "--pipeline-stages", "2"]) == \
        sample_cli.main(f32)
    with pytest.raises(SystemExit, match="separate streaming backends"):
        chat_cli.main(["--device", "cpu", "--model", "pythia-14m", "--tp-devices", "2",
                       "--pipeline-stages", "2"])


def test_dp_streaming_rejected_at_call_time(model, devices):
    """generate_chat and ChatSession refuse a dp mesh when called, with
    the JAX package's messages."""
    jc, jp, tc, tp = model
    jeng = JGenerator(jc, jp, cache_dtype=jnp.float32,
                      mesh=jmesh.make_mesh({"dp": 2}, devices[:2]))
    eng = _gen(tc, tp, {"dp": 2})
    for call in (lambda g: g.generate_chat([3, 1, 4], 4, **GREEDY), lambda g: g.chat_session()):
        with pytest.raises(ValueError, match="tp-only") as theirs:
            call(jeng)
        with pytest.raises(ValueError, match="tp-only") as mine:
            call(eng)
        assert str(mine.value) == str(theirs.value)


def test_tp_moe_experts_sharded(devices):
    """MoE inference over tp: each rank holds its experts (the expert axis
    is the split one), streams equal the single device's and the JAX tp
    Generator's."""
    jc, jp, tc, tp = _pair(3, block_size=64, n_layer=3, mlp_class_name="LLaMAMoE",
                           n_expert=4, n_expert_per_token=2)
    want, _ = _gen(tc, tp).generate(PROMPTS[:2], 8, **GREEDY)
    eng = _gen(tc, tp, {"tp": 2})
    got, _ = eng.generate(PROMPTS[:2], 8, **GREEDY)
    jgot, _ = JGenerator(jc, jp, cache_dtype=jnp.float32,
                         mesh=jmesh.make_mesh({"tp": 2}, devices[:2])).generate(
        PROMPTS[:2], 8, **GREEDY)
    assert got == want == jgot
    ex = eng._shards[1]["blocks"]["mlp"]["experts"]["fc_1"]["weight"]
    assert ex.shape[1] == 2 and torch.equal(ex, tp["blocks"]["mlp"]["experts"]["fc_1"][
        "weight"][:, 2:])


def test_chat_session_on_tp_mesh(model, single):
    """ChatSession over tp = 2: the per-rank cache persists and grows
    across sends, token-identical to the single device's stateless run."""
    _, _, tc, tp = model
    sess = _gen(tc, tp, {"tp": 2}).chat_session()
    history: list = []
    for turn in ([3, 1, 4], [9, 2]):
        want = list(single.generate_chat(history + turn, 8, **GREEDY))
        got = list(sess.send(turn, 8, **GREEDY))
        assert got == want
        history += turn + want


# ---------------------------------------------------------------------------
# the port's own: logits, block shapes, quantized layouts, K2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["llama", "neox", "shared-norm"])
@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_forward_logits_match_the_jax_tp_forward(devices, variant, tp):
    """f32 logits of `sharded_forward` against the JAX forward over
    GSPMD-sharded weights (and the port's own unsharded forward) within
    1e-4, with non-zero biases: a row-parallel bias added on every rank,
    or a parallel-residual block summing its partial results wrongly,
    would show."""
    jc, jp, tc, tp_params = _pair(4, perturb_bias=True, **CONFIG_VARIANTS[variant])
    mesh = jmesh.make_mesh({"tp": tp}, devices[:tp])
    jsh = jsharding.shard_params(jp, jc, mesh)
    tokens = np.random.default_rng(0).integers(0, jc.vocab_size, (2, 11)).astype(np.int32)
    want = np.asarray(jax.jit(lambda p, t: jtf.forward(jc, p, t, jnp.zeros((2,), jnp.int32))[0])(
        jsh, jnp.asarray(tokens)))
    tmesh = make_mesh({"tp": tp}, ["cpu"])
    shards = sharding.shard_params(tp_params, tc, tmesh)
    t = torch.from_numpy(tokens).long()
    got = ttf.sharded_forward(tc, [shards[i] for i in range(tp)], t, torch.zeros(2))
    single = ttf.forward(tc, tp_params, t, torch.zeros(2, dtype=torch.long))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.numpy(), single.numpy(), atol=1e-4, rtol=0)


@pytest.mark.parametrize("variant", ["neox", "shared-norm"])
def test_pythia_blocks_generate_the_single_and_jax_tp_streams(devices, variant):
    jc, jp, tc, tp = _pair(5, perturb_bias=True, block_size=128, **CONFIG_VARIANTS[variant])
    want, _ = _gen(tc, tp).generate(PROMPTS, 8, **GREEDY)
    got, _ = _gen(tc, tp, {"tp": 2}).generate(PROMPTS, 8, **GREEDY)
    jgot, _ = JGenerator(jc, jp, cache_dtype=jnp.float32,
                         mesh=jmesh.make_mesh({"tp": 2}, devices[:2])).generate(
        PROMPTS, 8, **GREEDY)
    assert got == want == jgot


@pytest.mark.parametrize("mode", ["int8", "w8a8", "int4"])
def test_quantized_tp_matches_the_jax_tp_generator(devices, mode):
    """Each package quantizes the same float32 weights (bit-identical
    quantizers) and generates over a tp = 2 mesh; the intermediate width
    384 gives int4's row-parallel MLP proj 3 scale groups, which tp = 2
    does not divide (`regroup_w4_row_scales`)."""
    jc, jp, tc, tp = _pair(6, block_size=128, intermediate_size=384)
    jgot, _ = JGenerator(jc, jp, cache_dtype=jnp.float32, quantize=mode,
                         mesh=jmesh.make_mesh({"tp": 2}, devices[:2])).generate(
        PROMPTS, 8, **GREEDY)
    want, _ = _gen(tc, tp, quantize=mode).generate(PROMPTS, 8, **GREEDY)
    eng = _gen(tc, tp, {"tp": 2}, quantize=mode)
    got, _ = eng.generate(PROMPTS, 8, **GREEDY)
    assert got == want == jgot
    if mode == "int4":
        proj = eng._shards[1]["blocks"]["mlp"]["proj"]
        # 192 input positions per rank, groups of 128: refitted to 64
        assert proj["weight_q4"].shape[-1] == 96 and proj["scale"].shape[-1] == 3


def test_w8a8_row_parallel_quantizes_on_the_whole_rows_max(model):
    """A rank's slice of a w8a8 row-parallel input is quantized on the
    whole row's max |x|: the sharded forward's logits equal the unsharded
    quantized forward's within f32 summation order."""
    _, _, tc, tp = model
    q = quantize_params(tp, mode=FLAG_TO_MODE["w8a8"])
    shards = sharding.shard_params(q, tc, make_mesh({"tp": 2}, ["cpu"]))
    t = torch.tensor([[5, 9, 2, 7, 1, 3]])
    got = ttf.sharded_forward(tc, [shards[0], shards[1]], t, torch.zeros(1))
    want = ttf.forward(tc, q, t, torch.zeros(1, dtype=torch.long))
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


def test_tp_prefill_runs_each_rank_through_k2(model, single):
    """A prefill bucket at `flash_min_len` runs K2 (its plain version on
    the CPU) once per rank and layer, with the single device's streams."""
    _, _, tc, tp = model
    prompts = [list(range(1, 20)), list(range(3, 30))]
    want, _ = _gen(tc, tp, use_flash=True, flash_min_len=16).generate(prompts, 6, **GREEDY)
    eng = _gen(tc, tp, {"tp": 2}, use_flash=True, flash_min_len=16)
    tflash.flash_attention_plain.calls = 0
    got, _ = eng.generate(prompts, 6, **GREEDY)
    assert got == want
    assert tflash.flash_attention_plain.calls == 2 * tc.n_layer


def test_tp_generate_sampled_is_seeded(model):
    """Sampled decoding on a tp mesh draws from the Generator's seed: two
    runs agree; the draws come from the single device's distribution."""
    _, _, tc, tp = model
    a, _ = _gen(tc, tp, {"tp": 2}, rng_seed=3).generate(PROMPTS, 6, temperature=0.8)
    b, _ = _gen(tc, tp, {"tp": 2}, rng_seed=3).generate(PROMPTS, 6, temperature=0.8)
    assert a == b


def test_mesh_runs_keep_their_lanes(model, single):
    """Batch compaction and the shared-prompt prefill stay off on a mesh,
    as in the JAX package; the streams are unchanged."""
    _, _, tc, tp = model
    prompts = [PROMPTS[0]] * 4
    want, wstats = single.generate(prompts, 6, **GREEDY)
    got, stats = _gen(tc, tp, {"tp": 2}).generate(prompts, 6, **GREEDY)
    assert got == want and stats.compactions == 0


# ---------------------------------------------------------------------------
# the rule table, the slices, the mesh
# ---------------------------------------------------------------------------


def _spec_tuples(tree):
    if isinstance(tree, dict):
        return {k: _spec_tuples(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("variant", ["llama", "neox", "gpt2", "moe"])
@pytest.mark.parametrize("axes", [("tp", None), (None, None), ("tp", "ep")])
def test_param_specs_are_the_jax_rule_table(variant, axes):
    kw = (dict(mlp_class_name="LLaMAMoE", n_expert=4, n_expert_per_token=2)
          if variant == "moe" else CONFIG_VARIANTS.get(variant, {}))
    jc = tiny_config(**kw)
    tc = TConfig(**jc.asdict())
    assert _spec_tuples(sharding.param_specs(tc, *axes)) == _spec_tuples(
        jsharding.param_specs(jc, *axes))
    assert tuple(sharding.paged_kv_spec()) == tuple(jsharding.paged_kv_spec())
    assert tuple(sharding.paged_kv_scale_spec()) == tuple(jsharding.paged_kv_scale_spec())
    assert tuple(sharding.block_table_spec()) == tuple(jsharding.block_table_spec())
    assert tuple(sharding.batch_spec("dp", "sp")) == tuple(jsharding.batch_spec("dp", "sp"))


def _quantized_pair(jp, mode):
    """The same float32 weights quantized by each package (bit-identical)."""
    jq = jquantize(jax.tree_util.tree_map(np.asarray, jp), mode=FLAG_TO_MODE[mode])
    tq = quantize_params(params_from_numpy(jax.tree_util.tree_map(np.asarray, jp)),
                         mode=FLAG_TO_MODE[mode])
    return jq, tq


@pytest.mark.parametrize("mode", [None, "int8", "w8a8", "int4"])
@pytest.mark.parametrize("axes", [{"tp": 2}, {"tp": 4}, {"dp": 2, "tp": 2}],
                         ids=["tp2", "tp4", "dp2-tp2"])
def test_shard_params_slices_are_the_jax_addressable_shards(devices, mode, axes):
    """Leaf by leaf, position by position: the port's slice equals the
    addressable shard `jax.device_put(..., NamedSharding)` puts on the
    same mesh position (quantized trees through `adapt_specs_to_tree`;
    the intermediate width 384 leaves int4's proj group axis unsplit)."""
    jc, jp, tc, tp = _pair(7, intermediate_size=384)
    if mode is None:
        jtree, ttree = jp, tp
    else:
        jtree, ttree = _quantized_pair(jp, mode)
    n = int(np.prod(list(axes.values())))
    jm = jmesh.make_mesh(axes, devices[:n])
    jsh = jsharding.shard_params(jtree, jc, jm)
    shards = sharding.shard_params(ttree, tc, make_mesh(axes, ["cpu"] * n))
    specs = sharding.adapt_specs_to_tree(sharding.param_specs(tc), ttree,
                                         axis_sizes=dict(axes))
    jspecs = jsharding.adapt_specs_to_tree(jsharding.param_specs(jc), jtree,
                                           axis_sizes=dict(axes))
    assert _spec_tuples(specs) == _spec_tuples(jspecs)
    order = {d: i for i, d in enumerate(jm.devices.flat)}
    jleaves = jax.tree_util.tree_leaves(jsh)
    for pos, tree in shards.items():
        tleaves = ttf.tree_leaves(tree)
        assert len(tleaves) == len(jleaves)
        for t, j in zip(tleaves, jleaves):
            shard = next(s for s in j.addressable_shards if order[s.device] == pos)
            want = np.asarray(shard.data)
            assert tuple(t.shape) == want.shape
            assert np.array_equal(t.numpy().astype(want.dtype), want)


def test_shard_params_are_views_of_the_full_tree(model):
    """On the weights' own device a slice is a view: a mesh on one device
    holds no second copy of the model."""
    _, _, tc, tp = model
    shards = sharding.shard_params(tp, tc, make_mesh({"tp": 2}, ["cpu"]))
    qkv = shards[1]["blocks"]["attn"]["qkv"]["weight"]
    assert qkv.untyped_storage().data_ptr() == tp["blocks"]["attn"]["qkv"][
        "weight"].untyped_storage().data_ptr()


@pytest.mark.parametrize("tp", [2, 3, 4, 5])
def test_validate_tp_divisibility_matches_jax(tp):
    for kw in ({}, dict(n_head=6, n_query_groups=3, n_embd=48),
               dict(mlp_class_name="LLaMAMoE", n_expert=6, n_expert_per_token=2),
               dict(padded_vocab_size=130, vocab_size=130)):
        jc = tiny_config(**kw)
        tc = TConfig(**jc.asdict())
        for check_vocab in (False, True):
            try:
                jsharding.validate_tp_divisibility(jc, tp, check_vocab=check_vocab)
                theirs = None
            except ValueError as e:
                theirs = str(e)
            try:
                sharding.validate_tp_divisibility(tc, tp, check_vocab=check_vocab)
                mine = None
            except ValueError as e:
                mine = str(e)
            assert mine == theirs


@pytest.mark.parametrize("axes", [
    {"tp": 2}, {"dp": 2, "tp": 4}, {"tp": -1}, {"dp": 2, "tp": -1}, {"tp": 0},
    {"tp": 2.0}, {"dp": -1, "tp": -1}, {"dp": 3, "tp": -1}, {"tp": 16}, {"dp": 5, "tp": 2},
])
def test_make_mesh_sizes_and_errors_match_jax(devices, axes):
    try:
        jm = jmesh.make_mesh(axes, devices)
        theirs = dict(jm.shape)
    except ValueError as e:
        theirs = str(e)
    try:
        tm = make_mesh(axes, ["cpu"] * len(devices))
        mine = dict(tm.shape)
        assert tm.devices.shape == tuple(mine.values())
    except ValueError as e:
        mine = str(e)
    assert mine == theirs


def test_make_mesh_on_one_device_puts_every_position_there():
    mesh = make_mesh({"dp": 2, "tp": 4}, ["cpu"])
    assert isinstance(mesh, Mesh) and mesh.shape == {"dp": 2, "tp": 4}
    assert mesh.device_list() == [torch.device("cpu")] * 8
    assert [c for c in mesh.positions()][5] == {"dp": 1, "tp": 1}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh({"tp": 2})


def test_collectives_sum_in_rank_order_and_gather():
    parts = [torch.full((2, 3), float(i + 1)) for i in range(4)]
    red = collectives.all_reduce(parts)
    assert all(r is red[0] for r in red) and torch.equal(red[0], torch.full((2, 3), 10.0))
    assert torch.equal(collectives.all_reduce(parts, op="max")[2], torch.full((2, 3), 4.0))
    gat = collectives.all_gather(parts, -1)
    assert gat[0].shape == (2, 12) and torch.equal(gat[3][:, 3:6], parts[1])


def test_shard_config_is_each_ranks_share():
    tc = TConfig(**tiny_config(n_query_groups=2, intermediate_size=96).asdict())
    r = ttf.shard_config(tc, 2)
    assert (r.n_head, r.n_query_groups, r.intermediate_size, r.head_size) == (2, 1, 48, 8)
    assert ttf.shard_config(tc, 1) is tc
    moe = dataclasses.replace(tc, mlp_class_name="LLaMAMoE", n_expert=4, n_expert_per_token=2)
    assert ttf.shard_config(moe, 2).n_expert == 2


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


# the ids are the ones these cases had when the pipeline meshes were
# refused (item 14, second half): they are ported now, and run
@pytest.mark.parametrize("axes,match", [
    pytest.param({"ep": 2}, None, id="axes0-item 16"),
    pytest.param({"sp": 2}, None, id="axes1-item 16"),
    pytest.param({"pp": 2, "tp": 2}, None, id="axes2-item 14, second half"),
    pytest.param({"pipe": 2}, None, id="axes3-item 14, second half"),
])
def test_unported_meshes_are_refused_naming_their_item(model, axes, match):
    """A pipeline axis, alone or beside tp, generates as the JAX Generator
    does with its replicated pipeline axis: over stage 0's tp ranks, the
    single device's streams.  An sp axis, once refused, is replicated as
    the JAX Generator leaves it (the sequence splits in `SPGenerator`),
    and an ep axis, once refused, leaves a dense config as it is, as the
    JAX Generator does (its experts split on an MoE config,
    tests/test_torch_expert.py): the single device's streams."""
    _, _, tc, tp = model
    if match is not None:
        with pytest.raises(NotImplementedError, match=match):
            _gen(tc, tp, axes)
        return
    gen = _gen(tc, tp, axes)
    if "sp" in axes or "ep" in axes:
        assert gen.mesh is None and gen.tp == 1
    else:
        assert set(gen.mesh) == {0, 1} and gen.tp == axes.get("tp", 1)
    single = Generator(tc, tp, device="cpu", cache_dtype=torch.float32)
    assert gen.generate(PROMPTS[:3], 4, **GREEDY)[0] == \
        single.generate(PROMPTS[:3], 4, **GREEDY)[0]


def test_pipe_by_tp_stays_refused(model):
    """Once a refusal, now the ported layout: `pipeline_mesh(S, devices,
    tp=N)` is a ("pipe", "tp") Mesh the Generator lays over its stages'
    ranks.  A bare dict of axis sizes is not a mesh (the JAX Generator
    takes a Mesh): refused by type, as is a {stage: device} dict with a
    gap."""
    _, _, tc, tp = model
    mesh = pipeline_mesh(2, ["cpu"], tp=2)
    assert mesh.axis_names == ("pipe", "tp") and mesh.size == 4
    gen = Generator(tc, tp, device="cpu", mesh=mesh)
    assert gen.stage_ranks == {0: [torch.device("cpu")] * 2, 1: [torch.device("cpu")] * 2}
    for bad in ({"pp": 2, "tp": 2}, {"tp": 2}, {0: "cpu", 2: "cpu"}):
        with pytest.raises(TypeError, match="make_mesh"):
            Generator(tc, tp, device="cpu", mesh=bad)


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


def test_sample_cli_tp_devices_generates_the_single_streams():
    from mdi_llm_tpu_torch.cli import sample as cli

    base = ["--device", "cpu", "--model", "pythia-14m", "--n-tokens", "6", "--greedy",
            "--n-samples", "2", "--dtype", "float32"]
    _p, want, _s, _g, _t, _sec = cli.run(cli.build_parser().parse_args(base))
    _p, got, stats, gen, _t, _sec = cli.run(cli.build_parser().parse_args(
        base + ["--tp-devices", "2"]))
    assert got == want and gen.tp == 2 and stats.tokens_generated == 12


def test_sample_cli_tp_raises_without_a_gpu():
    """Without `--device cpu` the tp run asks for the card, and on a
    machine without one it raises, as every entry point does."""
    if torch.cuda.is_available():
        return
    proc = subprocess.run(
        [sys.executable, "-m", "mdi_llm_tpu_torch.cli.sample", "--model", "pythia-14m",
         "--n-tokens", "4", "--greedy", "--tp-devices", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT)))
    assert proc.returncode != 0 and "torch.cuda.is_available() is False" in proc.stderr


def test_importing_the_new_modules_loads_no_jax():
    code = ("import sys, mdi_llm_tpu_torch.parallel.mesh, mdi_llm_tpu_torch.parallel.sharding, "
            "mdi_llm_tpu_torch.parallel.collectives, mdi_llm_tpu_torch.cli.evaluate, "
            "mdi_llm_tpu_torch.cli.prepare_data, mdi_llm_tpu_torch.utils.console, "
            "mdi_llm_tpu_torch.generation; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m.split('.')[0] == 'mdi_llm_tpu' for m in sys.modules)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0, proc.stderr
