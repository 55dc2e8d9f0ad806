"""The port's expert parallelism (`parallel/expert.py`) against the JAX
package's, on the CPU, in float32 (the cases of `tests/test_expert.py`).

The same numpy draws go through `mdi_llm_tpu.parallel.expert` on the 8
virtual CPU devices and through the port's ranks on the CPU:

- layer parity at exact capacity for (E, k, ep) = (8, 2, 8), (8, 2, 4)
  and (4, 1, 2), against the JAX ep layer and the port's dense
  `moe_forward`, within 2e-5;
- drops at `capacity_factor` 0.5: the JAX package's output (and its
  host-side reference dropper's) within 2e-4, and provably not dense;
- the aux, dense against ep and against the JAX ep aux; gradients of
  the training loss, dense against ep with aux weight 0 and 0.05 (the
  aux moving the router's gradient); the dp x ep token split's output,
  aux and gradients;
- `Generator` on an ep mesh: greedy streams equal to the JAX ep
  Generator's and the port's dense Generator's, over the float, int8,
  w8a8 and int4 trees and a pre-quantized one; `ChatSession` on an ep
  mesh; serving refuses ep;
- the Trainer's refusals in the JAX package's words, and the ep Trainer's
  steps equal to the JAX ep Trainer's;
- `sample`/`chat --ep-devices` on a converted tiny Mixtral checkpoint:
  the JAX CLIs' streams.
"""

import io
import shutil
import sys
from dataclasses import asdict
from functools import partial
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdi_llm_tpu import training as jtr
from mdi_llm_tpu.generation import Generator as JGenerator
from mdi_llm_tpu.models import transformer as jtf
from mdi_llm_tpu.ops import quant as jq
from mdi_llm_tpu.parallel import expert as jexpert
from mdi_llm_tpu.parallel import mesh as jmesh
from mdi_llm_tpu_torch import training as ttr
from mdi_llm_tpu_torch.config import Config as TConfig
from mdi_llm_tpu_torch.convert import params_from_numpy
from mdi_llm_tpu_torch.generation import Generator
from mdi_llm_tpu_torch.models import transformer as ttf
from mdi_llm_tpu_torch.ops import quant as tq
from mdi_llm_tpu_torch.parallel import expert as texpert
from mdi_llm_tpu_torch.parallel.collectives import all_to_all
from mdi_llm_tpu_torch.parallel.mesh import make_mesh
from tests.test_expert import _host_reference_with_drops, moe_config, moe_layer_params
from tests.test_training import small_tc

torch.set_num_threads(1)
GREEDY = dict(temperature=0.0)
PROMPTS = [[3, 7, 11, 2], [5, 1, 9, 13, 4]]


def tmesh(axes):
    return make_mesh(axes, ["cpu"])


def port_layer(p):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, p))


def xs(cfg, shape, seed):
    return np.random.default_rng(seed).standard_normal(shape + (cfg.n_embd,)).astype(np.float32)


def jep(cfg, p, x, mesh, **kw):
    """The JAX ep layer on `x`, compiled (the eager `shard_map` runs the
    same program op by op, an order of magnitude slower on the CPU)."""
    return jax.jit(lambda p, x: jexpert.ep_moe_forward(cfg, p, x, mesh, **kw))(
        p, jnp.asarray(x))


def model(cfg, seed):
    jp = jtf.init_params(cfg, jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))


@pytest.mark.parametrize("E,k,ep", [(8, 2, 8), (8, 2, 4), (4, 1, 2)])
def test_layer_parity_exact_capacity(devices, E, k, ep):
    cfg = moe_config(E=E, k=k)
    p = moe_layer_params(cfg)
    x = xs(cfg, (3, 5), 1)
    want = jep(cfg, p, x, jmesh.make_mesh({"ep": ep}, devices[:ep]))
    tc, tp = TConfig(**cfg.asdict()), port_layer(p)
    got = texpert.ep_moe_forward(tc, tp, torch.from_numpy(x), tmesh({"ep": ep}))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    dense = ttf.moe_forward(tc, tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=2e-5)


def test_capacity_drops_match_jax(devices):
    """At capacity factor 0.5 the port drops the JAX package's assignments:
    its output, and the host-side reference dropper's."""
    cfg = moe_config(E=4, k=2)
    p = moe_layer_params(cfg, seed=3)
    x = xs(cfg, (1, 12), 4)
    C = texpert.expert_capacity(TConfig(**cfg.asdict()), 6, 0.5)
    assert C == jexpert.expert_capacity(cfg, 6, 0.5) and C < 6  # the buffer can overflow
    want = jep(cfg, p, x, jmesh.make_mesh({"ep": 2}, devices[:2]), capacity_factor=0.5)
    tc, tp = TConfig(**cfg.asdict()), port_layer(p)
    got = texpert.ep_moe_forward(tc, tp, torch.from_numpy(x), tmesh({"ep": 2}),
                                 capacity_factor=0.5).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-4)
    np.testing.assert_allclose(got, _host_reference_with_drops(cfg, p, x, 2, C), atol=2e-4)
    dense = ttf.moe_forward(tc, tp, torch.from_numpy(x)).numpy()
    assert float(np.abs(dense - got).max()) > 1e-4


def test_moe_aux_loss_dense_vs_ep(devices):
    cfg = moe_config(E=4, k=2)
    p = moe_layer_params(cfg, seed=5)
    x = xs(cfg, (2, 8), 6)
    _, jaux = jep(cfg, p, x, jmesh.make_mesh({"ep": 4}, devices[:4]), with_aux=True)
    tc, tp = TConfig(**cfg.asdict()), port_layer(p)
    yd, aux_d = ttf.moe_forward(tc, tp, torch.from_numpy(x), with_aux=True)
    ye, aux_e = texpert.ep_moe_forward(tc, tp, torch.from_numpy(x), tmesh({"ep": 4}),
                                       with_aux=True)
    np.testing.assert_allclose(ye.numpy(), yd.numpy(), atol=2e-5)
    np.testing.assert_allclose(float(aux_e), float(aux_d), rtol=1e-5)
    np.testing.assert_allclose(float(aux_e), float(jaux), rtol=1e-5)


def _grads(tc, params, toks, tgts, aux_w, impl=None):
    params = ttf.tree_map(lambda a: a.detach().clone().requires_grad_(True), params)
    loss = ttr.cross_entropy_loss(tc, params, toks, tgts, remat=False, moe_aux_weight=aux_w,
                                  moe_impl=impl)
    leaves = ttf.tree_leaves(params)
    return float(loss.detach()), dict(zip(range(len(leaves)), torch.autograd.grad(loss, leaves)))


@pytest.mark.parametrize("axes,dp_axis", [({"ep": 4}, None), ({"dp": 2, "ep": 4}, "dp")],
                         ids=["ep4", "dp2-ep4"])
def test_ep_training_grad_parity(axes, dp_axis):
    """The CE loss's gradients through the dispatch (exact capacity) equal
    the dense formulation's, with and without the aux term (which must
    move the router's gradient); on dp x ep the tokens split over both
    axes."""
    cfg = moe_config(E=4, k=2, n_layer=2)
    tc = TConfig(**cfg.asdict())
    _, tp = model(cfg, 7)
    rng = np.random.default_rng(8)
    toks, tgts = (torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8))) for _ in range(2))
    impl = partial(texpert.ep_moe_forward, mesh=tmesh(axes), dp_axis=dp_axis)
    # the router's leaf, in tree_leaves' sorted-key order
    index = [i for i, (path, _) in enumerate(_paths(tp)) if path.endswith("gate/weight")][0]
    gate = {}
    for aux_w in (0.0, 0.05):
        ld, gd = _grads(tc, tp, toks, tgts, aux_w)
        le, ge = _grads(tc, tp, toks, tgts, aux_w, impl)
        np.testing.assert_allclose(le, ld, rtol=2e-5)
        for i in gd:
            np.testing.assert_allclose(ge[i].numpy(), gd[i].numpy(), atol=5e-5,
                                       err_msg=f"leaf {i} aux_w={aux_w}")
        gate[aux_w] = ge[index].numpy()
    assert float(np.abs(gate[0.05] - gate[0.0]).max()) > 1e-7


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_ep_dispatch_splits_tokens_over_dp(devices):
    """dp x ep (each rank routes N / (dp ep) tokens): output and aux equal
    the JAX package's and the dense formulation's."""
    cfg = moe_config(E=4, k=2, n_layer=2)
    p = moe_layer_params(cfg, seed=11)
    x = xs(cfg, (2, 8), 12)
    jy, jaux = jep(cfg, p, x, jmesh.make_mesh({"dp": 2, "ep": 4}, devices), with_aux=True,
                   dp_axis="dp")
    tc, tp = TConfig(**cfg.asdict()), port_layer(p)
    y, aux = texpert.ep_moe_forward(tc, tp, torch.from_numpy(x), tmesh({"dp": 2, "ep": 4}),
                                    with_aux=True, dp_axis="dp")
    yd, aux_d = ttf.moe_forward(tc, tp, torch.from_numpy(x), with_aux=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=2e-5)
    np.testing.assert_allclose(y.numpy(), yd.numpy(), atol=2e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(aux_d), rtol=1e-5)


def test_all_to_all_is_the_jax_exchange_and_its_own_transpose():
    """Rank r's chunk j lands at rank j, in rank order; the backward of
    the exchange is the reverse exchange."""
    parts = [torch.arange(12.0).reshape(4, 3) + 100 * r for r in range(4)]
    out = all_to_all(parts)
    for j in range(4):
        np.testing.assert_array_equal(out[j].numpy(),
                                      np.stack([parts[r][j].numpy() for r in range(4)]))
    leaves = [p.clone().requires_grad_(True) for p in parts]
    cot = [torch.randn(4, 3) for _ in range(4)]
    grads = torch.autograd.grad(all_to_all(leaves), leaves, cot)
    back = all_to_all(cot)
    for g, b in zip(grads, back):
        np.testing.assert_array_equal(g.numpy(), b.numpy())
    with pytest.raises(ValueError, match="does not divide"):
        all_to_all([torch.zeros(3, 2), torch.zeros(3, 2)])


def test_place_ep_slices_views_by_position_and_guards_the_axis():
    cfg = moe_config()
    _, tp = model(cfg, 0)
    placed = texpert.place_ep(tp, tmesh({"ep": 4}), cfg.n_expert)
    fc1 = tp["blocks"]["mlp"]["experts"]["fc_1"]["weight"]
    for e, tree in placed.items():
        got = tree["blocks"]["mlp"]["experts"]["fc_1"]["weight"]
        assert got.shape[1] == 2 and got.data_ptr() == fc1[:, 2 * e].data_ptr()
        assert tree["blocks"]["attn"]["qkv"]["weight"] is tp["blocks"]["attn"]["qkv"]["weight"]
    qt = tq.quantize_params(tp, mode="w4")
    for tree in texpert.place_ep(qt, tmesh({"ep": 2}), cfg.n_expert).values():
        assert tree["blocks"]["mlp"]["experts"]["proj"]["scale"].shape[1] == 4
    bad = {"experts": {"fc_1": {"weight": torch.zeros(2, 3, 4)}}}
    with pytest.raises(ValueError, match="axis-1 size 3"):
        texpert.place_ep(bad, tmesh({"ep": 2}), 8)


@pytest.fixture(scope="module")
def moe_model():
    cfg = moe_config()
    jp, tp = model(cfg, 1)
    return cfg, jp, TConfig(**cfg.asdict()), tp


@pytest.mark.parametrize("mode", [None, "int8", "w8a8", "int4", "prequantized"])
def test_generator_ep_greedy_equals_jax_and_dense(moe_model, devices, mode):
    cfg, jp, tc, tp = moe_model
    if mode == "prequantized":
        jp, tp, mode = jq.quantize_params(jp), tq.quantize_params(tp), None
    jgen = JGenerator(cfg, jp, max_seq_length=64, quantize=mode,
                      mesh=jmesh.make_mesh({"ep": 4}, devices[:4]))
    want, _ = jgen.generate(PROMPTS, 10, **GREEDY)
    dense = Generator(tc, tp, max_seq_length=64, device="cpu", quantize=mode)
    gen = Generator(tc, tp, max_seq_length=64, device="cpu", quantize=mode,
                    mesh=tmesh({"ep": 4}))
    assert gen._moe_impl is not None and dense._moe_impl is None
    got, _ = gen.generate(PROMPTS, 10, **GREEDY)
    assert got == want == dense.generate(PROMPTS, 10, **GREEDY)[0]


def test_chat_session_on_ep_mesh(moe_model):
    """Cross-turn KV reuse over an ep mesh: token-identical to a dense
    full-history re-prefill every turn."""
    _cfg, _jp, tc, tp = moe_model
    single = Generator(tc, tp, max_seq_length=64, device="cpu")
    sess = Generator(tc, tp, max_seq_length=64, device="cpu",
                     mesh=tmesh({"ep": 4})).chat_session()
    history = []
    for turn in ([3, 7, 11], [2, 5]):
        want = list(single.generate_chat(history + turn, 8, **GREEDY))
        assert list(sess.send(turn, 8, **GREEDY)) == want
        history += turn + want


def test_ep_generator_guards(moe_model):
    """A dense config on an ep mesh runs as without one (the JAX
    Generator's), `n_expert % ep` is refused in its words, serving refuses
    ep (the JAX engine's message), ep beside tp runs (the streams against
    the JAX Generator's are `tests/test_torch_ep_beside.py`'s), and an ep
    mesh over processes is accepted, each process keeping its ranks'
    experts (the exchange runs in `tests/test_torch_sp_ep_inference_procs.py`)."""
    _cfg, _jp, tc, tp = moe_model
    dense_cfg = TConfig(**moe_config(mlp_class_name="LLaMAMLP").asdict())
    dp = ttf.init_params(dense_cfg, 0)
    gen = Generator(dense_cfg, dp, max_seq_length=64, device="cpu", mesh=tmesh({"ep": 2}))
    assert gen._moe_impl is None and gen.mesh is None
    assert gen.generate(PROMPTS, 4, **GREEDY)[0] == Generator(
        dense_cfg, dp, max_seq_length=64, device="cpu").generate(PROMPTS, 4, **GREEDY)[0]
    with pytest.raises(ValueError, match="ep=3 does not divide n_expert=8"):
        Generator(tc, tp, max_seq_length=64, device="cpu", mesh=tmesh({"ep": 3}))
    gen = Generator(tc, tp, max_seq_length=64, device="cpu", mesh=tmesh({"ep": 2}))
    with pytest.raises(ValueError, match="serving does not support ep=2"):
        gen.serve(block_size=8, max_batch=2)
    gen = Generator(tc, tp, max_seq_length=64, device="cpu", mesh=tmesh({"tp": 2, "ep": 2}))
    assert gen._moe_impl is not None and gen.tp == 2
    assert gen.generate(PROMPTS, 4, **GREEDY)[0] == Generator(
        tc, tp, max_seq_length=64, device="cpu").generate(PROMPTS, 4, **GREEDY)[0]
    with mock.patch("mdi_llm_tpu_torch.parallel.collectives.CommGroup") as group:
        gen = Generator(tc, tp, max_seq_length=64, device="cpu",
                        mesh=make_mesh({"ep": 2}, ["cpu"], process_id=1, num_processes=2))
    group.assert_called_once_with([0, 1])
    assert gen._ep_group is group.return_value and not gen._graphs
    n = tc.n_expert // 2
    for a, b in zip(ttf.tree_leaves(gen.params["blocks"]["mlp"]["experts"]),
                    ttf.tree_leaves(tp["blocks"]["mlp"]["experts"])):
        assert torch.equal(a, b[:, n:])  # its rank's experts only


def test_local_trees_hold_only_the_owned_experts(moe_model, tmp_path):
    """A process of an ep mesh over processes draws, loads and keeps only
    its ranks' experts: `owned_experts` over 2 processes of ep 4,
    `init_params(experts=)` equal to the whole draw's slice (the other
    experts drawn and dropped), `load_checkpoint(experts=)` equal to the
    stored stacks' slice, `local_experts` keeping a local tree and
    refusing a stack of another size, `replicated` dropping the stacks."""
    from mdi_llm_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    _cfg, _jp, tc, tp = moe_model
    meshes = [make_mesh({"ep": 4}, ["cpu"], process_id=i, num_processes=2) for i in range(2)]
    assert [texpert.owned_experts(m, tc.n_expert) for m in meshes] == [(0, 4), (4, 4)]
    assert texpert.owned_experts(tmesh({"ep": 4}), tc.n_expert) is None
    whole = ttf.init_params(tc, 5)
    save_checkpoint(tp, tc, tmp_path)
    for mesh, (start, n) in zip(meshes, ((0, 4), (4, 4))):
        local = ttf.init_params(tc, 5, experts=(start, n))
        _, loaded = load_checkpoint(tmp_path, experts=(start, n))
        dims = ttf.tree_leaves(texpert.ep_dims(whole))
        for d, a, b, c, w in zip(dims, ttf.tree_leaves(local), ttf.tree_leaves(whole),
                                 ttf.tree_leaves(loaded), ttf.tree_leaves(tp)):
            assert torch.equal(a, b if d is None else b.narrow(1, start, n))
            assert torch.equal(c, w if d is None else w.narrow(1, start, n))
        kept = texpert.local_experts(local, mesh, tc.n_expert)
        assert all(a is b for a, b in zip(ttf.tree_leaves(kept), ttf.tree_leaves(local)))
        assert "experts" not in texpert.replicated(local)["blocks"]["mlp"]
        assert ttf.tree_leaves(texpert.replicated(local)["blocks"]["attn"])
    bad = {"experts": {"fc_1": {"weight": torch.zeros(2, 3, 4)}}}
    with pytest.raises(ValueError, match="axis-1 size 3"):
        texpert.local_experts(bad, meshes[0], 8)


def _tcs(**kw):
    jt = small_tc(grad_acc_steps=1, **kw)
    return jt, ttr.TrainingConfig(**asdict(jt))


def test_trainer_ep_refusals_in_the_jax_words():
    moe = TConfig(**moe_config(E=4).asdict())
    dense = TConfig(**moe_config(mlp_class_name="LLaMAMLP").asdict())
    _, tc = _tcs()
    cases = [(dense, {"dp": 2, "ep": 2}, ValueError, "'ep' mesh axis needs an MoE config"),
             (moe, {"dp": 1, "sp": 2, "ep": 2}, ValueError, r"ep composes with dp only \(ep×sp/pp"),
             (moe, {"dp": 1, "pp": 2, "ep": 2}, ValueError, r"ep composes with dp only"),
             (moe, {"ep": 3}, ValueError, "n_expert=4 not divisible by ep=3")]
    for cfg, axes, err, match in cases:
        with pytest.raises(err, match=match):
            ttr.Trainer(cfg, tc, mesh=make_mesh(axes, ["cpu"]), device="cpu")
    tr = ttr.Trainer(moe, tc, mesh=tmesh({"tp": 2, "ep": 2}), device="cpu")
    assert (tr.layout.tp, tr.layout.ep) == (2, 2)
    # over two processes each holds one tp rank with every expert (the
    # runs are tests/test_torch_ep_beside_procs.py's)
    with mock.patch("mdi_llm_tpu_torch.training.CommGroup") as group:
        lay = ttr.MeshLayout(make_mesh({"tp": 2, "ep": 2}, ["cpu"], process_id=0,
                                       num_processes=2))
    group.assert_called_once_with([0, 1])
    assert (lay.tp_local, lay.ep_local, lay.tp_group, lay.ep_group) == (
        1, 2, group.return_value, None)
    # the words are the JAX Trainer's own
    for cfg, axes in ((moe_config(mlp_class_name="LLaMAMLP"), {"dp": 2, "ep": 2}),
                      (moe_config(E=4), {"dp": 1, "sp": 2, "ep": 2})):
        with pytest.raises(ValueError, match="'ep' mesh axis needs|ep composes with dp only"):
            jtr.Trainer(cfg, _tcs()[0], mesh=jmesh.make_mesh(axes, jax.devices()[:4]))


@pytest.mark.parametrize("cf", [None, 0.5])
def test_ep_trainer_steps_equal_the_jax_ep_trainers(devices, cf):
    """Three float32 steps on a (dp 2, ep 4) mesh with the aux weighted:
    the JAX ep Trainer's losses and parameters (tests/test_training.py's
    mesh tolerance), at exact capacity and with drops (cf 0.5)."""
    cfg = moe_config(E=8, k=2, n_layer=2)
    jp, tp = model(cfg, 9)
    jt, tc = _tcs(batch_size=4, block_size=16, moe_aux_weight=0.05, moe_capacity_factor=cf,
                  use_flash=False, remat=False)
    rng = np.random.default_rng(9)
    batches = [tuple(rng.integers(0, cfg.vocab_size, (1, 4, 16)).astype(np.int32)
                     for _ in range(2)) for _ in range(3)]
    jtrainer = jtr.Trainer(cfg, jt, mesh=jmesh.make_mesh({"dp": 2, "ep": 4}, devices), params=jp)
    want = [jtrainer.train_step(x, y) for x, y in batches]
    tr = ttr.Trainer(TConfig(**cfg.asdict()), tc, mesh=tmesh({"dp": 2, "ep": 4}), params=tp,
                     device="cpu")
    got = [tr.train_step(x, y) for x, y in batches]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for a, b in zip(ttf.tree_leaves(tr._standard_params()),
                    jax.tree_util.tree_leaves(jtrainer.params)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=2e-4, atol=2e-5)
    # each step: every dp row's attention runs every layer once
    assert tr.layer_runs == 3 * cfg.n_layer * 2


# ---------------------------------------------------------------------------
# sample / chat --ep-devices against the JAX CLIs, on a converted checkpoint
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mixtral_ckpt(tmp_path_factory):
    """(the port's converted dir, the JAX package's): a tiny Mixtral written
    by `transformers` with a word-level tokenizer."""
    transformers = pytest.importorskip("transformers")
    pytest.importorskip("tokenizers")
    import json

    from tokenizers import Tokenizer as HFTok
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace

    from mdi_llm_tpu.utils import checkpoint as jck
    from mdi_llm_tpu_torch.cli import prepare_model

    root = tmp_path_factory.mktemp("mixtral")
    hf = root / "hf"
    torch.manual_seed(0)
    transformers.MixtralForCausalLM(transformers.MixtralConfig(
        vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, num_local_experts=4,
        num_experts_per_tok=2, max_position_embeddings=128,
        tie_word_embeddings=False)).save_pretrained(hf)
    vocab = {"<s>": 0, "</s>": 1, **{f"w{i}": i for i in range(2, 96)}}
    tok = HFTok(WordLevel(vocab, unk_token="</s>"))
    tok.pre_tokenizer = Whitespace()
    tok.save(str(hf / "tokenizer.json"))
    (hf / "tokenizer_config.json").write_text(
        json.dumps({"bos_token": "<s>", "eos_token": "</s>", "add_bos_token": True}))
    port_dir, jax_dir = root / "port", root / "jax"
    shutil.copytree(hf, port_dir)
    shutil.copytree(hf, jax_dir)
    jck.convert_hf_checkpoint(jax_dir, dtype=jnp.float32)
    prepare_model.main([str(port_dir), "--dtype", "float32"])
    return port_dir, jax_dir


RUN = ["--device", "cpu", "--dtype", "float32", "--sequence-length", "64"]


def test_sample_cli_ep_devices_gives_the_jax_clis_streams(mixtral_ckpt, devices):
    from mdi_llm_tpu.cli import sample as jsample
    from mdi_llm_tpu_torch.cli import sample as tsample

    port_dir, jax_dir = mixtral_ckpt
    flags = ["--greedy", "--n-tokens", "8", "--prompt", "w5 w17 w33 w2", "--ep-devices", "2"]
    got = tsample.main(RUN + ["--ckpt", str(port_dir)] + flags)
    want = jsample.main(RUN + ["--ckpt", str(jax_dir)] + flags)
    assert got == want
    assert tsample.main(RUN + ["--ckpt", str(port_dir)] + flags[:-2]) == got
    with pytest.raises(SystemExit, match="at least 2 devices"):
        tsample.main(RUN + ["--ckpt", str(port_dir)] + flags[:-1] + ["1"])


def test_chat_cli_ep_devices_gives_the_jax_clis_replies(mixtral_ckpt, devices, monkeypatch,
                                                       capsys):
    """Two turns through `chat --ep-devices 2`: the JAX CLI's printed
    conversation, character for character."""
    from mdi_llm_tpu.cli import chat as jchat
    from mdi_llm_tpu_torch.cli import chat as tchat

    port_dir, jax_dir = mixtral_ckpt
    turns = "w5 w6 w7 w8\nw9 w10\n"
    flags = ["--temperature", "0", "--n-tokens", "8", "--ep-devices", "2"]
    monkeypatch.setattr(sys, "stdin", io.StringIO(turns))
    jchat.main(RUN + ["--ckpt", str(jax_dir)] + flags)
    want = capsys.readouterr().out
    monkeypatch.setattr(sys, "stdin", io.StringIO(turns))
    session = tchat.main(RUN + ["--ckpt", str(port_dir)] + flags)
    assert session.gen._moe_impl is not None and len(session.history) > 8
    assert capsys.readouterr().out == want
