"""Expert parallelism beside tp and dp in the port's Generator, against the
JAX package's, on the CPU, in float32.

The same draws go through the JAX `Generator` on the 8 virtual CPU
devices and through the port's on the CPU, each JAX reference computed
once per (mesh, weights) in a module-scoped cache:

- the port's per-position trees on {"ep": 2, "tp": 2} are the JAX
  `shard_params(..., "tp", "ep")` slices (experts on ep, whole over tp;
  qkv, proj, wte and lm_head on tp), and a quantized tree's are the JAX
  `_place_ep_quantized` ones (experts on ep, every other leaf whole);
- greedy streams on ep 2 x tp 2, dp 2 x ep 2 and dp 2 x ep 2 x tp 2 equal
  the JAX Generator's on the same mesh and the port's dense ones, over
  the float, int8, w8a8 and int4 trees and a pre-quantized one;
- dp 2 x ep 2 at capacity factor 0.5 routes the whole batch as the JAX
  dispatch does: its streams equal the JAX Generator's and the port's ep
  2 at that factor, and differ from the dense ones and from the
  replicas routed apart;
- `ChatSession` on ep 2 x tp 2 equals the dense full-history re-prefill;
- what stays refused: serving on any ep mesh, ep beside a pipeline axis,
  a dp axis split over processes; ep beside tp over two processes builds
  its ep group (the runs are tests/test_torch_ep_beside_procs.py's).
"""

from unittest import mock

import jax
import numpy as np
import pytest
import torch

from mdi_llm_tpu.generation import Generator as JGenerator
from mdi_llm_tpu.generation import _place_ep_quantized
from mdi_llm_tpu.models import transformer as jtf
from mdi_llm_tpu.ops import quant as jq
from mdi_llm_tpu.parallel import mesh as jmesh
from mdi_llm_tpu.parallel import sharding as jsharding
from mdi_llm_tpu_torch.config import Config as TConfig
from mdi_llm_tpu_torch.convert import params_from_numpy
from mdi_llm_tpu_torch.generation import Generator
from mdi_llm_tpu_torch.models import transformer as ttf
from mdi_llm_tpu_torch.ops import quant as tq
from mdi_llm_tpu_torch.parallel import expert as texpert
from mdi_llm_tpu_torch.parallel import sharding as tsharding
from mdi_llm_tpu_torch.parallel.mesh import make_mesh
from tests.test_expert import moe_config

torch.set_num_threads(1)
GREEDY = dict(temperature=0.0)
PROMPTS = [[3, 7, 11, 2], [5, 1, 9, 13, 4]]
MESHES = {"ep2-tp2": {"ep": 2, "tp": 2}, "dp2-ep2": {"dp": 2, "ep": 2},
          "dp2-ep2-tp2": {"dp": 2, "ep": 2, "tp": 2}}
MODES = [None, "int8", "w8a8", "int4", "prequantized"]
# four prompts on which capacity factor 0.5 drops assignments that move
# the greedy streams (found by a search over prompt seeds)
CF_PROMPTS = (lambda rng: [[int(t) for t in rng.integers(0, 128, int(rng.integers(5, 14)))]
                           for _ in range(4)])(np.random.default_rng(1))


def tmesh(axes):
    return make_mesh(axes, ["cpu"])


def jax_mesh(axes):
    n = int(np.prod(list(axes.values())))
    return jmesh.make_mesh(axes, jax.devices()[:n])


@pytest.fixture(scope="module")
def moe_model():
    cfg = moe_config()
    jp = jtf.init_params(cfg, jax.random.PRNGKey(1))
    return cfg, jp, TConfig(**cfg.asdict()), params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp))


def _trees(moe_model, mode):
    cfg, jp, tc, tp = moe_model
    if mode == "prequantized":
        return jq.quantize_params(jp), tq.quantize_params(tp), None
    return jp, tp, mode


@pytest.fixture(scope="module")
def jax_streams(moe_model, devices):
    """{(mesh id, mode, capacity factor, prompts id): the JAX Generator's
    greedy streams}, each computed once for the module."""
    cache = {}

    def get(mesh_id, mode, cf=None, prompts="base"):
        key = (mesh_id, mode, cf, prompts)
        if key not in cache:
            jp, _, q = _trees(moe_model, mode)
            gen = JGenerator(moe_model[0], jp, max_seq_length=64, quantize=q,
                             mesh=jax_mesh(MESHES[mesh_id]), moe_capacity_factor=cf)
            cache[key] = gen.generate(PROMPTS if prompts == "base" else CF_PROMPTS, 10,
                                      **GREEDY)[0]
        return cache[key]

    return get


def _shard_of(arr, device):
    return next(np.asarray(s.data) for s in arr.addressable_shards if s.device == device)


def test_shard_params_on_ep_tp_are_the_jax_slices(moe_model, devices):
    """Each position's tree on {"ep": 2, "tp": 2} holds the JAX layout's
    shard on that position's device, leaf for leaf: experts on axis 1 by
    the ep coordinate, whole over tp; the Megatron leaves by the tp
    coordinate.  A quantized tree on an ep mesh takes the JAX
    `_place_ep_quantized` layout: experts on ep, every other leaf whole."""
    cfg, jp, tc, tp = moe_model
    axes = {"ep": 2, "tp": 2}
    jm = jax_mesh(axes)
    want = jsharding.shard_params(jp, cfg, jm, "tp", "ep")
    got = tsharding.shard_params(tp, tc, tmesh(axes), "tp", "ep")
    coords = list(tmesh(axes).positions())
    for i, dev in enumerate(jm.devices.flat):
        for a, b in zip(ttf.tree_leaves(got[i]), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(a.numpy(), _shard_of(b, dev))
        e, t = coords[i]["ep"], coords[i]["tp"]
        fc1 = got[i]["blocks"]["mlp"]["experts"]["fc_1"]["weight"]
        whole = tp["blocks"]["mlp"]["experts"]["fc_1"]["weight"]
        assert torch.equal(fc1, whole[:, 4 * e:4 * e + 4])
        qkv = tp["blocks"]["attn"]["qkv"]["weight"]
        n = qkv.shape[1] // 2
        assert torch.equal(got[i]["blocks"]["attn"]["qkv"]["weight"], qkv[:, t * n:(t + 1) * n])
        for name in ("wte", "lm_head"):
            w = tp[name]["weight"]
            v = w.shape[0] // 2
            assert torch.equal(got[i][name]["weight"], w[t * v:(t + 1) * v])
        proj = tp["blocks"]["attn"]["proj"]["weight"]
        assert torch.equal(got[i]["blocks"]["attn"]["proj"]["weight"],
                           proj[..., t * proj.shape[-1] // 2:(t + 1) * proj.shape[-1] // 2])
    jq8, tq8 = jq.quantize_params(jp), tq.quantize_params(tp)
    want = _place_ep_quantized(jq8, jm, cfg.n_expert)
    got = texpert.place_ep(tq8, tmesh(axes), cfg.n_expert)
    for i, dev in enumerate(jm.devices.flat):
        for a, b in zip(ttf.tree_leaves(got[i]), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(a.numpy(), _shard_of(b, dev))
    # the Trainer's split dims beside ep: the experts whole over tp
    dims = tsharding.split_dims(tc, tp, ep_axis="ep")
    assert dims["blocks"]["mlp"]["experts"]["fc_1"]["weight"] is None
    assert dims["blocks"]["attn"]["qkv"]["weight"] == 1


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh_id", list(MESHES))
def test_generator_ep_beside_greedy_equals_jax_and_dense(moe_model, jax_streams, mesh_id, mode):
    _cfg, _jp, tc, _tp = moe_model
    _, tp, q = _trees(moe_model, mode)
    dense = Generator(tc, tp, max_seq_length=64, device="cpu", quantize=q)
    gen = Generator(tc, tp, max_seq_length=64, device="cpu", quantize=q,
                    mesh=tmesh(MESHES[mesh_id]))
    assert gen._moe_impl is not None and gen.dp == MESHES[mesh_id].get("dp", 1)
    # a float tree runs the tp ranks per dp replica; a quantized one is
    # whole beside the experts, as the JAX `_place_ep_quantized` lays it
    assert (gen._shards is None) == (mode is not None)
    got, _ = gen.generate(PROMPTS, 10, **GREEDY)
    assert got == jax_streams(mesh_id, mode) == dense.generate(PROMPTS, 10, **GREEDY)[0]


def test_dp_ep_routes_the_whole_batch_at_capacity_factor(moe_model, jax_streams):
    """dp 2 x ep 2 at capacity factor 0.5: the JAX Generator's streams and
    the port's ep 2 at that factor (one dispatch over every replica's
    rows), not the dense ones, and not the replicas routed apart."""
    _cfg, _jp, tc, tp = moe_model
    gen = Generator(tc, tp, max_seq_length=64, device="cpu", mesh=tmesh({"dp": 2, "ep": 2}),
                    moe_capacity_factor=0.5)
    ep = Generator(tc, tp, max_seq_length=64, device="cpu", mesh=tmesh({"ep": 2}),
                   moe_capacity_factor=0.5)
    got = gen.generate(CF_PROMPTS, 10, **GREEDY)[0]
    assert got == jax_streams("dp2-ep2", None, 0.5, "cf") == ep.generate(CF_PROMPTS, 10,
                                                                          **GREEDY)[0]
    dense = Generator(tc, tp, max_seq_length=64, device="cpu")
    assert got != dense.generate(CF_PROMPTS, 10, **GREEDY)[0]
    apart = [ep.generate(CF_PROMPTS[2 * d:2 * d + 2], 10, **GREEDY)[0] for d in range(2)]
    assert got != apart[0] + apart[1]


def test_chat_session_on_ep_tp_mesh(moe_model):
    """Cross-turn KV reuse over ep 2 x tp 2: token-identical to a dense
    full-history re-prefill every turn."""
    _cfg, _jp, tc, tp = moe_model
    single = Generator(tc, tp, max_seq_length=64, device="cpu")
    sess = Generator(tc, tp, max_seq_length=64, device="cpu",
                     mesh=tmesh({"ep": 2, "tp": 2})).chat_session()
    history = []
    for turn in ([3, 7, 11], [2, 5]):
        want = list(single.generate_chat(history + turn, 8, **GREEDY))
        assert list(sess.send(turn, 8, **GREEDY)) == want
        history += turn + want


@pytest.mark.parametrize("mesh_id", list(MESHES))
def test_ep_beside_guards(moe_model, mesh_id):
    """Serving refuses every ep mesh (the JAX engine's message, naming dp
    first where the mesh has one); ep beside
    a pipeline axis is refused; over two processes each holds whole dp
    replicas: ep 2 x tp 2 builds its ep group (one ep rank with its tp
    group per process; the runs are tests/test_torch_ep_beside_procs.py's),
    a mesh whose processes would split the dp axis is refused."""
    _cfg, _jp, tc, tp = moe_model
    axes = MESHES[mesh_id]
    gen = Generator(tc, tp, max_seq_length=64, device="cpu", mesh=tmesh(axes))
    with pytest.raises(ValueError, match="serving does not support (dp|ep)=2"):
        gen.serve(block_size=8, max_batch=2)
    with pytest.raises(ValueError, match="not beside a pipeline axis"):
        Generator(tc, tp, max_seq_length=64, device="cpu", mesh=tmesh({"pp": 2, **axes}))
    procs = make_mesh(axes, ["cpu"], process_id=1, num_processes=2)
    if "dp" in axes:  # process 1 would hold dp row 1 only
        with pytest.raises(ValueError, match="split the tp and ep axes only, each holding "
                                             "whole dp replicas"):
            Generator(tc, tp, max_seq_length=64, device="cpu", mesh=procs)
        return
    with mock.patch("mdi_llm_tpu_torch.parallel.collectives.CommGroup") as group:
        gen = Generator(tc, tp, max_seq_length=64, device="cpu", mesh=procs)
    group.assert_called_once_with([0, 1])
    assert gen._ep_group is group.return_value and gen._group is None
    assert gen.tp == 2 and len(gen._shards) == 2 and not gen._graphs
    with pytest.raises(ValueError, match="serving does not support ep=2"):
        gen.serve(block_size=8, max_batch=2)
