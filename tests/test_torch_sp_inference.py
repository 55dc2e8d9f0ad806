"""The port's sequence-parallel inference (`parallel/sp_inference.py`:
`SPGenerator`, `SPChatSession`; `models/transformer.SPRanks`) against the
JAX package's, on the CPU.

One counterpart for each test of tests/test_sp_inference.py, on the same
float32 weights (JAX `init_params`, moved over by `params_from_numpy`) of
`tiny_config`.  The JAX `SPGenerator` runs on the virtual CPU devices of
tests/conftest.py; the port's sp ranks all sit on the CPU.  Greedy streams
equal the JAX `SPGenerator`'s and the port's `Generator`'s: sp 2 and 4,
stop sequences, a context beyond one shard, a prompt shorter than the
mesh, the cache-full boundary (with the slot -> position map), a
mixed-length batch, the flash route (K2's plain version counted, P^2 per
layer when the local chunk reaches `flash_min_len`), GQA, int8 weights,
`generate_chat`, and the chat session's turns, stop rollback, window
rebuild, Ctrl-C rollback and speculative stream.  Sampled decoding draws
from the Generator's distribution; the sample and chat CLIs run
`--sp-devices`.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdi_llm_tpu.models import init_params as jinit_params
from mdi_llm_tpu.parallel.sp_inference import POS_SENTINEL as JPOS_SENTINEL
from mdi_llm_tpu.parallel.sp_inference import SPGenerator as JSPGenerator
from mdi_llm_tpu_torch.config import Config as TConfig
from mdi_llm_tpu_torch.convert import params_from_numpy
from mdi_llm_tpu_torch.generation import Generator, _bucket
from mdi_llm_tpu_torch.ops import flash as tflash
from mdi_llm_tpu_torch.parallel.mesh import make_mesh
from mdi_llm_tpu_torch.parallel import sp_inference
from mdi_llm_tpu_torch.parallel.sp_inference import POS_SENTINEL, SPGenerator
from tests.test_model import CONFIG_VARIANTS, tiny_config

torch.set_num_threads(1)
PROMPTS = [[3, 1, 4, 1, 5, 9, 2], [2, 7]]
GREEDY = dict(temperature=0.0)


def _pair(seed, **kw):
    jc = tiny_config(**kw)
    jp = jinit_params(jc, jax.random.PRNGKey(seed))
    return jc, jp, TConfig(**jc.asdict()), params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))


@pytest.fixture(scope="module")
def model():
    return _pair(5, block_size=256, n_layer=3)


def _sp(model, n, **kw):
    return SPGenerator(model[2], model[3], n_devices=n, devices=["cpu"],
                       cache_dtype=torch.float32, **kw)


def _jsp(model, devices, n, **kw):
    return JSPGenerator(model[0], model[1], devices=devices[:n], cache_dtype=jnp.float32, **kw)


def _single(model, **kw):
    return Generator(model[2], model[3], cache_dtype=torch.float32, device="cpu", **kw)


@pytest.mark.parametrize("n_devices", [2, 4])
def test_sp_generation_matches_single_device(model, n_devices, devices):
    want, _ = _single(model).generate(PROMPTS, 12, **GREEDY)
    got, stats = _sp(model, n_devices).generate(PROMPTS, 12, **GREEDY)
    jgot, _ = _jsp(model, devices, n_devices).generate(PROMPTS, 12, **GREEDY)
    assert got == want == jgot
    assert stats.tokens_generated == 24


def test_sp_stop_sequences(model, devices):
    single = _single(model)
    free, _ = single.generate(PROMPTS[:1], 12, **GREEDY)
    stop = [free[0][len(PROMPTS[0]) + 4: len(PROMPTS[0]) + 6]]
    want, _ = single.generate(PROMPTS[:1], 12, stop_sequences=stop, **GREEDY)
    got, _ = _sp(model, 2).generate(PROMPTS[:1], 12, stop_sequences=stop, **GREEDY)
    jgot, _ = _jsp(model, devices, 2).generate(PROMPTS[:1], 12, stop_sequences=stop, **GREEDY)
    assert got == want == jgot


def test_sp_long_context_beyond_one_shard(model, devices):
    """The whole sequence exceeds each rank's shard: C < prompt + new."""
    n_dev, new = 4, 16
    prompt = np.random.default_rng(0).integers(1, 50, 120).tolist()
    want, _ = _single(model).generate([prompt], new, **GREEDY)
    sp = _sp(model, n_dev)
    got, _ = sp.generate([prompt], new, **GREEDY)
    jgot, _ = _jsp(model, devices, n_dev).generate([prompt], new, **GREEDY)
    assert got == want == jgot
    Tl = -(-_bucket(len(prompt)) // n_dev)
    C = Tl + -(-new // n_dev)
    assert C < len(prompt) + new and sp.slot_owner_map().shape == (1, n_dev, C)


def test_sp_prompt_shorter_than_mesh(model, devices):
    """3 tokens over 8 ranks: most shards hold only empty slots after the
    prefill."""
    want, _ = _single(model).generate([[7, 3, 2]], 10, **GREEDY)
    got, _ = _sp(model, 8).generate([[7, 3, 2]], 10, **GREEDY)
    jgot, _ = _jsp(model, devices, 8).generate([[7, 3, 2]], 10, **GREEDY)
    assert got == want == jgot


@pytest.mark.parametrize("new", [16, 17, 15])
def test_sp_cache_full_boundary(model, new, devices):
    """Round-robin appends up to the last local slot (new % P == 0), one
    past a row boundary and one short of it; the slot -> position map is
    the owner arithmetic's, and the JAX SPGenerator's."""
    n_dev = 4
    want, _ = _single(model).generate(PROMPTS[:1], new, **GREEDY)
    sp, jsp = _sp(model, n_dev), _jsp(model, devices, n_dev)
    got, _ = sp.generate(PROMPTS[:1], new, **GREEDY)
    jgot, _ = jsp.generate(PROMPTS[:1], new, **GREEDY)
    assert got == want == jgot
    L = len(PROMPTS[0])
    Tl = -(-_bucket(L) // n_dev)
    C = Tl + -(-new // n_dev)
    want_map = np.full((n_dev, C), POS_SENTINEL, np.int64)
    for d in range(n_dev):
        for j in range(C):
            if j < Tl:
                if d * Tl + j < L:
                    want_map[d, j] = d * Tl + j
            elif (j - Tl) * n_dev + d < new - 1:
                want_map[d, j] = L + (j - Tl) * n_dev + d
    kp = sp.slot_owner_map()
    np.testing.assert_array_equal(kp[0], want_map)
    np.testing.assert_array_equal(kp, jsp.slot_owner_map().astype(np.int64))
    assert POS_SENTINEL == int(JPOS_SENTINEL)


def test_sp_mixed_length_batch(model, devices):
    """Samples whose last prompt tokens sit on different ranks."""
    prompts = [[5] * 2, [6] * 19, [7] * 11]
    want, _ = _single(model).generate(prompts, 8, **GREEDY)
    got, _ = _sp(model, 4).generate(prompts, 8, **GREEDY)
    jgot, _ = _jsp(model, devices, 4).generate(prompts, 8, **GREEDY)
    assert got == want == jgot


def test_sp_prefill_use_flash_counts_kernel(model, devices):
    """`use_flash` ("force" too) sends the prefill ring through K2 (its
    plain version on the CPU) once the LOCAL chunk reaches
    `flash_min_len`: P^2 launches per layer; a shorter chunk stays on the
    plain ring; the default is off.  The streams are the plain ring's."""
    cfg = model[2]
    prompt = list(range(1, 30))  # bucket 32: local chunk 16 over 2 ranks
    want, _ = _single(model).generate([prompt], 6, **GREEDY)
    for use_flash in (True, "force"):
        sp = _sp(model, 2, use_flash=use_flash, flash_min_len=16)
        assert sp.use_flash is True
        tflash.flash_attention_plain.calls = 0
        got, _ = sp.generate([prompt], 6, **GREEDY)
        assert got == want and tflash.flash_attention_plain.calls == 4 * cfg.n_layer
    tflash.flash_attention_plain.calls = 0
    got, _ = _sp(model, 2, use_flash=True, flash_min_len=32).generate([prompt], 6, **GREEDY)
    assert got == want and tflash.flash_attention_plain.calls == 0
    assert _sp(model, 2).use_flash is False
    # the JAX flash ring runs only on a TPU (its test traces it): its
    # plain ring's streams
    jgot, _ = _jsp(model, devices, 2).generate([prompt], 6, **GREEDY)
    assert jgot == want


def test_sp_gqa_variant(devices):
    m = _pair(6, block_size=128, n_layer=3, **CONFIG_VARIANTS["gqa"])
    prompt = [[4, 8, 15, 16, 23, 42]]
    want, _ = _single(m).generate(prompt, 10, **GREEDY)
    got, _ = _sp(m, 4).generate(prompt, 10, **GREEDY)
    jgot, _ = _jsp(m, devices, 4).generate(prompt, 10, **GREEDY)
    assert got == want == jgot


def test_sp_quantized_decode_parity(model, devices):
    """int8 weights on every rank reproduce the quantized single device."""
    want, _ = _single(model, quantize="int8").generate(PROMPTS, 10, **GREEDY)
    got, _ = _sp(model, 4, quantize="int8").generate(PROMPTS, 10, **GREEDY)
    jgot, _ = _jsp(model, devices, 4, quantize="int8").generate(PROMPTS, 10, **GREEDY)
    assert got == want == jgot
    with pytest.raises(ValueError, match="quantize"):
        _sp(model, 2, quantize="int3")


def test_sp_generate_chat_streams_same_tokens(model, devices):
    """`generate_chat` yields the greedy `generate` tail, stop filtering
    included, over several decode chunks."""
    prompt = [3, 1, 4, 1, 5]
    sp = _sp(model, 4, decode_chunk=3)
    want, _ = sp.generate([prompt], 11, **GREEDY)
    assert list(sp.generate_chat(prompt, 11, **GREEDY)) == want[0][len(prompt):]
    stop = [want[0][len(prompt) + 3: len(prompt) + 5]]
    want_stop, _ = sp.generate([prompt], 11, stop_sequences=stop, **GREEDY)
    got = list(sp.generate_chat(prompt, 11, stop_sequences=stop, **GREEDY))
    jgot = list(_jsp(model, devices, 4, decode_chunk=3).generate_chat(
        prompt, 11, stop_sequences=stop, **GREEDY))
    assert got == want_stop[0][len(prompt):] == jgot


def test_sp_sampled_is_seeded_and_draws_the_single_distribution(model):
    """Sampled decoding draws from the rank-0 device's generator: two runs
    with one seed agree; the first token's frequencies over 400 seeds
    follow the single device's softmax (top-k 4, temperature 0.8)."""
    a, _ = _sp(model, 2, rng_seed=3).generate(PROMPTS, 6, temperature=0.8)
    b, _ = _sp(model, 2, rng_seed=3).generate(PROMPTS, 6, temperature=0.8)
    assert a == b
    single = _single(model)
    logits = single._prefill(np.asarray([PROMPTS[0]]), single._init_kv(1, 256), [7])
    probs = torch.softmax(torch.topk(logits[0].float() / 0.8, 4).values, -1).numpy()
    top = torch.topk(logits[0].float(), 4).indices.tolist()
    sp = _sp(model, 2)
    counts = np.zeros(4)
    for seed in range(400):
        sp.rng.manual_seed(seed)
        t = sp.generate([PROMPTS[0]], 1, temperature=0.8, top_k=4)[0][0][-1]
        counts[top.index(t)] += 1
    assert np.abs(counts / 400 - probs).max() < 0.08


# ---------------------------------------------------------------------------
# SPChatSession
# ---------------------------------------------------------------------------


def _single_baseline(model, history, turn, n, stop=()):
    return list(_single(model).generate_chat(history + turn, n, stop_sequences=stop, **GREEDY))


@pytest.mark.parametrize("n_devices", [2, 4])
def test_sp_chat_session_matches_single_device(model, n_devices, devices):
    sess = _sp(model, n_devices).chat_session()
    jsess = _jsp(model, devices, n_devices).chat_session()
    history: list = []
    for turn in ([3, 1, 4, 1, 5], [9, 2], [6, 5, 3, 5]):
        want = _single_baseline(model, history, turn, 8)
        got = list(sess.send(turn, 8, **GREEDY))
        assert got == want == list(jsess.send(turn, 8, **GREEDY)), f"turn {turn}"
        history += turn + want
        assert sess.history == history


def test_sp_chat_session_stop_rollback_clears_kp(model, devices):
    free = _single_baseline(model, [], [9, 9, 1], 10)
    stop = [[free[3]]]
    sess = _sp(model, 2).chat_session()
    jsess = _jsp(model, devices, 2).chat_session()
    history: list = []
    for turn, st in (([9, 9, 1], stop), ([4, 2, 8], ()), ([1, 3], stop)):
        want = _single_baseline(model, history, turn, 10, st)
        got = list(sess.send(turn, 10, stop_sequences=st, **GREEDY))
        assert got == want == list(jsess.send(turn, 10, stop_sequences=st, **GREEDY))
        history += turn + want
        assert sess.history == history
        # every stamped slot holds a live position of the conversation
        live = torch.cat(sess._kp, dim=1)
        assert int((live < POS_SENTINEL).sum()) == sess._pos


def test_sp_chat_session_window_rebuild(model, devices):
    """Outgrowing max_seq_length rebuilds by a ring prefill over the slid
    window and matches a stateless run over that window."""
    sess = _sp(model, 2, max_seq_length=64).chat_session()
    jsess = _jsp(model, devices, 2, max_seq_length=64).chat_session()
    for i in range(5):  # 5 x (4 + 8) tokens overflow 64
        turn = [2 + i, 3 + i, 5 + i, 7 + i]
        got = list(sess.send(turn, 8, **GREEDY))
        assert got == list(jsess.send(turn, 8, **GREEDY)), f"turn {i}"
        prompt = sess.history[: len(sess.history) - len(got)]
        assert prompt[-len(turn):] == turn
        assert got == _single_baseline(model, prompt[: -len(turn)], turn, 8), f"turn {i}"
    assert len(sess.history) <= 64


def test_sp_chat_session_rollback(model):
    sess = _sp(model, 2).chat_session()
    _ = list(sess.send([5, 6, 7], 6, **GREEDY))
    pre = sess.history[:]
    it = sess.send([11, 2], 8, **GREEDY)
    partial = [next(it), next(it)]
    sess.rollback(pre + [11, 2] + partial)
    want = _single_baseline(model, pre + [11, 2] + partial, [4, 4], 6)
    assert list(sess.send([4, 4], 6, **GREEDY)) == want


@pytest.mark.parametrize("n_devices", [2, 4])
def test_sp_chat_session_speculative_matches_plain(model, n_devices):
    plain = _sp(model, n_devices).chat_session()
    spec = _sp(model, n_devices).chat_session()
    for turn in ([5, 6, 7, 5, 6], [5, 6, 7, 5], [9, 1, 5, 6]):
        want = list(plain.send(turn, 9, **GREEDY))
        got = list(spec.send(turn, 9, speculative=3, **GREEDY))
        assert got == want, f"turn {turn}"
        assert len(got) <= 9 and spec.history == plain.history


def test_sp_chat_session_speculative_stop_rollback(model, devices):
    """A speculative burst cut by a stop marker clears both the rejected
    drafts' slots and the stop-trimmed slots: later turns stay the plain
    session's (and the JAX speculative session's)."""
    free = list(_sp(model, 2).chat_session().send([9, 9, 1], 10, **GREEDY))
    stop = [[free[3]]]
    plain = _sp(model, 2).chat_session()
    spec = _sp(model, 2).chat_session()
    jspec = _jsp(model, devices, 2).chat_session()
    for turn, st in (([9, 9, 1], stop), ([9, 9, 1, 4], ()), ([1, 3], stop)):
        want = list(plain.send(turn, 10, stop_sequences=st, **GREEDY))
        got = list(spec.send(turn, 10, stop_sequences=st, speculative=3, **GREEDY))
        jgot = list(jspec.send(turn, 10, stop_sequences=st, speculative=3, **GREEDY))
        assert got == want == jgot, f"turn {turn}"
        assert spec.history == plain.history


def test_sp_refusals(model):
    """An sp mesh over processes is accepted (the process holds its ranks:
    the group's collectives run in `tests/test_torch_sp_ep_inference_procs.py`);
    a mesh with another axis above size 1 is refused."""
    mesh = make_mesh({"sp": 4}, ["cpu"], process_id=1, num_processes=2)
    with mock.patch.object(sp_inference, "CommGroup") as group:
        gen = SPGenerator(model[2], model[3], mesh=mesh)
    group.assert_called_once_with(range(2))
    assert (gen.P, gen.local, gen.ranks.P) == (4, [2, 3], 2)
    with pytest.raises(ValueError, match="no other axis"):
        SPGenerator(model[2], model[3], mesh=make_mesh({"sp": 2, "tp": 2}, ["cpu"]))


def test_sample_cli_sp_devices_generates_the_single_streams():
    """`sample --sp-devices 2` (and with `--sp-flash`) prints the single
    device's greedy float32 streams."""
    from mdi_llm_tpu_torch.cli import sample as cli

    base = ["--device", "cpu", "--model", "pythia-14m", "--greedy", "--dtype", "float32",
            "--n-samples", "2", "--n-tokens", "6"]
    want = cli.main(base)
    assert cli.main(base + ["--sp-devices", "2"]) == want
    assert cli.main(base + ["--sp-devices", "4", "--sp-flash"]) == want
    with pytest.raises(SystemExit, match="exclusive"):
        cli.main(base + ["--sp-devices", "2", "--pipeline-stages", "2"])
