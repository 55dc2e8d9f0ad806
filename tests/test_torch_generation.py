"""The port's sequential generation against the JAX package's, on the CPU.

JAX `init_params` weights go through `params_from_numpy` into the port;
both `Generator`s run in float32 with float32 caches.  Greedy token
streams must be identical to the JAX `Generator.generate` on pythia-14m
(MHA, LayerNorm, parallel residual, partial rope) and tiny-llama-1.1b
narrowed to 2 layers x 256 (GQA, head size 64 as in the full model):

- batched against single prompts, stop sequences, the sequence-length
  guard, a non-pow2 max_seq_length whose prompt bucket is clamped;
- batch compaction and the shared-prompt prefill;
- greedy speculative decoding against plain greedy;
- `generate_chat` against `generate`; `ChatSession` against a full
  re-prefill of the conversation every turn, across cache growth and
  after a rollback;
- the `use_flash=True, flash_min_len=16` route, which on the CPU runs
  kernel K2's plain version (its calls are counted) and gives the same
  streams;
- the sample CLI with `--device cpu`, and raising without it.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdi_llm_tpu import generation as jgen_mod
from mdi_llm_tpu.config import Config as JConfig
from mdi_llm_tpu.models import transformer as jtf
from mdi_llm_tpu_torch import generation as tgen_mod
from mdi_llm_tpu_torch.config import Config as TConfig
from mdi_llm_tpu_torch.convert import params_from_numpy
from mdi_llm_tpu_torch.generation import Generator, find_eot
from mdi_llm_tpu_torch.ops import flash as tflash

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
TINY = dict(n_layer=2, n_embd=256, n_head=4, n_query_groups=2,
            intermediate_size=512, vocab_size=512)
MODELS = {"pythia-14m": {}, "tiny-llama-1.1b": TINY}
GREEDY = dict(temperature=0.0)


class Pair:
    """One model in both packages, with one JAX Generator per setting (its
    jit cache is per instance) and the port's weights."""

    def __init__(self, name):
        self.jc = JConfig.from_name(name, **MODELS[name])
        self.tc = TConfig.from_name(name, **MODELS[name])
        self.jp = jtf.init_params(self.jc, jax.random.PRNGKey(0))
        self.tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, self.jp))
        self._jgens = {}

    def jgen(self, **kw):
        key = tuple(sorted(kw.items()))
        if key not in self._jgens:
            self._jgens[key] = jgen_mod.Generator(
                self.jc, self.jp, cache_dtype=jnp.float32, use_flash=False, **kw)
        return self._jgens[key]

    def tgen(self, **kw):
        kw.setdefault("device", "cpu")
        return Generator(self.tc, self.tp, cache_dtype=torch.float32, **kw)


@pytest.fixture(scope="module", params=list(MODELS))
def pair(request):
    return Pair(request.param)


@pytest.fixture(scope="module")
def pythia():
    return Pair("pythia-14m")


def prompts_of(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).tolist() for n in lens]


def test_batched_and_single_prompts_match_jax(pair):
    p0, p1 = prompts_of(pair.tc.vocab_size, (5, 2), seed=1)
    tg = pair.tgen()
    want, _ = pair.jgen().generate([p0, p1], 8, chunk_size=4, **GREEDY)
    both, stats = tg.generate([p0, p1], 8, chunk_size=4, **GREEDY)
    single = [tg.generate([p], 8, chunk_size=4, **GREEDY)[0][0] for p in (p0, p1)]
    assert both == want
    assert single == want
    assert stats.tokens_generated == 16 and len(stats.tok_time) == 8


def test_stop_sequences_match_jax(pair):
    (p,) = prompts_of(pair.tc.vocab_size, (4,), seed=2)
    tg = pair.tgen()
    free, _ = tg.generate([p], 10, chunk_size=4, **GREEDY)
    stop = [[free[0][4 + 2]], [free[0][4 + 5], free[0][4 + 6]]]
    want, _ = pair.jgen().generate([p], 10, chunk_size=4, stop_sequences=stop, **GREEDY)
    got, _ = tg.generate([p], 10, chunk_size=4, stop_sequences=stop, **GREEDY)
    assert got == want == [free[0][: 4 + 2]]


def test_sequence_length_guard(pythia):
    tg = pythia.tgen(max_seq_length=16)
    with pytest.raises(ValueError, match="exceeds max_seq_length"):
        tg.generate([[1] * 10], 20)


def test_non_pow2_max_seq_clamps_the_prompt_bucket(pythia):
    prompt = [1 + (i % 7) for i in range(40)]  # _bucket(40) = 64 > 50
    want, _ = pythia.jgen(max_seq_length=50).generate([prompt], 8, **GREEDY)
    got, _ = pythia.tgen(max_seq_length=50).generate([prompt], 8, **GREEDY)
    assert len(got[0]) == 48 and got == want


def test_batch_compaction_matches_jax(pair):
    tg = pair.tgen()
    prompts = [[i + 1, i + 2, i + 3] for i in range(8)]
    free = [tg.generate([p], 14, chunk_size=4, **GREEDY)[0][0] for p in prompts]
    stops = [[free[j][3 + 2 * (j + 1)]] for j in range(4)]  # staggered
    want, _ = pair.jgen().generate(prompts, 14, stop_sequences=stops, chunk_size=1,
                                   **GREEDY)
    assert want == [f[: 3 + find_eot(f[3:], stops)] for f in free]
    for chunk in (1, 4):
        got, stats = tg.generate(prompts, 14, stop_sequences=stops, chunk_size=chunk,
                                 **GREEDY)
        assert got == want
        assert stats.compactions >= 1  # the lane reclaim engaged
    nocompact, stats = tg.generate(prompts, 14, stop_sequences=stops, chunk_size=1,
                                   compact=False, **GREEDY)
    assert nocompact == want and stats.compactions == 0


def test_shared_prompt_prefill_matches_jax(pair):
    (p,) = prompts_of(pair.tc.vocab_size, (3,), seed=4)
    tg = pair.tgen()
    want, _ = pair.jgen().generate([p] * 4, 10, **GREEDY)
    shared, _ = tg.generate([p] * 4, 10, **GREEDY)
    per_lane, _ = tg.generate([p] * 4, 10, shared_prefill=False, **GREEDY)
    assert shared == per_lane == want == [want[0]] * 4


def test_speculative_matches_plain_greedy_and_jax(pair):
    prompt = [5, 9, 2, 7, 5, 9, 2, 7, 5, 9, 2, 7, 3]
    tg = pair.tgen()
    for n_tokens in (5, 17, 40):
        want, _ = pair.jgen().generate([prompt], n_tokens, chunk_size=4, **GREEDY)
        plain, _ = tg.generate([prompt], n_tokens, chunk_size=4, **GREEDY)
        spec, s = tg.generate([prompt], n_tokens, speculative=4, **GREEDY)
        assert spec == plain == want, f"n_tokens={n_tokens}"
        assert not s.interrupted
    # a stop inside a speculative burst trims like plain decode
    stop = [[want[0][len(prompt) + 7]]]
    plain, _ = tg.generate([prompt], 24, stop_sequences=stop, **GREEDY)
    spec, _ = tg.generate([prompt], 24, stop_sequences=stop, speculative=4, **GREEDY)
    assert spec == plain
    with pytest.raises(ValueError):
        tg.generate([prompt], 5, temperature=0.8, speculative=4)
    with pytest.raises(ValueError):
        tg.generate([prompt, prompt], 5, speculative=4, **GREEDY)


def test_generate_chat_streams_what_generate_returns(pair):
    (p,) = prompts_of(pair.tc.vocab_size, (6,), seed=5)
    tg = pair.tgen()
    batch, _ = tg.generate([p], 10, **GREEDY)
    free = list(tg.generate_chat(p, 10, **GREEDY))
    assert free == batch[0][6:]
    stop = [[free[3], free[4]]]
    want = list(pair.jgen().generate_chat(p, 10, stop_sequences=stop, **GREEDY))
    assert list(tg.generate_chat(p, 10, stop_sequences=stop, **GREEDY)) == want == free[:3]


def _reprefill(tg, history, turn, n, stop=()):
    """What a stateless chat pays every turn: the whole conversation."""
    return list(tg.generate_chat(history + turn, n, stop_sequences=stop, **GREEDY))


def test_chat_session_matches_full_reprefill_across_growth_and_rollback(pythia):
    tg = pythia.tgen()
    sess = tg.chat_session()
    jsess = pythia.jgen().chat_session()
    history, sizes = [], []
    turns = prompts_of(pythia.tc.vocab_size, (60, 60, 60), seed=6)
    for i, turn in enumerate(turns):
        stop = [[_reprefill(tg, history, turn, 40)[5]]] if i == 1 else ()
        want = _reprefill(tg, history, turn, 40, stop)
        got = list(sess.send(turn, 40, stop_sequences=stop, **GREEDY))
        assert got == want == list(jsess.send(turn, 40, stop_sequences=stop, **GREEDY))
        history += turn + want
        assert sess.history == history
        sizes.append(sess._cache_len)
    assert sizes[0] < sizes[-1], "the session cache never grew"
    # abandon a reply after 2 tokens, roll back, and carry on
    pre = sess.history[:]
    turn = [11, 2, 9]
    it = sess.send(turn, 8, **GREEDY)
    partial = [next(it), next(it)]
    sess.rollback(pre + turn + partial)
    want = _reprefill(tg, pre + turn + partial, [4, 4], 6)
    assert list(sess.send([4, 4], 6, **GREEDY)) == want
    assert sess.history == pre + turn + partial + [4, 4] + want


def test_chat_session_speculative_matches_plain(pair):
    tg = pair.tgen()
    plain, spec = tg.chat_session(), tg.chat_session()
    for turn in ([5, 6, 7, 5, 6], [5, 6, 7, 5], [9, 1, 5, 6]):
        want = list(plain.send(turn, 9, **GREEDY))
        assert list(spec.send(turn, 9, speculative=3, **GREEDY)) == want
        assert spec.history == plain.history
    with pytest.raises(ValueError, match="empty turn"):
        spec.send([], 4)
    with pytest.raises(ValueError, match="temperature=0"):
        spec.send([1], 4, temperature=0.8, speculative=3)


def test_flash_route_runs_k2_plain_version_with_the_same_streams(pair):
    prompts = prompts_of(pair.tc.vocab_size, (20, 13), seed=7)  # bucket 32
    want, _ = pair.jgen().generate(prompts, 8, **GREEDY)
    dense, _ = pair.tgen().generate(prompts, 8, **GREEDY)
    flash = pair.tgen(use_flash=True, flash_min_len=16)
    calls = tflash.flash_attention_plain.calls
    got, _ = flash.generate(prompts, 8, **GREEDY)
    assert tflash.flash_attention_plain.calls == calls + pair.tc.n_layer
    assert got == dense == want
    # a bucket below flash_min_len stays on the dense route
    calls = tflash.flash_attention_plain.calls
    pair.tgen(use_flash=True, flash_min_len=64).generate(prompts, 4, **GREEDY)
    assert tflash.flash_attention_plain.calls == calls


def test_sampling_runs_and_stays_in_the_vocabulary(pythia):
    tg = pythia.tgen(rng_seed=3)
    outs, _ = tg.generate([[1, 2, 3]] * 3, 12, temperature=0.9, top_k=20)
    outs_p, _ = tg.generate([[1, 2, 3]], 12, temperature=0.9, top_p=0.8)
    for o in outs + outs_p:
        assert len(o) == 15 and all(0 <= x < pythia.tc.padded_vocab_size for x in o)
    again, _ = pythia.tgen(rng_seed=3).generate([[1, 2, 3]] * 3, 12, temperature=0.9,
                                                top_k=20)
    assert again == outs  # one seeded generator: reproducible draws


def test_host_helpers_match_jax():
    rng = np.random.default_rng(8)
    for _ in range(50):
        toks = rng.integers(0, 4, rng.integers(0, 20)).tolist()
        stops = [rng.integers(0, 4, rng.integers(1, 3)).tolist() for _ in range(2)]
        k = int(rng.integers(1, 6))
        assert tgen_mod.ngram_draft(toks, k) == jgen_mod.ngram_draft(toks, k)
        assert tgen_mod.find_eot(toks, stops) == jgen_mod.find_eot(toks, stops)
        assert list(tgen_mod.stop_filtered_stream(iter(toks), stops)) == \
            list(jgen_mod.stop_filtered_stream(iter(toks), stops))
        draft = tgen_mod.pad_draft(toks[:k], k)
        assert draft == jgen_mod.pad_draft(toks[:k], k)
        g = rng.integers(0, 4, k + 1)
        assert tgen_mod.accept_draft(draft, g, k) == jgen_mod.accept_draft(draft, g, k)
    for n in (1, 16, 17, 100, 2048, 2049):
        assert tgen_mod._bucket(n) == jgen_mod._bucket(n)
        assert tgen_mod._cache_bucket(n) == jgen_mod._cache_bucket(n)
        assert tgen_mod._run_cache_len(1000, n, 64) == jgen_mod._run_cache_len(1000, n, 64)


@pytest.mark.parametrize("kw", [
    dict(quantize="int8"), dict(mesh={"tp": 2}), dict(scan_unroll=2), dict(abstract=True),
], ids=lambda kw: next(iter(kw)))
def test_generator_refuses_unported_options(pythia, kw):
    """Weight quantization and tp meshes are ported: `quantize="int8"`
    generates the JAX Generator's greedy tokens in the same mode, and a
    `make_mesh({"tp": 2})` mesh the JAX tp Generator's (a bare dict of
    axis sizes is not a mesh: refused by type); `abstract=True` builds on
    the meta device; the other options are still refused."""
    prompts = prompts_of(pythia.tc.vocab_size, (5, 2), seed=1)
    if "quantize" in kw:
        want, _ = pythia.jgen(**kw).generate(prompts, 8, chunk_size=4, **GREEDY)
        got, _ = pythia.tgen(**kw).generate(prompts, 8, chunk_size=4, **GREEDY)
        assert got == want
        return
    if "mesh" in kw:
        from mdi_llm_tpu.parallel.mesh import make_mesh as jmake_mesh
        from mdi_llm_tpu_torch.parallel.mesh import make_mesh

        want, _ = pythia.jgen(mesh=jmake_mesh(kw["mesh"], jax.devices()[:2])).generate(
            prompts, 8, chunk_size=4, **GREEDY)
        got, _ = pythia.tgen(mesh=make_mesh(kw["mesh"], ["cpu"])).generate(
            prompts, 8, chunk_size=4, **GREEDY)
        assert got == want
        with pytest.raises(TypeError, match="make_mesh"):
            pythia.tgen(**kw)
        return
    if "abstract" in kw:
        # ported: a trace-only Generator lives on the meta device, its
        # weights meta stubs; a CPU device beside it is a contradiction
        from mdi_llm_tpu_torch.analysis.plan import abstract_params

        with pytest.raises(ValueError, match="meta device"):
            pythia.tgen(**kw)
        gen = Generator(pythia.tc, abstract_params(pythia.tc, "float32"), abstract=True)
        assert gen.device.type == "meta" and gen.rng.device.type == "cpu"
        from mdi_llm_tpu_torch.models.transformer import tree_leaves

        assert {x.device.type for x in tree_leaves(gen.params)} == {"meta"}
        assert [s.name for s in gen.enumerate_executables(1, 8, 9, chunk_size=4)] == [
            "prefill(1,16)", "decode_chunk(1,4)"]
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pythia.tgen(**kw)


def test_float8_dense_cache_matches_jax(pythia):
    """--kv-dtype float8 on the sequential path: a dense e4m3 cache, cast
    on write and upcast at the read, gives the JAX Generator's greedy
    streams."""
    prompts = prompts_of(pythia.tc.vocab_size, (5, 3), seed=4)
    jg = jgen_mod.Generator(pythia.jc, pythia.jp, cache_dtype=jnp.float8_e4m3fn, use_flash=False)
    want, _ = jg.generate(prompts, 8, chunk_size=4, **GREEDY)
    got, _ = Generator(pythia.tc, pythia.tp, cache_dtype=torch.float8_e4m3fn,
                       device="cpu").generate(prompts, 8, chunk_size=4, **GREEDY)
    assert got == want


def _sample_cli(args):
    return subprocess.run(
        [sys.executable, "-m", "mdi_llm_tpu_torch.cli.sample", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT)),
    )


def test_sample_cli_runs_on_cpu_and_raises_without_a_gpu(tmp_path):
    run = ["--model", "pythia-14m", "--greedy", "--n-tokens", "8", "--n-samples", "2"]
    proc = _sample_cli(["--device", "cpu", *run, "--time-run", str(tmp_path / "s.csv")])
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count("(8 new tokens)") == 2
    assert "tok/s decode" in proc.stderr
    assert (tmp_path / "s.csv").read_text().startswith("timestamp,n_samples")
    if not torch.cuda.is_available():
        proc = _sample_cli(run)
        assert proc.returncode != 0
        assert "torch.cuda.is_available() is False" in proc.stderr


@pytest.mark.parametrize("flag", ["--pipeline-stages", "--sp-devices", "--tp-devices",
                                  "--ep-devices", "--coordinator", "--profile-dir"])
def test_sample_cli_refuses_unported_flags(flag, tmp_path):
    """Every flag is ported: the recurrent pipeline (`--pipeline-stages`),
    tensor parallelism (`--tp-devices`), sequence parallelism
    (`--sp-devices`), `--profile-dir` and `--coordinator` (here a job of
    one process; two are tests/test_torch_inference_procs.py's) run;
    expert parallelism (`--ep-devices`) refuses a dense config in the JAX
    CLI's words (its runs are tests/test_torch_expert.py's)."""
    from mdi_llm_tpu_torch.cli import sample as cli

    value = {"--profile-dir": str(tmp_path / "prof"),
             "--coordinator": "127.0.0.1:1"}.get(flag, "2")
    job = ["--process-id", "0", "--num-processes", "1"] if flag == "--coordinator" else []
    args = cli.build_parser().parse_args(
        ["--device", "cpu", "--model", "pythia-14m", "--n-tokens", "4", "--greedy", flag, value,
         *job])
    if flag in ("--pipeline-stages", "--profile-dir", "--tp-devices", "--coordinator",
                "--sp-devices"):
        _prompts, outs, stats, _gen, _tok, _s = cli.run(args)
        assert stats.tokens_generated == 4 and len(outs) == 1
        return
    with pytest.raises(SystemExit, match="needs a MoE config"):
        cli.run(args)
