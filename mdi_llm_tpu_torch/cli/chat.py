"""Interactive chat REPL of the port, streaming token output.

Port of `mdi_llm_tpu/cli/chat.py` for one device, a tensor-parallel mesh
(`--tp-devices N`, every rank on `--device`) and the recurrent
pipeline: each turn gets the model's prompt style, tokens print as they
decode (`StreamPrinter`: incremental re-decode, so multi-byte and merged
tokens print correctly, and stop-sequence prefixes are held back).  On
one device the conversation lives in one `ChatSession`, which keeps its
KV cache across turns and prefills only each new turn (a first turn whose
prompt bucket reaches 2048 prefills through kernel K2); Ctrl-C during a
reply rolls the session back to the conversation so far.  With
`--pipeline-stages S` the turns stream through an S-stage ring
(`parallel/pipeline.PipelineEngine`, `--rotations-per-call` rotations per
steady call), which re-prefills the window every turn, as the JAX
package's does.  With `--sp-devices N` the conversation lives in an
`SPChatSession` over N sequence-parallel ranks on `--device`
(`parallel/sp_inference.py`: the first turn's ring prefill writes each
rank's cache shard, later turns append round-robin; `--sp-flash` sends
the ring through K2, `--sp-chunk` decode steps per host read).  With
`--ep-devices N` (an MoE config) the `ChatSession` runs over N
expert-parallel ranks on `--device` (`parallel/expert.py`, at
`--moe-capacity-factor`).  An empty line or end of input ends the chat.

    python -m mdi_llm_tpu_torch.cli.chat --ckpt checkpoints/tiny-llama
    python -m mdi_llm_tpu_torch.cli.chat --device cpu --ckpt DIR --temperature 0
    python -m mdi_llm_tpu_torch.cli.chat --device cpu --ckpt DIR --pipeline-stages 2
    python -m mdi_llm_tpu_torch.cli.chat --device cpu --ckpt DIR --tp-devices 2
    python -m mdi_llm_tpu_torch.cli.chat --device cpu --ckpt DIR --sp-devices 2 --sp-flash
    python -m mdi_llm_tpu_torch.cli.chat --device cpu --ckpt MOE_DIR --ep-devices 2

Needs a checkpoint with a tokenizer (`--ckpt`).  Runs on the GPU unless
`--device cpu` is given; without a GPU and without that flag it raises.
As in the JAX CLI, one streaming backend at a time.
"""

from __future__ import annotations

import argparse

from mdi_llm_tpu_torch.cli._common import (
    add_common_args,
    load_model,
    make_ep_mesh,
    make_tp_mesh,
    resolve_kv_dtype,
)
from mdi_llm_tpu_torch.config import TEMPERATURE, TOP_K
from mdi_llm_tpu_torch.generation import Generator, StreamPrinter, resolve_device

def build_parser():
    ap = argparse.ArgumentParser(description=__doc__)
    add_common_args(ap)
    ap.add_argument("--n-tokens", type=int, default=512, help="max tokens per reply")
    ap.add_argument("--temperature", type=float, default=TEMPERATURE)
    ap.add_argument("--top-k", type=int, default=TOP_K)
    ap.add_argument("--top-p", type=float, default=None)
    ap.add_argument(
        "--speculative", type=int, default=0, metavar="K",
        help="greedy speculative chat: draft K tokens by n-gram lookup over "
        "the whole conversation, verify in one forward (requires "
        "--temperature 0)",
    )
    ap.add_argument("--pipeline-stages", type=int, default=0,
                    help="stream over an S-stage recurrent pipeline ring (tokens "
                    "surface as stage 0 collects them)")
    ap.add_argument("--rotations-per-call", type=int, default=2,
                    help="pipeline streaming: ring rotations per steady call "
                    "(smaller: earlier first bytes; larger: more throughput)")
    ap.add_argument("--tp-devices", type=int, default=0,
                    help="chat over N tensor-parallel ranks, all on --device "
                    "(0 = off)")
    ap.add_argument("--sp-devices", type=int, default=0,
                    help="sequence-parallel streaming over N ranks, all on --device: "
                    "ring-attention prefill and a sequence-split KV cache "
                    "(parallel/sp_inference.SPChatSession; 0 = off)")
    ap.add_argument("--sp-flash", action="store_true",
                    help="run the sp prefill ring through kernel K2 (engages when "
                    "the local chunk is >= 2048)")
    ap.add_argument("--sp-chunk", type=int, default=8,
                    help="sp streaming: decode steps per host read (smaller: "
                    "earlier first bytes; larger: more throughput)")
    ap.add_argument("--ep-devices", type=int, default=0,
                    help="MoE configs: chat over N expert-parallel ranks, all on --device "
                    "(0 = off)")
    ap.add_argument("--moe-capacity-factor", type=float, default=None,
                    help="ep dispatch capacity factor (default exact, no drops)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    backends = (args.tp_devices, args.pipeline_stages, args.ep_devices, args.sp_devices)
    if sum(bool(f) for f in backends) > 1:
        raise SystemExit(
            "--tp-devices, --pipeline-stages, --ep-devices and --sp-devices "
            "are separate streaming backends; pick one (for a pipe x tp "
            "mesh use cli/starter.py)"
        )
    if args.speculative and args.temperature != 0.0:
        raise SystemExit("--speculative requires --temperature 0 (greedy)")
    if args.speculative and args.pipeline_stages:
        raise SystemExit("--speculative applies to session backends (one device, tp, "
                         "sp); drop --pipeline-stages")
    resolve_device(args.device)  # raises before any work without the device
    cfg, params, tokenizer, prompt_style = load_model(args)
    if tokenizer is None:
        raise SystemExit("chat needs a checkpoint with a tokenizer (--ckpt)")
    stop_seqs = prompt_style.stop_tokens(tokenizer)
    if args.pipeline_stages:
        from mdi_llm_tpu_torch.parallel.pipeline import PipelineEngine

        eng = PipelineEngine(
            cfg, params, n_stages=args.pipeline_stages,
            max_seq_length=args.sequence_length, rng_seed=args.seed,
            quantize=args.quantize, cache_dtype=resolve_kv_dtype(args.kv_dtype),
            rotations_per_call=args.rotations_per_call, device=args.device,
        )
        print(f"Chatting with {cfg.name} — empty line or Ctrl-D to exit.")
        return _ring_chat(args, eng, tokenizer, prompt_style, stop_seqs)
    if args.sp_devices:
        from mdi_llm_tpu_torch.parallel.sp_inference import SPGenerator

        gen = SPGenerator(
            cfg, params, n_devices=args.sp_devices, devices=[resolve_device(args.device)],
            max_seq_length=args.sequence_length, rng_seed=args.seed,
            cache_dtype=resolve_kv_dtype(args.kv_dtype), decode_chunk=args.sp_chunk,
            use_flash=args.sp_flash, quantize=args.quantize,
        )
    else:
        mesh = None
        if args.tp_devices:
            mesh = make_tp_mesh(args.tp_devices, args.quantize, args.device)
        elif args.ep_devices:
            mesh = make_ep_mesh(args.ep_devices, cfg, args.device)
        gen = Generator(
            cfg, params, max_seq_length=args.sequence_length, rng_seed=args.seed,
            cache_dtype=resolve_kv_dtype(args.kv_dtype), device=args.device,
            quantize=args.quantize, mesh=mesh, moe_capacity_factor=args.moe_capacity_factor,
        )

    print(f"Chatting with {cfg.name} — empty line or Ctrl-D to exit.")
    # cross-turn KV reuse: each turn prefills only its new tokens, so turn
    # latency tracks the turn length rather than the conversation length
    session = gen.chat_session()
    while True:
        user = _read_turn()
        if not user:
            break
        # mdi-lint: disable-next-line=host-sync -- a numpy array of token ids: host data, no device read
        turn = tokenizer.encode(prompt_style.apply(user)).tolist()
        pre_turn = session.history[:]
        printer = StreamPrinter(tokenizer, stop_seqs)
        try:
            # the session's stream is already stop-filtered: raw emit
            for tok in session.send(
                turn, args.n_tokens, temperature=args.temperature,
                top_k=args.top_k, top_p=args.top_p, stop_sequences=stop_seqs,
                speculative=args.speculative or None,
            ):
                printer.emit(tok)
        except KeyboardInterrupt:
            print("\n[interrupted]")
            # a mid-stream interrupt skipped the session's reconcile step,
            # so cache and history are out of step; keep the conversation
            # (pre-turn history + this turn + the partial reply) and let
            # the next send rebuild the cache with one full prefill
            session.rollback(pre_turn + turn + printer.reply)
        print()
    return session


def _read_turn() -> str:
    try:
        return input(">> ").strip()
    except (EOFError, KeyboardInterrupt):
        print()
        return ""


def _ring_chat(args, eng, tokenizer, prompt_style, stop_seqs):
    """The pipeline backend: every turn re-prefills the conversation's
    window (slid to fit the reply) and streams the reply through the
    ring's collect callback; the engine's cut list is authoritative, and
    `finish` prints a held-back tail.  Returns the conversation's tokens."""
    history: list = []
    while True:
        user = _read_turn()
        if not user:
            break
        # mdi-lint: disable-next-line=host-sync -- a numpy array of token ids: host data, no device read
        turn = tokenizer.encode(prompt_style.apply(user)).tolist()
        context = history + turn
        limit = eng.max_seq_length - args.n_tokens - 1
        if len(context) > limit > 0:
            context = context[-limit:]  # slide the window
        printer = StreamPrinter(tokenizer, stop_seqs)
        outs, stats = eng.generate(
            [context], args.n_tokens, temperature=args.temperature, top_k=args.top_k,
            top_p=args.top_p, stop_sequences=stop_seqs,
            stream_cb=lambda _j, tok: printer.push(tok),
        )
        printer.finish(outs[0][len(context):])
        print()
        history = context + printer.reply
        if stats.interrupted:
            print("[interrupted]")
    return history


if __name__ == "__main__":
    main()
