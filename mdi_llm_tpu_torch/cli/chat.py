"""Interactive chat REPL of the port, one device, streaming token output.

Port of the single-device backend of `mdi_llm_tpu/cli/chat.py`: each
turn gets the model's prompt style, tokens print as they decode
(`StreamPrinter`: incremental re-decode, so multi-byte and merged tokens
print correctly, and stop-sequence prefixes are held back), and the
conversation lives in one `ChatSession`, which keeps its KV cache across
turns and prefills only each new turn (a first turn whose prompt bucket
reaches 2048 prefills through kernel K2).  Ctrl-C during a reply rolls
the session back to the conversation so far.  An empty line or end of
input ends the chat.

    python -m mdi_llm_tpu_torch.cli.chat --ckpt checkpoints/tiny-llama
    python -m mdi_llm_tpu_torch.cli.chat --device cpu --ckpt DIR --temperature 0

Needs a checkpoint with a tokenizer (`--ckpt`).  Runs on the GPU unless
`--device cpu` is given; without a GPU and without that flag it raises.
The JAX CLI's other streaming backends are refused, each naming the
ROADMAP item that carries it.
"""

from __future__ import annotations

import argparse

from mdi_llm_tpu_torch.cli._common import (
    add_common_args,
    load_model,
    refuse,
    resolve_kv_dtype,
)
from mdi_llm_tpu_torch.config import TEMPERATURE, TOP_K
from mdi_llm_tpu_torch.generation import Generator, StreamPrinter, resolve_device

# streaming backends of the JAX CLI: flag -> the ROADMAP item carrying it
_UNPORTED = {
    "tp_devices": "item 14", "pipeline_stages": "item 15",
    "ep_devices": "item 16", "sp_devices": "item 16",
}


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
    unported = ap.add_argument_group("not ported yet (refused when set)")
    for flag in ("--tp-devices", "--pipeline-stages", "--ep-devices", "--sp-devices"):
        unported.add_argument(flag, type=int, default=0)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    for name, item in _UNPORTED.items():
        if getattr(args, name):
            refuse(f"--{name.replace('_', '-')} ({item})")
    if args.speculative and args.temperature != 0.0:
        raise SystemExit("--speculative requires --temperature 0 (greedy)")
    resolve_device(args.device)  # raises before any work without the device
    cfg, params, tokenizer, prompt_style = load_model(args)
    if tokenizer is None:
        raise SystemExit("chat needs a checkpoint with a tokenizer (--ckpt)")
    stop_seqs = prompt_style.stop_tokens(tokenizer)
    gen = Generator(
        cfg, params, max_seq_length=args.sequence_length, rng_seed=args.seed,
        cache_dtype=resolve_kv_dtype(args.kv_dtype), device=args.device,
    )

    print(f"Chatting with {cfg.name} — empty line or Ctrl-D to exit.")
    # cross-turn KV reuse: each turn prefills only its new tokens, so turn
    # latency tracks the turn length rather than the conversation length
    session = gen.chat_session()
    while True:
        try:
            user = input(">> ").strip()
        except (EOFError, KeyboardInterrupt):
            print()
            break
        if not user:
            break
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


if __name__ == "__main__":
    main()
