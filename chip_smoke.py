#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (`mdi_llm_tpu_torch`) on one GPU.

Run from the root of a checkout, on a machine with one CUDA GPU:

    python3 chip_smoke.py [--only PHASE,PHASE,...]

runs every phase below in order (`--only` runs the named ones, for
iterating on one of them).  Each prints its lines; any failure exits
non-zero.  Python's bytecode goes to `build/pycache/` in the checkout
(`PYTHONPYCACHEPREFIX`, unless the caller set one; written even under
`PYTHONDONTWRITEBYTECODE`), so the processes the phases start load the
modules torch imports late (`torch.distributed`, `torch._dynamo` under
remat) compiled instead of compiling them again.

1. device  — torch.cuda must be available; prints the card's name and
   power limit as nvidia-smi reports them.
2. build   — builds every kernel of the serving, generation and training
   paths from `csrc/` (one nvcc each, started together) and prints the
   build seconds.
3. kernel  — kernel K1 (ragged paged attention) against its plain PyTorch
   version on the card, at tiny-llama-1.1b geometry (32 heads, 4 KV
   groups, head size 64, 16-token blocks, 2048-token tables), in float32
   and bfloat16: pure decode of 8 slots at depths up to 2000; a mixed step
   (decode lanes, a 128-token prefill chunk, an absent slot, padding
   rows); verify-width spans of 5; the split-KV edges (a slot at depth
   2047 whose walk spans every chunk, walks ending exactly on a chunk
   boundary, one inside the first chunk); decode at head sizes 32 and
   128.  Owned rows are compared, rows no slot owns must be zero.  Tolerance: float32 max |err| <= 1e-4; bfloat16 max
   |err| <= 1.5e-2 against the plain version run in float32 on the same
   bfloat16 inputs (one bfloat16 rounding of outputs of size ~1 is ~4e-3).
   Prints the kernel's time, the plain version's, scaled_dot_product_
   attention's on the gathered dense view (a yardstick the port never
   calls), the least time the card could take and how many times the
   call launched K1's merge kernel.
4. serve   — the serve CLI's path, `--model tiny-llama-1.1b` at full width
   and all 22 layers, bf16, random weights from --seed, 16 synthetic
   requests, 8 slots, 2048-token window, 64 new tokens, chunked decode
   (8 steps) with double buffering.  Every request must finish with its
   token budget, every token must be in the vocabulary, K1 must have been
   launched 22 times per model forward and the plain route never; prints
   the merge kernel's launches beside K1's.  The run passes `--hbm-gb 80`:
   its plan audit (`analysis/audit.py`, before the weights load) must pass,
   its params bytes must equal the engine's weight tensors' and its pool
   bytes the pool's, exactly, and its per-device total must lie within
   15% of `torch.cuda.max_memory_allocated()` over the serve (from the
   built engine to the trace's end, less what the process held before:
   `serve_peak_checked`); the audit's
   K1 shared memory must equal what the launch requests
   (`ragged_paged_attention.launch_smem_bytes`, from the built library)
   and stay within the card's `shared_memory_per_block_optin`, which must
   be the audit's limit for the card.  Here and in every serving and
   generation phase below the engine's steps and generate's decode chunks
   run as CUDA graphs (phase 15), so launches are counted at replay.
4a. analysis — the compiled-program analysis (`analysis/ir.py`,
   `analysis/liveness.py`) on the serve phase's engine, kept alive for
   it: its steps traced on the meta device (`ir.trace_engine`: the
   engine's meta twin, K1's split planned for this card), which must move
   no counter and no generator of the live engine; the enumerated (label,
   key) set must equal the engine's captured steps (this serve dispatches
   no eager step); K1's nodes in each traced step must equal the step's
   captured K1 launch delta (`StepGraph._deltas`: 22 per mixed step, 22 x
   8 per decode chunk) and its merge nodes the captured merge launches;
   the generate phase's prefill (B=4, bucket 2048) traced from the same
   Generator must hold 22 K2 nodes, the generate phase's launches per
   flash prefill; each step's static temporaries + outputs (the flow's
   profile) must lie within ANALYSIS_PEAK_TOL of one eager run of its body
   on the card over zero inputs (`torch.cuda.reset_peak_memory_stats`,
   then `max_memory_allocated` less what was held, under
   `StepGraph._held`); `audit --liveness`'s per-device total (the flow's
   worst temporaries as the activation term) must lie within
   AUDIT_PEAK_TOL of the serve phase's peak, printed beside the analytic
   term's; the serve CLI's ir and flow preflight seconds at full width
   are printed.
5. serve parity — float32, 4 layers at full width, 4 requests of 16 new
   tokens, served through the kernel route and through the plain route on
   the card: the greedy streams must be identical but for a genuine
   near-tie (see the parity phases below).
5a. kernel-q8 — K1 over int8 pools (random payloads, random positive
   scales per (block, group)) and over float8 pools (e4m3, e5m2) against
   its plain version on the card, at the `kernel` phase's span cases, q
   in float32 and bfloat16; reference and tolerance as for
   `kernel`, the plain version run in float32 on the same stored pool.
   Prints the same times; the library yardstick is scaled_dot_product_
   attention over the already dequantized gathered view (the dequant is
   not timed), and the bound counts K/V at one byte per element plus the
   int8 scales.
5b. serve-q8 — the serve phase's CLI run with `--kv-dtype int8`, then
   with `--kv-dtype float8` (e4m3): every request finishes with its
   budget in the vocabulary, K1 is launched 22 times per forward and the
   plain route never; prints the pool's bytes beside a bf16 pool's.  The
   audit checks of the serve phase over the int8 pool (scales included);
   over the e4m3 one its bytes and K1's shared memory (its peak printed).
5c. serve-q8-parity — the serve-parity phase over an int8 pool, then an
   e4m3 pool: greedy streams through K1 and through the plain route.
5d. spec — speculative serving at full size, bf16 pool, `--spec-k 4
   --draft-model NanoLlama`, greedy, 8 of the serve trace's requests with
   `SPEC_TOKENS` (16) new tokens each: every request finishes in the
   vocabulary, the draft model and the lookup drafted, and K1 launches
   are exactly 22 per target forward + 12 per draft forward, the plain
   route never.  Then `--spec-k 4 --kv-dtype int8 --temperature 0.8`
   with the same draft model (random weights at temperature 0.8 make the
   n-gram lookup miss, so the draft model is what drafts): the
   rejection-sampled verify over the quantized pool.
5e. spec-parity — float32, 4 layers at full width, a 2-layer NanoLlama
   draft passed as `draft_gen`: greedy streams with `spec_k=4` and the
   draft equal the same engine's streams without `spec_k`, all on K1.
   Parity phases (serve-parity, serve-q8-parity, spec-parity): where two streams
   diverge, the phase prints the first divergent position and the top-2
   logit gap of the float32 model there (a dense forward over the common
   prefix), and passes only if that gap is below 1e-4, a genuine near-tie
   that a different summation order may flip.
6. flash   — kernel K2 (flash self-attention) against its plain PyTorch
   version on the card, 32 heads, 4 KV groups, head size 64, in float32
   and bfloat16: causal B=4 T=2048 (the generate phase's prefill shape),
   causal T=1000 with the LSE (T not a multiple of the tile), non-causal
   T=512 with the LSE; in bfloat16 also head sizes 32 and 128 at B=1,
   T in {1, 7, 100} (chunks shorter than one tile) and non-causal T=512
   at head size 128.  Tolerances as for K1, the LSE's too.  Prints the
   kernel's time, the plain version's, scaled_dot_product_attention's (a
   yardstick the port never calls) and the least time the card could
   take; then K2 against the dense torch route the model takes without
   flash, at T=256 to 2048 (the crossover for `flash_min_len`).
7. generate — `Generator.generate` on tiny-llama-1.1b at full width and
   all 22 layers, bf16, random weights from seed 10137, 2048-token window:
   4 greedy prompts of 1100-1900 tokens (one 2048 bucket), 64 new tokens
   in decode chunks of 16.  Every sample must get its 64 tokens in the
   vocabulary; K2 must be launched once per layer (22) and its plain
   version never.  Then the sample CLI (`--n-samples 4 --n-tokens 32
   --greedy`, 8-token prompts below `flash_min_len`) must finish without
   launching K2.
8. generate parity — float32, 4 layers at full width, 2 prompts of ~1100
   tokens, 16 greedy tokens, through K2 and through K2's plain version on
   the card: the streams must be identical.
9. flash-bwd — kernels K3 (dQ) and K4 (dK/dV, summed over each KV group)
   against their plain PyTorch versions on the same inputs (K2's output and
   LSE), 32 heads, 4 KV groups, head size 64, float32 and bfloat16: causal
   B=4 T=2048 (the training shape), causal T=1000 (a ragged tile),
   non-causal T=512 with an LSE cotangent; in bfloat16 also head sizes 32
   and 128 at B=1 T=1000, non-causal T=300 at head size 128 with an LSE
   cotangent and causal T=7 (shorter than a tile).  float32 inputs (the
   CUDA-core kernels): every output within 1e-4 x max(1, max |plain|).
   bfloat16 inputs (the tensor-core kernels): every element within the
   rounding-error bound of `flash_bwd_bf16_limits` against the plain
   version run in float32 on the same inputs; err/limit is printed.
   Prints each kernel's time, the plain version's, the backward of
   scaled_dot_product_attention (dQ, dK and dV together; a yardstick the
   port never calls) and the least time the card could take.
10. train  — `Trainer.train_step` on tiny-llama-1.1b at full width and all
   22 layers, bf16, B=4, T=2048, 2 micro-batches per step, remat on, the
   flash route on, random weights from seed 10137, tokens drawn from 512
   ids: every optimizer step launches exactly 88 K2 (forward and remat
   recompute), 44 K3 and 44 K4 and no plain version, an eval batch 22 K2;
   the step losses are finite and a fixed batch's loss falls by at least
   `TRAIN_MARGIN` over three steps.  Prints step seconds, tokens/s, the
   Trainer's TFLOP/s estimate and peak memory.  Then the train CLI on
   synthetic `train.bin`/`val.bin` in a temporary directory, cut to
   `TRAIN_CLI_LAYERS` layers (`--override`; the checkpoint's size, not the
   step, is what the depth costs): 2 steps and a checkpoint, then
   `--init resume` for a third, which reads the depth from the checkpoint.
11. train parity — float32, 4 layers at full width, B=2, T=2048: two
   optimizer steps through K2-K4 and through their plain versions from
   the same params and batches; the first step's gradients and the losses
   must agree (tolerances in `phase_train_parity`).
12. train parity bf16 — the same set-up in bfloat16, where K2-K4 run on
   tensor cores: one gradient through them and one through their plain
   versions from the same params and batch, with exact launch counts; per
   leaf ||g_kernel - g_plain||_2 <= 2^-5 ||g_plain||_2 and the losses
   within 2^-8 (relative).
13. ckpt   — a real checkpoint through the normal entry points: the serve
   phase's weights (tiny-llama-1.1b, bf16, seed 10137) written by the
   port's reverse map as a HF snapshot of three safetensors shards with
   its index and config.json into `checkpoints/<HUB_ORG>/tiny-llama-1.1b`
   of the run's temporary directory, where a finished hub download leaves
   it; where `huggingface_hub` is installed, `cli.prepare_model
   <HUB_ORG>/tiny-llama-1.1b --checkpoints-dir ...` reaches it through the
   hub route (`HF_HUB_OFFLINE=1`, set before the library is imported:
   nothing is fetched, `snapshot_download` returns the directory) and
   converts it; where it is not, `cli.prepare_model <dir>` converts it and
   the line says so.  Every loaded leaf bit-identical to the written one;
   `cli.serve --ckpt` must give the 16 streams of `cli.serve --model` (the
   serve phase's run of the same flags; without that phase, one here)
   with K1 at 22 launches per forward and the plain route never;
   `Generator.generate` on the loaded weights over the generate phase's
   prompts must launch K2 exactly 22 times and give the original
   weights' tokens (the generate phase's; without it, a run here).  Prints
   the route (`hub` or `local`) and the seconds to write, convert, load
   and serve beside the card.
14. chat   — a 32000-word word-level tokenizer.json in that checkpoint,
   then `cli.chat --ckpt` through stdin for two turns: a pasted
   1500-word first turn (bucket 2048) prefills the empty cache through K2
   (exactly 22 launches), a 12-word second turn takes the dense route;
   the conversation must equal a direct `ChatSession` run's.  Where the
   `tokenizers` library is missing it says so and stops there.
15. graphs — the engine's and the Generator's steps as CUDA graphs
   (the default everywhere above) against eager launches of the same step
   bodies (the private `_graphs=False` switch), at full tiny-llama-1.1b
   width and depth in bf16: 8 of the serve phase's requests at `GRAPH_TOKENS`
   (8) new tokens through `cli.build` + `engine.run()` over a bf16 pool in
   turns eager, graph, graph, eager, over int8 and e4m3 pools eager then
   graph, and the generate phase's prompts with `GRAPH_TOKENS` new tokens in turns
   eager, graph, graph, eager (each Generator
   called once first, so the timed calls are the second with their
   shapes).  Fails unless greedy streams are identical between the routes
   (the near-tie rule of the parity phases applies), host_syncs are equal,
   K1 launches are 22 per forward on both routes, no serve run captures a
   graph inside its steps and a second generate call captures none.  The
   sampled check: a temperature-0.8 serve and generate from the same
   generator state on both routes, printed as the number of streams
   identical draw for draw, and the frequency test of
   `sampled_frequencies_ok` on the graph route's mixed and decode steps.
   Prints tokens/s, decode_s, prefill_s, captures, capture seconds and
   peak memory per run, and the device time of 22 layers' paged writes
   (one decode forward of 8 lanes) over an int8 pool against a bf16 one,
   timed as graph replays.
16. server — the observer and the open-system server (`obs/`, `server/`,
   `cli/server.py`) at the serve phase's set-up (tiny-llama-1.1b, all 22
   layers, bf16, random weights from seed 10137, 8 slots, 16-token blocks,
   2048-token window, decode chunk 8 with double buffering, CUDA graphs),
   over `SERVER_REQUESTS` (8) synthetic requests (prompts 4-511, 8-64 new tokens):
   (a) the trace through an offline `engine.run()`, then submitted whole
   to a `ServingFrontend` before `start()` with the observer on and off:
   the streams and host_syncs must equal the offline run's;
   (b) the trace through `OpenLoopRunner` at Poisson rates of 25% and
   100% of (a)'s finished requests per second;
   (c) `cli.server` as a subprocess on a free localhost port (its module
   run as `__main__`, with K1's counts printed at exit): one SSE and one
   JSON completion must give the greedy tokens of the same requests
   served alone in-process, and (a)'s but for a bf16 near-tie (what else
   is in the batch decides whether a decode token runs in a mixed step
   or a decode chunk, another summation order: `bf16_near_tie` prints
   the divergence and fails unless the bf16 top-2 gap there is within two
   bf16 roundings), `/healthz` 200,
   `/metrics` parses with `serving_tokens_generated_total` equal to
   `/v1/stats`' `tokens_generated`, and SIGTERM drains and exits 0;
   (d) `cli.serve --spec-k 4 --draft-model NanoLlama --metrics-out
   --trace-out` over `SERVER_SPEC` (8 synthetic requests, 32 new tokens):
   the observer's spec counters equal the stats line's,
   the verify spans carry `spec_k` 4 and their `accepted` sum to
   `spec_accepted`.  Every part: K1 launched 22 times per forward (and
   12 per draft forward) and the plain route never, counted at replay; no
   capture after warm-up (the captures guard, or `graph_captures_total`
   read from the observer); no step report with `error` set; MFU and MBU
   in (0, 1].  Prints TTFT/TPOT/E2E/queue-wait p50/p95/p99, tokens/s and
   MFU/MBU per part, with the card's name and power limit.
17. tier  — the host-RAM KV tier (`serving/host_tier.py`) at the serve
   phase's set-up with the pool cut to 112 blocks (1024 cover every slot's
   window) over 24 requests: 4 sharing a 256-token prefix, the serve
   phase's 16 synthetic ones, 4 more with that prefix.  The serve CLI's
   engine runs them with `--host-pool-mib 1024`, then with 0 (recompute
   preemption), then on the full pool: the tier run must swap out, swap in
   and restore spilled prefix blocks (`prefix_hits_host`), the recompute
   run must preempt, the full-pool run must not; all must launch K1 22
   times per forward and the plain route never and capture nothing after
   warm-up (the tier run goes first once more and last; the last is
   compared, and both must give the same streams).  The runs batch
   differently (and a recompute re-prefills its
   victims' generated tokens), so in bf16 a stream's KV history differs
   by roundings between them and no rule on one step bounds a divergence
   (two runs diverged by more than two bf16 roundings, and by more than
   the bf16 model's error on the two tokens): the bf16 divergences are
   printed (`bf16_divergences`), and the same three runs in float32 (4
   layers at full width) must give the full pool's streams but for a
   near-tie below 1e-4 (`divergence_ok`), the tier run swapping in and
   hitting spilled prefixes there too.  Prints tokens/s of the
   three, the prefill tokens the swaps saved, the link rate the cost model
   observed and the restore wait's p50 (a histogram estimate).  Then, over
   bf16, int8 (payload and scales) and e4m3 pools filled with random bytes,
   11 blocks fetched to host slots and restored into 11 other blocks must
   round-trip byte for byte (`torch.equal` on the raw bytes), changing no
   other block; and pinned copies of 1, 8 and 32 pool blocks each way are
   timed by CUDA events (the link table's row in `serving/host_tier.py`).
18. quant — weight quantization (`ops/quant.py`) on tiny-llama-1.1b at
   full width, cut to `QUANT_LAYERS` (6) of its 22 layers in (a) and (b):
   (a) the serve phase's CLI run (`QUANT_TOKENS`, 8, new tokens) in bf16
   and with
   `--quantize int8`, `w8a8` and `int4`: each as the serve phase checks
   it (K1 12 per forward, replayed inside the step graphs), with the
   weights' stored bytes, tokens/s, MFU/MBU, the greedy tokens' agreement
   with bf16 (printed: random weights make them diverge legitimately) and
   each step report's flops over bf16's (w8a8 within 0.01%); (b)
   `Generator(quantize=...).generate` on the generate phase's 4 prompts
   (`QUANT_TOKENS` new tokens)
   with exactly 12 K2 launches, decode chunks of 8, decode tokens/s (the
   graph capture taken out) and prefill seconds beside bf16's; (c) one float32 forward of each
   mode (4 layers) against the same forward through
   `plain_quantized_einsum` (float64 products): max |err| <= 1e-4 x
   max(1, max |plain|); (d) `cli.prepare_model --quantize int8` on
   the ckpt phase's snapshot: every leaf of the sibling equal to the
   card's quantizer's on the same weights, and `cli.serve --ckpt
   <sibling>` giving the streams of `--ckpt <snapshot> --quantize int8`.
19. moe   — Mixtral-8x7B (`Config.from_name("Mixtral-8x7B-v0.1")`, its
   published widths checked: n_embd 4096, 32 heads over 8 KV groups, head
   size 128, intermediate 14336, 8 experts, top 2, rope base 1e6) in bf16
   with random weights from seed 10137, cut to `MOE_LAYERS` (4) of its 32
   layers (11.6 GB of blocks): (a) the serve phase's CLI run and trace with
   `--override n_layer=4`, `MOE_SERVE_TOKENS` (16) new tokens per request,
   K1 at exactly 4 launches per forward inside the step graphs and the plain
   route never; prints tokens/s, MFU and MBU (MFU
   counts the dense formulation's 8 experts per token), the stored weight
   bytes, peak memory and graph captures; the same trace through the plain
   route, its bf16 divergences from K1's streams printed with the router
   flips at the diverging step (`router_flips`), not gated; (b)
   `Generator.generate` on the generate phase's 4 prompts, 64 new tokens,
   K2 at exactly 4 launches; K2 at that prefill's shape (B=4, T=2048, 32
   heads over 8 groups, hs 128) against its plain version, timed beside
   it and SDPA; (c) float32 at full width and 2 layers: the greedy serve
   streams through K1 and the plain route, and generate's through K2 and
   its plain version, equal but for a near-tie (`divergence_ok`).
20. moe-quant — Mixtral-8x7B at all 32 layers with int8 weights
   (`init_quantized_params(mode="w8")`, 46.4 GB): 8 of the moe phase's
   requests served with `MOE_QUANT_TOKENS` new tokens each (K1 32 per
   forward) and generate on its prompts, `MOE_QUANT_TOKENS` new tokens (K2
   exactly 32), stored bytes, tokens/s and MFU/MBU printed; at 4 layers a float32
   forward of each mode (w8, w8a8, int4) against a float64 plain version
   of the quantized forward (`plain_moe_quantized_einsum`): max |err| <=
   1e-4 x max(1, max |plain|); then the trace (16 new tokens) served once
   in each mode at 4 layers, peak memory printed (int4's bounded by
   `quant.W4_Z_BYTES`).
21. moe-train — `Trainer.train_step` at Mixtral's width, 2 layers, bf16,
   B=1, T=2048, remat, the flash route, `moe_aux_weight` 0.01: the
   reckoned memory first, then 3 steps with exactly 4 K2, 2 K3 and 2 K4
   launches each; prints step seconds, tokens/s, losses, the layer-mean
   aux and peak memory.  K3 and K4 at that attention shape against their
   plain versions (bf16 limits), timed beside them and SDPA's backward.
   Then float32 at 1 layer: the first gradient and two steps' losses
   through K2-K4 and through their plain versions within `train-parity`'s
   limits.
22. tune  — `python -m mdi_llm_tpu_torch.ops.tuning` (`tuning.main`) on
   the card for tiny-llama-1.1b's K1 geometry (32 heads, 4 groups, hs 64)
   and Mixtral's (32, 8, 128), bf16, 16-token blocks: the serve trace's
   steps recorded on a one-layer stand-in, every candidate held against
   the plain version, then timed over those steps, each weighted by its
   count; prints the winner, the default and the committed entry.  Where
   the winner is not the default split, the trace served whole (22 and 8
   layers, bf16) with the default and the winner in the order default,
   winner, winner, default on fresh engines, each taking as many forwards
   as the recording has steps: tokens/s printed.  K1 at Mixtral's
   geometry at the spot steps (`tuning.SERVE_TRACE_CASES`) with the
   winner and the default, the plain version and SDPA.  Then the
   tiny-llama serve trace at float32 (4 layers) with the defaults and
   under an `MDI_TUNE_TABLE` table holding a non-default split: no capture
   after warm-up, K1 4 per forward, the greedy streams equal
   (`divergence_ok`); an invalid entry (min_chunk 48) raises at
   resolution and at a K1 call.
23. pipeline — the paper's recurrent pipeline (`parallel/pipeline.py`)
   in one process on the card, through `cli.starter` with
   `examples/node_configs/standalone.json`: tiny-llama-1.1b at full
   width and all 22 layers, bf16, seed 10137, S = 2 and S = 4 stages
   (the reference table's [10, 12] and [4, 6, 6, 6]), M = 2 samples per
   slot, 2·S greedy 8-token prompts, `PIPE_TOKENS` (8) new tokens.  Every
   sample gets its budget in the vocabulary; a second call on the same engine replays
   the captured decode chunks (no capture) and gives the same streams;
   the ring launches none of K1-K4 and no plain route.  The streams are
   compared with `Generator.generate`'s at B = S·M on the same prompts:
   bf16 divergences printed (`bf16_divergences`: the ring multiplies M
   rows where generate multiplies S·M, so the bf16 histories part at the
   first near-tie; not gated).  Prints the ring's tokens/s (second call), rotations,
   graph captures and replays, bytes per hop and generate's tokens/s.
   Then float32 at 4 layers, S = 2 and 4: the ring's streams equal
   generate's (`divergence_ok`) and the eager ring's (`_graphs=False`)
   exactly; with overlapped chunks a finished lane runs past a 64-slot
   cache (its positions clamped) and the stream is generate's.
24. pipeline-nodes — `cli.starter` and one `cli.secondary` as two
   processes sharing the card (gloo, the hop staged through pinned host
   buffers), each under `cli.mem_monitor`, running two jobs in turn: in
   float32 at 4 layers (S = 2, M = 2, 4 samples, 32 tokens) the streams
   are the one-process ring's (`divergence_ok`); in bf16 at 22 layers (32
   tokens) every sample gets its budget.  The starter runs both jobs with
   `--hbm-gb 80`: its plan audit (before the checkpoint load) must print
   0 errors.  Prints the bf16 job's stats
   line, seconds and each process's ring line (backend, hops, bytes, mean
   and fastest hop ms, its allocator's peak reserved bytes) and each
   monitor's peaks over both jobs: the process's card memory as
   `nvidia-smi --query-compute-apps` lists it (`none` in a container whose
   processes nvidia-smi lists under one other pid) and the card's
   memory in use.
25. pp-serve — pipeline-parallel serving (`serving/pipeline.py`): the
   serve phase's CLI run and trace (tiny-llama-1.1b at full width cut to
   `RING_SERVE_LAYERS` (6) of its 22 layers, bf16, seed 10137, 16
   synthetic requests, 8 slots, 16-token blocks, 2048-token window,
   `RING_SERVE_TOKENS` (8) new tokens, decode chunks of 8 with double
   buffering) with `--pp 2` and `--pp 4` (the reference table's split of 6,
   [2, 4], and [1, 1, 2, 2], every stage on the card), then `--pp 2
   --kv-dtype int8` (K1's int8 branch inside the ring).  Each run: every
   request finishes with its budget in the vocabulary, K1 launches exactly
   once per stage layer the engine counts (`stage_layer_runs`: 12 per
   tick, 2S - 1 ticks per mixed
   step and 8S + S per decode chunk, bubbles included; each with its merge
   kernel where the split plan has one), the plain route never, the steps
   are captured when the engine is built and replayed, host_syncs equal the
   single engine's on the same trace (its run served once per pool in the
   process, `single_reference`, and reused by tp-serve and pp-tp-serve).
   Prints tokens/s beside the single
   engine's in the same process and their ratio, the `pipeline` block,
   the capture seconds, the launch counts beside their prediction, peak
   memory and the bf16 divergences from the single engine's streams
   (`bf16_divergences`: the ring runs K1 and the products at 8/S lanes or
   T/S tokens, another summation order; printed, never gated).  Then
   float32 at 4 layers, full width, S = 2 and 4, 4 requests of 16 new
   tokens: the ring through K1 must give the single engine's streams
   through K1 and the ring's through the plain route (`divergence_ok`: a
   divergence passes only at a top-2 gap below 1e-4), with equal
   host_syncs.
26. tp-serve — tensor-parallel serving (`Generator(mesh=make_mesh({"tp":
   N}, ["cuda"]))`, every rank on the card): first K1 at the ranks'
   geometries against its plain version, q bfloat16, over bf16 and int8
   pools, at the `kernel` phase's decode, mixed and verify cases with 16
   heads over 2 KV groups (tp 2) and 8 heads over 1 (tp 4), head size
   64, its knobs resolved on the model's 32-head 4-group geometry as the
   serving path resolves them (reference, tolerance and times as for
   `kernel`).  Then pp-serve's CLI run and trace (`RING_SERVE_LAYERS`) with
   `--tp 2`, `--tp 4` and `--tp 2 --kv-dtype int8`, the single engine on
   the same trace beside each pool: every request finishes with its budget
   in the vocabulary, K1 launches exactly tp x 12 per target forward (counted at
   replay), the plain route never, the steps are captured and replayed,
   host_syncs equal the single engine's.  Prints tokens/s beside the
   single engine's and their ratio, the capture seconds and the bf16
   divergences from the single engine's streams (`bf16_divergences`: the
   ranks' partial sums meet in an all-reduce, another summation order;
   printed, never gated).  Then float32 at 4 layers, tp 2 and 4: the
   streams through K1 must give the single engine's and the tp engine's
   through the plain route (`divergence_ok`).  The tp 2 serves' plan
   audits: each rank's params and pool bytes equal its shard tree's and
   its pool's, exactly.
27. tp-generate — K2 at the generate phase's prefill shape (B=4, T=2048,
   causal, bf16) with 16 heads over 2 groups and 8 over 1, against its
   plain version (times as for `flash`); then `Generator(mesh=make_mesh(
   {"tp": 2}, ["cuda"])).generate` on the generate phase's four prompts
   (1100-1900 tokens, bucket 2048), 64 new tokens: exactly 2 x 22 K2
   launches for the prefill, the plain version never, the decode chunks
   captured; bf16 divergences from the single device printed.  Then
   float32 at 4 layers: tp 2 and dp x tp = 2 x 2 generate the single
   device's streams (`divergence_ok`).
28. tools — `cli.prepare_data` on a text file the phase writes, tokenized
   by the chat phase's word-level tokenizer into train.bin and val.bin
   (the text's tokens in order); where `datasets` is installed, the same
   words as `TOOLS_DOCS` documents saved as a local dataset and
   `cli.prepare_owt --num-proc 1` on it (tokenized in this process): its
   train.bin and val.bin must hold every document exactly once, each as
   bos, its words' ids (read off the words, not through the tokenizer)
   and eos.  Then `cli.evaluate` on the ckpt phase's checkpoint (all 22
   layers, bf16) over prepare_owt's val.bin (prepare_data's without
   `datasets`): its loss must equal, within 1e-3, the port's
   `cross_entropy_loss` computed here on the same batches.  Without the
   ckpt phase it writes the snapshot first, as `chat` does; without the
   `tokenizers` library it says so and skips, as `chat` does.
29. mesh-train — the meshed Trainer (`Trainer(mesh=make_mesh(axes,
   ["cuda"]))`, every position on the card): first K3 and K4 at the tp
   ranks' geometries (B=4, T=2048, causal, bf16, hs 64: 16 heads over 2
   groups and 8 over 1) against their plain versions (bf16 limits), timed
   beside them, SDPA's backward and the bound.  Then the train phase's
   set-up (tiny-llama-1.1b cut to `MESH_TRAIN_LAYERS` (4) of its 22
   layers, bf16, B=4, T=2048, 2 micro-batches, remat, the flash route,
   random weights from seed 10137)
   without a mesh and on `dp=2`, `tp=2`, `dp=2,tp=2`, `dp=1,pp=2` and
   `dp=1,pp=2,tp=2`, one warm-up step and three counted ones each on the
   same batches: every step runs 2 x 6 x (the mesh's positions) layer
   runs (the Trainer's `layer_runs`: a pp ring runs S micro-batches of
   each dp shard's rows) and launches K2 twice per run, K3 and K4 once,
   and no plain version; prints step seconds beside the unmeshed step's,
   the losses and peak memory.  Then float32 at `MESH_F32_LAYERS` (2)
   layers, B=2, grad_clip
   0.05 (clipping engaged), lr 1e-4 (`MESH_F32`): each mesh, through K2-K4
   and through their plain versions (`flash_kernel=False`), takes three
   steps whose losses equal the unmeshed Trainer's on the same route
   within 1e-5 (relative) and whose parameters in the standard layout
   equal its within rtol 2e-4, atol 2e-5.
30. mesh-train-procs — `python -m mdi_llm_tpu_torch.cli.train --mesh dp=2`
   as two processes sharing the card (`--coordinator` on a free localhost
   port, gloo staged through pinned host memory), each under its own time
   limit, through an entry that reports its Trainer (step seconds, the
   gradient all-reduce's seconds, calls and bytes, layer runs, K2-K4
   launches) and writes no checkpoint: in float32 at `MESH_F32_LAYERS` (B=2,
   grad_clip 0.05) process 0's `MESH_PROCS_STEPS` (2) loss lines equal one process's
   `--mesh dp=2` run's within 1e-5 (relative) and process 1 prints none;
   in bf16 at the train phase's shape cut to `MESH_PROCS_DP_LAYERS` (2)
   layers (the gradient all-reduce, through host memory, is the step)
   each process runs 2 x 2 x 2 layers, K2 twice per run and K3, K4 once,
   and the losses are finite; prints both processes' step and all-reduce
   seconds beside one process's steps.  Then the same two parts for `--mesh pp=2` (each
   process one GPipe stage, the hop a gloo send/recv of each
   micro-batch's activations and, in the backward, of their gradients)
   and `--mesh pp=2,tp=2` (one stage and its whole tp group each): the
   float32 loss lines equal one process's run on the same mesh; in bf16
   at `MESH_PROCS_PP_LAYERS` (4) layers each process holds stages [i,
   i+1), runs 2 x 2 x 2 micro-batches x 2 layers (x 2 ranks with tp) and launches K2 twice per run and K3, K4
   once; prints the step seconds beside one process's and the pp group's
   calls, bytes and host seconds.
   Beside its parameter check the float32 part prints, per mesh and route,
   the largest |diff| between the first step's gradients (summed,
   averaged, before the optimizer clips them) and the unmeshed Trainer's,
   absolute and relative to the leaf's largest gradient.
   Then sp and ep over the two processes, one rank each, in the same two
   processes (`train_procs_runs`): `--mesh sp=2 --use-flash on` at
   tiny-llama-1.1b's full width, `SP_PROCS_TRAIN_LAYERS` (4) layers, B=1,
   T=8192, bf16 (each process's rank runs P = 2 of the ring's 4 blocks a
   layer: 16 layer runs over `PROCS_BF16_STEPS` (2) steps, K2 32, K3 and
   K4 16 in each process;
   the ring's K/V chunks pass between the processes, the gradients sum
   over them) and `--mesh dp=1,ep=2` at moe-train's shape (Mixtral's
   widths, 2 layers, B=1, T=2048; each process holds 4 of the 8 experts;
   4 layer runs, K2 8, K3 and K4 4 in each process), the losses finite,
   process 1 printing none, the step seconds beside one process's run of
   the same argv (before the pair), with the sp / ep group's calls, bytes
   and host seconds; then float32
   sp 2 at 4 layers, T=2048, and ep 2 at one Mixtral layer (its float32
   AdamW state of 4 would not fit one process), `PROCS_F32_STEPS` (2)
   steps, clipping engaged: process 0 then runs the same argv alone and
   holds the pair's loss lines within 1e-5 (relative) and its first-step
   gradients and parameters, the experts gathered, within
   `MESH_PARAM_TOL` of that run's (`kept_close`).
   Then ep beside tp and dp over the two processes, in the same two
   processes and held the same way, at moe-train's shape (Mixtral's
   widths, T=2048): `--mesh ep=2,tp=2` (one ep rank, 4 experts, with its
   whole tp group per process; 2 layers, B=1: 8 layer runs, K2 16, K3 and
   K4 8 in each process), `--mesh tp=2,ep=2` (one tp rank with every
   expert; 1 layer: 2 layer runs) and `--mesh ep=2,dp=2` (one ep rank
   with both dp rows; 2 layers, B=2: 8 layer runs), with the tp / ep
   group's calls, bytes and host seconds; then each in float32 at one
   layer with `EP_F32_CUT` (the vocabulary cut to 4096 ids, T=1024,
   capacity factor 1.25: two tp=2,ep=2 processes each holding every
   expert's float32 state would not fit the card), its step seconds
   beside one process's, its loss lines and first-step gradients checked
   against one process's as above (`CHECKED`: its parameters after the
   steps are the CPU tests').
30a. mesh-train-quad — the train CLI over four processes sharing the
   card, every run in one set of four (`mesh_jobs(n=4)`): `--mesh
   dp=2,ep=2` (one (dp, ep) position each: a dp row and 4 experts; the
   exchange within each dp row, the gradients summed over the dp group)
   at Mixtral's widths, 1 layer (four processes' bf16 state of two would
   not fit the card), B=2, T=2048, bf16 (2 layer runs, K2 4,
   K3 and K4 2 in each process), and `--mesh dp=1,sp=2,tp=2` (one (sp,
   tp) position each: the ring per tp rank over its sp group, the tp
   partial sums in the tp group) at tiny-llama-1.1b's width, 4 layers,
   B=1, T=8192, bf16 (16 layer runs: K2 32, K3 and K4 16 in each
   process), the losses finite, the processes past the first printing
   none; then both in float32 (dp x ep at one layer with `EP_F32_CUT`:
   four processes' float32 state of Mixtral's 32000-id embedding and
   head beside their experts would not fit the card; sp x tp at 4 layers,
   T=2048), `PROCS_F32_STEPS` (2) steps, process 0 holding the loss
   lines and first-step gradients (and sp x tp's parameters) to one
   process's run as in mesh-train-procs (the kept trees in host memory),
   with the step seconds beside one process's and the dp group's gradient
   sum seconds.  Then K2, K3 and K4 alone at the sp x tp ring's blocks
   (tiny-llama's tp 2 rank: 16 heads, 2 groups, hs 64; B=1, T=4096 a
   rank; bf16, causal and not, with the LSE and its cotangent) against
   their plain versions, timed beside them, SDPA and its backward, and
   the bound.
31. pp-tp-serve — pp x tp serving (`serving/pipeline.py` with a tp axis
   inside each stage): the pp-serve phase's CLI run and trace with `--pp 2
   --tp 2` (the reference table's [5, 7] of 12 layers, two ranks per stage, every
   rank on the card), over a bf16 pool and an int8 pool, the single engine
   on the same trace beside each: every request finishes with its budget
   in the vocabulary, K1 launches exactly 2 x `stage_layer_runs` (once per
   stage layer and rank, at the rank's 16-head 2-group geometry, its knobs
   resolved on the model's 32-head 4-group one), each with its merge
   kernel, the plain route never, the steps are captured when the engine
   is built and replayed, host_syncs equal the single engine's.  Prints
   tokens/s beside the single engine's, `stage_layer_runs`, the capture
   seconds and the bf16 divergences (printed, not gated).  Then float32 at
   4 layers: the pp 2 x tp 2 engine through K1 gives the single engine's
   streams and its own through the plain route (`divergence_ok`).
32. pipeline-tp — the pipe x tp ring (`PipelineEngine(tp=2)` through
   `cli.starter --tp-devices 2` and `standalone.json`, one process): S = 2
   ([10, 12]), M = 2, 4 greedy 8-token prompts, `PIPE_TOKENS` new tokens, at full
   width and depth in bf16, beside the same ring at tp = 1 and
   `Generator.generate` at B = 4: every sample gets its budget, a second
   call replays the captured chunks and gives the same streams, the ring
   launches none of K1-K4 and no plain route.  Prints tokens/s, rotations,
   captures and the ratios.  Then float32 at 4 layers: the pipe x tp
   ring's streams are generate's (`divergence_ok`).
33. inference-procs — inference over two processes sharing the card
   (gloo through pinned host buffers), each under its own time limit:
   (a) `cli.sample --coordinator ... --tp-devices 2` (one tp rank per
   process) through an entry that runs the CLI three times in the same
   two processes, each a job on its own port: float32 at 4 layers greedy
   (both processes' streams equal one process's tp 2 run, `divergence_ok`)
   and at temperature 0.8 (the two processes draw the same tokens); bf16
   at `INFER_BF16_LAYERS` (6) layers on the generate phase's four prompts
   (1100-1900 tokens, the CLI's prompt source swapped for them),
   `INFER_BF16_TOKENS` (16) new tokens: each process launches K2 exactly
   6 times (one rank x 6 layers) and its plain
   version never, the two print the same streams.  Prints decode tokens/s
   beside the one-process tp 2 run's (its graphs replayed) and the
   collectives' calls, bytes and host seconds.  (b) `cli.starter` and
   `cli.secondary` with `--tp-devices 2` (each process one stage of two
   ranks), float32 at 4 layers, as a fourth job of the same two
   processes: the one-process pipe x tp ring's streams.  (c) sp and ep
   over the two processes, one rank each, as further jobs of the same
   processes (`procs_runs`): `--sp-devices 2 --sp-flash` at Llama-3-8B's
   widths, `SP_LAYERS` (4) layers, bf16, the sp phase's prompts of 8128
   and 6000 tokens (local chunks of 4096), `SP_TOKENS` (8) greedy new
   tokens: each process launches K2 8 times (its rank's diagonal and one
   rotated block a layer; 16 = P² x 4 over the pair), and float32 at 4
   layers with 16 new tokens (K2 8 each); `--ep-devices 2` at Mixtral's
   widths, `EP_PROCS_LAYERS` (4) layers, bf16 on the generate phase's
   four prompts (1100-1900 tokens: K2 4 times in each process),
   `EP_PROCS_TOKENS` (8) new tokens (each process draws only its 4 of the
   8 experts), and float32 at `EP_PROCS_F32_LAYERS` (2) layers on the
   CLI's four 8-token prompts, exact and at a capacity
   factor of 0.5 that drops assignments.  Both processes print the same streams, every
   sample gets its tokens in the vocabulary, the plain K2 never runs; the
   float32 streams equal one process's run of the same argv
   (`divergence_ok`), the bf16 divergences from it are printed; each run
   prints its seconds beside one process's, the collectives' calls, bytes
   and host seconds, K2 launches and each process's peak memory; the
   one-process runs follow the pair.  (d) the Generator's ep layouts
   beside tp and dp over the two processes, through the API (`api_runs`:
   `Generator(mesh=make_mesh(axes, [card], process_id, 2))`), as further
   jobs of the same processes: ep 2 x tp 2 (one ep rank with its tp group
   per process), tp 2 x ep 2 (one tp rank with every expert), ep 2 x dp 2
   and ep 2 x dp 2 x tp 2 (one ep rank with every replica), at Mixtral's
   widths, `EP_PROCS_LAYERS` (4) bf16 layers on the generate phase's four
   prompts at capacity factor 1.25, `EP_API_TOKENS` (8) greedy new
   tokens: each process launches K2 once a layer for every tp rank and dp
   replica it holds (8, 4, 8, 16) and its plain version never; then each
   in float32 at `EP_API_F32_LAYERS` (2) layers on four short prompts,
   exact, and ep 2 x dp 2 at capacity factor 0.5: the streams equal one
   process's run on the same mesh (`divergence_ok`), the capacity run's
   differ from the exact one's.  Each prints its seconds and decode
   tokens/s (the float32 ones beside one process's, its chunks captured),
   the tp and ep groups' calls, bytes and host seconds and the peak
   memory.
34. sp — sequence-parallel inference (`parallel/sp_inference.py`) at
   Llama-3-8B's full width (4096 wide, 32 heads, 8 KV groups, hs 128) at
   `SP_LAYERS` (4) of its 32 layers, bf16, random weights: K2 with its LSE against its
   plain version at the sp 2 ring's block shapes (B=2, T=4096, causal and
   non-causal), ring attention's gradient (P=2, T=1024 per rank: K2, K3
   and K4 with the LSE's cotangent against the plain ring in float32,
   within `flash_bwd_bf16_limits` of the whole sequence times P plus P
   bf16 roundings; err/limit printed), then two prompts of 8128 and
   6000 random tokens, `SP_TOKENS` (8) greedy new tokens each, through the
   `Generator` (K2 once per layer) and `SPGenerator` at sp 2 with and
   without `use_flash` and at sp 4 with `use_flash, flash_min_len=1024`:
   K2 launches exactly P^2 x `SP_LAYERS` per flash prefill and 0 on the plain
   ring, every sample gets its 64 tokens; prints prefill seconds, decode
   tokens/s, each rank's KV bytes beside the Generator's cache and the
   bf16 divergences from the Generator's streams (printed with the
   top-2 gap there, not gated: the sp prefill's other attention
   arithmetic differs by roundings at every position).
   Then float32 at 4 layers: sp 2 and sp 4 on both routes give the
   Generator's streams (`divergence_ok`), and an `SPChatSession` of two
   turns around a Ctrl-C rollback gives the `ChatSession`'s replies.
35. ep — expert parallelism (`parallel/expert.py`), run after moe-train
   (listed there in the phase order): Mixtral-8x7B's published widths at
   `MOE_LAYERS` (4) bf16 layers (the moe phase's tree, drawn again from its
   seed: the card cannot hold it beside moe-quant's 32 int8 layers), the generate
   phase's four prompts of 1100-1900 tokens (bucket 2048), `EP_TOKENS`
   greedy new tokens in decode chunks of 8, twice (the first call
   captures, the second, counted, replays), through the dense `Generator`, the
   `--ep-devices` 2 and 4 Generators and the Generators on
   `make_mesh({"ep": 2, "tp": 2})` and `{"dp": 2, "ep": 2, "tp": 2}` at
   exact capacity (every position on the card): K2 exactly once per
   layer, tp rank and dp replica (attention runs once on the card beside
   an ep axis alone; 2L and 4L with tp, dp), the plain version never,
   every sample in the vocabulary; prints prefill seconds, decode
   tokens/s and their ratios to the dense Generator, whether decode
   replays graphs, and how many bf16 streams differ (not gated: router
   near-ties).  float32 at 4 layers, the fp tree and its int8 tree, two
   prompts of ~300 tokens, `EP_F32_TOKENS` (8) new tokens: ep 2, ep 4 and
   ep 2 x tp 2 give the dense
   Generator's greedy streams (`divergence_ok`), and dp 2 x ep 2 at
   capacity factor 0.5 gives ep 2's at that factor (one dispatch over the
   whole batch, as the JAX Generator routes it).
   Then the Trainer at moe-train's shape (2 layers, B=1, T=2048, bf16,
   flash, remat): dense (moe-train's counted steps of the same run, or
   measured here without that phase), then ep 2 and ep 4 at
   `moe_capacity_factor`
   None and 1.25, and on `{"ep": 2, "tp": 2}` at None, 3 counted steps
   each: K2 2 x 2, K3 and K4 2 per step (the layers run once over the
   batch; beside tp 2 once per rank, so 8, 4, 4), prints step seconds
   over the dense step, layer runs and peak memory.  float32 at 2 layers,
   capacity None: the loss and the first step's gradients of the ep 2 and
   ep 4 loss and of the ep 2 x tp 2 Trainer's loss equal the dense
   formulation's within B*T float32 roundings of each leaf's largest
   gradient (`grad_limit`).  Last, K2, K3 and K4 against their plain
   versions and SDPA at a tp 2 rank's geometry of Mixtral (16 heads, 4
   groups, hs 128, causal, B=1, T=2048, bf16).
36. sp-train — sequence-parallel training: K2 with the LSE, K3 and K4
   against their plain versions at the sp 2 Trainer's per-rank blocks
   (B=1, T=4096, 32 heads / 8 groups / hs 128, bf16, causal and
   non-causal); then Llama-3-8B's published widths at `SP_TRAIN_LAYERS` (4)
   of its 32 layers (AdamW's float32 state of all 32 does not fit beside
   the weights), B=1,
   T=8192, bf16, flash, remat: the unmeshed Trainer, then `--mesh sp=2`
   and `sp=4`, a warm-up and 3 counted steps each: K2 2 P^2 x 4, K3 and
   K4 P^2 x 4 per step; prints the step seconds over the unmeshed step,
   the peak memory and the activation memory per rank.  float32 at 4
   layers of tiny-llama-1.1b (mesh-train's cut) on `sp=2` and
   `dp=1,sp=2,tp=2`: every loss line within 1e-5 (relative) of the
   unmeshed Trainer's, the parameters after 3 steps within
   `MESH_PARAM_TOL`, and the first step's gradients within `grad_limit`.
37. preflight — the serve CLI's plan audit refusing and downgrading, in
   this process: `--hbm-gb 1` (below tiny-llama-1.1b's 2.05 GiB of
   weights) must exit before any weight reaches the card, with
   `torch.cuda.memory_allocated()` unchanged, printing the refusal and its
   finding; `--no-preflight` with the same budget prints the finding as a
   warning and serves 2 requests of 8 tokens (the passing `--hbm-gb 80`
   is the serve phase's).
38. doctor — `python -m mdi_llm_tpu_torch.cli.doctor`, the full staged
   triage, each stage in a fresh interpreter under its own timeout
   (import_torch, devices, matmul, kernels: K1 and K2 once against their
   plain versions within `TOL`'s bfloat16 1.5e-2, graph, profiler_trace,
   collective, threads): prints every stage's status and seconds, and
   fails unless each is ok or skipped and `kernels` is ok.

The line before the last is the JSON `kernels` record (K1, K1 over int8
pools, K2-K4, each with `paths`: its launches in every phase that drives
it, K1's `server` the closed submission's with the observer on, its
`quant` summed over the three quantized serves, K2's `quant` over the
three quantized generates, K1's `moe-quant` over the int8 and the three
4-layer serves, its `tune` the tuned serve's, its `pp-serve` over the
three ring serves, its `tp-serve` over the three tp serves, K2's
`tp-generate` the tp 2 generate's, K3's and K4's `moe-train` over the
three counted steps, K2's, K3's and K4's `mesh-train` over the five
meshes' counted bf16 steps, K1's `pp-tp-serve` over its two ring serves,
K2's `inference-procs` over the two processes' bf16 tp run, sp, ep and
API runs (both processes), K2's, K3's and K4's `mesh-train-procs` over
every run of its two processes, `mesh-train-quad` over every run of its
four, K2's `sp` over
the three bf16 sp prefills, K3's and K4's `sp` the counted ring
gradient's, K2's `ep` over the two ep prefills and the four ep Trainers'
counted steps, K3's and K4's `ep` over those steps, K2's `ep-tp` over the
ep 2 x tp 2 and dp 2 x ep 2 x tp 2 prefills and the ep 2 x tp 2
Trainer's counted steps, K3's and K4's `ep-tp` over those steps, K2's,
K3's and K4's
`sp-train` over the sp 2 and sp 4 Trainers' counted steps); the last line
is `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import importlib.util
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, per input type
TOL = {"float32": 1e-4, "bfloat16": 1.5e-2}
TINY_LLAMA = "tiny-llama-1.1b"


def fail(phase: str, msg: str) -> None:
    # on both streams: a caller that keeps only the end of one still reads why
    print(f"FAIL [{phase}] {msg}", flush=True)
    print(f"FAIL [{phase}] {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, n: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    # the host queues every launch while the card sleeps, so the events
    # time the launches back to back on the device, not the host's pace
    torch.cuda._sleep(100_000_000)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def make_case(spans, T, dtype, seed, H=32, G=4, hs=64, BS=16, MB=128):
    """A packed ragged batch over a random pool with shuffled blocks.
    spans: one (first position, n_tokens) per slot, n_tokens 0 = absent;
    rows past the spans are padding at a position past every table."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    S = len(spans)
    NB = 1 + S * MB
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    q, k, v = randn(1, H, T, hs), randn(NB, BS, G, hs), randn(NB, BS, G, hs)
    tables = rng.permutation(np.arange(1, NB))[: S * MB].reshape(S, MB)
    q_start, q_len = np.zeros(S, np.int32), np.zeros(S, np.int32)
    q_pos = np.full(T, MB * BS, np.int32)
    off = 0
    for s, (p0, n) in enumerate(spans):
        q_start[s], q_len[s] = off, n
        q_pos[off:off + n] = np.arange(p0, p0 + n)
        off += n
    lens = q_pos[np.clip(q_start, 0, T - 1)] + q_len
    dev = lambda a: torch.tensor(np.asarray(a, np.int32), device="cuda")
    return (q, k, v, dev(tables), dev(q_start), dev(q_len), dev(lens), dev(q_pos)), off


def bound(args, n_owned) -> tuple:
    """(least ms, what bounds it): each input byte read once (only the K/V
    rows below each present slot's lens, at the pool's element size, and
    an int8 pool's scales of the blocks under lens), each output byte
    written once, against the flops of QK and PV over the keys each owned
    row sees."""
    q, k, _, tables, _, q_len, lens, q_pos = args
    _, H, T, hs = q.shape
    payload = k["q"] if isinstance(k, dict) else k
    G, BS, item = payload.shape[2], payload.shape[1], q.element_size()
    live = lens[q_len > 0].long()
    nbytes = 2 * q.numel() * item + 2 * int(live.sum()) * G * hs * payload.element_size()
    if isinstance(k, dict):
        nbytes += 2 * 4 * G * int(((live + BS - 1) // BS).sum())
    nbytes += 4 * (tables.numel() + 3 * q_len.numel() + T)
    flops = 4 * H * hs * int((q_pos[:n_owned].long() + 1).sum())
    peak = PEAK_FLOPS[str(q.dtype).replace("torch.", "")]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_call(args, scale):
    """scaled_dot_product_attention on the gathered dense view of the same
    batch: per slot, its padded query rows against its contiguous K/V.  A
    narrow pool's view is dequantized (and cast to q's dtype) here, outside
    what is timed."""
    import torch
    import torch.nn.functional as F

    from mdi_llm_tpu_torch.ops.ragged_paged_attention import gather_paged_kv

    q, k, v, tables, q_start, q_len, _, q_pos = args
    kd, vd = (gather_paged_kv(x, tables).to(q.dtype) for x in (k, v))  # (S, G, W, hs)
    S, W = tables.shape[0], kd.shape[2]
    L = max(1, int(q_len.max()))
    rows = (q_start.long()[:, None] + torch.arange(L, device="cuda")[None]).clamp(max=q.shape[2] - 1)
    qd = q[0][:, rows].permute(1, 0, 2, 3).contiguous()  # (S, H, L, hs)
    live = torch.arange(L, device="cuda")[None] < q_len[:, None]
    pos = torch.where(live, q_pos.long()[rows], 0)
    mask = (torch.arange(W, device="cuda")[None, None] <= pos[..., None])[:, None]
    return lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, scale=scale, enable_gqa=True)


DECODE_DEPTHS = (37, 250, 511, 800, 1203, 1500, 1777, 2000)
K1_CASES = {  # label: (one (first position, n_tokens) per slot, T, head size)
    "decode": ([(d, 1) for d in DECODE_DEPTHS], 8, 64),
    "mixed": ([(d, 1) for d in (64, 700, 1400, 1999, 333, 1024)]
              + [(300, 128), (0, 0)], 136, 64),
    "verify": ([(d, 5) for d in (10, 400, 900, 1300, 1700, 2040, 555)] + [(0, 0)], 40, 64),
    # the split's edges: a slot at depth 2047 spans every chunk of the
    # 2048-key table; walks of 1024 and 128 keys end exactly on a chunk
    # boundary (a decode step's chunks are 64 keys, others' 128); a
    # shallow one fits the first chunk
    "split-edges": ([(2047, 1), (1023, 1), (127, 1), (5, 1)], 4, 64),
    "decode-hs32": ([(d, 1) for d in DECODE_DEPTHS], 8, 32),
    "decode-hs128": ([(d, 1) for d in DECODE_DEPTHS], 8, 128),
}


def phase_kernel(record):
    import torch

    from mdi_llm_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention,
        ragged_paged_attention_plain,
    )

    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        for label, (spans, T, hs) in K1_CASES.items():
            scale = hs ** -0.5
            args, owned = make_case(spans, T, dtype, seed=len(spans) + T, hs=hs)
            merges = ragged_paged_attention.merge_launches
            out = ragged_paged_attention(*args, scale=scale)
            torch.cuda.synchronize()
            merged = ragged_paged_attention.merge_launches - merges
            ref_args = [a.float() if a.is_floating_point() else a for a in args]
            ref = ragged_paged_attention_plain(*ref_args, scale=scale)
            err = (out.float()[:, :, :owned] - ref[:, :, :owned]).abs().max().item()
            pad = out[:, :, owned:].abs().max().item() if owned < T else 0.0
            if not err <= TOL[name] or pad != 0.0:
                fail("kernel", f"{name} {label}: max|err| {err} (tol {TOL[name]}), "
                     f"padding rows max {pad}")
            worst = max(worst, err)
            ms = cuda_ms(lambda: ragged_paged_attention(*args, scale=scale), 50)
            plain_ms = cuda_ms(lambda: ragged_paged_attention_plain(*args, scale=scale), 5)
            lib_ms = cuda_ms(library_call(args, scale), 20)
            b_ms, b_by = bound(args, owned)
            print(f"kernel: K1 {name} {label} T={T} hs={hs} max_abs_err={err:.3e} "
                  f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                  f"bound_ms={b_ms:.5f} ({b_by}) merge_launches={merged}", flush=True)
            if name == "bfloat16" and label == "decode":  # the main path's decode shape
                record.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                              bound_ms=b_ms, bound_by=b_by)
    record["max_abs_err"] = worst


SERVE_BASE = ["--model", TINY_LLAMA, "--dtype", "bfloat16", "--seed", "10137",
              "--max-batch", "8", "--block-size", "16", "--sequence-length", "2048"]


def served(phase, run, n_layer, draft_layers=0, plain_route=False):
    """`run()` -> (trace, results, stats, engine), with K1's and the plain
    route's counts set to 0 just before and read just after.  Fails unless
    the target has `n_layer` layers, every request finished with its
    budget in the vocabulary, and K1 ran exactly once per layer of every
    target and draft forward and the plain route never (`plain_route`:
    K1 never and the plain route did).  Returns (trace, results, stats
    line, engine, K1 launches)."""
    from mdi_llm_tpu_torch.cli import serve as cli
    from mdi_llm_tpu_torch.ops.ragged_paged_attention import ragged_paged_attention

    reset_k1_counts()
    trace, results, stats, engine = run()
    launches, plain = k1_counts()
    engine.k1_merge_launches = ragged_paged_attention.merge_launches
    want = 0 if plain_route else (n_layer * engine.forward_calls
                                  + draft_layers * engine.draft_forward_calls)
    if engine.gen.cfg.n_layer != n_layer or launches != want or (plain > 0) != plain_route \
            or (not plain_route and launches <= 0):
        fail(phase, f"K1 launches {launches}, plain route {plain}: want {want} = {n_layer} x "
             f"{engine.forward_calls} target + {draft_layers} x "
             f"{engine.draft_forward_calls} draft forwards on the "
             f"{'plain' if plain_route else 'kernel'} route")
    vocab = engine.gen.cfg.padded_vocab_size
    for rid, prompt, new in trace:
        out = results.get(rid)
        if out is None or len(out) - len(prompt) != new or not all(
                0 <= t < vocab for t in out[len(prompt):]):
            fail(phase, f"{rid} did not finish with its {new} tokens in the vocabulary")
    line = cli.stats_line(stats, engine, [len(p) + n / 2 for _rid, p, n in trace])
    return trace, results, line, engine, launches


def serve_checked(phase, argv, draft_layers=0, n_layer=22):
    """The serve CLI on `argv`, checked by `served`; returns (stats line,
    K1 launches, engine, results)."""
    from mdi_llm_tpu_torch.cli import serve as cli

    args = cli.build_parser().parse_args(argv)
    _trace, results, line, engine, launches = served(
        phase, lambda: cli.serve(args)[:4], n_layer, draft_layers)
    return line, launches, engine, results


AUDIT_PEAK_TOL = 0.15  # the audit's per-device total against the serve's peak allocation


def audit_checked(phase, engine, label, peak=None) -> dict:
    """The plan audit the serve CLI made before loading the weights
    (`engine.audit`) against the engine's live tensors: the params bytes
    per device equal each tp rank's shard tree's (the weights' without a
    mesh) and the pool bytes per device each rank's pool's, scales
    included, exactly; with `peak` (max_memory_allocated over the serve)
    the per-device total lies within AUDIT_PEAK_TOL of it.  Returns what
    it compared."""
    from mdi_llm_tpu_torch.models import transformer

    rep = engine.audit
    dev, pool = rep.breakdown["per_device"], rep.breakdown["kv_pool"]
    nbytes = lambda tree: sum(int(x.nbytes) for x in transformer.tree_leaves(tree))
    gen = engine.gen
    if gen._shards is None:
        params, pools = [nbytes(gen.params)], [nbytes(engine._kv)]
    else:
        params = [nbytes(gen._shards[r]) for r in sorted(gen._shards)]
        pools = [nbytes(engine._kv[r]) for r in sorted(engine._kv)]
    out = {"audit_params_bytes": dev["params_bytes"], "live_params_bytes": params,
           "audit_pool_bytes": pool["pool_bytes_per_device"], "live_pool_bytes": pools,
           "audit_total_bytes": dev["total_bytes"], "errors": len(rep.errors)}
    if rep.errors or set(params) != {dev["params_bytes"]} \
            or set(pools) != {pool["pool_bytes_per_device"]} or sum(pools) != pool["pool_bytes"]:
        fail(phase, f"{label}: the plan audit against the live tensors: {out}")
    if peak is not None:
        out.update(peak_allocated_bytes=peak, audit_over_peak=dev["total_bytes"] / peak)
        if not abs(dev["total_bytes"] - peak) <= AUDIT_PEAK_TOL * peak:
            fail(phase, f"{label}: the audit's total {dev['total_bytes']} B is not within "
                 f"{AUDIT_PEAK_TOL:.0%} of the serve's peak allocation {peak} B")
    return out


def k1_smem_checked(phase, engine) -> dict:
    """The audit's K1 shared memory for the serve's entry against the size
    the launch requests (from the built library) and the card's opt-in
    limit per block, which must be the audit's limit for the card."""
    import torch

    from mdi_llm_tpu_torch.models import transformer
    from mdi_llm_tpu_torch.ops import ragged_paged_attention as rpa

    pool = engine.audit.breakdown["kv_pool"]
    leaf = engine._kv[0] if engine.gen._shards is not None else engine._kv
    payload = rpa._pool_parts(leaf["k"])[0]
    launch = rpa.launch_smem_bytes(transformer.param_dtype(engine.gen.params), payload.dtype,
                                   engine.gen.cfg.head_size)
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    out = {"kernel_key": pool["kernel_key"], "audit_smem_bytes": pool["k1_smem_bytes"],
           "launch_smem_bytes": launch, "card_optin_bytes": optin,
           "audit_limit_bytes": pool["k1_smem_limit"]}
    if pool["k1_smem_bytes"] != launch or launch > optin or pool["k1_smem_limit"] != optin:
        fail(phase, f"K1 shared memory: {out}")
    return out


def serve_peak_checked(phase, argv):
    """`serve_checked` with the peak allocation of the serve itself: the
    engine built (weights drawn, pool allocated, steps captured), the peak
    reset, the trace run; what this process held before the build (earlier
    phases' tensors) taken out.  (Drawing random weights peaks higher: each
    leaf is drawn in float32 and cast, a transient no checkpoint load has.)
    Returns (stats line, K1 launches, engine, results, peak bytes)."""
    import torch

    from mdi_llm_tpu_torch.cli import serve as cli

    args = cli.build_parser().parse_args(argv)
    peak = {}

    def run():
        held = torch.cuda.memory_allocated()
        trace, engine, _tok = cli.build(args)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        results, stats = engine.run()
        peak["bytes"] = torch.cuda.max_memory_allocated() - held
        return trace, results, stats, engine

    _trace, results, line, engine, launches = served(phase, run, 22)
    return line, launches, engine, results, peak["bytes"]


SINGLE_REFS = {}  # tuple(argv): the single engine's (stats line, Generator, results)


def single_reference(phase, argv):
    """The single engine's run of the serve CLI on `argv` that the split
    engines (pp-serve, tp-serve, pp-tp-serve) are held against, at their
    `RING_SERVE_LAYERS`: served and checked once per argv in this process,
    then reused.  Returns
    (stats line, its Generator, results)."""
    key = tuple(argv)
    if key not in SINGLE_REFS:
        line, _launches, engine, results = serve_checked(phase, argv, n_layer=RING_SERVE_LAYERS)
        SINGLE_REFS[key] = (line, engine.gen, results)
        del engine
        free()
    return SINGLE_REFS[key]


def phase_serve(record):
    import torch

    from mdi_llm_tpu_torch.cli import serve as cli

    # warm-up (CUDA context, cuBLAS handles), not counted
    cli.serve(cli.build_parser().parse_args(SERVE_BASE + ["--synthetic", "2", "--n-tokens", "8"]))
    free()
    line, launches, engine, results, peak = serve_peak_checked(
        "serve", SERVE_BASE + ["--synthetic", "16", "--n-tokens", "64", "--hbm-gb", "80"])
    audit = audit_checked("serve", engine, "bf16 pool", peak)
    smem = k1_smem_checked("serve", engine)
    print("serve: " + json.dumps({k: line[k] for k in (
        "requests", "tokens_generated", "tokens_per_s", "wall_s", "decode_s",
        "prefill_s", "mixed_steps", "decode_steps", "host_syncs",
        "kv_block_utilization_mean", "kv_block_utilization_peak", "forward_calls",
        "graph_captures", "graph_replays", "capture_s")}),
        flush=True)
    print(f"serve: K1 launches {launches} = {engine.gen.cfg.n_layer} per forward x "
          f"{engine.forward_calls} forwards, its merge kernel "
          f"{engine.k1_merge_launches} ({line['mixed_steps']} mixed steps, "
          f"{line['decode_steps']} decode steps in chunks of {engine.cfg.decode_chunk}); "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print("serve: plan audit (--hbm-gb 80) vs the live engine: " + json.dumps(audit), flush=True)
    print("serve: K1 shared memory: " + json.dumps(smem), flush=True)
    record["launches"] = launches
    record.setdefault("paths", {})["serve"] = launches
    # the analysis phase runs on this engine, right after this phase
    SERVE_RUN.update(engine=engine, peak=peak, audit=audit, results=results)


SERVE_RUN = {}  # the serve phase's engine, peak allocation, audit comparison and streams
# a step's static temporaries + outputs (the flow's) against one eager run
# of its body on the card (max_memory_allocated less what was held): the
# static model frees each value at its last use, eager Python at its
# last reference (a decode step's logits live on through the next step's
# forward); measured 0.9145 (mixed) and 0.7738 (decode chunk) static over
# measured on NVIDIA H100 80GB HBM3, 700.00 W (PERF.md, PR 20)
ANALYSIS_PEAK_TOL = 0.30


def phase_analysis(card):
    """The compiled-program analysis on the serve phase's engine (the
    module docstring, phase 4a)."""
    import torch

    from mdi_llm_tpu_torch.analysis import ir, liveness
    from mdi_llm_tpu_torch.analysis.audit import audit_plan
    from mdi_llm_tpu_torch.analysis.trace import kernel_nodes, trace_step
    from mdi_llm_tpu_torch.ops import tuning
    from mdi_llm_tpu_torch.utils.step_graph import kernel_counters

    if "engine" not in SERVE_RUN:
        fail("analysis", "needs the serve phase's engine: run it with --only serve,analysis")
    engine, peak = SERVE_RUN.pop("engine"), SERVE_RUN["peak"]
    gen, cfg = engine.gen, engine.gen.cfg
    kind = torch.cuda.get_device_name(0)
    counts = lambda: [getattr(o, a) for o, a in kernel_counters()] + [  # noqa: E731
        engine.forward_calls, gen.rng.get_state().sum().item(),
        engine._rng.get_state().sum().item()]
    before = counts()
    t0 = time.perf_counter()
    traces = ir.trace_engine(engine)
    trace_s = time.perf_counter() - t0
    if counts() != before:
        fail("analysis", f"tracing moved a counter or a generator: {before} -> {counts()}")
    # 1. the enumerated set against the live engine's captured steps (this
    # serve dispatches no eager step: no spec_k, no host tier)
    enumerated = {(t.spec.label, tuple(t.spec.key)) for t in traces}
    captured = {(label, tuple(st.key[:-2])) for label, st in engine._steps.items()}
    if engine.cfg.spec_k or engine.cfg.host_pool_mib or enumerated != captured:
        fail("analysis", f"enumerated {sorted(enumerated)} != captured {sorted(captured)}")
    failed = [t.spec.name for t in traces if t.error is not None]
    if failed:
        fail("analysis", f"steps that did not trace: {failed}")
    # 2. K1 nodes per traced step against the step's captured launch delta
    k1_nodes = {}
    for t in traces:
        st = engine._steps[t.spec.label]
        k = kernel_nodes(t.graph)
        delta = dict(zip(("launches", "merges"), st._deltas[:2]))
        k1_nodes[t.spec.name] = {"nodes": k["ragged_paged_attention"], "merge_nodes": k["merge"],
                                 "captured_launches": delta["launches"],
                                 "captured_merges": delta["merges"]}
        forwards = {"mixed": 1, "decode_chunk": engine.cfg.decode_chunk}[t.spec.label]
        if k["ragged_paged_attention"] != delta["launches"] \
                or delta["launches"] != cfg.n_layer * forwards \
                or k["merge"] != delta["merges"] or k["flash_attention"]:
            fail("analysis", f"{t.spec.name}: traced {k} against the captured delta {delta}")
    # 3. K2 nodes in the traced prefill of the generate phase's workload
    pre = gen.enumerate_executables(batch_size=4, prompt_len=1900, max_new_tokens=64,
                                    chunk_size=16)[0]
    with tuning.planned_device(kind):
        pre_traced = trace_step(pre)
    k2 = kernel_nodes(pre_traced.graph)["flash_attention"] if pre_traced.graph else None
    if pre.name != "prefill(4,2048)" or k2 != cfg.n_layer or cfg.n_layer != 22:
        fail("analysis", f"{pre.name}: {k2} K2 nodes, want the generate phase's 22")
    # 4. each step's static temporaries + outputs against one eager run of
    # its body on the card, over inert (zero) inputs as at capture, with
    # every counter and generator put back
    _, profiles = liveness.analyze_flow(traces, origin="analysis")
    peaks = {}
    for p in profiles:
        st = engine._steps[p.label]
        st.load(**{k: torch.zeros_like(v) for k, v in st.inputs.items()})
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        st._held(st.call)
        torch.cuda.synchronize()
        measured = torch.cuda.max_memory_allocated() - held
        static = p.temp_peak_bytes + p.output_bytes - p.alias_bytes
        peaks[p.name] = {"static_bytes": static, "measured_bytes": measured,
                         "static_over_measured": round(static / measured, 4),
                         "temp_peak_bytes": p.temp_peak_bytes, "nodes": p.nodes}
        if abs(static - measured) > ANALYSIS_PEAK_TOL * measured:
            fail("analysis", f"{p.name}: static {static} B vs measured {measured} B "
                 f"(tolerance {ANALYSIS_PEAK_TOL:.0%})")
    if counts() != before:
        fail("analysis", "the eager runs moved a counter or a generator")
    # 5. audit --liveness against the serve's peak, beside the analytic term
    heur = engine.audit.breakdown["per_device"]
    t1 = time.perf_counter()
    lv = audit_plan(engine.audit.plan, liveness=True).breakdown["per_device"]
    audit_s = time.perf_counter() - t1
    if lv["act_source"] != "liveness" or lv["act_bytes"] != max(
            p.temp_peak_bytes for p in profiles):
        fail("analysis", f"audit --liveness: {lv}, flow's worst temporaries "
             f"{max(p.temp_peak_bytes for p in profiles)}")
    audit = {"peak_allocated_bytes": peak,
             "liveness_total_bytes": lv["total_bytes"], "liveness_act_bytes": lv["act_bytes"],
             "liveness_over_peak": round(lv["total_bytes"] / peak, 4),
             "heuristic_total_bytes": heur["total_bytes"], "heuristic_act_bytes": heur["act_bytes"],
             "heuristic_over_peak": round(heur["total_bytes"] / peak, 4),
             "audit_liveness_s": round(audit_s, 3)}
    if not abs(lv["total_bytes"] - peak) <= AUDIT_PEAK_TOL * peak:
        fail("analysis", f"audit --liveness total {lv['total_bytes']} B is not within "
             f"{AUDIT_PEAK_TOL:.0%} of the serve's peak {peak} B")
    dispatch = op_dispatch_us()
    pre_s = engine.preflight
    print(f"analysis: {card}: {len(traces)} steps traced on the meta device in {trace_s:.2f} s "
          f"(serve preflights at full width: ir {pre_s['ir']['seconds']} s with the trace, "
          f"flow {pre_s['liveness']['seconds']} s); counters and generators unchanged", flush=True)
    print("analysis: K1 nodes against the captured launch deltas: " + json.dumps(k1_nodes),
          flush=True)
    print(f"analysis: {pre.name} traced with {k2} K2 nodes = the generate phase's "
          f"{cfg.n_layer} launches per flash prefill", flush=True)
    print(f"analysis: static temporaries + outputs vs one eager run (tolerance "
          f"{ANALYSIS_PEAK_TOL:.0%}): " + json.dumps(peaks), flush=True)
    print("analysis: audit --liveness vs the serve's peak: " + json.dumps(audit), flush=True)
    print("analysis: host us per eager call, through torch.ops.mdi_torch against the launch it "
          "wraps (tiny-llama decode / prefill shapes): " + json.dumps(dispatch), flush=True)
    del engine
    free()


def op_dispatch_us(n=400) -> dict:
    """What K1's and K2's operators add per eager call: host microseconds
    per call of `torch.ops.mdi_torch.*` and of the CUDA implementation it
    dispatches to, on the same inputs (K1 at an 8-lane decode over a
    64-block pool, K2 at a 16-token chunk: the kernels are short, the host
    enqueue sets the pace), in turns op, direct, direct, op; every counter
    put back."""
    import torch

    from mdi_llm_tpu_torch.ops import flash as fl
    from mdi_llm_tpu_torch.ops import ragged_paged_attention as rpa
    from mdi_llm_tpu_torch.utils.step_graph import kernel_counters

    before = [getattr(o, a) for o, a in kernel_counters()]
    dev, bf16, i32 = "cuda", torch.bfloat16, torch.int32
    q = torch.randn(1, 32, 8, 64, device=dev, dtype=bf16)
    kv = torch.randn(64, 16, 4, 64, device=dev, dtype=bf16)
    tables = torch.arange(32, device=dev, dtype=i32).reshape(8, 4)
    ones = torch.ones(8, device=dev, dtype=i32)
    k1 = (q, kv, kv, None, None, tables, torch.arange(8, device=dev, dtype=i32), ones,
          ones * 40, torch.full((8,), 39, device=dev, dtype=i32), 0.125, 64, 1)
    qf = torch.randn(1, 32, 16, 64, device=dev, dtype=bf16)
    kf = torch.randn(1, 4, 16, 64, device=dev, dtype=bf16)
    k2 = (qf, kf, kf, 0.125, True, False)
    out = {}
    for name, op, direct, args in (("K1", rpa.OP, rpa._launch, k1),
                                   ("K2", fl.OP, fl._launch_op, k2)):
        times = {"op": [], "direct": []}
        for route in ("op", "direct", "direct", "op"):
            fn = op if route == "op" else direct
            fn(*args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn(*args)
            torch.cuda.synchronize()
            times[route].append((time.perf_counter() - t0) / n * 1e6)
        out[name] = {k: round(min(v), 2) for k, v in times.items()}
        out[name]["added_us"] = round(out[name]["op"] - out[name]["direct"], 2)
    for (o, a), v in zip(kernel_counters(), before):
        setattr(o, a, v)
    return out


def phase_serve_parity():
    import torch

    from mdi_llm_tpu_torch.cli.serve import synthetic_trace
    from mdi_llm_tpu_torch.config import Config
    from mdi_llm_tpu_torch.generation import Generator
    from mdi_llm_tpu_torch.models import transformer
    from mdi_llm_tpu_torch.ops import paged_attention as pa
    from mdi_llm_tpu_torch.ops.ragged_paged_attention import ragged_paged_attention

    cfg = Config.from_name(TINY_LLAMA, n_layer=4)
    params = transformer.init_params(cfg, 10137, dtype=torch.float32, device="cuda")
    gen = Generator(cfg, params, max_seq_length=2048, device="cuda")
    trace = synthetic_trace(4, cfg.vocab_size, 2048, 16)
    streams = {}
    for route, use_kernel in (("kernel", None), ("plain", False)):
        ragged_paged_attention.launches = 0
        pa._paged_prefill_plain.calls = pa._paged_attention_plain.calls = 0
        engine = gen.serve(block_size=16, max_batch=8, use_kernel=use_kernel)
        for rid, prompt, new in trace:
            engine.add_request(rid, prompt, new)
        streams[route], _ = engine.run()
        launched = ragged_paged_attention.launches
        plain = pa._paged_prefill_plain.calls + pa._paged_attention_plain.calls
        if (launched > 0, plain > 0) != (route == "kernel", route == "plain"):
            fail("serve-parity", f"the {route} run launched K1 {launched} times "
                 f"and took the plain route {plain} times")
    divergence_ok("serve-parity", gen, streams["kernel"], streams["plain"], "K1 vs plain")
    n = sum(len(v) for v in streams["kernel"].values())
    same = sum(streams["kernel"][r] == streams["plain"][r] for r in streams["plain"])
    print(f"serve-parity: float32, {cfg.n_layer} layers x {cfg.n_embd}: "
          f"{same} of {len(trace)} greedy streams ({n} tokens) identical through K1 "
          "and the plain route", flush=True)


def narrow_pools(k, v, kind, seed):
    """The case's pools stored as `kind`: an int8 pool gets payloads drawn
    from [-127, 127] and scales drawn from [0.5, 2.5] / 127 per (block,
    group); a float8 pool is the case's draws cast."""
    import torch

    if kind != "int8":
        return k.float().to(getattr(torch, kind)), v.float().to(getattr(torch, kind))
    g = torch.Generator(device="cuda").manual_seed(seed)

    def one(x):
        NB, _, G, _ = x.shape
        payload = torch.randint(-127, 128, x.shape, generator=g, device="cuda").to(torch.int8)
        return {"q": payload,
                "scale": (0.5 + 2 * torch.rand((NB, G), generator=g, device="cuda")) / 127}

    return one(k), one(v)


def phase_kernel_q8(record):
    """K1 over int8 and float8 pools against its plain version in float32
    on the same stored pool (tolerances as in `phase_kernel`)."""
    import torch

    from mdi_llm_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention,
        ragged_paged_attention_plain,
    )

    worst = 0.0
    for kind in ("int8", "float8_e4m3fn", "float8_e5m2"):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            for label, (spans, T, hs) in K1_CASES.items():
                scale = hs ** -0.5
                args, owned = make_case(spans, T, dtype, seed=len(spans) + T, hs=hs)
                kp, vp = narrow_pools(args[1], args[2], kind, seed=T)
                args = (args[0], kp, vp) + args[3:]
                out = ragged_paged_attention(*args, scale=scale)
                torch.cuda.synchronize()
                ref = ragged_paged_attention_plain(args[0].float(), *args[1:], scale=scale)
                err = (out.float()[:, :, :owned] - ref[:, :, :owned]).abs().max().item()
                pad = out[:, :, owned:].abs().max().item() if owned < T else 0.0
                if not err <= TOL[name] or pad != 0.0:
                    fail("kernel-q8", f"{kind} pool, q {name} {label}: max|err| {err} "
                         f"(tol {TOL[name]}), padding rows max {pad}")
                ms = cuda_ms(lambda: ragged_paged_attention(*args, scale=scale), 50)
                plain_ms = cuda_ms(lambda: ragged_paged_attention_plain(*args, scale=scale), 5)
                lib_ms = cuda_ms(library_call(args, scale), 20)
                b_ms, b_by = bound(args, owned)
                print(f"kernel-q8: K1 {kind} pool, q {name} {label} T={T} hs={hs} "
                      f"max_abs_err={err:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f} "
                      f"library_ms={lib_ms:.4f} (SDPA on the dequantized view, dequant "
                      f"untimed) bound_ms={b_ms:.5f} ({b_by})", flush=True)
                if kind == "int8":
                    worst = max(worst, err)
                    if name == "bfloat16" and label == "decode":  # the main path's shape
                        record.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                      bound_ms=b_ms, bound_by=b_by)
                del args, kp, vp, out, ref
            torch.cuda.empty_cache()
    record["max_abs_err"] = worst


def phase_serve_q8(record):
    import torch

    from mdi_llm_tpu_torch.serving.engine import pool_bytes

    run = SERVE_BASE + ["--synthetic", "16", "--n-tokens", "64"]
    serve_checked("serve-q8", SERVE_BASE + ["--synthetic", "2", "--n-tokens", "8",
                                            "--kv-dtype", "int8"])  # warm-up
    for kv in ("int8", "float8"):
        free()
        line, launches, engine, _results, peak = serve_peak_checked(
            "serve-q8", run + ["--kv-dtype", kv])
        # the 15% bound is held over the int8 pool (and the serve phase's
        # bf16 one); the e4m3 pool's bytes are held exactly, its peak printed
        audit = audit_checked("serve-q8", engine, f"{kv} pool", peak if kv == "int8" else None)
        audit["peak_allocated_bytes"] = peak
        print(f"serve-q8: --kv-dtype {kv}: plan audit vs the live engine: " + json.dumps(audit)
              + "; K1 shared memory: " + json.dumps(k1_smem_checked("serve-q8", engine)),
              flush=True)
        cfg, nb = engine.gen.cfg, engine.pool.num_blocks
        bf16 = 2 * cfg.n_layer * nb * engine.cfg.block_size * cfg.n_query_groups * cfg.head_size * 2
        scales = sum(x["scale"].numel() * 4 for x in engine._kv.values()) if kv == "int8" else 0
        print(f"serve-q8: --kv-dtype {kv} ({line['kv_dtype']}): " + json.dumps({k: line[k] for k in (
            "requests", "tokens_generated", "tokens_per_s", "wall_s", "decode_s", "prefill_s",
            "mixed_steps", "decode_steps", "host_syncs", "forward_calls", "graph_captures",
            "capture_s")}), flush=True)
        print(f"serve-q8: --kv-dtype {kv}: K1 launches {launches} = {cfg.n_layer} per "
              f"forward x {engine.forward_calls} forwards, its merge kernel "
              f"{engine.k1_merge_launches}; pool {nb} blocks = "
              f"{pool_bytes(engine._kv) / 1e6:.2f} MB ({scales / 1e6:.3f} MB of scales) "
              f"against {bf16 / 1e6:.2f} MB as bf16", flush=True)
        if kv == "int8":
            record["launches"] = launches
            record.setdefault("paths", {})["serve-q8"] = launches
        del engine
        torch.cuda.empty_cache()


def divergence_ok(phase, gen, got, want, label) -> None:
    """Compare two dicts of greedy streams; where a stream diverges, print
    the first divergent position and the float32 model's top-2 logit gap
    there (a dense forward over the common prefix), and fail unless that
    gap is below 1e-4."""
    import torch

    from mdi_llm_tpu_torch.models import transformer

    for rid, w in want.items():
        g = got.get(rid)
        if g == w:
            continue
        if g is None:
            fail(phase, f"{label}: {rid} did not finish")
        i = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), min(len(g), len(w)))
        toks = torch.tensor([w[:i]], device="cuda")
        with torch.no_grad():
            logits = transformer.forward(gen.cfg, gen.params, toks,
                                         torch.zeros(1, dtype=torch.long, device="cuda"))
        top = torch.topk(logits[0, -1].float(), 2).values
        gap = (top[0] - top[1]).item()
        print(f"{phase}: {label}: {rid} diverges at position {i} (tokens "
              f"{g[i] if i < len(g) else None} vs {w[i] if i < len(w) else None}); "
              f"top-2 logit gap there {gap:.3e}", flush=True)
        if not gap < 1e-4:
            fail(phase, f"{label}: {rid} diverges at position {i} with a top-2 gap of {gap}")


def phase_serve_q8_parity():
    import torch

    from mdi_llm_tpu_torch.cli.serve import synthetic_trace
    from mdi_llm_tpu_torch.ops import paged_attention as pa
    from mdi_llm_tpu_torch.ops.ragged_paged_attention import ragged_paged_attention

    gen = tiny_llama_generator(4, torch.float32)
    trace = synthetic_trace(4, gen.cfg.vocab_size, 2048, 16)
    for kv in ("int8", "float8_e4m3fn"):
        streams = {}
        for route, use_kernel in (("kernel", None), ("plain", False)):
            ragged_paged_attention.launches = 0
            pa._paged_prefill_plain.calls = pa._paged_attention_plain.calls = 0
            engine = gen.serve(block_size=16, max_batch=8, use_kernel=use_kernel, kv_dtype=kv)
            for rid, prompt, new in trace:
                engine.add_request(rid, prompt, new)
            streams[route], _ = engine.run()
            launched = ragged_paged_attention.launches
            plain = pa._paged_prefill_plain.calls + pa._paged_attention_plain.calls
            if launched != (4 * engine.forward_calls if route == "kernel" else 0) or \
                    (plain > 0) != (route == "plain"):
                fail("serve-q8-parity", f"{kv}: the {route} run launched K1 {launched} "
                     f"times and took the plain route {plain} times")
            del engine
        divergence_ok("serve-q8-parity", gen, streams["kernel"], streams["plain"], kv)
        n = sum(len(v) for v in streams["kernel"].values())
        same = sum(streams["kernel"][r] == streams["plain"][r] for r in streams["plain"])
        print(f"serve-q8-parity: float32, {kv} pool, 4 layers x {gen.cfg.n_embd}: "
              f"{same} of {len(trace)} greedy streams ({n} tokens) identical through K1 "
              "and the plain route", flush=True)
    del gen
    torch.cuda.empty_cache()


SPEC_TOKENS = 16  # new tokens per request of the spec phase's eager verify steps (32 before
# the cuts for the layouts over processes)


def phase_spec():
    import torch

    draft = ["--spec-k", "4", "--draft-model", "NanoLlama"]
    run = SERVE_BASE + ["--synthetic", "8", "--n-tokens", str(SPEC_TOKENS)] + draft
    for label, extra in (("greedy, bf16 pool", []),
                         ("temperature 0.8, int8 pool", ["--kv-dtype", "int8",
                                                         "--temperature", "0.8"])):
        line, launches, engine, _results = serve_checked("spec", run + extra, draft_layers=12)
        if engine.draft_gen.cfg.n_layer != 12 or not line["spec_drafted"] > 0:
            fail("spec", f"{label}: spec_drafted {line['spec_drafted']}, draft layers "
                 f"{engine.draft_gen.cfg.n_layer}")
        if not extra and not line["spec_drafted_model"] > 0:
            fail("spec", f"{label}: the draft model never drafted")
        print(f"spec: {label}: " + json.dumps({k: line[k] for k in (
            "requests", "tokens_generated", "tokens_per_s", "wall_s", "decode_steps",
            "mixed_steps", "host_syncs", "spec_drafted", "spec_accepted",
            "spec_drafted_ngram", "spec_drafted_model", "spec_accepted_model",
            "forward_calls", "draft_forward_calls", "kv_dtype")}), flush=True)
        print(f"spec: {label}: K1 launches {launches} = 22 x {engine.forward_calls} "
              f"target + 12 x {engine.draft_forward_calls} draft forwards, its merge "
              f"kernel {engine.k1_merge_launches}", flush=True)
        del engine
        torch.cuda.empty_cache()


def phase_spec_parity():
    import torch

    from mdi_llm_tpu_torch.cli.serve import synthetic_trace
    from mdi_llm_tpu_torch.config import Config
    from mdi_llm_tpu_torch.generation import Generator
    from mdi_llm_tpu_torch.models import transformer
    from mdi_llm_tpu_torch.ops import paged_attention as pa
    from mdi_llm_tpu_torch.ops.ragged_paged_attention import ragged_paged_attention

    gen = tiny_llama_generator(4, torch.float32)
    dcfg = Config.from_name("NanoLlama", n_layer=2)
    dgen = Generator(dcfg, transformer.init_params(dcfg, 0, device="cuda"),
                     max_seq_length=2048, device="cuda")
    trace = synthetic_trace(4, gen.cfg.vocab_size, 2048, 16)
    streams = {}
    for label, knobs in (("plain decode", {}),
                         ("spec_k=4 + draft", dict(spec_k=4, draft_model="NanoLlama"))):
        ragged_paged_attention.launches = 0
        pa._paged_prefill_plain.calls = pa._paged_attention_plain.calls = 0
        engine = gen.serve(block_size=16, max_batch=8, draft_gen=dgen if knobs else None,
                           **knobs)
        for rid, prompt, new in trace:
            engine.add_request(rid, prompt, new)
        streams[label], stats = engine.run()
        want = 4 * engine.forward_calls + 2 * engine.draft_forward_calls
        plain = pa._paged_prefill_plain.calls + pa._paged_attention_plain.calls
        if ragged_paged_attention.launches != want or plain:
            fail("spec-parity", f"{label}: K1 launches {ragged_paged_attention.launches} "
                 f"(want {want}), plain route {plain}")
        if knobs and not stats.spec_drafted_model > 0:
            fail("spec-parity", "the draft model never drafted")
        del engine
    divergence_ok("spec-parity", gen, streams["spec_k=4 + draft"], streams["plain decode"],
                  "spec vs plain decode")
    print(f"spec-parity: float32, 4 layers x {gen.cfg.n_embd}, 2-layer NanoLlama draft: "
          f"spec_k=4 streams ({stats.spec_drafted} drafted, {stats.spec_accepted} "
          f"accepted, {stats.spec_drafted_model} by the model) against plain decode, "
          "all on K1", flush=True)
    del gen, dgen
    torch.cuda.empty_cache()


FLASH_SHAPES = {  # label: (B, T, causal, with_lse, head size)
    "main": (4, 2048, True, False, 64),
    "ragged": (2, 1000, True, True, 64),
    "noncausal": (2, 512, False, True, 64),
}
# bfloat16 only (the tensor-core kernel's edges): other head sizes, chunks
# shorter than one 128-row tile or 64-key tile, non-causal at hs 128
FLASH_BF16_SHAPES = {
    **{f"hs{hs}-T{T}": (1, T, True, True, hs) for hs in (32, 128) for T in (1, 7, 100)},
    "hs128-noncausal": (2, 512, False, True, 128),
}


def flash_bound(B, H, G, T, hs, dtype, causal, with_lse) -> tuple:
    """(least ms, what bounds it) for K2: q, k, v read once, the output
    (and LSE) written once, against 4 * hs flops per (head, query, key)
    pair the mask lets through."""
    import torch

    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * B * H + 2 * B * G) * T * hs * item + (4 * B * H * T if with_lse else 0)
    pairs = T * (T + 1) // 2 if causal else T * T
    flops = 4 * B * H * hs * pairs
    peak = PEAK_FLOPS[str(dtype).replace("torch.", "")]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_inputs(B, T, dtype, seed, H=32, G=4, hs=64):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(dtype)
            for shape in ((B, H, T, hs), (B, G, T, hs), (B, G, T, hs))]


def phase_flash(record):
    import torch
    import torch.nn.functional as F

    from mdi_llm_tpu_torch.ops.attention import multihead_attention
    from mdi_llm_tpu_torch.ops.flash import (
        flash_attention,
        flash_attention_lse,
        flash_attention_plain,
    )

    worst = 0.0
    cases = [(torch.float32, label, shape) for label, shape in FLASH_SHAPES.items()]
    cases += [(torch.bfloat16, label, shape) for label, shape in
              {**FLASH_SHAPES, **FLASH_BF16_SHAPES}.items()]
    for dtype, label, (B, T, causal, with_lse, hs) in cases:
        name = str(dtype).replace("torch.", "")
        q, k, v = flash_inputs(B, T, dtype, seed=T + B, hs=hs)
        if with_lse:
            run = lambda: flash_attention_lse(q, k, v, causal=causal)  # noqa: E731
        else:
            run = lambda: (flash_attention(q, k, v), None)  # noqa: E731
        out, lse = run()
        torch.cuda.synchronize()
        ref, ref_lse = flash_attention_plain(q.float(), k.float(), v.float(),
                                             causal=causal)
        err = (out.float() - ref).abs().max().item()
        if with_lse:
            err = max(err, (lse - ref_lse).abs().max().item())
        del ref, ref_lse
        if not err <= TOL[name]:
            fail("flash", f"{name} {label}: max|err| {err} (tol {TOL[name]})")
        worst = max(worst, err)
        ms = cuda_ms(run, 20)
        plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, causal=causal), 3)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True), 20)
        b_ms, b_by = flash_bound(B, 32, 4, T, hs, dtype, causal, with_lse)
        print(f"flash: K2 {name} {label} B={B} T={T} hs={hs} causal={causal} "
              f"lse={with_lse} max_abs_err={err:.3e} ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
              f"bound_ms={b_ms:.5f} ({b_by})", flush=True)
        if name == "bfloat16" and label == "main":  # the generate phase's shape
            record.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=b_ms, bound_by=b_by)
        torch.cuda.empty_cache()
    record["max_abs_err"] = worst
    # the crossover: K2 against the dense route a prefill takes without flash
    for T in (256, 512, 1024, 2048):
        q, k, v = flash_inputs(4, T, torch.bfloat16, seed=T)
        pos = torch.arange(T, device="cuda").expand(4, T)
        ms = cuda_ms(lambda: flash_attention(q, k, v), 20)
        dense_ms = cuda_ms(lambda: multihead_attention(q, k, v, pos, k_pos=pos), 10)
        print(f"flash: crossover bfloat16 B=4 T={T}: K2 ms={ms:.4f} dense-route "
              f"ms={dense_ms:.4f} (dense/K2 {dense_ms / ms:.3f})", flush=True)
        torch.cuda.empty_cache()


BWD_F32_TOL = 1e-4  # a float32 output: x max(1, max |plain|)
FLASH_BWD_SHAPES = {  # label: (B, T, causal, with an LSE cotangent, head size)
    "main": (4, 2048, True, False, 64),
    "ragged": (2, 1000, True, False, 64),
    "noncausal": (2, 512, False, True, 64),
}
# bfloat16 only (every instance of the tensor-core kernels, and their
# edges): head sizes 32 and 128 at a ragged T, non-causal with an LSE
# cotangent at a T that is no multiple of 64, a chunk shorter than a tile
FLASH_BWD_BF16_SHAPES = {
    "hs32": (1, 1000, True, False, 32),
    "hs128": (1, 1000, True, False, 128),
    "hs128-noncausal": (1, 300, False, True, 128),
    "T7": (1, 7, True, False, 64),
}


def flash_bwd_bound(B, H, G, T, hs, dtype, causal, which) -> tuple:
    """(least ms, what bounds it) for K3 or K4: q, k, v, dO, the LSE and D
    read once, dQ (q's dtype) or the per-group float32 dK, dV written once,
    against 6 * hs (K3) or 8 * hs (K4) flops per (head, query, key) pair
    the mask lets through."""
    import torch

    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * B * H + 2 * B * G) * T * hs * item + 2 * 4 * B * H * T
    nbytes += B * H * T * hs * item if which == "dq" else 2 * B * G * T * hs * 4
    pairs = T * (T + 1) // 2 if causal else T * T
    flops = (6 if which == "dq" else 8) * B * H * hs * pairs
    peak = PEAK_FLOPS[str(dtype).replace("torch.", "")]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_bwd_bf16_limits(q, k, v, do, lse, dsum, scale, causal, ref) -> tuple:
    """Element-wise limits (dQ, dK, dV) on K3/K4 over bfloat16 inputs,
    against `ref` = (dQ, dK, dV) of the plain versions run in float32 on
    the same bfloat16 inputs.  They bound the roundings the tensor-core
    kernels add, at u = 2^-8 (bfloat16's unit roundoff), with a factor 2 of
    headroom for the float32 summation order:

      dQ  2^-8 |ref| + 2^-7 scale (|dS| |K|)   dS rounded, dQ rounded once
      dK  2^-7 scale (|dS|^T |Q|)              dS rounded
      dV  2^-7 (P^T |dO|)                      P rounded

    each plus 1e-4 max(1, max |ref|); the products are group-summed and
    take the plain math's own P and |dS|.  Any device; nothing here needs
    a GPU."""
    import torch

    from mdi_llm_tpu_torch.ops.flash import _bwd_terms

    f32 = [x.float() for x in (q, k, v, do)]
    qg, dog, p, ds = _bwd_terms(*f32, lse, dsum, scale, causal)
    ads = ds.abs_()
    del ds
    kf = f32[1].abs()

    def shared(r):
        return 1e-4 * max(1.0, r.abs().max().item())

    dq, dk, dv = ref
    lim_dq = 2.0 ** -7 * scale * torch.einsum("bgrts,bgsh->bgrth", ads, kf).reshape(q.shape)
    lim_dq += 2.0 ** -8 * dq.abs() + shared(dq)
    lim_dk = 2.0 ** -7 * scale * torch.einsum("bgrts,bgrth->bgsh", ads, qg.abs()) + shared(dk)
    del ads
    lim_dv = 2.0 ** -7 * torch.einsum("bgrts,bgrth->bgsh", p, dog.abs()) + shared(dv)
    return lim_dq, lim_dk, lim_dv


def err_ratio(got, ref, limit) -> tuple:
    """(max |got - ref|, max over elements of |got - ref| / limit): a
    ratio above 1 fails."""
    diff = (got.float() - ref).abs()
    return diff.max().item(), (diff / limit).max().item()


def phase_flash_bwd(k3, k4):
    """K3 and K4 against their plain versions on the same inputs (the
    forward's output and LSE from K2), the plain versions run in float32 on
    the same (bfloat16) inputs.  float32 inputs run the CUDA-core kernels,
    which compute as the plain versions do: every output is held to
    max |err| <= BWD_F32_TOL * max(1, max |plain|).  bfloat16 inputs run
    the tensor-core kernels, held element by element to
    `flash_bwd_bf16_limits`."""
    import torch
    import torch.nn.functional as F

    from mdi_llm_tpu_torch.ops.flash import (
        flash_attention_lse,
        flash_dkv,
        flash_dkv_plain,
        flash_dq,
        flash_dq_plain,
    )

    worst = {"dq": 0.0, "dkv": 0.0}
    cases = [(torch.float32, label, shape) for label, shape in FLASH_BWD_SHAPES.items()]
    cases += [(torch.bfloat16, label, shape) for label, shape in
              {**FLASH_BWD_SHAPES, **FLASH_BWD_BF16_SHAPES}.items()]
    for dtype, label, (B, T, causal, with_dlse, hs) in cases:
        name = str(dtype).replace("torch.", "")
        q, k, v = flash_inputs(B, T, dtype, seed=3 * T + B, hs=hs)
        scale = hs ** -0.5
        out, lse = flash_attention_lse(q, k, v, causal=causal)
        g = torch.Generator(device="cuda").manual_seed(T)
        do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
        dsum = (do.float() * out.float()).sum(-1)
        if with_dlse:
            dsum = dsum - torch.randn(lse.shape, generator=g, device="cuda")
        args = (q, k, v, do, lse, dsum, scale, causal)
        got = (flash_dq(*args),) + flash_dkv(*args)
        torch.cuda.synchronize()
        f32 = [x.float() for x in (q, k, v, do)]
        ref = (flash_dq_plain(*f32, lse, dsum, scale, causal),) + \
            flash_dkv_plain(*f32, lse, dsum, scale, causal)
        del f32
        if dtype == torch.bfloat16:
            limits = flash_bwd_bf16_limits(q, k, v, do, lse, dsum, scale, causal, ref)
        else:
            limits = [BWD_F32_TOL * max(1.0, r.abs().max().item()) for r in ref]
        for which, a, r, lim in zip(("dq", "dk", "dv"), got, ref, limits):
            err, ratio = err_ratio(a, r, lim)
            print(f"flash-bwd: {which} {name} {label}: max|err| {err:.3e} "
                  f"max|plain| {r.abs().max().item():.3e} err/limit {ratio:.3e}", flush=True)
            if not ratio <= 1.0:
                fail("flash-bwd", f"{name} {label} {which}: max|err| {err}, "
                     f"{ratio:.3f} x its limit")
            kernel = "dq" if which == "dq" else "dkv"
            worst[kernel] = max(worst[kernel], err)
        del got, ref, limits
        torch.cuda.empty_cache()
        # the yardstick: the backward alone of one SDPA call (dQ, dK and
        # dV together), at the same shape
        qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qq, kk, vv, is_causal=causal,
                                                 enable_gqa=True)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(
            lib_out, (qq, kk, vv), do, retain_graph=True), 10)
        del lib_out, qq, kk, vv
        for which, rec, kern, plain in (("dq", k3, flash_dq, flash_dq_plain),
                                        ("dkv", k4, flash_dkv, flash_dkv_plain)):
            ms = cuda_ms(lambda: kern(*args), 10)
            plain_ms = cuda_ms(lambda: plain(*args), 2)
            torch.cuda.empty_cache()
            b_ms, b_by = flash_bwd_bound(B, 32, 4, T, hs, dtype, causal, which)
            print(f"flash-bwd: {'K3' if which == 'dq' else 'K4'} {name} {label} "
                  f"B={B} T={T} hs={hs} causal={causal} dlse={with_dlse} ms={ms:.4f} "
                  f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} (SDPA "
                  f"backward, dQ+dK+dV) bound_ms={b_ms:.5f} ({b_by})", flush=True)
            if name == "bfloat16" and label == "main":  # the training shape
                rec.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=b_ms, bound_by=b_by)
        del q, k, v, out, lse, do, dsum, args
        torch.cuda.empty_cache()
    k3["max_abs_err"], k4["max_abs_err"] = worst["dq"], worst["dkv"]
    print(f"flash-bwd: K3 max|err| {worst['dq']:.3e}, K4 max|err| {worst['dkv']:.3e} "
          "over both dtypes and every shape", flush=True)


def tiny_llama_generator(n_layer, dtype, **kw):
    import torch

    from mdi_llm_tpu_torch.config import Config
    from mdi_llm_tpu_torch.generation import Generator
    from mdi_llm_tpu_torch.models import transformer

    cfg = Config.from_name(TINY_LLAMA, n_layer=n_layer)
    params = transformer.init_params(cfg, 10137, dtype=dtype, device="cuda")
    return Generator(cfg, params, max_seq_length=2048, device="cuda", **kw)


def long_prompts(lens, vocab, seed=10137):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).tolist() for n in lens]


GENERATE_RUN = {}  # the generate phase's greedy tokens on the long prompts


def phase_generate(record):
    import torch

    from mdi_llm_tpu_torch.cli import sample as sample_cli
    from mdi_llm_tpu_torch.ops.flash import flash_attention, flash_attention_plain

    gen = tiny_llama_generator(22, torch.bfloat16)
    cfg = gen.cfg
    # warm-up (cuBLAS handles, allocator), short prompts: not counted
    gen.generate([[1, 2, 3]] * 4, 4, temperature=0.0)
    prompts = long_prompts((1100, 1370, 1650, 1900), cfg.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = flash_attention_plain.calls = 0
    outs, stats = gen.generate(prompts, 64, temperature=0.0, chunk_size=16)
    torch.cuda.synchronize()
    launches, plain = flash_attention.launches, flash_attention_plain.calls
    for i, (p, o) in enumerate(zip(prompts, outs)):
        new = o[len(p):]
        if len(new) != 64 or not all(0 <= t < cfg.padded_vocab_size for t in new):
            fail("generate", f"sample {i} did not get 64 tokens in the vocabulary")
    if cfg.n_layer != 22 or launches != cfg.n_layer or plain:
        fail("generate", f"K2 launches {launches} (want {cfg.n_layer}), plain "
             f"version calls {plain} (want 0)")
    print("generate: " + json.dumps({
        "prompt_lens": [len(p) for p in prompts], "new_tokens": 64,
        "prefill_s": round(stats.prefill_s, 4), "decode_s": round(stats.decode_s, 4),
        "tokens_generated": stats.tokens_generated,
        "tokens_per_s": round(stats.tokens_per_s, 2),
        "graph_captures": stats.captures, "capture_s": round(stats.capture_s, 4),
        "peak_memory_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3),
        "k2_launches": launches, "k2_plain_calls": plain}), flush=True)
    record["launches"] = launches
    record.setdefault("paths", {})["generate"] = launches
    GENERATE_RUN["outs"] = outs  # the ckpt phase's reference
    del gen
    torch.cuda.empty_cache()

    args = sample_cli.build_parser().parse_args(
        ["--model", TINY_LLAMA, "--n-samples", "4", "--n-tokens", "32", "--greedy"])
    flash_attention.launches = flash_attention_plain.calls = 0
    prompt_ids, outs, stats, gen, _tokenizer, seconds = sample_cli.run(args)
    torch.cuda.synchronize()
    if flash_attention.launches or flash_attention_plain.calls:
        fail("generate", f"the sample CLI's 8-token prompts launched K2 "
             f"{flash_attention.launches} times (plain {flash_attention_plain.calls})")
    if [len(o) - len(p) for o, p in zip(outs, prompt_ids)] != [32] * 4:
        fail("generate", "the sample CLI did not generate 32 tokens per sample")
    print(f"generate: sample CLI --n-samples 4 --n-tokens 32 --greedy: "
          f"{stats.tokens_generated} tokens, {stats.tokens_per_s:.2f} tokens/s "
          f"decode, 0 K2 launches (prompt bucket 16 < flash_min_len "
          f"{gen.flash_min_len})", flush=True)
    del gen
    torch.cuda.empty_cache()


def phase_generate_parity():
    import torch

    from mdi_llm_tpu_torch.ops.flash import flash_attention, flash_attention_plain

    streams = {}
    for route, flash_kernel in (("kernel", None), ("plain", False)):
        gen = tiny_llama_generator(4, torch.float32, use_flash=True,
                                   flash_kernel=flash_kernel)
        prompts = long_prompts((1100, 1093), gen.cfg.vocab_size, seed=7)
        flash_attention.launches = flash_attention_plain.calls = 0
        streams[route], _ = gen.generate(prompts, 16, temperature=0.0)
        launched, plain = flash_attention.launches, flash_attention_plain.calls
        if (launched, plain) != ((4, 0) if route == "kernel" else (0, 4)):
            fail("generate-parity", f"the {route} run launched K2 {launched} "
                 f"times and its plain version {plain} times")
        del gen
        torch.cuda.empty_cache()
    if streams["kernel"] != streams["plain"]:
        fail("generate-parity", "greedy streams differ between K2 and its plain version")
    print("generate-parity: float32, 4 layers x 2048: 2 greedy streams of 16 "
          "tokens identical through K2 and its plain version", flush=True)


DEVICE = "cuda"
TRAIN = dict(batch_size=4, block_size=2048, grad_acc_steps=2, learning_rate=1e-3,
             warmup_iters=0, lr_decay_iters=100, min_lr=1e-4, eval_iters=1,
             dtype="bfloat16", remat=True)
TRAIN_VOCAB = 512  # synthetic tokens are drawn from this many ids
# the fixed batch's loss must fall by this much over three steps; the first
# run on the card saw 10.8486 -> 6.5078 (a fall of 4.34), so 1.0 leaves room
TRAIN_MARGIN = 1.0
TRAIN_CLI_LAYERS = 4  # the train CLI's checkpoint round trip: params and moments


def reset_flash_counts():
    from mdi_llm_tpu_torch.ops import flash

    flash.flash_attention.launches = flash.flash_dq.launches = flash.flash_dkv.launches = 0
    flash.flash_attention_plain.calls = flash.flash_dq_plain.calls = 0
    flash.flash_dkv_plain.calls = 0


def flash_counts() -> dict:
    from mdi_llm_tpu_torch.ops import flash

    return {"K2": flash.flash_attention.launches, "K3": flash.flash_dq.launches,
            "K4": flash.flash_dkv.launches,
            "plain": flash.flash_attention_plain.calls + flash.flash_dq_plain.calls
            + flash.flash_dkv_plain.calls}


def synthetic_tokens(n, seed):
    import numpy as np

    return np.random.default_rng(seed).integers(0, TRAIN_VOCAB, n).astype(np.uint16)


def phase_train(k3, k4):
    """Trainer.train_step on tiny-llama-1.1b at full width and depth, then
    the train CLI with a checkpoint and `--init resume`."""
    import math

    import numpy as np
    import torch

    from mdi_llm_tpu_torch.cli import train as train_cli
    from mdi_llm_tpu_torch.config import Config
    from mdi_llm_tpu_torch.training import (
        Trainer,
        TrainingConfig,
        estimate_flops_per_token,
    )
    from mdi_llm_tpu_torch.utils import data_loader

    cfg = Config.from_name(TINY_LLAMA)
    tc = TrainingConfig(**TRAIN)
    L, a, B, T = cfg.n_layer, tc.grad_acc_steps, tc.batch_size, tc.block_size
    tr = Trainer(cfg, tc, device=DEVICE)
    if L != 22 or not tr.use_flash:
        fail("train", f"{L} layers, use_flash {tr.use_flash}: want 22 layers on the flash route")
    data = synthetic_tokens(1 << 22, seed=10137)
    rng = np.random.default_rng(10138)
    fixed = data_loader.get_batch(data, B, T, rng)

    def batches():
        xs = np.empty((a, B, T), np.int32)
        ys = np.empty_like(xs)
        for m in range(a):
            xs[m], ys[m] = data_loader.get_batch(data, B, T, rng)
        return xs, ys

    def evaluate(label):
        reset_flash_counts()
        loss = tr.eval_loss(*fixed)
        got = flash_counts()
        if got != {"K2": L, "K3": 0, "K4": 0, "plain": 0}:
            fail("train", f"eval batch ({label}) launched {got}; want K2 = {L} only")
        return loss

    tr.train_step(*batches())  # warm-up (cuBLAS handles, allocator): not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss0 = evaluate("before")
    want = {"K2": 2 * L * a, "K3": L * a, "K4": L * a, "plain": 0}
    steps, total = [], {"K3": 0, "K4": 0}
    for _ in range(3):
        xs, ys = batches()
        torch.cuda.synchronize()
        reset_flash_counts()
        t0 = time.perf_counter()
        loss = tr.train_step(xs, ys)  # returns a host float: synchronized
        dt = time.perf_counter() - t0
        got = flash_counts()
        if got != want:
            fail("train", f"one optimizer step launched {got}; want {want}")
        total["K3"] += got["K3"]
        total["K4"] += got["K4"]
        if not math.isfinite(loss):
            fail("train", f"step loss {loss}")
        steps.append((dt, loss))
    loss1 = evaluate("after")
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not (math.isfinite(loss0) and math.isfinite(loss1)) or loss0 - loss1 < TRAIN_MARGIN:
        fail("train", f"fixed-batch loss {loss0} -> {loss1}: want a fall of at "
             f"least {TRAIN_MARGIN}")
    dt = float(np.median([d for d, _ in steps]))
    tokens = a * B * T
    tflops = estimate_flops_per_token(cfg, T) * tokens / dt / 1e12
    print("train: " + json.dumps({
        "model": TINY_LLAMA, "layers": L, "batch": B, "block": T, "grad_acc": a,
        "dtype": tc.dtype, "remat": tc.remat, "use_flash": tr.use_flash,
        "step_s": [round(d, 4) for d, _ in steps], "step_s_median": round(dt, 4),
        "tokens_per_s": round(tokens / dt, 1), "tflops": round(tflops, 2),
        "step_losses": [round(x, 4) for _, x in steps],
        "fixed_batch_loss": [round(loss0, 4), round(loss1, 4)],
        "peak_memory_gib": round(peak, 3),
        "launches_per_step": want}), flush=True)
    k3["launches"], k4["launches"] = total["K3"], total["K4"]
    k3["paths"], k4["paths"] = {"train": total["K3"]}, {"train": total["K4"]}
    del tr
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        ds, ck = Path(tmp) / "data", Path(tmp) / "ckpt"
        ds.mkdir()
        synthetic_tokens(1 << 21, seed=1).tofile(ds / "train.bin")
        synthetic_tokens(1 << 18, seed=2).tofile(ds / "val.bin")
        argv = ["--model", TINY_LLAMA, "--ckpt", str(ck), "--dataset", str(ds),
                "--batch-size", str(B), "--block-size", str(T), "--learning-rate",
                str(tc.learning_rate), "--warmup-iters", "0", "--lr-decay-iters", "100",
                "--log-interval", "1", "--ckpt-interval", "1000", "--eval-iters", "1",
                "--device", DEVICE]
        L = TRAIN_CLI_LAYERS
        reset_flash_counts()
        t0 = time.perf_counter()
        result, trainer = train_cli.main(argv + ["--override", f"n_layer={L}",
                                                 "--max-iters", "2"])
        run_s = time.perf_counter() - t0
        got = flash_counts()
        want = {"K2": 2 * 2 * L, "K3": 2 * L, "K4": 2 * L, "plain": 0}
        losses = [h["loss"] for h in result["history"] if "loss" in h]
        if (trainer.cfg.n_layer != L or got != want or len(losses) != 2
                or not all(map(math.isfinite, losses))):
            fail("train", f"CLI run: {trainer.cfg.n_layer} layers, launches {got} (want "
                 f"{want}), losses {losses}")
        del trainer
        torch.cuda.empty_cache()
        saved = sorted(p.name for p in ck.iterdir())
        if saved != ["model_config.yaml", "opt_state.pt", "params.pt", "train_state.json"]:
            fail("train", f"CLI checkpoint holds {saved}")
        size = sum(p.stat().st_size for p in ck.iterdir()) / 2**30
        t1 = time.perf_counter()
        result, trainer = train_cli.main(argv + ["--init", "resume", "--max-iters", "3"])
        resume_s = time.perf_counter() - t1
        hist = [h for h in result["history"] if "loss" in h]
        if (result["iter_num"] != 3 or trainer.optimizer.count != 3 or [h["iter"] for h in hist]
                != [3] or not math.isfinite(hist[0]["loss"]) or trainer.cfg.n_layer != L):
            fail("train", f"--init resume did not continue at iter 3 on {L} layers: {result}")
        print(f"train: CLI at {L} layers, 2 steps + checkpoint ({size:.2f} GiB) in {run_s:.1f} s, "
              f"losses {[round(x, 4) for x in losses]}; --init resume continued at "
              f"iter 3 (loss {hist[0]['loss']:.4f}) in {resume_s:.1f} s", flush=True)
        del trainer
        torch.cuda.empty_cache()



def phase_train_parity():
    """float32, 4 layers at full width, B=2, T=2048: two optimizer steps
    through K2-K4 and through their plain versions from the same params and
    batches.  The kernels sum in another order than the plain einsums, so
    the first step's gradients agree within 1e-4 of the largest gradient
    and the losses within 1e-5 (relative)."""
    import numpy as np
    import torch

    from mdi_llm_tpu_torch.config import Config
    from mdi_llm_tpu_torch.models import transformer
    from mdi_llm_tpu_torch.training import Trainer, TrainingConfig, cross_entropy_loss
    from mdi_llm_tpu_torch.utils import data_loader

    cfg = Config.from_name(TINY_LLAMA, n_layer=4)
    tc = TrainingConfig(**{**TRAIN, "batch_size": 2, "grad_acc_steps": 1,
                           "dtype": "float32", "use_flash": True})
    params = transformer.init_params(cfg, 10137, dtype=torch.float32, device=DEVICE)
    data = synthetic_tokens(1 << 20, seed=3)
    rng = np.random.default_rng(4)
    batches = [data_loader.get_batch(data, 2, tc.block_size, rng) for _ in range(2)]
    grads, losses = {}, {}
    for route, flash_kernel in (("kernel", None), ("plain", False)):
        tr = Trainer(cfg, tc, params=params, device=DEVICE, flash_kernel=flash_kernel)
        reset_flash_counts()
        x, y = (torch.as_tensor(b, device=DEVICE).long() for b in batches[0])
        loss = cross_entropy_loss(cfg, tr.params, x, y, remat=True, use_flash=True,
                                  flash_kernel=flash_kernel)
        grads[route] = torch.autograd.grad(loss, transformer.tree_leaves(tr.params))
        losses[route] = [tr.train_step(bx[None], by[None]) for bx, by in batches]
        got = flash_counts()
        # one gradient and two steps of one micro-batch: per layer each ran
        # K2 twice (remat) and K3 and K4 once, or their plain versions
        n = 3 * cfg.n_layer
        want = ({"K2": 2 * n, "K3": n, "K4": n, "plain": 0} if route == "kernel"
                else {"K2": 0, "K3": 0, "K4": 0, "plain": 4 * n})
        if got != want:
            fail("train-parity", f"the {route} run launched {got}; want {want}")
        del tr
        torch.cuda.empty_cache()
    size = max(g.abs().max().item() for g in grads["plain"])
    err = max((a - b).abs().max().item() for a, b in zip(grads["kernel"], grads["plain"]))
    lk, lp = losses["kernel"], losses["plain"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    if not err <= 1e-4 * size or not rel <= 1e-5:
        fail("train-parity", f"grads max|err| {err} (largest grad {size}), losses "
             f"{lk} vs {lp} (rel {rel})")
    print(f"train-parity: float32, {cfg.n_layer} layers x {cfg.n_embd}, B=2 "
          f"T={tc.block_size}: "
          f"first-step grads max|err| {err:.3e} (largest {size:.3e}), losses "
          f"{[round(x, 6) for x in lk]} vs {[round(x, 6) for x in lp]} (rel {rel:.2e}) "
          "through K2-K4 and their plain versions", flush=True)


TRAIN_BF16_GRAD_REL = 2.0 ** -5  # per leaf, ||g_kernel - g_plain|| / ||g_plain||
TRAIN_BF16_LOSS_REL = 2.0 ** -8


def phase_train_parity_bf16():
    """bfloat16, 4 layers at full width, B=2, T=2048: one gradient through
    K2-K4 (the tensor-core kernels) and one through their plain versions
    (`flash_kernel=False`, float32 math on bfloat16 inputs) from the same
    params and batch.  Per leaf, ||g_kernel - g_plain||_2 <=
    TRAIN_BF16_GRAD_REL ||g_plain||_2, and the losses agree within
    TRAIN_BF16_LOSS_REL (relative)."""
    import numpy as np
    import torch

    from mdi_llm_tpu_torch.config import Config
    from mdi_llm_tpu_torch.models import transformer
    from mdi_llm_tpu_torch.training import cross_entropy_loss
    from mdi_llm_tpu_torch.utils import data_loader

    cfg = Config.from_name(TINY_LLAMA, n_layer=4)
    params = transformer.init_params(cfg, 10137, dtype=torch.bfloat16, device=DEVICE)
    transformer.tree_map(lambda x: x.requires_grad_(True), params)
    leaves = transformer.tree_leaves(params)
    data = synthetic_tokens(1 << 20, seed=5)
    x, y = (torch.as_tensor(b, device=DEVICE).long() for b in
            data_loader.get_batch(data, 2, TRAIN["block_size"], np.random.default_rng(6)))
    grads, losses = {}, {}
    n = cfg.n_layer
    for route, flash_kernel in (("kernel", None), ("plain", False)):
        reset_flash_counts()
        loss = cross_entropy_loss(cfg, params, x, y, remat=True, use_flash=True,
                                  flash_kernel=flash_kernel)
        grads[route] = [g.float() for g in torch.autograd.grad(loss, leaves)]
        losses[route] = loss.item()
        got = flash_counts()
        # one gradient with remat: per layer K2 twice, K3 and K4 once, or
        # their plain versions
        want = ({"K2": 2 * n, "K3": n, "K4": n, "plain": 0} if route == "kernel"
                else {"K2": 0, "K3": 0, "K4": 0, "plain": 4 * n})
        if got != want:
            fail("train-parity-bf16", f"the {route} run launched {got}; want {want}")
        torch.cuda.empty_cache()
    ratios = []
    for i, (a, b) in enumerate(zip(grads["kernel"], grads["plain"])):
        norm = b.norm().item()
        ratios.append(((a - b).norm().item() / norm if norm > 0 else (a - b).norm().item(), i))
    worst, leaf = max(ratios)
    lk, lp = losses["kernel"], losses["plain"]
    rel = abs(lk - lp) / abs(lp)
    print(f"train-parity-bf16: bfloat16, {n} layers x {cfg.n_embd}, B=2 "
          f"T={TRAIN['block_size']}: worst leaf ||g_kernel - g_plain|| / ||g_plain|| "
          f"{worst:.3e} (leaf {leaf} of {len(leaves)}; limit {TRAIN_BF16_GRAD_REL:.3e}), "
          f"loss {lk:.6f} vs {lp:.6f} (rel {rel:.2e}, limit {TRAIN_BF16_LOSS_REL:.2e}) "
          "through K2-K4 and their plain versions", flush=True)
    if not worst <= TRAIN_BF16_GRAD_REL or not rel <= TRAIN_BF16_LOSS_REL:
        fail("train-parity-bf16", f"gradient ratio {worst} (leaf {leaf}), loss rel {rel}")
    del grads, params, leaves
    torch.cuda.empty_cache()


# the HF config.json of tiny-llama-1.1b that `Config.from_hf_config` maps
# back onto the registry entry (TinyLlama-1.1B's published config)
TINY_LLAMA_HF = {
    "model_type": "llama", "architectures": ["LlamaForCausalLM"],
    "_name_or_path": TINY_LLAMA, "vocab_size": 32000, "hidden_size": 2048,
    "intermediate_size": 5632, "num_hidden_layers": 22, "num_attention_heads": 32,
    "num_key_value_heads": 4, "max_position_embeddings": 2048, "rms_norm_eps": 1e-5,
    "rope_theta": 10000.0, "tie_word_embeddings": False, "hidden_act": "silu",
    "bos_token_id": 1, "eos_token_id": 2, "torch_dtype": "bfloat16",
}
SHARD_BYTES = 1 << 30  # three safetensors shards for tiny-llama-1.1b in bf16
HUB_ORG = "mdi-smoke"  # the ckpt phase's hub id is HUB_ORG/tiny-llama-1.1b


def write_snapshot(ckpt_dir):
    """The serve phase's weights (tiny-llama-1.1b, bf16, --seed 10137) as a
    HF snapshot in `ckpt_dir`: the port's reverse map into sharded
    safetensors, the index and config.json.  Returns (cfg, params, the
    shard paths, seconds)."""
    import torch

    from mdi_llm_tpu_torch.config import Config
    from mdi_llm_tpu_torch.models import transformer
    from mdi_llm_tpu_torch.utils import checkpoint as ck

    cfg = Config.from_name(TINY_LLAMA)
    params = transformer.init_params(cfg, 10137, dtype=torch.bfloat16, device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    shards = ck.write_hf_shards(ck.convert_to_hf_state_dict(cfg, params), ckpt_dir,
                                shard_bytes=SHARD_BYTES)
    (Path(ckpt_dir) / "config.json").write_text(json.dumps(TINY_LLAMA_HF, indent=1))
    return cfg, params, shards, time.perf_counter() - t0


def phase_ckpt(k1, k2, card, ckpt_dir):
    """A real checkpoint through the normal entry points, at full width and
    depth: the serve phase's weights written as a sharded HF snapshot in
    `ckpt_dir` (`<checkpoints>/HUB_ORG/tiny-llama-1.1b`), `cli.prepare_model`
    on its hub id (offline: the hub route finds the snapshot there) or,
    without `huggingface_hub`, on the directory; every loaded leaf
    bit-identical to the original; `cli.serve --ckpt` token-identical to
    `cli.serve --model` at the same seed (the serve phase's streams) with
    K1 at 22 launches per forward; `Generator.generate` on the loaded
    weights over the generate phase's prompts with exactly 22 K2 launches
    and the original weights' tokens (the generate phase's)."""
    import torch

    from mdi_llm_tpu_torch.cli import prepare_model
    from mdi_llm_tpu_torch.config import Config
    from mdi_llm_tpu_torch.generation import Generator
    from mdi_llm_tpu_torch.models import transformer
    from mdi_llm_tpu_torch.ops.flash import flash_attention, flash_attention_plain
    from mdi_llm_tpu_torch.utils import checkpoint as ck

    cfg, params, shards, write_s = write_snapshot(ckpt_dir)
    size = sum(p.stat().st_size for p in shards)
    route = "hub" if importlib.util.find_spec("huggingface_hub") else "local"
    t0 = time.perf_counter()
    if route == "hub":
        repo_id = f"{ckpt_dir.parent.name}/{ckpt_dir.name}"
        got = prepare_model.main([repo_id, "--checkpoints-dir", str(ckpt_dir.parent.parent)])
        offline = sys.modules["huggingface_hub"].constants.HF_HUB_OFFLINE
        if got != ckpt_dir or not offline:
            fail("ckpt", f"the hub route gave {got} (want {ckpt_dir}), offline {offline}")
        hub = f"huggingface_hub {sys.modules['huggingface_hub'].__version__}, offline"
    else:
        prepare_model.main([str(ckpt_dir)])
        hub = "huggingface_hub is not installed on this machine: the local route"
    convert_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lcfg, loaded = ck.load_checkpoint(ckpt_dir, device=DEVICE)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    skip = {"hf_config", "padding_multiple"}  # registry-only fields
    if {k: v for k, v in lcfg.asdict().items() if k not in skip} != {
            k: v for k, v in cfg.asdict().items() if k not in skip}:
        fail("ckpt", f"the converted config differs from {TINY_LLAMA}'s")
    want, got = transformer.tree_leaves(params), transformer.tree_leaves(loaded)
    if len(want) != len(got) or not all(
            a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
            for a, b in zip(want, got)):
        fail("ckpt", "a loaded leaf is not bit-identical to the written one")

    ckpt_base = ["--ckpt", str(ckpt_dir)] + SERVE_BASE[2:]
    # the --model streams are the serve phase's, which ran these flags (its
    # --hbm-gb sets only the preflight's limit); without that phase, a run here
    trace = ["--synthetic", "16", "--n-tokens", "64"]
    want, model_s = SERVE_RUN.get("results"), None
    if want is None:
        t0 = time.perf_counter()
        _line, _launches, engine, want = serve_checked("ckpt", SERVE_BASE + trace)
        model_s = time.perf_counter() - t0
        del engine
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    line, launches, engine, results = serve_checked("ckpt", ckpt_base + trace)
    forwards, serve_s = engine.forward_calls, time.perf_counter() - t0
    del engine
    torch.cuda.empty_cache()
    if results != want:
        fail("ckpt", "cli.serve --ckpt streams differ from cli.serve --model's")

    prompts = long_prompts((1100, 1370, 1650, 1900), cfg.vocab_size)
    # the original weights' tokens are the generate phase's, which ran these
    # prompts on them; without that phase, a run here
    outs = {"original": GENERATE_RUN["outs"]} if "outs" in GENERATE_RUN else {}
    for label, p in (("original", params), ("loaded", loaded)):
        if label in outs:
            continue
        gen = Generator(lcfg, p, max_seq_length=2048, device=DEVICE)
        flash_attention.launches = flash_attention_plain.calls = 0
        t0 = time.perf_counter()
        outs[label], stats = gen.generate(prompts, 64, temperature=0.0, chunk_size=16)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        k2_launches, plain = flash_attention.launches, flash_attention_plain.calls
        if k2_launches != 22 or plain:
            fail("ckpt", f"{label} weights: K2 launches {k2_launches} (want 22), "
                 f"plain version calls {plain} (want 0)")
        del gen
    if outs["loaded"] != outs["original"]:
        fail("ckpt", "Generator.generate on the loaded weights differs from the original's")
    print("ckpt: " + json.dumps({
        "route": route, "hub": hub,
        "shards": len(shards), "snapshot_gib": round(size / 2**30, 3),
        "write_s": round(write_s, 2), "convert_s": round(convert_s, 2),
        "load_s": round(load_s, 2), "serve_s": round(serve_s, 2),
        "serve_tokens_per_s": line["tokens_per_s"], "k1_launches": launches,
        "forwards": forwards,
        "serve_model_s": "the serve phase's run" if model_s is None else round(model_s, 2),
        "generate_s": round(gen_s, 2),
        "generate_prefill_s": round(stats.prefill_s, 4), "k2_launches": k2_launches}),
        flush=True)
    print(f"ckpt: {len(shards)} safetensors shards ({size / 2**30:.2f} GiB) written in "
          f"{write_s:.1f} s, converted by cli.prepare_model ({route} route; {hub}) in "
          f"{convert_s:.1f} s, "
          f"loaded to the card in {load_s:.1f} s, every leaf bit-identical; cli.serve "
          f"--ckpt (load included) {serve_s:.1f} s, 16 streams identical to --model's "
          f"({'the serve phase' if model_s is None else f'{model_s:.1f} s'}), K1 "
          f"{launches} = 22 x {forwards} forwards; generate on the loaded weights: 22 K2 "
          f"launches, the original weights' tokens; on {card}", flush=True)
    k1.setdefault("paths", {})["ckpt"] = launches
    k2.setdefault("paths", {})["ckpt"] = k2_launches
    del params, loaded
    torch.cuda.empty_cache()


CHAT_VOCAB = 32000
CHAT_WORDS = 1500  # the pasted first turn: its prompt bucket is 2048


def write_word_tokenizer(ckpt_dir):
    """A 32000-entry word-level tokenizer.json ("<unk>", "<s>", "</s>",
    then "w3" ... "w31999", split on whitespace), written as the JSON the
    `tokenizers` library saves for one, and its tokenizer_config.json."""
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2, **{f"w{i}": i for i in range(3, CHAT_VOCAB)}}
    tok = {"version": "1.0", "truncation": None, "padding": None, "added_tokens": [],
           "normalizer": None, "pre_tokenizer": {"type": "Whitespace"},
           "post_processor": None, "decoder": None,
           "model": {"type": "WordLevel", "vocab": vocab, "unk_token": "<unk>"}}
    (Path(ckpt_dir) / "tokenizer.json").write_text(json.dumps(tok))
    (Path(ckpt_dir) / "tokenizer_config.json").write_text(json.dumps(
        {"bos_token": "<s>", "eos_token": "</s>", "add_bos_token": True}))


def phase_chat(k2, card, ckpt_dir):
    """`cli.chat --ckpt` through stdin for two turns on the ckpt phase's
    checkpoint with a word-level tokenizer: a pasted 1500-word first turn
    prefills the empty cache through K2 (22 launches), a short second turn
    takes the dense route; the replies equal a direct ChatSession run."""
    import contextlib
    import io

    import numpy as np
    import torch

    from mdi_llm_tpu_torch.cli import chat as chat_cli
    from mdi_llm_tpu_torch.cli import prepare_model
    from mdi_llm_tpu_torch.generation import Generator
    from mdi_llm_tpu_torch.ops.flash import flash_attention, flash_attention_plain
    from mdi_llm_tpu_torch.utils import checkpoint as ck
    from mdi_llm_tpu_torch.utils.prompts import style_for_model
    from mdi_llm_tpu_torch.utils.tokenizer import Tokenizer

    if importlib.util.find_spec("tokenizers") is None:
        print("chat: tokenizers is not installed on this machine; the text path is "
              "held on the CPU only", flush=True)
        return
    if not ck.has_checkpoint(ckpt_dir):  # run without the ckpt phase
        write_snapshot(ckpt_dir)
        prepare_model.main([str(ckpt_dir)])
    write_word_tokenizer(ckpt_dir)
    rng = np.random.default_rng(10137)
    turns = [" ".join(f"w{i}" for i in rng.integers(3, CHAT_VOCAB, n)) for n in (CHAT_WORDS, 12)]
    argv = ["--ckpt", str(ckpt_dir), "--device", DEVICE, "--temperature", "0",
            "--n-tokens", "32"]
    old_stdin, sys.stdin = sys.stdin, io.StringIO("\n".join(turns) + "\n")
    printed = io.StringIO()
    flash_attention.launches = flash_attention_plain.calls = 0
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            session = chat_cli.main(argv)
        torch.cuda.synchronize()
        chat_s = time.perf_counter() - t0
    finally:
        sys.stdin = old_stdin
    launches, plain = flash_attention.launches, flash_attention_plain.calls
    if launches != 22 or plain:
        fail("chat", f"K2 launches {launches} (want 22, the first turn's prefill), "
             f"plain version calls {plain} (want 0)")

    tok = Tokenizer(ckpt_dir)
    cfg, params = ck.load_checkpoint(ckpt_dir, dtype=torch.bfloat16, device=DEVICE)
    style = style_for_model(cfg.name)
    direct = Generator(cfg, params, max_seq_length=2048, device=DEVICE).chat_session()
    turn_ids, replies = [], []
    for t in turns:
        turn_ids.append(tok.encode(style.apply(t)).tolist())
        replies.append(list(direct.send(turn_ids[-1], 32, temperature=0.0,
                                        stop_sequences=style.stop_tokens(tok))))
    if session.history != direct.history or not all(replies):
        fail("chat", "cli.chat's conversation differs from a direct ChatSession run")
    text = printed.getvalue()
    if not all(tok.decode(np.asarray(r)) in text for r in replies):
        fail("chat", "cli.chat did not print the decoded replies")
    print("chat: " + json.dumps({
        "turn_tokens": [len(t) for t in turn_ids], "reply_tokens": [len(r) for r in replies],
        "chat_s": round(chat_s, 2), "k2_launches": launches}), flush=True)
    print(f"chat: cli.chat --ckpt, 2 turns through stdin ({len(turn_ids[0])}-token pasted "
          f"prompt into the empty cache: 22 K2 launches; {len(turn_ids[1])}-token second "
          f"turn on the dense route) in {chat_s:.1f} s (load included), replies identical "
          f"to a direct ChatSession; on {card}", flush=True)
    k2.setdefault("paths", {})["chat"] = launches
    del direct, params
    torch.cuda.empty_cache()


GRAPH_ROUTES = (("eager", False), ("graphs", True), ("graphs", True), ("eager", False))
GRAPH_TOKENS = 8  # new tokens of the phase's serves and generates (64, then 32, then 16,
# before the cuts for the whole run's time)
# pool: (serve CLI flags, the routes in turn)
GRAPH_POOLS = (("bf16", [], GRAPH_ROUTES), ("int8", ["--kv-dtype", "int8"], GRAPH_ROUTES[:2]),
               ("e4m3", ["--kv-dtype", "float8"], GRAPH_ROUTES[:2]))


def graph_serve_run(phase, argv, graphs):
    """The serve CLI's engine (`cli.build`) on one route, its `run()` with
    every count set to 0 just before and read just after.  Fails unless K1
    ran 22 times per forward and the plain route never, and a graph engine
    captured every step when it was built (none inside the run) and
    replayed them; an eager one captures and replays nothing.  Returns
    (results, summary, engine)."""
    import torch

    from mdi_llm_tpu_torch.cli import serve as cli
    from mdi_llm_tpu_torch.ops import paged_attention as pa
    from mdi_llm_tpu_torch.ops.ragged_paged_attention import ragged_paged_attention

    args = cli.build_parser().parse_args(argv)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _trace, engine, _tokenizer = cli.build(args, _graphs=graphs)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    built = engine.graph_stats()
    ragged_paged_attention.launches = ragged_paged_attention.merge_launches = 0
    pa._paged_prefill_plain.calls = pa._paged_attention_plain.calls = 0
    results, stats = engine.run()
    torch.cuda.synchronize()
    launches = ragged_paged_attention.launches
    plain = pa._paged_prefill_plain.calls + pa._paged_attention_plain.calls
    after = engine.graph_stats()
    n_layer = engine.gen.cfg.n_layer
    if n_layer != 22 or launches <= 0 or launches != n_layer * engine.forward_calls or plain:
        fail(phase, f"_graphs={graphs}: K1 launches {launches} != {n_layer} x "
             f"{engine.forward_calls} forwards, plain route {plain}")
    if graphs and (built["captures"] != built["steps"] or after["captures"] != built["captures"]
                   or after["replays"] <= 0):
        fail(phase, f"graph engine: {built} when built, {after} after the run")
    if not graphs and (after["captures"] or after["replays"]):
        fail(phase, f"eager engine captured or replayed: {after}")
    summary = {"route": "graphs" if graphs else "eager",
               "tokens_per_s": round(stats.tokens_per_s, 2), "wall_s": round(stats.wall_s, 4),
               "decode_s": round(stats.decode_s, 4), "prefill_s": round(stats.prefill_s, 4),
               "host_syncs": stats.host_syncs, "forward_calls": engine.forward_calls,
               "k1_launches": launches, "graph_captures": built["captures"],
               "graph_replays": after["replays"], "capture_s": round(built["capture_s"], 4),
               "build_s": round(build_s, 3),
               "peak_memory_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3)}
    return results, summary, engine


def sampled_frequencies_ok(phase, gen, n_requests=512, top_k=4, temperature=0.8):
    """The distribution test of the port's CPU suite, on the card:
    `n_requests` requests of one prompt, 2 new tokens each, at
    `temperature` and `top_k`.  The first token (the mixed step's draw)
    must follow the filtered softmax of the prompt's last logits, and the
    second (the decode step's) the filtered softmax after each first token
    that came up at least 64 times: |freq - p| < 5 sigma + 1e-3 per token,
    p from a dense forward of the same model."""
    import numpy as np
    import torch

    from mdi_llm_tpu_torch.models import transformer
    from mdi_llm_tpu_torch.ops.sampling import filtered_logits, sampling_operands

    prompt = long_prompts((24,), gen.cfg.vocab_size, seed=3)[0]
    engine = gen.serve(block_size=16, max_batch=8, temperature=temperature, top_k=top_k)
    for i in range(n_requests):
        engine.add_request(f"s{i}", prompt, 2)
    results, _ = engine.run()
    draws = np.array([results[f"s{i}"][len(prompt):] for i in range(n_requests)])
    t_op, p_op = sampling_operands(temperature, None, device="cuda")

    def probs(ctx):
        with torch.no_grad():
            logits = transformer.forward(gen.cfg, gen.params, torch.tensor([ctx], device="cuda"),
                                         torch.zeros(1, dtype=torch.long, device="cuda"))
        f = filtered_logits(logits[0, -1:], t_op, p_op, mode="top_k", top_k=top_k)
        return torch.softmax(f, dim=-1)[0].cpu().numpy()

    firsts, counts = np.unique(draws[:, 0], return_counts=True)
    cases = [(prompt, draws[:, 0])] + [(prompt + [int(t)], draws[draws[:, 0] == t, 1])
                                       for t, c in zip(firsts, counts) if c >= 64]
    worst = 0.0
    for ctx, got in cases:
        p = probs(ctx)
        freq = np.bincount(got, minlength=len(p)) / len(got)
        ratio = float(np.max(np.abs(freq - p) / (5.0 * np.sqrt(p * (1.0 - p) / len(got)) + 1e-3)))
        worst = max(worst, ratio)
        if not ratio < 1.0 or np.any(freq[p == 0.0] > 0):
            fail(phase, f"sampled draws after {len(ctx)} tokens: frequencies {freq[p > 0]} "
                 f"against {p[p > 0]} over {len(got)} draws")
    print(f"{phase}: sampled distribution test: {len(cases)} positions, worst "
          f"|freq - p| / (5 sigma + 1e-3) {worst:.3f} over {n_requests} requests", flush=True)
    del engine
    torch.cuda.empty_cache()


def paged_write_ms(kv_dtype, lanes=8, n_layer=22):
    """Device ms of one decode forward's paged K/V writes (`paged_update`
    of `lanes` tokens into each of `n_layer` layers of a tiny-llama pool
    stored as `kv_dtype`), timed as replays of one CUDA graph that holds
    all of them."""
    import torch

    from mdi_llm_tpu_torch.config import Config
    from mdi_llm_tpu_torch.models import transformer
    from mdi_llm_tpu_torch.ops.paged_attention import paged_update

    cfg = Config.from_name(TINY_LLAMA)
    nb = 1 + lanes * 128
    kv = transformer.init_paged_kv_cache(cfg, nb, 16, dtype=kv_dtype, device="cuda",
                                         n_layer=n_layer)
    g = torch.Generator(device="cuda").manual_seed(5)
    new = torch.randn((n_layer, 2, lanes, 1, cfg.n_query_groups, cfg.head_size),
                      generator=g, device="cuda").to(torch.bfloat16)
    tables = torch.arange(1, nb, device="cuda", dtype=torch.int32).reshape(lanes, 128)
    pos = torch.tensor([[37 + 211 * i] for i in range(lanes)], device="cuda")

    def writes():
        for layer in range(n_layer):
            kl, vl = (transformer._layer_pool(kv[side], layer) for side in ("k", "v"))
            paged_update(kl, vl, new[layer, 0], new[layer, 1], tables, pos)

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        writes()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        writes()
    return cuda_ms(graph.replay, 50)


def phase_graphs(k1, k2, card):
    """CUDA graphs against eager launches of the same steps, in turns
    eager, graph, graph, eager (the module docstring, phase 15)."""
    import statistics

    import torch

    from mdi_llm_tpu_torch.config import Config
    from mdi_llm_tpu_torch.generation import Generator
    from mdi_llm_tpu_torch.models import transformer
    from mdi_llm_tpu_torch.ops.flash import flash_attention, flash_attention_plain

    def medians(runs):
        return {route: statistics.median(s["tokens_per_s"] for _, s in runs if s["route"] == route)
                for route in ("eager", "graphs")}

    base = SERVE_BASE + ["--synthetic", "8", "--n-tokens", str(GRAPH_TOKENS)]
    graph_serve_run("graphs", SERVE_BASE + ["--synthetic", "2", "--n-tokens", "8"], True)
    for pool, extra, routes in GRAPH_POOLS:
        runs = []
        for route, graphs in routes:
            results, summary, engine = graph_serve_run("graphs", base + extra, graphs)
            runs.append((results, summary))
            print(f"graphs: serve {pool} pool: " + json.dumps(summary), flush=True)
            if pool == "bf16" and graphs:
                k1.setdefault("paths", {})["graphs"] = summary["k1_launches"]
            gen = engine.gen
            del engine
            torch.cuda.empty_cache()
        syncs = {s["host_syncs"] for _, s in runs}
        if len(syncs) != 1:
            fail("graphs", f"{pool} pool: host_syncs differ between runs: {syncs}")
        for a, b in ((1, 0), (2, 3))[:len(runs) // 2]:
            divergence_ok("graphs", gen, runs[a][0], runs[b][0], f"{pool} pool, graphs vs eager")
        same = sum(runs[1][0][r] == runs[0][0][r] for r in runs[0][0])
        med = medians(runs)
        print(f"graphs: serve {pool} pool: {same} of {len(runs[0][0])} greedy streams identical "
              f"between eager and graph runs, host_syncs {syncs.pop()} on every run; median "
              f"tokens/s eager {med['eager']} graphs {med['graphs']} "
              f"(x{med['graphs'] / med['eager']:.3f}); on {card}", flush=True)
        del gen
        torch.cuda.empty_cache()

    cfg = Config.from_name(TINY_LLAMA)
    params = transformer.init_params(cfg, 10137, dtype=torch.bfloat16, device="cuda")
    gens = {graphs: Generator(cfg, params, max_seq_length=2048, device="cuda", _graphs=graphs)
            for graphs in (False, True)}
    prompts = long_prompts((1100, 1370, 1650, 1900), cfg.vocab_size)
    first = {}
    for graphs, gen in gens.items():  # first calls: the graph route captures here
        outs, stats = gen.generate(prompts, GRAPH_TOKENS, temperature=0.0, chunk_size=16)
        first[graphs] = (outs, stats.captures, stats.capture_s)
    if not first[True][1] > 0 or first[False][1]:
        fail("graphs", f"generate's first calls captured {first[True][1]} (graphs) and "
             f"{first[False][1]} (eager) decode-chunk graphs")
    runs = []
    for route, graphs in GRAPH_ROUTES:
        gen = gens[graphs]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = flash_attention_plain.calls = 0
        outs, stats = gen.generate(prompts, GRAPH_TOKENS, temperature=0.0, chunk_size=16)
        torch.cuda.synchronize()
        launches, plain = flash_attention.launches, flash_attention_plain.calls
        if launches != 22 or plain or stats.captures:
            fail("graphs", f"generate ({route}): K2 launches {launches}, plain {plain}, "
                 f"captures {stats.captures} (want 22, 0, 0)")
        summary = {"route": route, "tokens_per_s": round(stats.tokens_per_s, 2),
                   "decode_s": round(stats.decode_s, 4), "prefill_s": round(stats.prefill_s, 4),
                   "graph_captures": stats.captures, "graph_steps": gen.graph_stats()["steps"],
                   "peak_memory_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3)}
        print("graphs: generate: " + json.dumps(summary), flush=True)
        runs.append((outs, summary))
        if graphs:
            k2.setdefault("paths", {})["graphs"] = launches
    if any(outs != first[False][0] for outs, _ in runs) or first[True][0] != first[False][0]:
        fail("graphs", "generate's greedy tokens differ between eager and graph runs")
    med = medians(runs)
    kept = sum(x.numel() * x.element_size() for kv in gens[True]._caches.values()
               for x in kv.values())
    # the graphs' private pools: what the card gets back when they go
    n_steps = gens[True].graph_stats()["steps"]
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    gens[True]._steps.clear()
    torch.cuda.empty_cache()
    pools = (reserved - torch.cuda.memory_reserved()) / 2**20
    print(f"graphs: generate: tokens identical on every run; the first graph call captured "
          f"{first[True][1]} decode chunks in {first[True][2]:.3f} s, the later ones none; "
          f"median decode tokens/s eager {med['eager']} graphs {med['graphs']} "
          f"(x{med['graphs'] / med['eager']:.3f}); between calls the Generator keeps "
          f"{len(gens[True]._caches)} dense caches ({kept / 2**20:.1f} MiB) and {n_steps} "
          f"step graphs whose private pools hold {pools:.1f} MiB; on {card}", flush=True)
    del gens
    torch.cuda.empty_cache()

    # the sampled check: the same generator state on both routes
    serve_draws = {}
    for route, graphs in GRAPH_ROUTES[:2]:
        serve_draws[route], _summary, engine = graph_serve_run(
            "graphs", base + ["--temperature", "0.8"], graphs)
        del engine
        torch.cuda.empty_cache()
    gen_draws = {graphs: Generator(cfg, params, max_seq_length=2048, device="cuda",
                                   _graphs=graphs).generate(prompts, GRAPH_TOKENS,
                                                            temperature=0.8,
                                                            top_k=None)[0]
                 for graphs in (False, True)}
    same = sum(serve_draws["graphs"][r] == serve_draws["eager"][r] for r in serve_draws["eager"])
    print(f"graphs: temperature 0.8 from the same generator state: {same} of "
          f"{len(serve_draws['eager'])} serve streams and "
          f"{sum(a == b for a, b in zip(gen_draws[True], gen_draws[False]))} of "
          f"{len(prompts)} generate samples identical draw for draw between eager and "
          "graph runs", flush=True)
    # the distribution test holds the graph route's draws either way; it is
    # the whole check where the draws differ from eager's.  float32, so the
    # dense reference's top-k set is the engine's (in bf16 the two routes'
    # roundings can swap a near-tie at the top-k boundary)
    del params
    torch.cuda.empty_cache()
    sampled_frequencies_ok("graphs", tiny_llama_generator(4, torch.float32))
    torch.cuda.empty_cache()

    ms = {kind: paged_write_ms(kind) for kind in ("int8", torch.bfloat16)}
    print(f"graphs: paged K/V writes of one decode forward (8 lanes x 22 layers), device "
          f"time as graph replays: int8 pool {ms['int8']:.4f} ms, bf16 pool "
          f"{ms[torch.bfloat16]:.4f} ms; on {card}", flush=True)


SERVER_REQUESTS = 8  # the closed submission's synthetic trace (32, then 16, before the cuts for
# the whole run's time)
SERVER_SPEC = (8, 32)  # (d)'s synthetic requests and new tokens ((16, 64) before the layouts
# over processes)
# the server's process under cli.server's own entry, with K1's and the plain
# route's counts printed when it exits (a replay runs no Python, so the
# counts are StepGraph's, as in every phase)
SERVER_ENTRY = (
    "import atexit, json, runpy, sys\n"
    "from mdi_llm_tpu_torch.ops import paged_attention as pa\n"
    "from mdi_llm_tpu_torch.ops.ragged_paged_attention import ragged_paged_attention as k1\n"
    "atexit.register(lambda: print('K1-COUNTS ' + json.dumps({'k1': k1.launches, "
    "'plain': pa._paged_prefill_plain.calls + pa._paged_attention_plain.calls}), "
    "file=sys.stderr, flush=True))\n"
    "sys.argv = ['mdi_llm_tpu_torch.cli.server'] + sys.argv[1:]\n"
    "runpy.run_module('mdi_llm_tpu_torch.cli.server', run_name='__main__', alter_sys=True)\n"
)


def reset_k1_counts():
    from mdi_llm_tpu_torch.ops import paged_attention as pa
    from mdi_llm_tpu_torch.ops.ragged_paged_attention import ragged_paged_attention

    ragged_paged_attention.launches = ragged_paged_attention.merge_launches = 0
    pa._paged_prefill_plain.calls = pa._paged_attention_plain.calls = 0


def k1_counts() -> tuple:
    import torch

    from mdi_llm_tpu_torch.ops import paged_attention as pa
    from mdi_llm_tpu_torch.ops.ragged_paged_attention import ragged_paged_attention

    torch.cuda.synchronize()
    return (ragged_paged_attention.launches,
            pa._paged_prefill_plain.calls + pa._paged_attention_plain.calls)


def utilization_ok(phase, label, mfu, mbu) -> None:
    if mfu is None or mbu is None or not (0 < mfu <= 1 and 0 < mbu <= 1):
        fail(phase, f"{label}: MFU {mfu} / MBU {mbu} not in (0, 1] (is the card an "
             "SXM H100, the one row of obs/roofline.DEVICE_PEAKS?)")


def server_part(label, gen, serving, trace, drive, observe=True):
    """One part of the `server` phase: a fresh engine over `gen` (captured
    when built, its observer measuring with device capture), `drive(engine)`
    with every count set to 0 just before and read just after, under a
    captures guard marked warm once the engine is built.  Fails unless K1
    ran 22 times per forward, the plain route never, nothing captured after
    warm-up, no step report has `error` set, every request finished with
    its budget in the vocabulary and MFU/MBU lie in (0, 1].  Returns
    (results, engine, launches, summary)."""
    from mdi_llm_tpu_torch.cli import serve as cli
    from mdi_llm_tpu_torch.obs import ServingObserver
    from mdi_llm_tpu_torch.utils.profiling import CompileGuard, RecompileError

    guard = CompileGuard(label=f"server {label}")
    with guard:
        engine = gen.serve(serving=serving, obs=ServingObserver(device=True) if observe else None)
        guard.mark_warm()
        reset_k1_counts()
        results, extra = drive(engine)
        launches, plain = k1_counts()
    try:
        guard.expect_clean()
    except RecompileError as e:
        fail("server", f"{label}: {e}")
    n_layer, vocab = gen.cfg.n_layer, gen.cfg.padded_vocab_size
    if n_layer != 22 or launches <= 0 or launches != n_layer * engine.forward_calls or plain:
        fail("server", f"{label}: K1 launches {launches} != {n_layer} x "
             f"{engine.forward_calls} forwards, plain route {plain}")
    for rid, prompt, new in trace:
        out = results.get(rid)
        if out is None or len(out) - len(prompt) != new or not all(
                0 <= t < vocab for t in out[len(prompt):]):
            fail("server", f"{label}: {rid} did not finish with its {new} tokens in the vocabulary")
    stats = engine.stats
    if observe:
        errors = {r.name: r.error for r in engine.obs.device.reports() if r.error}
        if errors or len(engine.obs.device) < 2:
            fail("server", f"{label}: step reports {errors or 'missing'}")
    roof = cli.roofline_block(engine, stats, [len(p) + n / 2 for _rid, p, n in trace])
    utilization_ok("server", label, roof["mfu"], roof["mbu"])
    summary = {"part": label, "requests": stats.requests_finished,
               "tokens_generated": stats.tokens_generated,
               "engine_tokens_per_s": round(stats.tokens_per_s, 2),
               "host_syncs": stats.host_syncs, "forward_calls": engine.forward_calls,
               "k1_launches": launches, "captures_after_warmup": guard.captures_after_warmup,
               "mfu": roof["mfu"], "mbu": roof["mbu"], **extra}
    if observe:
        summary["latency"] = {name: {k: round(v, 5) for k, v in s.items() if k != "count"}
                              for name, s in engine.obs.latency_summaries().items()}
    return results, engine, launches, summary


PICKED_PORTS: set = set()


def free_port() -> int:
    """A localhost port that no socket holds, below the kernel's ephemeral
    range: a port picked for a job's later run cannot then be taken by a
    socket of its earlier runs (gloo's pairs and clients bind ephemeral
    ports), and no port is handed out twice."""
    import random
    import socket

    try:
        low = int(Path("/proc/sys/net/ipv4/ip_local_port_range").read_text().split()[0])
    except (OSError, ValueError, IndexError):
        low = 32768
    rng = random.Random()
    for _ in range(4096):
        port = rng.randrange(max(1024, low - 12000), low)
        if port in PICKED_PORTS:
            continue
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        PICKED_PORTS.add(port)
        return port
    fail("port", f"no free localhost port below {low}")


def http_call(port, method, path, body=None, timeout=300):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body, headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        conn.close()


def bf16_near_tie(phase, gen, got, want, label) -> None:
    """Where two greedy bf16 streams of one prompt diverge, print the first
    divergent position and the top-2 gap of the bf16 model's logits there
    (a dense forward over the common prefix; the float32 model's gap
    beside it), and fail unless the bf16 gap is within two bf16 roundings
    of the larger logit: two streams served in other batches (a decode
    token in a mixed step or in a decode chunk, another summation order)
    may flip such a tie, and no other."""
    import math

    import torch

    from mdi_llm_tpu_torch.models import transformer

    for rid, w in want.items():
        g = got[rid]
        if g == w:
            continue
        i = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), min(len(g), len(w)))
        toks = torch.tensor([w[:i]], device=gen.device)
        gaps = {}
        with torch.no_grad():
            for name, params in (("bf16", gen.params),
                                 ("f32", transformer.tree_map(lambda x: x.float(), gen.params))):
                logits = transformer.forward(gen.cfg, params, toks,
                                             torch.zeros(1, dtype=torch.long, device=gen.device))
                top = torch.topk(logits[0, -1].float(), 2).values
                gaps[name] = ((top[0] - top[1]).item(), top[0].abs().item())
                del params
        gap, top0 = gaps["bf16"]
        limit = 2 * 2.0 ** (math.floor(math.log2(max(top0, 1e-30))) - 7)
        print(f"{phase}: {label}: {rid} diverges at position {i} (tokens "
              f"{g[i] if i < len(g) else None} vs {w[i] if i < len(w) else None}); bf16 "
              f"top-2 gap there {gap:.5f} (limit {limit:.5f}), float32 {gaps['f32'][0]:.5f}",
              flush=True)
        if not gap <= limit:
            fail(phase, f"{label}: {rid} diverges at position {i} with a bf16 top-2 gap of "
                 f"{gap} > {limit}")
        torch.cuda.empty_cache()


def bf16_divergences(phase, gen, got, want, label) -> int:
    """Print, for every greedy bf16 stream of `got` that diverges from
    `want`'s, the first divergent position i, the tokens a and b there and
    the two tokens' logits in a dense forward of the bf16 model and of the
    float32 model over the common prefix: the float32 gap |f32[a] -
    f32[b]| beside the bf16 model's error on them.  Returns how many
    diverge; gates nothing (a stream whose KV history was computed in
    other batches differs by roundings at every position, so no bound on
    one step holds it)."""
    import torch

    from mdi_llm_tpu_torch.models import transformer

    n = 0
    for rid, w in want.items():
        g = got[rid]
        if g == w:
            continue
        n += 1
        i = next((j for j, (x, y) in enumerate(zip(g, w)) if x != y), min(len(g), len(w)))
        if i >= min(len(g), len(w)):
            fail(phase, f"{label}: {rid} streams differ in length")
        a, b = g[i], w[i]
        toks = torch.tensor([w[:i]], device=gen.device)
        logits = {}
        with torch.no_grad():
            for name, params in (("bf16", gen.params),
                                 ("f32", transformer.tree_map(lambda x: x.float(), gen.params))):
                out = transformer.forward(gen.cfg, params, toks,
                                          torch.zeros(1, dtype=torch.long, device=gen.device))
                logits[name] = out[0, -1].float()
                del params, out
        l16, l32 = logits["bf16"], logits["f32"]
        gap = abs(l32[a] - l32[b]).item()
        err = (abs(l16[a] - l32[a]) + abs(l16[b] - l32[b])).item()
        print(f"{phase}: {label}: {rid} diverges at position {i} (tokens {a} vs {b}); "
              f"float32 logit gap between them {gap:.5f}, the bf16 model's error on them "
              f"{err:.5f}", flush=True)
        torch.cuda.empty_cache()
    return n

def phase_server_http(want, solo, trace, gen, card, tmp):
    """(c): the server CLI as a subprocess on a free localhost port."""
    import os
    import signal

    port = free_port()
    err_path = Path(tmp) / "server.err"
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", SERVER_ENTRY, *SERVE_BASE, "--port", str(port)],
            cwd=str(Path(__file__).resolve().parent), stdout=subprocess.DEVNULL, stderr=err,
            env=dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent)))
    try:
        t0 = time.perf_counter()
        while True:
            try:
                st, _h, body = http_call(port, "GET", "/healthz", timeout=10)
                break
            except OSError:
                if proc.poll() is not None or time.perf_counter() - t0 > 300:
                    fail("server", f"the HTTP server never came up: {err_path.read_text()[-3000:]}")
                time.sleep(0.5)
        up_s = time.perf_counter() - t0
        if st != 200 or json.loads(body)["status"] != "ok":
            fail("server", f"/healthz {st} {body!r}")
        got = {}
        rid, prompt, new = trace[0]
        st, hdrs, raw = http_call(port, "POST", "/v1/completions", json.dumps(
            {"prompt": prompt, "max_tokens": new, "stream": True}))
        events = [b for b in raw.decode().split("\n\n") if b.strip()]
        tokens = [json.loads(b.split("data: ", 1)[1])["token"] for b in events
                  if b.startswith("event: token")]
        if st != 200 or hdrs.get("Content-Type") != "text/event-stream" or not any(
                b.startswith("event: done") for b in events):
            fail("server", f"SSE request: status {st}, {len(events)} events")
        got[rid] = tokens
        rid2, prompt2, new2 = trace[1]
        st, _h, body = http_call(port, "POST", "/v1/completions",
                                 json.dumps({"prompt": prompt2, "max_tokens": new2}))
        if st != 200:
            fail("server", f"JSON request: status {st} {body[:200]!r}")
        got[rid2] = json.loads(body)["tokens"]
        got = {r: p + got[r] for r, p, _n in trace[:2]}
        if got != solo:
            fail("server", "HTTP: tokens differ from the same requests served alone in-process")
        st, _h, body = http_call(port, "GET", "/v1/stats")
        stats = json.loads(body)
        st2, _h, text = http_call(port, "GET", "/metrics")
        samples = {}
        for ln in text.decode().splitlines():
            if ln and not ln.startswith("#"):
                name, value = ln.rsplit(" ", 1)
                samples[name] = float(value)
        if st != 200 or st2 != 200 or samples.get("serving_tokens_generated_total") != \
                stats["tokens_generated"] or stats["tokens_generated"] != new + new2:
            fail("server", f"/v1/stats {st} tokens {stats.get('tokens_generated')}, /metrics "
                 f"{st2} serving_tokens_generated_total "
                 f"{samples.get('serving_tokens_generated_total')}")
        if samples.get("graph_captures_total") != 0:
            fail("server", f"the server captured {samples.get('graph_captures_total')} "
                 "steps while serving")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    err = err_path.read_text()
    if rc != 0 or "draining" not in err:
        fail("server", f"SIGTERM: exit {rc}: {err[-3000:]}")
    bf16_near_tie("server", gen, got, {r: want[r] for r, _p, _n in trace[:2]},
                  f"HTTP vs the closed submission, on {card}")
    same = sum(got[r] == want[r] for r, _p, _n in trace[:2])
    counts = json.loads(err.split("K1-COUNTS ", 1)[1].splitlines()[0])
    line = json.loads([ln for ln in err.splitlines() if ln.startswith("{")][-1])
    if counts["k1"] != 22 * line["forward_calls"] or counts["plain"] or counts["k1"] <= 0:
        fail("server", f"HTTP server: K1 {counts['k1']} != 22 x {line['forward_calls']} "
             f"forwards, plain route {counts['plain']}")
    dev = line["device"]
    errors = {n: r["error"] for n, r in dev["reports"].items() if r["error"]}
    if errors or line["graph_captures"] != 2 or line["graph_replays"] <= 0:
        fail("server", f"HTTP server: reports {errors}, captures {line['graph_captures']}, "
             f"replays {line['graph_replays']}")
    utilization_ok("server", "HTTP", dev["mfu"], dev["mbu"])
    print("server: (c) HTTP " + json.dumps({
        "up_s": round(up_s, 2), "requests": line["requests"],
        "tokens_generated": line["tokens_generated"], "tokens_per_s": line["tokens_per_s"],
        "forward_calls": line["forward_calls"], "k1_launches": counts["k1"],
        "captures_while_serving": 0, "mfu": dev["mfu"], "mbu": dev["mbu"],
        "ttft_s": line["latency"]["ttft_s"], "tpot_s": line["latency"]["tpot_s"]})
        + f"; SSE and JSON tokens equal the requests served alone in-process, {same} of 2 "
        f"equal (a)'s, /metrics tokens = /v1/stats tokens, SIGTERM drained, exit 0; "
        f"on {card}", flush=True)
    return counts["k1"]


def phase_server_spec(card, tmp):
    """(d): cli.serve with speculative serving and a draft model, writing
    the metrics and the trace: the observer's spec counters equal the
    stats line's, the verify spans carry spec_k 4 and their accepted sum
    is spec_accepted."""
    import contextlib
    import io

    from mdi_llm_tpu_torch.cli import serve as cli

    m_path, t_path = Path(tmp) / "spec-metrics.json", Path(tmp) / "spec-trace.json"
    argv = SERVE_BASE + ["--synthetic", str(SERVER_SPEC[0]), "--n-tokens", str(SERVER_SPEC[1]),
                         "--spec-k", "4",
                         "--draft-model", "NanoLlama", "--metrics-out", str(m_path),
                         "--trace-out", str(t_path)]
    reset_k1_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        line = cli.main(argv)
    launches, plain = k1_counts()
    want = 22 * line["forward_calls"] + 12 * line["draft_forward_calls"]
    if launches != want or plain or not line["spec_drafted"] > 0:
        fail("server", f"spec: K1 launches {launches} (want {want}), plain {plain}, "
             f"drafted {line['spec_drafted']}")
    counters = json.loads(m_path.read_text())["metrics"]["counters"]
    pairs = {"serving_spec_drafted_total": "spec_drafted",
             "serving_spec_accepted_total": "spec_accepted",
             "serving_spec_drafted_ngram_total": "spec_drafted_ngram",
             "serving_spec_drafted_model_total": "spec_drafted_model",
             "serving_tokens_generated_total": "tokens_generated",
             "serving_host_syncs_total": "host_syncs"}
    off = {c: (counters.get(c, 0), line[k]) for c, k in pairs.items()
           if counters.get(c, 0) != line[k]}
    if off or counters.get("graph_captures_total") != 0:
        fail("server", f"spec: observer vs stats line {off}, captures while serving "
             f"{counters.get('graph_captures_total')}")
    spans = [e["args"] for e in json.loads(t_path.read_text())["traceEvents"]
             if e.get("ph") == "X" and e.get("name") == "verify"]
    accepted = sum(a["accepted"] for a in spans)
    if not spans or any(a["spec_k"] != 4 for a in spans) or accepted != line["spec_accepted"]:
        fail("server", f"spec: {len(spans)} verify spans, accepted sum {accepted} != "
             f"{line['spec_accepted']}")
    dev = line["device"]
    errors = {n: r["error"] for n, r in dev["reports"].items() if r["error"]}
    if errors or not any(n.startswith("verify") for n in dev["reports"]):
        fail("server", f"spec: step reports {errors or list(dev['reports'])}")
    utilization_ok("server", "spec", dev["mfu"], dev["mbu"])
    print("server: (d) spec " + json.dumps({
        k: line[k] for k in ("requests", "tokens_generated", "tokens_per_s", "host_syncs",
                             "spec_drafted", "spec_accepted", "spec_drafted_model",
                             "forward_calls", "draft_forward_calls")})
        + f" verify spans {len(spans)} (spec_k 4, accepted sum {accepted}), K1 {launches} = "
        f"22 x target + 12 x draft forwards, mfu {dev['mfu']} mbu {dev['mbu']}, reports "
        f"{sorted(dev['reports'])}; on {card}", flush=True)


def phase_server(k1, card):
    """The observer and the open-system server on the card (the module
    docstring, phase 16)."""
    import torch

    from mdi_llm_tpu_torch.cli import serve as cli
    from mdi_llm_tpu_torch.server import OpenLoopRunner, ServingFrontend, poisson_arrivals

    class RecordingFrontend(ServingFrontend):
        """Keeps every handle it hands out (the open-loop runner does not)."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.handles = {}

        def submit(self, *a, **kw):
            handle = super().submit(*a, **kw)
            self.handles[handle.rid] = handle
            return handle

    args = cli.build_parser().parse_args(SERVE_BASE)
    serving = cli.make_serving_config(args)
    warm, _tokenizer = cli.build_engine(args, need_tokenizer=False)
    gen = warm.gen
    _serve_trace(warm, [("w0", [1, 2, 3], 8), ("w1", list(range(1, 40)), 8)])  # CUDA warm-up
    del warm
    trace = cli.synthetic_trace(SERVER_REQUESTS, gen.cfg.vocab_size, gen.max_seq_length, 64)

    def offline(engine):
        return _serve_trace(engine, trace)[0], {}

    def closed(engine):
        front = ServingFrontend(engine, max_queue=len(trace))
        handles = {rid: front.submit(p, n, rid=rid) for rid, p, n in trace}
        t0 = time.perf_counter()
        front.start()
        if not front.drain(timeout=600):
            fail("server", "the closed submission did not drain")
        wall = time.perf_counter() - t0
        front.stop()
        return ({rid: h.result for rid, h in handles.items() if h.result is not None},
                {"wall_s": round(wall, 4), "requests_per_s": round(len(trace) / wall, 3)})

    want, _e, _l, s_off = server_part("(a) offline engine.run", gen, serving, trace, offline)
    print("server: " + json.dumps(s_off) + f"; on {card}", flush=True)
    parts = {}
    for label, observe in (("(a) frontend, observer on", True), ("(a) frontend, observer off", False)):
        got, engine, launches, summary = server_part(label, gen, serving, trace, closed, observe)
        if got != want or summary["host_syncs"] != s_off["host_syncs"]:
            fail("server", f"{label}: streams equal {got == want}, host_syncs "
                 f"{summary['host_syncs']} vs offline {s_off['host_syncs']}")
        parts[label] = summary
        print("server: " + json.dumps(summary) + f"; streams and host_syncs = offline's; on {card}",
              flush=True)
        if observe:
            k1.setdefault("paths", {})["server"] = launches
        del engine
    rate = parts["(a) frontend, observer on"]["requests_per_s"]

    for share in (0.25, 1.0):
        qps = share * rate

        def open_loop(engine, qps=qps):
            front = RecordingFrontend(engine, max_queue=len(trace)).start()
            rep = OpenLoopRunner(front, poisson_arrivals(trace, qps, seed=10137),
                                 drain_timeout_s=600).run()
            front.drain(timeout=600)
            front.stop()
            if rep.completed != len(trace) or rep.rejected or rep.errored:
                fail("server", f"open loop at {qps:.3f} req/s: {rep.to_dict()}")
            return ({rid: h.result for rid, h in front.handles.items() if h.result is not None},
                    {"offered_qps": round(qps, 3), "load": f"{share:.0%} of (a)",
                     "wall_s": round(rep.wall_s, 4),
                     "tokens_per_s": round(engine.stats.tokens_generated / rep.wall_s, 2)})

        _got, engine, _launches, summary = server_part(
            f"(b) open loop {share:.0%}", gen, serving, trace, open_loop)
        print("server: " + json.dumps(summary) + f"; on {card}", flush=True)
        del engine
    # (c)'s two requests served alone, as the HTTP server serves them
    solo = {}
    for item in trace[:2]:
        solo.update(_serve_trace(gen.serve(serving=serving), [item])[0])
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        phase_server_http(want, solo, trace, gen, card, tmp)
        del gen
        torch.cuda.empty_cache()
        phase_server_spec(card, tmp)
    torch.cuda.empty_cache()


TIER_BLOCKS = 112  # of 1024 for full coverage: the 24 requests preempt
TIER_HOST_MIB = 1024
TIER_CHUNK_BLOCKS = (1, 8, 32)  # link-rate transfer widths, in pool blocks


def tier_trace(vocab):
    """The serve phase's 16 synthetic requests between two groups of 4
    that share a 256-token prefix: the first group registers the prefix
    chain, the synthetic requests evict it from the pool (spilling it with
    a tier), and the last group finds it again."""
    import numpy as np

    from mdi_llm_tpu_torch.cli.serve import synthetic_trace

    rng = np.random.default_rng(10138)
    shared = rng.integers(1, vocab, 256).tolist()

    def group(tag):
        return [(f"{tag}{i}", shared + rng.integers(1, vocab, int(rng.integers(8, 64))).tolist(), 32)
                for i in range(4)]

    return group("head") + synthetic_trace(16, vocab, 2048, 64) + group("tail")


def tier_serve(label, argv, trace):
    """The serve CLI's engine for `argv` over `trace`, its `run()` under a
    captures guard marked warm once the engine is built, with K1's and the
    plain route's counts set to 0 just before and read just after.  Fails
    unless every request finished in the vocabulary, K1 ran 22 times per
    forward, the plain route never, and nothing was captured after warm-up.
    Returns (results, engine, launches, summary)."""
    from mdi_llm_tpu_torch.cli import serve as cli
    from mdi_llm_tpu_torch.utils.profiling import CompileGuard, RecompileError

    args = cli.build_parser().parse_args(argv)
    guard = CompileGuard(label=f"tier {label}")
    with guard:
        engine, _tokenizer = cli.build_engine(args, need_tokenizer=False)
        guard.mark_warm()
        reset_k1_counts()
        results, stats = _serve_trace(engine, trace)
        launches, plain = k1_counts()
    try:
        guard.expect_clean()
    except RecompileError as e:
        fail("tier", f"{label}: {e}")
    n_layer, vocab = engine.gen.cfg.n_layer, engine.gen.cfg.padded_vocab_size
    if n_layer != 22 or launches <= 0 or launches != n_layer * engine.forward_calls or plain:
        fail("tier", f"{label}: K1 launches {launches} != {n_layer} x "
             f"{engine.forward_calls} forwards, plain route {plain}")
    for rid, prompt, new in trace:
        out = results.get(rid)
        if out is None or len(out) - len(prompt) != new or not all(
                0 <= t < vocab for t in out[len(prompt):]):
            fail("tier", f"{label}: {rid} did not finish with its {new} tokens in the vocabulary")
    summary = {"run": label, "tokens_per_s": round(stats.tokens_per_s, 2),
               "wall_s": round(stats.wall_s, 4), "prefill_tokens": stats.prefill_tokens,
               "preemptions": stats.preemptions, "swaps_out": stats.swaps_out,
               "swaps_in": stats.swaps_in, "swap_out_bytes": stats.swap_out_bytes,
               "swap_in_bytes": stats.swap_in_bytes, "prefix_hits_host": stats.prefix_hits_host,
               "prefix_cache_hits": stats.prefix_cache_hits,
               "restore_issue_s": round(stats.restore_issue_s, 5), "host_syncs": stats.host_syncs,
               "forward_calls": engine.forward_calls, "k1_launches": launches,
               "captures_after_warmup": guard.captures_after_warmup}
    return results, engine, launches, summary


def tier_f32_parity(trace, card):
    """The tier trace in float32 (4 layers at full width) on the tight pool
    with the tier, on it recomputing, and on the full pool: the tier run
    must swap in and hit spilled prefixes, and both tight runs must give
    the full pool's streams but for a float32 near-tie (`divergence_ok`)."""
    import torch

    gen = tiny_llama_generator(4, torch.float32)
    knobs = dict(block_size=16, max_batch=8)
    streams, stats = {}, {}
    for label, extra in (("tier", dict(max_blocks=TIER_BLOCKS, host_pool_mib=TIER_HOST_MIB)),
                         ("recompute", dict(max_blocks=TIER_BLOCKS)), ("full pool", {})):
        streams[label], stats[label] = _serve_trace(gen.serve(**knobs, **extra), trace)
    s = stats["tier"]
    if not (s.swaps_in > 0 and s.prefix_hits_host > 0 and stats["recompute"].preemptions):
        fail("tier", f"float32: tier run {s.to_dict()}, recompute run preemptions "
             f"{stats['recompute'].preemptions}")
    for label in ("tier", "recompute"):
        divergence_ok("tier", gen, streams[label], streams["full pool"], f"float32 {label} vs full pool")
    same = {k: sum(streams[k][r] == streams["full pool"][r] for r in streams[k])
            for k in ("tier", "recompute")}
    print(f"tier: float32, 4 layers at full width: {same['tier']} of {len(trace)} streams of "
          f"the tier run ({s.swaps_out} swaps out, {s.swaps_in} in, {s.prefix_hits_host} "
          f"host prefix hits) and {same['recompute']} of the recompute run identical to "
          f"the full pool's; on {card}", flush=True)
    del gen
    torch.cuda.empty_cache()


def tier_round_trip(gen, label, kv_dtype, seed):
    """Random bytes in every leaf of a fresh engine's pool (payload and
    scales), 11 blocks fetched to host slots (two fixed-width chunks, the
    second padded) and restored into 11 other blocks: the slots must hold
    the blocks' bytes, the restored blocks must equal the originals byte
    for byte, and no other block but the trash block may change."""
    import torch

    from mdi_llm_tpu_torch.models import transformer
    from mdi_llm_tpu_torch.serving.host_tier import raw_dtype

    engine = gen.serve(block_size=16, max_batch=8, max_blocks=64, host_pool_mib=64,
                       kv_dtype=kv_dtype)
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    raws = [x.view(raw_dtype(x.dtype)) for x in transformer.tree_leaves(engine._kv)]
    for r in raws:
        info = torch.iinfo(r.dtype)
        r.copy_(torch.randint(info.min, info.max, r.shape, generator=g, device=DEVICE,
                              dtype=torch.int64).to(r.dtype))
    src = [5, 9, 17, 3, 40, 41, 42, 43, 44, 50, 51]
    dst = [60, 61, 2, 33, 34, 35, 20, 21, 22, 7, 8]
    slots = engine.host_tier.store.alloc(len(src))
    before = [r.clone() for r in raws]
    engine._issue_fetch(src, slots)
    engine._drain_swaps()
    idx = torch.tensor(src, device=DEVICE)
    for r, host in zip(raws, engine.host_tier.store.read(slots)):
        if not torch.equal(host.view(r.dtype).to(DEVICE), r.index_select(1, idx).movedim(1, 0)):
            fail("tier", f"{label}: a host slot does not hold its block's bytes")
    engine._restore(slots, dst)
    torch.cuda.synchronize()
    keep = [b for b in range(raws[0].shape[1]) if b not in dst and b != 0]
    for r, old in zip(raws, before):
        if not torch.equal(r[:, dst], old[:, src]):
            fail("tier", f"{label}: restored blocks differ from the fetched ones")
        if not torch.equal(r[:, keep], old[:, keep]):
            fail("tier", f"{label}: a restore changed a block outside its targets")
    leaves = [f"{tuple(x.shape)} {str(x.dtype).replace('torch.', '')}"
              for x in transformer.tree_leaves(engine._kv)]
    del engine
    return leaves


def link_rates(block_bytes):
    """Pinned device -> host and host -> device GB/s of `TIER_CHUNK_BLOCKS`
    blocks per copy, by CUDA events over 50 copies each."""
    import torch

    out = {}
    for n in TIER_CHUNK_BLOCKS:
        nbytes = n * block_bytes
        dev = torch.empty(nbytes, dtype=torch.uint8, device=DEVICE)
        host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        d2h = cuda_ms(lambda: host.copy_(dev, non_blocking=True), 50)
        h2d = cuda_ms(lambda: dev.copy_(host, non_blocking=True), 50)
        out[n] = {"bytes": nbytes, "d2h_gbps": round(nbytes / d2h / 1e6, 3),
                  "h2d_gbps": round(nbytes / h2d / 1e6, 3),
                  "d2h_ms": round(d2h, 5), "h2d_ms": round(h2d, 5)}
        del dev, host
    return out


def phase_tier(k1, card):
    """The host-RAM KV tier on the card (the module docstring, phase 17)."""
    import torch

    from mdi_llm_tpu_torch.cli import serve as cli
    from mdi_llm_tpu_torch.serving.host_tier import lookup_host_link_gbps

    full = SERVE_BASE + ["--no-device-obs"]
    tight = full + ["--max-blocks", str(TIER_BLOCKS)]
    warm, _tokenizer = cli.build_engine(cli.build_parser().parse_args(full),
                                        need_tokenizer=False)
    gen = warm.gen
    _serve_trace(warm, [("w0", [1, 2, 3], 8), ("w1", list(range(1, 40)), 8)])  # CUDA warm-up
    del warm
    trace = tier_trace(gen.cfg.vocab_size)
    runs = {}
    tiered = tight + ["--host-pool-mib", str(TIER_HOST_MIB)]
    # the first tier run pays the process's first launches of the tier's
    # copy kernels; the second is the one compared
    for label, argv in (("tier, first", tiered), ("recompute", tight), ("full pool", full),
                        ("tier", tiered)):
        runs[label] = tier_serve(label, argv, trace)
        torch.cuda.empty_cache()
    first = runs.pop("tier, first")
    if first[0] != runs["tier"][0]:
        fail("tier", "two tier runs of one trace gave different streams")
    print("tier: " + json.dumps(first[3]) + f"; on {card}", flush=True)
    del first
    got, engine, launches, s_on = runs["tier"]
    rec, _e, _l, s_off = runs["recompute"]
    want, _e, _l, s_full = runs["full pool"]
    tier = engine.host_tier
    restore = engine.obs.metrics.histogram("serving_restore_wait_ms")
    s_on.update({
        "host_blocks": tier.store.num_slots,
        "host_pool_mib": round(tier.store.nbytes / 2**20, 1),
        "block_bytes": engine._host_block_bytes,
        "prefill_tokens_saved": s_off["prefill_tokens"] - s_on["prefill_tokens"],
        "link_gbps_prior": lookup_host_link_gbps(torch.cuda.get_device_name(0)),
        "link_gbps_observed": round(tier.cost_model.link_gbps, 3),
        "prefill_tokens_per_s_observed": round(tier.cost_model.prefill_tokens_per_s, 1),
        "restore_wait_ms_p50": round(restore.percentile(50), 4),
        "restore_waits": restore.count})
    for s in (s_on, s_off, s_full):
        print("tier: " + json.dumps(s) + f"; on {card}", flush=True)
    if not (s_on["swaps_out"] > 0 and s_on["swaps_in"] > 0 and s_on["prefix_hits_host"] > 0):
        fail("tier", f"the tier run did not swap out, swap in and hit spilled prefixes: {s_on}")
    if s_off["swaps_out"] or s_off["swaps_in"] or not s_off["preemptions"] \
            or s_full["preemptions"]:
        fail("tier", f"the recompute run {s_off}, the full-pool run {s_full}")
    # each run batches differently (and a recompute re-prefills its victims'
    # generated tokens): in bf16 a stream's KV history differs by roundings
    # between the runs, so its divergences are printed; the float32 runs
    # (`tier_f32_parity`) hold the tier to the near-tie rule of the parity
    # phases
    for label, streams in (("tier", got), ("recompute", rec)):
        bf16_divergences("tier", gen, streams, want, f"{label} vs full pool")
    same = {label: sum(r[rid] == want[rid] for rid in want)
            for label, r in (("tier", got), ("recompute", rec))}
    print(f"tier: {len(trace)} requests over {TIER_BLOCKS} pool blocks: streams identical "
          f"to the full pool's {same['tier']} with the tier, {same['recompute']} "
          f"recomputing (the others as checked above); tokens/s {s_on['tokens_per_s']} "
          f"with the tier, {s_off['tokens_per_s']} recomputing, {s_full['tokens_per_s']} "
          f"on the full pool; {s_on['prefill_tokens_saved']} prefill tokens saved; "
          f"restore_wait p50 {s_on['restore_wait_ms_p50']} ms (histogram estimate); "
          f"on {card}", flush=True)
    k1.setdefault("paths", {})["tier"] = launches
    block_bytes = engine._host_block_bytes
    del engine, runs, got, rec, want

    tier_f32_parity(trace, card)
    for label, kv_dtype, seed in (("bf16", None, 1), ("int8", "int8", 2), ("e4m3", "float8", 3)):
        leaves = tier_round_trip(gen, label, kv_dtype, seed)
        print(f"tier: {label} pool round trip byte-identical, 11 blocks in 2 chunks "
              f"to host slots and back into 11 other blocks; leaves {leaves}", flush=True)
    rates = link_rates(block_bytes)
    print("tier: pinned copies " + json.dumps({f"{n} blocks": r for n, r in rates.items()})
          + f" ({block_bytes} bytes per bf16 block); on {card}", flush=True)
    del gen
    torch.cuda.empty_cache()


QUANT_MODES = ("int8", "w8a8", "int4")
QUANT_TOKENS = 8  # new tokens of the quant phase's serves and generates (64 before the doctor
# phase's cuts, 32 before the analysis phase's and the serve preflights', 16 before the
# layouts over processes)
QUANT_LAYERS = 6  # tiny-llama's layers in those serves and generates (22 before the sp and
# ep runs over processes, 12 before the layouts over processes: each quantized serve's
# preflight traces every layer)


def plain_quantized_einsum(spec, x, p):
    """The plain version of `quant.quantized_einsum` for the linear specs:
    w8 and int4 as a float64 product with the dequantized weights; w8a8
    with the same per-token int8 activations, their int8 product with the
    weights as a float64 product (exact, as the int32 one is), then the
    same float32 scaling.  (A float64 scaling would move activations across
    int8 rounding boundaries in later layers: a discontinuity, not an
    error of the route.)"""
    import torch

    from mdi_llm_tpu_torch.ops import quant

    if "weight_q8" in p:
        xf = x.float()
        xs = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / torch.full((), 127.0,
                                                                          device=x.device),
                         min=1e-10)
        xq = torch.clamp(torch.round(xf / xs), -127, 127)
        y = (xq.double() @ p["weight_q8"].double().t()).float()
        return (y * xs * p["scale"]).to(x.dtype)
    if "weight_q4" in p:
        w = quant.unpack_w4(p["weight_q4"], p["scale"], torch.float64)
    elif "weight_q" in p:
        w = p["weight_q"].double() * p["scale"].double()[..., None]
    else:
        w = p["weight"].double()
    return (x.double() @ w.t()).to(x.dtype)


def quant_forward_parity():
    """One float32 forward of each mode (4 layers at full width) against
    the same forward through `plain_quantized_einsum`: max |err| <=
    1e-4 x max(1, max |plain|).  Returns {mode: (err, limit)}."""
    from unittest import mock

    import torch

    from mdi_llm_tpu_torch.config import Config
    from mdi_llm_tpu_torch.models import transformer
    from mdi_llm_tpu_torch.ops.quant import FLAG_TO_MODE, quantize_params

    cfg = Config.from_name(TINY_LLAMA, n_layer=4)
    params = transformer.init_params(cfg, 10137, dtype=torch.float32, device=DEVICE)
    g = torch.Generator(device=DEVICE).manual_seed(5)
    toks = torch.randint(1, cfg.vocab_size, (2, 100), generator=g, device=DEVICE)
    pos = torch.zeros(2, dtype=torch.long, device=DEVICE)
    out = {}
    with torch.no_grad():
        for mode in QUANT_MODES:
            qp = quantize_params(params, mode=FLAG_TO_MODE[mode])
            got = transformer.forward(cfg, qp, toks, pos)
            with mock.patch.object(transformer, "quantized_einsum", plain_quantized_einsum):
                ref = transformer.forward(cfg, qp, toks, pos)
            err = (got - ref).abs().max().item()
            limit = TOL["float32"] * max(1.0, ref.abs().max().item())
            if not err <= limit:
                fail("quant", f"{mode}: f32 forward max |err| {err} > {limit} against the plain version")
            out[mode] = (err, limit)
            del qp, got, ref
    del params
    torch.cuda.empty_cache()
    return out


def agreement(got, want, prompts):
    """Generated tokens equal to `want`'s up to each stream's first
    divergence, over all generated tokens."""
    same = total = 0
    for key, w in want.items():
        g, n = got[key], prompts[key]
        new_w, new_g = w[n:], g[n:]
        k = next((i for i, (a, b) in enumerate(zip(new_g, new_w)) if a != b),
                 min(len(new_g), len(new_w)))
        same, total = same + k, total + len(new_w)
    return round(same / max(1, total), 4)


def phase_quant(k1, k2, card, ckpt_dir):
    """Weight quantization on the card (the module docstring, phase 18)."""
    import torch

    from mdi_llm_tpu_torch.cli import prepare_model
    from mdi_llm_tpu_torch.cli import serve as cli
    from mdi_llm_tpu_torch.config import Config
    from mdi_llm_tpu_torch.generation import Generator
    from mdi_llm_tpu_torch.models import transformer
    from mdi_llm_tpu_torch.obs.roofline import param_bytes
    from mdi_llm_tpu_torch.ops.flash import flash_attention, flash_attention_plain
    from mdi_llm_tpu_torch.ops.quant import quantize_params, tree_has_quantized
    from mdi_llm_tpu_torch.utils import checkpoint as ck

    # (a) the serve CLI, bf16 then each mode, K1 replayed inside the graphs
    serve_argv = SERVE_BASE + ["--override", f"n_layer={QUANT_LAYERS}", "--synthetic", "16",
                               "--n-tokens", str(QUANT_TOKENS)]
    serves, k1_launches = {}, 0
    for mode in ("none",) + QUANT_MODES:
        line, launches, engine, results = serve_checked("quant", serve_argv + ["--quantize", mode],
                                                        n_layer=QUANT_LAYERS)
        graphs = engine.graph_stats()
        if graphs["captures"] != graphs["steps"] or graphs["replays"] <= 0:
            fail("quant", f"--quantize {mode}: step graphs {graphs}")
        if (mode != "none") != bool(engine.gen.quantized):
            fail("quant", f"--quantize {mode}: Generator.quantized is {engine.gen.quantized}")
        dev = line["device"]
        utilization_ok("quant", f"serve --quantize {mode}", dev.get("mfu"), dev.get("mbu"))
        flops = {n: r["flops"] for n, r in dev["reports"].items()}
        if not flops or None in flops.values():
            fail("quant", f"--quantize {mode}: step reports {dev['reports']}")
        serves[mode] = (line, results, param_bytes(engine.gen.params), flops)
        if mode != "none":
            k1_launches += launches
        engine_vocab = engine.gen.cfg.vocab_size
        del engine
        torch.cuda.empty_cache()
    bline, bres, bbytes, bflops = serves["none"]
    trace = cli.synthetic_trace(16, engine_vocab, 2048, QUANT_TOKENS)
    lens = {rid: len(p) for rid, p, _n in trace}
    for mode in QUANT_MODES:
        line, results, nbytes, flops = serves[mode]
        ratio = {n: round(flops[n] / bflops[n], 6) for n in bflops}
        if mode == "w8a8" and any(abs(r - 1) > 1e-4 for r in ratio.values()):
            fail("quant", f"w8a8 step flops / bf16 step flops {ratio} (want within 0.01%)")
        print("quant: serve " + json.dumps({
            "quantize": mode, "weight_bytes": nbytes, "bf16_weight_bytes": bbytes,
            "tokens_per_s": line["tokens_per_s"], "bf16_tokens_per_s": bline["tokens_per_s"],
            "mfu": line["device"]["mfu"], "mbu": line["device"]["mbu"],
            "bf16_mbu": bline["device"]["mbu"], "forward_calls": line["forward_calls"],
            "graph_captures": line["graph_captures"], "graph_replays": line["graph_replays"],
            "greedy_agreement_with_bf16": agreement(results, bres, lens),
            "step_flops_over_bf16": ratio}) + f"; on {card}", flush=True)
    k1.setdefault("paths", {})["quant"] = k1_launches

    # (b) Generator.generate on the generate phase's prompts, K2 in the prefill
    cfg = Config.from_name(TINY_LLAMA, n_layer=QUANT_LAYERS)
    params = transformer.init_params(cfg, 10137, dtype=torch.bfloat16, device=DEVICE)
    prompts = long_prompts((1100, 1370, 1650, 1900), cfg.vocab_size)
    plens = {i: len(p) for i, p in enumerate(prompts)}
    gens, k2_launches = {}, 0
    for mode in ("none",) + QUANT_MODES:
        gen = Generator(cfg, params, max_seq_length=2048, device=DEVICE, quantize=mode)
        gen.generate([[1, 2, 3]] * 4, 4, temperature=0.0)  # warm-up, not counted
        torch.cuda.synchronize()
        flash_attention.launches = flash_attention_plain.calls = 0
        # decode chunks of 8: each capture half the launches of one of 16
        # (PR 18's cuts of the whole run's time)
        outs, stats = gen.generate(prompts, QUANT_TOKENS, temperature=0.0, chunk_size=8)
        torch.cuda.synchronize()
        launches, plain = flash_attention.launches, flash_attention_plain.calls
        if launches != QUANT_LAYERS or plain:
            fail("quant", f"generate --quantize {mode}: K2 launches {launches} (want "
                 f"{QUANT_LAYERS}), plain version calls {plain} (want 0)")
        for i, (p, o) in enumerate(zip(prompts, outs)):
            if len(o) - len(p) != QUANT_TOKENS or not all(0 <= t < cfg.padded_vocab_size for t in o[len(p):]):
                fail("quant", f"generate --quantize {mode}: sample {i} did not get {QUANT_TOKENS} tokens")
        # decode tokens/s without the decode-chunk graph's first capture
        # (the warm-up call's shapes differ), which decode_s includes
        decode_tps = stats.tokens_generated / (stats.decode_s - stats.capture_s)
        gens[mode] = (dict(enumerate(outs)), stats, decode_tps)
        if mode != "none":
            k2_launches += launches
            print("quant: generate " + json.dumps({
                "quantize": mode, "prefill_s": round(stats.prefill_s, 4),
                "decode_s": round(stats.decode_s, 4), "capture_s": round(stats.capture_s, 4),
                "decode_tokens_per_s": round(decode_tps, 2),
                "bf16_decode_tokens_per_s": round(gens["none"][2], 2),
                "bf16_prefill_s": round(gens["none"][1].prefill_s, 4),
                "k2_launches": launches, "graph_captures": stats.captures,
                "greedy_agreement_with_bf16": agreement(gens[mode][0], gens["none"][0], plens)})
                + f"; on {card}", flush=True)
        del gen
        torch.cuda.empty_cache()
    k2.setdefault("paths", {})["quant"] = k2_launches
    del params
    torch.cuda.empty_cache()

    # (c) a float32 forward of each mode against its plain version
    for mode, (err, limit) in quant_forward_parity().items():
        print(f"quant: f32 forward, 4 layers at full width, {mode}: max |err| {err:.3e} "
              f"<= {limit:.3e} against the float64 plain version", flush=True)

    # (d) prepare_model --quantize int8 on the ckpt phase's snapshot
    if not ck.has_checkpoint(ckpt_dir):
        write_snapshot(ckpt_dir)
        prepare_model.main([str(ckpt_dir)])
    t0 = time.perf_counter()
    prepare_model.main([str(ckpt_dir), "--quantize", "int8"])
    prep_s = time.perf_counter() - t0
    sibling = ckpt_dir.parent / f"{ckpt_dir.name}-int8"
    _cfg, stored = ck.load_checkpoint(sibling, device=DEVICE)
    _cfg, original = ck.load_checkpoint(ckpt_dir, device=DEVICE)
    on_card = quantize_params(original, mode="w8")
    want, got = transformer.tree_leaves(on_card), transformer.tree_leaves(stored)
    differ = [i for i, (a, b) in enumerate(zip(want, got))
              if not (a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b))]
    if not tree_has_quantized(stored) or len(want) != len(got) or differ:
        fail("quant", f"the sibling (quantized on the CPU) differs from the card's quantizer "
             f"on the same weights in leaves {differ} of {len(want)}")
    del stored, original, on_card, want, got
    torch.cuda.empty_cache()
    ckpt_base = SERVE_BASE[2:] + ["--synthetic", "16", "--n-tokens", str(QUANT_TOKENS)]
    _l, _n, e_sib, r_sib = serve_checked("quant", ["--ckpt", str(sibling)] + ckpt_base)
    sib_quantized = e_sib.gen.quantized
    del e_sib
    _l, _n, e_flag, r_flag = serve_checked(
        "quant", ["--ckpt", str(ckpt_dir), "--quantize", "int8"] + ckpt_base)
    del e_flag
    if not sib_quantized or r_sib != r_flag:
        fail("quant", f"the int8 sibling (quantized {sib_quantized}) served other tokens than "
             "--quantize int8 on the original")
    print(f"quant: prepare_model --quantize int8 wrote {sibling.name} in {prep_s:.1f} s; "
          "every leaf equal to the card's quantizer's, the sibling loads quantized and "
          "serves --quantize int8's 16 greedy streams", flush=True)
    torch.cuda.empty_cache()


MIXTRAL = "Mixtral-8x7B-v0.1"
MOE_LAYERS = 4  # of 32 (16, 46.4 GB of bf16 blocks, before the layouts over processes)
MOE_QUANT_TOKENS = 8  # new tokens per request of int8 Mixtral at all 32 layers (16 before the
# layouts over processes)
# Mixtral-8x7B's published widths, which every MoE phase checks it runs at
MIXTRAL_WIDTHS = dict(n_embd=4096, n_head=32, n_query_groups=8, head_size=128,
                      intermediate_size=14336, n_expert=8, n_expert_per_token=2,
                      padded_vocab_size=32256, rope_base=1000000)
MOE_SERVE_TOKENS = 16  # new tokens per request of the moe phase's serves (64, then 32, before
# the cuts for the whole run's time: its bf16 plain-route serve is eager)
MOE_SERVE = ["--model", MIXTRAL, "--override", f"n_layer={MOE_LAYERS}", "--dtype", "bfloat16",
             "--seed", "10137", "--max-batch", "8", "--block-size", "16",
             "--sequence-length", "2048", "--synthetic", "16", "--n-tokens",
             str(MOE_SERVE_TOKENS)]


def free() -> None:
    """Collect what a phase dropped (an engine and its step graphs hold
    reference cycles) and hand the cached blocks back to the card."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def mixtral_config(phase, n_layer):
    from mdi_llm_tpu_torch.config import Config

    cfg = Config.from_name(MIXTRAL, n_layer=n_layer)
    widths_ok(phase, cfg)
    return cfg


def widths_ok(phase, cfg) -> None:
    got = {k: getattr(cfg, k) for k in MIXTRAL_WIDTHS}
    if got != MIXTRAL_WIDTHS or cfg.mlp_class_name != "LLaMAMoE":
        fail(phase, f"Mixtral's widths {got} ({cfg.mlp_class_name}), want {MIXTRAL_WIDTHS}")


def engine_serve(phase, gen, trace, n_layer, serving=None, observe=True, use_kernel=None):
    """`trace` through a fresh engine over `gen` (the serve CLI's defaults:
    8 slots, 16-token blocks, token budget 136, decode chunks of 8 with
    double buffering, CUDA graphs; `use_kernel=False` takes the plain
    route), checked by `served`.  Returns (results, stats line, engine,
    K1 launches)."""
    import dataclasses

    from mdi_llm_tpu_torch.config import ServingConfig
    from mdi_llm_tpu_torch.obs import ServingObserver

    serving = serving or ServingConfig(block_size=16, max_batch=8)
    if use_kernel is not None:
        serving = dataclasses.replace(serving, use_kernel=use_kernel)
    engine = gen.serve(serving=serving, obs=ServingObserver(device=True) if observe else None)
    _trace, results, line, engine, launches = served(
        phase, lambda: (trace, *_serve_trace(engine, trace), engine), n_layer,
        plain_route=use_kernel is False)
    return results, line, engine, launches


def router_flips(gen, prefix) -> tuple:
    """Two bf16 dense forwards over `prefix`, attention through the torch
    route and through K2 (another summation order), with each MoE layer's
    top-k experts recorded: (layers whose top-k set differs at the last
    position, (layer, position) pairs that differ, pairs compared)."""
    from unittest import mock

    import torch

    from mdi_llm_tpu_torch.models import transformer

    real = transformer.moe_forward
    picks = {}

    def recording(cfg, p, x, with_aux=False):
        router = transformer.quantized_einsum("...i,ei->...e", x, p["gate"]).float()
        top = torch.topk(torch.softmax(router, -1), cfg.n_expert_per_token, dim=-1).indices
        picks[route].append(top.sort(dim=-1).values)
        return real(cfg, p, x, with_aux=with_aux)

    toks = torch.tensor([prefix], device=gen.device)
    zero = torch.zeros(1, dtype=torch.long, device=gen.device)
    with torch.no_grad(), mock.patch.object(transformer, "moe_forward", recording):
        for route, flash in (("dense", False), ("K2", True)):
            picks[route] = []
            transformer.forward(gen.cfg, gen.params, toks, zero, use_flash=flash)
    differ = torch.stack([(a != b).any(-1)[0] for a, b in zip(picks["dense"], picks["K2"])])
    return int(differ[:, -1].sum()), int(differ.sum()), differ.numel()


def moe_divergences(phase, gen, got, want, label) -> int:
    """Print, for every greedy bf16 stream of `got` that diverges from
    `want`'s, the first divergent position, the tokens there, the bf16
    model's top-2 logit gap over the common prefix and the router flips
    `router_flips` finds there.  Gates nothing: a router near-tie flips
    with the summation order and changes the token's output far more than
    the logits' gap shows.  Returns how many diverge."""
    import torch

    from mdi_llm_tpu_torch.models import transformer

    n = 0
    for rid, w in want.items():
        g = got[rid]
        if g == w:
            continue
        n += 1
        i = next((j for j, (x, y) in enumerate(zip(g, w)) if x != y), min(len(g), len(w)))
        with torch.no_grad():
            logits = transformer.forward(gen.cfg, gen.params, torch.tensor([w[:i]], device=gen.device),
                                         torch.zeros(1, dtype=torch.long, device=gen.device))
        top = torch.topk(logits[0, -1].float(), 2).values
        last, pairs, total = router_flips(gen, w[:i])
        print(f"{phase}: {label}: {rid} diverges at position {i} (tokens "
              f"{g[i] if i < len(g) else None} vs {w[i] if i < len(w) else None}); bf16 "
              f"top-2 gap {(top[0] - top[1]).item():.5f}; router flips dense vs K2 "
              f"attention at the diverging step: {last} of {gen.cfg.n_layer} layers "
              f"({pairs} of {total} (layer, position) pairs over the prefix)", flush=True)
        del logits
        free()
    return n


def flash_case_ms(B, T, H, G, hs, dtype=None):
    """K2 against its plain version at one causal shape: returns the
    kernel's max |err| and (ms, plain ms, SDPA ms, bound ms, bound by)."""
    import torch
    import torch.nn.functional as F

    from mdi_llm_tpu_torch.ops.flash import flash_attention, flash_attention_plain

    dtype = dtype or torch.bfloat16
    name = str(dtype).replace("torch.", "")
    q, k, v = flash_inputs(B, T, dtype, seed=T + B + hs, H=H, G=G, hs=hs)
    out = flash_attention(q, k, v)
    ref, _lse = flash_attention_plain(q.float(), k.float(), v.float(), causal=True)
    err = (out.float() - ref).abs().max().item()
    del ref, out
    if not err <= TOL[name]:
        fail("flash", f"K2 {name} B={B} T={T} H={H} G={G} hs={hs}: max|err| {err}")
    ms = cuda_ms(lambda: flash_attention(q, k, v), 20)
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, causal=True), 3)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 20)
    free()
    return err, (ms, plain_ms, lib_ms) + flash_bound(B, H, G, T, hs, dtype, True, False)


def phase_moe(k1, k2, card):
    """Mixtral-8x7B at full width in bf16 (the module docstring, phase 19)."""
    import dataclasses

    import torch

    from mdi_llm_tpu_torch.cli import serve as cli
    from mdi_llm_tpu_torch.generation import Generator
    from mdi_llm_tpu_torch.models import transformer
    from mdi_llm_tpu_torch.obs.roofline import param_bytes
    from mdi_llm_tpu_torch.ops.flash import flash_attention, flash_attention_plain

    # (a) the serve CLI at `MOE_LAYERS` layers, K1 replayed inside the step graphs
    free()
    torch.cuda.reset_peak_memory_stats()
    line, launches, engine, results = serve_checked("moe", MOE_SERVE, n_layer=MOE_LAYERS)
    gen, cfg = engine.gen, engine.gen.cfg
    widths_ok("moe", cfg)
    graphs = engine.graph_stats()
    if graphs["captures"] != graphs["steps"] or graphs["replays"] <= 0:
        fail("moe", f"step graphs {graphs}")
    dev = line["device"]
    utilization_ok("moe", "serve", dev.get("mfu"), dev.get("mbu"))
    print("moe: serve " + json.dumps({
        "model": MIXTRAL, "layers": cfg.n_layer, **{k: line[k] for k in (
            "requests", "tokens_generated", "tokens_per_s", "wall_s", "decode_s", "prefill_s",
            "mixed_steps", "decode_steps", "host_syncs", "forward_calls", "graph_captures",
            "graph_replays", "capture_s")},
        "mfu": dev["mfu"], "mbu": dev["mbu"], "weight_bytes": param_bytes(gen.params),
        "peak_memory_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3),
        "k1_launches": launches, "k1_merge_launches": engine.k1_merge_launches})
        + f"; MFU counts the dense formulation's 8 experts per token; on {card}", flush=True)
    k1.setdefault("paths", {})["moe"] = launches
    args = cli.build_parser().parse_args(MOE_SERVE)
    trace = cli.synthetic_trace(16, cfg.vocab_size, 2048, MOE_SERVE_TOKENS)
    serving = cli.make_serving_config(args)
    params = gen.params
    del engine, gen
    free()

    # the same trace through the plain route in bf16: divergences printed only
    gen = Generator(cfg, params, max_seq_length=2048, device=DEVICE)
    plain_results, _pl, engine, _n = engine_serve("moe", gen, trace, MOE_LAYERS, serving=serving,
                                                  observe=False, use_kernel=False)
    del engine
    free()
    n_div = moe_divergences("moe", gen, results, plain_results, "bf16 K1 vs plain route")
    print(f"moe: bf16 serve, {n_div} of {len(trace)} greedy streams diverge between K1 and "
          "the plain route (printed, not gated: parity is held in float32 below)", flush=True)

    # (b) Generator.generate, K2 in the prefill
    gen.generate([[1, 2, 3]] * 4, 4, temperature=0.0)  # warm-up, not counted
    prompts = long_prompts((1100, 1370, 1650, 1900), cfg.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = flash_attention_plain.calls = 0
    outs, stats = gen.generate(prompts, 64, temperature=0.0, chunk_size=16)
    torch.cuda.synchronize()
    k2_launches, plain = flash_attention.launches, flash_attention_plain.calls
    if k2_launches != MOE_LAYERS or plain:
        fail("moe", f"generate: K2 launches {k2_launches} (want {MOE_LAYERS}), plain {plain}")
    for i, (p, o) in enumerate(zip(prompts, outs)):
        if len(o) - len(p) != 64 or not all(0 <= t < cfg.padded_vocab_size for t in o[len(p):]):
            fail("moe", f"generate: sample {i} did not get 64 tokens in the vocabulary")
    print("moe: generate " + json.dumps({
        "prompt_lens": [len(p) for p in prompts], "new_tokens": 64,
        "prefill_s": round(stats.prefill_s, 4), "decode_s": round(stats.decode_s, 4),
        "capture_s": round(stats.capture_s, 4), "tokens_per_s": round(stats.tokens_per_s, 2),
        "decode_tokens_per_s": round(stats.tokens_generated / (stats.decode_s - stats.capture_s), 2),
        "graph_captures": stats.captures, "k2_launches": k2_launches,
        "peak_memory_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3)})
        + f"; on {card}", flush=True)
    k2.setdefault("paths", {})["moe"] = k2_launches
    del gen, params, outs
    free()

    # K2 at the generate prefill's shape: Mixtral's 32 heads over 8 groups, hs 128
    err, (ms, plain_ms, lib_ms, b_ms, b_by) = flash_case_ms(4, 2048, 32, 8, 128)
    print(f"moe: K2 bfloat16 B=4 T=2048 H=32 G=8 hs=128 causal max_abs_err={err:.3e} "
          f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
          f"bound_ms={b_ms:.5f} ({b_by}); on {card}", flush=True)

    # (c) float32 parity at full width, 2 layers: K1 vs plain, K2 vs plain
    cfg2 = mixtral_config("moe", 2)
    params = transformer.init_params(cfg2, 10137, dtype=torch.float32, device=DEVICE)
    gen = Generator(cfg2, params, max_seq_length=2048, device=DEVICE)
    ptrace = cli.synthetic_trace(4, cfg2.vocab_size, 2048, 16)
    streams = {}
    for route, use_kernel in (("kernel", None), ("plain", False)):
        streams[route], _line, engine, _n = engine_serve(
            "moe", gen, ptrace, 2, observe=False, use_kernel=use_kernel)
        del engine
    divergence_ok("moe", gen, streams["kernel"], streams["plain"], "f32 K1 vs plain")
    gstreams = {}
    for route, flash_kernel in (("kernel", None), ("plain", False)):
        g = Generator(cfg2, params, max_seq_length=2048, device=DEVICE, use_flash=True,
                      flash_kernel=flash_kernel)
        flash_attention.launches = flash_attention_plain.calls = 0
        gstreams[route], _ = g.generate(long_prompts((1100, 1093), cfg2.vocab_size, seed=7),
                                        16, temperature=0.0)
        got = (flash_attention.launches, flash_attention_plain.calls)
        if got != ((2, 0) if route == "kernel" else (0, 2)):
            fail("moe", f"f32 generate, {route} route: K2 launches and plain calls {got}")
        del g
    divergence_ok("moe", gen, dict(enumerate(gstreams["kernel"])),
                  dict(enumerate(gstreams["plain"])), "f32 generate K2 vs plain")
    print(f"moe: float32, 2 layers x {cfg2.n_embd}: {len(ptrace)} greedy serve streams "
          f"through K1 and the plain route, 2 generate streams through K2 and its plain "
          f"version: equal", flush=True)
    del gen, params
    free()


def plain_moe_quantized_einsum(spec, x, p):
    """`plain_quantized_einsum` for every spec the MoE forward contracts:
    the linear specs as there; the expert specs as a float64 einsum with
    the dequantized weights (w8a8: with the same per-token int8
    activations, scaled as the route scales them)."""
    import torch

    from mdi_llm_tpu_torch.ops import quant

    if quant._is_linear(spec, next(v for k, v in p.items() if k != "scale")):
        return plain_quantized_einsum(spec, x, p)
    if "weight_q8" in p:
        xf = x.float()
        xs = torch.clamp(xf.abs().amax(dim=-1, keepdim=True)
                         / torch.full((), 127.0, device=x.device), min=1e-10)
        xq = torch.clamp(torch.round(xf / xs), -127, 127)
        y = torch.einsum(spec, xq.double(), p["weight_q8"].double()).float()
        extra = y.dim() - (x.dim() - 1)
        xs = xs.reshape(xs.shape[:-1] + (1,) * max(extra, 1))
        return quant._apply_scale(spec, y * xs, p["scale"]).to(x.dtype)
    if "weight_q4" in p:
        w = quant.unpack_w4(p["weight_q4"], p["scale"], torch.float64)
    else:
        w = p["weight_q"].double() * p["scale"].double()[..., None]
    return torch.einsum(spec, x.double(), w).to(x.dtype)


def phase_moe_quant(k1, k2, card):
    """Quantized Mixtral-8x7B (the module docstring, phase 20)."""
    from unittest import mock

    import torch

    from mdi_llm_tpu_torch.cli.serve import synthetic_trace
    from mdi_llm_tpu_torch.generation import Generator
    from mdi_llm_tpu_torch.models import transformer
    from mdi_llm_tpu_torch.obs.roofline import param_bytes
    from mdi_llm_tpu_torch.ops.flash import flash_attention, flash_attention_plain
    from mdi_llm_tpu_torch.ops.quant import (
        FLAG_TO_MODE,
        init_quantized_params,
        quantize_params,
    )

    # (a) all 32 layers, int8 weights: serve and generate, fewer new tokens
    cfg = mixtral_config("moe-quant", 32)
    free()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_quantized_params(cfg, seed=10137, mode="w8", dtype=torch.bfloat16, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = Generator(cfg, params, max_seq_length=2048, device=DEVICE)
    if not gen.quantized:
        fail("moe-quant", "the int8 tree is not seen as quantized")
    # the 4-layer modes' trace: 16 new tokens (64, then 32, before the cuts
    # of the whole run's time); the 32-layer serve's 8 requests (16 before
    # the layouts over processes)
    trace = synthetic_trace(16, cfg.vocab_size, 2048, 16)
    _res, line, engine, launches = engine_serve(
        "moe-quant", gen, synthetic_trace(8, cfg.vocab_size, 2048, MOE_QUANT_TOKENS), 32)
    dev = line["device"]
    utilization_ok("moe-quant", "serve int8", dev.get("mfu"), dev.get("mbu"))
    print("moe-quant: serve " + json.dumps({
        "model": MIXTRAL, "layers": 32, "quantize": "int8", "init_s": round(init_s, 2),
        "weight_bytes": param_bytes(params), **{k: line[k] for k in (
            "requests", "tokens_generated", "tokens_per_s", "wall_s", "decode_s", "prefill_s",
            "forward_calls", "graph_captures", "graph_replays", "capture_s")},
        "mfu": dev["mfu"], "mbu": dev["mbu"], "k1_launches": launches,
        "peak_memory_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3)})
        + f"; MBU counts the stored int8 bytes; on {card}", flush=True)
    k1_launches = launches
    del engine
    free()
    gen.generate([[1, 2, 3]] * 4, 4, temperature=0.0)  # warm-up, not counted
    prompts = long_prompts((1100, 1370, 1650, 1900), cfg.vocab_size)
    torch.cuda.synchronize()
    flash_attention.launches = flash_attention_plain.calls = 0
    outs, stats = gen.generate(prompts, MOE_QUANT_TOKENS, temperature=0.0, chunk_size=16)
    torch.cuda.synchronize()
    k2_launches, plain = flash_attention.launches, flash_attention_plain.calls
    if k2_launches != 32 or plain:
        fail("moe-quant", f"generate: K2 launches {k2_launches} (want 32), plain {plain}")
    for i, (p, o) in enumerate(zip(prompts, outs)):
        if len(o) - len(p) != MOE_QUANT_TOKENS or not all(
                0 <= t < cfg.padded_vocab_size for t in o[len(p):]):
            fail("moe-quant", f"generate: sample {i} did not get {MOE_QUANT_TOKENS} tokens "
                 "in the vocabulary")
    print("moe-quant: generate " + json.dumps({
        "layers": 32, "quantize": "int8", "new_tokens": MOE_QUANT_TOKENS,
        "prefill_s": round(stats.prefill_s, 4),
        "decode_s": round(stats.decode_s, 4), "capture_s": round(stats.capture_s, 4),
        "decode_tokens_per_s": round(stats.tokens_generated / (stats.decode_s - stats.capture_s), 2),
        "k2_launches": k2_launches,
        "peak_memory_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3)})
        + f"; on {card}", flush=True)
    del gen, params, outs
    free()

    # (b) 4 layers: a float32 forward of each mode against its float64 plain version
    cfg4 = mixtral_config("moe-quant", 4)
    params = transformer.init_params(cfg4, 10137, dtype=torch.float32, device=DEVICE)
    g = torch.Generator(device=DEVICE).manual_seed(5)
    toks = torch.randint(1, cfg4.vocab_size, (2, 64), generator=g, device=DEVICE)
    pos = torch.zeros(2, dtype=torch.long, device=DEVICE)
    with torch.no_grad():
        for mode in QUANT_MODES:
            qp = quantize_params(params, mode=FLAG_TO_MODE[mode])
            got = transformer.forward(cfg4, qp, toks, pos)
            with mock.patch.object(transformer, "quantized_einsum", plain_moe_quantized_einsum):
                ref = transformer.forward(cfg4, qp, toks, pos)
            err = (got - ref).abs().max().item()
            limit = TOL["float32"] * max(1.0, ref.abs().max().item())
            print(f"moe-quant: f32 forward, 4 layers at full width, {mode}: max |err| "
                  f"{err:.3e} <= {limit:.3e} against the float64 plain version", flush=True)
            if not err <= limit:
                fail("moe-quant", f"{mode}: f32 forward max |err| {err} > {limit}")
            del qp, got, ref
            free()
    del params
    free()

    # (c) 4 layers: the trace served once in each mode
    for mode in QUANT_MODES:
        torch.cuda.reset_peak_memory_stats()
        params = init_quantized_params(cfg4, seed=10137, mode=FLAG_TO_MODE[mode],
                                       dtype=torch.bfloat16, device=DEVICE)
        gen = Generator(cfg4, params, max_seq_length=2048, device=DEVICE)
        _res, line, engine, launches = engine_serve("moe-quant", gen, trace, 4, observe=False)
        print("moe-quant: serve " + json.dumps({
            "layers": 4, "quantize": mode, "weight_bytes": param_bytes(params),
            "tokens_per_s": line["tokens_per_s"], "forward_calls": line["forward_calls"],
            "k1_launches": launches,
            "peak_memory_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3)})
            + f"; on {card}", flush=True)
        k1_launches += launches
        del engine, gen, params
        free()
    k1.setdefault("paths", {})["moe-quant"] = k1_launches
    k2.setdefault("paths", {})["moe-quant"] = k2_launches


MOE_TRAIN = dict(batch_size=1, block_size=2048, grad_acc_steps=1, learning_rate=1e-3,
                 warmup_iters=0, lr_decay_iters=100, min_lr=1e-4, eval_iters=1,
                 dtype="bfloat16", remat=True, use_flash=True, moe_aux_weight=0.01)
MOE_TRAIN_LAYERS = 2  # Mixtral's layers in moe-train's steps
# moe-train's counted dense steps, the ep phase's baseline in the same run
MOE_TRAIN_DENSE = {}


def flash_bwd_case_ms(B, T, H, G, hs, card, phase="moe-train", causal=True, dlse=False):
    """K3 and K4 against their plain versions at one bf16 shape (causal or not;
    with `dlse`, a random cotangent of the LSE in D, as a ring's blocks
    take it) (held to `flash_bwd_bf16_limits`), then timed beside the
    plain versions and SDPA's backward; returns {"dq"/"dkv": (ms, plain
    ms, library ms, bound ms, bound by, max |err|)}."""
    import torch
    import torch.nn.functional as F

    from mdi_llm_tpu_torch.ops.flash import (
        flash_attention_lse,
        flash_dkv,
        flash_dkv_plain,
        flash_dq,
        flash_dq_plain,
    )

    dtype, scale = torch.bfloat16, hs ** -0.5
    q, k, v = flash_inputs(B, T, dtype, seed=5 * T + hs, H=H, G=G, hs=hs)
    out, lse = flash_attention_lse(q, k, v, causal=causal)
    g = torch.Generator(device=DEVICE).manual_seed(T + 1)
    do = torch.randn(q.shape, generator=g, device=DEVICE).to(dtype)
    dsum = (do.float() * out.float()).sum(-1)
    if dlse:
        dsum = dsum - torch.randn(lse.shape, generator=g, device=DEVICE)
    args = (q, k, v, do, lse, dsum, scale, causal)
    got = (flash_dq(*args),) + flash_dkv(*args)
    f32 = [x.float() for x in (q, k, v, do)]
    ref = (flash_dq_plain(*f32, lse, dsum, scale, causal),) + flash_dkv_plain(*f32, lse, dsum, scale,
                                                                            causal)
    del f32
    limits = flash_bwd_bf16_limits(q, k, v, do, lse, dsum, scale, causal, ref)
    errs = {}
    for which, a, r, lim in zip(("dq", "dk", "dv"), got, ref, limits):
        err, ratio = err_ratio(a, r, lim)
        if not ratio <= 1.0:
            fail(phase, f"K3/K4 bf16 B={B} T={T} H={H} G={G} hs={hs} {which}: "
                 f"max|err| {err}, {ratio:.3f} x its limit")
        errs["dq" if which == "dq" else "dkv"] = max(errs.get("dq" if which == "dq" else "dkv", 0.0), err)
    del got, ref, limits
    free()
    qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qq, kk, vv, is_causal=causal, enable_gqa=True)
    lib_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, (qq, kk, vv), do, retain_graph=True), 10)
    del lib_out, qq, kk, vv
    out_rows = {}
    for which, kern, plain in (("dq", flash_dq, flash_dq_plain), ("dkv", flash_dkv, flash_dkv_plain)):
        ms = cuda_ms(lambda: kern(*args), 10)
        plain_ms = cuda_ms(lambda: plain(*args), 2)
        b_ms, b_by = flash_bwd_bound(B, H, G, T, hs, dtype, causal, which)
        out_rows[which] = (ms, plain_ms, lib_ms, b_ms, b_by, errs[which])
        print(f"{phase}: {'K3' if which == 'dq' else 'K4'} bfloat16 B={B} T={T} H={H} G={G} "
              f"hs={hs} causal={causal} dlse={dlse} max_abs_err={errs[which]:.3e} ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} "
              f"library_ms={lib_ms:.4f} (SDPA backward, dQ+dK+dV) bound_ms={b_ms:.5f} ({b_by}); "
              f"on {card}", flush=True)
        free()
    return out_rows


def phase_moe_train(k3, k4, card):
    """Mixtral-8x7B training steps (the module docstring, phase 21)."""
    import math

    import numpy as np
    import torch

    from mdi_llm_tpu_torch.models import transformer
    from mdi_llm_tpu_torch.training import (
        Trainer,
        TrainingConfig,
        cross_entropy_loss,
        estimate_flops_per_token,
    )
    from mdi_llm_tpu_torch.utils import data_loader

    cfg = mixtral_config("moe-train", MOE_TRAIN_LAYERS)
    tc = TrainingConfig(**MOE_TRAIN)
    L, B, T = cfg.n_layer, tc.batch_size, tc.block_size
    n = cfg.estimate_params()
    # bf16 params, float32 accumulated gradients and two float32 moments
    print(f"moe-train: {n:.4e} parameters: reckoned {n * (2 + 4 + 8) / 1e9:.1f} GB of params, "
          f"gradients and moments before activations (plus bf16 autograd gradients, "
          f"{2 * n / 1e9:.1f} GB)", flush=True)
    free()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, tc, device=DEVICE)
    if not tr.use_flash or tr.moe_aux_weight != 0.01:
        fail("moe-train", f"use_flash {tr.use_flash}, moe_aux_weight {tr.moe_aux_weight}")
    data = synthetic_tokens(1 << 20, seed=11)
    rng = np.random.default_rng(12)
    tr.train_step(*(b[None] for b in data_loader.get_batch(data, B, T, rng)))  # warm-up
    want = {"K2": 2 * L, "K3": L, "K4": L, "plain": 0}
    steps, total = [], {"K3": 0, "K4": 0}
    for _ in range(3):
        x, y = data_loader.get_batch(data, B, T, rng)
        torch.cuda.synchronize()
        reset_flash_counts()
        t0 = time.perf_counter()
        loss = tr.train_step(x[None], y[None])
        dt = time.perf_counter() - t0
        got = flash_counts()
        if got != want:
            fail("moe-train", f"one optimizer step launched {got}; want {want}")
        total["K3"] += got["K3"]
        total["K4"] += got["K4"]
        with torch.no_grad():
            xt, yt = (torch.as_tensor(a, device=DEVICE).long() for a in (x, y))
            _logits, aux = transformer.forward(cfg, tr.params, xt, torch.zeros(
                B, dtype=torch.long, device=DEVICE), use_flash=True, collect_moe_aux=True)
        if not (math.isfinite(loss) and math.isfinite(aux.item())):
            fail("moe-train", f"step loss {loss}, aux {aux.item()}")
        steps.append((dt, loss, aux.item() / L))
        del _logits
    peak = torch.cuda.max_memory_allocated() / 2**30
    dt = float(np.median([d for d, _l, _a in steps]))
    MOE_TRAIN_DENSE.update({
        "step_s": [round(d, 4) for d, _l, _a in steps], "step_s_median": dt,
        "step_losses": [round(lo, 4) for _d, lo, _a in steps], "layer_runs_per_step": L,
        "launches_per_step": want, "peak_memory_gib": peak, "measured_in": "moe-train"})
    print("moe-train: " + json.dumps({
        "model": MIXTRAL, "layers": L, "batch": B, "block": T, "dtype": tc.dtype,
        "remat": tc.remat, "use_flash": tr.use_flash, "moe_aux_weight": tc.moe_aux_weight,
        "step_s": [round(d, 4) for d, _l, _a in steps], "step_s_median": round(dt, 4),
        "tokens_per_s": round(B * T / dt, 1),
        "tflops": round(estimate_flops_per_token(cfg, T) * B * T / dt / 1e12, 2),
        "step_losses": [round(lo, 4) for _d, lo, _a in steps],
        "aux_layer_mean": [round(a, 5) for _d, _l, a in steps],
        "peak_memory_gib": round(peak, 3), "launches_per_step": want})
        + f"; TFLOP/s counts the dense formulation's 8 experts; on {card}", flush=True)
    k3.setdefault("paths", {})["moe-train"] = total["K3"]
    k4.setdefault("paths", {})["moe-train"] = total["K4"]
    del tr
    free()

    # K3 and K4 at this phase's attention shape
    flash_bwd_case_ms(B, T, 32, 8, 128, card)

    # float32, 1 layer: losses and the first gradient through K2-K4 and their plain versions
    cfg1 = mixtral_config("moe-train", 1)
    tc1 = TrainingConfig(**{**MOE_TRAIN, "dtype": "float32"})
    params = transformer.init_params(cfg1, 10137, dtype=torch.float32, device=DEVICE)
    batches = [data_loader.get_batch(data, B, T, np.random.default_rng(13)) for _ in range(2)]
    grads, losses = {}, {}
    for route, flash_kernel in (("kernel", None), ("plain", False)):
        tr = Trainer(cfg1, tc1, params=params, device=DEVICE, flash_kernel=flash_kernel)
        reset_flash_counts()
        x, y = (torch.as_tensor(b, device=DEVICE).long() for b in batches[0])
        loss = cross_entropy_loss(cfg1, tr.params, x, y, remat=True, use_flash=True,
                                  flash_kernel=flash_kernel, moe_aux_weight=0.01)
        grads[route] = torch.autograd.grad(loss, transformer.tree_leaves(tr.params))
        losses[route] = [tr.train_step(bx[None], by[None]) for bx, by in batches]
        got = flash_counts()
        want = ({"K2": 6, "K3": 3, "K4": 3, "plain": 0} if route == "kernel"
                else {"K2": 0, "K3": 0, "K4": 0, "plain": 12})
        if got != want:
            fail("moe-train", f"f32 parity, the {route} run launched {got}; want {want}")
        del tr
        free()
    size = max(g.abs().max().item() for g in grads["plain"])
    err = max((a - b).abs().max().item() for a, b in zip(grads["kernel"], grads["plain"]))
    lk, lp = losses["kernel"], losses["plain"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    print(f"moe-train: float32, 1 layer x {cfg1.n_embd}, B={B} T={T}, aux weight 0.01: "
          f"first-step grads max|err| {err:.3e} (largest {size:.3e}), losses "
          f"{[round(v, 6) for v in lk]} vs {[round(v, 6) for v in lp]} (rel {rel:.2e}) through "
          "K2-K4 and their plain versions", flush=True)
    if not err <= 1e-4 * size or not rel <= 1e-5:
        fail("moe-train", f"grads max|err| {err} (largest {size}), losses {lk} vs {lp}")
    del grads, params
    free()


EP_SIZES = (2, 4)
EP_TOKENS = 8  # new tokens of the ep phase's bf16 generates (32, then 16, before the run's cuts)
EP_F32_TOKENS = 8  # and of its float32 ones (16 before the layouts over processes)
EP_CF = 1.25  # the finite capacity factor of the ep Trainer's second runs
# ep beside tp and dp in one process (every position on the card)
EP_TP_MESHES = {"ep 2 x tp 2": {"ep": 2, "tp": 2},
                "dp 2 x ep 2 x tp 2": {"dp": 2, "ep": 2, "tp": 2}}
EP_TP_CF = 0.5  # the capacity factor at which dp x ep must route the whole batch


def ep_generate(phase, label, gen, prompts, n_new, card) -> dict:
    """`gen.generate` over `prompts`, K2 counted, after a warm-up call on
    the same shapes (which captures the decode chunks the counted call
    replays): K2 exactly once per layer, tp rank and dp replica (attention
    runs once on the card whatever the ep ranks; beside tp and dp, over
    each replica's tp ranks), the plain version never.  Returns the run's
    numbers."""
    import torch

    # decode chunks of 8: each captured chunk holds half the launches of
    # one of 16 (the capture's seconds grow with the ep ranks' launches)
    _outs, warm = gen.generate(prompts, n_new, temperature=0.0, chunk_size=8)
    torch.cuda.synchronize()
    reset_flash_counts()
    outs, stats = gen.generate(prompts, n_new, temperature=0.0, chunk_size=8)
    torch.cuda.synchronize()
    got = flash_counts()
    k2 = gen.cfg.n_layer * gen.tp * gen.dp
    if (got["K2"], got["plain"]) != (k2, 0):
        fail(phase, f"{label}: generate launched {got}; want K2 {k2}, plain 0")
    for i, (p, o) in enumerate(zip(prompts, outs)):
        if len(o) - len(p) != n_new or not all(0 <= t < gen.cfg.padded_vocab_size
                                               for t in o[len(p):]):
            fail(phase, f"{label}: sample {i} did not get {n_new} tokens in the vocabulary")
    return {"outs": dict(enumerate(outs)), "prefill_s": stats.prefill_s,
            "decode_tokens_per_s": stats.tokens_generated / (stats.decode_s - stats.capture_s),
            "captures": (warm.captures, stats.captures), "capture_s": warm.capture_s,
            "decode": "graphs" if gen._graphs else "eager", "k2_launches": got["K2"]}


def grad_limit(n_terms: int) -> float:
    """The float32 limit on two gradients of one loss computed in other
    summation orders, relative to the leaf's largest entry: each entry is
    a sum over `n_terms` per-token contributions, and recursive summation
    errs by at most n u of the sum of their magnitudes (u = 2^-24); that
    sum is taken to be at most the leaf's largest entry times 1 (a wrong
    gradient differs at O(1) of it)."""
    return n_terms * 2.0 ** -24


def phase_ep(k2, k3, k4, card):
    """Expert parallelism on the card (the module docstring, phase 35)."""
    from functools import partial

    import numpy as np
    import torch

    from mdi_llm_tpu_torch.generation import Generator
    from mdi_llm_tpu_torch.models import transformer
    from mdi_llm_tpu_torch.ops.quant import quantize_params
    from mdi_llm_tpu_torch.parallel.expert import ep_moe_forward
    from mdi_llm_tpu_torch.parallel.mesh import make_mesh
    from mdi_llm_tpu_torch.training import Trainer, TrainingConfig, cross_entropy_loss
    from mdi_llm_tpu_torch.utils import data_loader

    t_phase = time.perf_counter()

    def part(name):
        print(f"ep: {name} done at {time.perf_counter() - t_phase:.1f} s", flush=True)

    # (a) `MOE_LAYERS` bf16 layers: the dense Generator, the --ep-devices 2 and 4 ones,
    # and ep beside tp and dp
    cfg = mixtral_config("ep", MOE_LAYERS)
    free()
    params = transformer.init_params(cfg, 10137, dtype=torch.bfloat16, device=DEVICE)
    prompts = long_prompts((1100, 1370, 1650, 1900), cfg.vocab_size)
    runs, k2_total, k2_tp = {}, 0, 0
    meshes = {"dense": None, **{f"ep {ep}": {"ep": ep} for ep in EP_SIZES}, **EP_TP_MESHES}
    for label, axes in meshes.items():
        mesh = None if axes is None else make_mesh(axes, [DEVICE])
        gen = Generator(cfg, params, max_seq_length=2048, device=DEVICE, mesh=mesh)
        if (axes is None) != (gen._moe_impl is None):
            fail("ep", f"{label}: the token dispatch is {'on' if gen._moe_impl else 'off'}")
        torch.cuda.reset_peak_memory_stats()
        runs[label] = ep_generate("ep", label, gen, prompts, EP_TOKENS, card)
        runs[label]["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        if label in EP_TP_MESHES:
            k2_tp += runs[label]["k2_launches"]
        elif axes is not None:
            k2_total += runs[label]["k2_launches"]
        del gen
        free()
    base = runs["dense"]
    for label, r in runs.items():
        n_div = 0 if label == "dense" else sum(
            r["outs"][i] != base["outs"][i] for i in base["outs"])
        print("ep: generate " + json.dumps({
            "card": card, "model": MIXTRAL, "layers": MOE_LAYERS, "dtype": "bfloat16",
            "route": label, "mesh": meshes[label], "capacity_factor": None,
            "prompt_lens": [len(p) for p in prompts],
            "new_tokens": EP_TOKENS, "prefill_s": r["prefill_s"],
            "prefill_over_dense": r["prefill_s"] / base["prefill_s"],
            "decode_tokens_per_s": r["decode_tokens_per_s"],
            "decode_over_dense": r["decode_tokens_per_s"] / base["decode_tokens_per_s"],
            "decode": r["decode"], "captures_warm_counted": r["captures"],
            "capture_s": r["capture_s"],
            "k2_launches": r["k2_launches"], "bf16_streams_differing": n_div,
            "peak_memory_gib": r["peak_memory_gib"]}), flush=True)
    del params, runs
    free()
    part("(a) bf16 generates")

    # (b) float32, 4 layers: the fp tree and its int8 tree, ep 2 and 4 and
    # ep 2 x tp 2 against dense; dp 2 x ep 2 at EP_TP_CF against ep 2 there
    cfg4 = mixtral_config("ep", 4)
    params = transformer.init_params(cfg4, 10137, dtype=torch.float32, device=DEVICE)
    fprompts = long_prompts((300, 293), cfg4.vocab_size, seed=7)
    f32_meshes = {**{f"ep {ep}": {"ep": ep} for ep in EP_SIZES},
                  "ep 2 x tp 2": EP_TP_MESHES["ep 2 x tp 2"]}
    for tree_label in ("fp", "int8"):
        tree = params if tree_label == "fp" else quantize_params(params, mode="w8")
        # eager decode: these runs hold the streams, not the graphs
        dense = Generator(cfg4, tree, max_seq_length=2048, device=DEVICE, _graphs=False)
        want, _ = dense.generate(fprompts, EP_F32_TOKENS, temperature=0.0)
        want = dict(enumerate(want))
        for label, axes in f32_meshes.items():
            gen = Generator(cfg4, tree, max_seq_length=2048, device=DEVICE, _graphs=False,
                            mesh=make_mesh(axes, [DEVICE]))
            got, _ = gen.generate(fprompts, EP_F32_TOKENS, temperature=0.0)
            got = dict(enumerate(got))
            divergence_ok("ep", dense, got, want, f"float32 {tree_label} {label}")
            print(f"ep: float32 {tree_label}, 4 layers at full width: {label} gives "
                  f"{sum(got[i] == want[i] for i in want)} of {len(want)} greedy streams "
                  "identical to the dense Generator's", flush=True)
            del gen
            free()
        if tree_label == "fp":
            # the whole batch's routing: dp 2 x ep 2 drops the assignments ep 2 drops
            cf_runs = {}
            for label, axes in (("ep 2", {"ep": 2}), ("dp 2 x ep 2", {"dp": 2, "ep": 2})):
                gen = Generator(cfg4, tree, max_seq_length=2048, device=DEVICE, _graphs=False,
                                mesh=make_mesh(axes, [DEVICE]), moe_capacity_factor=EP_TP_CF)
                cf_runs[label] = dict(enumerate(gen.generate(fprompts, EP_F32_TOKENS,
                                                             temperature=0.0)[0]))
                del gen
                free()
            divergence_ok("ep", dense, cf_runs["dp 2 x ep 2"], cf_runs["ep 2"],
                          f"float32 dp 2 x ep 2 against ep 2 at capacity factor {EP_TP_CF}")
            same = sum(cf_runs["dp 2 x ep 2"][i] == cf_runs["ep 2"][i] for i in want)
            moved = sum(cf_runs["ep 2"][i] != want[i] for i in want)
            print(f"ep: float32 fp, 4 layers, capacity factor {EP_TP_CF}: dp 2 x ep 2 gives "
                  f"{same} of {len(want)} greedy streams identical to ep 2's at that factor; "
                  f"the drops move {moved} of {len(want)} streams off the dense ones",
                  flush=True)
        del dense, tree
        free()
    del params
    free()
    part("(b) float32 streams")

    # (c) the Trainer at moe-train's shape: dense, then ep 2 and 4 at
    # capacity None and EP_CF
    cfg2 = mixtral_config("ep", 2)
    tc = TrainingConfig(**MOE_TRAIN)
    L, B, T = cfg2.n_layer, tc.batch_size, tc.block_size
    data = synthetic_tokens(1 << 20, seed=11)
    rng = np.random.default_rng(12)
    fixed = [data_loader.get_batch(data, B, T, rng) for _ in range(4)]
    want = {"K2": 2 * L, "K3": L, "K4": L, "plain": 0}
    # the dense baseline: moe-train's steps (the same shape, batches and
    # seed) when that phase ran in this call
    results = {"dense": dict(MOE_TRAIN_DENSE)} if MOE_TRAIN_DENSE else {}
    totals = {"K2": 0, "K3": 0, "K4": 0}
    tp_totals = {"K2": 0, "K3": 0, "K4": 0}
    dense_run = () if results else (("dense", None, None),)
    train_runs = dense_run + tuple((f"ep {e} cf {c}", {"ep": e}, c)
                                   for e in EP_SIZES for c in (None, EP_CF)) + (
        ("ep 2 x tp 2 cf None", EP_TP_MESHES["ep 2 x tp 2"], None),)
    for label, axes, cf in train_runs:
        # per step: the layers once over the batch, per tp rank (remat: K2 twice)
        ranks = 1 if axes is None else axes.get("tp", 1)
        want = {"K2": 2 * L * ranks, "K3": L * ranks, "K4": L * ranks, "plain": 0}
        free()
        torch.cuda.reset_peak_memory_stats()
        tr = Trainer(cfg2, TrainingConfig(**{**MOE_TRAIN, "moe_capacity_factor": cf}),
                     mesh=None if axes is None else make_mesh(axes, [DEVICE]),
                     device=DEVICE)
        tr.train_step(fixed[0][0][None], fixed[0][1][None])  # warm-up, not counted
        steps = []
        for x, y in fixed[1:]:
            torch.cuda.synchronize()
            reset_flash_counts()
            runs0 = tr.layer_runs
            t0 = time.perf_counter()
            loss = tr.train_step(x[None], y[None])
            dt = time.perf_counter() - t0
            got = flash_counts()
            if got != want or (axes is not None and tr.layer_runs - runs0 != L * ranks):
                fail("ep", f"{label}: one optimizer step launched {got} over "
                     f"{tr.layer_runs - runs0} layer runs; want {want}")
            if not np.isfinite(loss):
                fail("ep", f"{label}: step loss {loss}")
            if axes is not None:
                for kk in totals:
                    (tp_totals if ranks > 1 else totals)[kk] += got[kk]
            steps.append((dt, loss))
        results[label] = {
            "step_s": [round(d, 4) for d, _ in steps],
            "step_s_median": float(np.median([d for d, _ in steps])),
            "step_losses": [round(lo, 4) for _, lo in steps],
            "layer_runs_per_step": L * ranks, "launches_per_step": want,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30, "measured_in": "ep"}
        del tr
    free()
    for r in results.values():
        r["over_dense"] = r["step_s_median"] / results["dense"]["step_s_median"]
    print("ep: train " + json.dumps({
        "card": card, "model": MIXTRAL, "layers": L, "batch": B, "block": T,
        "dtype": tc.dtype, "remat": tc.remat, "use_flash": True, "runs": results}), flush=True)
    k2.setdefault("paths", {})["ep"] = k2_total + totals["K2"]
    k3.setdefault("paths", {})["ep"] = totals["K3"]
    k4.setdefault("paths", {})["ep"] = totals["K4"]
    k2.setdefault("paths", {})["ep-tp"] = k2_tp + tp_totals["K2"]
    k3.setdefault("paths", {})["ep-tp"] = tp_totals["K3"]
    k4.setdefault("paths", {})["ep-tp"] = tp_totals["K4"]
    part("(c) Trainer steps")

    # (d) float32, 2 layers, capacity None: the first step's gradients of
    # the ep Trainer's loss against the dense formulation's
    params = transformer.init_params(cfg2, 10137, dtype=torch.float32, device=DEVICE)
    transformer.tree_map(lambda a: a.requires_grad_(True), params)
    leaves = transformer.tree_leaves(params)
    x, y = (torch.as_tensor(a, device=DEVICE).long() for a in fixed[1])

    def grads(impl):
        loss = cross_entropy_loss(cfg2, params, x, y, remat=True, use_flash=True,
                                  moe_aux_weight=MOE_TRAIN["moe_aux_weight"], moe_impl=impl)
        return loss.item(), torch.autograd.grad(loss, leaves)

    want_loss, want_g = grads(None)
    limit = grad_limit(B * T)
    for ep in EP_SIZES:
        loss, got_g = grads(partial(ep_moe_forward, mesh=make_mesh({"ep": ep}, [DEVICE])))
        diff = grad_diff(got_g, want_g)
        del got_g
        free()
        rel = abs(loss - want_loss) / abs(want_loss)
        print(f"ep: float32, 2 layers x {cfg2.n_embd}, B={B} T={T}, ep {ep}, capacity None, "
              f"aux weight {MOE_TRAIN['moe_aux_weight']}: loss {loss:.7f} vs dense "
              f"{want_loss:.7f} (rel {rel:.2e}); first-step gradients {diff}, limit "
              f"{limit:.3e} of the leaf's largest (B*T float32 roundings)", flush=True)
        if not (diff["max_rel_to_leaf_max"] <= limit and rel <= 1e-5):
            fail("ep", f"ep {ep}: gradients {diff} (limit {limit}), loss rel {rel}")
    # the ep 2 x tp 2 Trainer's loss (its own copy of the tree; no step is
    # taken, so its AdamW moments go): attention over each dp row's tp
    # ranks, one dispatch a layer over the whole batch
    tr = Trainer(cfg2, TrainingConfig(**{**MOE_TRAIN, "dtype": "float32"}), params=params,
                 mesh=make_mesh(EP_TP_MESHES["ep 2 x tp 2"], [DEVICE]), device=DEVICE)
    tr.optimizer.mu = tr.optimizer.nu = None
    del params, leaves
    free()
    reset_flash_counts()
    loss_t = tr._loss(x, y, remat=True)
    got_g = torch.autograd.grad(loss_t, transformer.tree_leaves(tr.params))
    got = flash_counts()
    if got != {"K2": 2 * L * 2, "K3": L * 2, "K4": L * 2, "plain": 0}:
        fail("ep", f"ep 2 x tp 2 float32 gradient launched {got}")
    diff = grad_diff(got_g, want_g)
    rel = abs(loss_t.item() - want_loss) / abs(want_loss)
    print(f"ep: float32, 2 layers x {cfg2.n_embd}, B={B} T={T}, ep 2 x tp 2 Trainer, capacity "
          f"None, aux weight {MOE_TRAIN['moe_aux_weight']}: loss {loss_t.item():.7f} vs dense "
          f"{want_loss:.7f} (rel {rel:.2e}); first-step gradients {diff}, limit {limit:.3e} "
          "of the leaf's largest (B*T float32 roundings)", flush=True)
    if not (diff["max_rel_to_leaf_max"] <= limit and rel <= 1e-5):
        fail("ep", f"ep 2 x tp 2: gradients {diff} (limit {limit}), loss rel {rel}")
    del tr, got_g, want_g, loss_t
    free()
    part("(d) float32 gradients")

    # (e) K2-K4 at a tp 2 rank's geometry of Mixtral (16 heads, 4 groups, hs 128)
    err, (ms, plain_ms, lib_ms, b_ms, b_by) = flash_case_ms(B, T, 16, 4, 128)
    print(f"ep: K2 bfloat16 B={B} T={T} H=16 G=4 hs=128 causal=True max_abs_err={err:.3e} "
          f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} (SDPA) "
          f"bound_ms={b_ms:.5f} ({b_by}); on {card}", flush=True)
    flash_bwd_case_ms(B, T, 16, 4, 128, card, phase="ep")
    part("(e) kernel rows")


TUNE_GEOMETRIES = {"tiny-llama-1.1b": (32, 4, 64), MIXTRAL: (32, 8, 128)}
TUNE_MIXTRAL_LAYERS = 2  # the whole-trace serves (16, then 8, then 4, before the cuts for the
# whole run's time)
# the serve and moe phases' trace and engine, as the tuning CLI's flags
TUNE_SERVE = ["--synthetic", "16", "--n-tokens", "64", "--sequence-length", "2048",
              "--max-batch", "8", "--block-size", "16", "--dtype", "bfloat16", "--seed", "10137"]


def phase_tune(k1, card):
    """K1's tuning tables (the module docstring, phase 22)."""
    import os

    import torch

    from mdi_llm_tpu_torch.cli.serve import synthetic_trace
    from mdi_llm_tpu_torch.config import Config
    from mdi_llm_tpu_torch.generation import Generator
    from mdi_llm_tpu_torch.models import transformer
    from mdi_llm_tpu_torch.ops import ragged_paged_attention as rpa
    from mdi_llm_tpu_torch.ops import tuning
    from mdi_llm_tpu_torch.utils.profiling import CompileGuard, RecompileError

    dev_name = torch.cuda.get_device_name(0)
    winners, env = {}, os.environ.pop(tuning.TUNE_TABLE_ENV, None)
    tables_dir = tempfile.TemporaryDirectory()
    for model in TUNE_GEOMETRIES:
        # (a) the serve trace's steps recorded on a one-layer stand-in, every
        # candidate timed over them, each step weighted by its count
        t0 = time.perf_counter()
        out = str(Path(tables_dir.name) / f"{model}.json")
        res = tuning.main(TUNE_SERVE + ["--model", model, "--out", out, "--device", DEVICE])
        best, results, key = res["winner"], res["results"], res["key"]
        committed, meta = tuning.resolve_kernel_params(
            *TUNE_GEOMETRIES[model], 16, torch.bfloat16, torch.bfloat16, device_kind=dev_name)
        rows = {tuple(r["params"].values()): r for r in results}
        default = rows[tuple(tuning.DEFAULT_PARAMS.to_dict().values())]
        comm = rows[tuple(committed.to_dict().values())]
        print(f"tune: {model} ({key}) over the serve trace's {res['steps']} steps "
              f"({len(res['cases'])} distinct): winner {best.to_dict()} "
              f"{json.dumps({k: round(v, 5) for k, v in rows[tuple(best.to_dict().values())]['ms'].items()})}"
              f" ms against the default's "
              f"{json.dumps({k: round(v, 5) for k, v in default['ms'].items()})}; committed "
              f"entry ({meta['table_source']}) {committed.to_dict()} total "
              f"{comm['total_ms']:.5f} ms; {len(results)} candidates in "
              f"{time.perf_counter() - t0:.1f} s; on {card}", flush=True)
        winners[model] = (best, results, res["steps"])
        free()

    # (b) the trace served whole with the default and the winning split, in
    # the order default, winner, winner, default, each on a fresh engine
    for model, n_layer in ((TINY_LLAMA, 22), (MIXTRAL, TUNE_MIXTRAL_LAYERS)):
        best, _results, n_steps = winners[model]
        if best == tuning.DEFAULT_PARAMS:
            print(f"tune: {model}: the winner is the default split; no serve to compare",
                  flush=True)
            continue
        cfg = Config.from_name(model, n_layer=n_layer)
        gen = Generator(cfg, transformer.init_params(cfg, 10137, dtype=torch.bfloat16,
                                                     device=DEVICE),
                        max_seq_length=2048, device=DEVICE)
        trace = synthetic_trace(16, cfg.vocab_size, 2048, 64)
        key = tuning.geometry_key(dev_name, cfg.n_head, cfg.n_query_groups, cfg.head_size, 16,
                                  torch.bfloat16, torch.bfloat16)
        tables = {}
        for label, p in (("default", tuning.DEFAULT_PARAMS), ("winner", best)):
            tables[label] = str(Path(tables_dir.name) / f"{model}-{label}-serve.json")
            tuning.save_tuning_table(tables[label], dev_name, {key: p.to_dict()})
        rates, streams = {"default": [], "winner": []}, {}
        try:
            for label in ("default", "winner", "winner", "default"):
                os.environ[tuning.TUNE_TABLE_ENV] = tables[label]
                streams[label], line, engine, _n = engine_serve(
                    "tune", gen, trace, n_layer, observe=False)
                if engine.forward_calls != n_steps:
                    fail("tune", f"{model}: the serve took {engine.forward_calls} forwards, "
                         f"the recorded trace {n_steps} steps")
                rates[label].append(line["tokens_per_s"])
                del engine
                free()
        finally:
            os.environ.pop(tuning.TUNE_TABLE_ENV, None)
        same = sum(streams["winner"][r] == streams["default"][r] for r in streams["default"])
        print(f"tune: {model} bf16 {n_layer} layers, the serve trace served whole: default "
              f"{tuning.DEFAULT_PARAMS.to_dict()} {rates['default']} tokens/s, winner "
              f"{best.to_dict()} {rates['winner']} tokens/s (order default, winner, winner, "
              f"default); winner faster in both pairs: "
              f"{min(rates['winner']) > max(rates['default'])}; {same} of {len(trace)} bf16 "
              f"streams equal; on {card}", flush=True)
        del gen
        free()

    # K1 at Mixtral's geometry at the spot steps: the winner and the default
    # beside the plain version and SDPA
    H, G, hs = TUNE_GEOMETRIES[MIXTRAL]
    tuned = winners[MIXTRAL][0]
    for i, (label, (spans, T, _w)) in enumerate(tuning.SERVE_TRACE_CASES.items()):
        args, owned = tuning.make_case(spans, T, H, G, hs, 16, 128, torch.bfloat16, DEVICE, seed=i + 1)
        scale = hs ** -0.5
        ms = {name: cuda_ms(lambda p=p: rpa.ragged_paged_attention(*args, scale=scale, params=p), 50)
              for name, p in (("tuned", tuned), ("default", tuning.DEFAULT_PARAMS))}
        plain_ms = cuda_ms(lambda: rpa.ragged_paged_attention_plain(*args, scale=scale), 5)
        lib_ms = cuda_ms(library_call(args, scale), 20)
        b_ms, b_by = bound(args, owned)
        print(f"tune: K1 bfloat16 Mixtral {label} T={T} H={H} G={G} hs={hs} tuned_ms="
              f"{ms['tuned']:.4f} ({tuned.to_dict()}) default_ms={ms['default']:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={b_ms:.5f} ({b_by}); "
              f"on {card}", flush=True)
        del args
        free()

    # serve tiny-llama at float32 under a table holding a non-default winner
    best, results, _n = winners[TINY_LLAMA]
    H, G, hs = TUNE_GEOMETRIES[TINY_LLAMA]

    def mixed_chunk(p):
        return rpa.split_plan(H, G, 136, 8, 16, 128, hs, p)["chunk"]

    if best == tuning.DEFAULT_PARAMS:  # the fastest candidate with another mixed plan
        best = next(p for p in (tuning.KernelParams.from_dict(r["params"]) for r in
                                sorted(results, key=lambda r: r["total_ms"]))
                    if mixed_chunk(p) != mixed_chunk(tuning.DEFAULT_PARAMS))
    cfg = Config.from_name(TINY_LLAMA, n_layer=4)
    gen = Generator(cfg, transformer.init_params(cfg, 10137, dtype=torch.float32, device=DEVICE),
                    max_seq_length=2048, device=DEVICE)
    trace = synthetic_trace(16, gen.cfg.vocab_size, 2048, 64)
    streams = {}
    with tempfile.TemporaryDirectory() as tmp:
        table = str(Path(tmp) / "k1.json")
        fkey = tuning.geometry_key(dev_name, cfg.n_head, cfg.n_query_groups, cfg.head_size, 16,
                                   torch.float32, torch.float32)
        tuning.save_tuning_table(table, dev_name, {fkey: best.to_dict()})
        try:
            for label in ("default", "tuned"):
                if label == "tuned":
                    os.environ[tuning.TUNE_TABLE_ENV] = table
                q = torch.empty(1, cfg.n_head, 8, cfg.head_size, device=DEVICE)
                params = tuning.kernel_params_for(
                    q, torch.empty(1, 16, cfg.n_query_groups, cfg.head_size, device=DEVICE))
                if (params == best) != (label == "tuned"):
                    fail("tune", f"{label} serve resolves {params}")
                guard = CompileGuard(label=f"tune {label}")
                with guard:
                    engine = gen.serve(block_size=16, max_batch=8)
                    guard.mark_warm()
                    reset_k1_counts()
                    streams[label], stats = _serve_trace(engine, trace)
                    launches, plain = k1_counts()
                try:
                    guard.expect_clean()
                except RecompileError as e:
                    fail("tune", f"{label}: {e}")
                if launches != 4 * engine.forward_calls or launches <= 0 or plain:
                    fail("tune", f"{label}: K1 launches {launches} (want 4 x "
                         f"{engine.forward_calls}), plain route {plain}")
                print(f"tune: tiny-llama float32 4 layers, {label} K1 params {params.to_dict()}: "
                      f"{stats.tokens_generated} tokens, {stats.tokens_per_s:.2f} tokens/s, K1 "
                      f"{launches} launches, captures after warm-up "
                      f"{guard.captures_after_warmup}", flush=True)
                if label == "tuned":
                    k1.setdefault("paths", {})["tune"] = launches
                del engine
            # an invalid entry raises, at resolution and at a K1 call
            table = str(Path(tmp) / "bad.json")
            tuning.save_tuning_table(table, dev_name, {fkey: dict(best.to_dict(), min_chunk=48)})
            os.environ[tuning.TUNE_TABLE_ENV] = table
            args, _owned = tuning.make_case([(5, 1)], 1, cfg.n_head, cfg.n_query_groups,
                                            cfg.head_size, 16, 4, torch.float32, DEVICE)
            for what, call in (
                    ("resolution", lambda: tuning.resolve_kernel_params(
                        cfg.n_head, cfg.n_query_groups, cfg.head_size, 16, torch.float32,
                        torch.float32, device_kind=dev_name)),
                    ("K1 call", lambda: rpa.ragged_paged_attention(*args, scale=0.125))):
                try:
                    call()
                except ValueError as e:
                    if fkey not in str(e):
                        fail("tune", f"the invalid entry's error does not name it: {e}")
                    print(f"tune: an invalid entry raises at {what}: {str(e)[:160]}", flush=True)
                else:
                    fail("tune", f"an invalid entry (min_chunk 48) did not raise at {what}")
        finally:
            os.environ.pop(tuning.TUNE_TABLE_ENV, None)
            if env is not None:
                os.environ[tuning.TUNE_TABLE_ENV] = env
    divergence_ok("tune", gen, streams["tuned"], streams["default"], "tuned vs default K1")
    same = sum(streams["tuned"][r] == streams["default"][r] for r in streams["default"])
    print(f"tune: {same} of {len(trace)} greedy float32 streams identical under the tuned "
          f"table ({best.to_dict()}) and the defaults", flush=True)
    del gen
    tables_dir.cleanup()
    free()


PIPE_CONFIG = "examples/node_configs/standalone.json"
PIPE_RUNS = ((2, [10, 12]), (4, [4, 6, 6, 6]))  # stages, the reference table's split of 22
PIPE_M = 2  # samples per ring slot: 2 * S samples fill the ring
PIPE_TOKENS = 8  # new tokens of the rings' bf16 runs (64 before the doctor phase's cuts, 32
# before the analysis phase's and the serve preflights', 16 before the layouts over processes)
PIPE_F32_LAYERS = 4


def all_kernel_counts() -> dict:
    """Launches of K1-K4 and calls of every plain version or plain route."""
    from mdi_llm_tpu_torch.ops import flash
    from mdi_llm_tpu_torch.ops import paged_attention as pa
    from mdi_llm_tpu_torch.ops.ragged_paged_attention import ragged_paged_attention as k1

    return {"K1": k1.launches, "K2": flash.flash_attention.launches,
            "K3": flash.flash_dq.launches, "K4": flash.flash_dkv.launches,
            "plain": pa._paged_prefill_plain.calls + pa._paged_attention_plain.calls
            + flash.flash_attention_plain.calls + flash.flash_dq_plain.calls
            + flash.flash_dkv_plain.calls}


def ring_budget_ok(phase, label, outs, prompts, n_new, vocab) -> None:
    for i, (p, o) in enumerate(zip(prompts, outs)):
        new = o[len(p):]
        if len(new) != n_new or not all(0 <= t < vocab for t in new):
            fail(phase, f"{label}: sample {i} did not get {n_new} tokens in the vocabulary")


def hop_bytes(M, D, itemsize) -> int:
    """One payload hop: the activations (M, 1, D) and 1 + 2M int64s."""
    return M * D * itemsize + 8 * (1 + 2 * M)


def phase_pipeline(card):
    """The recurrent pipeline in one process on the card (the module
    docstring, phase 23)."""
    import contextlib
    import io

    import torch

    from mdi_llm_tpu_torch.cli import starter as starter_cli
    from mdi_llm_tpu_torch.config import Config
    from mdi_llm_tpu_torch.generation import Generator
    from mdi_llm_tpu_torch.models import transformer
    from mdi_llm_tpu_torch.parallel.nodes import parse_nodes_config
    from mdi_llm_tpu_torch.parallel.pipeline import PipelineEngine

    root = Path(__file__).resolve().parent
    nodes = parse_nodes_config(root / PIPE_CONFIG)
    gen = None
    for S, split in PIPE_RUNS:
        n = S * PIPE_M
        args = starter_cli.build_parser().parse_args(
            ["--model", TINY_LLAMA, "--dtype", "bfloat16", "--seed", "10137", "--greedy",
             "--n-samples", str(n), "--n-tokens", str(PIPE_TOKENS), "--sequence-length",
             "2048", "--pipeline-stages", str(S), "--samples-per-slot", str(PIPE_M),
             "--nodes-config", str(root / PIPE_CONFIG)])
        before = all_kernel_counts()
        torch.cuda.reset_peak_memory_stats()
        with contextlib.redirect_stdout(io.StringIO()):
            outs, stats, seconds, eng = starter_cli.run_node(args, nodes, 0)
        cfg = eng.cfg
        prompts = [o[:8] for o in outs]
        ring_budget_ok("pipeline", f"S={S}", outs, prompts, PIPE_TOKENS, cfg.padded_vocab_size)
        if eng.counts != split or cfg.n_layer != 22:
            fail("pipeline", f"S={S}: stage split {eng.counts}, want {split} of 22 layers")
        # the second call replays the captured chunks: no capture inside
        outs2, st2 = eng.generate(prompts, PIPE_TOKENS, temperature=0.0)
        torch.cuda.synchronize()
        graphs = eng.graph_stats()
        if outs2 != outs or st2.captures or not graphs["replays"]:
            fail("pipeline", f"S={S}: second call streams equal {outs2 == outs}, captures "
                 f"{st2.captures}, replays {graphs['replays']}")
        ring_peak = torch.cuda.max_memory_allocated() / 2**30
        if all_kernel_counts() != before:
            fail("pipeline", f"S={S}: the ring launched a kernel: {before} -> "
                 f"{all_kernel_counts()}")
        del eng
        free()
        if gen is None:
            params = transformer.init_params(cfg, 10137, dtype=torch.bfloat16, device="cuda")
            gen = Generator(cfg, params, max_seq_length=2048, device="cuda")
        gen.generate(prompts, PIPE_TOKENS, temperature=0.0)  # capture outside the timing
        want, gst = gen.generate(prompts, PIPE_TOKENS, temperature=0.0)
        torch.cuda.synchronize()
        got_d = {i: o for i, o in enumerate(outs)}
        want_d = {i: w for i, w in enumerate(want)}
        # printed, not gated: the ring multiplies M = 2 rows where generate
        # multiplies S·M, so every product rounds in another order and the
        # bf16 histories part at the first near-tie (stream parity is held
        # in float32 below, as in the tier and moe phases)
        n_div = bf16_divergences("pipeline", gen, got_d, want_d, f"S={S} ring vs generate")
        print("pipeline: " + json.dumps({
            "card": card, "S": S, "split": split, "M": PIPE_M, "samples": n,
            "new_tokens": PIPE_TOKENS, "dtype": "bfloat16",
            "ring_tokens_per_s": st2.tokens_per_s, "ring_decode_s": st2.decode_s,
            "ring_prefill_s": st2.prefill_s, "ring_first_call_tokens_per_s": stats.tokens_per_s,
            "rotations": st2.rotations, "graph_captures": graphs["captures"],
            "graph_replays": graphs["replays"], "capture_s": graphs["capture_s"],
            "bytes_per_hop": hop_bytes(PIPE_M, cfg.n_embd, 2),
            "generate_batch": n, "generate_tokens_per_s": gst.tokens_per_s,
            "generate_decode_s": gst.decode_s, "generate_prefill_s": gst.prefill_s,
            "ring_over_generate": st2.tokens_per_s / gst.tokens_per_s,
            "bf16_streams_diverging": n_div, "ring_peak_memory_gib": ring_peak,
            "kernel_launches": 0}), flush=True)
    del gen
    free()

    # float32 at 4 layers: the ring's streams are generate's; the eager
    # ring's are the graph ring's; a lane past the cache is clamped
    cfg = Config.from_name(TINY_LLAMA, n_layer=PIPE_F32_LAYERS)
    params = transformer.init_params(cfg, 10137, dtype=torch.float32, device="cuda")
    gen = Generator(cfg, params, max_seq_length=2048, device="cuda")
    for S, _split in PIPE_RUNS:
        prompts = long_prompts([8 + 3 * i for i in range(S * PIPE_M)], cfg.vocab_size, seed=S)
        want, _ = gen.generate(prompts, 32, temperature=0.0)
        routes = {}
        for graphs in (True, False):
            eng = PipelineEngine(cfg, params, n_stages=S, samples_per_slot=PIPE_M,
                                 max_seq_length=2048, device="cuda", _graphs=graphs)
            routes[graphs], st = eng.generate(prompts, 32, temperature=0.0)
            if graphs and not eng.graph_stats()["replays"]:
                fail("pipeline", f"float32 S={S}: the graph route replayed nothing")
        divergence_ok("pipeline", gen, dict(enumerate(routes[True])), dict(enumerate(want)),
                      f"float32 S={S} ring vs generate")
        if routes[True] != routes[False]:
            fail("pipeline", f"float32 S={S}: the graph ring's streams differ from the eager ring's")
        print(f"pipeline: float32 {PIPE_F32_LAYERS} layers S={S}: {len(prompts)} streams of 32 "
              f"tokens, graph ring = eager ring, ring vs generate: "
              f"{sum(a == b for a, b in zip(routes[True], want))}/{len(want)} identical",
              flush=True)
    prompt, new = [[5, 9, 2]], 61
    short = Generator(cfg, params, max_seq_length=64, device="cuda")
    want, _ = short.generate(prompt, new, temperature=0.0)
    eng = PipelineEngine(cfg, params, n_stages=2, max_seq_length=64, overlap_chunks=True,
                         device="cuda")
    got, st = eng.generate(prompt, new, temperature=0.0)
    torch.cuda.synchronize()
    divergence_ok("pipeline", short, {0: got[0]}, {0: want[0]}, "bubble lane past the cache")
    print(f"pipeline: overlapped chunks run a finished lane past the 64-slot cache "
          f"({len(got[0])} tokens, {st.rotations} rotations): clamped, streams as generate's",
          flush=True)
    del gen, short, eng, params
    free()


# one node's process of a job per argv, the runs in turn in one interpreter
# (`cli.starter` or `cli.secondary` main); after each run a marker line on
# stdout and on stderr, the latter with the run's seconds
NODE_END = "NODE-RUN-END "
NODE_ENTRY = (
    "import json, sys, time\n"
    "from mdi_llm_tpu_torch.cli import secondary, starter\n"
    "job = json.loads(sys.argv[1])\n"
    "cli = starter if job['role'] == 'starter' else secondary\n"
    "for argv in job['runs']:\n"
    "    t0 = time.perf_counter()\n"
    "    cli.main(argv)\n"
    f"    print({NODE_END!r}, flush=True)\n"
    f"    print({NODE_END!r} + str(time.perf_counter() - t0), file=sys.stderr, flush=True)\n"
)


def node_pair(tmp, runs, label, timeout=300, starter_args=()):
    """`cli.starter` and one `cli.secondary` as two processes on the card,
    each under `cli.mem_monitor`, which run the node CLIs' argv `runs` in
    turn (each its own localhost config; the starter's with
    `starter_args` too); returns, per run, (starter
    stdout, starter stderr, secondary stderr, the starter's seconds) and
    {role: the monitor's peak gpu_bytes and card_bytes over every run, or
    its word for them}."""
    import csv
    import os

    root = Path(__file__).resolve().parent
    configs = []
    for i in range(len(runs)):
        cfg_path = Path(tmp) / f"{label}-{i}.json"
        cfg_path.write_text(json.dumps({"nodes": {
            "starter": {"addr": "127.0.0.1", "communication": {"port": free_port()}},
            "secondary": [{"addr": "127.0.0.1", "communication": {"port": free_port()}}]}}))
        configs.append(str(cfg_path))
    env = dict(os.environ, PYTHONPATH=str(root))

    def cmd(role, extra):
        job = {"role": role, "runs": [argv + ["--nodes-config", c, *extra]
                                      for argv, c in zip(runs, configs)]}
        return [sys.executable, "-m", "mdi_llm_tpu_torch.cli.mem_monitor", "-o",
                str(Path(tmp) / f"{label}-{role}.csv"), "--interval", "0.25", "--",
                sys.executable, "-c", NODE_ENTRY, json.dumps(job)]

    sec_err = Path(tmp) / f"{label}-secondary.err"
    with open(sec_err, "w") as err:
        sec = subprocess.Popen(cmd("secondary", ["0"]), cwd=str(root), env=env,
                               stdout=subprocess.DEVNULL, stderr=err)
    try:
        sta = subprocess.run(cmd("starter", list(starter_args)), cwd=str(root), env=env,
                             capture_output=True, text=True, timeout=timeout)
        sec.wait(timeout=timeout)
    finally:
        for p in (sec,):
            if p.poll() is None:
                p.kill()
                p.wait()
    serr = sec_err.read_text()
    if sta.returncode or sec.returncode:
        fail("pipeline-nodes", f"{label}: starter exit {sta.returncode}, secondary exit "
             f"{sec.returncode}\n{sta.stderr[-3000:]}\n{serr[-3000:]}")

    def split(text):
        parts, cur = [], []
        for ln in text.splitlines():
            if ln.startswith(NODE_END):
                parts.append(("\n".join(cur), ln[len(NODE_END):]))
                cur = []
            else:
                cur.append(ln)
        return parts

    outs, errs, serrs = split(sta.stdout), split(sta.stderr), split(serr)
    if not len(outs) == len(errs) == len(serrs) == len(runs):
        fail("pipeline-nodes", f"{label}: {len(runs)} runs, the starter ended {len(outs)} / "
             f"{len(errs)} and the secondary {len(serrs)}\n{sta.stderr[-3000:]}\n"
             f"{serr[-3000:]}")
    mem = {}
    for role in ("starter", "secondary"):
        with open(Path(tmp) / f"{label}-{role}.csv") as f:
            rows = list(csv.DictReader(f))
        mem[role] = {}
        for col in ("gpu_bytes", "card_bytes"):
            vals = [r[col] for r in rows]
            ints = [int(v) for v in vals if v.isdigit()]
            mem[role][col] = max(ints) if ints else (vals[-1] if vals else "no samples")
    return [(o, e, se, float(sec_s)) for (o, _), (e, sec_s), (se, _) in
            zip(outs, errs, serrs)], mem


def printed_samples(stdout):
    import re

    out, grab = [], False
    for line in stdout.splitlines():
        if line.startswith("--- sample"):
            grab = True
        elif grab and line.startswith("["):
            out.append([int(x) for x in re.findall(r"-?\d+", line)])
            grab = False
    return out


def ring_line(stderr):
    return json.loads(next(ln for ln in stderr.splitlines() if ln.startswith("ring: "))[6:])


def phase_pipeline_nodes(card):
    """The starter and a secondary as two processes sharing the card (the
    module docstring, phase 24)."""
    import torch

    from mdi_llm_tpu_torch.config import Config
    from mdi_llm_tpu_torch.generation import Generator
    from mdi_llm_tpu_torch.models import transformer
    from mdi_llm_tpu_torch.parallel.pipeline import PipelineEngine

    base = ["--model", TINY_LLAMA, "--seed", "10137", "--greedy", "--sequence-length", "2048",
            "--samples-per-slot", str(PIPE_M), "--n-samples", str(2 * PIPE_M)]
    with tempfile.TemporaryDirectory() as tmp:
        # float32, 4 layers: the two-process streams are the one-process ring's
        f32 = base + ["--dtype", "float32", "--override", f"n_layer={PIPE_F32_LAYERS}",
                      "--n-tokens", "32"]
        # bf16 at full depth: tokens/s, the hop, each process's card memory
        bf16 = base + ["--dtype", "bfloat16", "--n-tokens", str(PIPE_TOKENS)]
        runs, mem = node_pair(tmp, [f32, bf16], "nodes", starter_args=["--hbm-gb", "80"])
        for i, (_o, e, _se, _s) in enumerate(runs):
            audit = next((ln for ln in e.splitlines() if "cli.starter: plan audit:" in ln), "")
            if "plan audit: 0 error(s)" not in audit or "80 GiB budget" not in audit:
                fail("pipeline-nodes", f"job {i}: the starter's plan audit line {audit!r}")
            print(f"pipeline-nodes: job {i}: {audit}", flush=True)
        out, err, serr, _s = runs[0]
        got = printed_samples(out)
        cfg = Config.from_name(TINY_LLAMA, n_layer=PIPE_F32_LAYERS)
        params = transformer.init_params(cfg, 10137, dtype=torch.float32, device="cuda")
        prompts = [g[:8] for g in got]
        want, _ = PipelineEngine(cfg, params, n_stages=2, samples_per_slot=PIPE_M,
                                 max_seq_length=2048, device="cuda").generate(
            prompts, 32, temperature=0.0)
        ring_budget_ok("pipeline-nodes", "float32", got, prompts, 32, cfg.padded_vocab_size)
        gen = Generator(cfg, params, max_seq_length=2048, device="cuda")
        divergence_ok("pipeline-nodes", gen, dict(enumerate(got)), dict(enumerate(want)),
                      "float32 two processes vs one")
        if ring_line(err)["backend"] != "gloo" or ring_line(serr)["stages"] != [1]:
            fail("pipeline-nodes", f"float32: ring lines {ring_line(err)} {ring_line(serr)}")
        print(f"pipeline-nodes: float32 {PIPE_F32_LAYERS} layers, 2 processes (gloo, hop "
              f"through pinned host buffers): {sum(a == b for a, b in zip(got, want))}/"
              f"{len(want)} streams identical to the one-process ring", flush=True)
        del gen, params
        free()
        out, err, serr, run_s = runs[1]
        got = printed_samples(out)
        ring_budget_ok("pipeline-nodes", "bf16", got, [g[:8] for g in got], PIPE_TOKENS, 32000)
        stats_line = next(ln for ln in err.splitlines() if "tok/s decode" in ln)
        print("pipeline-nodes: " + json.dumps({
            "card": card, "dtype": "bfloat16", "layers": 22, "S": 2, "M": PIPE_M,
            "samples": len(got), "new_tokens": PIPE_TOKENS, "stats_line": stats_line,
            "starter_ring": ring_line(err), "secondary_ring": ring_line(serr),
            "mem_monitor_peaks": mem,
            "cuda_max_reserved_bytes": {"starter": ring_line(err).get("cuda_max_reserved_bytes"),
                                        "secondary": ring_line(serr).get("cuda_max_reserved_bytes")},
            "starter_run_s": run_s}), flush=True)


RING_SERVE_LAYERS = 6  # tiny-llama's layers in the pp, tp and pp x tp serves (22 before the
# sp and ep runs over processes, 12 before the layouts over processes: each engine
# layout's preflight traces every layer)
PP_SERVE_RUNS = ((2, [2, 4]), (4, [1, 1, 2, 2]))  # stages, `partition.stage_layers` of 6 (of
# 12 before the layouts over processes)
RING_SERVE_TOKENS = 8  # the pp, tp and pp x tp serves (64 before the doctor phase's cuts, 32
# before the analysis phase's and the serve preflights', 16 before the layouts over processes)
PP_SERVE_ARGV = SERVE_BASE + ["--override", f"n_layer={RING_SERVE_LAYERS}", "--synthetic", "16",
                              "--n-tokens", str(RING_SERVE_TOKENS)]
PP_SERVE_F32_LAYERS = 4


def pp_served(phase, argv, S, split, tp=1):
    """The serve CLI on `argv` with `--pp S` (and `--tp tp`), K1's and the
    plain route's counts set to 0 just before and read just after.  Fails
    unless the engine is the ring over `split` of `RING_SERVE_LAYERS` with tp ranks
    per stage, every request finished with its budget in the vocabulary,
    K1 launched exactly once per stage layer the engine ran and rank and
    the plain route never, and the steps were captured when the engine was
    built and replayed in the run.  Returns (stats line, K1 launches,
    merge launches, engine, results)."""
    from mdi_llm_tpu_torch.cli import serve as cli
    from mdi_llm_tpu_torch.ops.ragged_paged_attention import ragged_paged_attention
    from mdi_llm_tpu_torch.serving.pipeline import PipelinedServingEngine

    args = cli.build_parser().parse_args(argv + ["--pp", str(S), "--tp", str(tp)])
    reset_k1_counts()
    trace, results, stats, engine, _tok = cli.serve(args)
    launches, plain = k1_counts()
    merges = ragged_paged_attention.merge_launches
    if not isinstance(engine, PipelinedServingEngine) or engine._stage_counts != split \
            or engine.gen.cfg.n_layer != RING_SERVE_LAYERS or engine._tp != tp:
        fail(phase, f"--pp {S} --tp {tp}: engine {type(engine).__name__} over "
             f"{engine.gen.cfg.n_layer} layers split {getattr(engine, '_stage_counts', None)} "
             f"tp {getattr(engine, '_tp', None)}, want {split} of {RING_SERVE_LAYERS}, tp {tp}")
    if launches != tp * engine.stage_layer_runs or plain or not launches:
        fail(phase, f"--pp {S} --tp {tp}: K1 launches {launches}, plain route {plain}: want "
             f"{tp} x {engine.stage_layer_runs} = the stage layers the ring ran, per rank")
    graphs = engine.graph_stats()
    if graphs["captures"] != graphs["steps"] or not graphs["replays"]:
        fail(phase, f"--pp {S}: steps {graphs['steps']}, captures {graphs['captures']}, "
             f"replays {graphs['replays']}: the ring's steps must replay as graphs")
    vocab = engine.gen.cfg.padded_vocab_size
    for rid, prompt, new in trace:
        out = results.get(rid)
        if out is None or len(out) - len(prompt) != new or not all(
                0 <= t < vocab for t in out[len(prompt):]):
            fail(phase, f"--pp {S}: {rid} did not finish with its {new} tokens in the vocabulary")
    line = cli.stats_line(stats, engine, [len(p) + n / 2 for _rid, p, n in trace])
    return line, launches, merges, engine, results


def phase_pp_serve(k1, card):
    """Pipeline-parallel serving on the card (the module docstring, phase
    25)."""
    import torch

    from mdi_llm_tpu_torch.cli import serve as cli
    from mdi_llm_tpu_torch.cli.serve import synthetic_trace
    from mdi_llm_tpu_torch.generation import Generator
    from mdi_llm_tpu_torch.ops import paged_attention as pa
    from mdi_llm_tpu_torch.ops.ragged_paged_attention import ragged_paged_attention
    from mdi_llm_tpu_torch.parallel.mesh import pipeline_mesh

    # warm-up (CUDA context, cuBLAS handles), not counted
    cli.serve(cli.build_parser().parse_args(SERVE_BASE + ["--synthetic", "2", "--n-tokens", "8"]))
    torch.cuda.synchronize()
    total = 0
    for kv, extra, runs in (("bfloat16", [], PP_SERVE_RUNS),
                            ("int8", ["--kv-dtype", "int8"], PP_SERVE_RUNS[:1])):
        argv = PP_SERVE_ARGV + extra
        single_line, single_gen, want = single_reference("pp-serve", argv)
        for S, split in runs:
            torch.cuda.reset_peak_memory_stats()
            line, launches, merges, engine, got = pp_served("pp-serve", argv, S, split)
            peak = torch.cuda.max_memory_allocated() / 2**30
            total += launches
            K = engine.cfg.decode_chunk
            chunks = (engine.forward_calls - line["mixed_steps"]) // K
            n_div = bf16_divergences("pp-serve", single_gen, got, want,
                                     f"--pp {S} {kv} pool vs the single engine")
            if line["host_syncs"] != single_line["host_syncs"]:
                fail("pp-serve", f"--pp {S} {kv}: host_syncs {line['host_syncs']}, the single "
                     f"engine's {single_line['host_syncs']}")
            print("pp-serve: " + json.dumps({
                "card": card, "pp": S, "split": split, "kv_dtype": kv, "requests": 16,
                "new_tokens": RING_SERVE_TOKENS, "tokens_per_s": line["tokens_per_s"],
                "single_tokens_per_s": single_line["tokens_per_s"],
                "pp_over_single": line["tokens_per_s"] / single_line["tokens_per_s"],
                "wall_s": line["wall_s"], "single_wall_s": single_line["wall_s"],
                "preflight_s": {k: v["seconds"] for k, v in engine.preflight.items()},
                "pipeline": line["pipeline"], "devices": line["devices"],
                "tokens_per_s_per_chip": line["tokens_per_s_per_chip"],
                "mixed_steps": line["mixed_steps"], "decode_chunks": chunks,
                "decode_chunk": K, "forward_calls": engine.forward_calls,
                "host_syncs": line["host_syncs"], "k1_launches": launches,
                "k1_merge_launches": merges, "stage_layer_runs": engine.stage_layer_runs,
                "k1_launches_predicted": RING_SERVE_LAYERS * ((2 * S - 1) * line["mixed_steps"]
                                               + (K * S + S) * chunks),
                "graph_captures": line["graph_captures"], "graph_replays": line["graph_replays"],
                "capture_s": line["capture_s"], "single_capture_s": single_line["capture_s"],
                "bf16_divergences": n_div, "peak_memory_gib": peak}), flush=True)
            del engine, got
            free()
        del single_gen, want
        free()
    k1.setdefault("paths", {})["pp-serve"] = total

    # float32 at 4 layers: the ring through K1 gives the single engine's
    # streams through K1 and the ring's through the plain route
    gen = tiny_llama_generator(PP_SERVE_F32_LAYERS, torch.float32)
    trace = synthetic_trace(4, gen.cfg.vocab_size, 2048, 16)
    want, wstats = _serve_trace(gen.serve(block_size=16, max_batch=8), trace)
    for S in (2, 4):
        ppgen = Generator(gen.cfg, gen.params, max_seq_length=2048, device=gen.device,
                          mesh=pipeline_mesh(S, [gen.device]))
        streams = {}
        for route, use_kernel in (("kernel", None), ("plain", False)):
            reset_k1_counts()
            engine = ppgen.serve(block_size=16, max_batch=8, use_kernel=use_kernel)
            streams[route], stats = _serve_trace(engine, trace)
            launched, plain = k1_counts()
            want_launches = engine.stage_layer_runs if route == "kernel" else 0
            if launched != want_launches or (plain > 0) != (route == "plain"):
                fail("pp-serve", f"float32 S={S}: the {route} run launched K1 {launched} times "
                     f"(want {want_launches}) and took the plain route {plain} times")
            if stats.host_syncs != wstats.host_syncs:
                fail("pp-serve", f"float32 S={S} {route}: host_syncs {stats.host_syncs}, the "
                     f"single engine's {wstats.host_syncs}")
            del engine
        divergence_ok("pp-serve", gen, streams["kernel"], want,
                      f"float32 S={S} ring (K1) vs single engine (K1)")
        divergence_ok("pp-serve", gen, streams["kernel"], streams["plain"],
                      f"float32 S={S} ring K1 vs ring plain route")
        same = sum(streams["kernel"][r] == want[r] for r in want)
        print(f"pp-serve: float32 {PP_SERVE_F32_LAYERS} layers x {gen.cfg.n_embd}, S={S}: "
              f"{same} of {len(trace)} greedy streams identical to the single engine's, "
              f"{sum(streams['kernel'][r] == streams['plain'][r] for r in want)} to the plain "
              f"route's; host_syncs {wstats.host_syncs} as the single engine's", flush=True)
        del ppgen
    del gen
    free()


def _serve_trace(engine, trace):
    for rid, prompt, new in trace:
        engine.add_request(rid, prompt, new)
    return engine.run()


TP_SIZES = (2, 4)
TP_SERVE_ARGV = PP_SERVE_ARGV
TP_F32_LAYERS = 4
TP_K1_CASES = ("decode", "mixed", "verify")


def phase_tp_kernels(record):
    """K1 at the tp ranks' geometries (the module docstring, phase 26),
    its knobs resolved on the model's whole geometry as the path does."""
    import torch

    from mdi_llm_tpu_torch.ops import tuning
    from mdi_llm_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention,
        ragged_paged_attention_plain,
    )

    rows = {}
    for tp in TP_SIZES:
        H, G = 32 // tp, 4 // tp
        for kind in ("bfloat16", "int8"):
            for label in TP_K1_CASES:
                spans, T, hs = K1_CASES[label]
                scale = hs ** -0.5
                args, owned = make_case(spans, T, torch.bfloat16, seed=len(spans) + T,
                                        H=H, G=G, hs=hs)
                if kind == "int8":
                    kp, vp = narrow_pools(args[1], args[2], kind, seed=T)
                    args = (args[0], kp, vp) + args[3:]
                pool = args[1]["q"] if kind == "int8" else args[1]
                params = tuning.global_kernel_params(32, 4, hs, pool.shape[1], torch.bfloat16,
                                                     pool.dtype, pool.device)
                out = ragged_paged_attention(*args, scale=scale, params=params)
                torch.cuda.synchronize()
                ref = ragged_paged_attention_plain(args[0].float(), *args[1:], scale=scale)
                err = (out.float()[:, :, :owned] - ref[:, :, :owned]).abs().max().item()
                pad = out[:, :, owned:].abs().max().item() if owned < T else 0.0
                if not err <= TOL["bfloat16"] or pad != 0.0:
                    fail("tp-serve", f"K1 {H}h/{G}g {kind} pool {label}: max|err| {err} "
                         f"(tol {TOL['bfloat16']}), padding rows max {pad}")
                ms = cuda_ms(lambda: ragged_paged_attention(*args, scale=scale, params=params), 50)
                plain_ms = cuda_ms(lambda: ragged_paged_attention_plain(*args, scale=scale), 5)
                lib_ms = cuda_ms(library_call(args, scale), 20)
                b_ms, b_by = bound(args, owned)
                rows[(tp, kind, label)] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                               bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
                print(f"tp-serve: K1 tp={tp} ({H} heads / {G} groups) {kind} pool, q bfloat16 "
                      f"{label} T={T} hs={hs} params={params.to_dict()} max_abs_err={err:.3e} "
                      f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                      f"bound_ms={b_ms:.5f} ({b_by})", flush=True)
                del args, out, ref
            torch.cuda.empty_cache()
    record["max_abs_err"] = max(record.get("max_abs_err", 0.0),
                                max(r["max_abs_err"] for r in rows.values()))
    return rows


def tp_served(phase, argv, tp):
    """The serve CLI on `argv` with `--tp tp`, K1's and the plain route's
    counts set to 0 just before and read just after.  Fails unless the
    engine runs `RING_SERVE_LAYERS` over tp ranks on one card, every request
    finished with its budget in the vocabulary, K1 launched exactly tp x
    that per target forward and the plain route never, and the steps were
    captured when the engine was built and replayed in the run.  Returns
    (stats line, K1 launches, engine, results)."""
    from mdi_llm_tpu_torch.cli import serve as cli

    from mdi_llm_tpu_torch.ops.ragged_paged_attention import ragged_paged_attention

    args = cli.build_parser().parse_args(argv + ["--tp", str(tp)])
    reset_k1_counts()
    trace, results, stats, engine, _tok = cli.serve(args)
    launches, plain = k1_counts()
    engine.k1_merge_launches = ragged_paged_attention.merge_launches
    gen = engine.gen
    if gen.tp != tp or gen.cfg.n_layer != RING_SERVE_LAYERS or set(engine._kv) != set(range(tp)):
        fail(phase, f"--tp {tp}: Generator tp {gen.tp}, {gen.cfg.n_layer} layers, pool "
             f"ranks {sorted(engine._kv)}")
    want = tp * RING_SERVE_LAYERS * engine.forward_calls
    if launches != want or plain or not launches:
        fail(phase, f"--tp {tp}: K1 launches {launches}, plain route {plain}: want {want} "
             f"= {tp} ranks x {RING_SERVE_LAYERS} layers x {engine.forward_calls} forwards")
    graphs = engine.graph_stats()
    if graphs["captures"] != graphs["steps"] or not graphs["replays"]:
        fail(phase, f"--tp {tp}: steps {graphs['steps']}, captures {graphs['captures']}, "
             f"replays {graphs['replays']}: the tp engine's steps must replay as graphs")
    vocab = gen.cfg.padded_vocab_size
    for rid, prompt, new in trace:
        out = results.get(rid)
        if out is None or len(out) - len(prompt) != new or not all(
                0 <= t < vocab for t in out[len(prompt):]):
            fail(phase, f"--tp {tp}: {rid} did not finish with its {new} tokens in the "
                 "vocabulary")
    line = cli.stats_line(stats, engine, [len(p) + n / 2 for _rid, p, n in trace])
    return line, launches, engine, results


def phase_tp_serve(k1, card):
    """Tensor-parallel serving on the card (the module docstring, phase 26)."""
    import torch

    from mdi_llm_tpu_torch.cli import serve as cli
    from mdi_llm_tpu_torch.cli.serve import synthetic_trace
    from mdi_llm_tpu_torch.generation import Generator
    from mdi_llm_tpu_torch.parallel.mesh import make_mesh

    phase_tp_kernels(k1)
    # warm-up (CUDA context, cuBLAS handles), not counted
    cli.serve(cli.build_parser().parse_args(TP_SERVE_ARGV + ["--synthetic", "2", "--n-tokens",
                                                             "8", "--tp", "2"]))
    torch.cuda.synchronize()
    total = 0
    for kv, extra, sizes in (("bfloat16", [], TP_SIZES), ("int8", ["--kv-dtype", "int8"], (2,))):
        argv = TP_SERVE_ARGV + extra
        single_line, single_gen, want = single_reference("tp-serve", argv)
        for tp in sizes:
            torch.cuda.reset_peak_memory_stats()
            line, launches, engine, got = tp_served("tp-serve", argv, tp)
            peak = torch.cuda.max_memory_allocated() / 2**30
            total += launches
            if tp == 2:
                print(f"tp-serve: --tp 2 {kv} pool: plan audit per rank vs the live engine: "
                      + json.dumps(audit_checked("tp-serve", engine, f"--tp 2 {kv}")), flush=True)
            n_div = bf16_divergences("tp-serve", single_gen, got, want,
                                     f"--tp {tp} {kv} pool vs the single engine")
            if line["host_syncs"] != single_line["host_syncs"]:
                fail("tp-serve", f"--tp {tp} {kv}: host_syncs {line['host_syncs']}, the single "
                     f"engine's {single_line['host_syncs']}")
            print("tp-serve: " + json.dumps({
                "card": card, "tp": tp, "kv_dtype": kv, "requests": 16,
                "new_tokens": RING_SERVE_TOKENS,
                "tokens_per_s": line["tokens_per_s"],
                "single_tokens_per_s": single_line["tokens_per_s"],
                "tp_over_single": line["tokens_per_s"] / single_line["tokens_per_s"],
                "wall_s": line["wall_s"], "single_wall_s": single_line["wall_s"],
                "preflight_s": {k: v["seconds"] for k, v in engine.preflight.items()},
                "n_chips": line["n_chips"], "devices": line["devices"],
                "mixed_steps": line["mixed_steps"], "forward_calls": engine.forward_calls,
                "host_syncs": line["host_syncs"], "k1_launches": launches,
                "k1_merge_launches": engine.k1_merge_launches,
                "graph_captures": line["graph_captures"], "graph_replays": line["graph_replays"],
                "capture_s": line["capture_s"], "single_capture_s": single_line["capture_s"],
                "bf16_divergences": n_div, "peak_memory_gib": peak}), flush=True)
            del engine, got
            free()
        del single_gen, want
        free()
    k1.setdefault("paths", {})["tp-serve"] = total

    # float32 at 4 layers: the tp engine through K1 gives the single
    # engine's streams through K1 and its own through the plain route
    gen = tiny_llama_generator(TP_F32_LAYERS, torch.float32)
    trace = synthetic_trace(4, gen.cfg.vocab_size, 2048, 16)
    want, wstats = _serve_trace(gen.serve(block_size=16, max_batch=8), trace)
    for tp in TP_SIZES:
        tgen = Generator(gen.cfg, gen.params, max_seq_length=2048, device=gen.device,
                         mesh=make_mesh({"tp": tp}, [gen.device]))
        streams = {}
        for route, use_kernel in (("kernel", None), ("plain", False)):
            reset_k1_counts()
            engine = tgen.serve(block_size=16, max_batch=8, use_kernel=use_kernel)
            streams[route], stats = _serve_trace(engine, trace)
            launched, plain = k1_counts()
            want_launches = tp * TP_F32_LAYERS * engine.forward_calls if route == "kernel" else 0
            if launched != want_launches or (plain > 0) != (route == "plain"):
                fail("tp-serve", f"float32 tp={tp}: the {route} run launched K1 {launched} "
                     f"times (want {want_launches}) and took the plain route {plain} times")
            if stats.host_syncs != wstats.host_syncs:
                fail("tp-serve", f"float32 tp={tp} {route}: host_syncs {stats.host_syncs}, "
                     f"the single engine's {wstats.host_syncs}")
            del engine
        divergence_ok("tp-serve", gen, streams["kernel"], want,
                      f"float32 tp={tp} (K1) vs single engine (K1)")
        divergence_ok("tp-serve", gen, streams["kernel"], streams["plain"],
                      f"float32 tp={tp} K1 vs plain route")
        same = sum(streams["kernel"][r] == want[r] for r in want)
        print(f"tp-serve: float32 {TP_F32_LAYERS} layers x {gen.cfg.n_embd}, tp={tp}: "
              f"{same} of {len(trace)} greedy streams identical to the single engine's, "
              f"{sum(streams['kernel'][r] == streams['plain'][r] for r in want)} to the plain "
              f"route's; host_syncs {wstats.host_syncs} as the single engine's", flush=True)
        del tgen
    del gen
    free()


def phase_tp_generate(k2, card):
    """Tensor-parallel generation on the card (the module docstring,
    phase 27)."""
    import torch

    from mdi_llm_tpu_torch.generation import Generator
    from mdi_llm_tpu_torch.ops.flash import flash_attention, flash_attention_plain
    from mdi_llm_tpu_torch.parallel.mesh import make_mesh

    B, T = 4, 2048
    for tp in TP_SIZES:
        H, G = 32 // tp, 4 // tp
        q, k, v = flash_inputs(B, T, torch.bfloat16, seed=T + tp, H=H, G=G)
        out = flash_attention(q, k, v)
        torch.cuda.synchronize()
        ref, _lse = flash_attention_plain(q.float(), k.float(), v.float(), causal=True)
        err = (out.float() - ref).abs().max().item()
        del ref, _lse
        if not err <= TOL["bfloat16"]:
            fail("tp-generate", f"K2 {H}h/{G}g: max|err| {err} (tol {TOL['bfloat16']})")
        ms = cuda_ms(lambda: flash_attention(q, k, v), 20)
        plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v), 3)
        lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 20)
        b_ms, b_by = flash_bound(B, H, G, T, 64, torch.bfloat16, True, False)
        k2["max_abs_err"] = max(k2.get("max_abs_err", 0.0), err)
        print(f"tp-generate: K2 tp={tp} ({H} heads / {G} groups) bfloat16 B={B} T={T} "
              f"hs=64 causal max_abs_err={err:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib_ms:.4f} bound_ms={b_ms:.5f} ({b_by})", flush=True)
        del q, k, v, out
        torch.cuda.empty_cache()

    single = tiny_llama_generator(22, torch.bfloat16)
    cfg = single.cfg
    prompts = long_prompts((1100, 1370, 1650, 1900), cfg.vocab_size)
    single.generate([[1, 2, 3]] * 4, 4, temperature=0.0)  # warm-up, not counted
    want, wstats = single.generate(prompts, 64, temperature=0.0, chunk_size=16)
    gen = Generator(cfg, single.params, max_seq_length=2048, device="cuda",
                    mesh=make_mesh({"tp": 2}, ["cuda"]))
    gen.generate([[1, 2, 3]] * 4, 4, temperature=0.0)  # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = flash_attention_plain.calls = 0
    outs, stats = gen.generate(prompts, 64, temperature=0.0, chunk_size=16)
    torch.cuda.synchronize()
    launches, plain = flash_attention.launches, flash_attention_plain.calls
    for i, (p, o) in enumerate(zip(prompts, outs)):
        new = o[len(p):]
        if len(new) != 64 or not all(0 <= t < cfg.padded_vocab_size for t in new):
            fail("tp-generate", f"sample {i} did not get 64 tokens in the vocabulary")
    if launches != 2 * 22 or plain or not stats.captures:
        fail("tp-generate", f"K2 launches {launches} (want 2 x 22), plain version calls "
             f"{plain} (want 0), decode-chunk captures {stats.captures} (want > 0)")
    n_div = bf16_divergences("tp-generate", single, dict(enumerate(outs)),
                             dict(enumerate(want)), "tp=2 generate vs the single device")
    tp_replay_s = stats.decode_s - stats.capture_s
    single_replay_s = wstats.decode_s - wstats.capture_s
    print("tp-generate: " + json.dumps({
        "card": card, "tp": 2, "prompt_lens": [len(p) for p in prompts], "new_tokens": 64,
        "prefill_s": round(stats.prefill_s, 4), "single_prefill_s": round(wstats.prefill_s, 4),
        "decode_s": round(stats.decode_s, 4), "single_decode_s": round(wstats.decode_s, 4),
        "tokens_per_s": round(stats.tokens_per_s, 2),
        "single_tokens_per_s": round(wstats.tokens_per_s, 2),
        # decode_s holds this run's graph captures: tokens/s without them
        "replay_tokens_per_s": stats.tokens_generated / tp_replay_s,
        "single_replay_tokens_per_s": wstats.tokens_generated / single_replay_s,
        "tp_over_single": single_replay_s / tp_replay_s,
        "graph_captures": stats.captures, "capture_s": round(stats.capture_s, 4),
        "single_capture_s": round(wstats.capture_s, 4),
        "peak_memory_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3),
        "k2_launches": launches, "k2_plain_calls": plain, "bf16_divergences": n_div}),
        flush=True)
    k2.setdefault("paths", {})["tp-generate"] = launches
    del gen, single
    free()

    # float32 at 4 layers: tp 2 and dp x tp = 2 x 2 generate the single
    # device's streams
    single = tiny_llama_generator(TP_F32_LAYERS, torch.float32)
    prompts = long_prompts((1100, 1370, 1650, 1900), single.cfg.vocab_size, seed=7)
    want, _ = single.generate(prompts, 16, temperature=0.0)
    for axes in ({"tp": 2}, {"dp": 2, "tp": 2}):
        gen = Generator(single.cfg, single.params, max_seq_length=2048, device="cuda",
                        mesh=make_mesh(axes, ["cuda"]))
        flash_attention.launches = flash_attention_plain.calls = 0
        got, _ = gen.generate(prompts, 16, temperature=0.0)
        launched = flash_attention.launches
        n_ranks = axes["tp"] * axes.get("dp", 1)
        if launched != n_ranks * TP_F32_LAYERS or flash_attention_plain.calls:
            fail("tp-generate", f"float32 {axes}: K2 launches {launched} (want {n_ranks} x "
                 f"{TP_F32_LAYERS}), plain version calls {flash_attention_plain.calls}")
        divergence_ok("tp-generate", single, dict(enumerate(got)), dict(enumerate(want)),
                      f"float32 {axes} vs the single device")
        print(f"tp-generate: float32 {TP_F32_LAYERS} layers x {single.cfg.n_embd}, mesh "
              f"{axes}: {sum(g == w for g, w in zip(got, want))} of {len(want)} greedy "
              f"streams identical to the single device's; K2 launches {launched}", flush=True)
        del gen
    del single
    free()


TOOLS_WORDS = 60000  # the text file's words: ~54k train and ~6k val tokens
TOOLS_DOCS = 30  # prepare_owt's documents of those words: 3 (~6k tokens) in val


def phase_tools(card, ckpt_dir):
    """`cli.prepare_data`, `cli.prepare_owt` and `cli.evaluate` on the card
    (the module docstring, phase 28)."""
    import contextlib
    import io

    import numpy as np
    import torch

    from mdi_llm_tpu_torch.cli import evaluate as evaluate_cli
    from mdi_llm_tpu_torch.cli import prepare_data
    from mdi_llm_tpu_torch.cli import prepare_model
    from mdi_llm_tpu_torch.training import cross_entropy_loss
    from mdi_llm_tpu_torch.utils import checkpoint as ck
    from mdi_llm_tpu_torch.utils import data_loader
    from mdi_llm_tpu_torch.utils.tokenizer import Tokenizer

    if importlib.util.find_spec("tokenizers") is None:
        print("tools: tokenizers is not installed on this machine; prepare_data and "
              "evaluate are held on the CPU only", flush=True)
        return
    if not ck.has_checkpoint(ckpt_dir):  # run without the ckpt phase
        print("tools: the ckpt phase did not run: writing its snapshot here", flush=True)
        write_snapshot(ckpt_dir)
        prepare_model.main([str(ckpt_dir)])
    write_word_tokenizer(ckpt_dir)
    data_dir = Path(ckpt_dir).parent / "tools-data"
    data_dir.mkdir(exist_ok=True)
    rng = np.random.default_rng(10137)
    text = data_dir / "input.txt"
    words = [f"w{i}" for i in rng.integers(3, CHAT_VOCAB, TOOLS_WORDS)]
    text.write_text(" ".join(words))
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        train_p, val_p = prepare_data.main(["--dataset", str(text), "--ckpt", str(ckpt_dir)])
    prep_s = time.perf_counter() - t0
    ids = Tokenizer(ckpt_dir).encode(text.read_text(), bos=False)
    bins = np.concatenate([np.fromfile(train_p, np.uint16), np.fromfile(val_p, np.uint16)])
    if not np.array_equal(bins, ids.astype(np.uint16)):
        fail("tools", "train.bin + val.bin are not the text's tokens in order")
    eval_dir, evaluated, owt = data_dir, "prepare_data", {
        "datasets": "not installed on this machine: prepare_owt is held on the CPU only"}
    if importlib.util.find_spec("datasets") is not None:
        from mdi_llm_tpu_torch.cli import prepare_owt

        docs = [" ".join(d) for d in np.array_split(words, TOOLS_DOCS)]
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            prepare_owt.save_documents(docs, data_dir / "docs")
            owt_p = prepare_owt.main(["--dataset", str(data_dir / "docs"), "--ckpt",
                                      str(ckpt_dir), "--out", str(data_dir / "owt"),
                                      "--num-proc", "1", "--val-frac", "0.1"])
        owt_s = time.perf_counter() - t0
        # each document as bos ("<s>" = 1), its words' ids and eos ("</s>" = 2)
        want = sorted((1, *(int(w[1:]) for w in d.split())) for d in docs)
        got, n = [], []
        for p in owt_p:
            ids = np.fromfile(p, np.uint16)
            pieces = np.split(ids, np.flatnonzero(ids == 2) + 1)
            if pieces[-1].size:
                fail("tools", f"{p.name} does not end with eos")
            got += [tuple(int(t) for t in d[:-1]) for d in pieces[:-1]]
            n.append(len(pieces) - 1)
        if sorted(got) != want or not 0 < n[1] < n[0]:
            fail("tools", f"prepare_owt's bins ({n} documents) are not every document's "
                 "bos, ids and eos once each")
        eval_dir, evaluated, val_p = data_dir / "owt", "prepare_owt", owt_p[1]
        owt = {"datasets": sys.modules["datasets"].__version__, "documents": n,
               "tokens": [int(p.stat().st_size // 2) for p in owt_p],
               "prepare_owt_s": round(owt_s, 3)}

    argv = ["--ckpt", str(ckpt_dir), "--dataset", str(eval_dir), "--split", "val",
            "--eval-iters", "4", "--batch-size", "4", "--block-size", "1024",
            "--dtype", "bfloat16", "--device", DEVICE]
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        rc = evaluate_cli.main(argv)
    eval_s = time.perf_counter() - t0
    rec = json.loads(printed.getvalue().strip().splitlines()[-1])
    if rc != 0 or set(rec) != {"ckpt", "split", "tokens", "eval_iters", "loss", "perplexity"}:
        fail("tools", f"cli.evaluate returned {rc} with keys {sorted(rec)}")
    cfg, params = ck.load_checkpoint(ckpt_dir, dtype=torch.bfloat16, device=DEVICE)
    if cfg.n_layer != 22:
        fail("tools", f"the checkpoint has {cfg.n_layer} layers, want 22")
    data = data_loader.open_bin(val_p)
    draws = np.random.default_rng(10137)
    losses = []
    with torch.no_grad():
        for _ in range(4):
            x, y = data_loader.get_batch(data, 4, 1024, draws)
            losses.append(float(cross_entropy_loss(
                cfg, params, torch.from_numpy(x).to(DEVICE), torch.from_numpy(y).to(DEVICE),
                remat=False)))
    direct = float(np.mean(losses))
    if not abs(rec["loss"] - direct) <= 1e-3 or not np.isfinite(direct):
        fail("tools", f"cli.evaluate loss {rec['loss']} against the direct "
             f"cross_entropy_loss {direct}")
    print("tools: " + json.dumps({
        "card": card, "text_words": TOOLS_WORDS, "train_tokens": int(np.fromfile(
            train_p, np.uint16).size), "val_tokens": int(data.size),
        "prepare_data_s": round(prep_s, 3), "prepare_owt": owt, "evaluated": evaluated,
        "evaluate": rec, "evaluate_s": round(eval_s, 2), "direct_loss": direct}), flush=True)
    del params
    free()


MESH_TRAIN_MESHES = ({"dp": 2}, {"tp": 2}, {"dp": 2, "tp": 2}, {"dp": 1, "pp": 2},
                     {"dp": 1, "pp": 2, "tp": 2})
MESH_F32_LAYERS = 2  # 4 before PR 18's cuts of the whole run's time
MESH_TRAIN_LAYERS = 4  # the bf16 steps (22, then 11, before the cuts for the run's time; 6
# since the sp and ep runs over processes, 4 since the layouts over processes)
MESH_PROCS_DP_LAYERS = 2  # tiny-llama cut for dp 2 over two processes in bf16 (11, then 4,
# before the cuts for the whole run's time: the gloo gradient all-reduce is the step)
MESH_PROCS_PP_LAYERS = 4  # and for the GPipe stages over them (22, then 6, before the cuts)
MESH_PROCS_STEPS = 2  # steps of the dp and pp runs over two processes (3 before the run's cuts)
# clipping engaged (the first norm is far above 0.05).  The learning rate
# sets how far float32 rounding moves AdamW's normalised update: at 1e-3
# the first run's 3e8 parameters differed by up to 2.7e-5 on every mesh
# and route (m/sqrt(v) is sensitive where m cancels), at the tolerance;
# at 1e-4 rounding moves them by a tenth of that, while a wrong gradient
# still moves an update by O(lr), 5x the tolerance
MESH_F32 = dict(TRAIN, batch_size=2, grad_acc_steps=1, dtype="float32", use_flash=True,
                grad_clip=0.05, learning_rate=1e-4)
MESH_PARAM_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_training.py's mesh tolerance
SP_PROCS_TRAIN_LAYERS = 4  # tiny-llama-1.1b's layers in the sp Trainer over two processes
PROCS_BF16_STEPS = 2  # the bf16 sp and ep runs over two processes (the first a warm-up)
PROCS_F32_STEPS = 2  # the float32 sp and ep runs over two processes, checked in the pair


def mesh_params_close(phase, label, got, want) -> float:
    """Fail unless every leaf of `got` is within `MESH_PARAM_TOL` of
    `want`'s (both standard-layout trees); returns the largest |diff|."""
    import torch

    from mdi_llm_tpu_torch.models.transformer import tree_leaves

    worst, bad = 0.0, 0
    rtol, atol = MESH_PARAM_TOL["rtol"], MESH_PARAM_TOL["atol"]
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        d = (a.detach().float() - b.detach().float()).abs()
        worst = max(worst, d.max().item())
        bad += int((d > atol + rtol * b.detach().float().abs()).sum().item())
    if bad:
        fail(phase, f"{label}: {bad} parameters outside rtol {rtol} atol {atol} of the "
             f"unmeshed Trainer's (largest |diff| {worst:.3e})")
    return worst


def phase_mesh_train(k2, k3, k4, card):
    """The meshed Trainer on the card (the module docstring, phase 29)."""
    import math

    import numpy as np
    import torch

    from mdi_llm_tpu_torch.config import Config
    from mdi_llm_tpu_torch.models import transformer
    from mdi_llm_tpu_torch.parallel.mesh import make_mesh
    from mdi_llm_tpu_torch.training import Trainer, TrainingConfig
    from mdi_llm_tpu_torch.utils import data_loader

    # K3 and K4 at the tp ranks' geometries, the training shape
    for tp in TP_SIZES:
        rows = flash_bwd_case_ms(4, 2048, 32 // tp, 4 // tp, 64, card, phase="mesh-train")
        k3["max_abs_err"] = max(k3.get("max_abs_err", 0.0), rows["dq"][5])
        k4["max_abs_err"] = max(k4.get("max_abs_err", 0.0), rows["dkv"][5])

    cfg = Config.from_name(TINY_LLAMA, n_layer=MESH_TRAIN_LAYERS)
    tc = TrainingConfig(**TRAIN)
    L, a, B, T = cfg.n_layer, tc.grad_acc_steps, tc.batch_size, tc.block_size
    data = synthetic_tokens(1 << 22, seed=10137)
    rng = np.random.default_rng(10139)

    def batches():
        xs = np.empty((a, B, T), np.int32)
        ys = np.empty_like(xs)
        for m in range(a):
            xs[m], ys[m] = data_loader.get_batch(data, B, T, rng)
        return xs, ys

    fixed = [batches() for _ in range(4)]  # warm-up + 3 counted steps, the same for every run
    results, totals = {}, {"K2": 0, "K3": 0, "K4": 0}
    for axes in (None,) + MESH_TRAIN_MESHES:
        label = "none" if axes is None else ",".join(f"{k}={v}" for k, v in axes.items())
        mesh = None if axes is None else make_mesh(axes, [DEVICE])
        free()
        tr = Trainer(cfg, tc, mesh=mesh, device=DEVICE)
        if not tr.use_flash:
            fail("mesh-train", f"{label}: the flash route is off")
        tr.train_step(*fixed[0])  # warm-up: not counted
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        per_step = a * L * (1 if axes is None else math.prod(axes.values()))
        steps = []
        for xs, ys in fixed[1:]:
            torch.cuda.synchronize()
            reset_flash_counts()
            runs0 = tr.layer_runs
            t0 = time.perf_counter()
            loss = tr.train_step(xs, ys)
            dt = time.perf_counter() - t0
            got = flash_counts()
            runs = tr.layer_runs - runs0
            if axes is not None and runs != per_step:
                fail("mesh-train", f"{label}: {runs} layer runs in a step; want {per_step}")
            want = {"K2": 2 * per_step, "K3": per_step, "K4": per_step, "plain": 0}
            if got != want:
                fail("mesh-train", f"{label}: one optimizer step launched {got}; want {want}")
            if not math.isfinite(loss):
                fail("mesh-train", f"{label}: step loss {loss}")
            if axes is not None:
                for kk in totals:
                    totals[kk] += got[kk]
            steps.append((dt, loss))
        results[label] = {
            "step_s": [round(d, 4) for d, _ in steps],
            "step_s_median": round(float(np.median([d for d, _ in steps])), 4),
            "step_losses": [round(x, 4) for _, x in steps],
            "peak_memory_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3),
            "launches_per_step": want}
        del tr
    base = results["none"]["step_s_median"]
    for label, r in results.items():
        r["over_unmeshed"] = round(r["step_s_median"] / base, 4)
    print("mesh-train: " + json.dumps({
        "card": card, "model": TINY_LLAMA, "layers": L, "batch": B, "block": T,
        "grad_acc": a, "dtype": tc.dtype, "remat": tc.remat, "runs": results}), flush=True)
    k2.setdefault("paths", {})["mesh-train"] = totals["K2"]
    k3.setdefault("paths", {})["mesh-train"] = totals["K3"]
    k4.setdefault("paths", {})["mesh-train"] = totals["K4"]
    free()

    # float32 at 4 layers: every mesh's params after three steps equal the
    # unmeshed Trainer's on the same attention route, K2-K4 or their plain
    # versions
    cfg4 = Config.from_name(TINY_LLAMA, n_layer=MESH_F32_LAYERS)
    tc4 = TrainingConfig(**MESH_F32)
    params = transformer.init_params(cfg4, 10137, dtype=torch.float32, device=DEVICE)
    steps4 = [tuple(b[None] for b in data_loader.get_batch(data, 2, T, rng)) for _ in range(3)]
    grad_diffs = {}
    for route, flash_kernel in (("kernels", None), ("plain", False)):
        ref = Trainer(cfg4, tc4, params=params, device=DEVICE, flash_kernel=flash_kernel)
        want_grads = first_step_grads(ref)
        want_losses = [ref.train_step(x, y) for x, y in steps4]
        for axes in MESH_TRAIN_MESHES:
            label = f"float32 {axes} {route}"
            tr = Trainer(cfg4, tc4, mesh=make_mesh(axes, [DEVICE]), params=params,
                         device=DEVICE, flash_kernel=flash_kernel)
            got_grads = first_step_grads(tr)
            reset_flash_counts()
            losses = [tr.train_step(x, y) for x, y in steps4]
            grad_diffs[label] = grad_diff(tr._standard(got_grads[0]), want_grads[0])
            got = flash_counts()
            runs = tr.layer_runs
            counts = ({"K2": 2 * runs, "K3": runs, "K4": runs, "plain": 0} if flash_kernel is None
                      else {"K2": 0, "K3": 0, "K4": 0, "plain": 4 * runs})
            if got != counts:
                fail("mesh-train", f"{label}: launched {got}; want {counts}")
            rel = max(abs(g - w) / abs(w) for g, w in zip(losses, want_losses))
            if not rel <= 1e-5:
                fail("mesh-train", f"{label}: losses {losses} against the unmeshed "
                     f"{want_losses} (rel {rel:.2e})")
            worst = mesh_params_close("mesh-train", label, tr._standard_params(), ref.params)
            print(f"mesh-train: {label}, {MESH_F32_LAYERS} layers x {cfg4.n_embd}, B=2 "
                  f"T={T}, lr {tc4.learning_rate}, grad_clip {tc4.grad_clip}: params after 3 "
                  f"steps within {MESH_PARAM_TOL} of the unmeshed Trainer's on the same "
                  f"route (largest |diff| {worst:.3e}), losses rel {rel:.2e}; launches "
                  f"{got}; first-step gradients before the optimizer: {grad_diffs[label]}",
                  flush=True)
            del tr
            free()
        del ref
        free()
    print("mesh-train: gradients " + json.dumps({"card": card, "dtype": "float32",
                                                   "layers": MESH_F32_LAYERS,
                                                   "per_mesh": grad_diffs}), flush=True)
    del params
    free()


def first_step_grads(tr, device=None) -> list:
    """Make `tr`'s optimizer keep a copy of the float32 gradients its first
    step is handed (summed over the micro-batches and the dp group,
    averaged, not yet clipped) in the list it returns, on `device`
    (default: theirs)."""
    kept = []
    update = tr.optimizer.update

    def keeping(params, grads, norm=None):
        if not kept:
            kept.append([g.detach().to(device or g.device, copy=True) for g in grads])
        return update(params, grads, norm=norm)

    tr.optimizer.update = keeping
    return kept


def grad_diff(got, want) -> dict:
    """The largest |got - want| over every gradient leaf, and over every
    leaf that largest difference relative to the leaf's largest |want|."""
    worst = rel = 0.0
    for a, b in zip(got, want):
        d = (a.float() - b.float()).abs().max().item()
        worst = max(worst, d)
        rel = max(rel, d / max(b.float().abs().max().item(), 1e-30))
    return {"max_abs_diff": worst, "max_rel_to_leaf_max": rel}


def train_report(argv, keep=None) -> dict:
    """`cli.train argv` in this process, its Trainer reported: step
    seconds, the gradient all-reduce's seconds (`Trainer.grad_sync_s`),
    the dp, pp, sp and ep groups' calls and bytes (and host seconds),
    layer runs, K2-K4 launches and peak memory.  The checkpoint is not
    written (what a job writes is held on the CPU).  With `keep` (a dict),
    where the CLI would save, the whole tree's first-step gradients (before
    the clip) and its parameters in the standard layout go into `keep`
    ("grads", "params": leaf lists, on `keep.get("device")`, default the
    card) on process 0 of a job, or in one process."""
    from unittest import mock

    import torch

    from mdi_llm_tpu_torch import training
    from mdi_llm_tpu_torch.cli import train as train_cli
    from mdi_llm_tpu_torch.models import transformer

    steps = []
    step = training.Trainer.train_step

    def timed(self, xs, ys):
        if keep is not None and not hasattr(self, "_first_grads"):
            self._first_grads = first_step_grads(self, keep.get("device", DEVICE))
        t0 = time.perf_counter()
        loss = step(self, xs, ys)  # a host float: synchronized
        steps.append(time.perf_counter() - t0)
        return loss

    def saved(self, out_dir):
        if keep is None:
            return out_dir
        to = keep.get("device", DEVICE)
        lead = self.mesh is None or self.mesh.process_id == 0
        for key, leaves in (("grads", self._first_grads[0]),
                            ("params", transformer.tree_leaves(self.params))):
            if key not in keep.get("kept", ("grads", "params")):
                continue
            if self.layout is not None and self.layout.split_stages:
                whole = self._whole(leaves, torch.float32 if key == "grads" else None)
                got = None if whole is None else [x.detach().to(to) for x in whole]
            else:  # leaf by leaf (collective): only process 0 keeps each
                got = []
                for i, x in enumerate(leaves):
                    x = self._gathered(i, x) if self.layout is not None else x
                    if lead:
                        got.append(x.detach().to(to))
                    del x
            if lead:
                keep[key] = got
        return out_dir

    reset_flash_counts()
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(training.Trainer, "train_step", timed), \
            mock.patch.object(training.Trainer, "save", saved):
        _, tr = train_cli.main(argv)
    lay = tr.layout
    rec = {"step_s": steps, "layer_runs": tr.layer_runs, **flash_counts(),
           "grad_allreduce_s": tr.grad_sync_s,
           "stages": list(lay.stages) if lay is not None else None,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
           "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2**30}
    for kind in ("dp", "pp", "sp", "ep", "tp"):
        g = getattr(lay, f"{kind}_group") if lay is not None else None
        rec.update({f"{kind}_group_calls": g.calls if g else None,
                    f"{kind}_group_bytes": g.bytes if g else None,
                    f"{kind}_group_s": g.seconds if g else None})
    del tr
    free()
    return rec


def kept_close(got, want) -> dict:
    """How far `train_report`'s kept gradients and parameters `got` lie
    from `want`'s, leaf by leaf on the card: per kind, the largest |diff|
    and how many elements lie outside `MESH_PARAM_TOL`."""
    out = {}
    rtol, atol = MESH_PARAM_TOL["rtol"], MESH_PARAM_TOL["atol"]
    for key in [k for k in ("grads", "params") if k in want]:
        worst, bad = 0.0, 0
        if len(got[key]) != len(want[key]):
            return {key: {"leaves": (len(got[key]), len(want[key]))}}
        for a, b in zip(got[key], want[key]):
            b = b.float().to(DEVICE)
            d = (a.float().to(DEVICE) - b).abs()
            worst = max(worst, d.max().item())
            bad += int((d > atol + rtol * b.abs()).sum().item())
        out[key] = {"max_abs_diff": worst, "outside_tol": bad}
    return out


class Headroom:
    """The least free card memory (`torch.cuda.mem_get_info`: every
    process's use of the card) and the least available host memory
    (MemAvailable) seen while a job's processes run, read every 50 ms on a
    thread of this process."""

    def __init__(self):
        import threading

        self.card_gib = self.host_gib = float("inf")
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)

    def _watch(self):
        import torch

        while not self._stop.is_set():
            self.card_gib = min(self.card_gib, torch.cuda.mem_get_info()[0] / 2**30)
            try:
                for ln in Path("/proc/meminfo").read_text().splitlines():
                    if ln.startswith("MemAvailable:"):
                        self.host_gib = min(self.host_gib, int(ln.split()[1]) / 2**20)
            except OSError:
                pass
            self._stop.wait(0.05)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()

    def row(self) -> dict:
        return {"min_card_free_gib": round(self.card_gib, 3),
                "min_host_available_gib": round(self.host_gib, 3)}


# one process of a job per `cli.train` run, in one interpreter, reporting
# each run's stdout and `train_report` record as `train_report` gives them;
# a run {"argv": ..., "check": argv[, "kept": ("grads",)]} keeps its
# gradients and parameters (or what "kept" names, on the job's `keep`
# device), and its process 0 then runs `check` alone (the run in one
# process) and adds how far they lie from that run's (`kept_close`) and its
# report: it starts once every other process has left the run (a marker
# file each in the job's `sync` directory), and they start the next run
# once it is done (its marker)
MESH_PROCS_ENTRY = (
    "import contextlib, io, json, os, sys, time\n"
    "import chip_smoke\n"
    "job = json.loads(sys.argv[1])\n"
    "me, sync, keep = job['process_id'], job['sync'], job['keep']\n"
    "def mark(name):\n"
    "    open(os.path.join(sync, name), 'w').close()\n"
    "def wait(name):\n"
    "    while not os.path.exists(os.path.join(sync, name)):\n"
    "        time.sleep(0.1)\n"
    "for j, run in enumerate(job['runs']):\n"
    "    argv, check = (run, None) if isinstance(run, list) else (run['argv'], run['check'])\n"
    "    what = None if check is None else run.get('kept', ['grads', 'params'])\n"
    "    out, kept = io.StringIO(), ({'device': keep, 'kept': what} if check else None)\n"
    "    t0 = time.perf_counter()\n"
    "    with contextlib.redirect_stdout(out):\n"
    "        rec = chip_smoke.train_report(argv + ['--process-id', str(me)], kept)\n"
    "    rec['wall_s'] = time.perf_counter() - t0\n"
    "    if check and me:  # its card memory freed: process 0 checks alone\n"
    "        mark(f'{j}.{me}')\n"
    "        wait(f'{j}.done')\n"
    "    elif check:\n"
    "        for i in range(1, job['n']):\n"
    "            wait(f'{j}.{i}')\n"
    "        one, ref = io.StringIO(), {'device': keep, 'kept': what}\n"
    "        with contextlib.redirect_stdout(one):\n"
    "            rec['one_process'] = [None, chip_smoke.train_report(check, ref)]\n"
    "        rec['one_process'][0] = one.getvalue()\n"
    "        rec['check'] = chip_smoke.kept_close(kept, ref)\n"
    "        del kept, ref\n"
    "        chip_smoke.free()\n"
    "        mark(f'{j}.done')\n"
    "    print('MESH-PROCS ' + json.dumps([out.getvalue(), rec]), file=sys.stderr, flush=True)\n"
)


ALLOC_CONF = "expandable_segments:True"


def mesh_jobs(phase, runs, n=2, timeout=600, keep=None):
    """Each `cli.train` argv of `runs` (or {"argv", "check"}: the entry's
    check against one process, its gradients and parameters kept on
    `keep`, default `DEVICE`) as processes 0..n-1 of one job on a free localhost port, the
    runs in turn inside the same n processes (through `MESH_PROCS_ENTRY`),
    all of them under one time limit; returns, per run, [(stdout, the
    `train_report` record)] in process order.  The processes' allocators
    grow their segments in place (`ALLOC_CONF`): the caching allocator's
    fixed segments held 74.1 GiB of the card for four dp=2,ep=2 processes'
    63.5 GiB of tensors, and left 0.6 GiB free beside this process."""
    import os

    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root))
    env.setdefault("PYTORCH_CUDA_ALLOC_CONF", ALLOC_CONF)

    def joined(argv):
        return argv + ["--coordinator", f"127.0.0.1:{free_port()}", "--num-processes", str(n)]

    runs = [joined(r) if isinstance(r, list) else dict(r, argv=joined(r["argv"]))
            for r in runs]
    sync = tempfile.TemporaryDirectory()
    procs = [subprocess.Popen(
        [sys.executable, "-c", MESH_PROCS_ENTRY,
         json.dumps({"process_id": i, "n": n, "sync": sync.name, "keep": keep or DEVICE,
                     "runs": runs})],
        cwd=str(root), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(n)]
    per_proc, failed, errs = [], [], [None] * n
    deadline = time.monotonic() + timeout
    room = Headroom()
    try:
        with room:
            for i, p in enumerate(procs):
                try:
                    errs[i] = p.communicate(timeout=max(1.0, deadline - time.monotonic()))[1]
                except subprocess.TimeoutExpired:
                    break
        # every process's record and error: a peer's death shows as a lost
        # link, a hang as a process past the time limit
        for i, p in enumerate(procs):
            late = errs[i] is None
            if late:
                p.kill()
                errs[i] = p.communicate()[1]
            e = errs[i]
            recs = [json.loads(ln[len("MESH-PROCS "):]) for ln in e.splitlines()
                    if ln.startswith("MESH-PROCS ")]
            run = runs[len(recs)] if len(recs) < len(runs) else None
            if late or p.returncode:
                why = f"ran past {timeout} s" if late else f"exited {p.returncode}"
                failed.append(f"process {i} of {n} {why} in run {len(recs)} ({run}):\n"
                              f"{e[-2000:]}")
            elif len(recs) != len(runs):
                failed.append(f"process {i} of {n} reported {len(recs)} of {len(runs)} runs")
            per_proc.append([tuple(r) for r in recs])
        if failed:
            fail(phase, f"headroom {json.dumps(room.row())}\n" + "\n".join(failed))
        print(f"{phase}: {n} processes, {len(runs)} runs: headroom "
              f"{json.dumps(room.row())}", flush=True)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        sync.cleanup()
    return [[per_proc[i][j] for i in range(n)] for j in range(len(runs))]


def mesh_one(argv):
    """`cli.train argv` in this process: (stdout, the `train_report`
    record)."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rec = train_report(argv)
    return out.getvalue(), rec


def phase_mesh_train_procs(k2, k3, k4, card):
    """The train CLI over two processes sharing the card (the module
    docstring, phase 30): every run of the phase in one pair of
    processes, after the one-process runs they are held against."""
    with tempfile.TemporaryDirectory() as tmp:
        ds = Path(tmp) / "data"
        ds.mkdir()
        synthetic_tokens(1 << 21, seed=21).tofile(ds / "train.bin")
        synthetic_tokens(1 << 18, seed=22).tofile(ds / "val.bin")
        base = ["--model", TINY_LLAMA, "--dataset", str(ds), "--ckpt", str(Path(tmp) / "ck"),
                "--block-size", str(TRAIN["block_size"]), "--warmup-iters", "0",
                "--learning-rate", "1e-3", "--lr-decay-iters", "100", "--log-interval", "1",
                "--ckpt-interval", "1000", "--eval-iters", "1", "--max-iters",
                str(MESH_PROCS_STEPS),
                "--use-flash", "on", "--device", DEVICE]

        def loss_lines(stdout):
            return [json.loads(ln)["loss"] for ln in stdout.splitlines()
                    if ln.startswith("{") and "loss" in ln]

        # float32 at 4 layers: the two processes' loss lines are one
        # process's; bf16 at full depth: step seconds, the gradient
        # all-reduce's (dp) and the hop's (pp); dp 2, then GPipe stages
        # over the two processes: pp 2 (one stage each) and pp 2 x tp 2
        # (one stage and its whole tp group each)
        meshes = ("dp=2", "pp=2", "pp=2,tp=2")
        f32 = {m: base + ["--mesh", m, "--dtype", "float32", "--override",
                          f"n_layer={MESH_F32_LAYERS}", "--batch-size", "2", "--grad-clip", "0.05"]
               for m in meshes}
        bf16 = {m: base + ["--mesh", m, "--dtype", "bfloat16", "--batch-size",
                           str(TRAIN["batch_size"]), "--grad-acc-steps",
                           str(TRAIN["grad_acc_steps"])] for m in meshes}
        bf16["dp=2"] += ["--override", f"n_layer={MESH_PROCS_DP_LAYERS}"]
        for m in ("pp=2", "pp=2,tp=2"):
            bf16[m] += ["--override", f"n_layer={MESH_PROCS_PP_LAYERS}"]
        order = [(m, part) for m in meshes for part in (f32, bf16)]
        ones = {(m, id(part)): mesh_one(part[m]) for m, part in order}
        # sp and ep over the two processes (`train_procs_runs`): the bf16
        # runs beside one process's, the float32 ones checked in the pair
        new_bf16, new_f32 = train_procs_runs(base)
        # (the ep layouts beside tp and dp hold their steps to one process's
        # in float32, their check runs)
        new_ones = {label: mesh_one(argv) for label, (argv, _) in new_bf16.items()
                    if label in ("sp=2", "dp=1,ep=2")}
        all_jobs = mesh_jobs(
            "mesh-train-procs", [part[m] for m, part in order]
            + [argv for argv, _ in new_bf16.values()]
            + [{"argv": argv, "check": argv, **({"kept": CHECKED[label]} if label in CHECKED
                                                 else {})}
               for label, (argv, _) in new_f32.items()], timeout=900)
        jobs = dict(zip(((m, id(part)) for m, part in order), all_jobs))
        for kernel, key in ((k2, "K2"), (k3, "K3"), (k4, "K4")):
            kernel.setdefault("paths", {})["mesh-train-procs"] = sum(
                rec[key] for job in all_jobs for _, rec in job)
        new_jobs = all_jobs[len(order):]

        for mesh in meshes:
            tp = 2 if "tp" in mesh else 1
            one_out, _one = ones[(mesh, id(f32))]
            job = jobs[(mesh, id(f32))]
            want, got = loss_lines(one_out), loss_lines(job[0][0])
            rel = max((abs(g - w) / abs(w) for g, w in zip(got, want)), default=float("inf"))
            if len(got) != MESH_PROCS_STEPS or len(want) != MESH_PROCS_STEPS \
                    or loss_lines(job[1][0]) or not rel <= 1e-5:
                fail("mesh-train-procs", f"float32 {mesh}: loss lines {got} over two processes "
                     f"(process 1 printed {loss_lines(job[1][0])}) against one process's "
                     f"{want} (rel {rel})")
            how = ("gloo, staged through pinned host memory" if mesh == "dp=2"
                   else "one stage each, the hop a gloo send/recv")
            print(f"mesh-train-procs: float32 {MESH_F32_LAYERS} layers, {mesh} over 2 processes "
                  f"({how}): loss lines {got} against one process's {want} (rel {rel:.2e})",
                  flush=True)

            one_out, one = ones[(mesh, id(bf16))]
            job = jobs[(mesh, id(bf16))]
            for i, (out, rec) in enumerate(job):
                runs = rec["layer_runs"]
                if mesh == "dp=2":
                    ok = runs == MESH_PROCS_STEPS * TRAIN["grad_acc_steps"] * MESH_PROCS_DP_LAYERS
                else:  # steps x grad-acc x the 2 micro-batches x a stage's layers
                    ok = (runs == MESH_PROCS_STEPS * TRAIN["grad_acc_steps"] * 2
                          * (MESH_PROCS_PP_LAYERS // 2) * tp
                          and rec["stages"] == [i, i + 1])
                if not ok or (rec["K2"], rec["K3"], rec["K4"]) != (2 * runs, runs, runs):
                    fail("mesh-train-procs", f"{mesh} process {i}: stages {rec['stages']}, "
                         f"layer runs {runs}, launches {rec['K2']}/{rec['K3']}/{rec['K4']}")
            losses = loss_lines(job[0][0])
            if len(losses) != MESH_PROCS_STEPS or not all(
                    map(lambda v: v == v and abs(v) < 1e9, losses)):
                fail("mesh-train-procs", f"bf16 {mesh} loss lines {losses}")
            if mesh == "dp=2":
                one_keys = ("step_s", "peak_memory_gib")
                two_keys = ("wall_s", "step_s", "grad_allreduce_s", "dp_group_calls",
                            "dp_group_bytes", "peak_memory_gib")
            else:
                one_keys = ("step_s", "peak_memory_gib", "layer_runs")
                two_keys = ("wall_s", "stages", "step_s", "layer_runs", "K2", "K3", "K4",
                            "pp_group_calls", "pp_group_bytes", "pp_group_s", "peak_memory_gib")
            print("mesh-train-procs: " + json.dumps({
                "card": card, "model": TINY_LLAMA,
                "layers": MESH_PROCS_DP_LAYERS if mesh == "dp=2" else MESH_PROCS_PP_LAYERS,
                "dtype": "bfloat16",
                "mesh": mesh, "batch": TRAIN["batch_size"], "block": TRAIN["block_size"],
                "grad_acc": TRAIN["grad_acc_steps"], "losses": losses,
                "one_process": {**{k: one[k] for k in one_keys}, "losses": loss_lines(one_out)},
                "two_processes": [{k: rec[k] for k in two_keys} for _, rec in job]}),
                flush=True)
        train_procs_checked(new_bf16, new_f32, new_ones, new_jobs, loss_lines, card)


def train_procs_runs(base):
    """The mesh-train-procs phase's sp and ep runs over two processes, one
    rank each, and its ep runs beside tp and dp: ({label: (`cli.train`
    argv, layer runs each process makes)} in bf16, the same in float32).  sp 2 through K2-K4 at tiny-llama-1.1b's
    full width, 4 layers, B=1, T=8192 (each process's rank runs P of the
    ring's P^2 blocks a layer); ep 2 at moe-train's shape (Mixtral's
    widths, 2 layers, B=1, T=2048: each process holds 4 of the 8 experts
    and runs the layers once over the batch).  float32: sp 2 at 4 layers
    and T=2048, ep 2 at 1 layer (its float32 AdamW state of a Mixtral
    layer is 34 GB in one process), `PROCS_F32_STEPS` steps, clipping
    engaged, learning rate 1e-4 (`MESH_F32`'s reason)."""
    one = ["--batch-size", "1", "--grad-acc-steps", "1"]
    sp = base + one + ["--mesh", "sp=2", "--override", f"n_layer={SP_PROCS_TRAIN_LAYERS}"]
    ep = base + one + ["--model", MIXTRAL, "--mesh", "dp=1,ep=2", "--block-size",
                       str(MOE_TRAIN["block_size"])]
    f32 = ["--dtype", "float32", "--grad-clip", "0.05", "--learning-rate", "1e-4",
           "--max-iters", str(PROCS_F32_STEPS)]
    steps = ["--max-iters", str(PROCS_BF16_STEPS)]
    bf16 = {"sp=2": (sp + steps + ["--dtype", "bfloat16", "--block-size", "8192"],
                     PROCS_BF16_STEPS * SP_PROCS_TRAIN_LAYERS * 2),
            "dp=1,ep=2": (ep + steps + ["--dtype", "bfloat16", "--override",
                                        f"n_layer={MOE_TRAIN_LAYERS}"],
                          PROCS_BF16_STEPS * MOE_TRAIN_LAYERS)}
    f32s = {"sp=2": (sp + f32 + ["--block-size", "2048"],
                     PROCS_F32_STEPS * SP_PROCS_TRAIN_LAYERS * 2),
            "dp=1,ep=2": (ep + f32 + ["--override", "n_layer=1"], PROCS_F32_STEPS)}
    # ep beside tp and dp: (mesh, batch, bf16 layers, (dp, tp) positions a
    # process holds); a process of tp=2,ep=2 holds every expert, so its
    # bf16 run keeps one layer (two such processes' AdamW state of two
    # would not fit the card beside each other)
    for mesh, batch, layers, held in (("ep=2,tp=2", 1, MOE_TRAIN_LAYERS, 2),
                                      ("tp=2,ep=2", 1, 1, 1),
                                      ("ep=2,dp=2", 2, MOE_TRAIN_LAYERS, 2)):
        argv = base + ["--batch-size", str(batch), "--grad-acc-steps", "1", "--model", MIXTRAL,
                       "--mesh", mesh, "--block-size", str(MOE_TRAIN["block_size"])]
        bf16[mesh] = (argv + steps + ["--dtype", "bfloat16", "--override", f"n_layer={layers}"],
                      PROCS_BF16_STEPS * layers * held)
        # float32 at `EP_F32_CUT`, as the four-process phase's dp=2,ep=2
        # (tp=2,ep=2's processes each hold every expert)
        f32s[mesh] = (argv + f32 + ["--override", "n_layer=1"] + EP_F32_CUT,
                      PROCS_F32_STEPS * held)
    return bf16, f32s


def train_procs_checked(bf16, f32, ones, jobs, loss_lines, card,
                        phase="mesh-train-procs") -> None:
    """The runs of `train_procs_runs` (or the four-process phase's) over
    their processes (`jobs` in that order: the bf16 runs, then the float32
    ones) against one process's: in bf16 each process's layer runs, K2
    twice a run (remat), K3 and K4 once, finite losses, the processes past
    the first printing none, the step seconds beside one process's
    (`ones`); in float32 the loss lines within 1e-5 (relative) of the same
    run in one process, its first-step gradients and its parameters after
    its steps within `MESH_PARAM_TOL` (`kept_close`, on process 0)."""
    keys = ("wall_s", "step_s", "layer_runs", "K2", "K3", "K4", "sp_group_calls", "sp_group_bytes",
            "sp_group_s", "ep_group_calls", "ep_group_bytes", "ep_group_s", "tp_group_calls",
            "tp_group_bytes", "tp_group_s", "dp_group_calls", "dp_group_bytes",
            "grad_allreduce_s", "peak_memory_gib", "peak_reserved_gib")
    for (mesh, (argv, runs)), job in zip(bf16.items(), jobs):
        for i, (out, rec) in enumerate(job):
            if (rec["layer_runs"], rec["K2"], rec["K3"], rec["K4"]) != (runs, 2 * runs, runs,
                                                                         runs):
                fail(phase, f"bf16 {mesh} process {i}: layer runs "
                     f"{rec['layer_runs']} (want {runs}), launches {rec['K2']}/{rec['K3']}/"
                     f"{rec['K4']}")
        losses = loss_lines(job[0][0])
        others = [loss_lines(out) for out, _ in job[1:]]
        if len(losses) != PROCS_BF16_STEPS or not all(v == v and abs(v) < 1e9 for v in losses) \
                or any(others):
            fail(phase, f"bf16 {mesh}: loss lines {losses} (the other processes printed "
                 f"{others})")
        row = {"card": card, "mesh": mesh, "argv": " ".join(argv), "dtype": "bfloat16",
               "losses": losses, "processes": [{k: rec[k] for k in keys} for _, rec in job]}
        if mesh in ones:
            one_out, one = ones[mesh]
            row["one_process"] = {"losses": loss_lines(one_out), **{k: one.get(k) for k in keys}}
            # the steps past each run's first (the first pays the warm-up)
            row["step_over_one"] = (statistics.median(job[0][1]["step_s"][1:])
                                    / statistics.median(one["step_s"][1:]))
        print(f"{phase}: " + json.dumps(row), flush=True)
    for (mesh, (argv, runs)), job in zip(f32.items(), jobs[len(bf16):]):
        out0, rec0 = job[0]
        one_out, one = rec0["one_process"]
        got, want = loss_lines(out0), loss_lines(one_out)
        rel = max((abs(g - w) / abs(w) for g, w in zip(got, want)), default=float("inf"))
        check = rec0["check"]
        bad = [k for k in ("grads", "params") if (k in check or k == "grads")
               and check.get(k, {}).get("outside_tol") != 0]
        others = [loss_lines(out) for out, _ in job[1:]]
        if len(got) != PROCS_F32_STEPS or len(want) != PROCS_F32_STEPS or any(others) \
                or not rel <= 1e-5 or bad:
            fail(phase, f"float32 {mesh}: loss lines {got} over {len(job)} processes "
                 f"against one process's {want} (rel {rel}); gradients and parameters "
                 f"{check}")
        for i, (_, rec) in enumerate(job):
            if (rec["layer_runs"], rec["K2"], rec["K3"], rec["K4"]) != (runs, 2 * runs, runs,
                                                                         runs):
                fail(phase, f"float32 {mesh} process {i}: layer runs "
                     f"{rec['layer_runs']} (want {runs}), launches {rec['K2']}/{rec['K3']}/"
                     f"{rec['K4']}")
        print(f"{phase}: " + json.dumps({
            "card": card, "mesh": mesh, "argv": " ".join(argv), "dtype": "float32",
            "losses": got, "one_process_losses": want, "loss_rel": rel,
            "first_step_grads_and_params": check, "tolerance": MESH_PARAM_TOL,
            "step_s": rec0["step_s"], "one_process_step_s": one["step_s"],
            "step_over_one": rec0["step_s"][-1] / one["step_s"][-1],
            "grad_allreduce_s": rec0["grad_allreduce_s"],
            "group_calls": {k: rec0[f"{k}_group_calls"] for k in ("tp", "ep", "dp", "sp")},
            "wall_s": [rec["wall_s"] for _, rec in job],
            "peak_memory_gib": [rec["peak_memory_gib"] for _, rec in job],
            "peak_reserved_gib": [rec["peak_reserved_gib"] for _, rec in job]}), flush=True)


# the float32 runs whose processes would not fit the card beside each
# other take Mixtral's widths with the vocabulary cut to `EP_F32_VOCAB` ids,
# T=1024 and capacity factor `EP_CF` (the slots each expert computes):
# tp=2,ep=2 over two processes (each its float32 params, AdamW moments,
# accumulated and fresh gradients of a layer with every expert beside its
# activations: 34.3 GiB allocated when the second ran out of the card at
# 32000 ids) and dp=2,ep=2 over four (half the experts each)
EP_F32_VOCAB = 4096
# the float32 checks of the ep layouts beside tp and dp hold the losses and
# the first-step gradients to one process's: their parameters after the
# steps are the CPU tests' (gathering a Mixtral layer's experts' float32
# parameters through host memory as well doubles a check's seconds)
CHECKED = {"ep=2,tp=2": ("grads",), "tp=2,ep=2": ("grads",), "ep=2,dp=2": ("grads",),
           "dp=2,ep=2": ("grads",)}
EP_F32_CUT = ["--override", f"vocab_size={EP_F32_VOCAB}", "--override",
              f"padded_vocab_size={EP_F32_VOCAB}", "--block-size", "1024",
              "--moe-capacity-factor", str(EP_CF)]


def phase_mesh_train_quad(k2, k3, k4, card):
    """The train CLI over four processes sharing the card (the module
    docstring, phase 30a): every run in one set of four processes, the
    float32 ones held to one process's run."""
    with tempfile.TemporaryDirectory() as tmp:
        ds = Path(tmp) / "data"
        ds.mkdir()
        synthetic_tokens(1 << 21, seed=21).tofile(ds / "train.bin")
        synthetic_tokens(1 << 18, seed=22).tofile(ds / "val.bin")
        base = ["--dataset", str(ds), "--ckpt", str(Path(tmp) / "ck"), "--warmup-iters", "0",
                "--learning-rate", "1e-3", "--lr-decay-iters", "100", "--log-interval", "1",
                "--ckpt-interval", "1000", "--eval-iters", "1", "--use-flash", "on",
                "--device", DEVICE, "--grad-acc-steps", "1"]
        ep = base + ["--model", MIXTRAL, "--mesh", "dp=2,ep=2", "--batch-size", "2",
                     "--block-size", str(MOE_TRAIN["block_size"]), "--override", "n_layer=1"]
        sp = base + ["--model", TINY_LLAMA, "--mesh", "dp=1,sp=2,tp=2", "--batch-size", "1",
                     "--override", f"n_layer={SP_PROCS_TRAIN_LAYERS}"]
        f32 = ["--dtype", "float32", "--grad-clip", "0.05", "--learning-rate", "1e-4",
               "--max-iters", str(PROCS_F32_STEPS)]
        steps = ["--max-iters", str(PROCS_BF16_STEPS), "--dtype", "bfloat16"]
        # layer runs per process: dp x ep one dp row's layer a step (at
        # Mixtral's widths, one layer: four processes' bf16 state of two
        # would not fit the card); sp x tp its rank's P = 2 ring blocks a layer
        bf16 = {"dp=2,ep=2": (ep + steps, PROCS_BF16_STEPS),
                "dp=1,sp=2,tp=2": (sp + steps + ["--block-size", "8192"],
                                   PROCS_BF16_STEPS * SP_PROCS_TRAIN_LAYERS * 2)}
        f32s = {"dp=2,ep=2": (ep + f32 + EP_F32_CUT, PROCS_F32_STEPS),
                "dp=1,sp=2,tp=2": (sp + f32 + ["--block-size", "2048"],
                                   PROCS_F32_STEPS * SP_PROCS_TRAIN_LAYERS * 2)}
        # the steps held to one process's in float32 (the check runs); the
        # float32 runs' kept trees in host memory: four processes' state
        # leaves no room for them on the card
        jobs = mesh_jobs("mesh-train-quad", [argv for argv, _ in bf16.values()]
                         + [{"argv": argv, "check": argv,
                             **({"kept": CHECKED[mesh]} if mesh in CHECKED else {})}
                            for mesh, (argv, _) in f32s.items()],
                         n=4, timeout=420, keep="cpu")
        for kernel, key in ((k2, "K2"), (k3, "K3"), (k4, "K4")):
            kernel.setdefault("paths", {})["mesh-train-quad"] = sum(
                rec[key] for job in jobs for _, rec in job)

        def loss_lines(stdout):
            return [json.loads(ln)["loss"] for ln in stdout.splitlines()
                    if ln.startswith("{") and "loss" in ln]

        train_procs_checked(bf16, f32s, {}, jobs, loss_lines, card, phase="mesh-train-quad")
    # K2-K4 alone at the sp x tp ring's blocks: tiny-llama's tp 2 rank (16
    # heads, 2 groups, hs 64), T=4096 a rank, with the LSE (K2) and its
    # cotangent (K3, K4), the diagonal block causal and a rotated one not
    sp_k2_shapes(k2, card, B=1, T=4096, phase="mesh-train-quad", H=16, G=2, hs=64)
    for causal in (True, False):
        rows = flash_bwd_case_ms(1, 4096, 16, 2, 64, card, phase="mesh-train-quad",
                                 causal=causal, dlse=True)
        k3["max_abs_err"] = max(k3.get("max_abs_err", 0.0), rows["dq"][5])
        k4["max_abs_err"] = max(k4.get("max_abs_err", 0.0), rows["dkv"][5])


PP_TP = (2, [10, 12], 2)  # stages, the reference table's split of 22, tp ranks per stage
PP_TP_SERVE = (2, [2, 4], 2)  # pp-tp-serve's: the split of its `RING_SERVE_LAYERS`


def phase_pp_tp_serve(k1, card):
    """pp x tp serving on the card (the module docstring, phase 31)."""
    import torch

    from mdi_llm_tpu_torch.cli.serve import synthetic_trace
    from mdi_llm_tpu_torch.generation import Generator
    from mdi_llm_tpu_torch.parallel.mesh import pipeline_mesh

    S, split, tp = PP_TP_SERVE
    total = 0
    for kv, extra in (("bfloat16", []), ("int8", ["--kv-dtype", "int8"])):
        argv = PP_SERVE_ARGV + extra
        single_line, single_gen, want = single_reference("pp-tp-serve", argv)
        torch.cuda.reset_peak_memory_stats()
        line, launches, merges, engine, got = pp_served("pp-tp-serve", argv, S, split, tp=tp)
        peak = torch.cuda.max_memory_allocated() / 2**30
        total += launches
        if merges != launches:
            fail("pp-tp-serve", f"{kv}: {merges} merge launches for {launches} K1 launches "
                 f"(want one merge per launch: {tp} x {engine.stage_layer_runs})")
        if line["host_syncs"] != single_line["host_syncs"]:
            fail("pp-tp-serve", f"{kv}: host_syncs {line['host_syncs']}, the single "
                 f"engine's {single_line['host_syncs']}")
        n_div = bf16_divergences("pp-tp-serve", single_gen, got, want,
                                 f"--pp {S} --tp {tp} {kv} pool vs the single engine")
        print("pp-tp-serve: " + json.dumps({
            "card": card, "pp": S, "tp": tp, "split": split, "kv_dtype": kv, "requests": 16,
            "new_tokens": RING_SERVE_TOKENS, "tokens_per_s": line["tokens_per_s"],
            "single_tokens_per_s": single_line["tokens_per_s"],
            "pp_tp_over_single": line["tokens_per_s"] / single_line["tokens_per_s"],
            "wall_s": line["wall_s"], "single_wall_s": single_line["wall_s"],
            "preflight_s": {k: v["seconds"] for k, v in engine.preflight.items()},
            "n_chips": line["n_chips"], "devices": line["devices"],
            "pipeline": line["pipeline"], "mixed_steps": line["mixed_steps"],
            "forward_calls": engine.forward_calls, "host_syncs": line["host_syncs"],
            "stage_layer_runs": engine.stage_layer_runs, "k1_launches": launches,
            "k1_merge_launches": merges, "graph_captures": line["graph_captures"],
            "graph_replays": line["graph_replays"], "capture_s": line["capture_s"],
            "single_capture_s": single_line["capture_s"], "bf16_divergences": n_div,
            "peak_memory_gib": peak}), flush=True)
        del engine, got, single_gen, want
        free()
    k1.setdefault("paths", {})["pp-tp-serve"] = total
    SINGLE_REFS.clear()  # the last phase held against them
    free()

    # float32 at 4 layers: the pp x tp ring through K1 gives the single
    # engine's streams through K1 and its own through the plain route
    gen = tiny_llama_generator(PP_SERVE_F32_LAYERS, torch.float32)
    trace = synthetic_trace(4, gen.cfg.vocab_size, 2048, 16)
    want, wstats = _serve_trace(gen.serve(block_size=16, max_batch=8), trace)
    ppgen = Generator(gen.cfg, gen.params, max_seq_length=2048, device=gen.device,
                      mesh=pipeline_mesh(S, [gen.device], tp=tp))
    streams = {}
    for route, use_kernel in (("kernel", None), ("plain", False)):
        reset_k1_counts()
        engine = ppgen.serve(block_size=16, max_batch=8, use_kernel=use_kernel)
        streams[route], stats = _serve_trace(engine, trace)
        launched, plain = k1_counts()
        want_launches = tp * engine.stage_layer_runs if route == "kernel" else 0
        if launched != want_launches or (plain > 0) != (route == "plain"):
            fail("pp-tp-serve", f"float32 {route}: K1 launched {launched} times (want "
                 f"{want_launches}), the plain route {plain} times")
        if stats.host_syncs != wstats.host_syncs:
            fail("pp-tp-serve", f"float32 {route}: host_syncs {stats.host_syncs}, the single "
                 f"engine's {wstats.host_syncs}")
        del engine
    divergence_ok("pp-tp-serve", gen, streams["kernel"], want,
                  f"float32 pp {S} x tp {tp} (K1) vs single engine (K1)")
    divergence_ok("pp-tp-serve", gen, streams["kernel"], streams["plain"],
                  f"float32 pp {S} x tp {tp} K1 vs plain route")
    print(f"pp-tp-serve: float32 {PP_SERVE_F32_LAYERS} layers x {gen.cfg.n_embd}, pp {S} x tp "
          f"{tp}: {sum(streams['kernel'][r] == want[r] for r in want)} of {len(trace)} greedy "
          f"streams identical to the single engine's, "
          f"{sum(streams['kernel'][r] == streams['plain'][r] for r in want)} to the plain "
          f"route's; host_syncs {wstats.host_syncs} as the single engine's", flush=True)
    del ppgen, gen
    free()


def phase_pipeline_tp(card):
    """The pipe x tp ring on the card (the module docstring, phase 32)."""
    import contextlib
    import io

    import torch

    from mdi_llm_tpu_torch.cli import starter as starter_cli
    from mdi_llm_tpu_torch.config import Config
    from mdi_llm_tpu_torch.generation import Generator
    from mdi_llm_tpu_torch.models import transformer
    from mdi_llm_tpu_torch.parallel.nodes import parse_nodes_config
    from mdi_llm_tpu_torch.parallel.pipeline import PipelineEngine

    S, split, tp = PP_TP
    root = Path(__file__).resolve().parent
    nodes = parse_nodes_config(root / PIPE_CONFIG)
    n = S * PIPE_M
    rows, streams = {}, {}
    for ranks in (tp, 1):
        args = starter_cli.build_parser().parse_args(
            ["--model", TINY_LLAMA, "--dtype", "bfloat16", "--seed", "10137", "--greedy",
             "--n-samples", str(n), "--n-tokens", str(PIPE_TOKENS), "--sequence-length",
             "2048", "--pipeline-stages", str(S), "--samples-per-slot", str(PIPE_M),
             "--tp-devices", str(ranks), "--nodes-config", str(root / PIPE_CONFIG)])
        before = all_kernel_counts()
        torch.cuda.reset_peak_memory_stats()
        with contextlib.redirect_stdout(io.StringIO()):
            outs, stats, _seconds, eng = starter_cli.run_node(args, nodes, 0)
        cfg = eng.cfg
        prompts = [o[:8] for o in outs]
        ring_budget_ok("pipeline-tp", f"tp={ranks}", outs, prompts, PIPE_TOKENS,
                       cfg.padded_vocab_size)
        if eng.counts != split or eng.tp != ranks or cfg.n_layer != 22:
            fail("pipeline-tp", f"tp={ranks}: split {eng.counts}, tp {eng.tp}, want {split} "
                 f"of 22 layers, tp {ranks}")
        outs2, st2 = eng.generate(prompts, PIPE_TOKENS, temperature=0.0)
        torch.cuda.synchronize()
        graphs = eng.graph_stats()
        if outs2 != outs or st2.captures or not graphs["replays"]:
            fail("pipeline-tp", f"tp={ranks}: second call streams equal {outs2 == outs}, "
                 f"captures {st2.captures}, replays {graphs['replays']}")
        after = all_kernel_counts()
        if after != before:
            fail("pipeline-tp", f"tp={ranks}: the ring launched a kernel: {before} -> {after}")
        streams[ranks] = outs
        rows[f"tp={ranks}"] = {
            "tokens_per_s": st2.tokens_per_s, "decode_s": st2.decode_s,
            "prefill_s": st2.prefill_s, "first_call_tokens_per_s": stats.tokens_per_s,
            "rotations": st2.rotations, "graph_captures": graphs["captures"],
            "graph_replays": graphs["replays"], "capture_s": graphs["capture_s"],
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
            "kernel_launches": {k: after[k] - before[k] for k in after}}
        del eng
        free()
    params = transformer.init_params(cfg, 10137, dtype=torch.bfloat16, device="cuda")
    gen = Generator(cfg, params, max_seq_length=2048, device="cuda")
    gen.generate(prompts, PIPE_TOKENS, temperature=0.0)  # capture outside the timing
    want, gst = gen.generate(prompts, PIPE_TOKENS, temperature=0.0)
    torch.cuda.synchronize()
    n_div = bf16_divergences("pipeline-tp", gen, dict(enumerate(streams[tp])),
                             dict(enumerate(want)), f"S={S} tp={tp} ring vs generate")
    print("pipeline-tp: " + json.dumps({
        "card": card, "S": S, "split": split, "tp": tp, "M": PIPE_M, "samples": n,
        "new_tokens": PIPE_TOKENS, "dtype": "bfloat16", "rings": rows,
        "tp_ring_over_tp1_ring": rows[f"tp={tp}"]["tokens_per_s"] / rows["tp=1"]["tokens_per_s"],
        "generate_batch": n, "generate_tokens_per_s": gst.tokens_per_s,
        "tp_ring_over_generate": rows[f"tp={tp}"]["tokens_per_s"] / gst.tokens_per_s,
        "bytes_per_hop": hop_bytes(PIPE_M, cfg.n_embd, 2),
        "bf16_streams_diverging_from_generate": n_div}), flush=True)
    del gen, params
    free()

    # float32 at 4 layers: the pipe x tp ring's streams are generate's
    cfg = Config.from_name(TINY_LLAMA, n_layer=PIPE_F32_LAYERS)
    params = transformer.init_params(cfg, 10137, dtype=torch.float32, device="cuda")
    gen = Generator(cfg, params, max_seq_length=2048, device="cuda")
    prompts = long_prompts([8 + 3 * i for i in range(S * PIPE_M)], cfg.vocab_size, seed=S)
    want, _ = gen.generate(prompts, 32, temperature=0.0)
    before = all_kernel_counts()
    eng = PipelineEngine(cfg, params, n_stages=S, tp=tp, samples_per_slot=PIPE_M,
                         max_seq_length=2048, device="cuda")
    got, _ = eng.generate(prompts, 32, temperature=0.0)
    torch.cuda.synchronize()
    if all_kernel_counts() != before or not eng.graph_stats()["replays"]:
        fail("pipeline-tp", f"float32: kernel counts {before} -> {all_kernel_counts()}, "
             f"replays {eng.graph_stats()['replays']}")
    divergence_ok("pipeline-tp", gen, dict(enumerate(got)), dict(enumerate(want)),
                  f"float32 S={S} tp={tp} ring vs generate")
    print(f"pipeline-tp: float32 {PIPE_F32_LAYERS} layers S={S} tp={tp}: {len(prompts)} "
          f"streams of 32 tokens, {sum(a == b for a, b in zip(got, want))}/{len(want)} "
          "identical to generate's; no kernel launched", flush=True)
    del gen, eng, params
    free()


INFER_LENS = (1100, 1370, 1650, 1900)  # the generate phase's prompts
INFER_F32 = ["--model", TINY_LLAMA, "--dtype", "float32", "--override",
             f"n_layer={TP_F32_LAYERS}", "--seed", "10137", "--n-samples", "4",
             "--n-tokens", "32", "--sequence-length", "2048", "--device", DEVICE]
INFER_BF16_TOKENS = 16  # decode over two processes is gloo calls, one per product (32
# before PR 18's cuts of the whole run's time)
INFER_BF16_LAYERS = 6  # tiny-llama's layers there (22, then 12, before the cuts for the
# run's time)
INFER_BF16 = ["--model", TINY_LLAMA, "--dtype", "bfloat16", "--seed", "10137",
              "--override", f"n_layer={INFER_BF16_LAYERS}",
              "--n-samples", "4", "--n-tokens", str(INFER_BF16_TOKENS),
              "--sequence-length", "2048", "--chunk", "16", "--greedy", "--device", DEVICE]
# one process of two-process jobs, running the runs of its JSON spec in
# turn, each a job of its own on its own port: a `cli.sample` run
# (`sample_report`), with "api" a `Generator` on a mesh over the two
# processes (`api_report`), or with "node" a `cli.starter` (process 0) or
# `cli.secondary` (process 1) run on the nodes config "node", its stdout
# and stderr kept
INFER_PROCS_ENTRY = (
    "import contextlib, io, json, sys\n"
    "import chip_smoke\n"
    "from mdi_llm_tpu_torch.cli import secondary, starter\n"
    "spec = json.loads(sys.argv[1])\n"
    "me = spec['process_id']\n"
    "recs = []\n"
    "for r in spec['runs']:\n"
    "    if 'api' in r:\n"
    "        recs.append(chip_smoke.api_report(r['api'], me, 2, r['port']))\n"
    "        continue\n"
    "    if 'node' not in r:\n"
    "        recs.append(chip_smoke.sample_report(r['argv'] + [\n"
    "            '--coordinator', '127.0.0.1:%d' % r['port'], '--num-processes', '2',\n"
    "            '--process-id', str(me)], r['long']))\n"
    "        continue\n"
    "    out, err = io.StringIO(), io.StringIO()\n"
    "    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):\n"
    "        if me == 0:\n"
    "            starter.main(r['argv'] + ['--nodes-config', r['node']])\n"
    "        else:\n"
    "            secondary.main(r['argv'] + ['--nodes-config', r['node'], '0'])\n"
    "    recs.append({'stdout': out.getvalue(), 'stderr': err.getvalue()})\n"
    "print('INFER-PROCS ' + json.dumps(recs), file=sys.stderr, flush=True)\n"
)


def sample_report(argv, long=False) -> dict:
    """`cli.sample argv` (its `run`) in this process, K2's counts set to 0
    just before and read just after; with `long` its prompts are the
    generate phase's four long prompts (or, `long` a pair [lengths,
    seed], `long_prompts` of those) instead of the CLI's 8-token draws.
    Returns the streams, stats, K2 launches and plain calls, the peak
    memory, and the processes' group's collective calls, bytes and host
    seconds (None in one process)."""
    import contextlib
    from unittest import mock

    import torch

    from mdi_llm_tpu_torch.cli import sample as sample_cli

    args = sample_cli.build_parser().parse_args(argv)
    patch = contextlib.nullcontext()
    if long:
        lens, seed = (INFER_LENS, 10137) if long is True else long
        patch = mock.patch.object(sample_cli, "prompt_ids_for", lambda a, cfg, t, st: (
            long_prompts(lens, cfg.vocab_size, seed), ()))
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    reset_flash_counts()
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with patch:
        prompt_ids, outs, stats, gen, _tok, seconds = sample_cli.run(args)
    sync()
    wall = time.perf_counter() - t0
    counts = flash_counts()
    # the processes' groups: the tp (or sp) group, and an ep Generator's
    groups = [g for g in (gen._group, getattr(gen, "_ep_group", None)) if g is not None]
    g = groups[0] if groups else None
    rec = {"prompt_lens": [len(p) for p in prompt_ids], "outs": outs, "seconds": seconds,
           "wall_s": wall,
           "peak_memory_gib": (torch.cuda.max_memory_allocated() / 2**30
                               if torch.cuda.is_available() else None),
           "tokens_per_s": stats.tokens_per_s, "decode_s": stats.decode_s,
           "prefill_s": stats.prefill_s, "captures": stats.captures,
           "capture_s": stats.capture_s, "tokens_generated": stats.tokens_generated,
           "K2": counts["K2"], "plain": counts["plain"],
           "collective_calls": sum(g.calls for g in groups) if g else None,
           "collective_bytes": sum(g.bytes for g in groups) if g else None,
           "collective_s": sum(g.seconds for g in groups) if g else None}
    del gen
    free()
    return rec


def sample_pair(phase, runs, timeout=400) -> list:
    """`runs` ([{"argv": [...], "long": bool}], or {"argv": [...], "node":
    a nodes config path} for a starter/secondary job) through
    `INFER_PROCS_ENTRY` as processes 0 and 1 of a job per run, each
    process under its own time limit; returns each process's list of
    records (`sample_report`'s, or the node run's stdout and stderr)."""
    import os

    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root))
    runs = [dict(r, port=free_port()) for r in runs]
    procs = [subprocess.Popen(
        [sys.executable, "-c", INFER_PROCS_ENTRY,
         json.dumps({"process_id": i, "runs": runs})],
        cwd=str(root), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    recs = []
    room = Headroom()
    try:
        with room:
            for i, p in enumerate(procs):
                try:
                    _o, e = p.communicate(timeout=timeout)
                except subprocess.TimeoutExpired:
                    fail(phase, f"process {i} ran past {timeout} s; headroom "
                         f"{json.dumps(room.row())}")
                if p.returncode:
                    fail(phase, f"process {i} exited {p.returncode}; headroom "
                         f"{json.dumps(room.row())}:\n{e[-3000:]}")
                line = [ln for ln in e.splitlines() if ln.startswith("INFER-PROCS ")]
                recs.append(json.loads(line[-1][len("INFER-PROCS "):]))
        print(f"{phase}: 2 processes, {len(runs)} runs: headroom {json.dumps(room.row())}",
              flush=True)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return recs


def phase_inference_procs(k2, card):
    """Inference over two processes sharing the card (the module
    docstring, phase 33)."""
    import torch

    from mdi_llm_tpu_torch.config import Config
    from mdi_llm_tpu_torch.generation import Generator
    from mdi_llm_tpu_torch.models import transformer
    from mdi_llm_tpu_torch.parallel.pipeline import PipelineEngine

    tp2 = ["--tp-devices", "2"]
    sampled = ["--temperature", "0.8", "--top-k", "20"]
    # (b)'s job: cli.starter / cli.secondary with --tp-devices 2 (each
    # process one stage of two ranks), float32
    node_base = ["--model", TINY_LLAMA, "--seed", "10137", "--greedy", "--sequence-length",
                 "2048", "--samples-per-slot", str(PIPE_M), "--n-samples", str(2 * PIPE_M),
                 "--dtype", "float32", "--override", f"n_layer={PIPE_F32_LAYERS}",
                 "--n-tokens", "32", "--tp-devices", "2"]
    node_tmp = tempfile.TemporaryDirectory()
    node_cfg = Path(node_tmp.name) / "tp-f32.json"
    node_cfg.write_text(json.dumps({"nodes": {
        "starter": {"addr": "127.0.0.1", "communication": {"port": free_port()}},
        "secondary": [{"addr": "127.0.0.1", "communication": {"port": free_port()}}]}}))
    # (a) cli.sample --coordinator --tp-devices 2: float32 greedy and
    # sampled at 4 layers, bf16 greedy at 22 layers on the long prompts;
    # then (b)'s job in the same two processes
    # (c) sp and ep over the two processes, one rank each, in the same two
    # processes: `procs_runs`'s bf16 runs (K2 in each process's ring
    # prefill) and float32 runs held to one process's streams
    new_runs = procs_runs()
    # (d) the Generator's ep layouts beside tp and dp over the two
    # processes, through the API, in the same two processes (`api_runs`)
    api = api_runs()
    with node_tmp:
        p0, p1 = sample_pair("inference-procs", [
            {"argv": INFER_F32 + tp2 + ["--greedy"], "long": False},
            {"argv": INFER_F32 + tp2 + sampled, "long": False},
            {"argv": INFER_BF16 + tp2, "long": True},
            {"argv": node_base, "node": str(node_cfg)}]
            + [{"argv": argv, "long": long} for argv, long, _ in new_runs.values()]
            + [{"api": run} for run, _ in api.values()],
            timeout=600)
    one = sample_report(INFER_F32 + tp2 + ["--greedy"])
    cfg4 = Config.from_name(TINY_LLAMA, n_layer=TP_F32_LAYERS)
    params4 = transformer.init_params(cfg4, 10137, dtype=torch.float32, device=DEVICE)
    gen4 = Generator(cfg4, params4, max_seq_length=2048, device=DEVICE)
    for i, recs in enumerate((p0, p1)):
        divergence_ok("inference-procs", gen4, dict(enumerate(recs[0]["outs"])),
                      dict(enumerate(one["outs"])),
                      f"float32 process {i} of 2 vs one process, tp 2")
    if p0[1]["outs"] != p1[1]["outs"] or p0[1]["outs"] == p0[0]["outs"]:
        fail("inference-procs", "float32 at temperature 0.8: the two processes drew "
             f"different tokens ({p0[1]['outs']} vs {p1[1]['outs']}), or greedy ones")
    if p0[2]["outs"] != p1[2]["outs"]:
        fail("inference-procs", "bf16: the two processes printed different streams")
    for i, recs in enumerate((p0, p1)):
        r = recs[2]
        if r["K2"] != INFER_BF16_LAYERS or r["plain"] or r["prompt_lens"] != list(INFER_LENS):
            fail("inference-procs", f"bf16 process {i}: K2 launches {r['K2']} (want "
                 f"{INFER_BF16_LAYERS}: one rank x {INFER_BF16_LAYERS} layers), plain calls "
                 f"{r['plain']}, prompts {r['prompt_lens']}")
        ring_budget_ok("inference-procs", f"bf16 process {i}", r["outs"],
                       long_prompts(INFER_LENS, 32000), INFER_BF16_TOKENS, 32000)
    # the same bf16 run in one process (its decode chunks captured): a
    # first call captures, the second is timed
    sample_report(INFER_BF16 + tp2, long=True)
    single = sample_report(INFER_BF16 + tp2, long=True)
    # printed, not gated: the same sums in the same order, but the one
    # process's decode replays captured graphs
    n_div = sum(a != b for a, b in zip(p0[2]["outs"], single["outs"]))
    k2.setdefault("paths", {})["inference-procs"] = p0[2]["K2"] + p1[2]["K2"] + sum(
        r["K2"] for recs in (p0, p1) for r in recs[4:])

    def row(r):
        return {k: r[k] for k in ("tokens_per_s", "decode_s", "prefill_s", "captures",
                                  "capture_s", "K2", "collective_calls",
                                  "collective_bytes", "collective_s")}

    replay_s = single["decode_s"] - single["capture_s"]
    print("inference-procs: " + json.dumps({
        "card": card, "model": TINY_LLAMA, "layers": INFER_BF16_LAYERS, "dtype": "bfloat16",
        "tp": 2,
        "prompt_lens": list(INFER_LENS), "new_tokens": INFER_BF16_TOKENS,
        "two_processes": [row(p0[2]), row(p1[2])], "one_process": row(single),
        "one_process_replay_tokens_per_s": single["tokens_generated"] / replay_s,
        "two_over_one_decode": p0[2]["tokens_per_s"] / (single["tokens_generated"] / replay_s),
        "bf16_streams_differing_from_one_process": n_div,
        "float32_streams_identical": sum(a == b for a, b in zip(p0[0]["outs"], one["outs"])),
        "float32_sampled_equal_across_processes": p0[1]["outs"] == p1[1]["outs"]}),
        flush=True)

    # (b) cli.starter / cli.secondary with --tp-devices 2 (each process one
    # stage of two ranks): float32 streams are the one-process ring's
    out, err, serr = p0[3]["stdout"], p0[3]["stderr"], p1[3]["stderr"]
    got = printed_samples(out)
    prompts = [g[:8] for g in got]
    ring_budget_ok("inference-procs", "starter/secondary float32", got, prompts, 32,
                   cfg4.padded_vocab_size)
    want, _ = PipelineEngine(cfg4, params4, n_stages=2, tp=2, samples_per_slot=PIPE_M,
                             max_seq_length=2048, device=DEVICE).generate(
        prompts, 32, temperature=0.0)
    divergence_ok("inference-procs", gen4, dict(enumerate(got)), dict(enumerate(want)),
                  "float32 starter/secondary (tp 2 per stage) vs the one-process ring")
    lines = [ring_line(err), ring_line(serr)]
    if [(ln["stages"], ln["tp"], ln["backend"]) for ln in lines] != [
            ([0], 2, "gloo"), ([1], 2, "gloo")]:
        fail("inference-procs", f"starter/secondary ring lines {lines}")
    print("inference-procs: starter/secondary " + json.dumps({
        "card": card, "dtype": "float32", "layers": PIPE_F32_LAYERS, "S": 2, "tp": 2,
        "M": PIPE_M, "samples": len(got), "identical_to_one_process": sum(
            a == b for a, b in zip(got, want)), "starter_ring": lines[0],
        "secondary_ring": lines[1]}), flush=True)
    del gen4, params4
    free()
    n = 4 + len(new_runs)
    procs_runs_checked(new_runs, p0[4:n], p1[4:n], card)
    api_runs_checked(api, p0[n:], p1[n:], card)


def procs_runs() -> dict:
    """{label: (`cli.sample` argv, its prompts for `sample_report`, K2
    launches each process must make)} of the inference-procs phase's sp
    and ep runs over two processes: sp 2 through K2 (`--sp-flash`) at
    Llama-3-8B's widths on the sp phase's two prompts (local chunks of
    4096: each process launches K2 for its rank's two blocks a layer),
    ep 2 at Mixtral's widths on the generate phase's four prompts of
    1100-1900 tokens (each process draws only its 4 of the 8 experts; the
    prefill's dispatch crosses the processes at its full length, its
    attention through K2 once a layer in each process), and float32 runs
    of both at 4 layers, ep's on the CLI's four 8-token prompts (the
    dense route: no K2), exact and at a capacity factor that drops
    assignments."""
    sp = ["--model", SP_MODEL, "--seed", "10137", "--sequence-length",
          str(SP_WIDTHS["block_size"]), "--greedy", "--device", DEVICE, "--sp-devices", "2",
          "--sp-flash"]
    ep = ["--model", MIXTRAL, "--seed", "10137", "--sequence-length", "2048", "--greedy",
          "--device", DEVICE, "--ep-devices", "2", "--n-samples", "4", "--n-tokens",
          str(EP_PROCS_TOKENS)]
    sp_prompts = [list(SP_PROMPTS), 34]
    return {
        "sp-bf16": (sp + ["--override", f"n_layer={SP_LAYERS}", "--dtype", "bfloat16",
                          "--n-tokens", str(SP_TOKENS)], sp_prompts, 2 * SP_LAYERS),
        "sp-f32": (sp + ["--override", f"n_layer={SP_F32_LAYERS}", "--dtype", "float32",
                         "--n-tokens", "16"], sp_prompts, 2 * SP_F32_LAYERS),
        "ep-bf16": (ep + ["--override", f"n_layer={EP_PROCS_LAYERS}", "--dtype", "bfloat16"],
                    True, EP_PROCS_LAYERS),
        "ep-f32": (ep + ["--override", f"n_layer={EP_PROCS_F32_LAYERS}", "--dtype", "float32"],
                   False, 0),
        "ep-f32-drop": (ep + ["--override", f"n_layer={EP_PROCS_F32_LAYERS}", "--dtype",
                              "float32", "--moe-capacity-factor", "0.5"], False, 0),
    }


class CliModel:
    """The `cfg` and `params` that a `cli.sample` argv loads (its `--model`
    drawn from `--seed`), loaded at first use: the gap checks of
    `divergence_ok` and `sp_divergences` need them only where two streams
    part."""

    def __init__(self, argv):
        self.argv, self._loaded = argv, None

    def _load(self):
        if self._loaded is None:
            from mdi_llm_tpu_torch.cli import sample as sample_cli
            from mdi_llm_tpu_torch.cli._common import load_model

            cfg, params, _, _ = load_model(sample_cli.build_parser().parse_args(self.argv))
            self._loaded = (cfg, params)
        return self._loaded

    cfg = property(lambda self: self._load()[0])
    params = property(lambda self: self._load()[1])


def procs_runs_checked(runs, recs0, recs1, card) -> None:
    """The inference-procs phase's sp and ep runs over two processes
    (`procs_runs`, records in its order): both processes print the same
    streams, every sample gets its tokens in the vocabulary, each process
    launches K2 as planned and its plain version never; then each is held
    against the same run in one process (`procs_run_report`), run here
    after the pair."""
    from mdi_llm_tpu_torch.config import Config

    for (label, (argv, long, k2_want)), r0, r1 in zip(runs.items(), recs0, recs1):
        if r0["outs"] != r1["outs"]:
            fail("inference-procs", f"{label}: the two processes printed different streams")
        n_new = int(argv[argv.index("--n-tokens") + 1])
        vocab = Config.from_name(argv[argv.index("--model") + 1]).padded_vocab_size
        for i, r in enumerate((r0, r1)):
            if r["K2"] != k2_want or r["plain"]:
                fail("inference-procs", f"{label} process {i}: K2 launches {r['K2']} (want "
                     f"{k2_want}), plain calls {r['plain']}")
            ring_budget_ok("inference-procs", f"{label} process {i}", r["outs"],
                           [o[:n] for o, n in zip(r["outs"], r["prompt_lens"])], n_new, vocab)
        procs_run_report("inference-procs", label, argv, r0, r1, sample_report(argv, long),
                         CliModel(argv), card)
        free()


def procs_run_report(phase, label, argv, r0, r1, one, model, card) -> None:
    """One sp or ep run over two processes (records `r0`, `r1`) against the
    same run in one process (`one`, a `sample_report`-like record): float32
    streams are one process's (`divergence_ok`), bf16 divergences are
    printed with their gaps (`sp_divergences`); prints the seconds beside
    one process's, the collectives' calls, bytes and host seconds, K2
    launches and each process's peak memory."""
    got, want = dict(enumerate(r0["outs"])), dict(enumerate(one["outs"]))
    if "f32" in label:
        divergence_ok(phase, model, got, want, f"{label} over 2 processes vs one process")
        n_div = sum(got[i] != want[i] for i in want)
    else:
        n_div = sp_divergences(phase, model, got, want,
                               f"{label} over 2 processes vs one process")

    def row(r):
        return {k: r.get(k) for k in ("wall_s", "seconds", "prefill_s", "decode_s",
                                      "tokens_per_s", "K2",
                                      "collective_calls", "collective_bytes", "collective_s",
                                      "peak_memory_gib")}

    print(f"{phase}: " + json.dumps({
        "card": card, "run": label, "argv": " ".join(argv),
        "prompt_lens": r0["prompt_lens"], "two_processes": [row(r0), row(r1)],
        "one_process": row(one),
        "seconds_over_one": r0["seconds"] / one["seconds"],
        "streams_differing_from_one_process": n_div}), flush=True)


# the Generator's ep layouts beside tp and dp over two processes (the API:
# the sample CLI's --ep-devices stands alone, as the JAX CLI's)
EP_API_LAYOUTS = {"ep 2 x tp 2": {"ep": 2, "tp": 2}, "tp 2 x ep 2": {"tp": 2, "ep": 2},
                  "ep 2 x dp 2": {"ep": 2, "dp": 2},
                  "ep 2 x dp 2 x tp 2": {"ep": 2, "dp": 2, "tp": 2}}
EP_API_TOKENS = 8  # greedy new tokens of each of their runs
EP_API_F32_LAYERS = 2  # Mixtral's layers in their float32 runs
EP_API_F32_LENS = (9, 13, 7, 11)  # the float32 runs' prompts: the dense route, no K2
EP_API_CF = 0.5  # the capacity factor at which ep 2 x dp 2 drops assignments


def api_runs() -> dict:
    """{label: (an `api_report` run, K2 launches each of two processes must
    make)} of the inference-procs phase's Generator layouts over two
    processes: each of `EP_API_LAYOUTS` at Mixtral's widths,
    `EP_PROCS_LAYERS` (4) bf16 layers on the generate phase's four prompts
    of 1100-1900 tokens (K2 once a layer for every tp rank and dp replica
    a process holds), `EP_API_TOKENS` new tokens, at capacity factor
    `EP_CF` (the long prompts' dispatch buffers through host memory);
    float32 at `EP_API_F32_LAYERS` layers on four short prompts, exact; ep
    2 x dp 2 in float32 at capacity factor `EP_API_CF` (one dispatch over
    both replicas' rows, across the processes)."""
    from mdi_llm_tpu_torch.parallel.mesh import make_mesh

    runs = {}
    for name, axes in EP_API_LAYOUTS.items():
        mesh = make_mesh(axes, ["cpu"], 0, 2)
        ranks = len(mesh.owned()) // len(mesh.held("ep"))  # (dp, tp) positions held
        runs[f"{name} bf16"] = (dict(axes=axes, layers=EP_PROCS_LAYERS, dtype="bfloat16",
                                     lens=list(INFER_LENS), n_new=EP_API_TOKENS, cf=EP_CF),
                                ranks * EP_PROCS_LAYERS)
        runs[f"{name} f32"] = (dict(axes=axes, layers=EP_API_F32_LAYERS, dtype="float32",
                                    lens=list(EP_API_F32_LENS), n_new=EP_API_TOKENS, cf=None), 0)
    runs[f"ep 2 x dp 2 f32 cf {EP_API_CF}"] = (dict(
        runs["ep 2 x dp 2 f32"][0], cf=EP_API_CF), 0)
    return runs


def api_report(run, process_id=0, num_processes=1, port=None, keep=False) -> dict:
    """`Generator(mesh=make_mesh(run["axes"], [DEVICE], process_id,
    num_processes))` at Mixtral's widths and `run`'s layers and dtype, its
    weights drawn from seed 10137 (over processes a process draws only its
    experts), greedy `generate` on `long_prompts(run["lens"])` for
    `run["n_new"]` tokens at capacity factor `run["cf"]`, K2's counts set
    to 0 just before and read just after.  Over processes it joins the job
    on 127.0.0.1:`port` and leaves it after.  Returns the streams, the
    seconds, K2 launches and plain calls, the peak memory and the tp and
    ep groups' calls, bytes and host seconds (and, with `keep`, the
    Generator under "gen")."""
    import torch

    from mdi_llm_tpu_torch.generation import Generator
    from mdi_llm_tpu_torch.models import transformer
    from mdi_llm_tpu_torch.parallel import nodes
    from mdi_llm_tpu_torch.parallel.expert import owned_experts
    from mdi_llm_tpu_torch.parallel.mesh import make_mesh

    if num_processes > 1:
        nodes.init_distributed(nodes.coordinator_config(f"127.0.0.1:{port}", num_processes),
                               process_id, device=DEVICE)
    try:
        cfg = mixtral_config("inference-procs", run["layers"])
        mesh = make_mesh(run["axes"], [DEVICE], process_id, num_processes)
        params = transformer.init_params(cfg, 10137, dtype=getattr(torch, run["dtype"]),
                                         device=DEVICE,
                                         experts=owned_experts(mesh, cfg.n_expert))
        gen = Generator(cfg, params, max_seq_length=2048, device=DEVICE, mesh=mesh,
                        moe_capacity_factor=run["cf"])
        del params
        prompts = long_prompts(run["lens"], cfg.vocab_size)
        torch.cuda.synchronize()
        reset_flash_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        outs, stats = gen.generate(prompts, run["n_new"], temperature=0.0)
        torch.cuda.synchronize()
        rec = {"outs": outs, "prompt_lens": [len(p) for p in prompts],
               "wall_s": time.perf_counter() - t0, "prefill_s": stats.prefill_s,
               "decode_s": stats.decode_s, "captures": stats.captures,
               "capture_s": stats.capture_s, "tokens_generated": stats.tokens_generated,
               "decode_tokens_per_s": stats.tokens_generated / (stats.decode_s
                                                                - stats.capture_s),
               "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
               **flash_counts()}
        for kind, g in (("tp", gen._group), ("ep", gen._ep_group)):
            rec.update({f"{kind}_group_calls": g.calls if g else None,
                        f"{kind}_group_bytes": g.bytes if g else None,
                        f"{kind}_group_s": g.seconds if g else None})
        if keep:
            rec["gen"] = gen
        del gen
        free()
    finally:
        if num_processes > 1:
            nodes.shutdown_distributed()
    return rec


def api_runs_checked(runs, recs0, recs1, card) -> None:
    """The Generator layouts of `api_runs` over two processes (records in
    its order): both processes print the same streams, every sample gets
    its tokens in the vocabulary, each process launches K2 as planned and
    its plain version never; each float32 run against the same run in one
    process on the same mesh, run here after the pair: the streams equal
    (`divergence_ok`), ep 2 x dp 2's at the capacity factor too, and those
    differ from its exact ones (the drops act).  Prints each run's seconds
    and decode tokens/s (the float32 ones beside one process's), the tp
    and ep groups' calls, bytes and host seconds, and each process's peak
    memory."""

    def row(r):
        return {k: r.get(k) for k in (
            "wall_s", "prefill_s", "decode_s", "capture_s", "decode_tokens_per_s", "K2",
            "tp_group_calls", "tp_group_bytes", "tp_group_s", "ep_group_calls",
            "ep_group_bytes", "ep_group_s", "peak_memory_gib")}

    for (label, (run, k2_want)), r0, r1 in zip(runs.items(), recs0, recs1):
        if r0["outs"] != r1["outs"]:
            fail("inference-procs", f"{label}: the two processes printed different streams")
        vocab = mixtral_config("inference-procs", run["layers"]).padded_vocab_size
        for i, r in enumerate((r0, r1)):
            if r["K2"] != k2_want or r["plain"]:
                fail("inference-procs", f"{label} process {i}: K2 launches {r['K2']} (want "
                     f"{k2_want}), plain calls {r['plain']}")
            ring_budget_ok("inference-procs", f"{label} process {i}", r["outs"],
                           [o[:n] for o, n in zip(r["outs"], r["prompt_lens"])],
                           run["n_new"], vocab)
        rec = {"card": card, "run": label, "model": MIXTRAL, "layers": run["layers"],
               "mesh": run["axes"], "capacity_factor": run["cf"],
               "prompt_lens": r0["prompt_lens"], "new_tokens": run["n_new"],
               "two_processes": [row(r0), row(r1)]}
        if "f32" in label:
            one = api_report(run, keep=True)
            got, want = dict(enumerate(r0["outs"])), dict(enumerate(one["outs"]))
            divergence_ok("inference-procs", one.pop("gen"), got, want,
                          f"{label} over 2 processes vs one process")
            if run["cf"] is not None:
                exact = recs0[list(runs).index(label.replace(f" cf {run['cf']}", ""))]
                if exact["outs"] == r0["outs"]:
                    fail("inference-procs", f"{label}: the streams equal the exact "
                         "dispatch's (no drop moved a stream)")
            free()
            rec.update(one_process=row(one),
                       decode_over_one=r0["decode_tokens_per_s"] / one["decode_tokens_per_s"],
                       streams_differing_from_one_process=sum(got[i] != want[i] for i in want))
        print("inference-procs: " + json.dumps(rec), flush=True)


EP_PROCS_LAYERS = 4  # Mixtral's layers in the bf16 ep runs over two processes
EP_PROCS_F32_LAYERS = 2  # and in their float32 runs (4 before the layouts over processes)
EP_PROCS_TOKENS = 8  # new tokens of the ep runs over two processes (16 before the cuts for
# the layouts over processes)
SP_MODEL = "Llama-3-8B"
SP_WIDTHS = dict(n_embd=4096, n_head=32, n_query_groups=8, head_size=128, block_size=8192)
SP_LAYERS = 4  # of Llama-3-8B's 32, for the whole run's time (8 before the layouts over
# processes; PERF.md §4 lists the cuts)
SP_TOKENS = 8  # greedy new tokens per prompt (64, then 32, then 16, before the cuts for the
# whole run's time)
SP_PROMPTS = (8128, 6000)  # one bucket of 8192: local chunks 4096 (sp 2), 2048 (sp 4)
SP_RUNS = ((2, True, 2048), (2, False, 2048), (4, True, 1024))  # P, use_flash, flash_min_len
SP_F32_LAYERS = 4


def sp_ring_inputs(P, T, dtype, seed, B=1, H=32, G=8, hs=128):
    """The ranks' (q, k, v, pos) lists of one ring: P chunks of T tokens."""
    import torch

    q, k, v = flash_inputs(B, P * T, dtype, seed, H=H, G=G, hs=hs)
    pos = torch.arange(P * T, device="cuda").expand(B, P * T)
    return [list(x.chunk(P, dim=2)) for x in (q, k, v)] + [list(pos.chunk(P, dim=1))]


def sp_ring_limits(q, k, v, do, out, lse, dsum, scale, ref, P) -> tuple:
    """Element-wise limits (dQ, dK, dV) on the flash ring's bfloat16
    gradient against `ref`, the plain ring's in float32 on the same
    inputs.  The ring's gradient is causal attention's over the whole
    sequence (`out`, `lse`, `dsum` its float32 output, LSE and D): each
    block's dS is that attention's dS on the block's pairs.  Three
    sources of rounding, at bfloat16's u = 2^-8 with a factor 2 of
    headroom:

    - each of the P blocks' K3/K4 as in `flash_bwd_bf16_limits` (which
      takes dO exact): P times that limit;
    - each block's dO (w_b dO, w_b the block's merge weight) and its saved
      output O_b enter K3/K4 rounded to bf16: dP and D move by up to
      2^-8 |dO| |V|^T and 2^-8 rowsum(|dO| |O|), so dS by P times their
      sum, which dQ = scale dS K and dK = scale dS^T Q carry;
    - autograd sums the P blocks' bf16 gradients of a chunk in bf16: P
      roundings of |ref|."""
    import torch

    from mdi_llm_tpu_torch.ops.flash import _bwd_terms

    B, H, T, hs = q.shape
    G = k.shape[1]
    lim_dq, lim_dk, lim_dv = (P * x for x in flash_bwd_bf16_limits(
        q, k, v, do, lse, dsum, scale, True, ref))
    qg, dog, p, _ = _bwd_terms(q.float(), k.float(), v.float(), do.float(), lse, dsum,
                               scale, True)
    og = out.float().reshape(B, G, H // G, T, hs).abs()
    e = torch.einsum("bgrth,bgsh->bgrts", dog.abs(), v.float().abs())
    e.add_((dog.abs() * og).sum(-1)[..., None])
    e.mul_(p).mul_(2.0 ** -7)
    del p, og
    lim_dq += scale * torch.einsum("bgrts,bgsh->bgrth", e, k.float().abs()).reshape(q.shape)
    lim_dk += scale * torch.einsum("bgrts,bgrth->bgsh", e, qg.abs())
    del e
    return tuple(lim + P * 2.0 ** -8 * r.abs() for lim, r in zip((lim_dq, lim_dk, lim_dv), ref))


def sp_ring_grad(k2, k3, k4, card):
    """Ring attention's gradient on the card: P=2 ranks of T=1024, 32
    heads / 8 groups / hs 128, bfloat16.  The flash ring (K2 with its LSE,
    K3 and K4 with the LSE's cotangent) against the plain ring run in
    float32 on the same inputs, within `sp_ring_limits`.  Returns the
    launches of the counted flash run."""
    import torch

    from mdi_llm_tpu_torch.ops.flash import _bwd_terms, flash_attention_plain
    from mdi_llm_tpu_torch.ops.ring_attention import ring_attention

    P, T = 2, 1024
    qs, ks, vs, ps = sp_ring_inputs(P, T, torch.bfloat16, seed=17)
    g = torch.Generator(device="cuda").manual_seed(18)
    co = torch.randn((1, 32, P * T, 128), generator=g, device="cuda").to(torch.bfloat16)

    def grads(dtype, use_flash):
        leaves = [torch.cat(x, dim=2).to(dtype).requires_grad_(True) for x in (qs, ks, vs)]
        out = ring_attention(*(list(x.chunk(P, dim=2)) for x in leaves), ps, ps,
                             use_flash=use_flash)
        (torch.cat(out, dim=2).float() * co.float()).sum().backward()
        return [x.grad for x in leaves]

    grads(torch.bfloat16, True)  # warm-up, not counted
    torch.cuda.synchronize()
    reset_flash_counts()
    got = grads(torch.bfloat16, True)
    torch.cuda.synchronize()
    counts = flash_counts()
    if (counts["K2"], counts["K3"], counts["K4"], counts["plain"]) != (P * P,) * 3 + (0,):
        fail("sp", f"ring gradient launches {counts} (want {P * P} of K2-K4, no plain)")
    ref = grads(torch.float32, False)
    q, k, v = (torch.cat(x, dim=2) for x in (qs, ks, vs))
    scale = 1.0 / 128 ** 0.5
    with torch.no_grad():  # the whole sequence's LSE and D, for the limits
        out, lse = flash_attention_plain(q.float(), k.float(), v.float(), scale, True)
        dsum = (co.float() * out.float()).sum(-1)
    lims = sp_ring_limits(q, k, v, co, out, lse, dsum, scale, ref, P)
    del out, lse, dsum
    worst = {}
    for name, a, r, lim in zip(("dq", "dk", "dv"), got, ref, lims):
        err, ratio = err_ratio(a, r, lim)
        worst[name] = (err, ratio)
        if not ratio <= 1.0:
            fail("sp", f"ring gradient {name}: max|err| {err} at err/limit {ratio}")
    t_flash = cuda_ms(lambda: grads(torch.bfloat16, True), 5)
    t_plain = cuda_ms(lambda: grads(torch.bfloat16, False), 3)
    print("sp: " + json.dumps({
        "card": card, "ring_gradient": {"P": P, "T_per_rank": T, "heads": 32, "groups": 8,
                                        "hs": 128, "dtype": "bfloat16"},
        "err_over_limit": {n: round(r, 4) for n, (_, r) in worst.items()},
        "max_abs_err": {n: e for n, (e, _) in worst.items()},
        "launches": counts, "flash_ring_fwd_bwd_ms": t_flash,
        "plain_ring_fwd_bwd_ms": t_plain}), flush=True)
    k3["max_abs_err"] = max(k3.get("max_abs_err", 0.0), worst["dq"][0])
    k4["max_abs_err"] = max(k4.get("max_abs_err", 0.0), worst["dk"][0], worst["dv"][0])
    del got, ref, lims, q, k, v
    free()
    # K3 and K4 alone at the ring's two block shapes: the diagonal block
    # (causal) and a rotated one (non-causal)
    for causal in (True, False):
        flash_bwd_case_ms(1, T, 32, 8, 128, card, phase="sp", causal=causal)
    return counts


def sp_k2_shapes(k2, card, B=2, T=4096, phase="sp", H=32, G=8, hs=128):
    """K2 against its plain version at an sp 2 ring's two block shapes
    (the main path's: B rows, T per rank, H heads / G groups / hs, bfloat16,
    with the LSE; the sp prefill's B=2 and Llama-3-8B's 32 / 8 / 128 by
    default): causal (the diagonal block) and non-causal (a rotated chunk)."""
    import torch

    from mdi_llm_tpu_torch.ops.flash import flash_attention_lse, flash_attention_plain

    q, k, v = flash_inputs(B, T, torch.bfloat16, seed=41, H=H, G=G, hs=hs)
    for causal in (True, False):
        out, lse = flash_attention_lse(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref, ref_lse = flash_attention_plain(q.float(), k.float(), v.float(), causal=causal)
        err = (out.float() - ref).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        del ref, ref_lse, out, lse
        if not (err <= TOL["bfloat16"] and lse_err <= TOL["bfloat16"]):
            fail(phase, f"K2 ring block causal={causal}: max|err| {err}, lse {lse_err}")
        ms = cuda_ms(lambda: flash_attention_lse(q, k, v, causal=causal), 20)
        plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, causal=causal), 3)
        lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True), 20)
        b_ms, b_by = flash_bound(B, H, G, T, hs, torch.bfloat16, causal, True)
        k2["max_abs_err"] = max(k2.get("max_abs_err", 0.0), err)
        print(f"{phase}: {card}: K2 ring block bfloat16 B={B} T={T} {H}h/{G}g hs={hs} causal={causal} "
              f"with LSE max_abs_err={err:.3e} lse_err={lse_err:.3e} ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={b_ms:.5f} ({b_by})",
              flush=True)
        torch.cuda.empty_cache()
    del q, k, v
    free()


def sp_divergences(phase, gen, got, want, label) -> int:
    """bf16 streams of one model through two routes: for every stream of
    `got` that diverges from `want`'s, print the first divergent position
    and the top-2 logit gap there of `gen`'s bf16 model (a K2 prefill over
    the common prefix) beside two bf16 roundings of the larger logit (the
    `bf16_near_tie` measure, without its float32 copy of an 8B model).
    Returns how many diverge; gates nothing: the sp prefill computes every
    position's K/V through another attention arithmetic than the
    Generator's K2 (a float32 ring, or K2 blocks merged in float32), so
    the histories differ by roundings at every position and no bound on
    one step holds them (`bf16_divergences`); parity is held in float32."""
    import math

    import torch

    from mdi_llm_tpu_torch.models import transformer

    n = 0
    for rid, w in want.items():
        g = got[rid]
        if g == w:
            continue
        n += 1
        i = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), min(len(g), len(w)))
        toks = torch.tensor([w[:i]], device="cuda")
        with torch.no_grad():
            logits = transformer.forward(gen.cfg, gen.params, toks,
                                         torch.zeros(1, dtype=torch.long, device="cuda"),
                                         use_flash=True)
        top = torch.topk(logits[0, -1].float(), 2).values
        gap, top0 = (top[0] - top[1]).item(), top[0].abs().item()
        two = 2 * 2.0 ** (math.floor(math.log2(max(top0, 1e-30))) - 7)
        print(f"{phase}: {label}: {rid} diverges at position {i}; the Generator's bf16 "
              f"top-2 gap there {gap:.5f} (two bf16 roundings: {two:.5f})", flush=True)
        del logits
        torch.cuda.empty_cache()
    return n


def phase_sp(k2, k3, k4, card):
    """Sequence-parallel inference on the card (the module docstring,
    phase 34)."""
    import torch

    from mdi_llm_tpu_torch.config import Config
    from mdi_llm_tpu_torch.generation import Generator
    from mdi_llm_tpu_torch.models import transformer
    from mdi_llm_tpu_torch.ops.flash import flash_attention, flash_attention_plain
    from mdi_llm_tpu_torch.parallel.sp_inference import SPGenerator

    sp_k2_shapes(k2, card)
    k34 = sp_ring_grad(k2, k3, k4, card)
    k3.setdefault("paths", {})["sp"] = k34["K3"]
    k4.setdefault("paths", {})["sp"] = k34["K4"]

    cfg = Config.from_name(SP_MODEL, n_layer=SP_LAYERS)
    got_w = {k: getattr(cfg, k) for k in SP_WIDTHS}
    if got_w != SP_WIDTHS:
        fail("sp", f"{SP_MODEL}'s widths {got_w}, want {SP_WIDTHS}")
    params = transformer.init_params(cfg, 10137, dtype=torch.bfloat16, device="cuda")
    prompts = long_prompts(SP_PROMPTS, cfg.vocab_size, seed=34)
    new = SP_TOKENS
    single = Generator(cfg, params, max_seq_length=cfg.block_size, device="cuda")
    single.generate([[1, 2, 3]] * 2, 4, temperature=0.0)  # warm-up, not counted
    torch.cuda.synchronize()
    flash_attention.launches = flash_attention_plain.calls = 0
    want, wstats = single.generate(prompts, new, temperature=0.0)
    torch.cuda.synchronize()
    if flash_attention.launches != cfg.n_layer or flash_attention_plain.calls:
        fail("sp", f"Generator: K2 launches {flash_attention.launches} (want {cfg.n_layer})")
    single_kv = sum(x.numel() * x.element_size()
                    for c in single._caches.values() for x in c.values())
    want = dict(enumerate(want))
    print("sp: " + json.dumps({
        "card": card, "model": SP_MODEL, "layers": cfg.n_layer, "dtype": "bfloat16",
        "route": "Generator", "prompt_lens": list(SP_PROMPTS), "new_tokens": new,
        "prefill_s": wstats.prefill_s, "decode_tokens_per_s": wstats.tokens_per_s,
        # decode_s holds this run's graph capture: tokens/s without it
        "replay_tokens_per_s": wstats.tokens_generated / (wstats.decode_s - wstats.capture_s),
        "capture_s": wstats.capture_s, "k2_launches": cfg.n_layer, "kv_bytes": single_kv}),
        flush=True)
    total = 0
    for P, use_flash, fml in SP_RUNS:
        sp = SPGenerator(cfg, params, n_devices=P, devices=["cuda"],
                         max_seq_length=cfg.block_size, use_flash=use_flash, flash_min_len=fml)
        sp.generate([[1, 2, 3]] * 2, 4, temperature=0.0)  # warm-up, not counted
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = flash_attention_plain.calls = 0
        outs, stats = sp.generate(prompts, new, temperature=0.0)
        torch.cuda.synchronize()
        launches = flash_attention.launches
        expect = P * P * cfg.n_layer if use_flash else 0
        if launches != expect or flash_attention_plain.calls:
            fail("sp", f"sp {P} use_flash={use_flash}: K2 launches {launches} (want "
                 f"{expect}), plain version calls {flash_attention_plain.calls}")
        total += launches
        for i, (p, o) in enumerate(zip(prompts, outs)):
            if len(o) - len(p) != new or not all(0 <= t < cfg.padded_vocab_size
                                                 for t in o[len(p):]):
                fail("sp", f"sp {P}: sample {i} did not get {new} tokens in the vocabulary")
        Tl, C = sp._geometry(max(SP_PROMPTS), new)
        n_div = sp_divergences("sp", single, dict(enumerate(outs)), want,
                               f"sp {P} use_flash={use_flash} vs the Generator")
        print("sp: " + json.dumps({
            "card": card, "model": SP_MODEL, "dtype": "bfloat16", "sp": P,
            "use_flash": use_flash, "flash_min_len": fml, "local_chunk": Tl,
            "prefill_s": stats.prefill_s, "decode_tokens_per_s": stats.tokens_per_s,
            "k2_launches": launches, "kv_bytes_per_rank": sp.kv_bytes(len(prompts), C),
            "single_kv_bytes": single_kv, "bf16_divergences": n_div,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}), flush=True)
        del sp
        free()
    k2.setdefault("paths", {})["sp"] = total
    del single, params
    free()

    # float32 at 4 layers: every sp stream is the Generator's, on both routes
    cfg = Config.from_name(SP_MODEL, n_layer=SP_F32_LAYERS)
    params = transformer.init_params(cfg, 10137, dtype=torch.float32, device="cuda")
    single = Generator(cfg, params, max_seq_length=cfg.block_size, device="cuda")
    want, _ = single.generate(prompts, 16, temperature=0.0)
    want = dict(enumerate(want))
    for P in (2, 4):
        for use_flash in (True, False):
            sp = SPGenerator(cfg, params, n_devices=P, devices=["cuda"],
                             max_seq_length=cfg.block_size, use_flash=use_flash,
                             flash_min_len=1024)
            got, _ = sp.generate(prompts, 16, temperature=0.0)
            got = dict(enumerate(got))
            divergence_ok("sp", single, got, want, f"float32 sp {P} use_flash={use_flash}")
            print(f"sp: float32 {SP_F32_LAYERS} layers, sp {P} use_flash={use_flash}: "
                  f"{sum(got[i] == want[i] for i in want)} of {len(want)} greedy streams "
                  "identical to the Generator's", flush=True)
            del sp
            free()
    # an SPChatSession of two turns with a Ctrl-C rollback: the ChatSession's
    turns = long_prompts((3000, 700, 40), cfg.vocab_size, seed=35)
    replies = {}
    for name, sess in (("chat", single.chat_session()),
                       ("sp", SPGenerator(cfg, params, n_devices=2, devices=["cuda"],
                                          max_seq_length=cfg.block_size, use_flash=True,
                                          flash_min_len=1024).chat_session())):
        r1 = list(sess.send(turns[0], 12, temperature=0.0))
        pre = sess.history[:]
        it = sess.send(turns[1], 12, temperature=0.0)
        partial = [next(it), next(it)]
        sess.rollback(pre + turns[1] + partial)
        r3 = list(sess.send(turns[2], 12, temperature=0.0))
        replies[name] = (r1, partial, r3, sess.history)
        del sess
    if replies["sp"] != replies["chat"]:
        fail("sp", "float32 SPChatSession (two turns and a rollback) differs from the "
             f"ChatSession: {replies['sp'][:3]} vs {replies['chat'][:3]}")
    print(f"sp: float32 {SP_F32_LAYERS} layers: an SPChatSession over 2 ranks (turns of "
          f"3000 and 40 tokens around a rolled-back 700-token turn) gives the ChatSession's "
          f"replies {replies['sp'][0]} / {replies['sp'][2]}", flush=True)
    del single, params
    free()


SP_TRAIN_LAYERS = 4  # of Llama-3-8B's 32 (8 before the layouts over processes): AdamW's
# float32 state of all 32 (~96 GB) does not fit
SP_TRAIN = dict(TRAIN, batch_size=1, block_size=8192, grad_acc_steps=1, use_flash=True)
SP_TRAIN_MESHES = ({"sp": 2}, {"sp": 4})
SP_TRAIN_F32_MESHES = ({"sp": 2}, {"dp": 1, "sp": 2, "tp": 2})
SP_TRAIN_F32_LAYERS = 4


def phase_sp_train(k2, k3, k4, card):
    """Sequence-parallel training on the card (the module docstring,
    phase 36)."""
    import math

    import numpy as np
    import torch

    from mdi_llm_tpu_torch.config import Config
    from mdi_llm_tpu_torch.models import transformer
    from mdi_llm_tpu_torch.parallel.mesh import make_mesh
    from mdi_llm_tpu_torch.training import Trainer, TrainingConfig
    from mdi_llm_tpu_torch.utils import data_loader

    # K2, K3 and K4 at the sp 2 Trainer's per-rank blocks: B=1, T=4096
    sp_k2_shapes(k2, card, B=1, T=4096, phase="sp-train")
    for causal in (True, False):
        rows = flash_bwd_case_ms(1, 4096, 32, 8, 128, card, phase="sp-train", causal=causal)
        k3["max_abs_err"] = max(k3.get("max_abs_err", 0.0), rows["dq"][5])
        k4["max_abs_err"] = max(k4.get("max_abs_err", 0.0), rows["dkv"][5])

    cfg = Config.from_name(SP_MODEL, n_layer=SP_TRAIN_LAYERS)
    got_w = {k: getattr(cfg, k) for k in SP_WIDTHS}
    if got_w != SP_WIDTHS:
        fail("sp-train", f"{SP_MODEL}'s widths {got_w}")
    tc = TrainingConfig(**SP_TRAIN)
    L, B, T = cfg.n_layer, tc.batch_size, tc.block_size
    data = synthetic_tokens(1 << 22, seed=36)
    rng = np.random.default_rng(37)
    fixed = [tuple(b[None] for b in data_loader.get_batch(data, B, T, rng)) for _ in range(4)]
    results, totals = {}, {"K2": 0, "K3": 0, "K4": 0}
    for axes in (None,) + SP_TRAIN_MESHES:
        label = "none" if axes is None else ",".join(f"{k}={v}" for k, v in axes.items())
        P = 1 if axes is None else axes["sp"]
        free()
        tr = Trainer(cfg, tc, mesh=None if axes is None else make_mesh(axes, [DEVICE]),
                     device=DEVICE)
        tr.train_step(*fixed[0])  # warm-up, not counted
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        per_step = L * P * P
        want = {"K2": 2 * per_step, "K3": per_step, "K4": per_step, "plain": 0}
        steps = []
        for xs, ys in fixed[1:]:
            torch.cuda.synchronize()
            reset_flash_counts()
            runs0 = tr.layer_runs
            t0 = time.perf_counter()
            loss = tr.train_step(xs, ys)
            dt = time.perf_counter() - t0
            got = flash_counts()
            if got != want or (axes is not None and tr.layer_runs - runs0 != per_step):
                fail("sp-train", f"{label}: one optimizer step launched {got} over "
                     f"{tr.layer_runs - runs0} layer runs; want {want}")
            if not math.isfinite(loss):
                fail("sp-train", f"{label}: step loss {loss}")
            if axes is not None:
                for kk in totals:
                    totals[kk] += got[kk]
            steps.append((dt, loss))
        peak = torch.cuda.max_memory_allocated()
        results[label] = {
            "step_s": [round(d, 4) for d, _ in steps],
            "step_s_median": float(np.median([d for d, _ in steps])),
            "step_losses": [round(lo, 4) for _, lo in steps],
            "launches_per_step": want, "peak_memory_gib": peak / 2**30,
            # what a step adds to the params, gradients and moments, and its
            # share per rank (the ranks' activations all live on this card)
            "step_activation_gib": (peak - resident) / 2**30,
            "activation_gib_per_rank": (peak - resident) / P / 2**30}
        del tr
    free()
    for r in results.values():
        r["over_unmeshed"] = r["step_s_median"] / results["none"]["step_s_median"]
    print("sp-train: " + json.dumps({
        "card": card, "model": SP_MODEL, "layers": L, "batch": B, "block": T,
        "dtype": tc.dtype, "remat": tc.remat, "use_flash": True, "runs": results}), flush=True)
    k2.setdefault("paths", {})["sp-train"] = totals["K2"]
    k3.setdefault("paths", {})["sp-train"] = totals["K3"]
    k4.setdefault("paths", {})["sp-train"] = totals["K4"]

    # float32 at 4 layers, tiny-llama-1.1b widths (mesh-train's set-up): the
    # sp Trainers' loss lines, parameters and first-step gradients against
    # the unmeshed Trainer's, every route through K2-K4
    cfg4 = Config.from_name(TINY_LLAMA, n_layer=SP_TRAIN_F32_LAYERS)
    tc4 = TrainingConfig(**MESH_F32)
    params = transformer.init_params(cfg4, 10137, dtype=torch.float32, device=DEVICE)
    steps4 = [tuple(b[None] for b in data_loader.get_batch(data, 2, 2048, rng)) for _ in range(3)]
    ref = Trainer(cfg4, tc4, params=params, device=DEVICE)
    want_grads = first_step_grads(ref)
    want_losses = [ref.train_step(x, y) for x, y in steps4]
    limit = grad_limit(2 * 2048)
    for axes in SP_TRAIN_F32_MESHES:
        label = f"float32 {axes}"
        tr = Trainer(cfg4, tc4, mesh=make_mesh(axes, [DEVICE]), params=params, device=DEVICE)
        got_grads = first_step_grads(tr)
        reset_flash_counts()
        losses = [tr.train_step(x, y) for x, y in steps4]
        runs = tr.layer_runs
        got = flash_counts()
        if got != {"K2": 2 * runs, "K3": runs, "K4": runs, "plain": 0}:
            fail("sp-train", f"{label}: launched {got} over {runs} layer runs")
        rel = max(abs(g - w) / abs(w) for g, w in zip(losses, want_losses))
        if not rel <= 1e-5:
            fail("sp-train", f"{label}: losses {losses} against the unmeshed {want_losses} "
                 f"(rel {rel:.2e})")
        worst = mesh_params_close("sp-train", label, tr._standard_params(), ref.params)
        diff = grad_diff(tr._standard(got_grads[0]), want_grads[0])
        print(f"sp-train: {label}, {SP_TRAIN_F32_LAYERS} layers x {cfg4.n_embd}, B=2 T=2048: "
              f"losses rel {rel:.2e} of the unmeshed Trainer's; params after 3 steps within "
              f"{MESH_PARAM_TOL} (largest |diff| {worst:.3e}); first-step gradients {diff}, "
              f"limit {limit:.3e} of the leaf's largest; launches {got}", flush=True)
        if not diff["max_rel_to_leaf_max"] <= limit:
            fail("sp-train", f"{label}: first-step gradients {diff} (limit {limit})")
        del tr
        free()
    del ref, params
    free()


def phase_preflight(card):
    """The serve CLI's plan audit refusing and downgrading (the module
    docstring, phase 37)."""
    import contextlib
    import io

    import torch

    from mdi_llm_tpu_torch.cli import serve as cli

    argv = SERVE_BASE + ["--synthetic", "2", "--n-tokens", "8", "--hbm-gb", "1"]
    free()
    before = torch.cuda.memory_allocated()
    err = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(err):
            cli.main(argv)
    except SystemExit as e:
        refusal = str(e)
    else:
        fail("preflight", "--hbm-gb 1: the serve was not refused")
    refused_s = time.perf_counter() - t0
    after = torch.cuda.memory_allocated()
    findings = [ln for ln in err.getvalue().splitlines() if "preflight:" in ln]
    if after != before or "preflight refused" not in refusal or not any(
            "error: hbm-over-budget" in ln for ln in findings):
        fail("preflight", f"--hbm-gb 1: allocated {before} -> {after} B, refusal {refusal!r}, "
             f"findings {findings}")
    print(f"preflight: {card}: --hbm-gb 1 refused in {refused_s:.3f} s, "
          f"torch.cuda.memory_allocated() {before} B before and after; {refusal}; "
          + " | ".join(findings), flush=True)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        line = cli.main(argv + ["--no-preflight"])
    warned = [ln for ln in err.getvalue().splitlines() if "error: hbm-over-budget" in ln]
    if not warned or "refused" in err.getvalue() or line["requests"] != 2 \
            or line["tokens_generated"] != 16:
        fail("preflight", f"--no-preflight: warnings {warned}, stats {line}")
    print(f"preflight: --hbm-gb 1 --no-preflight: the finding as a warning, then "
          f"{line['requests']} requests served, {line['tokens_generated']} tokens", flush=True)


DOCTOR_TIMEOUT_S = 900


def phase_doctor(card):
    """The doctor's full staged triage (the module docstring, phase 38)."""
    import os

    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "mdi_llm_tpu_torch.cli.doctor"],
                          cwd=str(root), env=dict(os.environ, PYTHONPATH=str(root)),
                          capture_output=True, text=True, timeout=DOCTOR_TIMEOUT_S)
    wall = time.perf_counter() - t0
    try:
        snap = json.loads(proc.stdout.strip().splitlines()[-1])
    except (IndexError, json.JSONDecodeError):
        fail("doctor", f"exit {proc.returncode}, no snapshot\n{proc.stderr[-3000:]}")
    for r in snap["stages"]:
        print(f"doctor: {r['name']} {r['status']} {r['elapsed_s']:.2f} s "
              f"{json.dumps(r['detail'])}" + (f" error: {r['error']}" if r["error"] else ""),
              flush=True)
    status = {r["name"]: r["status"] for r in snap["stages"]}
    if proc.returncode or not snap["ok"] or status.get("kernels") != "ok" \
            or any(v not in ("ok", "skipped") for v in status.values()):
        fail("doctor", f"exit {proc.returncode}, stages {status}")
    print(f"doctor: {card}: {len(status)} stages in {wall:.1f} s, "
          f"{sum(v == 'ok' for v in status.values())} ok, "
          f"{sum(v == 'skipped' for v in status.values())} skipped", flush=True)


PHASES = ("kernel", "serve", "analysis", "serve-parity", "kernel-q8", "serve-q8", "serve-q8-parity",
          "spec", "spec-parity", "flash", "generate", "generate-parity", "flash-bwd",
          "train", "train-parity", "train-parity-bf16", "ckpt", "chat", "graphs", "server",
          "tier", "quant", "moe", "moe-quant", "moe-train", "ep", "tune", "pipeline",
          "pipeline-nodes", "pp-serve", "tp-serve", "tp-generate", "tools", "mesh-train",
          "mesh-train-procs", "mesh-train-quad", "pp-tp-serve", "pipeline-tp",
          "inference-procs", "sp",
          "sp-train", "preflight", "doctor")


def main(argv=None) -> None:
    import argparse
    import os

    # before torch: this process writes the bytecode every later one reads
    os.environ.setdefault("PYTHONPYCACHEPREFIX",
                          str(Path(__file__).resolve().parent / "build" / "pycache"))
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    sys.pycache_prefix = os.environ["PYTHONPYCACHEPREFIX"]
    sys.dont_write_bytecode = False
    # before any HF library is imported (the ckpt and tools phases): the
    # hub route and `datasets` find what the phases place and fetch nothing
    os.environ["HF_HUB_OFFLINE"] = os.environ["HF_DATASETS_OFFLINE"] = "1"
    import torch

    ap = argparse.ArgumentParser(description="bring-up check of the port on one GPU")
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated phases to run (default: all)")
    only = set(ap.parse_args(argv).only.split(","))
    if not only <= set(PHASES):
        fail("args", f"unknown phases {sorted(only - set(PHASES))}")
    if not torch.cuda.is_available():
        fail("device", "torch.cuda.is_available() is False: this check needs a GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    print(f"device: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    from mdi_llm_tpu_torch import kernels

    t0 = time.perf_counter()
    seconds = kernels.build()
    print(f"build: {json.dumps({k: round(v, 2) for k, v in seconds.items()})} "
          f"({time.perf_counter() - t0:.2f} s wall)", flush=True)
    for name in kernels.SOURCES:
        regs = [ln.strip() for ln in (kernels.BUILD_DIR / f"{name}.log")
                .read_text().splitlines() if "registers" in ln]
        print(f"build: {name} ptxas: {regs[:12]}", flush=True)

    k1 = {
        "name": "K1 ragged_paged_attention",
        "route": "cuda",
        "source": "mdi_llm_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "mdi_llm_tpu/ops/ragged_paged_attention.py:123",
    }
    k1q8 = {
        "name": "K1 ragged_paged_attention over int8 pools",
        "route": "cuda",
        "source": "mdi_llm_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "mdi_llm_tpu/ops/ragged_paged_attention.py:171",
    }
    k2 = {
        "name": "K2 flash_attention",
        "route": "cuda",
        "source": "mdi_llm_tpu_torch/csrc/flash_attention.cu",
        "replaces": "mdi_llm_tpu/ops/flash.py:40",
    }
    k3 = {
        "name": "K3 flash_dq",
        "route": "cuda",
        "source": "mdi_llm_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "mdi_llm_tpu/ops/flash.py:181",
    }
    k4 = {
        "name": "K4 flash_dkv",
        "route": "cuda",
        "source": "mdi_llm_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "mdi_llm_tpu/ops/flash.py:229",
    }
    runs = {
        "kernel": lambda: phase_kernel(k1),
        "serve": lambda: phase_serve(k1),
        "analysis": lambda: phase_analysis(card),
        "serve-parity": phase_serve_parity,
        "kernel-q8": lambda: phase_kernel_q8(k1q8),
        "serve-q8": lambda: phase_serve_q8(k1q8),
        "serve-q8-parity": phase_serve_q8_parity,
        "spec": phase_spec,
        "spec-parity": phase_spec_parity,
        "flash": lambda: phase_flash(k2),
        "generate": lambda: phase_generate(k2),
        "generate-parity": phase_generate_parity,
        "flash-bwd": lambda: phase_flash_bwd(k3, k4),
        "train": lambda: phase_train(k3, k4),
        "train-parity": phase_train_parity,
        "train-parity-bf16": phase_train_parity_bf16,
        "ckpt": lambda: phase_ckpt(k1, k2, card, ckpt_dir),
        "chat": lambda: phase_chat(k2, card, ckpt_dir),
        "graphs": lambda: phase_graphs(k1, k2, card),
        "server": lambda: phase_server(k1, card),
        "tier": lambda: phase_tier(k1, card),
        "quant": lambda: phase_quant(k1, k2, card, ckpt_dir),
        "moe": lambda: phase_moe(k1, k2, card),
        "moe-quant": lambda: phase_moe_quant(k1, k2, card),
        "moe-train": lambda: phase_moe_train(k3, k4, card),
        "ep": lambda: phase_ep(k2, k3, k4, card),
        "tune": lambda: phase_tune(k1, card),
        "pipeline": lambda: phase_pipeline(card),
        "pipeline-nodes": lambda: phase_pipeline_nodes(card),
        "pp-serve": lambda: phase_pp_serve(k1, card),
        "tp-serve": lambda: phase_tp_serve(k1, card),
        "tp-generate": lambda: phase_tp_generate(k2, card),
        "tools": lambda: phase_tools(card, ckpt_dir),
        "mesh-train": lambda: phase_mesh_train(k2, k3, k4, card),
        "mesh-train-procs": lambda: phase_mesh_train_procs(k2, k3, k4, card),
        "mesh-train-quad": lambda: phase_mesh_train_quad(k2, k3, k4, card),
        "pp-tp-serve": lambda: phase_pp_tp_serve(k1, card),
        "pipeline-tp": lambda: phase_pipeline_tp(card),
        "inference-procs": lambda: phase_inference_procs(k2, card),
        "sp": lambda: phase_sp(k2, k3, k4, card),
        "sp-train": lambda: phase_sp_train(k2, k3, k4, card),
        "preflight": lambda: phase_preflight(card),
        "doctor": lambda: phase_doctor(card),
    }
    with tempfile.TemporaryDirectory() as tmp:
        # the HF libraries' caches and token in the run's directory, not $HOME's
        os.environ["HF_HOME"] = str(Path(tmp) / "hf-home")
        os.environ["HF_DATASETS_CACHE"] = str(Path(tmp) / "hf-home" / "datasets")
        ckpt_dir = Path(tmp) / "checkpoints" / HUB_ORG / TINY_LLAMA
        for phase in PHASES:
            if phase in only:
                t = time.perf_counter()
                runs[phase]()
                print(f"phase {phase}: {time.perf_counter() - t:.1f} s", flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "paths")
    records = (k1, k1q8, k2, k3, k4)
    missing = [(r["name"], k) for r in records for k in keys if k not in r]
    k2_paths = {"generate", "ckpt", "graphs", "quant", "moe", "moe-quant", "tp-generate",
                "mesh-train", "mesh-train-procs", "mesh-train-quad", "inference-procs", "sp",
                "ep", "ep-tp", "sp-train"} | (
        {"chat"} if importlib.util.find_spec("tokenizers") else set())
    k1_paths = {"serve", "ckpt", "graphs", "server", "tier", "quant", "moe", "moe-quant", "tune",
                "pp-serve", "tp-serve", "pp-tp-serve"}
    k34_paths = {"train", "moe-train", "mesh-train", "mesh-train-procs", "mesh-train-quad",
                 "sp", "ep", "ep-tp", "sp-train"}
    if only == set(PHASES) and (set(k1["paths"]) != k1_paths or set(k2["paths"]) != k2_paths
                                or set(k3["paths"]) != k34_paths
                                or set(k4["paths"]) != k34_paths):
        fail("record", f"K1 paths {k1['paths']}, K2 paths {k2['paths']}, K3 paths "
             f"{k3['paths']}, K4 paths {k4['paths']}")
    if only == set(PHASES) and missing:
        fail("record", f"kernels line lacks {missing}")
    print(card)
    print(json.dumps({"kernels": [{k: r.get(k) for k in keys} for r in records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
