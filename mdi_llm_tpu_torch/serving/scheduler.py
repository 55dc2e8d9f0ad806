"""Continuous-batching request scheduler.

Policy layer between the request queue and the device loop
(`serving.engine.ServingEngine`): policy-ordered admission into a fixed
set of decode slots (`serving/policy.py` — FCFS by default, priority /
per-tenant fair-share / TTFT-deadline pluggable), token-budget
mixed-batch composition (Sarathi-style: decode lanes first, then prefill
chunks split to fit, packed in policy order), mid-batch retirement, and
recompute-style preemption when the block pool runs dry.

The scheduler never touches device arrays — it owns `SequenceState`
bookkeeping (token lists, block tables, feed positions) and the `KVPool`
accounting, and hands the engine one action at a time (`next_batch`):

    ("mixed", [(seq, n_tokens), ...])  ONE unified ragged forward: every
                                  decode-ready lane's pending token plus
                                  prefill chunks filling the token budget
    ("decode", [seqs])            no prefill work pending — the engine's
                                  chunked/speculative decode paths take over
    None                          nothing runnable (queue empty or blocked)

Feed-position invariants (`SequenceState`):
- `fed` tokens have their K/V in the pool; the next token to feed is
  `tokens[fed]` at absolute position `fed`.
- prefill phase: `fed < prefill_target`; on completion the engine samples
  the first output token from the chunk's last logits (fresh requests) or
  restores the preserved `resume_tok` (preempted requests).
- decode phase: `fed == len(tokens) - 1` — exactly the final sampled token
  is pending, matching `Generator.generate`'s loop.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

from mdi_llm_tpu_torch.serving.kv_pool import KVPool
from mdi_llm_tpu_torch.serving.policy import FCFSPolicy, SchedulingPolicy

__all__ = ["Request", "SequenceState", "Scheduler"]


@dataclass
class Request:
    rid: str
    prompt: List[int]
    max_new_tokens: int
    stop_sequences: Sequence[Sequence[int]] = ()
    # open-system scheduling attributes (serving/policy.py): ignored by
    # the default FCFS policy, so replay traces behave exactly as before
    priority: int = 0  # higher admits first under PriorityPolicy
    tenant: str = ""  # fair-share accounting key (FairSharePolicy)
    ttft_slo_s: Optional[float] = None  # TTFT deadline relative to arrival
    arrival_s: Optional[float] = None  # stamped by the policy at add()


class SequenceState:
    """One admitted request's feed/block bookkeeping."""

    def __init__(self, req: Request, blocks: List[int], n_cached: int,
                 slot: int, resume_tokens: Optional[List[int]] = None):
        self.req = req
        # full logical token list (prompt + generated so far)
        self.tokens: List[int] = list(resume_tokens or req.prompt)
        self.blocks = blocks  # shared cached prefix + exclusively owned
        self.n_cached = n_cached  # tokens covered by reused prefix blocks
        self.fed = n_cached  # tokens whose K/V is in the pool
        self.slot = slot
        # resumed sequences already know their pending token; fresh ones
        # sample it from the prefill logits
        self.resume_tok: Optional[int] = (
            self.tokens[-1] if resume_tokens else None
        )
        self.prefill_target = (
            len(self.tokens) - 1 if resume_tokens else len(self.tokens)
        )
        self.next_tok: Optional[int] = None  # sampled, not yet fed
        # a fully-prefix-cached resume needs no prefill at all: the pending
        # token is restored immediately so next_batch sees it decode-ready
        if resume_tokens and self.fed >= self.prefill_target:
            self.next_tok = self.resume_tok
        self.done = False
        self.admit_order = -1  # stamped by the scheduler at admission
        # draft-model bookkeeping (engine-owned; inert without a draft pool):
        # `draft_fed` counts tokens whose K/V the DRAFT model has seen,
        # `draft_blocks` is the sequence's table into the draft pool, and
        # `draft_stale` marks sequences the draft can never catch up on —
        # prefix-cache hits and swap restores hand the TARGET pool KV the
        # draft was never fed (a documented quality concession: those lanes
        # keep the n-gram drafter, never the model drafter).
        self.draft_fed = 0
        self.draft_blocks: List[int] = []
        self.draft_stale = n_cached > 0

    @property
    def n_prompt(self) -> int:
        return len(self.req.prompt)

    @property
    def n_generated(self) -> int:
        return len(self.tokens) - self.n_prompt

    @property
    def needs_prefill(self) -> bool:
        return self.fed < self.prefill_target

    def generated(self) -> List[int]:
        return self.tokens[self.n_prompt:]


class Scheduler:
    def __init__(self, pool: KVPool, max_batch: int, prefill_chunk: int,
                 max_seq_length: int,
                 policy: Optional[SchedulingPolicy] = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.pool = pool
        self.max_batch = max_batch
        self.prefill_chunk = max(1, prefill_chunk)
        self.max_seq_length = max_seq_length
        # scheduling policy (serving/policy.py): decides which waiting
        # request takes the next free slot and in what order prefilling
        # sequences split the unified step's token budget.  Pure host-side
        # reordering — dispatch shapes and sync cadence cannot change.
        # The default is FCFS, bit-identical to the pre-policy scheduler.
        self.policy = policy if policy is not None else FCFSPolicy()
        self.waiting: Deque[Request] = deque()
        # preempted sequences resume before fresh admissions (they hold
        # progress the pool already paid for once)
        self.preempted: Deque[Tuple[Request, List[int]]] = deque()
        self.slots: List[Optional[SequenceState]] = [None] * max_batch
        self.finished: List[SequenceState] = []
        self._admit_counter = 0  # admission recency for preemption order
        self.preemptions = 0
        # host-RAM tier seam (serving/host_tier.py): the scheduler stays
        # device- and tier-blind — when ServingConfig.host_pool_mib > 0
        # the engine installs these hooks, and swap-vs-recompute becomes a
        # per-victim cost-model decision instead of always-recompute.
        # rid -> SwapRecord for queued preempted entries whose KV lives in
        # host slots (the deque keeps its historical (req, toks) tuples so
        # the open-system frontend's cancellation scan is untouched).
        self.swap_records: Dict[str, object] = {}
        # seq -> Optional[SwapRecord]: engine gathers the victim's blocks
        # to host slots (enqueued BEFORE the release below frees them) and
        # returns the record, or None to fall back to recompute
        self.swap_out_hook: Optional[Callable[[SequenceState], Optional[object]]] = None
        # (record, hbm_blocks) -> None: engine schedules the payload
        # restore into freshly allocated blocks and reclaims the host slots
        self.swap_in_hook: Optional[Callable[[object, List[int]], None]] = None
        # record -> None: release host slots without restoring (cancel path)
        self.swap_drop_hook: Optional[Callable[[object], None]] = None
        self.swaps_out = 0  # preemptions resolved by swap, not recompute
        self.swaps_in = 0  # admissions resumed from host-tier payloads
        # draft-model KV pool (serving/engine.py installs it when
        # ServingConfig.draft_model is set): the scheduler only RELEASES
        # draft blocks on retire/preempt so the two pools' lifetimes stay
        # in lockstep; allocation is engine-side (non-preempting).
        self.draft_pool: Optional[KVPool] = None
        # observability hook (obs.ServingObserver or None): the scheduler
        # owns the request lifecycle edges — submitted/admitted/resumed/
        # preempted/retired — so it reports them; all hooks are plain
        # host-side appends taken where the bookkeeping already happens
        # (zero device work; see docs/observability.md)
        self.observer = None

    # -- queue ---------------------------------------------------------------

    def validate(self, req: Request) -> None:  # mdi-thread: any
        """The add-time feasibility wall, callable WITHOUT mutating any
        scheduler state: pure reads of pool/window constants, so the
        open-system front-end can pre-check a submission from its own
        thread (HTTP 400) before the engine thread ever sees it."""
        total = len(req.prompt) + req.max_new_tokens
        if len(req.prompt) < 1:
            raise ValueError(f"request {req.rid}: empty prompt")
        if req.max_new_tokens < 1:
            # 0 would break the generate() parity contract: prefill always
            # samples one token before the generated-length check fires (and
            # with max_new >= 1 the add-time footprint check below also
            # covers admission's blocks_needed(prompt + 1) reservation)
            raise ValueError(f"request {req.rid}: max_new_tokens must be >= 1")
        if total > self.max_seq_length:
            raise ValueError(
                f"request {req.rid}: prompt+max_new_tokens {total} exceeds "
                f"max_seq_length {self.max_seq_length}"
            )
        # worst-case block footprint must fit the pool even running alone
        if self.pool.blocks_needed(total) > self.pool.num_blocks - 1:
            raise ValueError(
                f"request {req.rid}: needs {self.pool.blocks_needed(total)} "
                f"blocks, pool has {self.pool.num_blocks - 1}"
            )

    def add(self, req: Request) -> None:  # mdi-thread: engine
        self.validate(req)
        self.policy.on_submitted(req)  # stamps arrival_s for deadlines
        self.waiting.append(req)
        if self.observer is not None:
            self.observer.request_submitted(
                req.rid, len(req.prompt), req.max_new_tokens
            )

    @property
    def has_work(self) -> bool:  # mdi-thread: engine
        return bool(
            self.waiting or self.preempted
            or any(s is not None for s in self.slots)
        )

    def running(self) -> List[SequenceState]:  # mdi-thread: engine
        return [s for s in self.slots if s is not None]

    # -- admission -----------------------------------------------------------

    def _free_slot(self) -> Optional[int]:  # mdi-thread: engine
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def _try_admit_one(self, req: Request,
                       resume_tokens: Optional[List[int]]) -> Optional[SequenceState]:
        slot = self._free_slot()
        if slot is None:
            return None
        tokens = resume_tokens or req.prompt
        if resume_tokens and req.rid in self.swap_records:
            return self._try_admit_swapped(req, resume_tokens, slot)
        cached, n_cached = self.pool.match_prefix(tokens)
        # cover every prefill write plus the first decode write
        target = len(tokens) - 1 if resume_tokens else len(tokens)
        need = self.pool.blocks_needed(target + 1) - len(cached)
        owned = self.pool.alloc(max(0, need))
        if owned is None:
            self.pool.release(cached)
            return None
        seq = SequenceState(req, cached + owned, n_cached, slot,
                            resume_tokens=resume_tokens)
        seq.admit_order = self._admit_counter
        self._admit_counter += 1
        self.slots[slot] = seq
        if self.observer is not None:
            self.observer.request_admitted(
                req.rid, slot, seq.admit_order, n_cached=n_cached,
                resumed=resume_tokens is not None,
            )
        return seq

    def _try_admit_swapped(self, req: Request, resume_tokens: List[int],
                           slot: int) -> Optional[SequenceState]:
        """Resume a swapped-out victim: allocate its whole table fresh
        (the restored payload carries the KV, so the prefix cache is
        bypassed — sharing a matched block would alias restore writes into
        it), schedule the host→HBM restore, and admit the sequence
        fully-cached: `fed` lands on the swap record's token coverage, so
        a mid-decode victim re-enters with ZERO re-prefill (its pending
        token is set immediately) and a mid-prefill victim re-prefills
        only the tail it had not fed yet."""
        record = self.swap_records[req.rid]
        target = len(resume_tokens) - 1  # the pending token rides along
        owned = self.pool.alloc(self.pool.blocks_needed(target + 1))
        if owned is None:
            return None  # record kept; the next admit() retries
        del self.swap_records[req.rid]
        n_cached = min(record.n_tokens, target)
        self.swap_in_hook(
            record, owned[: self.pool.blocks_needed(record.n_tokens)]
        )
        self.swaps_in += 1
        seq = SequenceState(req, owned, n_cached, slot,
                            resume_tokens=resume_tokens)
        seq.admit_order = self._admit_counter
        self._admit_counter += 1
        self.slots[slot] = seq
        if self.observer is not None:
            self.observer.request_admitted(
                req.rid, slot, seq.admit_order, n_cached=n_cached,
                resumed=True, restored=True,
            )
        return seq

    def drop_swap_record(self, rid: str) -> None:  # mdi-thread: engine
        """Forget a queued entry's swap record, releasing its host slots
        (the open-system frontend's cancel path, after it removes the
        entry from `preempted`).  No-op when the rid holds no record."""
        record = self.swap_records.pop(rid, None)
        if record is not None and self.swap_drop_hook is not None:
            self.swap_drop_hook(record)

    def admit(self) -> List[SequenceState]:  # mdi-thread: engine
        """Policy-ordered admission, preempted sequences first (they hold
        progress the pool already paid for once, whatever the policy).
        Admission stops at the first pick that does not fit — the policy's
        choice blocks the queue rather than being skipped, so block
        accounting stays conservative and the pick can never be starved
        by later arrivals it ranked above (FCFS keeps its historical
        head-of-line no-starvation guarantee as the default policy)."""
        admitted = []
        while self.preempted:
            req, toks = self.preempted[0]
            seq = self._try_admit_one(req, toks)
            if seq is None:
                return admitted
            self.preempted.popleft()
            admitted.append(seq)
        while self.waiting:
            idx = self.policy.select_next(self.waiting, self.running())
            if idx is None:
                return admitted
            seq = self._try_admit_one(self.waiting[idx], None)
            if seq is None:
                return admitted
            del self.waiting[idx]
            admitted.append(seq)
        return admitted

    # -- lifecycle -----------------------------------------------------------

    def retire(self, seq: SequenceState) -> None:  # mdi-thread: engine
        """Mid-batch retirement: free the slot and the blocks (copy-free —
        prefix-registered blocks stay warm in the pool's cached set)."""
        seq.done = True
        self.slots[seq.slot] = None
        self.pool.release(seq.blocks)
        seq.blocks = []
        self._release_draft(seq)
        self.finished.append(seq)
        self.policy.on_retired(seq)  # fair-share usage accounting
        if self.observer is not None:
            self.observer.request_finished(seq.req.rid)

    def _release_draft(self, seq: SequenceState) -> None:
        """Return a sequence's draft-pool blocks (no-op without a draft
        pool).  Draft KV is always recomputable from the token list, so
        retire and preempt both drop it wholesale."""
        if self.draft_pool is not None and seq.draft_blocks:
            self.draft_pool.release(seq.draft_blocks)
        seq.draft_blocks = []
        seq.draft_fed = 0

    def preempt_latest(self, exclude: Optional[SequenceState] = None) -> bool:  # mdi-thread: engine
        """Recompute-style preemption: kick the lowest-priority lane back
        to the queue (its tokens re-prefill on resume).  Within a priority
        class the most recently ADMITTED sequence yields (not the highest
        slot index — slots churn): the newest sequence has the least
        paid-for KV to recompute.  Under plain FCFS every lane has
        priority 0 and this reduces to the pure recency rule, so pool
        pressure can never evict a high-priority stream to keep a
        low-priority one decoding (priority inversion)."""
        victims = [s for s in self.running() if s is not exclude]
        if not victims:
            # fall back to self-preemption: the caller's own sequence yields
            victims = self.running()
        if not victims:
            return False
        seq = min(victims, key=lambda s: (s.req.priority, -s.admit_order))
        # host tier: offer the victim to the engine's swap path BEFORE the
        # release below recycles its blocks — the gather snapshotting the
        # payload is enqueued while the blocks are still owned, so device
        # in-order execution reads them ahead of any new owner's writes.
        # None (cost model says recompute, tier full, or no tier) keeps
        # the historical recompute behavior bit-for-bit.
        record = None
        if self.swap_out_hook is not None:
            record = self.swap_out_hook(seq)
        self.slots[seq.slot] = None
        self.pool.release(seq.blocks)
        seq.blocks = []
        self._release_draft(seq)
        # resume from the full token list; the pending token rides along
        toks = list(seq.tokens)
        if seq.next_tok is not None and (not toks or toks[-1] != seq.next_tok):
            toks.append(seq.next_tok)
        if record is not None:
            self.swap_records[seq.req.rid] = record
            self.swaps_out += 1
        self.preempted.appendleft((seq.req, toks))
        self.preemptions += 1
        if self.observer is not None:
            self.observer.request_preempted(
                seq.req.rid, seq.n_generated, swapped=record is not None
            )
        return True

    def ensure_blocks_for(self, seq: SequenceState, n_writes: int = 1) -> bool:  # mdi-thread: engine
        """Grow a decoding sequence's table to cover its next `n_writes`
        positions (`fed .. fed+n_writes-1` — a K-step decode chunk or a
        speculative verify's K+1 tokens), one block at a time; preempt
        others until it fits.  False if the sequence itself was preempted.

        Rollback contract for speculative reservation: blocks reserved
        ahead of the written tokens are rolled back to the pool through the
        normal release path — `retire` (early stop mid-chunk) and
        `preempt_latest` both release the sequence's WHOLE table, and the
        engine caps `n_writes` at the slot's remaining budget/window so a
        live sequence never holds coverage it cannot use."""
        target = seq.fed + max(1, int(n_writes))
        while self.pool.blocks_needed(target) > len(seq.blocks):
            got = self.pool.alloc(1)
            if got is not None:
                seq.blocks.extend(got)
                continue
            if not self.preempt_latest(exclude=seq):
                raise RuntimeError("KV pool exhausted with nothing to preempt")
            if self.slots[seq.slot] is not seq:  # self-preempted
                return False
        return True

    # back-compat alias (the per-step decode path reserves one write)
    def ensure_block_for(self, seq: SequenceState) -> bool:  # mdi-thread: engine
        return self.ensure_blocks_for(seq, 1)

    def try_reserve(self, seq: SequenceState, n_writes: int) -> bool:  # mdi-thread: engine
        """Non-preempting variant of `ensure_blocks_for`, for reservations
        made while a dispatched chunk is still in flight (double-buffering):
        preempting here would free blocks the device is actively writing.
        Partial growth on failure is safe — the extra blocks ride on the
        sequence and roll back with its table."""
        need = self.pool.blocks_needed(
            seq.fed + max(1, int(n_writes))
        ) - len(seq.blocks)
        if need <= 0:
            return True
        got = self.pool.alloc(need)
        if got is None:
            return False
        seq.blocks.extend(got)
        return True

    # -- action selection ----------------------------------------------------

    def next_batch(self, token_budget: int):  # mdi-thread: engine
        """One step of the continuous-batching policy: admit whatever fits,
        then compose the step's token batch under `token_budget` — decode
        lanes FIRST (one pending token each, so a long prompt can never
        starve a live decode), then prefill chunks packed into the
        remaining budget in admission order, each capped at
        `prefill_chunk` and split across steps when the remainder is
        smaller than the prompt's tail.

        Returns ``("mixed", [(seq, n_tokens), ...])`` whenever any prefill
        work rides along (the engine runs ONE unified ragged forward),
        ``("decode", [seqs])`` when only decode lanes are live (the
        engine's chunked/speculative multi-token paths take over), or
        ``None`` when nothing is runnable.  With ``token_budget >
        max_batch`` (enforced by the engine and mdi-audit) at least one
        prefill token fits every mixed step, so prefill always makes
        progress."""
        self.admit()
        # packing order is the policy's second seam: FCFS returns
        # admission order (the historical behavior); DeadlinePolicy puts
        # the least-slack TTFT deadline first so an urgent prompt takes
        # the leftover budget before relaxed ones.  Reordering only —
        # chunking and the dispatch shape are untouched.
        prefilling = self.policy.order_prefill(
            [s for s in self.running() if s.needs_prefill],
            now=self.policy.clock(),
        )
        decoding = [
            s for s in self.running()
            if not s.needs_prefill and s.next_tok is not None
        ]
        if not prefilling:
            return ("decode", decoding) if decoding else None
        entries: List[Tuple[SequenceState, int]] = [(s, 1) for s in decoding]
        budget = token_budget - len(entries)
        for seq in prefilling:
            if budget <= 0:
                break
            chunk = min(self.prefill_chunk, seq.prefill_target - seq.fed,
                        budget)
            entries.append((seq, chunk))
            budget -= chunk
        return ("mixed", entries)
