"""Continuous-batching scheduler (TPU twist: static-shape step plans).

Each call to :meth:`schedule` emits one *step plan*: a single sequence's
prefill (bucketed length), one batched decode over all running sequences
(padded to a batch-size bucket), or — with ``mixed_batch`` on — a fused
MIXED plan packing every running sequence's decode token plus a bounded
prefill chunk of the head waiting sequence under the
``max_num_batched_tokens`` budget (chunked-prefill-integrated batching:
arriving prompts stop stalling the decoders for a full prefill bucket).
Every plan maps to a pre-compiled XLA executable — no shape escapes the
bucket set, so steady-state serving never recompiles.

Preemption: when the block pool cannot back a decode step, the youngest
running sequence is preempted.  With ``preemption_mode="offload"`` its KV
blocks are paged to host DRAM (kv/offload.py) and restored on resume —
cheaper on TPU than recompute because host<->HBM DMA overlaps compute, while
re-prefill burns MXU FLOPs (the reference reaches the same capability with
LMCache CPU offload, deployment-vllm-multi.yaml:161-166).
"""

from __future__ import annotations

import dataclasses
import logging
from collections import deque
from typing import Deque, List, Optional

from production_stack_tpu_torch.engine.config import SchedulerConfig
from production_stack_tpu_torch.engine.core.sequence import (
    Sequence,
    SequenceStatus,
    host_state_flags,
)
from production_stack_tpu_torch.engine.kv.block_pool import BlockPool

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class PrefillPlan:
    seq: Sequence
    bucket_len: int  # padded token count (multiple of block size)
    new_block_ids: List[int]  # blocks receiving the new KV (null-padded)
    prefix_block_ids: List[int]  # cached-prefix blocks (may be empty)
    num_new_tokens: int  # valid tokens to prefill
    cached_len: int
    # False for a non-final chunk of a long prompt (chunked prefill): the
    # engine writes KV but must not sample — the logits are mid-prompt.
    is_final: bool = True


@dataclasses.dataclass
class DecodePlan:
    seqs: List[Sequence]  # <= max_num_seqs running sequences
    # Per-sequence decode TOKEN budget for this plan (aligned with
    # ``seqs``).  All 1s for classic stepping; for K-step windows each
    # entry is capped by the sequence's remaining room (max_model_len,
    # max_tokens) and its blocks are pre-allocated for the whole budget —
    # under the fused speculative window that is the MAX-ACCEPTANCE
    # growth K x (ngram + 1), not the iteration count.
    steps: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class StepPlan:
    """THE one step-plan type (unifying the former four-way plan
    taxonomy; the former compat views are retired — callers read the
    fields directly).
    Exactly one execution shape per plan, read off three fields:

      decode only                     pure decode — ``decode_window`` (K)
                                      iterations per row budgeted in
                                      ``decode.steps`` (K > 1 only when
                                      no prompt is waiting)
      prefill_chunk only              one prefill step (bucketed, maybe
                                      chunked)
      decode + prefill_chunk          fused mixed step (always K=1: the
                                      chunk either completes admission
                                      this step or the window machinery
                                      declined)
      decode + chunk_schedule         MIXED K-step window: each of the
                                      K = len(chunk_schedule) scan
                                      iterations runs the packed
                                      [decode + chunk] mixed forward —
                                      decode rows advance one token from
                                      the carried state while the head
                                      prompt's next chunk rides the same
                                      forward, chunk cursor carried
                                      in-graph.  The window always ends
                                      at an admission boundary (the
                                      schedule's last chunk is final, or
                                      the prompt continues next window).

    ``provisional`` marks plans made while the previous window is still
    in flight (optimistic no-finish assumption; the engine rolls back
    at collect).  ``window_fallback`` names the reason a pass that
    WANTED a K>1 window was forced to K=1 (``"waiting_head"`` — the
    head prompt forced per-token admission; ``"bucket_mismatch"`` —
    the final chunk's natural bucket differed from the window's static
    scan shape; ``"pool_pressure"`` — block pool / restore pressure
    ended chunking early); the engine folds it into
    ``tpu:multistep_fallback_total``."""

    decode: Optional[DecodePlan] = None
    prefill_chunk: Optional[PrefillPlan] = None
    decode_window: int = 1
    provisional: bool = False
    # Mixed K-step window: one PrefillPlan per scan iteration, all at
    # ONE chunk bucket (static scan shape).  Packed windows
    # (multi_prompt_window) may carry chunks from SEVERAL prompts: a
    # final chunk mid-schedule admits its prompt and the next iteration
    # starts the next waiting prompt's cursor (later prompts ride
    # padded at the window's established bucket — pf_valid masks
    # identically).  Under --no-multi-prompt-window only the last chunk
    # may be final (the single-head shape).
    chunk_schedule: Optional[List[PrefillPlan]] = None
    window_fallback: Optional[str] = None

    @property
    def is_empty(self) -> bool:
        return self.decode is None and self.prefill_chunk is None


class Scheduler:
    def __init__(
        self,
        config: SchedulerConfig,
        block_pool: BlockPool,
        offload_cb=None,
        restore_cb=None,
        remote_prefix_cb=None,
    ):
        self.config = config
        self.block_pool = block_pool
        # offload_cb(seq, block_ids) -> bool: snapshot blocks before they
        # are freed (engine wires offload_seq_blocks).  With the async
        # transfer plane (cache.remote_prefetch) the callback only
        # DISPATCHES a device-side gather and returns — the D2H wait and
        # any remote PUT complete on a writer thread, so schedule() never
        # blocks on DMA or the network here.
        self.offload_cb = offload_cb
        # restore_cb(seq) -> "restored" | "gone" | "retry": page an
        # offloaded sequence's KV back in; on "restored" the engine sets
        # seq.block_table/num_cached_tokens/partial_prefill so the plan
        # below resumes as a held prefix.  "retry" covers transient pool
        # pressure AND an in-flight async remote page-in — schedule again
        # next pass instead of waiting.
        self.restore_cb = restore_cb
        # remote_prefix_cb(seq, prefix_blocks, cached_len) ->
        # (prefix_blocks, cached_len): cross-engine prefix reuse through
        # the shared remote store (engine wires fetch_remote_prefix when
        # cache.disagg_role imports).  Async mode returns the inputs
        # unchanged, only ensuring a background prefetch is in flight —
        # completed fetches were already imported into the prefix cache
        # before schedule() ran, so match_prefix above saw them; legacy
        # mode (remote_prefetch=False) extends in place with blocking
        # GETs.
        self.remote_prefix_cb = remote_prefix_cb
        self.waiting: Deque[Sequence] = deque()
        self.running: List[Sequence] = []
        self.preempted: Deque[Sequence] = deque()
        self.num_preemptions = 0
        # Deterministic admission counter: priority ties break FCFS, and
        # (unlike wall-clock arrival_time) the ordering is identical on
        # every lockstep replica of a multi-host group.
        self._admit_counter = 0
        # Prompt tokens currently held by waiting+preempted sequences,
        # maintained incrementally so bounded admission can read one int
        # cross-thread instead of iterating a deque the step thread
        # mutates (a mid-iteration mutation raises RuntimeError).
        self.queued_prompt_tokens = 0
        # Decode-side chunk-budget computations (_chunk_token_budget
        # calls) — regression-tested O(1) per planning pass: packed
        # window planning over N waiters must not recompute it per
        # chunk.
        self.budget_computations = 0
        # Why the last _extend_chunk_schedule stopped early (None = it
        # ran to a natural end) — window_fallback attribution.
        self._chunk_stop_reason: Optional[str] = None

    # -- admission ---------------------------------------------------------

    def add_seq(self, seq: Sequence) -> None:
        if seq.num_prompt_tokens >= self.config.max_model_len:
            raise ValueError(
                f"Prompt ({seq.num_prompt_tokens} tokens) exceeds max_model_len "
                f"({self.config.max_model_len})"
            )
        bs = self.block_pool.block_size
        worst_tokens = min(
            seq.num_prompt_tokens + seq.sampling_params.max_tokens,
            self.config.max_model_len,
        )
        worst_blocks = (worst_tokens + bs - 1) // bs
        if worst_blocks > self.block_pool.num_blocks - 1:
            raise ValueError(
                f"Request needs up to {worst_blocks} KV blocks but the pool "
                f"only has {self.block_pool.num_blocks - 1}; lower max_tokens "
                "or raise the KV pool size"
            )
        seq._admit_idx = self._admit_counter
        self._admit_counter += 1
        # Priority order (vLLM semantics: LOWER value runs earlier; ties
        # keep admission order).  Admission keys are monotone under FCFS,
        # so the all-default case stays a plain append.
        key = (seq.sampling_params.priority, seq._admit_idx)
        self.queued_prompt_tokens += seq.num_prompt_tokens
        for i, other in enumerate(self.waiting):
            if (other.sampling_params.priority, other._admit_idx) > key:
                self.waiting.insert(i, seq)
                return
        self.waiting.append(seq)

    def abort_seq(self, seq_id: str) -> Optional[Sequence]:
        for queue in (self.waiting, self.preempted):
            for seq in list(queue):
                if seq.seq_id == seq_id:
                    queue.remove(seq)
                    self.queued_prompt_tokens -= seq.num_prompt_tokens
                    self._release(seq)
                    return seq
        for seq in self.running:
            if seq.seq_id == seq_id:
                self.running.remove(seq)
                self._release(seq)
                return seq
        return None

    def has_unfinished(self) -> bool:
        return bool(self.waiting or self.running or self.preempted)

    @property
    def num_waiting(self) -> int:
        return len(self.waiting) + len(self.preempted)

    @property
    def num_running(self) -> int:
        return len(self.running)

    # -- planning ----------------------------------------------------------

    def _bucket_for(self, n_tokens: int) -> Optional[int]:
        for bucket in self.config.prefill_buckets:
            if n_tokens <= bucket:
                return bucket
        return None

    def _window_for_pass(self) -> int:
        """Window-selection rule: K > 1 pure-decode windows only when no
        prompt is waiting to prefill.  A waiting head is first offered a
        MIXED K-step window (its chunks ride the decode scan — see
        ``_try_schedule_mixed_window``); only when that declines does
        the pass drop to K=1 steps so admission — mixed chunk or
        dedicated prefill — is re-evaluated every token, not every K
        tokens (counted as ``window_fallback="waiting_head"``).

        Packed-window exception (multi_prompt_window): when every batch
        slot is occupied, NO admission is possible this pass no matter
        how often it is re-evaluated — dropping to K=1 would burn K
        host round-trips purely on ceremony.  Run a pure-decode window
        clamped to the first step a slot could FREE (the smallest
        remaining output budget across the batch): windows never
        retire rows mid-scan — finish/abort land at collect — so
        iterations past the first exhausted row's budget would decode
        dead rows while admissible prompts wait, and the boundary is
        exactly where packing becomes possible again."""
        window = self.config.window_steps
        if window > 1 and self.num_waiting:
            if (
                self.config.multi_prompt_window_enabled
                and len(self.running) >= self.config.max_num_seqs
            ):
                # Floor 2: still a window (a K=1 pass here would be
                # miscounted as a waiting_head forfeit — it isn't one,
                # no admission fits a full batch either way).
                return min(window, max(
                    2,
                    min(s.remaining_budget for s in self.running),
                ))
            return 1
        return window

    # stackcheck: root=step-thread
    def schedule(self) -> StepPlan:
        """Emit one unified :class:`StepPlan`.  With ``mixed_batch`` on
        and sequences decoding, a fused decode+chunk plan keeps arriving
        prompts from stalling the decoders — as a mixed K-step window
        when the head prompt has several chunks to go (decode keeps its
        host-cost amortization under sustained arrivals), else a K=1
        mixed step; otherwise prefer admitting a prefill when a batch
        slot is open, else decode every running sequence — as a K-step
        window when no prompt waits (the device-resident fast path),
        single-token steps otherwise."""
        window = self._window_for_pass()
        if self.config.mixed_enabled and self.running:
            plan = self._try_schedule_mixed_window()
            if plan is not None:
                return plan
            plan = self._try_schedule_mixed(window)
            if plan is not None:
                if (
                    self.config.window_steps > 1
                    and window == 1
                    and not (
                        plan.prefill_chunk is not None
                        and plan.prefill_chunk.is_final
                    )
                ):
                    # A waiting prompt forced single-stepping and the
                    # pass did NOT complete its admission (a final
                    # chunk IS the optimal full-service step): the
                    # window amortization was forfeited, visibly.
                    plan.window_fallback = "waiting_head"
                return plan
        plan = self._try_schedule_prefill()
        if plan is not None:
            return StepPlan(prefill_chunk=plan)
        decode = self._try_schedule_decode(window)
        if decode is not None:
            return StepPlan(decode=decode, decode_window=window)
        # No step possible.  Two partially-prefilled sequences can coexist
        # (one per queue, or via offload restore) and deadlock each other
        # by jointly holding the pool; roll back the youngest — freeing its
        # blocks for recompute later — until something schedules again.
        while self._rollback_youngest_partial():
            plan = self._try_schedule_prefill()
            if plan is not None:
                return StepPlan(prefill_chunk=plan)
        return StepPlan()

    def _rollback_youngest_partial(self) -> bool:
        """Free a stalled mid-prefill sequence's held blocks (its chunks
        will recompute).  Progress guarantee for the chunked-prefill path:
        admission bounds every single sequence to fit the pool alone."""
        partials = [
            s
            for s in list(self.preempted) + list(self.waiting)
            if s.partial_prefill
        ]
        if not partials:
            return False
        # Victim key mirrors _preempt_youngest: lowest priority loses,
        # youngest ADMISSION among equals.  Never wall-clock arrival_time —
        # clocks diverge across lockstep multi-host replicas, and a
        # replica-dependent victim desyncs every subsequent plan (the same
        # reason admission ordering uses _admit_idx).
        seq = max(
            partials,
            key=lambda s: (s.sampling_params.priority,
                           getattr(s, "_admit_idx", 0)),
        )
        logger.debug("Rolling back partial prefill of %s (pool pressure)", seq.seq_id)
        self.block_pool.free(seq.block_table)
        seq.block_table = []
        seq.num_cached_tokens = 0
        seq.partial_prefill = False
        return True

    def _admission_queue(self) -> Optional[Deque[Sequence]]:
        """Pick which queue admits next.  Preempted sequences normally
        resume first (their progress is largest), but a strictly
        higher-priority waiting head (LOWER value) jumps ahead — without
        this, any preemption would starve later high-priority arrivals
        behind the whole preempted backlog.  Ties keep the preempted
        queue (progress wins).  Residual gap vs vLLM is documented in
        docs/engine.md (no priority-triggered preemption of running
        sequences)."""
        if not self.preempted:
            return self.waiting if self.waiting else None
        if not self.waiting:
            return self.preempted
        if (
            self.waiting[0].sampling_params.priority
            < self.preempted[0].sampling_params.priority
        ):
            return self.waiting
        return self.preempted

    def _try_schedule_mixed(self, window: int = 1) -> Optional[StepPlan]:
        """Fused step: decode every running sequence AND, when the token
        budget and a batch slot allow, a bounded prefill chunk of the
        admission head.  Returns None to fall back to the classic
        alternating path — used when the head needs the full prefill
        machinery (echo+logprobs wants per-position prompt logprobs,
        which only the dedicated prefill executable computes), so such
        requests keep today's prefill-first latency instead of waiting
        behind a decode-forever batch."""
        queue = self._admission_queue()
        head = queue[0] if queue else None
        if (
            head is not None
            and head.sampling_params.echo
            and head.sampling_params.logprobs
            and len(self.running) < self.config.max_num_seqs
        ):
            return None
        decode = self._try_schedule_decode(window)
        if decode is None:
            # Pool pressure emptied the running set: the classic path's
            # prefill-first + rollback machinery handles recovery.
            return None
        chunk = None
        if self.num_waiting and len(self.running) < self.config.max_num_seqs:
            budget = self._chunk_token_budget(len(decode.seqs))
            chunk = self._try_schedule_prefill(chunk_budget=budget)
        if chunk is None:
            return StepPlan(decode=decode, decode_window=window)
        return StepPlan(decode=decode, prefill_chunk=chunk)

    # -- mixed K-step windows ----------------------------------------------

    def _mixed_window_head(self) -> Optional[Sequence]:
        """The admission head a mixed K-step window could chunk, or None
        when the pass must stay on the K=1 machinery: no head / no open
        batch slot, a head needing the prompt-logprobs prefill
        executable, an offloaded head (the restore state machine lives
        on the K=1 path), or any running row using host-sampled
        features the engine would fall back out of the window for."""
        if not self.config.mixed_window_enabled or not self.running:
            return None
        if len(self.running) >= self.config.max_num_seqs:
            return None
        queue = self._admission_queue()
        head = queue[0] if queue else None
        if head is None or head.offloaded:
            return None
        sp = head.sampling_params
        if sp.echo and sp.logprobs:
            return None
        if any(host_state_flags(s)[0] for s in self.running):
            return None
        return head

    def _chunk_token_budget(self, num_decode_rows: int) -> int:
        """Per-iteration chunk token budget beside ``num_decode_rows``
        decode tokens — computed ONCE per planning pass and threaded
        through window planning.  The per-chunk recomputation this
        replaces also drifted on the packed path: a final chunk pops
        its prompt into ``running`` mid-planning, which must not
        shrink later chunks' budget (the window's decode rows are
        fixed at plan time; packed prompts only join the decode batch
        at the next boundary)."""
        self.budget_computations += 1
        return self.config.batched_tokens_budget - num_decode_rows

    def _chunk_buckets_in_budget(self, budget: int) -> List[int]:
        """Chunk buckets admissible beside the current decode batch
        under the per-iteration token budget (each scan iteration is
        one mixed step: decode tokens + one chunk <= the budget, so the
        window's total is K x (decode + chunk))."""
        return [b for b in self.config.prefill_chunk_buckets if b <= budget]

    def _next_packable_head(self) -> Optional[Sequence]:
        """The next waiting prompt a PACKED window may start chunking
        after the previous prompt's final chunk, or None to stop
        packing this window: no open batch slot left (prompts already
        popped by earlier final chunks count), empty queues, an
        offloaded head (the restore state machine lives on the K=1
        path), or a head needing the prompt-logprobs prefill
        executable."""
        if len(self.running) >= self.config.max_num_seqs:
            return None
        queue = self._admission_queue()
        head = queue[0] if queue else None
        if head is None or head.offloaded:
            return None
        sp = head.sampling_params
        if sp.echo and sp.logprobs:
            return None
        return head

    def _extend_chunk_schedule(
        self, head: Sequence, first: PrefillPlan, buckets: List[int],
        k_cap: int, budget: int,
    ) -> List[PrefillPlan]:
        """Grow a window's chunk schedule past its first chunk, one
        ``_try_schedule_prefill`` chunk at a time.

        Single-head mode (--no-multi-prompt-window) iterates the SAME
        bucket rule K=1 mixed stepping uses, so the planned chunk
        shapes (and therefore the compiled forwards, and the streams)
        are identical to the escape-hatch path.  Stops at ``k_cap``, at
        the head's final chunk, at pool pressure (the window ends
        non-final and the next window continues), or when the K=1 rule
        would pick a DIFFERENT bucket for the final chunk (one scan has
        ONE static chunk shape; the mismatched final chunk runs as the
        next pass's K=1 mixed step instead — bit-identical either way).

        Packed mode keeps filling the window across prompts: a final
        chunk admits its prompt, and the next iteration starts the next
        packable head's cursor.  Every chunk after the first is FORCED
        to the window's established bucket T — a chunk smaller than T
        rides padded (pf_valid masks padding out of attention and the
        tail-logit gather reads the last VALID row, so the compute is
        bit-identical to the chunk's natural bucket) — which keeps the
        scan shape static without ever rolling back committed plan
        state when a prefix hit shrinks a chunk at planning time."""
        schedule = [first]
        T = first.bucket_len
        packed = self.config.multi_prompt_window_enabled
        # Why extension stopped EARLY (window_fallback attribution when
        # the schedule collapses to K=1): a final chunk / k_cap exit is a
        # natural end and leaves this None.
        self._chunk_stop_reason = None
        while len(schedule) < k_cap:
            if schedule[-1].is_final:
                if not packed or self._next_packable_head() is None:
                    break
            if packed:
                nxt = self._try_schedule_prefill(
                    chunk_budget=budget, force_bucket=T
                )
            else:
                remaining = head.num_prompt_tokens - head.num_cached_tokens
                fit = [b for b in buckets if b >= remaining]
                if fit and fit[0] != T:
                    # One scan has ONE static chunk shape; the final
                    # chunk's natural bucket differs.
                    self._chunk_stop_reason = "bucket_mismatch"
                    break
                nxt = self._try_schedule_prefill(chunk_budget=budget)
            if nxt is None:
                self._chunk_stop_reason = "pool_pressure"
                break
            schedule.append(nxt)
        return schedule

    def _mixed_window_decode_steps(self, seqs, k_eff, bases=None):
        """Per-row decode token budgets for a mixed K-step window: the
        plain iteration count (the in-window drafter never engages in a
        mixed window — drafting is a pure-decode-window feature), capped
        by each row's max_model_len / max_tokens room.  0 freezes the
        row for the whole window (its stream is length-done; the K=1
        world would have retired it, and collect() does the same)."""
        steps = []
        for i, seq in enumerate(seqs):
            base_tokens, base_gen = (
                bases[i] if bases is not None
                else (seq.num_tokens, seq.num_generated)
            )
            room_len = self.config.max_model_len - base_tokens
            room_out = seq.sampling_params.max_tokens - base_gen
            steps.append(max(0, min(k_eff, room_len, room_out)))
        return steps

    def _try_schedule_mixed_window(self) -> Optional[StepPlan]:
        """Plan a MIXED K-step window: K = min(window_steps, chunks the
        head prompt needs, the adaptive queue-depth clamp) scan
        iterations, each running the packed [decode + chunk] mixed
        forward.  The window always ends at an admission boundary (its
        last chunk is final, or the prompt keeps chunking next window),
        which is what keeps greedy streams byte-identical and seeded
        streams bit-identical to K=1 mixed stepping: iteration t of a
        window dispatched at step counter c IS step c+t of the K=1
        world, chunk shapes included.  Returns None to fall back to the
        K=1 machinery (which owns preemption, restore, and the
        echo+logprobs special cases); a planned single-chunk outcome is
        emitted in the K=1 shape directly (nothing to amortize).

        Packed mode (multi_prompt_window): K is no longer clamped by
        queue depth — the adaptive clamp existed to re-evaluate
        admission often, and a packed window IS the admission: a final
        chunk mid-window admits its prompt and the next iteration
        starts the next waiter's cursor, so deep queues fill the
        window instead of shrinking it."""
        head = self._mixed_window_head()
        if head is None:
            return None
        budget = self._chunk_token_budget(len(self.running))
        buckets = self._chunk_buckets_in_budget(budget)
        if not buckets:
            return None
        packed = self.config.multi_prompt_window_enabled
        if packed:
            k_cap = self.config.window_steps
        else:
            k_cap = min(
                self.config.window_steps,
                self.config.mixed_window_clamp(self.num_waiting),
            )
        if k_cap < 2:
            # Deep waiting queue: the adaptive clamp demands per-token
            # admission re-evaluation — today's K=1 behavior.
            return None
        # Multi-chunk precheck before committing any state: a head that
        # fits one chunk bucket admits completely in one K=1 mixed step
        # (a false positive from an unknown prefix hit just ends the
        # window early at the final chunk).  Packed windows keep going
        # when OTHER waiters could fill the remaining iterations.
        remaining_max = head.num_prompt_tokens - (
            head.num_cached_tokens if head.partial_prefill else 0
        )
        if remaining_max <= buckets[-1] and (
            not packed or self.num_waiting <= 1
        ):
            return None
        decode = self._mixed_window_decode_plan(k_cap)
        if decode is None:
            return None
        first = self._try_schedule_prefill(chunk_budget=budget)
        if first is None or (first.is_final and not packed):
            # Pool pressure / restore retry, or a prefix hit shrank the
            # prompt to one final chunk: emit the exact K=1 mixed shape
            # (decode blocks are over-allocated for the declined window
            # — they sit in the block tables and back later steps).
            self._recap_steps_k1(decode)
            # first can only be None (pool pressure / restore retry) or
            # final here; a final single chunk is a natural K=1 shape,
            # not a decline.
            return StepPlan(
                decode=decode, prefill_chunk=first, decode_window=1,
                window_fallback="pool_pressure" if first is None else None,
            )
        schedule = self._extend_chunk_schedule(
            head, first, buckets, k_cap, budget
        )
        k_eff = len(schedule)
        if k_eff == 1:
            # Couldn't extend (pool pressure / bucket-mismatched final
            # chunk / nothing packable behind a final first chunk): the
            # planned chunk runs as today's K=1 mixed step.
            self._recap_steps_k1(decode)
            # _extend_chunk_schedule says WHY it stopped when it stopped
            # early (pool_pressure / bucket_mismatch); a final first
            # chunk is a natural K=1 shape, not a decline.
            return StepPlan(
                decode=decode, prefill_chunk=first, decode_window=1,
                window_fallback=(
                    None if first.is_final
                    else (self._chunk_stop_reason or "waiting_head")
                ),
            )
        decode.steps = self._mixed_window_decode_steps(decode.seqs, k_eff)
        return StepPlan(
            decode=decode, chunk_schedule=schedule, decode_window=k_eff,
        )

    def _recap_steps_k1(self, decode: DecodePlan) -> None:
        """Re-budget a declined mixed window's decode rows for a K=1
        emission.  The K=1 budget is NOT always 1: with the legacy
        host-side speculative path active, ``_step_budget(seq, 1)`` is
        ngram+1 — which can exceed the k_cap-iteration block allocation
        ``_mixed_window_decode_plan`` made (a deep-queue clamp can push
        k_cap below the draft budget), and the speculative dispatch
        indexes the block table for its whole budget.  Top the
        allocation up; under pool pressure trim the budget to the
        blocks held instead (the drafter derives its draft count from
        the budget, so a trimmed row just drafts less — greedy output
        is unchanged, acceptance merely caps earlier)."""
        bs = self.block_pool.block_size
        steps = []
        for seq in decode.seqs:
            k = self._step_budget(seq, 1)
            slots = seq.num_tokens + k - 1
            need = max(0, -(-slots // bs) - len(seq.block_table))
            if need:
                if self.block_pool.can_allocate(need):
                    seq.block_table.extend(self.block_pool.allocate(need))
                else:
                    k = max(
                        1,
                        len(seq.block_table) * bs - seq.num_tokens + 1,
                    )
            steps.append(k)
        decode.steps = steps

    def _mixed_window_decode_plan(self, k_cap: int) -> Optional[DecodePlan]:
        """Decode rows for a mixed K-step window, blocks pre-allocated
        for the whole k_cap budget.  Declines instead of preempting —
        pool pressure falls back to the K=1 path, which owns the
        preemption/rollback recovery machinery (and whose victim choice
        must not depend on whether a window was attempted)."""
        if not self.running:
            return None
        bs = self.block_pool.block_size
        steps = self._mixed_window_decode_steps(self.running, k_cap)
        needs = []
        for seq, k in zip(self.running, steps):
            slots = seq.num_tokens + max(k, 1) - 1
            needs.append(max(0, -(-slots // bs) - len(seq.block_table)))
        total = sum(needs)
        if total and not self.block_pool.can_allocate(total):
            return None
        for seq, need in zip(self.running, needs):
            if need:
                seq.block_table.extend(self.block_pool.allocate(need))
        return DecodePlan(seqs=list(self.running), steps=steps)

    def _try_schedule_prefill(
        self, chunk_budget: Optional[int] = None,
        force_bucket: Optional[int] = None,
    ) -> Optional[PrefillPlan]:
        """Plan one prefill step.  ``chunk_budget`` switches to mixed-step
        chunk mode: the padded length comes from ``prefill_chunk_buckets``
        (not ``prefill_buckets``) and may not exceed the budget.
        ``force_bucket`` (packed windows) pins the padded chunk shape to
        the window's established bucket — one scan has ONE static chunk
        shape, and a chunk smaller than the bucket rides padded
        (bit-identical: pf_valid masks padding and the tail-logit
        gather reads the last valid row)."""
        if len(self.running) >= self.config.max_num_seqs:
            return None
        queue = self._admission_queue()
        if not queue:
            return None
        seq = queue[0]
        if chunk_budget is not None:
            if force_bucket is not None:
                chunk_buckets = [force_bucket]
            else:
                chunk_buckets = [
                    b for b in self.config.prefill_chunk_buckets
                    if b <= chunk_budget
                ]
            sp = seq.sampling_params
            if not chunk_buckets or (sp.echo and sp.logprobs):
                # No chunk fits the budget, or the head needs the
                # prompt-logprobs prefill executable: no chunk this step
                # (the mixed caller degrades to decode-only; the classic
                # path serves echo+logprobs heads prefill-first).
                return None

        if seq.offloaded:
            # Page the KV snapshot back in; on "restored" the engine has
            # set block_table/num_cached_tokens/partial_prefill and the
            # plan below resumes from that held prefix (no recompute).
            # "retry" (transient pool pressure, snapshot kept) leaves the
            # offloaded flag set and lets decode free blocks first;
            # "gone" falls through to a plain re-prefill.
            result = self.restore_cb(seq) if self.restore_cb is not None else "gone"
            if result == "retry":
                return None
            seq.offloaded = False

        if seq.partial_prefill:
            # Chunks already written: the sequence owns its blocks.
            prefix_blocks = list(seq.block_table)
            cached_len = seq.num_cached_tokens
        elif seq.sampling_params.echo and seq.sampling_params.logprobs:
            # echo+logprobs needs a logprob for EVERY prompt position; a
            # prefix-cache hit would skip those rows' compute, so this
            # sequence prefills from scratch (vLLM's prompt_logprobs makes
            # the same trade).
            prefix_blocks, cached_len = [], 0
        else:
            prefix_blocks, cached_len = self.block_pool.match_prefix(
                seq.prompt_token_ids, namespace=seq.cache_ns
            )
            if self.remote_prefix_cb is not None:
                prefix_blocks, cached_len = self.remote_prefix_cb(
                    seq, prefix_blocks, cached_len
                )
        num_new = seq.num_prompt_tokens - cached_len
        if chunk_budget is not None:
            # Mixed-step chunk: pad to the chunk-bucket set so the fused
            # executable inventory stays |chunk_buckets| x |decode buckets|.
            fit = [b for b in chunk_buckets if b >= num_new]
            is_final = bool(fit)
            bucket = fit[0] if fit else chunk_buckets[-1]
            if not is_final:
                num_new = bucket
        else:
            bucket = self._bucket_for(num_new)
            is_final = bucket is not None
            if bucket is None:
                # Prompt longer than the largest bucket: chunked prefill —
                # run one full-bucket chunk now, keep the sequence at the
                # queue head, and continue next step from the accumulated
                # prefix.
                bucket = self.config.prefill_buckets[-1]
                num_new = bucket
        bs = self.block_pool.block_size
        blocks_needed = (num_new + bs - 1) // bs
        if not self.block_pool.can_allocate(blocks_needed):
            if not seq.partial_prefill:
                self.block_pool.free(prefix_blocks)
            return None
        new_blocks = self.block_pool.allocate(blocks_needed)
        seq.num_cached_tokens = cached_len
        seq.block_table = prefix_blocks + new_blocks
        if is_final:
            queue.popleft()
            self.queued_prompt_tokens -= seq.num_prompt_tokens
            seq.status = SequenceStatus.RUNNING
            seq.partial_prefill = False
            self.running.append(seq)
        else:
            seq.partial_prefill = True
            seq.num_cached_tokens = cached_len + num_new
        return PrefillPlan(
            seq=seq,
            bucket_len=bucket,
            new_block_ids=new_blocks,
            prefix_block_ids=prefix_blocks,
            num_new_tokens=num_new,
            cached_len=cached_len,
            is_final=is_final,
        )

    def _window_token_cap(self, window: int) -> int:
        """Per-row token ceiling for a pure-decode window plan: the
        max-acceptance growth K x (draft_len + 1) — draft_len from
        whichever drafter is configured (n-gram count or the model
        drafter's speculative_draft_len) — only when the fused drafter
        can actually engage: it drafts exclusively for all-greedy
        batches (the same temperature <= 0 predicate the engine
        dispatches on, read from broadcast SamplingParams so lockstep
        replicas agree) — and plain K otherwise, so sampled workloads
        never pre-allocate blocks for drafts that cannot happen.  A
        model-drafter window that declines to plain at dispatch time
        (draft-pool pressure) emits at most K tokens — strictly under
        this ceiling, so the pre-allocation stays sufficient."""
        if (
            window > 1
            and self.config.spec_window_enabled
            and all(
                s.sampling_params.temperature <= 0 for s in self.running
            )
        ):
            return window * (self.config.spec_draft_len + 1)
        return window

    def _step_budget(self, seq: Sequence, window: int = 1) -> int:
        """Decode TOKENS this sequence may emit in one window (or
        speculative) plan: bounded by max_model_len and the request's
        max_tokens (stop/EOS cut shorter — the device stop-mask freezes
        the row; a mismatching host-only condition discards on readback).
        Under the fused speculative window a K-iteration plan can land
        up to K x (ngram + 1) tokens at full acceptance, so the budget —
        and the block pre-allocation derived from it — covers the
        max-acceptance growth (_window_token_cap), never just the
        iteration count."""
        if window > 1:
            n = self._window_token_cap(window)
        else:
            # Legacy host-side speculation (and K=1 passes with
            # speculation on): K drafts + the bonus token per dispatch.
            n = max(1, self.config.speculative_ngram + 1)
        room_len = self.config.max_model_len - seq.num_tokens
        room_out = seq.sampling_params.max_tokens - seq.num_generated
        return max(1, min(n, room_len, room_out))

    def _try_schedule_decode(self, window: int = 1) -> Optional[DecodePlan]:
        if not self.running:
            return None
        bs = self.block_pool.block_size

        def blocks_needed(seq: Sequence) -> int:
            # Iteration i consumes the token at position num_tokens-1+i, so
            # a k-step budget writes KV through slot num_tokens+k-2 — the
            # table must cover num_tokens+k-1 slots (k=1: num_tokens).
            slots = seq.num_tokens + self._step_budget(seq, window) - 1
            return max(0, -(-slots // bs) - len(seq.block_table))

        # Ensure every running sequence has blocks for its whole budget;
        # preempt the youngest until the step fits.
        while self.running:
            need = sum(blocks_needed(seq) for seq in self.running)
            if self.block_pool.can_allocate(need):
                break
            self._preempt_youngest()
        if not self.running:
            return None
        for seq in self.running:
            need = blocks_needed(seq)
            if need:
                seq.block_table.extend(self.block_pool.allocate(need))
        return DecodePlan(
            seqs=list(self.running),
            steps=[self._step_budget(seq, window) for seq in self.running],
        )

    def schedule_provisional_window(
        self, inflight_seqs: List[Sequence], inflight_steps: List[int]
    ) -> Optional[StepPlan]:
        """Plan the NEXT K-step decode window while the previous window
        is still in flight on the device, under the optimistic
        assumption that no in-flight row stops early and every row emits
        its full ``inflight_steps`` budget (the device window carry
        keeps actually-stopped rows frozen; the engine discards their
        overrun on readback).  Declines (None) whenever the pipeline
        must break and replan synchronously: the running set changed, an
        admission is pending that a MIXED window cannot serve (window
        selection must drop to K=1 mixed steps), every row's remaining
        budget is zero, or backing the window would require preemption.
        A waiting head whose chunks CAN ride the scan chains a MIXED
        window off the in-flight carry instead of breaking the pipeline
        — the sustained-arrival case that used to serialize every
        window boundary into K=1 host round-trips."""
        window = self.config.window_steps
        if window <= 1:
            return None
        if len(self.running) < len(inflight_seqs) or any(
            a is not b for a, b in zip(self.running, inflight_seqs)
        ):
            return None
        parked = len(self.running) > len(inflight_seqs)
        if parked:
            # The in-flight window itself admitted prompts (packed
            # final chunks pop into self.running at plan time).  Those
            # rows have NO slot in the device carry yet — a chained
            # MIXED window may keep streaming over the carried rows
            # while the newcomers PARK for one window (their first
            # token is already finalized at the in-flight window's
            # collect; they join the batch at the next synchronous
            # rebuild).  Only the packed planner creates this shape,
            # and only when MORE packing work is waiting — otherwise
            # break the pipeline so the parked rows join immediately
            # (which also keeps the single-head seeded key-ordinal
            # stream bit-identical to the K=1 path).
            if not self.config.multi_prompt_window_enabled:
                return None
            if any(
                seq.num_generated > 0
                for seq in self.running[len(inflight_seqs):]
            ):
                return None  # not a parked admission: replan sync
        if not inflight_seqs:
            return None
        if self.waiting or self.preempted:
            plan = self._provisional_mixed_window(inflight_steps)
            if plan is not None:
                return plan
            if parked or not (
                self.config.multi_prompt_window_enabled
                and len(self.running) >= self.config.max_num_seqs
            ):
                return None
            if any(
                seq.remaining_budget <= prev_k
                for seq, prev_k in zip(inflight_seqs, inflight_steps)
            ):
                # A row exhausts its output budget INSIDE the in-flight
                # window: its slot frees at collect, so a chained pure
                # window would decode a dead row for K steps while this
                # waiting prompt could pack.  Break the pipeline; the
                # synchronous replan sees the freed slot.
                return None
            # Packed mode with a slot-full batch: no admission is
            # possible at this boundary no matter how it replans, so
            # chain a full pure-decode window off the carry instead of
            # breaking the pipeline into K=1 waiting_head steps
            # (mirrors _window_for_pass's slot-full rule).
        elif parked:
            return None  # nothing left to pack: rebuild with the rows
        bs = self.block_pool.block_size
        # Per-window per-row token ceiling: K x (ngram + 1) under the
        # fused speculative window at max acceptance (all-greedy batch),
        # K otherwise.
        max_tok = self._window_token_cap(window)
        rows = self.running[: len(inflight_seqs)]
        steps: List[int] = []
        needs: List[int] = []
        for seq, prev_k in zip(rows, inflight_steps):
            # The in-flight window will (optimistically) land its whole
            # prev_k token budget before this one runs (full acceptance
            # under speculation; the device carry keeps the real count
            # and the engine discards overrun on readback).
            base_tokens = seq.num_tokens + prev_k
            base_gen = seq.num_generated + prev_k
            room_len = self.config.max_model_len - base_tokens
            room_out = seq.sampling_params.max_tokens - base_gen
            k = max(0, min(max_tok, room_len, room_out))
            steps.append(k)
            slots = base_tokens + k - 1
            needs.append(max(0, -(-slots // bs) - len(seq.block_table)))
        if not any(steps):
            return None
        total = sum(needs)
        if total and not self.block_pool.can_allocate(total):
            return None
        for seq, need in zip(rows, needs):
            if need:
                seq.block_table.extend(self.block_pool.allocate(need))
        return StepPlan(
            decode=DecodePlan(seqs=list(rows), steps=steps),
            decode_window=window,
            provisional=True,
        )

    def _provisional_mixed_window(
        self, inflight_steps: List[int]
    ) -> Optional[StepPlan]:
        """Chain a MIXED K-step window off the in-flight carry for a
        waiting head: decode budgets are planned from the optimistic
        post-window base exactly like the pure provisional path, and the
        head's chunk schedule continues from its plan-time cursor (the
        in-flight window's chunks already advanced it).  Unlike the
        synchronous planner this EMITS single-chunk windows too — a
        1-iteration mixed scan is bit-identical to the K=1 mixed step
        and keeps the pipeline streaming through the admission.
        Declines (sync replan at the boundary) when the head cannot
        chunk at all."""
        cfg = self.config
        head = self._mixed_window_head()
        if head is None:
            return None
        # The chained scan's decode batch is the device CARRY's row set
        # (parked admissions from the in-flight window have no slot
        # yet), so the chunk budget and decode planning cover exactly
        # those rows.
        rows = self.running[: len(inflight_steps)]
        budget = self._chunk_token_budget(len(rows))
        buckets = self._chunk_buckets_in_budget(budget)
        if not buckets:
            return None
        packed = cfg.multi_prompt_window_enabled
        if packed:
            k_cap = cfg.window_steps
        else:
            k_cap = min(
                cfg.window_steps, cfg.mixed_window_clamp(self.num_waiting)
            )
        # Single-chunk heads decline (pipeline break -> the sync K=1
        # mixed step admits them whole): a 1-iteration scan would mint
        # a whole executable variant for zero amortization.  A prefix
        # hit discovered at chunk planning can still shrink a
        # multi-chunk head to one final chunk — that rare case emits
        # the 1-iteration window below rather than rolling back
        # committed plan state.  Packed windows keep chaining when
        # OTHER waiters could fill the remaining iterations.
        remaining_max = head.num_prompt_tokens - (
            head.num_cached_tokens if head.partial_prefill else 0
        )
        if remaining_max <= buckets[-1] and (
            not packed or self.num_waiting <= 1
        ):
            return None
        bs = self.block_pool.block_size
        bases = [
            (seq.num_tokens + prev_k, seq.num_generated + prev_k)
            for seq, prev_k in zip(rows, inflight_steps)
        ]
        steps = self._mixed_window_decode_steps(
            rows, k_cap, bases=bases
        )
        needs = []
        for (base_tokens, _), k, seq in zip(bases, steps, rows):
            slots = base_tokens + k - 1
            needs.append(max(0, -(-slots // bs) - len(seq.block_table)))
        total = sum(needs)
        if total and not self.block_pool.can_allocate(total):
            return None
        for seq, need in zip(rows, needs):
            if need:
                seq.block_table.extend(self.block_pool.allocate(need))
        # Snapshot BEFORE chunk planning: a final chunk pops the head
        # into self.running at plan time, and the popped head has no
        # decode row in THIS window (it joins at the next boundary).
        decode_seqs = list(rows)
        first = self._try_schedule_prefill(chunk_budget=budget)
        if first is None:
            # Nothing chunkable (pool pressure / restore retry): break
            # the pipeline so the sync pass re-evaluates at K=1.  The
            # decode blocks above stay in the block tables and back the
            # replanned step.
            return None
        if first.is_final and not packed:
            schedule = [first]
        else:
            schedule = self._extend_chunk_schedule(
                head, first, buckets, k_cap, budget
            )
        k_eff = len(schedule)
        return StepPlan(
            decode=DecodePlan(
                seqs=decode_seqs,
                steps=[min(s, k_eff) for s in steps],
            ),
            chunk_schedule=schedule,
            decode_window=k_eff,
            provisional=True,
        )

    def schedule_provisional(
        self, inflight_seqs: List[Sequence]
    ) -> Optional[DecodePlan]:
        """Plan the NEXT decode step while the previous one is still in
        flight on the device, under the optimistic assumption that no
        in-flight sequence finishes (the engine rolls back appends for
        sequences that did — the same overrun argument multi-step decode
        relies on).  Returns None whenever the pipeline must break and
        replan synchronously:

        * the running set changed under us (an abort landed),
        * an admission is pending (a waiting/preempted sequence could
          prefill into an open slot — ordering must match the
          synchronous scheduler),
        * any in-flight sequence PREDICTABLY finishes this step
          (max_tokens / max_model_len — length finishes are host-known
          before the token is),
        * backing the extra token would require preemption (provisional
          planning never preempts: the victim choice must see collected
          state).

        On success every returned sequence's block table already covers
        the provisional +1 token (at most one new block per sequence)."""
        if len(self.running) != len(inflight_seqs) or any(
            a is not b for a, b in zip(self.running, inflight_seqs)
        ):
            return None
        if not self.running:
            return None
        if (self.waiting or self.preempted) and (
            len(self.running) < self.config.max_num_seqs
        ):
            return None
        for seq in self.running:
            if seq.num_generated + 1 >= seq.sampling_params.max_tokens:
                return None
            if seq.num_tokens + 1 >= self.config.max_model_len:
                return None
        bs = self.block_pool.block_size
        needs = [
            # After the in-flight token lands the sequence holds
            # num_tokens+1 tokens; the next step writes KV at slot index
            # num_tokens, so the table must cover num_tokens+1 slots.
            max(0, -(-(seq.num_tokens + 1) // bs) - len(seq.block_table))
            for seq in self.running
        ]
        total = sum(needs)
        if total and not self.block_pool.can_allocate(total):
            return None
        for seq, need in zip(self.running, needs):
            if need:
                seq.block_table.extend(self.block_pool.allocate(need))
        return DecodePlan(seqs=list(self.running), steps=[1] * len(self.running))

    # -- preemption / release ---------------------------------------------

    def _preempt_youngest(self) -> None:
        # Victim: the lowest-priority running sequence (highest value),
        # youngest among equals — high-priority work survives pool
        # pressure at the expense of low-priority work.
        seq = max(
            self.running,
            key=lambda s: (s.sampling_params.priority,
                           getattr(s, "_admit_idx", 0)),
        )
        self.running.remove(seq)
        seq.status = SequenceStatus.PREEMPTED
        seq.preempt_count += 1
        self.num_preemptions += 1
        if self.config.preemption_mode == "offload" and self.offload_cb is not None:
            # Page the blocks to host DRAM *before* the pool can reuse them.
            seq.offloaded = bool(self.offload_cb(seq, list(seq.block_table)))
        self.block_pool.free(seq.block_table)
        seq.block_table = []
        # Re-prefill path treats all prior tokens as the new prompt.
        seq.outputs_absorbed += len(seq.output_token_ids)
        seq.prompt_token_ids = seq.all_token_ids
        seq.output_token_ids = []
        # Emptying output_token_ids re-arms the min_tokens floor (the
        # host predicate counts post-preemption output tokens); the
        # engine's cached boundary-crossing bit must re-arm with it.
        if getattr(seq, "_min_tok_pending", None) is not None:
            seq._min_tok_pending = (
                seq.sampling_params.min_tokens > 0
            )
        self.queued_prompt_tokens += seq.num_prompt_tokens
        self.preempted.appendleft(seq)
        logger.debug("Preempted %s (mode=%s)", seq.seq_id, self.config.preemption_mode)

    def _release(self, seq: Sequence) -> None:
        if seq.block_table:
            self.block_pool.free(seq.block_table)
            seq.block_table = []

    def finish_seq(self, seq: Sequence) -> None:
        if seq in self.running:
            self.running.remove(seq)
        # Register the sequence's full blocks for prefix reuse BEFORE
        # freeing, so the freed blocks enter the reclaimable LRU tier.
        self.block_pool.register_prefix(
            seq.all_token_ids, seq.block_table, namespace=seq.cache_ns
        )
        self._release(seq)
        seq.status = SequenceStatus.FINISHED
