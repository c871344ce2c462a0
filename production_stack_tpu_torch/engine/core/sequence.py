"""Request/sequence state for the serving engine."""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import List, Optional, Union


class SequenceStatus(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    PREEMPTED = "preempted"  # paged out (host DRAM) or dropped for recompute
    FINISHED = "finished"


class FinishReason(enum.Enum):
    STOP = "stop"  # EOS or stop string
    LENGTH = "length"
    ABORT = "abort"
    # response_format json_object whose assembled text failed the final
    # json.loads re-check (single-token decode() need not equal a token's
    # in-context byte contribution for sentencepiece/byte-BPE vocabs, so
    # the automaton can diverge from the emitted text; the finish-time
    # re-validation makes that divergence visible instead of silent).
    GUIDED_INVALID = "guided_invalid"


@dataclasses.dataclass
class SamplingParams:
    max_tokens: int = 128
    temperature: float = 0.0  # 0 -> greedy
    top_p: float = 1.0
    top_k: int = 0  # 0 -> disabled
    min_p: float = 0.0  # 0 -> disabled (vLLM min_p: mass cut vs the max prob)
    stop: Optional[List[str]] = None
    # Token ids that end generation like EOS, but are NOT appended to the
    # output (vLLM stop_token_ids semantics).
    stop_token_ids: Optional[List[int]] = None
    ignore_eos: bool = False
    seed: Optional[int] = None
    logprobs: bool = False
    top_logprobs: int = 0  # alternatives returned per token when logprobs
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    repetition_penalty: float = 1.0  # HF/vLLM semantics; 1.0 = off
    # vLLM min_tokens: EOS + stop_token_ids are suppressed at the logits
    # until this many tokens have been generated.
    min_tokens: int = 0
    # vLLM priority scheduling: LOWER value = scheduled earlier; equal
    # priorities keep FCFS order.  Preemption evicts the
    # highest-value (lowest-priority) running sequence first.
    priority: int = 0
    # OpenAI logit_bias: token id -> additive bias in [-100, 100].
    logit_bias: Optional[dict] = None
    # OpenAI completions echo: return the prompt ahead of the completion;
    # combined with logprobs, per-position prompt logprobs are computed
    # during prefill (the lm-eval-harness loglikelihood pattern).
    echo: bool = False
    # OpenAI response_format: None | "text" | "json_object" (byte-level
    # guided decoding, engine/guided.py) | {"type": "json_schema",
    # "schema": {...}} (schema-constrained script, engine/guided_schema.py).
    response_format: Union[str, dict, None] = None
    # Absolute wall-clock deadline (epoch seconds) propagated from the
    # client (X-Request-Deadline header / `timeout` body field).  The
    # server sheds at admission when the deadline is unmeetable; the
    # engine step loop aborts expired WAITING/PREEMPTED sequences so they
    # stop occupying queue slots and KV blocks (running sequences are
    # already streaming and are left to the client to cancel).  Lives on
    # SamplingParams so it rides the lockstep event broadcast unchanged —
    # only the leader evaluates it, and the resulting aborts are published
    # like any other (replica-deterministic).
    deadline: Optional[float] = None


@dataclasses.dataclass
class Sequence:
    seq_id: str
    prompt_token_ids: List[int]
    sampling_params: SamplingParams
    arrival_time: float = dataclasses.field(default_factory=time.time)

    status: SequenceStatus = SequenceStatus.WAITING
    # Multi-LoRA: adapter name + resolved slot (0 = base model, engine/lora.py).
    adapter: Optional[str] = None
    adapter_idx: int = 0
    # Prefix-cache namespace: a per-load-event id (NOT the slot index), so
    # KV cached by a slot's previous tenant can never be served after a
    # slot is reused or an adapter reloaded.
    cache_ns: int = 0
    output_token_ids: List[int] = dataclasses.field(default_factory=list)
    block_table: List[int] = dataclasses.field(default_factory=list)
    num_cached_tokens: int = 0  # prefix-cache hit length at admission
    finish_reason: Optional[FinishReason] = None
    first_token_time: Optional[float] = None
    # Observability (obs/): first prefill-chunk launch (ends the queue-wait
    # span) and the previous token's emit time (feeds the engine ITL
    # histogram).  Maintained only when obs.tracing is on.
    first_scheduled_time: Optional[float] = None
    last_token_time: Optional[float] = None
    # Host-offload bookkeeping: host buffer ids per paged-out block.
    offloaded: bool = False
    # Mid-chunked-prefill: the sequence sits at its queue's head holding
    # block_table/num_cached_tokens for the chunks already written; the
    # next prefill plan continues from there (scheduler.py).
    partial_prefill: bool = False
    preempt_count: int = 0
    # Generated tokens absorbed into prompt_token_ids by preemption
    # (re-prefill path); keeps max_tokens accounting correct across preempts.
    outputs_absorbed: int = 0
    # echo+logprobs: per-ABSOLUTE-position prompt logprob entries collected
    # during prefill (position -> (logprob|None, [(tid, lp), ...])), and
    # the original prompt length (preemption absorbs outputs into the
    # prompt; echoed positions never grow past this).
    prompt_lp: Optional[dict] = None
    echo_prompt_len: int = 0
    # Guided decoding state (engine/guided.py JsonGuide) when the request
    # set response_format.
    guide: Optional[object] = None
    # Cached host-state sampling verdicts (LLMEngine._host_state_flags):
    # the (window_fallback, classic_fallback, greedy) triple is static
    # over the request's life, so it's computed once instead of
    # re-reading SamplingParams attribute chains on the step thread
    # every dispatch (greedy = temperature <= 0, the fused speculative
    # window's drafting predicate).
    # _min_tok_pending is the ONE dynamic bit — the min_tokens floor is
    # still unmet — cleared by the engine exactly at the boundary
    # crossing and re-armed when preemption empties output_token_ids.
    _hs_flags: Optional[tuple] = None
    _min_tok_pending: Optional[bool] = None

    @property
    def num_prompt_tokens(self) -> int:
        return len(self.prompt_token_ids)

    @property
    def num_tokens(self) -> int:
        return len(self.prompt_token_ids) + len(self.output_token_ids)

    @property
    def all_token_ids(self) -> List[int]:
        return self.prompt_token_ids + self.output_token_ids

    @property
    def num_generated(self) -> int:
        """Total tokens generated for this request, across preemptions."""
        return self.outputs_absorbed + len(self.output_token_ids)

    @property
    def remaining_budget(self) -> int:
        """Output tokens this request may still generate (max_tokens
        minus generated; model-length limits and stop conditions may
        end it sooner).  The window planners use this as the earliest
        step a batch slot could free: a slot-full pure window under
        waiting pressure ends where the first row's budget runs out,
        so admission re-evaluates the moment packing becomes possible
        again."""
        return max(0, self.sampling_params.max_tokens - self.num_generated)

    @property
    def is_finished(self) -> bool:
        return self.status == SequenceStatus.FINISHED

    def blocks_needed(self, block_size: int) -> int:
        """Blocks for the whole sequence (prompt + outputs so far + 1 lookahead)."""
        return (self.num_tokens + block_size) // block_size


def host_state_flags(seq: Sequence) -> tuple:
    """(window_fallback, classic_fallback, greedy) cached verdicts —
    THE one place the host-state taxonomy lives, shared by the engine's
    dispatch gates and the scheduler's mixed-window planner (the
    scheduler must not plan a K-step mixed window the engine would have
    to fall back out of).  window_fallback: features the K-step window
    cannot serve on-device (logprobs, logit_bias, guided — penalties
    and the min_tokens floor run inside the scan).  classic_fallback:
    the stricter single-step-pipeline set (its sampler has no penalty
    path).  greedy: temperature <= 0 — the fused speculative window's
    drafting predicate.  All three are static over a request's life;
    the companion ``_min_tok_pending`` dynamic bit is armed here and
    cleared by the engine at the boundary crossing."""
    flags = seq._hs_flags
    if flags is None:
        sp = seq.sampling_params
        window = bool(
            sp.logprobs or sp.logit_bias or seq.guide is not None
        )
        classic = window or bool(
            sp.presence_penalty
            or sp.frequency_penalty
            or sp.repetition_penalty != 1.0
        )
        seq._hs_flags = flags = (window, classic, sp.temperature <= 0)
        seq._min_tok_pending = (
            sp.min_tokens > len(seq.output_token_ids)
        )
    return flags


@dataclasses.dataclass
class StepOutput:
    """One engine step's result for one sequence."""

    seq_id: str
    new_token_id: int
    finished: bool
    finish_reason: Optional[FinishReason]
    num_prompt_tokens: int
    num_output_tokens: int
    # Set when the request asked for logprobs: log P(chosen) and the top-k
    # alternatives as (token_id, logprob) pairs.
    logprob: Optional[float] = None
    top_logprobs: Optional[List] = None
    # First-token event of an echo+logprobs request: ordered per-prompt-
    # position entries [(logprob|None, top_pairs|None), ...] (index 0 is
    # None — no context predicts the first token).
    prompt_logprobs: Optional[List] = None
