"""LLMEngine: the serving engine core (PyTorch).

Counterpart of ``production_stack_tpu/engine/core/engine.py``, slimmed to
the main serving path: each ``step()`` runs one scheduler plan — a
(possibly chunked) prefill of one sequence, one single-token decode of
every running sequence, or a mixed step that does both in one forward —
synchronously, then samples on the host side of the one device read per
step (the sampled ids).

Owns the params and the paged KV caches on one device, the block pool
(hash-chained prefix cache, null block 0) and the scheduler.  The caches
are dense in the model dtype or, with ``cache.kv_cache_dtype="int8"``,
int8 ``(data, scale)`` tuples (``kv/quant.py``).  Prefill runs the
flash-prefill kernel and decode the paged-decode kernel for the cache
type whenever the tensors live on a CUDA device (``ops/attention.py``).

The engine serves the JAX package's engine at its K=1 path
(``SLICE_OVERRIDES``: no K-step windows, no lookahead pipeline, recompute
preemption, no LoRA / speculation / guided decoding / offload / remote
KV / parallelism / tracing; mixed steps on by default, dense or int8 KV)
and raises ``NotImplementedError`` at construction for any setting
outside it.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from production_stack_tpu_torch.engine import sampling as sampling_lib
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.core.scheduler import (
    DecodePlan,
    PrefillPlan,
    Scheduler,
)
from production_stack_tpu_torch.engine.core.sequence import (
    FinishReason,
    SamplingParams,
    Sequence,
    SequenceStatus,
    StepOutput,
)
from production_stack_tpu_torch.engine.kv.block_pool import BlockPool
from production_stack_tpu_torch.engine.models import llama
from production_stack_tpu_torch.engine.models.weights import load_params
from production_stack_tpu_torch.engine.tokenizer import get_tokenizer

logger = logging.getLogger(__name__)

# The configuration this engine serves, as ``config_from_preset``
# overrides: the JAX engine's K=1 path (mixed steps stay at their default).
SLICE_OVERRIDES = {
    "scheduler.multi_step_window": False,
    "scheduler.pipeline_decode": False,
    "scheduler.encode_lane": False,
    "scheduler.preemption_mode": "recompute",
    "obs.tracing": False,
}


def resolve_device(device=None) -> torch.device:
    """The engine's device: CUDA unless the caller asks for another one.
    Asking for CUDA (explicitly or by default) with no CUDA device raises:
    the port never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the engine runs on the card; pass "
            "device='cpu' to run on the CPU on purpose"
        )
    return dev


def _unsupported(config: EngineConfig) -> List[str]:
    """Settings outside the served configuration, by name."""
    m, c, s, p = config.model, config.cache, config.scheduler, config.parallel
    checks = [
        (s.window_steps != 1, "scheduler.multi_step_window (K-step windows)"),
        (s.mixed_window_enabled, "scheduler.mixed_window (mixed K-step windows)"),
        (s.pipeline_enabled, "scheduler.pipeline_decode (lookahead pipeline)"),
        (s.encode_lane_enabled, "scheduler.encode_lane (batched encode lane)"),
        (s.preemption_mode != "recompute", "scheduler.preemption_mode != recompute"),
        (s.spec_drafter is not None, "speculative decoding"),
        (c.host_offload_gb > 0, "cache.host_offload_gb (KV offload)"),
        (c.remote_kv_url is not None or c.disagg_role is not None,
         "cache.remote_kv_url / disagg_role (remote KV)"),
        (p.world_size != 1, "parallel (tp/dp/sp/ep)"),
        (config.lora.enabled, "lora"),
        (config.obs.tracing, "obs.tracing"),
        (m.quantization is not None, "model.quantization (int8 weights)"),
        (m.num_experts > 0, "model.num_experts (MoE)"),
        (config.weights_path is not None, "weights_path (HF safetensors)"),
    ]
    return [name for bad, name in checks if bad]


def _check_chunk_buckets(config: EngineConfig) -> None:
    """Mixed steps: every chunk bucket divides into whole blocks, so a
    non-final chunk leaves the cached prefix block-aligned."""
    if not config.scheduler.mixed_enabled:
        return
    bs = config.cache.block_size
    for bucket in config.scheduler.prefill_chunk_buckets:
        if bucket % bs:
            raise ValueError(
                f"prefill chunk bucket {bucket} not divisible by "
                f"block_size={bs} (non-final chunks must leave the cached "
                "prefix block-aligned)"
            )


class LLMEngine:
    def __init__(self, config: EngineConfig, device=None, params=None):
        """``device``: where the model runs (default CUDA; raises without
        one).  ``params``: a parameter tree already on ``device`` (e.g. from
        ``weights.params_from_numpy``); None boots the seeded random init."""
        bad = _unsupported(config)
        if bad:
            raise NotImplementedError(
                "the PyTorch engine serves only the K=1 path; "
                "unsupported settings: " + ", ".join(bad)
            )
        _check_chunk_buckets(config)
        self.config = config
        self.device = resolve_device(device)
        cfg = config.model
        self.tokenizer = get_tokenizer(config.tokenizer)
        if self.tokenizer.vocab_size > cfg.vocab_size:
            raise ValueError(
                f"Tokenizer vocab ({self.tokenizer.vocab_size}) exceeds model "
                f"vocab ({cfg.vocab_size})"
            )
        logger.info("Loading params for %s on %s ...", cfg.name, self.device)
        if params is None:
            params = load_params(cfg, config.weights_path, seed=config.seed,
                                 device=self.device)
        self.params = params
        llama.add_fp32_lm_head(self.params, cfg)

        num_blocks = self._decide_num_blocks()
        self.block_pool = BlockPool(
            num_blocks,
            config.cache.block_size,
            enable_prefix_caching=config.cache.enable_prefix_caching,
        )
        # Recompute preemption: no offload/restore/remote callbacks.
        self.scheduler = Scheduler(config.scheduler, self.block_pool)
        self.kv_caches = self._allocate_kv(num_blocks)
        logger.info(
            "KV pool: %d blocks x %d tokens (%.2f GiB)",
            num_blocks, config.cache.block_size,
            self._kv_bytes(num_blocks) / 2**30,
        )

        self._bmax = config.scheduler.max_model_len // config.cache.block_size
        self._smax = config.scheduler.max_num_seqs
        self._step_counter = 0
        self._bias_cache = None
        # Cumulative counters for stats().  admission_rejected is written
        # by the server's event loop, the rest by the step thread.
        self.total_prompt_tokens = 0
        self.total_generated_tokens = 0
        self.total_finished = 0
        # Prompt tokens prefilled inside mixed steps (nonzero: prompts
        # chunk alongside live decodes instead of stalling them).
        self.prefill_chunk_tokens = 0
        self.admission_rejected = 0
        self.num_steps = 0
        self._step_time_accum = 0.0

    # -- sizing ------------------------------------------------------------

    def _kv_bytes(self, num_blocks: int) -> int:
        cfg = self.config.model
        if self.config.cache.kv_cache_dtype == "int8":
            # int8 data + one fp32 scale per (token, KV head): about half
            # the bytes of bf16, so the pool holds about twice the tokens.
            per_token = 2 * cfg.num_kv_heads * (cfg.head_dim + 4)
        else:
            per_token = (
                2 * cfg.num_kv_heads * cfg.head_dim
                * llama.param_dtype(cfg).itemsize
            )
        return num_blocks * self.config.cache.block_size * per_token * cfg.num_layers

    def _decide_num_blocks(self) -> int:
        """Explicit ``cache.num_blocks``, else ``hbm_utilization`` of the
        card's free memory (after the weights) divided by a block's bytes
        over all layers; 512 blocks on the CPU, as the JAX engine keeps."""
        cache = self.config.cache
        if cache.num_blocks is not None:
            return cache.num_blocks
        if self.device.type != "cuda":
            return 512
        free, _total = torch.cuda.mem_get_info(self.device)
        return max(int(free * cache.hbm_utilization // self._kv_bytes(1)), 16)

    def _allocate_kv(self, num_blocks: int):
        cfg = self.config.model
        shape = (num_blocks, self.config.cache.block_size, cfg.num_kv_heads,
                 cfg.head_dim)
        if self.config.cache.kv_cache_dtype == "int8":
            # (data int8, scale fp32 [N, bs, K]) per side — kv/quant.py.
            def side():
                return (torch.zeros(shape, dtype=torch.int8, device=self.device),
                        torch.zeros(shape[:3], dtype=torch.float32,
                                    device=self.device))
        else:
            def side():
                return torch.zeros(shape, dtype=llama.param_dtype(cfg),
                                   device=self.device)
        return [(side(), side()) for _ in range(cfg.num_layers)]

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> tensor on the engine's device."""
        return torch.from_numpy(arr).to(self.device)

    # -- request lifecycle -------------------------------------------------

    def add_request(
        self,
        request_id: str,
        prompt: Optional[str] = None,
        prompt_token_ids: Optional[List[int]] = None,
        sampling_params: Optional[SamplingParams] = None,
        adapter: Optional[str] = None,
    ) -> None:
        if prompt_token_ids is None:
            if prompt is None:
                raise ValueError("need prompt or prompt_token_ids")
            prompt_token_ids = self.tokenizer.encode(prompt)
        if not prompt_token_ids:
            prompt_token_ids = [self.tokenizer.bos_token_id or 0]
        params_obj = sampling_params or SamplingParams()
        if adapter:
            raise ValueError(
                "LoRA adapter requested but this engine serves no adapters"
            )
        if params_obj.response_format not in (None, "text"):
            raise ValueError(
                f"response_format {params_obj.response_format!r}: guided "
                "decoding is not ported yet"
            )
        if params_obj.echo and params_obj.logprobs:
            raise ValueError("prompt logprobs (echo + logprobs) are not ported yet")
        if params_obj.deadline is not None:
            raise ValueError("request deadlines are not ported yet")
        seq = Sequence(
            seq_id=request_id,
            prompt_token_ids=list(prompt_token_ids),
            sampling_params=params_obj,
        )
        self.scheduler.add_seq(seq)
        self.total_prompt_tokens += len(prompt_token_ids)

    def abort_request(self, request_id: str) -> None:
        seq = self.scheduler.abort_seq(request_id)
        if seq is not None:
            seq.status = SequenceStatus.FINISHED
            seq.finish_reason = FinishReason.ABORT

    def has_unfinished(self) -> bool:
        return self.scheduler.has_unfinished()

    # -- stepping ----------------------------------------------------------

    def step(self) -> List[StepOutput]:
        """One engine step: schedule one plan and run it to its outputs
        (one dispatch, one collect — the only device read is the sampled
        ids).  Returns [] when nothing is schedulable."""
        t0 = time.time()
        plan = self.scheduler.schedule()
        if plan.is_empty:
            return []
        if plan.decode is None:
            outputs = self._run_prefill(plan.prefill_chunk)
        elif plan.prefill_chunk is not None:
            outputs = self._run_mixed(plan)
        else:
            outputs = self._run_decode(plan.decode)
        self._step_counter += 1
        self.num_steps += 1
        self._step_time_accum += time.time() - t0
        return outputs

    def _run_prefill(self, plan: PrefillPlan) -> List[StepOutput]:
        seq = plan.seq
        tokens, new_block_ids, prefix_ids = self._prefill_plan_arrays(plan)
        logits = llama.prefill(
            self.params, self.config.model,
            tokens=self._put(tokens),
            cached_len=plan.cached_len,
            prefix_block_ids=self._put(prefix_ids),
            new_block_ids=self._put(new_block_ids),
            valid_len=plan.num_new_tokens,
            kv_caches=self.kv_caches,
        )
        if not plan.is_final:
            # Non-final chunk of a long prompt: KV is written, the logits
            # are mid-prompt — nothing to sample yet.
            return []
        return self._finalize_final_prefill(seq, logits)

    def _prefill_plan_arrays(self, plan: PrefillPlan):
        """(tokens [T], new_block_ids [T//bs], prefix_ids [P]) host arrays
        for one PrefillPlan.  The JAX engine pads the prefix ids to the
        static block-table width (Bmax); eager PyTorch needs no static
        shape, so only the prefix's own blocks are passed — the result is
        the same, since padded slots are masked, and the flash kernel never
        walks the padding."""
        seq = plan.seq
        bs = self.block_pool.block_size
        T = plan.bucket_len
        new_tokens = seq.prompt_token_ids[
            plan.cached_len : plan.cached_len + plan.num_new_tokens
        ]
        tokens = np.zeros((T,), np.int32)
        tokens[: len(new_tokens)] = new_tokens
        new_block_ids = np.zeros((T // bs,), np.int32)
        new_block_ids[: len(plan.new_block_ids)] = plan.new_block_ids
        prefix_ids = np.asarray(plan.prefix_block_ids, np.int32).reshape(-1)
        return tokens, new_block_ids, prefix_ids

    def _finalize_final_prefill(
        self, seq: Sequence, last_logits: torch.Tensor
    ) -> List[StepOutput]:
        """Shared tail of every final prefill: the max_tokens == 0 scoring
        sentinel, or the request's first token sampled from the last valid
        row's logits [V]."""
        if seq.sampling_params.max_tokens == 0:
            seq.first_token_time = time.time()
            self._finish_seq_now(seq, FinishReason.LENGTH)
            return [StepOutput(
                seq_id=seq.seq_id,
                new_token_id=-1,
                finished=True,
                finish_reason=FinishReason.LENGTH,
                num_prompt_tokens=seq.num_prompt_tokens,
                num_output_tokens=0,
            )]
        token_ids, logprob_info = self._sample_batch(last_logits[None, :], [seq])
        return self._append_and_check(
            [seq], token_ids, first_token=True, logprob_info=logprob_info
        )

    def _decode_batch_arrays(self, seqs: List[Sequence], S: int):
        """Padded decode-row host arrays ([S] x5 + [S, bmax] tables).
        Padding rows keep null block 0 / ctx 0 (the kernel skips them)."""
        bs = self.block_pool.block_size
        tokens = np.zeros((S,), np.int32)
        positions = np.zeros((S,), np.int32)
        block_tables = np.zeros((S, self._bmax), np.int32)
        ctx_lens = np.zeros((S,), np.int32)
        slot_blocks = np.zeros((S,), np.int32)
        slot_offsets = np.zeros((S,), np.int32)
        for i, seq in enumerate(seqs):
            pos = seq.num_tokens - 1
            tokens[i] = seq.all_token_ids[-1]
            positions[i] = pos
            table = seq.block_table[: self._bmax]
            block_tables[i, : len(table)] = table
            ctx_lens[i] = seq.num_tokens
            slot_blocks[i] = seq.block_table[pos // bs]
            slot_offsets[i] = pos % bs
        return tokens, positions, block_tables, ctx_lens, slot_blocks, slot_offsets

    def _decode_bucket(self, n: int) -> int:
        """Decode batch sizes: the smallest power of two holding ``n``
        rows, capped at max_num_seqs."""
        b = 1
        while b < n:
            b *= 2
        return min(b, self._smax)

    def _run_decode(self, plan: DecodePlan) -> List[StepOutput]:
        seqs = plan.seqs
        S = self._decode_bucket(len(seqs))
        (tokens, positions, block_tables, ctx_lens, slot_blocks,
         slot_offsets) = self._decode_batch_arrays(seqs, S)
        logits = llama.decode(
            self.params, self.config.model,
            tokens=self._put(tokens),
            positions=self._put(positions),
            block_tables=self._put(block_tables),
            ctx_lens=self._put(ctx_lens),
            slot_block_ids=self._put(slot_blocks),
            slot_offsets=self._put(slot_offsets),
            kv_caches=self.kv_caches,
        )
        token_ids, logprob_info = self._sample_batch(logits[: len(seqs)], seqs)
        return self._append_and_check(
            seqs, token_ids, first_token=False, logprob_info=logprob_info
        )

    def _run_mixed(self, step_plan) -> List[StepOutput]:
        """One fused step over the packed [decode bucket + chunk bucket]
        token batch: every running sequence decodes as in _run_decode, and
        the head waiting sequence's prefill chunk rides along.  Decode rows
        are sampled first; only a final chunk samples its last valid row,
        through _finalize_final_prefill, as _run_prefill does."""
        plan = step_plan.prefill_chunk
        seqs = step_plan.decode.seqs
        S = self._decode_bucket(len(seqs))
        (tokens, positions, block_tables, ctx_lens, slot_blocks,
         slot_offsets) = self._decode_batch_arrays(seqs, S)
        pf_tokens, pf_new_blocks, pf_prefix = self._prefill_plan_arrays(plan)
        logits = llama.mixed_step(
            self.params, self.config.model,
            dec_tokens=self._put(tokens),
            dec_positions=self._put(positions),
            dec_block_tables=self._put(block_tables),
            dec_ctx_lens=self._put(ctx_lens),
            dec_slot_block_ids=self._put(slot_blocks),
            dec_slot_offsets=self._put(slot_offsets),
            pf_tokens=self._put(pf_tokens),
            pf_cached_len=plan.cached_len,
            pf_prefix_block_ids=self._put(pf_prefix),
            pf_new_block_ids=self._put(pf_new_blocks),
            pf_valid_len=plan.num_new_tokens,
            kv_caches=self.kv_caches,
        )
        self.prefill_chunk_tokens += plan.num_new_tokens
        token_ids, logprob_info = self._sample_batch(logits[: len(seqs)], seqs)
        outputs = self._append_and_check(
            seqs, token_ids, first_token=False, logprob_info=logprob_info
        )
        if plan.is_final:
            # The last row is the chunk's last valid token: the request's
            # first sampled token.
            outputs.extend(self._finalize_final_prefill(plan.seq, logits[-1]))
        return outputs

    # -- sampling ----------------------------------------------------------

    def _stop_set_ids(self, seq: Sequence) -> tuple:
        """The per-sequence stop set: ``stop_token_ids`` plus EOS unless
        ``ignore_eos`` — exactly what an unmet min_tokens floor suppresses.
        Out-of-vocab ids can never be sampled and are dropped."""
        sp = seq.sampling_params
        V = self.config.model.vocab_size
        ids = [t for t in (sp.stop_token_ids or ()) if 0 <= t < V]
        eos = self.tokenizer.eos_token_id
        if eos is not None and not sp.ignore_eos:
            ids.append(eos)
        return tuple(sorted(set(ids)))

    def _sampling_arrays(self, seqs: List[Sequence], S: int):
        """Padded per-sequence sampling parameter arrays [S]."""
        pad = S - len(seqs)
        temps = np.array(
            [s.sampling_params.temperature for s in seqs] + [0.0] * pad, np.float32
        )
        top_ps = np.array(
            [s.sampling_params.top_p for s in seqs] + [1.0] * pad, np.float32
        )
        top_ks = np.array(
            [s.sampling_params.top_k for s in seqs] + [0] * pad, np.int32
        )
        min_ps = np.array(
            [s.sampling_params.min_p for s in seqs] + [0.0] * pad, np.float32
        )
        seeds = [
            s.sampling_params.seed if s.sampling_params.seed is not None else idx
            for idx, s in enumerate(seqs)
        ] + [0] * pad
        return temps, top_ps, top_ks, min_ps, seeds

    def _sample_batch(self, logits: torch.Tensor, seqs: List[Sequence]):
        """Returns (token_ids, logprob_info): penalties, logit_bias and the
        min_tokens ban on the fp32 logits, then greedy/sampled choice;
        logprob_info holds None or (chosen_logprob, [(token_id, logprob),
        ...]) per sequence."""
        S = logits.shape[0]
        pad = S - len(seqs)

        use_rep = any(s.sampling_params.repetition_penalty != 1.0 for s in seqs)
        if use_rep or any(
            (s.sampling_params.presence_penalty
             or s.sampling_params.frequency_penalty)
            and s.output_token_ids
            for s in seqs
        ):
            max_len = max(max((len(s.output_token_ids) for s in seqs), default=1), 1)
            L = 64
            while L < max_len:
                L *= 2
            out_tokens = np.full((S, L), -1, np.int32)
            for i, s in enumerate(seqs):
                ids = s.output_token_ids[-L:]
                out_tokens[i, : len(ids)] = ids
            presence = np.array(
                [s.sampling_params.presence_penalty for s in seqs] + [0.0] * pad,
                np.float32,
            )
            frequency = np.array(
                [s.sampling_params.frequency_penalty for s in seqs] + [0.0] * pad,
                np.float32,
            )
            kwargs = {}
            if use_rep:
                # repetition_penalty covers prompt AND generated tokens.
                max_ctx = max(len(s.all_token_ids) for s in seqs)
                Lc = 64
                while Lc < max_ctx:
                    Lc *= 2
                ctx_tokens = np.full((S, Lc), -1, np.int32)
                for i, s in enumerate(seqs):
                    ids = s.all_token_ids[-Lc:]
                    ctx_tokens[i, : len(ids)] = ids
                kwargs = {
                    "repetition": self._put(np.array(
                        [s.sampling_params.repetition_penalty for s in seqs]
                        + [1.0] * pad, np.float32,
                    )),
                    "ctx_tokens": self._put(ctx_tokens),
                }
            logits = sampling_lib.apply_penalties(
                logits, self._put(out_tokens), self._put(presence),
                self._put(frequency), **kwargs,
            )

        # OpenAI logit_bias and the min_tokens ban: a dense [S, V] bias,
        # cached across steps keyed on the batch's bias composition.
        min_tok_banned = [
            self._stop_set_ids(s)
            if s.sampling_params.min_tokens > len(s.output_token_ids) else ()
            for s in seqs
        ]
        if any(s.sampling_params.logit_bias for s in seqs) or any(min_tok_banned):
            V = logits.shape[-1]
            key = (S, V) + tuple(
                (i,
                 tuple(sorted((s.sampling_params.logit_bias or {}).items())),
                 min_tok_banned[i])
                for i, s in enumerate(seqs)
            )
            if self._bias_cache is None or self._bias_cache[0] != key:
                bias = np.zeros((S, V), np.float32)
                for i, s in enumerate(seqs):
                    for tid, b in (s.sampling_params.logit_bias or {}).items():
                        t = int(tid)
                        if 0 <= t < V:
                            bias[i, t] = float(b)
                    for t in min_tok_banned[i]:
                        if 0 <= t < V:
                            bias[i, t] = -1e9
                self._bias_cache = (key, self._put(bias))
            logits = logits + self._bias_cache[1]

        temps, top_ps, top_ks, min_ps, seeds = self._sampling_arrays(seqs, S)
        out = sampling_lib.sample_tokens(
            logits,
            self._put(temps),
            self._put(top_ps),
            self._put(top_ks),
            step_seed=self.config.seed + self._step_counter,
            seq_seeds=seeds,
            min_p=self._put(min_ps),
        )
        token_ids = out[: len(seqs)].tolist()  # the step's device read

        logprob_info: List = [None] * len(seqs)
        if any(s.sampling_params.logprobs for s in seqs):
            chosen, top_ids, top_logps = sampling_lib.top_logprobs_of(
                logits, out, k=20
            )
            chosen = chosen.tolist()
            top_ids = top_ids.tolist()
            top_logps = top_logps.tolist()
            for i, s in enumerate(seqs):
                if s.sampling_params.logprobs:
                    n = s.sampling_params.top_logprobs
                    logprob_info[i] = (
                        float(chosen[i]),
                        [(int(top_ids[i][j]), float(top_logps[i][j]))
                         for j in range(n)],
                    )
        return token_ids, logprob_info

    # -- finishing ---------------------------------------------------------

    def _append_and_check(
        self,
        seqs: List[Sequence],
        token_ids: List[int],
        first_token: bool,
        logprob_info: Optional[List] = None,
    ) -> List[StepOutput]:
        outputs: List[StepOutput] = []
        now = time.time()
        if logprob_info is None:
            logprob_info = [None] * len(seqs)
        for seq, token_id, lp in zip(seqs, token_ids, logprob_info):
            sp = seq.sampling_params
            # vLLM stop_token_ids semantics: the token ends generation like
            # EOS but is never appended/streamed (-1 is the text-free
            # sentinel).
            stop_hit = bool(sp.stop_token_ids and token_id in sp.stop_token_ids)
            if not stop_hit:
                seq.output_token_ids.append(token_id)
                self.total_generated_tokens += 1
            if seq.first_token_time is None:
                seq.first_token_time = now
            if stop_hit:
                finish = FinishReason.STOP
                token_id = -1
                lp = None
            else:
                finish = self._check_finish(seq, token_id)
            if finish is not None:
                finish = self._finish_seq_now(seq, finish)
            outputs.append(
                StepOutput(
                    seq_id=seq.seq_id,
                    new_token_id=token_id,
                    finished=finish is not None,
                    finish_reason=finish,
                    num_prompt_tokens=seq.num_prompt_tokens,
                    num_output_tokens=seq.num_generated,
                    logprob=lp[0] if lp else None,
                    top_logprobs=lp[1] if lp else None,
                )
            )
        return outputs

    def _finish_seq_now(self, seq: Sequence, reason: FinishReason) -> FinishReason:
        """The single finish protocol: scheduler release + prefix-cache
        registration, counters, registry removal."""
        seq.finish_reason = reason
        self.scheduler.finish_seq(seq)
        self.total_finished += 1
        return reason

    def _check_finish(self, seq: Sequence, token_id: int) -> Optional[FinishReason]:
        sp = seq.sampling_params
        if (
            not sp.ignore_eos
            and self.tokenizer.eos_token_id is not None
            and token_id == self.tokenizer.eos_token_id
        ):
            return FinishReason.STOP
        if seq.num_generated >= sp.max_tokens:
            return FinishReason.LENGTH
        if seq.num_tokens >= self.config.scheduler.max_model_len:
            return FinishReason.LENGTH
        return None

    # -- stats -------------------------------------------------------------

    def stats(self) -> Dict[str, float]:
        return {
            "num_requests_running": self.scheduler.num_running,
            "num_requests_waiting": self.scheduler.num_waiting,
            "kv_usage_perc": self.block_pool.usage,
            "num_kv_blocks": self.block_pool.num_blocks,
            "prefix_cache_hit_rate": self.block_pool.prefix_hit_rate,
            "prefix_cache_hit_tokens": self.block_pool.hit_tokens,
            "prefix_cache_query_tokens": self.block_pool.query_tokens,
            "total_prompt_tokens": self.total_prompt_tokens,
            "total_generated_tokens": self.total_generated_tokens,
            "total_finished": self.total_finished,
            "num_preemptions": self.scheduler.num_preemptions,
            "prefill_chunk_tokens": self.prefill_chunk_tokens,
            "num_steps": self.num_steps,
            "step_seconds_total": self._step_time_accum,
            "admission_rejected_total": self.admission_rejected,
            "queued_prompt_tokens": self.scheduler.queued_prompt_tokens,
        }
