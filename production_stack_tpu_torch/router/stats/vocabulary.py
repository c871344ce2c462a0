"""Engine metric vocabulary — the single place TPU metric names live.

SURVEY.md section 7 "Hard parts" calls this out: the scraper, the Grafana
dashboard, the prometheus-adapter rule and the HPA all key off engine metric
names, and vLLM-TPU names differ from CUDA vLLM's (reference scraper
hard-codes ``vllm:gpu_cache_usage_perc`` etc. at
src/vllm_router/stats/engine_stats.py:52-55).

Canonical fields map to an ordered list of candidate Prometheus metric names;
the first present wins.  Our JAX engine emits the ``tpu:`` names; stock
vLLM(-TPU) emits the ``vllm:`` names — the scraper understands both, so the
router can front either engine.

A copy of ``production_stack_tpu/router/stats/vocabulary.py``: the port imports
nothing of the JAX package.
"""

from __future__ import annotations

from typing import Dict, List

# Canonical engine-stat field -> candidate gauge names, most preferred first.
ENGINE_METRIC_CANDIDATES: Dict[str, List[str]] = {
    "num_running_requests": [
        "tpu:num_requests_running",
        "vllm:num_requests_running",
    ],
    "num_queuing_requests": [
        "tpu:num_requests_waiting",
        "vllm:num_requests_waiting",
    ],
    # Fraction (0-1) of the paged-KV block pool in TPU HBM that is in use.
    "kv_usage_perc": [
        "tpu:hbm_kv_usage_perc",
        "vllm:gpu_cache_usage_perc",
        "vllm:cpu_cache_usage_perc",
    ],
    # Rolling prefix-cache hit rate (0-1).
    "prefix_cache_hit_rate": [
        "tpu:prefix_cache_hit_rate",
        "vllm:gpu_prefix_cache_hit_rate",
    ],
    # Fraction of KV blocks currently offloaded to host DRAM.
    "kv_offload_usage_perc": [
        "tpu:host_kv_usage_perc",
    ],
    # TPU duty cycle (0-1), the TPU analogue of GPU utilization.
    "accelerator_utilization": [
        "tpu:duty_cycle",
    ],
    # Mean host-side serialization per decode step, ms (pipeline health).
    "decode_host_gap_ms": [
        "tpu:decode_host_gap_ms",
    ],
    # Prompt tokens queued in waiting+preempted sequences (the disagg
    # policy's prefill-pool selection signal).
    "queued_prompt_tokens": [
        "tpu:queued_prompt_tokens",
    ],
    # Cumulative engine-side admission 429s.  The fleet capacity model
    # (router/capacity.py) treats a GROWING value as saturation evidence
    # even when another router instance absorbed the 429s.
    "admission_rejected_total": [
        "tpu:admission_rejected_total",
    ],
    # Prefix-cache truth counters/size.  The router's fleet popularity
    # view (routing/kv_aware.py) computes the fleet-wide KV hit rate
    # from the hit/query token counters and reconciles its prefix-owner
    # map against the cached-blocks gauge: a collapse to ~0 means the
    # engine restarted and every "resident" prefix there is gone.
    "prefix_cache_hit_tokens": [
        "tpu:prefix_cache_hit_tokens_total",
    ],
    "prefix_cache_query_tokens": [
        "tpu:prefix_cache_query_tokens_total",
    ],
    "prefix_cache_blocks": [
        "tpu:prefix_cache_blocks",
    ],
}

# Names our own engine exports (used by the engine server and the fake
# engine; keep in sync with ENGINE_METRIC_CANDIDATES above).
TPU_NUM_REQUESTS_RUNNING = "tpu:num_requests_running"
TPU_NUM_REQUESTS_WAITING = "tpu:num_requests_waiting"
TPU_HBM_KV_USAGE_PERC = "tpu:hbm_kv_usage_perc"
TPU_PREFIX_CACHE_HIT_RATE = "tpu:prefix_cache_hit_rate"
# Prefix-cache truth: cumulative matched/queried prompt tokens (counters
# — rates stay derivable after engine restarts, unlike the rolling-ratio
# gauge above) and content-valid blocks resident right now (gauge — the
# cache SIZE the router's popularity view reconciles owner maps against).
TPU_PREFIX_CACHE_HIT_TOKENS = "tpu:prefix_cache_hit_tokens_total"
TPU_PREFIX_CACHE_QUERY_TOKENS = "tpu:prefix_cache_query_tokens_total"
TPU_PREFIX_CACHE_BLOCKS = "tpu:prefix_cache_blocks"
TPU_HOST_KV_USAGE_PERC = "tpu:host_kv_usage_perc"
TPU_DUTY_CYCLE = "tpu:duty_cycle"
TPU_LOADED_LORAS = "tpu:loaded_loras"
# Mean host-side serialization per decode step, ms: time the accelerator
# sat idle between decode steps waiting on host work.  ≈0 when the
# engine's one-step-lookahead decode pipeline is active.
TPU_DECODE_HOST_GAP_MS = "tpu:decode_host_gap_ms"

# Remote-prefix prefetches currently in flight on the async KV transfer
# plane (gauge; a persistently high value beside a low hit rate means the
# store is slower than admission).
TPU_KV_PREFETCH_INFLIGHT = "tpu:kv_prefetch_inflight"

# Step-loop watchdog (gauge): seconds since the engine step thread last
# started an iteration.  A hung device dispatch stops it advancing; the
# engine's /health fails liveness past scheduler.step_watchdog_s, so k8s
# restarts a wedged engine instead of probing it green forever.
TPU_LAST_STEP_AGE = "tpu:last_step_age_seconds"
# Prompt tokens held by waiting+preempted sequences (gauge): the queue
# depth bounded admission enforces, in tokens.
TPU_QUEUED_PROMPT_TOKENS = "tpu:queued_prompt_tokens"

# The custom metric the prometheus-adapter exposes for HPA (reference:
# observability/prom-adapter.yaml:8-20 exposes vllm:num_requests_waiting).
HPA_QUEUE_METRIC = TPU_NUM_REQUESTS_WAITING

# Engine counters (monotonic; everything else above is a gauge).
TPU_TOTAL_PROMPT_TOKENS = "tpu:total_prompt_tokens"
TPU_TOTAL_GENERATED_TOKENS = "tpu:total_generated_tokens"
TPU_TOTAL_FINISHED_REQUESTS = "tpu:total_finished_requests"
TPU_NUM_PREEMPTIONS = "tpu:num_preemptions"
# Cross-engine prefix sharing (cache.disagg_role): blocks imported from /
# pushed to the shared store.
TPU_REMOTE_PREFIX_BLOCKS_FETCHED = "tpu:remote_prefix_blocks_fetched"
TPU_REMOTE_PREFIX_BLOCKS_EXPORTED = "tpu:remote_prefix_blocks_exported"
# N-gram speculative decoding effectiveness (acceptance rate =
# accepted/drafted; a low rate means the drafter wastes verify FLOPs).
TPU_SPEC_TOKENS_DRAFTED = "tpu:spec_tokens_drafted"
TPU_SPEC_TOKENS_ACCEPTED = "tpu:spec_tokens_accepted"
# Prompt tokens prefilled inside fused mixed decode+prefill steps
# (scheduler mixed_batch): nonzero means arriving prompts are chunking
# alongside live decodes instead of stalling them (the prefill/decode
# interference signal, read beside tpu:itl_seconds).
TPU_PREFILL_CHUNK_TOKENS = "tpu:prefill_chunk_tokens"
# Async KV transfer plane (kv/prefetch.py): blocks imported into the
# prefix cache by admission-time remote prefetch (hit) vs fetched and
# then dropped unused — cancelled, malformed, or undeliverable (waste).
# hit/(hit+waste) is the prefetch efficiency; read beside
# tpu:remote_kv_fetch_seconds for the latency the plane is hiding.
TPU_KV_PREFETCH_HIT = "tpu:kv_prefetch_hit"
TPU_KV_PREFETCH_WASTE = "tpu:kv_prefetch_waste"
# Overload protection (docs/robustness.md): requests shed by bounded
# admission with a structured 429, and requests shed/aborted because
# their client deadline expired before first token.
TPU_ADMISSION_REJECTED = "tpu:admission_rejected_total"
TPU_DEADLINE_EXPIRED = "tpu:deadline_expired_total"
# Fused speculative windows (scheduler speculative_ngram or
# speculative_model with the K-step window active): per-window outcome
# split of the on-device draft-and-verify — draft tokens the verifier
# accepted / rejected inside windows, plus window tokens emitted by the
# fused path but undeliverable at collect (abort / out-of-band finish
# mid-window) — split by the proposal source (drafter: ngram — prompt
# lookup from the carried history buffer; model — the tiny draft model
# riding the scan).  Acceptance RATE per drafter is accepted /
# (accepted + rejected) over this family; the unlabeled totals stay
# derivable from tpu:spec_tokens_{drafted,accepted}, which the fused
# path feeds alongside the legacy host path.
TPU_SPEC_WINDOW_TOKENS = "tpu:spec_window_tokens_total"
# The closed outcome and drafter sets, pre-seeded as zero-valued series
# so scrapers, dashboards, and rate() see stable label sets from boot.
TPU_SPEC_WINDOW_OUTCOMES = ("accepted", "rejected", "wasted")
TPU_SPEC_WINDOW_DRAFTERS = ("ngram", "model")
# Scan wall-time attributed to the draft model's forwards inside fused
# speculative windows (static cost-model split of the collect wait) —
# the overhead the model drafter's acceptance rate must out-earn.  The
# ngram drafter accrues ZERO here (its lookup is a gather, not a
# forward); compare rate() against tpu:spec_window_tokens_total
# {outcome="accepted",drafter="model"} for the speculation ROI.
TPU_SPEC_DRAFT_FRACTION_SECONDS = "tpu:spec_draft_fraction_seconds"
# K-step decode windows (scheduler multi_step_window): dispatches that
# fell back to single-step because a co-scheduled request needed
# host-sampled features (labeled by reason — logprobs / logit_bias /
# guided; one such request de-optimizes every co-scheduled stream) or
# because a waiting prompt forced K=1 admission cadence and the mixed
# K-step window could not serve it (waiting_head — with mixed windows
# on and chunkable traffic this series should sit at ZERO under load;
# a climbing rate means sustained arrivals are forfeiting the window
# amortization), and window tokens emitted but undeliverable (sequence
# aborted or finished out-of-band while the window flew; ordinary stops
# cost zero under the device stop-mask).  waste/total_generated is the
# amortization tax.
TPU_MULTISTEP_FALLBACK = "tpu:multistep_fallback_total"
# The closed reason set, pre-seeded as zero-valued series so scrapers,
# dashboards, and rate() see stable label sets from boot.  The mixed-
# window decline reasons are split so the flight recorder (and this
# family) can say WHY a waiting prompt forced K=1: bucket_mismatch — the
# head chunk fit no static chunk bucket; pool_pressure — the KV pool had
# no room for the chunk's blocks; waiting_head — the residual decline
# (mixed windows disabled, or an unpackable final chunk); draft_pool —
# the draft model's dedicated KV pool could not cover the batch, so the
# window ran plain (non-speculative) instead.
TPU_MULTISTEP_FALLBACK_REASONS = (
    "guided", "logit_bias", "logprobs", "waiting_head",
    "bucket_mismatch", "pool_pressure", "draft_pool",
)
TPU_MULTISTEP_WASTED_TOKENS = "tpu:multistep_wasted_tokens_total"
# Mixed K-step windows (scheduler mixed_window): prompt tokens whose
# prefill chunks rode the device-resident decode scan — the subset of
# tpu:prefill_chunk_tokens that did NOT pay a per-chunk host
# round-trip.  Its ratio to tpu:prefill_chunk_tokens is the window
# coverage of sustained-arrival prefill traffic.
TPU_MIXED_WINDOW_CHUNK_TOKENS = "tpu:mixed_window_chunk_tokens_total"
# Packed multi-prompt windows (scheduler multi_prompt_window): distinct
# prompts whose chunks rode EACH mixed K-step window, as a histogram —
# the packing depth.  A mass at bucket 1 under queue depth means the
# packed path is not engaging (flag off, or per-window admission
# declining); mass in the >1 buckets is queue depth being converted
# into device utilization.
TPU_MIXED_WINDOW_PROMPTS = "tpu:mixed_window_prompts_per_window"
# Batched encode lane (scheduler encode_lane; docs/engine.md "The encode
# lane"): texts embedded via the step thread's [B, T]-bucketed encode
# batches (counter), the queue of texts the batcher is carrying (gauge —
# the depth encode admission bounds), per-batch ACTUAL size as a
# histogram (mass near the top bucket means embed/rerank/score traffic
# is coalescing; mass stuck at 1 under load means it arrives too sparse
# to batch and is paying per-text dispatches), and per-batch wall
# seconds including the device sync.
TPU_ENCODE_TEXTS = "tpu:encode_texts_total"
TPU_ENCODE_QUEUE_DEPTH = "tpu:encode_queue_depth"
TPU_ENCODE_BATCH_SIZE = "tpu:encode_batch_size"
TPU_ENCODE_SECONDS = "tpu:encode_seconds"
# Seconds of host<->device transfer work issued while the device was
# BUSY with an in-flight window — H2D chunk staging for chained windows
# and D2H offload gathers dispatched under the scan.  Each second here
# is a stall the overlap-everything dispatch avoided; compare its rate
# to wall time for the overlap duty-cycle.
TPU_WINDOW_TRANSFER_OVERLAP_SECONDS = (
    "tpu:window_transfer_overlap_seconds_total"
)
# Disaggregated prefill/decode serving (docs/engine.md "Disaggregated
# data path"): prefill-phase prime completions served (the handoff
# producer side), and decode-phase handoff prefetch outcomes — a hit
# means the imported chain covered the whole prompt (decode executed no
# prompt tokens), a miss means the decode engine recomputed the prefill
# locally (the in-place fused fallback; reads beside
# tpu_router:disagg_fallback_total{reason="prefix_miss"}).
TPU_DISAGG_PREFILL_PRIMES = "tpu:disagg_prefill_primes_total"
TPU_DISAGG_HANDOFF_HITS = "tpu:disagg_handoff_hits_total"
TPU_DISAGG_HANDOFF_MISSES = "tpu:disagg_handoff_misses_total"
# Quantized KV tiering plane (engine/kv/quant.py, kvserver/protocol.py
# serde versioning): bytes crossing each tier boundary (tier ∈ host /
# remote) by wire representation (format ∈ dense / int8 — int8 is the
# native (data, scale) quantized wire, dense the legacy fp32/model-dtype
# wire), and KV snapshots encoded onto the kvserver wire by serde
# version (v1 = untagged dense, v2 = tagged quantized).  A quantized-
# cache fleet stuck on {format="dense"} / {version="v1"} means the
# store never advertised serde v2 — the rollout is incomplete and every
# offload/export is paying the retired 4x fp32 byte tax.
TPU_KV_WIRE_BYTES = "tpu:kv_wire_bytes_total"
TPU_KV_WIRE_TIERS = ("host", "remote")
TPU_KV_WIRE_FORMATS = ("dense", "int8")
TPU_KV_SNAPSHOT_FORMAT = "tpu:kv_snapshot_format_total"
TPU_KV_SNAPSHOT_VERSIONS = ("v1", "v2")
# Slice-coherent lifecycle (multi-host lockstep groups; docs/robustness.md
# "Slice lifecycle contract").  The leader exports group liveness truth:
# per-member seconds since the last lockstep ack advanced (a member
# frozen near --slice-member-timeout-s is about to fail the slice),
# the group epoch (leader boot nonce — strictly larger after every group
# restart, so a flat line that steps is a restart marker), member
# failures by reason, and follower->leader drain relays (preStop/SIGTERM
# on a follower drains the WHOLE slice through the leader).
TPU_LOCKSTEP_MEMBER_LAST_ACK = "tpu:lockstep_member_last_ack_seconds"
TPU_LOCKSTEP_GROUP_EPOCH = "tpu:lockstep_group_epoch"
TPU_LOCKSTEP_MEMBER_FAILURES = "tpu:lockstep_member_failures_total"
# The closed reason set, pre-seeded as zero-valued series so scrapers,
# dashboards, and rate() see stable label sets from boot.
TPU_LOCKSTEP_FAILURE_REASONS = ("member_silent", "epoch_mismatch")
TPU_SLICE_DRAIN_RELAYS = "tpu:slice_drain_relays_total"
# XLA compile-event tracking (obs/compile_tracker.py): seconds spent in
# trace+compile per executable shape key (labeled counter — the label is
# the jit entry point plus a compact arg-shape signature), and the count
# of distinct executable keys compiled since boot (gauge; read against
# the config-derived inventory at GET /debug/compiles for warmup
# coverage).  A compile_seconds series growing under steady traffic
# means live shapes are still missing from warmup.
TPU_COMPILE_SECONDS = "tpu:compile_seconds_total"
TPU_COMPILED_SHAPES = "tpu:compiled_shapes"
# Trace-ring eviction truth (obs/trace.py byte bound): completed
# /debug/requests records dropped by the count or byte bound.  Nonzero
# under a long-prompt burst is EXPECTED (the bound doing its job);
# silent unbounded growth is what it replaces.
TPU_OBS_TRACE_DROPPED = "tpu:obs_trace_dropped_total"
TPU_COUNTERS = frozenset({
    TPU_PREFIX_CACHE_HIT_TOKENS,
    TPU_PREFIX_CACHE_QUERY_TOKENS,
    TPU_TOTAL_PROMPT_TOKENS,
    TPU_TOTAL_GENERATED_TOKENS,
    TPU_TOTAL_FINISHED_REQUESTS,
    TPU_NUM_PREEMPTIONS,
    TPU_REMOTE_PREFIX_BLOCKS_FETCHED,
    TPU_REMOTE_PREFIX_BLOCKS_EXPORTED,
    TPU_SPEC_TOKENS_DRAFTED,
    TPU_SPEC_TOKENS_ACCEPTED,
    TPU_SPEC_DRAFT_FRACTION_SECONDS,
    TPU_PREFILL_CHUNK_TOKENS,
    TPU_KV_PREFETCH_HIT,
    TPU_KV_PREFETCH_WASTE,
    TPU_ADMISSION_REJECTED,
    TPU_DEADLINE_EXPIRED,
    TPU_MULTISTEP_WASTED_TOKENS,
    TPU_MIXED_WINDOW_CHUNK_TOKENS,
    TPU_ENCODE_TEXTS,
    TPU_WINDOW_TRANSFER_OVERLAP_SECONDS,
    TPU_DISAGG_PREFILL_PRIMES,
    TPU_DISAGG_HANDOFF_HITS,
    TPU_DISAGG_HANDOFF_MISSES,
    TPU_SLICE_DRAIN_RELAYS,
    TPU_OBS_TRACE_DROPPED,
})


# -- latency histogram families (this PR's tracing layer) ------------------
#
# Every span duration the tracing subsystem records also feeds a Prometheus
# HISTOGRAM (p50/p95/p99 queryable via histogram_quantile) alongside the
# pre-existing gauges, which keep their names unchanged.

# Engine request-level families, keyed by obs.EngineObs.REQUEST_HISTS names
# (one observation per request — except itl, observed per token GAP, so
# its _count is ~tokens not requests; detokenize_time is the request's
# total accumulated host detokenize cost).
TPU_REQUEST_HISTOGRAMS = {
    "ttft": "tpu:ttft_seconds",
    "itl": "tpu:itl_seconds",
    "e2e_latency": "tpu:e2e_latency_seconds",
    "queue_time": "tpu:queue_time_seconds",
    "prefill_time": "tpu:prefill_time_seconds",
    "decode_time": "tpu:decode_time_seconds",
    "detokenize_time": "tpu:detokenize_time_seconds",
}

# Engine step-phase families, keyed by obs.EngineObs.STEP_PHASES names
# (one observation per engine step — unit-comparable across phases).
TPU_STEP_HISTOGRAMS = {
    "schedule": "tpu:step_schedule_seconds",
    "dispatch": "tpu:step_dispatch_seconds",
    "collect": "tpu:step_collect_seconds",
    "sample": "tpu:step_sample_seconds",
    # Fused mixed decode+prefill-chunk steps, end-to-end wall time per
    # step (its _count / all-step counts = fraction of steps a prompt
    # chunked alongside live decodes).
    "mixed": "tpu:step_mixed_seconds",
}

# Async KV transfer-plane families, keyed by obs.EngineObs.KV_PHASES
# names.  remote_kv_fetch is one observation per store round-trip (MGET
# chain fetch or restore GET, observed on the fetcher threads) — the
# network latency the plane hides from the step loop; offload_stage is
# one observation per staged preemption snapshot (device gather dispatch
# -> host copy complete, observed on the stager's writer thread).
TPU_KV_HISTOGRAMS = {
    "remote_kv_fetch": "tpu:remote_kv_fetch_seconds",
    "offload_stage": "tpu:offload_stage_seconds",
}

# Router families (labeled by backend server), fed by RequestStatsMonitor.
ROUTER_HISTOGRAMS = {
    "ttft": "tpu_router:ttft_seconds",
    "itl": "tpu_router:itl_seconds",
    "latency": "tpu_router:e2e_latency_seconds",
    "queueing": "tpu_router:request_queueing_seconds",
}


def render_prometheus(pairs) -> str:
    """Serialize (name, value) pairs in Prometheus text format with TYPE
    lines.  Shared by the real engine server and the fake engine so the
    observability contract cannot silently diverge between them."""
    lines = []
    for name, value in pairs:
        kind = "counter" if name in TPU_COUNTERS else "gauge"
        lines.append(f"# TYPE {name} {kind}")
        lines.append(f"{name} {float(value)}")
    return "\n".join(lines) + "\n"


def render_labeled_counter(name: str, label: str, values) -> str:
    """Serialize one LABELED counter family ({label="key"} series from a
    plain dict).  The TYPE header renders even with no series yet so
    scrapers and dashboards see a stable family name from boot (same
    contract render_prometheus gives unlabeled families).  Shared by the
    real engine server and the fake engine."""
    lines = [f"# TYPE {name} counter"]
    for key in sorted(values):
        lines.append(f'{name}{{{label}="{key}"}} {float(values[key])}')
    return "\n".join(lines) + "\n"


def render_labeled_gauge(name: str, label: str, values) -> str:
    """Serialize one LABELED gauge family ({label="key"} series from a
    plain dict) — the gauge sibling of render_labeled_counter, with the
    same stable-TYPE-header contract.  Shared by the real engine server
    and the fake engine."""
    lines = [f"# TYPE {name} gauge"]
    for key in sorted(values):
        lines.append(f'{name}{{{label}="{key}"}} {float(values[key])}')
    return "\n".join(lines) + "\n"


def render_labeled_counter2(name: str, labels, values) -> str:
    """Two-label sibling of render_labeled_counter: ``values`` maps
    (label1_value, label2_value) tuples to counts.  Same stable-TYPE-
    header contract; shared by the real engine server and the fake
    engine."""
    l1, l2 = labels
    lines = [f"# TYPE {name} counter"]
    for key in sorted(values):
        lines.append(
            f'{name}{{{l1}="{key[0]}",{l2}="{key[1]}"}} '
            f"{float(values[key])}"
        )
    return "\n".join(lines) + "\n"
