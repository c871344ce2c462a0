"""OpenAI-compatible API server for the PyTorch engine.

Counterpart of ``production_stack_tpu/engine/server/api_server.py``: the
contract the router expects from a serving engine, over
:class:`AsyncEngine`.

- ``/v1/completions`` and ``/v1/chat/completions``: SSE streaming and not,
  ``n`` in [1, 16] choices (one engine request each), request deadlines
  (``X-Request-Deadline`` or a ``timeout`` body field: 504 when expired at
  admission or while queued), bounded admission (429 + ``Retry-After``);
- ``/v1/models``, ``/health`` (liveness, step watchdog), ``/ready``
  (readiness, 503 while draining) and ``POST /drain``; SIGTERM drains too;
- ``/metrics`` in the ``tpu:`` vocabulary (``router/stats/vocabulary.py``):
  every family the JAX engine renders, in its order, those of features not
  ported yet at zero, and the request, step and KV histograms that tracing
  feeds;
- request tracing (``obs/``, on by default; ``--no-tracing`` restores the
  untraced path): a trace starts after a request's validation with the
  router-propagated ``traceparent``, the detokenize time is added when it
  ends, and the first data chunk (or a non-streamed body) of a request in
  which a compile event fired (a CUDA-graph key's first use) carries
  ``"compile": true``; ``/debug/requests``, ``/debug/requests/{id}`` (the
  timeline joined with the windows it rode), ``/debug/windows`` (the
  flight recorder, ``?seq=``) and ``/debug/compiles`` (the compile events
  and the warmup coverage); a deadline the TTFT histogram says cannot be
  met is shed at admission (504 ``deadline_unmeetable``);
- ``/tokenize`` and ``/detokenize``;
- ``/start_profile`` and ``/stop_profile`` on ``torch.profiler`` (CUDA
  activity on the card), writing a Chrome trace into ``trace_dir``;
- the KV tiers' flags (``--host-offload-gb``, ``--remote-kv-url``,
  ``--disagg-role``, ...) and the two-phase disaggregated surface the
  router's ``disagg`` policy drives: ``x-disagg-phase: prefill`` runs the
  prefill, flushes the prompt's block export to the shared store and
  answers a handoff token instead of generating; ``x-disagg-handoff``
  waits (bounded) for that chain to be prefetched before admitting, and
  the response says how it went in ``X-Disagg-Prefix``;
- the encode surface: ``/v1/embeddings``, ``/v1/rerank`` and ``/rerank``,
  ``/v1/score`` and ``/score``, through the batched encode lane
  (``--no-encode-lane`` restores the serial per-text path), with bounded
  admission against the encode queue (429), deadlines (504) and the
  ``encode`` disagg role (a pool label the router's encode lane prefers:
  no KV handoff, no store);
- multi-LoRA (``--max-loras``, ``--max-lora-rank``): a completion whose
  model is ``"<base>:<adapter>"`` runs a loaded adapter (an unknown one
  gets a 400 before any stream starts), ``/v1/models`` lists each loaded
  adapter, and ``GET``/``POST /admin/lora`` and ``DELETE
  /admin/lora/{name}`` list, load (a PEFT safetensors file, read off the
  event loop) and unload adapters at run time;
- guided decoding (``response_format`` ``json_object`` and
  ``json_schema``; a schema outside the compiled subset gets a 400 before
  any stream starts), tool calls (``tools`` / ``tool_choice``: a forced
  tool's arguments are generated as guided JSON, under the tool's schema
  when it compiles, and answered as ``tool_calls``), and prompt logprobs
  (``echo`` with ``logprobs`` on completions: the prompt's per-position
  entries first in the ``logprobs`` block; ``max_tokens`` 0 scores the
  prompt alone).

It reuses nothing of the JAX module (which forces the JAX platform and
starts ``jax.distributed``).

    python -m production_stack_tpu_torch.engine.server.api_server \
        --model llama-3.1-8b --port 9200 [--device cuda] \
        [--speculative-ngram 3 | --speculative-model llama-3.2-1b]

``--weights-path`` loads an HF safetensors checkpoint and
``--quantization int8`` serves its projections as int8 weights (the
W8A16 kernel), as the JAX server's flags do.

``--tensor-parallel N`` shards the model over N tp positions
(``engine/parallel/``): all run by this process on the engine's device,
or, in a multi-process group (the JAX server's ``PSTPU_NUM_PROCESSES``,
``PSTPU_PROCESS_ID`` and ``PSTPU_COORDINATOR_ADDRESS``; one process a
card), ``N / world`` by each process on its own card.  As in the JAX
server, process 0 is the leader and serves the whole surface, publishing
each iteration's event batch to the followers (``parallel/
distributed.py``); a follower serves only ``/health``, ``/ready`` and a
``POST /drain`` (and SIGTERM) that it relays to the leader, and steps in
lockstep.  In a group the async KV transfer plane and the encode lane
default to off (the engine refuses an explicit
``cache.remote_prefetch=True`` there), the remote
KV store serves full-head blocks under one engine's keys (process 0
gathers the heads and writes; every rank imports its own heads, the group
taking the blocks every rank found), the encode routes run the serial
embed on every rank between steps, ``--data-parallel`` > 1 exits, the
leader's ``/health``
and ``/ready`` fail when a member goes silent past
``--slice-member-timeout-s``, and a follower's drain relay drains the
whole group through the leader.

``--data-parallel N`` and ``--sequence-parallel N`` (with
``--sequence-parallel-mode ring`` or ``ulysses``) are served in one
process, every position of the mesh on the engine's device: dp shards the
decode batch (its buckets start at N), sp runs each prompt's attention
over N sequence shards, and mixed steps go off, as in the JAX engine.  In
a multi-process group ``--sequence-parallel N`` runs one sp position a
process (the world divides by N; tp divides over the processes of a
position): each process runs its rows of a prompt's chunk and the ring
or Ulysses over its sp column, and the decode steps run replicated over
sp; ``--data-parallel`` > 1 still exits.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import logging
import os
import signal
import tempfile
import time
import uuid
from typing import Optional

import numpy as np
import torch
from aiohttp import web

from production_stack_tpu_torch.engine.config import config_from_preset
from production_stack_tpu_torch.engine.core.engine import SLICE_OVERRIDES
from production_stack_tpu_torch.engine.core.sequence import (
    FinishReason,
    SamplingParams,
)
from production_stack_tpu_torch.engine.guided_schema import (
    SchemaCompileError,
    compile_schema_cached,
)
from production_stack_tpu_torch.engine.server.async_engine import (
    AsyncEngine,
    DeadlineExceeded,
)
from production_stack_tpu_torch.obs.histogram import render_histogram
from production_stack_tpu_torch.obs.trace import parse_traceparent
from production_stack_tpu_torch.router.stats import vocabulary as vocab
from production_stack_tpu_torch.utils.drain import DrainController
from production_stack_tpu_torch.utils.net import parse_deadline

logger = logging.getLogger(__name__)


def _error(message: str, status: int = 400, type_: str = "invalid_request_error",
           **extra) -> web.Response:
    return web.json_response(
        {"error": {"message": message, "type": type_, **extra}}, status=status
    )


def _sampling_from_body(body: dict, chat: bool) -> SamplingParams:
    stop = body.get("stop")
    if isinstance(stop, str):
        stop = [stop]
    # logprobs: chat uses bool `logprobs` + int `top_logprobs`; the legacy
    # completions API uses int-or-null `logprobs` as the top-k count.
    if chat:
        want_logprobs = bool(body.get("logprobs", False))
        top_logprobs = int(body.get("top_logprobs") or 0)
    else:
        raw = body.get("logprobs")
        want_logprobs = raw is not None and raw is not False
        top_logprobs = int(raw or 0) if not isinstance(raw, bool) else 0
    logit_bias = body.get("logit_bias") or None
    if logit_bias is not None:
        if not isinstance(logit_bias, dict):
            raise ValueError("'logit_bias' must be a map of token id -> bias")
        try:
            logit_bias = {int(k): float(v) for k, v in logit_bias.items()}
        except (TypeError, ValueError):
            raise ValueError(
                "'logit_bias' keys must be token ids and values numbers"
            ) from None
    stop_token_ids = body.get("stop_token_ids") or None
    if stop_token_ids is not None:
        if not isinstance(stop_token_ids, list):
            raise ValueError("'stop_token_ids' must be a list of token ids")
        try:
            stop_token_ids = [int(t) for t in stop_token_ids]
        except (TypeError, ValueError):
            raise ValueError("'stop_token_ids' entries must be token ids") from None
    min_p = float(body.get("min_p") or 0.0)
    if not 0.0 <= min_p <= 1.0:
        raise ValueError(f"'min_p' must be in [0, 1], got {min_p}")
    response_format = None
    rf = body.get("response_format")
    if rf is not None:
        rf_type = rf.get("type") if isinstance(rf, dict) else rf
        if rf_type == "json_object":
            response_format = "json_object"
        elif rf_type == "json_schema":
            # OpenAI structured outputs: {"type": "json_schema",
            # "json_schema": {"name": ..., "schema": {...}, "strict": ...}}.
            spec = rf.get("json_schema") if isinstance(rf, dict) else None
            if not isinstance(spec, dict):
                raise ValueError(
                    "response_format json_schema requires a 'json_schema' "
                    "object"
                )
            schema = spec.get("schema")
            if not isinstance(schema, dict):
                raise ValueError(
                    "response_format json_schema requires "
                    "json_schema.schema (an object)"
                )
            # Compiled here so an unsupported schema gets a 400 before any
            # stream starts (SchemaCompileError is a ValueError); the
            # cache lets each sequence's guide reuse this compilation.
            compile_schema_cached(schema)
            response_format = {"type": "json_schema", "schema": schema}
        elif rf_type not in ("text", None):
            raise ValueError(
                f"Unsupported response_format type {rf_type!r} "
                "(supported: text, json_object, json_schema)"
            )
    raw_max = body.get("max_tokens")
    if raw_max is None:
        raw_max = body.get("max_completion_tokens")
    # An explicit 0 scores the prompt (echo + logprobs) and generates
    # nothing; only absence takes the default.
    max_tokens = 128 if raw_max is None else int(raw_max)
    if max_tokens < 0:
        raise ValueError(f"'max_tokens' must be >= 0, got {max_tokens}")
    rep = body.get("repetition_penalty")
    if rep is not None and not (isinstance(rep, (int, float)) and rep > 0):
        raise ValueError(
            f"'repetition_penalty' must be a positive number, got {rep}"
        )
    min_tokens = int(body.get("min_tokens") or 0)
    if min_tokens < 0 or min_tokens > max_tokens:
        raise ValueError(
            f"'min_tokens' must be in [0, max_tokens], got {min_tokens}"
        )
    return SamplingParams(
        max_tokens=max_tokens,
        temperature=float(body.get("temperature") or 0.0),
        top_p=float(body.get("top_p") or 1.0),
        top_k=int(body.get("top_k") or 0),
        min_p=min_p,
        stop=stop,
        stop_token_ids=stop_token_ids,
        logit_bias=logit_bias,
        echo=bool(body.get("echo")) and not chat,
        # Guided decoding forces EOS when the value completes, so
        # ignore_eos would loop forever: response_format wins.
        ignore_eos=bool(body.get("ignore_eos", False)) and response_format is None,
        response_format=response_format,
        seed=body.get("seed"),
        logprobs=want_logprobs,
        top_logprobs=max(0, min(top_logprobs, 20)),
        presence_penalty=float(body.get("presence_penalty") or 0.0),
        frequency_penalty=float(body.get("frequency_penalty") or 0.0),
        repetition_penalty=float(body.get("repetition_penalty") or 1.0),
        min_tokens=min_tokens,
        priority=int(body.get("priority") or 0),
    )


class StopChecker:
    """Incremental detokenization with stop-string truncation."""

    def __init__(self, tokenizer, stop: Optional[list]):
        self.tokenizer = tokenizer
        self.stop = stop or []
        self.token_ids: list = []
        self.emitted_text = ""

    def push(self, token_id: int):
        """Returns (delta_text, stopped).  Negative ids are no-text
        sentinels (a stop_token_ids match ends generation without
        contributing text)."""
        if token_id >= 0:
            self.token_ids.append(token_id)
        text = self.tokenizer.decode(self.token_ids)
        for s in self.stop:
            idx = text.find(s)
            if idx != -1:
                delta = text[len(self.emitted_text) : idx]
                self.emitted_text = text[:idx]
                return delta, True
        # Hold back a partial-stop suffix so half a stop string never goes out.
        hold = 0
        for s in self.stop:
            for k in range(1, len(s)):
                if text.endswith(s[:k]):
                    hold = max(hold, k)
        safe = text[: len(text) - hold] if hold else text
        delta = safe[len(self.emitted_text) :]
        if delta:
            self.emitted_text = safe
        return delta, False

    def flush(self) -> str:
        """Held-back text when generation ends without a stop match."""
        text = self.tokenizer.decode(self.token_ids)
        delta = text[len(self.emitted_text):]
        self.emitted_text = text
        return delta

    def aligned_token_count(self) -> int:
        """Largest k such that the first k tokens detokenize within the
        emitted (stop-trimmed) text: how many tokens' logprobs entries
        align with the returned content."""
        emitted = len(self.emitted_text)
        for k in range(len(self.token_ids), -1, -1):
            if len(self.tokenizer.decode(self.token_ids[:k])) <= emitted:
                return k
        return 0




def _finish_reason(event, stopped: bool) -> str:
    if stopped or event.finish_reason == FinishReason.STOP:
        return "stop"
    if event.finish_reason == FinishReason.GUIDED_INVALID:
        return "guided_invalid"
    return "length"


def _forced_tool(tools, tool_choice) -> Optional[dict]:
    """The tool a chat request forces (``tool_choice`` a function or
    ``"required"``), None for ``"auto"`` / ``"none"``; raises ValueError
    with the JAX server's message for a malformed request."""
    if tool_choice not in ("auto", "none") and not tools:
        # OpenAI: tool_choice is only allowed when tools are given.
        raise ValueError("'tool_choice' requires a non-empty 'tools' array")
    if not tools:
        return None
    if not isinstance(tools, list) or not all(
        isinstance(t, dict) and t.get("type") == "function"
        and isinstance(t.get("function"), dict) and t["function"].get("name")
        for t in tools
    ):
        raise ValueError(
            "'tools' must be a list of {type: function, function: {name, ...}}"
        )
    if isinstance(tool_choice, dict):
        wanted = (tool_choice.get("function") or {}).get("name")
        match = [t for t in tools if t["function"]["name"] == wanted]
        if not match:
            raise ValueError(f"tool_choice function {wanted!r} not in tools")
        return match[0]
    if tool_choice == "required":
        if len(tools) > 1:
            # Choosing among several tools needs a per-family output
            # parser; the caller forces one instead of getting tools[0].
            raise ValueError(
                "tool_choice 'required' with multiple tools is not "
                "supported; force one with {type: function, function: "
                "{name: ...}}"
            )
        return tools[0]
    if tool_choice not in ("auto", "none"):
        raise ValueError(
            f"Unsupported tool_choice {tool_choice!r} (auto | none | "
            "required | {type: function, ...})"
        )
    return None


def _steer_messages(messages: list, tool: dict) -> list:
    """The messages with a forced tool's instruction on the last user
    turn (an appended system message would be refused by strict
    templates); the JSON guarantee itself comes from guided decoding."""
    steer = (
        f"\n\n(Call the function {tool['function']['name']} by replying "
        "with ONLY its JSON arguments object.)"
    )
    messages = list(messages)
    if messages and messages[-1].get("role") == "user" and \
            isinstance(messages[-1].get("content"), str):
        messages[-1] = dict(messages[-1], content=messages[-1]["content"] + steer)
    else:
        messages.append({"role": "user", "content": steer.strip()})
    return messages


def _tool_response_format(tool: dict):
    """A forced tool's arguments format: its parameters schema when that
    compiles under the guided subset (strict tool calls), else any JSON
    object."""
    schema = (tool.get("function") or {}).get("parameters")
    if isinstance(schema, dict):
        try:
            compile_schema_cached(schema)
            return {"type": "json_schema", "schema": schema}
        except SchemaCompileError:
            pass  # outside the subset: the generic JSON guarantee
    return "json_object"


def _parses(text: str) -> bool:
    try:
        json.loads(text)
        return True
    except json.JSONDecodeError:
        return False


def _is_engine_data_plane(request: web.Request) -> bool:
    """Model-serving work a draining engine refuses (the router's drain
    middleware draws the same line): completions and the other POST or
    DELETE routes of the data plane.  GET control-plane routes (/health,
    /ready, /metrics) and POST /drain itself stay served throughout."""
    if request.method not in ("POST", "DELETE") or request.path == "/drain":
        return False
    return (
        request.path.startswith("/v1/")
        or request.path in ("/rerank", "/score", "/tokenize", "/detokenize")
        or request.path.startswith("/admin/")
    )


def render_metrics(engine: AsyncEngine) -> str:
    """The ``/metrics`` body: the JAX engine's families in its order, with
    this engine's values.  Families of features not ported yet render at
    zero, their closed label sets pre-seeded; the request, step and KV
    histograms last (observed only with tracing on, rendered either way so
    the names are scrape-stable).  The group families carry the leader's
    monitor (empty member set and zeros outside a group)."""
    s = engine.stats()
    monitor = engine.slice_monitor
    pairs = [
        (vocab.TPU_NUM_REQUESTS_RUNNING, s["num_requests_running"]),
        (vocab.TPU_NUM_REQUESTS_WAITING, s["num_requests_waiting"]),
        (vocab.TPU_HBM_KV_USAGE_PERC, s["hbm_kv_usage_perc"]),
        (vocab.TPU_PREFIX_CACHE_HIT_RATE, s["prefix_cache_hit_rate"]),
        (vocab.TPU_PREFIX_CACHE_HIT_TOKENS, s["prefix_cache_hit_tokens"]),
        (vocab.TPU_PREFIX_CACHE_QUERY_TOKENS, s["prefix_cache_query_tokens"]),
        (vocab.TPU_PREFIX_CACHE_BLOCKS, s["prefix_cache_blocks"]),
        (vocab.TPU_HOST_KV_USAGE_PERC, s["host_kv_usage_perc"]),
        (vocab.TPU_DUTY_CYCLE, s["duty_cycle"]),
        (vocab.TPU_DECODE_HOST_GAP_MS, s["decode_host_gap_ms"]),
        (vocab.TPU_LOADED_LORAS, s["loaded_loras"]),
        (vocab.TPU_TOTAL_PROMPT_TOKENS, s["total_prompt_tokens"]),
        (vocab.TPU_TOTAL_GENERATED_TOKENS, s["total_generated_tokens"]),
        (vocab.TPU_TOTAL_FINISHED_REQUESTS, s["total_finished"]),
        (vocab.TPU_NUM_PREEMPTIONS, s["num_preemptions"]),
        (vocab.TPU_REMOTE_PREFIX_BLOCKS_FETCHED, s["remote_prefix_blocks_fetched"]),
        (vocab.TPU_REMOTE_PREFIX_BLOCKS_EXPORTED, s["remote_prefix_blocks_exported"]),
        (vocab.TPU_DISAGG_PREFILL_PRIMES, s["disagg_prefill_primes"]),
        (vocab.TPU_DISAGG_HANDOFF_HITS, s["disagg_handoff_hits"]),
        (vocab.TPU_DISAGG_HANDOFF_MISSES, s["disagg_handoff_misses"]),
        (vocab.TPU_KV_PREFETCH_HIT, s["kv_prefetch_hit"]),
        (vocab.TPU_KV_PREFETCH_WASTE, s["kv_prefetch_waste"]),
        (vocab.TPU_KV_PREFETCH_INFLIGHT, s["kv_prefetch_inflight"]),
        (vocab.TPU_SPEC_TOKENS_DRAFTED, s["spec_tokens_drafted"]),
        (vocab.TPU_SPEC_TOKENS_ACCEPTED, s["spec_tokens_accepted"]),
        (vocab.TPU_PREFILL_CHUNK_TOKENS, s["prefill_chunk_tokens"]),
        (vocab.TPU_MIXED_WINDOW_CHUNK_TOKENS, s["mixed_window_chunk_tokens"]),
        (vocab.TPU_WINDOW_TRANSFER_OVERLAP_SECONDS,
         s["window_transfer_overlap_seconds"]),
        (vocab.TPU_ADMISSION_REJECTED, s["admission_rejected_total"]),
        (vocab.TPU_DEADLINE_EXPIRED, s["deadline_expired_total"]),
        (vocab.TPU_QUEUED_PROMPT_TOKENS, s["queued_prompt_tokens"]),
        (vocab.TPU_LAST_STEP_AGE, engine.last_step_age_s),
        (vocab.TPU_MULTISTEP_WASTED_TOKENS, s["multistep_wasted_tokens"]),
        (vocab.TPU_LOCKSTEP_GROUP_EPOCH, engine.slice_epoch),
        (vocab.TPU_SLICE_DRAIN_RELAYS,
         monitor.drain_relays if monitor is not None else 0),
    ]
    spec_tokens = {
        **{(o, d): 0 for o in vocab.TPU_SPEC_WINDOW_OUTCOMES
           for d in vocab.TPU_SPEC_WINDOW_DRAFTERS},
        **{(o, s["spec_drafter"]): v for o, v in s["spec_window_tokens"].items()
           if s["spec_drafter"]},
    }
    wire_bytes = {
        **{(t, f): 0 for t in vocab.TPU_KV_WIRE_TIERS
           for f in vocab.TPU_KV_WIRE_FORMATS},
        **s["kv_wire_bytes"],
    }
    parts = [
        vocab.render_prometheus(pairs),
        vocab.render_labeled_counter(
            vocab.TPU_MULTISTEP_FALLBACK, "reason",
            {**dict.fromkeys(vocab.TPU_MULTISTEP_FALLBACK_REASONS, 0),
             **s["multistep_fallback"]},
        ),
        vocab.render_labeled_counter2(
            vocab.TPU_SPEC_WINDOW_TOKENS, ("outcome", "drafter"), spec_tokens),
        vocab.render_prometheus([(vocab.TPU_SPEC_DRAFT_FRACTION_SECONDS,
                                  s["spec_draft_fraction_seconds"])]),
        vocab.render_labeled_counter2(
            vocab.TPU_KV_WIRE_BYTES, ("tier", "format"), wire_bytes),
        vocab.render_labeled_counter(
            vocab.TPU_KV_SNAPSHOT_FORMAT, "version",
            {**dict.fromkeys(vocab.TPU_KV_SNAPSHOT_VERSIONS, 0),
             **s["kv_snapshot_format"]},
        ),
        vocab.render_labeled_gauge(
            vocab.TPU_LOCKSTEP_MEMBER_LAST_ACK, "member",
            {} if monitor is None else {
                str(pid): age for pid, age in monitor.member_ack_ages().items()
            },
        ),
        vocab.render_labeled_counter(
            vocab.TPU_LOCKSTEP_MEMBER_FAILURES, "reason",
            {**dict.fromkeys(vocab.TPU_LOCKSTEP_FAILURE_REASONS, 0),
             **({} if monitor is None else monitor.member_failures)},
        ),
        render_histogram(vocab.TPU_MIXED_WINDOW_PROMPTS,
                         engine.engine.mixed_window_prompts_hist),
        vocab.render_prometheus([
            (vocab.TPU_ENCODE_TEXTS, s["encode_texts_total"]),
            (vocab.TPU_ENCODE_QUEUE_DEPTH, s["encode_queue_depth"]),
        ]),
        render_histogram(vocab.TPU_ENCODE_BATCH_SIZE,
                         engine.engine.encode_batch_size_hist),
        render_histogram(vocab.TPU_ENCODE_SECONDS, engine.engine.encode_seconds_hist),
        vocab.render_labeled_counter(
            vocab.TPU_COMPILE_SECONDS, "executable", s["compile_seconds"]),
        vocab.render_prometheus([
            (vocab.TPU_COMPILED_SHAPES, s["compiled_shapes"]),
            (vocab.TPU_OBS_TRACE_DROPPED, s["obs_trace_dropped"]),
        ]),
        engine.engine.obs.render_metrics(),
    ]
    return "".join(parts)


def _start_torch_profiler(device: torch.device):
    """A started ``torch.profiler`` session: CPU activity, and CUDA
    activity for an engine on the card (an error when this build cannot
    trace it: a profile of the card without the card's kernels would
    pass for one)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        cuda = torch.profiler.ProfilerActivity.CUDA
        if cuda not in torch.profiler.supported_activities():
            raise RuntimeError("this torch build cannot trace CUDA activity")
        activities.append(cuda)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def _export_trace(prof, trace_dir: str) -> str:
    """Write a stopped session's Chrome trace into ``trace_dir``; returns
    its path."""
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(
        trace_dir, f"trace-{os.getpid()}-{int(time.time() * 1000)}.json"
    )
    prof.export_chrome_trace(path)
    return path


def build_engine_app(
    engine: AsyncEngine, served_model: str, drain_grace_s: float = 30.0
) -> web.Application:
    # /drain (helm preStop) and SIGTERM (main) both land on this
    # controller.  Busy = a stream still attached or a sequence still
    # decoding.  exit_cb stays None here; main() installs a SIGINT to self
    # so the process exits 0 once the drain ends.
    drain = DrainController(
        grace_s=drain_grace_s,
        busy_fn=lambda: bool(engine._queues) or engine.engine.has_unfinished(),
    )

    @web.middleware
    async def drain_gate(request: web.Request, handler):
        """503 + Connection: close for all data-plane work during a drain,
        in one place so no route can forget it."""
        if drain.draining and _is_engine_data_plane(request):
            resp = web.json_response(
                {"error": {"message": "server is draining for shutdown",
                           "type": "shutting_down", "code": 503}},
                status=503,
            )
            resp.force_close()
            return resp
        return await handler(request)

    app = web.Application(middlewares=[drain_gate])
    app["engine"] = engine
    app["drain"] = drain

    def _watchdog_problem() -> Optional[str]:
        if not engine.step_thread_healthy:
            return "engine step thread died"
        # Group liveness conjunction: the leader is the group's one
        # discovery endpoint, so a silent member fails the whole group's
        # health here, within --slice-member-timeout-s, well before the
        # step watchdog would notice the wedged collective.
        slice_problem = engine.slice_problem()
        if slice_problem is not None:
            return slice_problem
        wd = engine.engine.config.scheduler.step_watchdog_s
        age = engine.last_step_age_s
        if wd and age > wd:
            return (
                f"step loop stalled: last iteration started {age:.1f}s ago "
                f"(watchdog {wd:.0f}s)"
            )
        return None

    async def models(_req: web.Request) -> web.Response:
        def card(model_id: str) -> dict:
            return {
                "id": model_id,
                "object": "model",
                "created": int(time.time()),
                "owned_by": "production-stack-tpu",
            }

        # Loaded LoRA adapters are addressable as "<base>:<adapter>".
        data = [card(served_model)] + [
            card(f"{served_model}:{name}")
            for name in engine.engine.loaded_adapters()
        ]
        return web.json_response({"object": "list", "data": data})

    async def health(_req: web.Request) -> web.Response:
        """Liveness: fails when the step thread died or stalled past
        scheduler.step_watchdog_s, not during a drain (a kubelet killing a
        draining pod would drop the streams the drain exists to finish)."""
        problem = _watchdog_problem()
        if problem is not None:
            return web.json_response(
                {"status": "unhealthy", "problem": problem,
                 "last_step_age_s": engine.last_step_age_s}, status=503,
            )
        return web.json_response(
            {"status": "ok", "last_step_age_s": engine.last_step_age_s}
        )

    async def ready(_req: web.Request) -> web.Response:
        """Readiness: also fails while draining, so the Service (and the
        router's discovery) drops the pod while its streams finish."""
        if drain.draining:
            return web.json_response(
                {"status": "draining", "in_flight_streams": len(engine._queues)},
                status=503,
            )
        problem = _watchdog_problem()
        if problem is not None:
            return web.json_response(
                {"status": "unhealthy", "problem": problem}, status=503
            )
        return web.json_response({"status": "ready"})

    async def drain_endpoint(_req: web.Request) -> web.Response:
        """POST /drain: flip readiness, stop admission, let in-flight
        streams finish within the grace, then exit."""
        drain.begin()
        return web.json_response({
            "draining": True,
            "in_flight_streams": len(engine._queues),
            "unfinished_sequences": engine.engine.has_unfinished(),
            "grace_s": drain.grace_s,
        })

    async def metrics(_req: web.Request) -> web.Response:
        return web.Response(text=render_metrics(engine))

    # -- request tracing debug surface (obs/) ------------------------------

    async def debug_requests(_req: web.Request) -> web.Response:
        """Ring buffer of completed request timelines, newest first."""
        return web.json_response(engine.engine.obs.debug_payload())

    async def debug_request(request: web.Request) -> web.Response:
        snap = engine.engine.obs.request_payload(request.match_info["request_id"])
        if snap is None:
            return web.json_response(
                {"error": {"message": "unknown request id (expired from the "
                           "trace ring, or tracing is off)"}},
                status=404,
            )
        return web.json_response(snap)

    async def debug_windows(request: web.Request) -> web.Response:
        """Window flight-recorder ring, newest first (?seq= filters to
        windows one sequence rode)."""
        return web.json_response(
            engine.engine.obs.windows_payload(seq=request.query.get("seq") or None)
        )

    async def debug_compiles(_req: web.Request) -> web.Response:
        """Compile events (graph keys' first use) per executable key +
        warmup coverage report."""
        return web.json_response(engine.engine.compiles_payload())

    async def chat_completions(request: web.Request) -> web.StreamResponse:
        return await _serve_completion(request, chat=True)

    async def completions(request: web.Request) -> web.StreamResponse:
        return await _serve_completion(request, chat=False)

    async def _serve_completion(request: web.Request, chat: bool) -> web.StreamResponse:
        try:
            body = await request.json()
        except json.JSONDecodeError:
            return _error("invalid JSON")
        tokenizer = engine.engine.tokenizer
        forced_tool = None
        if chat:
            tools = body.get("tools")
            tool_choice = body.get("tool_choice", "auto")
            try:
                forced_tool = _forced_tool(tools, tool_choice)
            except ValueError as e:
                return _error(str(e))
            messages = list(body.get("messages") or [])
            if forced_tool is not None:
                messages = _steer_messages(messages, forced_tool)
            prompt = tokenizer.apply_chat_template(
                messages,
                # 'none': the model must not call tools, so it is not
                # prompted with them.
                tools=tools if tool_choice != "none" else None,
            )
        else:
            prompt = body.get("prompt") or ""
            if isinstance(prompt, list):
                prompt = "\n".join(str(p) for p in prompt)
        try:
            params = _sampling_from_body(body, chat)
        except (TypeError, ValueError) as e:
            return _error(str(e))
        stream = bool(body.get("stream", False))
        stream_options = body.get("stream_options")
        if stream_options is not None and (
            not isinstance(stream_options, dict) or not stream
        ):
            return _error("'stream_options' must be an object, with 'stream' true")
        include_usage = bool((stream_options or {}).get("include_usage"))
        if params.echo and stream:
            return _error("'echo' is not supported with streaming")
        if forced_tool is not None:
            if stream:
                return _error("forced tool_choice is not supported with streaming")
            params.response_format = _tool_response_format(forced_tool)
            params.ignore_eos = False
        request_id = (
            request.headers.get("x-request-id") or f"cmpl-{uuid.uuid4().hex[:16]}"
        )
        created = int(time.time())
        model_name = body.get("model", served_model)
        # "<base>:<adapter>" selects a loaded LoRA adapter; validated before
        # any stream starts so an unknown adapter gets a clean 400.  Only
        # on a LoRA-enabled engine: otherwise ':' stays an opaque character
        # of the model id.
        adapter = None
        if ":" in model_name and engine.engine.lora_registry is not None:
            _, adapter = model_name.split(":", 1)
            try:
                engine.engine.lora_registry.slot_of(adapter)
            except ValueError as e:
                return _error(str(e), code=404)
        object_name = "chat.completion.chunk" if chat else "text_completion"
        prompt_token_ids = tokenizer.encode(prompt)
        max_len = engine.engine.config.scheduler.max_model_len
        if len(prompt_token_ids) >= max_len:
            return _error(
                f"This model's maximum context length is {max_len} tokens, "
                f"but the prompt is {len(prompt_token_ids)} tokens long",
                code="context_length_exceeded",
            )
        # n > 1: one engine request a choice (OpenAI `n`).
        n_choices = body.get("n", 1)
        if n_choices is None:
            n_choices = 1
        if not isinstance(n_choices, int) or isinstance(n_choices, bool):
            # int() would silently truncate 2.9 and accept True.
            return _error(f"n must be an integer, got {body.get('n')!r}")
        if not 1 <= n_choices <= 16:
            return _error(f"n must be in [1, 16], got {n_choices}")

        now = time.time()
        try:
            deadline = parse_deadline(request.headers, body, now)
        except ValueError as e:
            return _error(str(e))
        rejection = engine.check_admission(
            n_choices, n_choices * len(prompt_token_ids)
        )
        if rejection is not None:
            engine.engine.admission_rejected += 1
            return web.json_response(
                {"error": {
                    "message": (
                        f"engine overloaded: {rejection.queued_requests} "
                        f"requests ({rejection.queued_tokens} prompt tokens) "
                        f"already queued; retry after {rejection.retry_after_s}s"
                    ),
                    "type": "overloaded", "code": 429,
                    "detail": dataclasses.asdict(rejection),
                }},
                status=429,
                headers={"Retry-After": str(rejection.retry_after_s)},
            )
        if deadline is not None:
            params.deadline = deadline
            if now >= deadline:
                # The event loop's own counter: the step thread owns
                # deadline_expired.
                engine.engine.deadline_expired_admission += 1
                return _error("request deadline already expired at admission",
                              504, "deadline_expired", code=504)
            # "Would miss the deadline before its first token: shed now":
            # the observed median TTFT scaled by the queue depth in batch
            # units.  Only once the histogram holds real observations;
            # with tracing off it holds none, and the queued-expiry sweep
            # does the work.
            ttft_hist = engine.engine.obs.request_hists["ttft"]
            if ttft_hist.count >= 8:
                est_wait = ttft_hist.quantile(0.5) * (
                    1.0 + engine.engine.scheduler.num_waiting
                    / max(1, engine.engine.config.scheduler.max_num_seqs)
                )
                if now + est_wait > deadline:
                    engine.engine.deadline_expired_admission += 1
                    return _error(
                        f"deadline unmeetable: estimated {est_wait:.2f}s to "
                        "first token exceeds the remaining budget",
                        504, "deadline_unmeetable", code=504)

        # -- disaggregated prefill phase --------------------------------
        # The router's disagg policy primes a prefill-pool engine with
        # this marker: run the prefill, flush the prompt's block export
        # so the shared store holds it before we answer (the decode
        # side's prefetch must never race the export writer), and return
        # a handoff token instead of generating.
        if request.headers.get("x-disagg-phase") == "prefill":
            return await _serve_prefill_phase(
                request_id, prompt_token_ids, params, created, model_name, adapter)

        # -- disaggregated decode phase ---------------------------------
        # A handoff-tagged generation waits (bounded, off the event loop
        # and off the step thread) for the prefetched chain to be staged,
        # so its first schedule() serves the whole prompt from the prefix
        # cache.  Any other outcome admits normally: the engine computes
        # the prefill itself, never failing the request.
        disagg_prefix_outcome: Optional[str] = None
        handoff_hdr = request.headers.get("x-disagg-handoff")
        if handoff_hdr:
            disagg_prefix_outcome = await _wait_handoff(
                handoff_hdr, prompt_token_ids, deadline, adapter)

        obs = engine.engine.obs
        if obs.enabled:
            # Only after every validation 400 above: a rejected request
            # must not leave an active trace behind.  The router-propagated
            # W3C context joins this timeline to the router's.  With n > 1
            # the trace follows choice 0, which shares the request id.
            obs.start_request(
                request_id,
                parse_traceparent(request.headers.get("traceparent")),
                model=model_name, path=request.path, stream=stream, n=n_choices,
            )

        def choice_params(i: int) -> SamplingParams:
            """Choice i's sampling: a seeded request's choice i takes
            seed + i, so the choices differ and each replays alone."""
            if params.seed is None or i == 0:
                return params if i == 0 else dataclasses.replace(params)
            return dataclasses.replace(params, seed=params.seed + i)

        choice_ids = [
            request_id if i == 0 else f"{request_id}-c{i}"
            for i in range(n_choices)
        ]
        gens = [
            engine.generate(
                prompt_token_ids=prompt_token_ids,
                sampling_params=choice_params(i),
                request_id=choice_ids[i],
                adapter=adapter,
            )
            for i in range(n_choices)
        ]
        checkers = [StopChecker(tokenizer, params.stop) for _ in range(n_choices)]
        # Host detokenize time across all choices, reported to the obs
        # layer when the request ends; with tracing off the push is untimed.
        detok_s = [0.0]
        if obs.enabled:
            def push(checker: StopChecker, token_id: int):
                t0 = time.perf_counter()
                out = checker.push(token_id)
                detok_s[0] += time.perf_counter() - t0
                return out
        else:
            def push(checker: StopChecker, token_id: int):
                return checker.push(token_id)

        def token_text(token_id: int) -> str:
            return tokenizer.decode([token_id]) if token_id >= 0 else ""

        def logprob_entry(event) -> dict:
            return {
                "token": token_text(event.token_id),
                "logprob": event.logprob,
                "top_logprobs": [
                    {"token": tokenizer.decode([tid]), "logprob": lp}
                    for tid, lp in (event.top_logprobs or [])
                ],
            }

        # Running text_offset per choice for completions logprobs.
        offsets = [0] * n_choices

        def chunk_payload(delta_text: str, finish_reason, first: bool,
                          event=None, index: int = 0):
            if chat:
                delta = {"role": "assistant"} if first else {}
                if delta_text:
                    delta["content"] = delta_text
                choice = {"index": index, "delta": delta,
                          "finish_reason": finish_reason}
                if params.logprobs and event is not None:
                    choice["logprobs"] = {"content": [logprob_entry(event)]}
            else:
                choice = {"index": index, "text": delta_text,
                          "finish_reason": finish_reason}
                if params.logprobs and event is not None:
                    tok = token_text(event.token_id)
                    choice["logprobs"] = {
                        "tokens": [tok],
                        "token_logprobs": [event.logprob],
                        "top_logprobs": [{
                            tokenizer.decode([tid]): lp
                            for tid, lp in (event.top_logprobs or [])
                        }],
                        "text_offset": [offsets[index]],
                    }
                    offsets[index] += len(tok)
            return {"id": request_id, "object": object_name, "created": created,
                    "model": model_name, "choices": [choice]}

        def usage(completion_tokens: int) -> dict:
            return {
                "prompt_tokens": len(prompt_token_ids),
                "completion_tokens": completion_tokens,
                "total_tokens": len(prompt_token_ids) + completion_tokens,
            }

        if stream:
            stream_headers = {
                "Content-Type": "text/event-stream",
                "Cache-Control": "no-cache",
                "X-Request-Id": request_id,
            }
            if disagg_prefix_outcome is not None:
                stream_headers["X-Disagg-Prefix"] = disagg_prefix_outcome
            response = web.StreamResponse(headers=stream_headers)
            await response.prepare(request)
            # The n choices' event streams merge through one queue, so
            # chunks interleave as tokens arrive (each carries its index).
            queue: asyncio.Queue = asyncio.Queue()

            async def pump(i: int, g):
                try:
                    async for ev in g:
                        await queue.put((i, ev, None))
                    await queue.put((i, None, None))
                except Exception as e:  # surfaced on the write loop
                    await queue.put((i, None, e))

            pumps = [asyncio.create_task(pump(i, g)) for i, g in enumerate(gens)]
            first = [True] * n_choices
            live = [True] * n_choices
            retired = [False] * n_choices  # taken off `remaining` by hand
            total_out = 0
            shed_on_deadline = False
            # The compile taint rides the first data chunk (the headers
            # left at prepare(), before the first token): the router's
            # proxy reads it to keep a compile-excluded TTFT window.
            compile_stamped = False
            try:
                remaining = n_choices
                while remaining:
                    i, event, error = await queue.get()
                    if error is not None:
                        if isinstance(error, DeadlineExceeded):
                            # Expired while queued: the stream is already
                            # open, so a structured SSE error event (and
                            # no [DONE]: the stream did not complete).
                            shed_on_deadline = True
                            err = {"error": {"message": str(error),
                                             "type": "deadline_expired",
                                             "code": 504}}
                            await response.write(
                                f"data: {json.dumps(err)}\n\n".encode())
                            break
                        raise error
                    if event is None:
                        # A choice retired on a stop match was deducted
                        # already; its pump may still send its sentinel.
                        if not retired[i]:
                            remaining -= 1
                        continue
                    if not live[i]:
                        continue  # events after a stop of an aborting choice
                    checker = checkers[i]
                    delta, stopped = push(checker, event.token_id)
                    if event.finished and not stopped:
                        delta += checker.flush()
                    if delta or first[i] or params.logprobs:
                        payload = chunk_payload(
                            delta, None, first[i],
                            event=None if stopped or event.token_id < 0 else event,
                            index=i,
                        )
                        if not compile_stamped:
                            compile_stamped = True
                            if obs.compile_tainted(request_id):
                                payload["compile"] = True
                        await response.write(f"data: {json.dumps(payload)}\n\n".encode())
                        first[i] = False
                    if stopped or event.finished:
                        if stopped and not event.finished:
                            # An abort sends no further events, so this
                            # pump never sends its sentinel: retire the
                            # choice here (cancelling the pump closes its
                            # generator, which aborts it in the engine).
                            pumps[i].cancel()
                            retired[i] = True
                            remaining -= 1
                        live[i] = False
                        total_out += event.num_output_tokens
                        final = chunk_payload("", _finish_reason(event, stopped),
                                              first[i], index=i)
                        await response.write(f"data: {json.dumps(final)}\n\n".encode())
                if include_usage and not shed_on_deadline:
                    chunk = {"id": request_id, "object": object_name,
                             "created": created, "model": model_name,
                             "choices": [], "usage": usage(total_out)}
                    await response.write(f"data: {json.dumps(chunk)}\n\n".encode())
                if not shed_on_deadline:
                    await response.write(b"data: [DONE]\n\n")
                await response.write_eof()
            except ConnectionResetError:
                pass  # the finally aborts every live choice
            finally:
                # Cancelling a pump closes its generator, which aborts the
                # choice in the engine if it has not finished: a
                # disconnect never leaves siblings decoding for nobody.
                for task in pumps:
                    task.cancel()
                obs.record_detokenize(request_id, detok_s[0])
            return response

        # Not streaming: drain the choices concurrently (a sequential loop
        # would submit choice i+1 only after choice i finished).
        async def drain_choice(i: int, gen):
            checker = checkers[i]
            text_parts, entries = [], []
            finish, out_tokens, prompt_lp = "length", 0, None
            async for event in gen:
                if event.prompt_logprobs is not None:
                    prompt_lp = event.prompt_logprobs
                delta, stopped = push(checker, event.token_id)
                text_parts.append(delta)
                if params.logprobs and event.token_id >= 0:
                    entries.append(event)
                if stopped:
                    finish, out_tokens = "stop", event.num_output_tokens
                    if not event.finished:
                        await engine.abort(choice_ids[i])
                    break
                if event.finished:
                    text_parts.append(checker.flush())
                    finish = _finish_reason(event, False)
                    out_tokens = event.num_output_tokens
                    break
            if params.logprobs:
                # Tokens a (multi-token) stop string consumed leave the
                # content, and their entries with them.
                entries = entries[: checker.aligned_token_count()]
            return "".join(text_parts), entries, finish, out_tokens, prompt_lp

        tasks = [asyncio.create_task(drain_choice(i, g)) for i, g in enumerate(gens)]
        try:
            drained = await asyncio.gather(*tasks)
        except DeadlineExceeded as e:
            # One choice expired while queued; the deadline holds for the
            # whole request, so the siblings go too (below) and it is shed.
            obs.on_abort(request_id)
            return _error(str(e), 504, "deadline_expired", code=504)
        finally:
            # A failed or expired choice cancels the rest: cancelling closes
            # a choice's generator, which aborts it in the engine.
            for t in tasks:
                t.cancel()
        obs.record_detokenize(request_id, detok_s[0])
        choices = []
        total_out = 0
        for i, (text, entries, finish, out_tokens, prompt_lp) in enumerate(drained):
            total_out += out_tokens
            if chat:
                message = {"role": "assistant", "content": text}
                if forced_tool is not None and _parses(text):
                    # The OpenAI tool-call shape: the arguments are the
                    # guided JSON verbatim.  A value cut by the budget is
                    # answered as plain content with its finish reason.
                    message = {
                        "role": "assistant",
                        "content": None,
                        "tool_calls": [{
                            "id": f"call_{uuid.uuid4().hex[:20]}",
                            "type": "function",
                            "function": {
                                "name": forced_tool["function"]["name"],
                                "arguments": text,
                            },
                        }],
                    }
                    finish = "tool_calls"
                choice = {"index": i, "message": message, "finish_reason": finish}
                if params.logprobs:
                    choice["logprobs"] = {"content": [logprob_entry(e) for e in entries]}
            else:
                choice = {"index": i, "text": (prompt + text) if params.echo else text,
                          "finish_reason": finish}
                if params.logprobs:
                    toks = [token_text(e.token_id) for e in entries]
                    lps = [e.logprob for e in entries]
                    tops = [
                        {tokenizer.decode([tid]): lp
                         for tid, lp in (e.top_logprobs or [])}
                        for e in entries
                    ]
                    if params.echo and prompt_lp is not None:
                        # The echoed prompt's entries first (the lm-eval
                        # loglikelihood surface); position 0's is null.
                        toks = [tokenizer.decode([tid]) for tid in
                                prompt_token_ids[: len(prompt_lp)]] + toks
                        lps = [lp for lp, _ in prompt_lp] + lps
                        tops = [
                            None if pairs is None else
                            {tokenizer.decode([tid]): lp for tid, lp in pairs}
                            for _, pairs in prompt_lp
                        ] + tops
                    text_offsets, pos = [], 0
                    for t in toks:
                        text_offsets.append(pos)
                        pos += len(t)
                    choice["logprobs"] = {
                        "tokens": toks,
                        "token_logprobs": lps,
                        "top_logprobs": tops,
                        "text_offset": text_offsets,
                    }
            choices.append(choice)
        final_headers = {"X-Request-Id": request_id}
        if disagg_prefix_outcome is not None:
            final_headers["X-Disagg-Prefix"] = disagg_prefix_outcome
        final_body = {
            "id": request_id,
            "object": "chat.completion" if chat else "text_completion",
            "created": created,
            "model": model_name,
            "choices": choices,
            "usage": usage(total_out),
        }
        if obs.compile_tainted(request_id):
            # A compile event fired inside this request's dispatches: its
            # latency is cold start (the marker the streamed path puts in
            # its first chunk).
            final_body["compile"] = True
        return web.json_response(final_body, headers=final_headers)

    async def _serve_prefill_phase(request_id, prompt_token_ids, params,
                                   created, model_name, adapter) -> web.Response:
        """The prefill phase of a disaggregated request: the prompt's
        prefill as a scoring-only generation (``max_tokens=0``), then the
        export flush (off the event loop: the writer must have put the
        chain in the store before the decode side asks), then the handoff
        token."""
        prime_params = dataclasses.replace(
            params, max_tokens=0, logprobs=False, top_logprobs=0, echo=False,
        )
        gen = engine.generate(
            prompt_token_ids=prompt_token_ids, sampling_params=prime_params,
            request_id=request_id, adapter=adapter,
        )
        try:
            async for _event in gen:
                pass
        except DeadlineExceeded as e:
            engine.engine.deadline_expired_admission += 1
            return _error(str(e), 504, "deadline_expired", code=504)
        await asyncio.to_thread(engine.engine.flush_prefix_exports, 10.0)
        handoff = await asyncio.to_thread(
            engine.engine.handoff_token, prompt_token_ids,
            engine.engine.cache_ns_of(adapter),
        )
        engine.engine.disagg_prefill_primes += 1
        return web.json_response(
            {
                "id": request_id,
                "object": "disagg.prefill",
                "created": created,
                "model": model_name,
                "disagg": {"handoff": handoff},
                "usage": {
                    "prompt_tokens": len(prompt_token_ids),
                    "completion_tokens": 0,
                    "total_tokens": len(prompt_token_ids),
                },
            },
            headers={"X-Request-Id": request_id},
        )

    async def _wait_handoff(handoff_hdr: str, prompt_token_ids,
                            deadline: Optional[float], adapter) -> str:
        """The decode phase's bounded wait for the handed-off chain
        ("hit", "partial", "miss" or "disabled"), counted as a hit or a
        miss."""
        try:
            handoff = json.loads(handoff_hdr)
        except json.JSONDecodeError:
            handoff = None
        outcome = "disabled"
        if isinstance(handoff, dict):
            wait_s = engine.engine.config.cache.disagg_handoff_wait_s
            if deadline is not None:
                # Leave headroom for the generation itself.
                wait_s = min(wait_s, max(0.0, deadline - time.time() - 0.05))
            outcome = await asyncio.to_thread(
                engine.engine.wait_handoff_prefix, prompt_token_ids,
                engine.engine.cache_ns_of(adapter), handoff, wait_s,
            )
        if outcome == "hit":
            engine.engine.disagg_handoff_hits += 1
        else:
            engine.engine.disagg_handoff_misses += 1
        return outcome

    # -- the encode surface: embeddings, rerank, score ---------------------

    def _encode_admission(request, body, texts):
        """Overload protection of the encode surface, before any device
        work is queued: the deadline parse (400 on a malformed one),
        bounded admission against the encode queue's caps (429 +
        Retry-After), an already-expired deadline (504).  Returns
        (error response, token lists, deadline); the token lists are reused
        by the embed call, so each text tokenizes once."""
        token_lists = [engine.engine.tokenizer.encode(text) for text in texts]
        now = time.time()
        try:
            deadline = parse_deadline(request.headers, body, now)
        except ValueError as e:
            return _error(str(e)), None, None
        rejection = engine.check_encode_admission(
            len(token_lists), sum(len(ids) for ids in token_lists))
        if rejection is not None:
            engine.engine.admission_rejected += 1
            return web.json_response(
                {"error": {
                    "message": (
                        f"engine overloaded: {rejection.queued_requests} texts "
                        f"({rejection.queued_tokens} prompt tokens) already "
                        "queued on the encode lane; retry after "
                        f"{rejection.retry_after_s}s"
                    ),
                    "type": "overloaded", "code": 429,
                    "detail": dataclasses.asdict(rejection),
                }},
                status=429,
                headers={"Retry-After": str(rejection.retry_after_s)},
            ), None, None
        if deadline is not None and now >= deadline:
            # The event loop's own counter, as for completions.
            engine.engine.deadline_expired_admission += 1
            return _error("request deadline already expired at admission",
                          504, "deadline_expired", code=504), None, None
        return None, token_lists, deadline

    async def _embed_texts(token_lists, deadline):
        """Unit vectors of tokenized texts through the encode lane (or the
        serial path with the lane off or in a multi-process group), and an
        error response: 504 for a text whose deadline passed while it was
        queued, 400 for an over-long input."""
        try:
            return await engine.embed_batch(token_lists, deadline=deadline), None
        except DeadlineExceeded as e:
            return None, _error(str(e), 504, "deadline_expired", code=504)
        except ValueError as e:
            return None, _error(str(e))

    async def _json_body(request):
        try:
            return await request.json(), None
        except json.JSONDecodeError:
            return None, _error("invalid JSON")

    async def embeddings(request: web.Request) -> web.Response:
        """OpenAI /v1/embeddings: the normalized mean-pooled final hidden
        states (``llama.encode_batch``)."""
        body, err = await _json_body(request)
        if err is not None:
            return err
        raw = body.get("input")
        if isinstance(raw, str):
            inputs = [raw]
        elif isinstance(raw, list) and all(isinstance(x, str) for x in raw):
            inputs = raw
        else:
            return _error("'input' must be a string or list of strings")
        if not 1 <= len(inputs) <= 128:
            # Each item is a device forward: an unbounded list would let
            # one request starve completions.
            return _error(f"'input' must contain 1-128 items, got {len(inputs)}")
        err, token_lists, deadline = _encode_admission(request, body, inputs)
        if err is not None:
            return err
        vectors, err = await _embed_texts(token_lists, deadline)
        if err is not None:
            return err
        total = sum(len(ids) for ids in token_lists)
        return web.json_response({
            "object": "list",
            "data": [{"object": "embedding", "index": i,
                      "embedding": [float(x) for x in vector]}
                     for i, vector in enumerate(vectors)],
            "model": body.get("model", served_model),
            "usage": {"prompt_tokens": total, "total_tokens": total},
        })

    async def rerank(request: web.Request) -> web.Response:
        """Jina/Cohere-style rerank (``/v1/rerank`` and ``/rerank``): the
        cosine relevance of each document to the query, sorted
        descending."""
        body, err = await _json_body(request)
        if err is not None:
            return err
        query, documents = body.get("query"), body.get("documents")
        if not isinstance(query, str) or not isinstance(documents, list) or not all(
                isinstance(d, str) for d in documents):
            return _error("'query' must be a string and 'documents' a list of strings")
        if not 1 <= len(documents) <= 128:
            return _error(f"'documents' must contain 1-128 items, got {len(documents)}")
        top_n = body.get("top_n")
        if top_n is not None and (
                not isinstance(top_n, int) or isinstance(top_n, bool) or top_n < 1):
            return _error("'top_n' must be a positive integer")
        err, token_lists, deadline = _encode_admission(request, body, [query] + documents)
        if err is not None:
            return err
        vectors, err = await _embed_texts(token_lists, deadline)
        if err is not None:
            return err
        total = sum(len(ids) for ids in token_lists)
        qvec = vectors[0]
        results = [{"index": i, "document": {"text": documents[i]},
                    "relevance_score": float(np.dot(qvec, dvec))}
                   for i, dvec in enumerate(vectors[1:])]
        results.sort(key=lambda r: r["relevance_score"], reverse=True)
        if top_n is not None:
            results = results[:top_n]
        if not body.get("return_documents", True):
            for r in results:
                r.pop("document")
        return web.json_response({
            "id": f"rerank-{uuid.uuid4().hex[:16]}",
            "model": body.get("model", served_model),
            "usage": {"prompt_tokens": total, "total_tokens": total},
            "results": results,
        })

    async def score(request: web.Request) -> web.Response:
        """vLLM-style ``/v1/score`` and ``/score``: the similarity of
        text_1 x text_2 pairs; a single text_1 broadcasts over the text_2
        list, equal-length lists pair elementwise."""
        body, err = await _json_body(request)
        if err is not None:
            return err

        def as_list(v):
            if isinstance(v, str):
                return [v]
            if isinstance(v, list) and all(isinstance(x, str) for x in v):
                return v
            return None

        t1, t2 = as_list(body.get("text_1")), as_list(body.get("text_2"))
        if not t1 or not t2:
            return _error("'text_1' and 'text_2' must be non-empty strings or "
                          "lists of strings")
        if len(t1) == 1:
            t1 = t1 * len(t2)
        if len(t1) != len(t2):
            return _error(f"'text_1' ({len(t1)}) and 'text_2' ({len(t2)}) must "
                          "broadcast (1-to-N or equal length)")
        if len(t2) > 128:
            return _error(f"at most 128 pairs, got {len(t2)}")
        # Each distinct text is embedded once.
        distinct = list(dict.fromkeys(t1 + t2))
        err, token_lists, deadline = _encode_admission(request, body, distinct)
        if err is not None:
            return err
        vectors, err = await _embed_texts(token_lists, deadline)
        if err is not None:
            return err
        by_text = dict(zip(distinct, vectors))
        n_tokens = {text: len(ids) for text, ids in zip(distinct, token_lists)}
        # Usage counts the logical pairs, though a broadcast text is
        # embedded once.
        total = sum(n_tokens[a] + n_tokens[b] for a, b in zip(t1, t2))
        return web.json_response({
            "id": f"score-{uuid.uuid4().hex[:16]}",
            "object": "list",
            "model": body.get("model", served_model),
            "usage": {"prompt_tokens": total, "total_tokens": total},
            "data": [{"object": "score", "index": i,
                      "score": float(np.dot(by_text[a], by_text[b]))}
                     for i, (a, b) in enumerate(zip(t1, t2))],
        })

    # vLLM's /tokenize and /detokenize: clients budget long-context
    # requests against max_model_len without shipping the tokenizer.
    async def tokenize(request: web.Request) -> web.Response:
        try:
            body = await request.json()
        except json.JSONDecodeError:
            return _error("invalid JSON")
        tokenizer = engine.engine.tokenizer
        prompt = body.get("prompt")
        messages = body.get("messages")
        if isinstance(messages, list):
            try:
                prompt = tokenizer.apply_chat_template(messages)
            except Exception as e:
                return _error(f"chat template failed: {e}")
        if not isinstance(prompt, str):
            return _error("'prompt' (string) or 'messages' (list) is required")
        ids = tokenizer.encode(prompt)
        return web.json_response({
            "tokens": ids,
            "count": len(ids),
            "max_model_len": engine.engine.config.scheduler.max_model_len,
        })

    async def detokenize(request: web.Request) -> web.Response:
        try:
            body = await request.json()
        except json.JSONDecodeError:
            return _error("invalid JSON")
        tokens = body.get("tokens")
        if not isinstance(tokens, list) or not all(isinstance(t, int) for t in tokens):
            return _error("'tokens' must be a list of ids")
        return web.json_response({"prompt": engine.engine.tokenizer.decode(tokens)})

    # On-demand profiling (vLLM's /start_profile and /stop_profile) on
    # torch.profiler: serving goes on while the trace records, so a
    # latency spike can be caught in place.  The Chrome trace lands in
    # trace_dir, viewable in Perfetto.
    profile_state = {"dir": None, "prof": None}

    async def start_profile(request: web.Request) -> web.Response:
        if profile_state["dir"] is not None:
            return web.json_response(
                {"error": {"message": "profiling already running "
                           f"(writing {profile_state['dir']})"}},
                status=409,
            )
        try:
            body = await request.json()
        except Exception:
            body = {}
        trace_dir = body.get("trace_dir") or os.environ.get(
            "PSTPU_PROFILE_DIR", os.path.join(tempfile.gettempdir(), "pstpu_profile")
        )
        try:
            prof = _start_torch_profiler(engine.engine.device)
        except Exception as e:
            return web.json_response(
                {"error": {"message": f"start_trace failed: {e}"}}, status=500
            )
        profile_state.update(dir=trace_dir, prof=prof)
        logger.info("profiling started -> %s", trace_dir)
        return web.json_response({"ok": True, "trace_dir": trace_dir})

    async def stop_profile(_req: web.Request) -> web.Response:
        if profile_state["dir"] is None:
            return web.json_response(
                {"error": {"message": "profiling is not running"}}, status=409
            )
        trace_dir, prof = profile_state["dir"], profile_state["prof"]
        profile_state.update(dir=None, prof=None)
        try:
            # Stopped on the thread that started it; the export, which
            # can take seconds, off the event loop.
            prof.stop()
            await asyncio.to_thread(_export_trace, prof, trace_dir)
        except Exception as e:
            return web.json_response(
                {"error": {"message": f"stop_trace failed: {e}"}}, status=500
            )
        logger.info("profiling stopped; trace in %s", trace_dir)
        return web.json_response({"ok": True, "trace_dir": trace_dir})

    # -- multi-LoRA admin -------------------------------------------------

    async def lora_list(_req: web.Request) -> web.Response:
        return web.json_response({"adapters": engine.engine.loaded_adapters()})

    async def lora_load(request: web.Request) -> web.Response:
        try:
            body = await request.json()
            name = body["name"]
            path = body["path"]
        except (json.JSONDecodeError, KeyError):
            return web.json_response(
                {"error": {"message": "need JSON body with 'name' and 'path'"}},
                status=400,
            )
        try:
            # Off the loop: the file read and the upload, then the wait for
            # the step thread's commit, would stall every in-flight stream.
            # Broad catch: a corrupt file raises safetensors' own error.
            slot = await asyncio.to_thread(
                engine.engine.load_lora_from_path,
                name, path, float(body.get("alpha", 16.0)),
            )
        except Exception as e:
            return web.json_response(
                {"error": {"message": f"{type(e).__name__}: {e}"}}, status=400
            )
        return web.json_response({"name": name, "slot": slot})

    async def lora_unload(request: web.Request) -> web.Response:
        try:
            # Off the loop: the step thread commits the write.
            await asyncio.to_thread(
                engine.engine.unload_lora, request.match_info["name"])
        except ValueError as e:
            return web.json_response({"error": {"message": str(e)}}, status=400)
        return web.json_response({"ok": True})

    app.router.add_get("/v1/models", models)
    app.router.add_get("/health", health)
    app.router.add_get("/ready", ready)
    app.router.add_post("/drain", drain_endpoint)
    app.router.add_get("/metrics", metrics)
    app.router.add_get("/debug/requests", debug_requests)
    app.router.add_get("/debug/requests/{request_id}", debug_request)
    app.router.add_get("/debug/windows", debug_windows)
    app.router.add_get("/debug/compiles", debug_compiles)
    app.router.add_post("/v1/chat/completions", chat_completions)
    app.router.add_post("/v1/completions", completions)
    app.router.add_post("/v1/embeddings", embeddings)
    app.router.add_post("/v1/rerank", rerank)
    app.router.add_post("/rerank", rerank)
    app.router.add_post("/v1/score", score)
    app.router.add_post("/score", score)
    app.router.add_post("/tokenize", tokenize)
    app.router.add_post("/detokenize", detokenize)
    app.router.add_post("/start_profile", start_profile)
    app.router.add_post("/stop_profile", stop_profile)
    app.router.add_get("/admin/lora", lora_list)
    app.router.add_post("/admin/lora", lora_load)
    app.router.add_delete("/admin/lora/{name}", lora_unload)

    async def lifecycle(_app):
        await engine.start()
        # Follower -> leader drain relay: a follower's SIGTERM or /drain
        # never leaves the collectives; it relays to the leader, which
        # runs the one drain the whole group follows (streams finish,
        # then the step loop's shutdown publish releases every member to
        # exit 0).  The relay fires on the monitor thread; begin() needs
        # the loop.
        if engine.slice_monitor is not None:
            loop = asyncio.get_running_loop()
            engine.slice_monitor.on_drain_relay = (
                lambda: loop.call_soon_threadsafe(drain.begin)
            )
        yield
        await engine.close()

    app.cleanup_ctx.append(lifecycle)
    return app


def _parse_buckets(args):
    """--prefill-buckets, checked as the parser reads it: each bucket a
    positive multiple of --block-size (a prefill plan has bucket //
    block_size new blocks), returned ascending (the scheduler chunks long
    prompts at the largest)."""
    try:
        buckets = sorted(int(b) for b in args.prefill_buckets.split(","))
    except ValueError:
        raise SystemExit(f"--prefill-buckets must be integers: {args.prefill_buckets!r}")
    for b in buckets:
        if b <= 0 or b % args.block_size:
            raise SystemExit(
                f"--prefill-buckets entries must be positive multiples of "
                f"--block-size={args.block_size}; got {b}"
            )
    return tuple(buckets)


def build_parser() -> argparse.ArgumentParser:
    """The flags of what this engine serves, with the JAX server's names,
    defaults and meanings (plus ``--device``).  Flags of features not
    ported yet come with their features."""
    parser = argparse.ArgumentParser(
        description="PyTorch/CUDA serving engine (OpenAI API)"
    )
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--model", default="tiny-llama", help="model preset name")
    parser.add_argument("--served-model-name", default=None)
    parser.add_argument("--weights-path", default=None)
    parser.add_argument("--tokenizer", default=None)
    parser.add_argument(
        "--chat-template",
        default=None,
        help="path to a Jinja chat-template file overriding the "
        "tokenizer's (the chart mounts modelSpec.chatTemplate here)",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="torch device the engine runs on (default cuda; cpu on purpose "
        "only); it holds every position of the mesh",
    )
    parser.add_argument("--max-num-seqs", type=int, default=8)
    parser.add_argument("--max-model-len", type=int, default=2048)
    parser.add_argument("--block-size", type=int, default=16)
    parser.add_argument("--num-blocks", type=int, default=None)
    parser.add_argument(
        "--prefill-buckets",
        default=None,
        help="comma-separated prefill bucket lengths (prompts beyond the "
        "largest bucket run as chunked prefill)",
    )
    parser.add_argument(
        "--max-num-batched-tokens",
        type=int,
        default=None,
        help="token budget per fused mixed step (decode tokens count "
        "first, the prefill chunk gets the remainder; a mixed K-step "
        "window applies it per iteration); default admits the largest "
        "chunk bucket beside a full decode batch",
    )
    parser.add_argument(
        "--host-offload-gb", type=float, default=0.0,
        help="host-DRAM tier for offload preemption (pinned memory): a "
        "preempted sequence's KV blocks are staged here and restored "
        "instead of recomputed; 0 disables",
    )
    parser.add_argument(
        "--remote-kv-url", default=None,
        help="shared KV store (kv://host:port) behind the host tier: "
        "offloaded snapshots are put there, and the disagg roles export "
        "and import prompt blocks through it",
    )
    parser.add_argument(
        "--disagg-role",
        default=None,
        choices=["prefill", "decode", "both", "encode"],
        help="cross-engine prefix sharing through the remote KV store: "
        "'prefill' exports prompt KV blocks after prefill, 'decode' "
        "imports matching blocks instead of recomputing, 'both' shares "
        "symmetrically (requires --remote-kv-url); 'encode' marks a "
        "dedicated embed/rerank/score pool member (no KV handoff, no "
        "--remote-kv-url needed) — the router's encode lane prefers it",
    )
    parser.add_argument(
        "--no-remote-prefetch",
        action="store_true",
        help="disable the asynchronous batched KV transfer plane "
        "(admission-time remote-prefix prefetch, off-step offload "
        "staging, async restore page-in) and restore the legacy "
        "synchronous in-schedule transfers — A/B baseline / debugging",
    )
    parser.add_argument(
        "--prefetch-threads", type=int, default=2,
        help="background fetcher threads for the KV prefetch plane",
    )
    parser.add_argument(
        "--disagg-handoff-wait-s", type=float, default=2.0,
        help="decode-phase handoff: bounded wait for the prefetched "
        "prefix chain to land in the cache before admitting anyway "
        "(caps the TTFT tax of a slow store; a store miss exits early; "
        "0 disables the wait)",
    )
    parser.add_argument("--no-prefix-caching", action="store_true")
    # Multi-LoRA slots (engine/lora.py); adapters load via POST /admin/lora.
    parser.add_argument("--max-loras", type=int, default=0)
    parser.add_argument("--max-lora-rank", type=int, default=16)
    parser.add_argument("--dtype", default=None, help="override preset dtype")
    parser.add_argument(
        "--quantization",
        default=None,
        choices=["int8"],
        help="weight-only quantization of the projection matmuls "
        "(halves decode's HBM weight traffic)",
    )
    # Mesh axes (config.ParallelConfig): every position of a single
    # process's mesh on the engine's device; in a group tp and sp span the
    # ranks and dp above 1 exits (_join_group).
    parser.add_argument("--data-parallel", type=int, default=1)
    parser.add_argument("--tensor-parallel", type=int, default=1)
    parser.add_argument("--sequence-parallel", type=int, default=1)
    parser.add_argument(
        "--sequence-parallel-mode", choices=["ring", "ulysses"], default="ring"
    )
    parser.add_argument(
        "--kv-cache-dtype",
        default=None,
        choices=["auto", "int8"],
        help="KV cache precision (vLLM --kv-cache-dtype analogue): int8 "
        "stores cached K/V as int8 with per-(token, head) scales — KV "
        "bytes roughly halve, so the pool holds ~2x the tokens",
    )
    parser.add_argument(
        "--kv-wire-format",
        default=None,
        choices=["auto", "fp32", "int8"],
        help="offload/remote wire representation for int8 KV caches: "
        "auto (default) sends the cache's native (data, scale) tuples "
        "(kvserver serde v2, with a probe-once dense-v1 fallback against "
        "legacy stores); fp32 pins the dense wire; int8 is auto plus "
        "strictness (requires --kv-cache-dtype int8, warns when the store "
        "downgrades)",
    )
    parser.add_argument(
        "--no-mixed-batch",
        action="store_true",
        help="disable fused mixed prefill+decode steps (arriving prompts "
        "then stall all decoders for a full prefill bucket per step — "
        "the pre-mixed alternating scheduler)",
    )
    parser.add_argument(
        "--no-mixed-window",
        action="store_true",
        help="disable mixed K-step windows (a waiting prompt's prefill "
        "chunks riding the decode window, each iteration one CUDA-graph "
        "replay on the card) and restore the K=1 mixed scheduling "
        "exactly: a waiting head forces single-token steps, counted as "
        'multistep_fallback["waiting_head"]',
    )
    parser.add_argument(
        "--no-multi-prompt-window",
        action="store_true",
        help="disable multi-prompt packing inside mixed K-step windows "
        "and restore the single-head window planner exactly (one "
        "waiting prompt's chunks per window, adaptive K-halving clamp "
        "under deep queues)",
    )
    parser.add_argument(
        "--num-scheduler-steps",
        type=int,
        default=1,
        help="legacy spelling of the K-step decode window (vLLM "
        "--num-scheduler-steps): a value > 1 forces window size K "
        "through the same device-resident machinery --decode-window "
        "sizes; 1 defers to --decode-window",
    )
    parser.add_argument(
        "--no-multi-step-window",
        action="store_true",
        help="disable K-step device-resident decode windows (the default "
        "decode fast path: K decode+sample iterations per dispatch, one "
        "CUDA-graph replay on the card, with on-device penalties, the "
        "min_tokens floor and per-row stop masking) and restore "
        "single-token stepping exactly",
    )
    parser.add_argument(
        "--decode-window",
        type=int,
        default=8,
        help="window size K for the K-step decode fast path (iterations "
        "fused per pure-decode dispatch; the per-token host round-trip "
        "is amortized K-fold)",
    )
    parser.add_argument(
        "--no-pipeline-decode",
        action="store_true",
        help="disable the lookahead decode pipeline (dispatch decode step "
        "or K-step window N+1 while N's tokens are in flight; greedy "
        "streams are identical)",
    )
    parser.add_argument(
        "--speculative-ngram",
        type=int,
        default=0,
        help="n-gram (prompt-lookup) speculative decoding: draft K tokens "
        "from the sequence's own history and verify them alongside the "
        "committed token in one forward.  With the K-step decode window "
        "active (the default) the drafter runs INSIDE the window (one "
        "CUDA-graph replay on the card): drafts proposed on the device, "
        "acceptance folded into the carried state, a rejected draft costs "
        "a window iteration, never a host round-trip.  Greedy-only; with "
        "--no-multi-step-window the legacy host-side speculative path "
        "runs instead",
    )
    parser.add_argument(
        "--speculative-model",
        default=None,
        help="draft-MODEL speculative decoding: a model preset name "
        "sharing the target's tokenizer/vocab (a vocab mismatch refuses "
        "to boot; e.g. llama-3.2-1b for llama-3.1-8b), loaded as a second "
        "model on the same card.  It proposes --speculative-draft-len "
        "tokens per window iteration, autoregressively from its own "
        "device-resident KV cache (dedicated draft pool; target KV "
        "capacity untouched), and the target verifies draft+1 rows in "
        "the same wide forward the n-gram drafter uses.  Mutually "
        "exclusive with --speculative-ngram; requires the window "
        "machinery (no legacy host path)",
    )
    parser.add_argument(
        "--speculative-draft-len",
        type=int,
        default=4,
        help="draft tokens the model drafter proposes per window "
        "iteration (the D in the W = D+1 verify-row fan-out; only "
        "meaningful with --speculative-model)",
    )
    parser.add_argument(
        "--speculative-draft-pool-blocks",
        type=int,
        default=None,
        help="device blocks reserved for the draft model's dedicated KV "
        "pool (default: auto-sized for max_num_seqs rows).  Exhaustion "
        "never stalls: a window that cannot allocate draft blocks "
        "declines to a plain window, counted under "
        "tpu:multistep_fallback_total{reason=draft_pool}",
    )
    parser.add_argument(
        "--no-speculative-model",
        action="store_true",
        help="force the model drafter OFF even if --speculative-model "
        "is set (deploy-template escape hatch; restores ngram-only / "
        "non-speculative behavior exactly)",
    )
    parser.add_argument(
        "--no-admission-control",
        action="store_true",
        help="disable bounded admission (the waiting queue then grows "
        "without bound; overload times out in the middle instead of being "
        "shed with a 429 at the edge)",
    )
    parser.add_argument(
        "--max-queued-requests", type=int, default=None,
        help="waiting-queue request bound for bounded admission "
        "(default: 4 x --max-num-seqs)",
    )
    parser.add_argument(
        "--max-queued-tokens", type=int, default=None,
        help="waiting-queue prompt-token bound for bounded admission "
        "(default: 2 x --max-num-seqs x --max-model-len)",
    )
    parser.add_argument(
        "--no-encode-lane",
        action="store_true",
        help="disable the batched encode lane (embed/rerank/score then "
        "run the legacy serial per-text encode off the step thread, and "
        "encode admission falls back to the generation caps) — A/B "
        "baseline / debugging",
    )
    parser.add_argument(
        "--encode-batch-buckets", default=None,
        help="comma-separated B-axis bucket grid for encode batches "
        "(default 1,2,4,8); the T axis pads to the prefill buckets",
    )
    parser.add_argument(
        "--max-queued-encode-texts", type=int, default=None,
        help="encode-queue text bound for bounded admission "
        "(default: 32 x the largest encode batch bucket)",
    )
    parser.add_argument(
        "--step-watchdog-s", type=float, default=300.0,
        help="fail /health liveness when the engine step loop has not "
        "iterated in this many seconds (hung device dispatch); 0 disables",
    )
    parser.add_argument(
        "--slice-member-timeout-s", type=float, default=10.0,
        help="multi-host slice groups: fail the leader's /health (and "
        "fatal-exit the whole group into a parallel restart) when a "
        "member's lockstep acks stop advancing for this long — well "
        "under --step-watchdog-s, so a dead follower fails the slice in "
        "seconds instead of wedging collectives until the watchdog; "
        "0 disables group liveness (staleness-window behavior only)",
    )
    parser.add_argument(
        "--drain-grace-s", type=float, default=30.0,
        help="on SIGTERM or POST /drain: stop admitting (503 + "
        "Connection: close), flip /ready to 503, let in-flight streams "
        "finish up to this many seconds, then exit 0",
    )
    parser.add_argument(
        "--no-tracing",
        action="store_true",
        help="disable request tracing + step-phase histograms "
        "(obs.tracing=off: restores the untraced hot path; /debug/requests "
        "returns an empty ring and /metrics drops the histogram families' "
        "samples growth)",
    )
    parser.add_argument(
        "--trace-ring-size", type=int, default=256,
        help="completed request timelines kept for GET /debug/requests",
    )
    parser.add_argument(
        "--trace-ring-bytes", type=int, default=8 * 1024 * 1024,
        help="byte bound on the completed-trace ring (JSON-encoded size; "
        "evictions past it count in tpu:obs_trace_dropped_total; 0 = "
        "count bound only)",
    )
    parser.add_argument(
        "--window-ring-size", type=int, default=1024,
        help="window flight records kept for GET /debug/windows",
    )
    parser.add_argument("--log-level", default="info")
    return parser


def config_from_args(args):
    """The engine config for parsed flags: the preset, the served slice
    (``SLICE_OVERRIDES``), then the flags, mapped as the JAX server maps
    them."""
    return config_from_preset(args.model, **{
        **SLICE_OVERRIDES,
        "weights_path": args.weights_path,
        "tokenizer": args.tokenizer,
        "scheduler.max_num_seqs": args.max_num_seqs,
        "scheduler.max_model_len": args.max_model_len,
        **({"scheduler.prefill_buckets": _parse_buckets(args)}
           if args.prefill_buckets else {}),
        "scheduler.num_scheduler_steps": args.num_scheduler_steps,
        "scheduler.speculative_ngram": args.speculative_ngram,
        **({
            "scheduler.speculative_model": args.speculative_model,
            "scheduler.speculative_draft_len": args.speculative_draft_len,
            **({"scheduler.speculative_draft_pool_blocks":
                args.speculative_draft_pool_blocks}
               if args.speculative_draft_pool_blocks is not None else {}),
        } if args.speculative_model is not None
            and not args.no_speculative_model else {}),
        **({"scheduler.multi_step_window": False}
           if args.no_multi_step_window else {}),
        "scheduler.decode_window": args.decode_window,
        **({"scheduler.pipeline_decode": False}
           if args.no_pipeline_decode else {}),
        **({"scheduler.mixed_batch": False} if args.no_mixed_batch else {}),
        **({"scheduler.mixed_window": False} if args.no_mixed_window else {}),
        **({"scheduler.multi_prompt_window": False}
           if args.no_multi_prompt_window else {}),
        **({"scheduler.max_num_batched_tokens": args.max_num_batched_tokens}
           if args.max_num_batched_tokens is not None else {}),
        "cache.block_size": args.block_size,
        "cache.num_blocks": args.num_blocks,
        "cache.host_offload_gb": args.host_offload_gb,
        "cache.remote_kv_url": args.remote_kv_url,
        "cache.disagg_role": args.disagg_role,
        **({"cache.remote_prefetch": False} if args.no_remote_prefetch else {}),
        "cache.prefetch_threads": args.prefetch_threads,
        "cache.disagg_handoff_wait_s": args.disagg_handoff_wait_s,
        "cache.enable_prefix_caching": not args.no_prefix_caching,
        "lora.max_loras": args.max_loras,
        "lora.max_rank": args.max_lora_rank,
        **({"cache.kv_cache_dtype": args.kv_cache_dtype}
           if args.kv_cache_dtype else {}),
        **({"cache.kv_wire_format": args.kv_wire_format}
           if args.kv_wire_format else {}),
        **({"model.dtype": args.dtype} if args.dtype else {}),
        **({"model.quantization": args.quantization} if args.quantization else {}),
        "parallel.data_parallel": args.data_parallel,
        "parallel.tensor_parallel": args.tensor_parallel,
        "parallel.sequence_parallel": args.sequence_parallel,
        "parallel.sequence_parallel_mode": args.sequence_parallel_mode,
        **({"scheduler.admission_control": False}
           if args.no_admission_control else {}),
        **({"scheduler.max_queued_requests": args.max_queued_requests}
           if args.max_queued_requests is not None else {}),
        **({"scheduler.max_queued_tokens": args.max_queued_tokens}
           if args.max_queued_tokens is not None else {}),
        **({"scheduler.encode_lane": False} if args.no_encode_lane else {}),
        **({"scheduler.encode_batch_buckets": tuple(
            int(b) for b in args.encode_batch_buckets.split(","))}
           if args.encode_batch_buckets else {}),
        **({"scheduler.max_queued_encode_texts": args.max_queued_encode_texts}
           if args.max_queued_encode_texts is not None else {}),
        "scheduler.step_watchdog_s": args.step_watchdog_s,
        "obs.tracing": not args.no_tracing,
        "obs.trace_ring_size": args.trace_ring_size,
        "obs.trace_ring_bytes": args.trace_ring_bytes,
        "obs.window_ring_size": args.window_ring_size,
    })


def on_sigterm(drain: DrainController) -> None:
    """What SIGTERM does to a serving engine: begin the graceful drain."""
    logger.info("SIGTERM: beginning graceful drain")
    drain.begin()


def install_sigterm_drain(app: web.Application) -> None:
    """Graceful SIGTERM (pod termination): a drain instead of aiohttp's
    immediate exit.  At startup the drain's exit_cb becomes a SIGINT to
    this process, which takes aiohttp's graceful exit through cleanup_ctx
    (engine.close), so the process exits 0 once the streams finish.
    on_startup runs after the runner registered aiohttp's own handlers,
    so this one wins."""

    async def install(app_: web.Application) -> None:
        drain = app_["drain"]
        drain.exit_cb = lambda: os.kill(os.getpid(), signal.SIGINT)
        loop = asyncio.get_running_loop()
        try:
            loop.add_signal_handler(signal.SIGTERM, on_sigterm, drain)
        except (NotImplementedError, RuntimeError):  # not the main thread
            pass

    app.on_startup.append(install)


def _serve_health(health_loop, health_app, host: str, port: int) -> None:
    """The follower's probe server on its own event loop and thread, torn
    down through ``AppRunner.cleanup`` so the listening socket is released
    on the way out."""
    asyncio.set_event_loop(health_loop)
    runner = web.AppRunner(health_app, handle_signals=False, access_log=None)
    try:
        # The drain path's stop() can land while startup is still inside
        # run_until_complete (follower_loop failing fast): that raises
        # "Event loop stopped before Future completed"; fall through to
        # the cleanup so the socket is always released.
        health_loop.run_until_complete(runner.setup())
        site = web.TCPSite(runner, host, port)
        health_loop.run_until_complete(site.start())
        health_loop.run_forever()
    except RuntimeError:
        pass
    finally:
        try:
            if not health_loop.is_closed():
                health_loop.run_until_complete(runner.cleanup())
        except RuntimeError:
            pass
        finally:
            if not health_loop.is_closed():
                health_loop.close()


def _slice_guard(channel, stop_event) -> None:
    """Follower-side group-fail watcher: the leader's monitor writes a
    group-fail marker on the control-plane side channel when a member
    dies, and this thread is how a live follower sees it (the main thread
    is blocked inside a collective the dead member will never join, so
    only an off-collective poll can release it).  ``fatal_exit``, never
    ``sys.exit``: the wedged collective would hang the exit."""
    from production_stack_tpu_torch.engine.parallel import distributed

    while not stop_event.wait(0.5):
        reason = channel.group_failed()
        if reason is not None:
            logger.error("slice group marked failed (%s); exiting for a "
                         "parallel group restart", reason)
            distributed.fatal_exit(1)
            return  # unreachable except under a patched exit


def _run_follower(config, denv, args) -> None:
    """A follower process of a multi-process group: a small probe app
    (every ordinal answers probes and the preStop ``/drain``) and the
    lockstep step loop, as the JAX server's follower.

    SIGTERM or ``POST /drain`` on a follower relays the drain intent to
    the leader through the control-plane side channel: the follower keeps
    stepping (leaving the collectives would kill every stream of the
    group) until the leader finishes the in-flight streams and announces
    shutdown, releasing the whole group to exit 0 in order."""
    import threading

    from production_stack_tpu_torch.engine.core.engine import LLMEngine
    from production_stack_tpu_torch.engine.parallel import distributed

    health_app = web.Application()
    engine = LLMEngine(config, device=args.device)
    channel = distributed.LockstepChannel(
        denv, member_timeout_s=args.slice_member_timeout_s
    )

    async def health(_req: web.Request) -> web.Response:
        if channel.stale():
            # The leader heartbeats while idle; prolonged silence means it
            # is gone, and a group cannot heal a lost member in place.
            return web.json_response(
                {"status": "unhealthy", "role": "follower",
                 "problem": "no leader event within the staleness window"},
                status=503,
            )
        return web.json_response(
            {"status": "ok", "role": "follower", "process_id": denv.process_id}
        )

    async def ready(_req: web.Request) -> web.Response:
        """503 once a drain was relayed (on its way out) or when the
        leader went stale."""
        if channel.drain_relayed:
            return web.json_response(
                {"status": "draining", "role": "follower"}, status=503
            )
        if channel.stale():
            return web.json_response(
                {"status": "unhealthy", "role": "follower"}, status=503
            )
        return web.json_response({"status": "ready", "role": "follower"})

    def _relay_drain(source: str) -> bool:
        relayed = channel.relay_drain()
        if relayed:
            logger.info("follower %d: %s -> drain relayed to the leader; "
                        "stepping until the group shutdown", denv.process_id, source)
        else:
            logger.warning("follower %d: %s but no control-plane side "
                           "channel; relying on the leader's own drain",
                           denv.process_id, source)
        return relayed

    async def drain_endpoint(_req: web.Request) -> web.Response:
        """POST /drain (the preStop hook reaches every ordinal): relay to
        the leader, never exit alone."""
        relayed = _relay_drain("POST /drain")
        return web.json_response(
            {"draining": True, "role": "follower", "relayed": relayed}
        )

    health_app.router.add_get("/health", health)
    health_app.router.add_get("/ready", ready)
    health_app.router.add_post("/drain", drain_endpoint)

    # SIGTERM converges on the same relay (this runs on the main thread).
    try:
        signal.signal(signal.SIGTERM, lambda _sig, _frm: _relay_drain("SIGTERM"))
    except (ValueError, OSError):  # not the main thread
        pass

    health_loop = asyncio.new_event_loop()
    health_thread = threading.Thread(
        target=_serve_health, args=(health_loop, health_app, args.host, args.port),
        name="health-serve", daemon=True,
    )
    health_thread.start()
    guard_stop = threading.Event()
    guard_thread = threading.Thread(
        target=_slice_guard, args=(channel, guard_stop),
        name="slice-guard", daemon=True,
    )
    guard_thread.start()
    logger.info("engine follower %d/%d ready (the leader owns the HTTP surface)",
                denv.process_id, denv.num_processes)
    try:
        distributed.follower_loop(engine, channel)
    finally:
        # Stop the probe server and join it, then release the engine's
        # workers; the loop may already be closed (a bind error), and
        # engine.close() runs regardless.
        guard_stop.set()
        guard_thread.join(5)
        try:
            health_loop.call_soon_threadsafe(health_loop.stop)
        except RuntimeError:
            pass
        health_thread.join(10)
        engine.close()
        engine.graphs.release()  # before the group's teardown


def _join_group(args, config):
    """The multi-process bootstrap of the JAX server: when the
    environment declares a group, its rules first (``--data-parallel`` > 1
    exits; the async KV transfer plane and the encode lane, left on auto,
    go off: both are thread-timing or leader-only work that would desync
    the ranks), then the group formed on ``--device`` with its subgroups
    for ``--sequence-parallel`` (one sp position a process: the world must
    divide by it, and tp over the processes of a position, which the
    engine's mesh checks by name).  Returns the topology, or None for a
    single process."""
    from production_stack_tpu_torch.engine.parallel import distributed

    denv = distributed.detect_env()
    if denv is None:
        return None
    if args.data_parallel > 1:
        # dp shards the decode batch; across processes the leader could
        # not read the other ranks' rows.  Replica-level dp belongs to the
        # chart (more groups); within a group use tp.
        raise SystemExit(
            "--data-parallel > 1 is not supported inside a multi-host "
            "slice group; scale replicas with the chart's replicaCount "
            "and use --tensor-parallel/--sequence-parallel across hosts"
        )
    if config.cache.remote_prefetch is None:
        logger.info("multi-process group: disabling the async KV transfer "
                    "plane (cache.remote_prefetch auto -> False)")
        config.cache.remote_prefetch = False
    if config.scheduler.encode_lane is None:
        logger.info("multi-process group: disabling the batched encode lane "
                    "(scheduler.encode_lane auto -> False)")
        config.scheduler.encode_lane = False
    distributed.maybe_initialize(device=args.device,
                                 sequence_parallel=args.sequence_parallel)
    return denv


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=args.log_level.upper(),
        format="[%(asctime)s] %(levelname)s %(name)s: %(message)s",
    )
    config = config_from_args(args)
    from production_stack_tpu_torch.engine.parallel import distributed

    denv = _join_group(args, config)
    try:
        if denv is not None and not denv.is_leader:
            _run_follower(config, denv, args)
            return
        _serve(args, config, denv)
    finally:
        distributed.shutdown()


def _serve(args, config, denv) -> None:
    """The serving process: the leader of a group, or the only process."""
    from production_stack_tpu_torch.engine.parallel import distributed

    lockstep = (
        distributed.LockstepChannel(denv, member_timeout_s=args.slice_member_timeout_s)
        if denv is not None else None
    )
    engine = AsyncEngine(config, device=args.device, lockstep=lockstep)
    if args.chat_template:
        with open(args.chat_template, "r", encoding="utf-8") as f:
            engine.engine.tokenizer.chat_template = f.read()
        try:
            # Fail at boot, not per request: render a probe conversation.
            engine.engine.tokenizer.apply_chat_template(
                [{"role": "system", "content": "probe"},
                 {"role": "user", "content": "probe"}]
            )
        except Exception as e:
            raise SystemExit(
                f"--chat-template {args.chat_template} failed to render: "
                f"{type(e).__name__}: {e}"
            )
    served = args.served_model_name or args.model
    app = build_engine_app(engine, served, drain_grace_s=args.drain_grace_s)
    install_sigterm_drain(app)
    logger.info("Starting engine (%s) on %s:%d", served, args.host, args.port)
    web.run_app(app, host=args.host, port=args.port, access_log=None)
    if denv is not None:
        distributed.log_transfers(engine.engine, "process 0")
    engine.engine.graphs.release()  # before the group's teardown


if __name__ == "__main__":
    main()
