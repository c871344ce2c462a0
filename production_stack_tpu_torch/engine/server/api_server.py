"""OpenAI-compatible API server for the PyTorch engine.

Counterpart of ``production_stack_tpu/engine/server/api_server.py`` for the
main serving path: ``/v1/completions`` and ``/v1/chat/completions`` (SSE
streaming and non-streaming, one choice per request), ``/v1/models`` and
``/health``, over :class:`AsyncEngine`.  It reuses nothing of the JAX
module (which forces the JAX platform and starts ``jax.distributed``).

    python -m production_stack_tpu_torch.engine.server.api_server \
        --model llama-3.1-8b --port 9200 [--device cuda]

Not ported yet: ``n > 1``, tool calls, guided decoding (response_format),
prompt logprobs, deadlines and drain, /metrics, embeddings / rerank /
score, LoRA admin, tokenize / detokenize, profiling.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import time
import uuid
from typing import Optional

from aiohttp import web

from production_stack_tpu_torch.engine.config import config_from_preset
from production_stack_tpu_torch.engine.core.engine import SLICE_OVERRIDES
from production_stack_tpu_torch.engine.core.sequence import (
    FinishReason,
    SamplingParams,
)
from production_stack_tpu_torch.engine.server.async_engine import AsyncEngine

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
    rf = body.get("response_format")
    rf_type = rf.get("type") if isinstance(rf, dict) else rf
    if rf_type not in (None, "text"):
        raise ValueError(
            f"response_format {rf_type!r}: guided decoding is not ported "
            "to this engine yet (supported: text)"
        )
    raw_max = body.get("max_tokens")
    if raw_max is None:
        raw_max = body.get("max_completion_tokens")
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
    echo = bool(body.get("echo")) and not chat
    if echo and want_logprobs:
        raise ValueError("'echo' with 'logprobs' (prompt logprobs) is not ported yet")
    return SamplingParams(
        max_tokens=max_tokens,
        temperature=float(body.get("temperature") or 0.0),
        top_p=float(body.get("top_p") or 1.0),
        top_k=int(body.get("top_k") or 0),
        min_p=min_p,
        stop=stop,
        stop_token_ids=stop_token_ids,
        logit_bias=logit_bias,
        echo=echo,
        ignore_eos=bool(body.get("ignore_eos", False)),
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


def _finish_reason(event, stopped: bool) -> str:
    if stopped or event.finish_reason == FinishReason.STOP:
        return "stop"
    return "length"


def build_engine_app(engine: AsyncEngine, served_model: str) -> web.Application:
    app = web.Application()

    async def models(_req: web.Request) -> web.Response:
        return web.json_response({"object": "list", "data": [{
            "id": served_model,
            "object": "model",
            "created": int(time.time()),
            "owned_by": "production-stack-tpu",
        }]})

    async def health(_req: web.Request) -> web.Response:
        """Liveness: fails when the step thread died or stalled past
        scheduler.step_watchdog_s."""
        problem = None
        if not engine.step_thread_healthy:
            problem = "engine step thread died"
        wd = engine.engine.config.scheduler.step_watchdog_s
        age = engine.last_step_age_s
        if problem is None and wd and age > wd:
            problem = f"step loop stalled: last iteration started {age:.1f}s ago"
        if problem is not None:
            return web.json_response(
                {"status": "unhealthy", "problem": problem,
                 "last_step_age_s": age}, status=503,
            )
        return web.json_response({"status": "ok", "last_step_age_s": age})

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
        if chat and body.get("tools"):
            return _error("'tools' (tool calls) are not ported to this engine yet")
        if body.get("n", 1) not in (None, 1):
            return _error("n > 1 is not ported to this engine yet")
        if chat:
            prompt = tokenizer.apply_chat_template(list(body.get("messages") or []))
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
        request_id = (
            request.headers.get("x-request-id") or f"cmpl-{uuid.uuid4().hex[:16]}"
        )
        created = int(time.time())
        model_name = body.get("model", served_model)
        object_name = "chat.completion.chunk" if chat else "text_completion"
        prompt_token_ids = tokenizer.encode(prompt)
        max_len = engine.engine.config.scheduler.max_model_len
        if len(prompt_token_ids) >= max_len:
            return _error(
                f"This model's maximum context length is {max_len} tokens, "
                f"but the prompt is {len(prompt_token_ids)} tokens long",
                code="context_length_exceeded",
            )
        rejection = engine.check_admission(1, len(prompt_token_ids))
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

        gen = engine.generate(
            prompt_token_ids=prompt_token_ids, sampling_params=params,
            request_id=request_id,
        )
        checker = StopChecker(tokenizer, params.stop)

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

        offset = [0]  # running text_offset for completions logprobs

        def chunk_payload(delta_text: str, finish_reason, first: bool, event=None):
            if chat:
                delta = {"role": "assistant"} if first else {}
                if delta_text:
                    delta["content"] = delta_text
                choice = {"index": 0, "delta": delta, "finish_reason": finish_reason}
                if params.logprobs and event is not None:
                    choice["logprobs"] = {"content": [logprob_entry(event)]}
            else:
                choice = {"index": 0, "text": delta_text,
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
                        "text_offset": [offset[0]],
                    }
                    offset[0] += len(tok)
            return {"id": request_id, "object": object_name, "created": created,
                    "model": model_name, "choices": [choice]}

        if stream:
            response = web.StreamResponse(headers={
                "Content-Type": "text/event-stream",
                "Cache-Control": "no-cache",
                "X-Request-Id": request_id,
            })
            await response.prepare(request)
            first = True
            out_tokens = 0
            try:
                async for event in gen:
                    delta, stopped = checker.push(event.token_id)
                    if event.finished and not stopped:
                        delta += checker.flush()
                    if delta or first or params.logprobs:
                        payload = chunk_payload(
                            delta, None, first,
                            event=None if stopped or event.token_id < 0 else event,
                        )
                        await response.write(f"data: {json.dumps(payload)}\n\n".encode())
                        first = False
                    if stopped or event.finished:
                        out_tokens = event.num_output_tokens
                        final = chunk_payload("", _finish_reason(event, stopped), first)
                        await response.write(f"data: {json.dumps(final)}\n\n".encode())
                        break
                if include_usage:
                    usage = {
                        "id": request_id, "object": object_name,
                        "created": created, "model": model_name, "choices": [],
                        "usage": {
                            "prompt_tokens": len(prompt_token_ids),
                            "completion_tokens": out_tokens,
                            "total_tokens": len(prompt_token_ids) + out_tokens,
                        },
                    }
                    await response.write(f"data: {json.dumps(usage)}\n\n".encode())
                await response.write(b"data: [DONE]\n\n")
                await response.write_eof()
            except ConnectionResetError:
                pass
            finally:
                await gen.aclose()  # aborts in-engine if it did not finish
            return response

        text_parts, entries = [], []
        finish, out_tokens = "length", 0
        try:
            async for event in gen:
                delta, stopped = checker.push(event.token_id)
                text_parts.append(delta)
                if params.logprobs and event.token_id >= 0 and not stopped:
                    entries.append(event)
                if stopped or event.finished:
                    if not stopped:
                        text_parts.append(checker.flush())
                    finish = _finish_reason(event, stopped)
                    out_tokens = event.num_output_tokens
                    break
        finally:
            await gen.aclose()
        text = "".join(text_parts)
        if chat:
            choice = {"index": 0, "message": {"role": "assistant", "content": text},
                      "finish_reason": finish}
            if params.logprobs:
                choice["logprobs"] = {"content": [logprob_entry(e) for e in entries]}
        else:
            choice = {"index": 0, "text": (prompt + text) if params.echo else text,
                      "finish_reason": finish}
            if params.logprobs:
                toks = [token_text(e.token_id) for e in entries]
                offsets, pos = [], 0
                for t in toks:
                    offsets.append(pos)
                    pos += len(t)
                choice["logprobs"] = {
                    "tokens": toks,
                    "token_logprobs": [e.logprob for e in entries],
                    "top_logprobs": [
                        {tokenizer.decode([tid]): lp for tid, lp in (e.top_logprobs or [])}
                        for e in entries
                    ],
                    "text_offset": offsets,
                }
        return web.json_response(
            {
                "id": request_id,
                "object": "chat.completion" if chat else "text_completion",
                "created": created,
                "model": model_name,
                "choices": [choice],
                "usage": {
                    "prompt_tokens": len(prompt_token_ids),
                    "completion_tokens": out_tokens,
                    "total_tokens": len(prompt_token_ids) + out_tokens,
                },
            },
            headers={"X-Request-Id": request_id},
        )

    app.router.add_get("/v1/models", models)
    app.router.add_get("/health", health)
    app.router.add_post("/v1/chat/completions", chat_completions)
    app.router.add_post("/v1/completions", completions)

    async def lifecycle(_app):
        await engine.start()
        yield
        await engine.close()

    app.cleanup_ctx.append(lifecycle)
    return app


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="PyTorch/CUDA serving engine (OpenAI API)"
    )
    parser.add_argument("--model", default="tiny-llama", help="model preset name")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument(
        "--device", default="cuda",
        help="torch device the engine runs on (default cuda; cpu on purpose only)",
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
    return parser


def config_from_args(args):
    """The engine config for parsed flags: the preset, the served slice
    (``SLICE_OVERRIDES``), then the KV dtype, mixed-step, mixed-window,
    window and pipeline flags."""
    return config_from_preset(args.model, **{
        **SLICE_OVERRIDES,
        **({"scheduler.mixed_batch": False} if args.no_mixed_batch else {}),
        **({"scheduler.mixed_window": False} if args.no_mixed_window else {}),
        **({"scheduler.multi_prompt_window": False}
           if args.no_multi_prompt_window else {}),
        **({"cache.kv_cache_dtype": args.kv_cache_dtype}
           if args.kv_cache_dtype else {}),
        "scheduler.num_scheduler_steps": args.num_scheduler_steps,
        **({"scheduler.multi_step_window": False}
           if args.no_multi_step_window else {}),
        "scheduler.decode_window": args.decode_window,
        **({"scheduler.pipeline_decode": False}
           if args.no_pipeline_decode else {}),
    })


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s] %(levelname)s %(name)s: %(message)s",
    )
    config = config_from_args(args)
    engine = AsyncEngine(config, device=args.device)
    app = build_engine_app(engine, args.model)
    logger.info("Starting engine (%s) on port %d", args.model, args.port)
    web.run_app(app, host="0.0.0.0", port=args.port, access_log=None)


if __name__ == "__main__":
    main()
