"""Engine configuration.

Mirrors the configuration surface the reference exposes per modelSpec in
helm (helm/values.yaml:16-128: model, dtype, maxModelLen, prefix caching,
chunked prefill, tensorParallelSize) — expressed TPU-first: parallelism is a
mesh shape, memory is an HBM fraction for the paged-KV pool.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class ModelConfig:
    """Decoder-only transformer architecture (llama family + friends)."""

    name: str = "tiny-llama"
    vocab_size: int = 384  # covers the 260-entry byte-fallback tokenizer
    hidden_size: int = 64
    intermediate_size: int = 128
    num_layers: int = 2
    num_heads: int = 4
    num_kv_heads: int = 2
    head_dim: Optional[int] = None  # defaults to hidden_size // num_heads
    max_model_len: int = 2048
    rope_theta: float = 10000.0
    # Llama-3.1/3.2-style "llama3" RoPE scaling (HF rope_scaling dict:
    # factor / low_freq_factor / high_freq_factor /
    # original_max_position_embeddings) — stretches an 8k-trained RoPE to
    # 128k contexts.  None = classic RoPE.
    rope_scaling: Optional[dict] = None
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = False
    dtype: str = "bfloat16"
    # Architecture switches (cover llama/mistral/qwen-style variants).
    attention_bias: bool = False
    mlp_bias: bool = False
    sliding_window: Optional[int] = None  # mistral-style local attention
    # Sparse MoE (mixtral-style): 0 = dense MLP.  Experts shard over the
    # tp mesh axis (models/llama.py _moe_mlp).
    num_experts: int = 0
    num_experts_per_tok: int = 2
    # Gemma-family switches: zero-centered RMSNorm weights (output scaled
    # by 1+w), tanh-approx GeGLU activation, sqrt(h) embedding scaling.
    rms_norm_offset: float = 0.0
    hidden_act: str = "silu"  # silu | gelu_tanh
    scale_embeddings: bool = False
    # Weight-only quantization of the projection matmuls (decode is
    # HBM-bandwidth-bound: int8 weights halve the bytes streamed per step,
    # nearly doubling the decode roofline).  None | "int8" (per-out-channel
    # symmetric scales; embeddings/norms/biases stay in dtype).
    quantization: Optional[str] = None

    def __post_init__(self):
        if self.head_dim is None:
            self.head_dim = self.hidden_size // self.num_heads
        assert self.num_heads % self.num_kv_heads == 0
        if self.quantization not in (None, "int8"):
            raise ValueError(
                f"Unknown quantization {self.quantization!r} (None | int8)"
            )
        if self.hidden_act not in ("silu", "gelu_tanh"):
            # A typo (or HF's own string, "gelu_pytorch_tanh") silently
            # falling back to silu would serve wrong logits forever.
            raise ValueError(
                f"Unknown hidden_act {self.hidden_act!r} (silu | gelu_tanh)"
            )

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads


# Preset architectures (shapes from the public HF configs of each family;
# weights are loaded from local checkpoints or randomly initialized).
PRESETS = {
    "tiny-llama": ModelConfig(),
    "debug-1l": ModelConfig(name="llama-debug-1l", num_layers=1),
    "llama-3.2-1b": ModelConfig(
        name="llama-3.2-1b",
        vocab_size=128256,
        hidden_size=2048,
        intermediate_size=8192,
        num_layers=16,
        num_heads=32,
        num_kv_heads=8,
        head_dim=64,
        max_model_len=8192,
        rope_theta=500000.0,
        tie_word_embeddings=True,
        # The 3.2 checkpoints ship llama3 rope scaling (128k-trained).
        rope_scaling={
            "rope_type": "llama3",
            "factor": 32.0,
            "low_freq_factor": 1.0,
            "high_freq_factor": 4.0,
            "original_max_position_embeddings": 8192,
        },
    ),
    "llama-3.2-3b": ModelConfig(
        name="llama-3.2-3b",
        vocab_size=128256,
        hidden_size=3072,
        intermediate_size=8192,
        num_layers=28,
        num_heads=24,
        num_kv_heads=8,
        head_dim=128,
        max_model_len=8192,
        rope_theta=500000.0,
        tie_word_embeddings=True,
        rope_scaling={
            "rope_type": "llama3",
            "factor": 32.0,
            "low_freq_factor": 1.0,
            "high_freq_factor": 4.0,
            "original_max_position_embeddings": 8192,
        },
    ),
    "llama-3-8b": ModelConfig(
        name="llama-3-8b",
        vocab_size=128256,
        hidden_size=4096,
        intermediate_size=14336,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        max_model_len=8192,
        rope_theta=500000.0,
    ),
    # The reference's benchmark comparison model
    # (tutorials/07-benchmark-multi-round-qa-single-gpu.md:5 uses
    # Llama-3.1-8B-Instruct): llama-3-8b architecture + llama3 rope
    # scaling for long context.  HF max is 131072; capped to 32k here —
    # a v5e chip's HBM (16 GB) holds ~45k bf16 KV tokens beside the 16 GB
    # weights only with offload/int8-KV, so the default stays realistic.
    "llama-3.1-8b": ModelConfig(
        name="llama-3.1-8b",
        vocab_size=128256,
        hidden_size=4096,
        intermediate_size=14336,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        max_model_len=32768,
        rope_theta=500000.0,
        rope_scaling={
            "rope_type": "llama3",
            "factor": 8.0,
            "low_freq_factor": 1.0,
            "high_freq_factor": 4.0,
            "original_max_position_embeddings": 8192,
        },
    ),
    "mistral-7b": ModelConfig(
        name="mistral-7b",
        vocab_size=32000,
        hidden_size=4096,
        intermediate_size=14336,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        max_model_len=8192,
        rope_theta=10000.0,
        sliding_window=4096,
    ),
    # Gemma family: zero-centered norms (1+w), GeGLU, sqrt(h) embedding
    # scale, head_dim decoupled from hidden/heads, always-tied embeddings.
    "gemma-2b": ModelConfig(
        name="gemma-2b",
        vocab_size=256000,
        hidden_size=2048,
        intermediate_size=16384,
        num_layers=18,
        num_heads=8,
        num_kv_heads=1,
        head_dim=256,
        max_model_len=8192,
        rope_theta=10000.0,
        rms_norm_eps=1e-6,
        tie_word_embeddings=True,
        rms_norm_offset=1.0,
        hidden_act="gelu_tanh",
        scale_embeddings=True,
    ),
    "gemma-7b": ModelConfig(
        name="gemma-7b",
        vocab_size=256000,
        hidden_size=3072,
        intermediate_size=24576,
        num_layers=28,
        num_heads=16,
        num_kv_heads=16,
        head_dim=256,
        max_model_len=8192,
        rope_theta=10000.0,
        rms_norm_eps=1e-6,
        tie_word_embeddings=True,
        rms_norm_offset=1.0,
        hidden_act="gelu_tanh",
        scale_embeddings=True,
    ),
    "mixtral-8x7b": ModelConfig(
        name="mixtral-8x7b",
        vocab_size=32000,
        hidden_size=4096,
        intermediate_size=14336,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        max_model_len=8192,
        rope_theta=1000000.0,
        num_experts=8,
        num_experts_per_tok=2,
    ),
    # Qwen2/2.5 family: QKV biases (attention_bias), high rope theta.
    "qwen2.5-0.5b": ModelConfig(
        name="qwen2.5-0.5b",
        vocab_size=151936,
        hidden_size=896,
        intermediate_size=4864,
        num_layers=24,
        num_heads=14,
        num_kv_heads=2,
        head_dim=64,
        max_model_len=8192,
        rope_theta=1000000.0,
        rms_norm_eps=1e-6,
        attention_bias=True,
        tie_word_embeddings=True,
    ),
    "qwen2.5-7b": ModelConfig(
        name="qwen2.5-7b",
        vocab_size=152064,
        hidden_size=3584,
        intermediate_size=18944,
        num_layers=28,
        num_heads=28,
        num_kv_heads=4,
        head_dim=128,
        max_model_len=8192,
        rope_theta=1000000.0,
        rms_norm_eps=1e-6,
        attention_bias=True,
    ),
}


@dataclasses.dataclass
class CacheConfig:
    """Paged KV cache (TPU HBM pool + host DRAM offload tier)."""

    block_size: int = 16  # tokens per block
    num_blocks: Optional[int] = None  # None -> sized from HBM fraction
    hbm_utilization: float = 0.90  # fraction of free HBM for weights+KV
    # stackcheck: allow=SC401 reason=prefix caching has been the default-on contract since the seed; the safe rollback is the explicit opt-out (--no-prefix-caching), and the KV-transfer plane auto-disables itself when this is off
    enable_prefix_caching: bool = True
    # Host-DRAM offload tier (the reference's LMCache CPU-offload analogue,
    # deployment-vllm-multi.yaml:161-166).
    host_offload_gb: float = 0.0
    # Remote shared KV store URL, e.g. "kv://host:port"
    # (reference lm://host:port, _helpers.tpl:164-166).
    remote_kv_url: Optional[str] = None
    # Cross-engine prefix sharing through the remote store, content-keyed
    # by the same hash chain as the local prefix cache.  "prefill": export
    # full prompt blocks after each prefill; "decode": import matching
    # blocks on admission instead of recomputing; "both": symmetric
    # sharing.  This is the disaggregated-prefill building block (the
    # reference lists disagg as roadmap-only, README.md:57) and the
    # TPU-native analogue of LMCache's shared-store prefill reuse.
    # Requires remote_kv_url.
    disagg_role: Optional[str] = None
    # Asynchronous batched KV transfer plane (kv/prefetch.py +
    # kv/offload.py OffloadStager): admission-time remote-prefix prefetch
    # on fetcher threads (one MGET round-trip per hash chain), off-step
    # preemption offload staging, and async restore page-in — no kvserver
    # RPC or host-DMA wait ever runs inside Scheduler.schedule() or the
    # step thread's critical section.  None = auto (ON whenever
    # remote_kv_url is set); False restores the legacy synchronous
    # in-schedule transfers (A/B baseline; debugging).
    remote_prefetch: Optional[bool] = None
    # Background fetcher threads for the prefetch plane (each issues
    # independent RPCs through the client connection pool).
    prefetch_threads: int = 2
    # Disaggregated decode-phase handoff: how long the API server lets a
    # handoff-tagged request wait (off the event loop, off the step
    # thread) for the prefetched chain to land in the prefix cache before
    # admitting anyway.  Bounds the TTFT tax of a slow store; an actual
    # store miss exits the wait early.  0 disables the wait (handoff
    # requests admit local-only like any other, and will recompute).
    disagg_handoff_wait_s: float = 2.0
    # KV cache precision (vLLM --kv-cache-dtype analogue).  "int8" stores
    # each cached K/V vector as int8 with a per-(token, head) fp32 scale:
    # KV HBM traffic and pool bytes roughly halve (decode is
    # KV-bandwidth-bound at long context, SURVEY §5 long-context story),
    # so num_blocks roughly doubles at equal memory.  Importers
    # cast/quantize, so engines with different kv dtypes still share
    # prefixes; the offload/remote representation is kv_wire_format's
    # call.
    kv_cache_dtype: str = "auto"
    # Offload/remote wire representation for quantized caches.  "auto"
    # (default): an int8 cache serializes its native (data, scale)
    # tuples — no dequant round-trip on the D2H path, ~4x the resident
    # tokens per host-DRAM byte vs the fp32 wire, and snapshot serde v2
    # on the kvserver (the client probes the store once and falls back
    # to v1 dense against a legacy deployment — kvserver/protocol.py).
    # "int8" is auto plus strictness: invalid without an int8 cache,
    # and a store that fails the serde-v2 probe logs a loud WARNING at
    # downgrade (auto downgrades silently — by design, it is the
    # rollout default).  "fp32" pins the legacy dense wire
    # (bit-preserving via exact requantization — the rollout escape
    # hatch and A/B baseline).  Dense (non-int8) caches always use the
    # dense wire.
    kv_wire_format: str = "auto"

    def __post_init__(self):
        if self.disagg_role not in (None, "prefill", "decode", "both",
                                    "encode"):
            raise ValueError(
                f"Unknown disagg_role {self.disagg_role!r} "
                "(None | prefill | decode | both | encode)"
            )
        if (
            self.disagg_role is not None
            and self.disagg_role != "encode"
            and not self.remote_kv_url
        ):
            # "encode" is a pool label, not a KV-sharing role: a
            # dedicated embed/rerank/score pool member does no prefix
            # handoff and needs no store.
            raise ValueError("disagg_role requires remote_kv_url")
        if self.kv_cache_dtype not in ("auto", "int8"):
            raise ValueError(
                f"Unknown kv_cache_dtype {self.kv_cache_dtype!r} "
                "(auto | int8)"
            )
        if self.kv_wire_format not in ("auto", "fp32", "int8"):
            raise ValueError(
                f"Unknown kv_wire_format {self.kv_wire_format!r} "
                "(auto | fp32 | int8)"
            )
        if self.kv_wire_format == "int8" and self.kv_cache_dtype != "int8":
            raise ValueError(
                "kv_wire_format=int8 serializes the int8 cache's native "
                "(data, scale) representation; it requires "
                "kv_cache_dtype=int8 (a dense cache has nothing "
                "quantized to put on the wire)"
            )
        if self.prefetch_threads < 1:
            raise ValueError("prefetch_threads must be >= 1")
        if self.disagg_handoff_wait_s < 0:
            raise ValueError("disagg_handoff_wait_s must be >= 0")

    @property
    def remote_prefetch_enabled(self) -> bool:
        """Resolved async-transfer gate: auto (None) turns on exactly
        when a remote store is configured."""
        if self.remote_prefetch is None:
            return self.remote_kv_url is not None
        return bool(self.remote_prefetch)

    @property
    def wire_quantized(self) -> bool:
        """Resolved wire representation: True when offload/remote
        snapshots carry the int8 cache's native (data, scale) tuples
        (kv_cache_dtype=int8 with kv_wire_format auto/int8); False is
        the dense wire — always for dense caches, and for int8 caches
        pinned to the legacy fp32 wire."""
        return self.kv_cache_dtype == "int8" and self.kv_wire_format != "fp32"


@dataclasses.dataclass
class ParallelConfig:
    """SPMD mesh layout: data/tensor/sequence/expert axes over ICI.

    The reference only passes --tensor-parallel-size through to vLLM
    (deployment-vllm-multi.yaml:84-87); here the mesh is first-class.
    """

    data_parallel: int = 1
    tensor_parallel: int = 1
    sequence_parallel: int = 1  # sequence-parallel axis for long context
    # "ring" (ppermute KV rotation, ring_attention.py) or "ulysses"
    # (all-to-all head redistribution, ulysses.py — needs
    # (num_kv_heads/tp) % sp == 0).
    sequence_parallel_mode: str = "ring"
    expert_parallel: int = 1  # reserved for MoE models

    @property
    def mesh_shape(self) -> Tuple[int, int, int]:
        return (self.data_parallel, self.tensor_parallel, self.sequence_parallel)

    @property
    def world_size(self) -> int:
        return (
            self.data_parallel
            * self.tensor_parallel
            * self.sequence_parallel
            * self.expert_parallel
        )


@dataclasses.dataclass
class SchedulerConfig:
    """Continuous batching (vLLM-style scheduler semantics, TPU twist:
    fixed shape buckets so every step hits a cached XLA executable)."""

    max_num_seqs: int = 8  # decode batch (padded, static shape)
    max_prefill_tokens: int = 2048  # prefill bucket ceiling
    prefill_buckets: Tuple[int, ...] = (128, 256, 512, 1024, 2048)
    max_model_len: int = 2048
    # Fused mixed prefill+decode steps (Sarathi-Serve / vLLM chunked-
    # prefill-integrated batching, TPU twist: static chunk buckets).  When
    # running sequences exist AND a prompt waits, one step packs every
    # running sequence's decode token plus a bounded prefill chunk of the
    # head waiting sequence into ONE model invocation, so arriving prompts
    # no longer stall all decoders for a full prefill bucket (the ITL
    # spike the tpu:itl_seconds histogram shows under load).  None = auto
    # (ON whenever the classic single-step path is active and the mesh has
    # no dp/sp axis); False restores the alternating one-plan-per-step
    # scheduler exactly.
    mixed_batch: Optional[bool] = None
    # Per-step token budget for mixed steps (vLLM --max-num-batched-tokens
    # analogue): decode tokens (== running batch size) count first, the
    # prefill chunk gets the remainder.  None = auto: always admits the
    # largest chunk bucket beside a full decode batch.
    max_num_batched_tokens: Optional[int] = None
    # Chunk-length buckets for the prefill segment of a mixed step.  Kept
    # deliberately small: the compiled-shape space for mixed executables
    # is |prefill_chunk_buckets| x |decode batch buckets|.
    prefill_chunk_buckets: Tuple[int, ...] = (128, 256, 512)
    # "recompute" (drop + re-prefill) or "offload" (page out to host DRAM)
    preemption_mode: str = "offload"
    # Legacy spelling of the K-step decode window (vLLM's
    # --num-scheduler-steps): a value > 1 forces window size K =
    # num_scheduler_steps through the same device-resident window
    # machinery multi_step_window gates.  1 = defer to multi_step_window.
    num_scheduler_steps: int = 1
    # K-step device-resident decode windows — THE default decode fast
    # path: the scheduler emits pure-decode plans with a decode_window-
    # iteration budget whenever no prompt is waiting, and the engine runs
    # the whole window as ONE device dispatch (lax.scan over decode +
    # on-device sampling with penalties, the min_tokens EOS floor and
    # per-row stop masking), so the per-token host round-trip is
    # amortized K-fold.  Batches using logprobs / logit_bias / guided
    # decoding (host-visible per-token state) fall back to single-step
    # per dispatch (tpu:multistep_fallback_total).  With
    # speculative_ngram set, the n-gram drafter runs INSIDE the window
    # scan (spec_window_enabled).  None = auto (ON); False
    # (--no-multi-step-window) restores single-token stepping exactly —
    # and, with speculative_ngram, the legacy host-side speculative path
    # (greedy parity asserted in tests/test_multistep_window.py and
    # tests/test_speculative.py).
    multi_step_window: Optional[bool] = None
    # Window size K for multi_step_window (compiled-shape inventory grows
    # by one scan executable per decode bucket; scan compile cost is
    # ~independent of K).
    decode_window: int = 8
    # N-gram (prompt-lookup) speculative decoding: draft up to this many
    # tokens by matching the sequence's trailing bigram against its own
    # recent history and verify them alongside the committed token in
    # ONE forward (the draft rows share the step's weight streaming, so
    # accepted drafts are nearly free on an HBM-bound decode).  With the
    # K-step decode window active (the default) the drafter runs INSIDE
    # the window scan: drafts are proposed on-device from the carried
    # history, verified in the same scan-iteration forward, and
    # acceptance folds into the carried state — a rejected draft costs a
    # scan iteration, never a host round-trip.  Greedy-only (acceptance
    # compares the model's own argmax); batches with sampled rows run
    # the plain window, and logprobs/logit_bias/guided rows fall back to
    # single-step like any other window batch.  With
    # multi_step_window=False the LEGACY host-side speculative path runs
    # instead (drafts built on the host, one wide verify dispatch per
    # step — the A/B baseline and the fallback the host-state rows use).
    # 0 = off.
    speculative_ngram: int = 0
    # Draft-MODEL speculative decoding: a second, tiny model (a PRESETS
    # name, e.g. "tiny-llama" — loaded through the same registry/weights
    # path as the target and sharded on the same mesh) proposes up to
    # speculative_draft_len tokens per scan iteration INSIDE the K-step
    # window, autoregressively from its own small device-resident KV
    # cache (carried through the scan like the n-gram history buffer;
    # blocks come from a dedicated draft pool so target KV capacity is
    # untouched).  The target verifies draft+1 rows in the SAME wide
    # forward the n-gram drafter uses — the two drafters are proposal
    # sources behind one in-scan drafting interface, so acceptance,
    # penalties, min_tokens, stop masks and the PRNG ordinal schedule
    # are shared and greedy streams stay byte-identical across
    # {none, ngram, model}.  Mutually exclusive with speculative_ngram
    # (one proposal source per engine); requires the window machinery
    # (no legacy host path exists for the model drafter).  Unlike the
    # n-gram drafter, proposals depend only on draft weights + carried
    # state, so acceptance holds up on non-templated text.  None = off.
    speculative_model: Optional[str] = None
    # Draft tokens proposed per scan iteration by the model drafter
    # (the D in the W = D+1 verify-row fan-out; the model-drafter
    # analogue of speculative_ngram's count).
    speculative_draft_len: int = 4
    # Device blocks reserved for the draft model's KV pool.  None = auto
    # (sized for max_num_seqs rows at the drafter's history window plus
    # chained-window growth).  Exhaustion never stalls: a window that
    # cannot allocate draft blocks declines to a plain (non-speculative)
    # window, counted under tpu:multistep_fallback_total{reason=draft_pool}.
    speculative_draft_pool_blocks: Optional[int] = None
    # Mixed K-step windows: a waiting prompt's prefill chunks ride the
    # device-resident decode scan instead of forcing K=1 steps — each
    # scan iteration runs the packed [decode + chunk] mixed forward
    # (decode rows advance one token from the carried state; the head
    # prompt's NEXT chunk rides the same forward with its chunk cursor
    # carried in-graph), so under sustained arrivals the fleet keeps the
    # K-fold host-round-trip amortization it used to forfeit whenever a
    # prompt waited.  The window length is min(decode_window, chunks
    # remaining for the head prompt, an adaptive clamp halving per
    # extra waiter) so the window ALWAYS ends at an admission boundary
    # — greedy streams stay byte-identical and seeded streams
    # bit-identical to the K=1 mixed path, and TTFT never regresses
    # more than one window's worth.  None = auto (ON whenever mixed
    # steps and K-step windows are both active); False
    # (--no-mixed-window) restores the K=1 mixed scheduling exactly
    # (waiting head -> K=1 steps, tpu:multistep_fallback_total
    # {reason="waiting_head"}).
    mixed_window: Optional[bool] = None
    # Multi-prompt packed mixed windows: each scan iteration of a mixed
    # K-step window may carry a chunk cursor from a DIFFERENT waiting
    # prompt (ragged per-iteration cursors over the same static
    # prefill_chunk_buckets shapes — steady-state serving never
    # recompiles), so deep queues fill the window instead of shrinking
    # it.  The packed path retires the adaptive K-halving clamp
    # (mixed_window_clamp) and runs full-K pure-decode windows when the
    # batch is slot-full (no admission is possible mid-window anyway),
    # driving {reason="waiting_head"} fallbacks to zero under surge.
    # Admission still happens only at window boundaries, so greedy
    # streams stay byte-identical and seeded streams bit-identical to
    # the single-head path.  None = auto (ON whenever
    # mixed_window_enabled); False (--no-multi-prompt-window) restores
    # the single-head window + adaptive clamp exactly,
    # plan-by-plan.
    multi_prompt_window: Optional[bool] = None
    # Bounded admission (overload protection): once the waiting queue
    # holds this many requests (or prompt tokens), the API server rejects
    # new work with a structured 429 + Retry-After instead of queueing it
    # unboundedly (reject early and cheaply at the edge, not time out
    # expensively in the middle — docs/robustness.md).  None = auto:
    # max_queued_requests -> 4 x max_num_seqs,
    # max_queued_tokens   -> 2 x max_num_seqs x max_model_len.
    max_queued_requests: Optional[int] = None
    max_queued_tokens: Optional[int] = None
    # Master gate for bounded admission.  None = auto (ON);
    # False (--no-admission-control) restores the unbounded legacy
    # admission exactly (greedy parity asserted in tests/test_overload.py).
    admission_control: Optional[bool] = None
    # Batched encode lane: embed/rerank/score inputs queue on the event
    # loop and the STEP THREAD drains them as [B, T]-bucketed encode
    # batches at window boundaries — one prefill-chunk-shaped pass with
    # no KV bookkeeping, so decode windows are never preempted mid-scan
    # and the device is never touched off the step thread.  None = auto
    # (ON; the server auto-disables it under multi-host lockstep, where
    # a leader-only encode forward would desync the SPMD followers);
    # False (--no-encode-lane) restores the serial per-text embed path.
    encode_lane: Optional[bool] = None
    # B-axis bucket grid for encode batches: a batch of n texts pads to
    # the smallest bucket >= n (T pads to a prefill chunk bucket), so
    # the jitted executable count stays |encode_batch_buckets| x
    # |prefill_chunk_buckets| — the same grid discipline as mixed steps.
    encode_batch_buckets: Tuple[int, ...] = (1, 2, 4, 8)
    # Encode-queue admission bound (texts): once this many texts are
    # queued for the encode lane, new embed/rerank/score requests get a
    # structured 429 + Retry-After (bounded admission, encode flavor).
    # None = auto: 32 x encode_batch_buckets[-1].
    max_queued_encode_texts: Optional[int] = None
    # Step-loop watchdog: /health fails liveness when the engine step
    # thread has not completed an iteration within this many seconds (a
    # hung device dispatch otherwise serves a green probe forever).
    # Generous default: the first XLA compile of a large bucket set can
    # legitimately take minutes.  0 disables the check.
    step_watchdog_s: float = 300.0
    # Async lookahead decode pipeline: dispatch decode step (or K-step
    # window) N+1 — input tokens chained from N's still-in-flight
    # device-resident sample — before reading N's result back, so host
    # scheduling/detokenize overlaps device compute.  Greedy streams are
    # byte-identical to synchronous stepping; single-step batches using
    # host-state sampling features fall back per step, and K-step windows
    # chain through the device-resident window carry (done/penalty state
    # rides along, so stopped rows stay frozen in the successor).
    # None = auto (ON unless the LEGACY host-side speculative path is
    # active — speculative_ngram with the window disabled — whose wide
    # verify dispatch is synchronous); explicit True conflicts with that
    # legacy combination; False forces synchronous stepping.
    pipeline_decode: Optional[bool] = None

    def __post_init__(self):
        if self.speculative_ngram < 0:
            raise ValueError("speculative_ngram must be >= 0")
        if self.speculative_draft_len < 1:
            raise ValueError("speculative_draft_len must be >= 1")
        if (
            self.speculative_draft_pool_blocks is not None
            and self.speculative_draft_pool_blocks < 2
        ):
            # BlockPool reserves block 0 as the null block; a pool of
            # fewer than 2 blocks can never allocate anything.
            raise ValueError("speculative_draft_pool_blocks must be >= 2")
        if self.speculative_model is not None and self.speculative_ngram:
            raise ValueError(
                "speculative_model and speculative_ngram are mutually "
                "exclusive (one proposal source per engine); drop "
                "--speculative-ngram or pass --no-speculative-model"
            )
        if self.speculative_model is not None and self.multi_step_window is False:
            raise ValueError(
                "speculative_model runs INSIDE the K-step window scan and "
                "has no legacy host-side path; drop --no-multi-step-window "
                "or --speculative-model"
            )
        if self.decode_window < 1:
            raise ValueError("decode_window must be >= 1")
        if self.num_scheduler_steps > 1 and self.multi_step_window is False:
            raise ValueError(
                "num_scheduler_steps > 1 requests a K-step decode window "
                "but multi_step_window=False disables the window machinery "
                "that runs it; drop one of the two"
            )
        # speculative_ngram COMPOSES with multi_step_window /
        # num_scheduler_steps / pipeline_decode / mixed_batch: the
        # drafter runs inside the window scan (draft-and-verify per scan
        # iteration, acceptance folded into the carried state).  Only
        # the LEGACY host-side speculative path — speculative_ngram with
        # the window explicitly disabled — keeps the old conflicts: its
        # wide verify dispatch is synchronous and one-plan-shaped.
        legacy_spec = bool(self.speculative_ngram) and self.window_steps == 1
        if self.pipeline_decode and legacy_spec:
            raise ValueError(
                "pipeline_decode requires the fused speculative window; "
                "the legacy host-side speculative path (speculative_ngram "
                "with multi_step_window=False) dispatches synchronously — "
                "drop --no-multi-step-window or --no-pipeline-decode"
            )
        if self.mixed_batch and legacy_spec:
            raise ValueError(
                "mixed_batch requires the fused speculative window; the "
                "legacy host-side speculative path (speculative_ngram "
                "with multi_step_window=False) assumes one plan shape per "
                "dispatch — drop --no-multi-step-window or "
                "--no-mixed-batch"
            )
        if self.mixed_window and self.multi_step_window is False:
            raise ValueError(
                "mixed_window=True requests prefill chunks riding the "
                "K-step decode scan but multi_step_window=False disables "
                "the window machinery; drop one of the two"
            )
        if self.mixed_window and self.mixed_batch is False:
            raise ValueError(
                "mixed_window=True requires mixed_batch (the chunk "
                "machinery); drop --no-mixed-batch or --mixed-window"
            )
        if self.multi_prompt_window and self.mixed_window is False:
            raise ValueError(
                "multi_prompt_window=True packs prompts into mixed K-step "
                "windows but mixed_window=False disables those windows; "
                "drop --no-mixed-window or --multi-prompt-window"
            )
        if not self.prefill_chunk_buckets:
            raise ValueError("prefill_chunk_buckets must be non-empty")
        if tuple(sorted(self.prefill_chunk_buckets)) != tuple(
            self.prefill_chunk_buckets
        ):
            raise ValueError("prefill_chunk_buckets must be sorted ascending")
        if self.max_queued_requests is not None and self.max_queued_requests < 1:
            raise ValueError("max_queued_requests must be >= 1")
        if self.max_queued_tokens is not None and self.max_queued_tokens < 1:
            raise ValueError("max_queued_tokens must be >= 1")
        if not self.encode_batch_buckets:
            raise ValueError("encode_batch_buckets must be non-empty")
        if tuple(sorted(self.encode_batch_buckets)) != tuple(
            self.encode_batch_buckets
        ) or self.encode_batch_buckets[0] < 1:
            raise ValueError(
                "encode_batch_buckets must be positive and sorted ascending"
            )
        if (
            self.max_queued_encode_texts is not None
            and self.max_queued_encode_texts < 1
        ):
            raise ValueError("max_queued_encode_texts must be >= 1")
        if self.step_watchdog_s < 0:
            raise ValueError("step_watchdog_s must be >= 0 (0 disables)")
        if (
            self.max_num_batched_tokens is not None
            and self.max_num_batched_tokens
            < self.max_num_seqs + self.prefill_chunk_buckets[0]
        ):
            raise ValueError(
                f"max_num_batched_tokens={self.max_num_batched_tokens} can "
                "never admit a prefill chunk beside a full decode batch; "
                f"needs >= max_num_seqs + smallest chunk bucket "
                f"({self.max_num_seqs} + {self.prefill_chunk_buckets[0]})"
            )

    @property
    def window_steps(self) -> int:
        """Resolved K-step decode-window size: iterations a pure-decode
        plan may fuse into one device dispatch.  1 = single-token steps
        (window off); num_scheduler_steps > 1 keeps its legacy meaning
        as an explicit window size.  Speculation no longer resolves the
        window off — the drafter runs INSIDE the scan (spec_window_enabled);
        only the explicit multi_step_window=False escape hatch restores
        the legacy host-side speculative path."""
        if self.multi_step_window is False:
            return 1
        if self.num_scheduler_steps > 1:
            return self.num_scheduler_steps
        return max(1, self.decode_window)

    @property
    def spec_drafter(self) -> Optional[str]:
        """Configured in-scan proposal source: "ngram" (prompt-lookup
        from the carried history buffer), "model" (tiny draft model with
        its own device-resident KV), or None.  Selection only — gate on
        spec_window_enabled for whether the fused path actually runs."""
        if self.speculative_model is not None:
            return "model"
        if self.speculative_ngram:
            return "ngram"
        return None

    @property
    def spec_draft_len(self) -> int:
        """Draft tokens proposed per scan iteration by whichever drafter
        is configured (the D in the W = D+1 verify-row fan-out)."""
        if self.speculative_model is not None:
            return self.speculative_draft_len
        return self.speculative_ngram

    @property
    def spec_window_enabled(self) -> bool:
        """The fused draft-and-verify path: speculation (n-gram or draft
        model) proposed, verified, and folded INSIDE the K-step window
        scan.  False means either no speculation, or the legacy host-side
        speculative path (speculative_ngram with multi_step_window=False;
        the model drafter has no legacy path — it is simply inert at
        K=1)."""
        return self.spec_drafter is not None and self.window_steps > 1

    @property
    def window_max_tokens(self) -> int:
        """Per-pure-decode-window token ceiling a single row may emit:
        K iterations, each committing one token plus up to
        spec_draft_len accepted drafts under the fused path.  THE
        bound the scheduler budgets block allocation and max_model_len
        room against (max-acceptance growth), and the engine sizes the
        chained-window block-table delta from."""
        if self.spec_window_enabled:
            return self.window_steps * (self.spec_draft_len + 1)
        return self.window_steps

    @property
    def pipeline_enabled(self) -> bool:
        """Resolved pipeline gate: auto (None) turns on unless the
        LEGACY host-side speculative path owns the dispatch shape
        (fused speculative windows chain through the pipeline like any
        window: N+1 dispatched off window N's device-resident carry,
        draft history included)."""
        if self.pipeline_decode is None:
            return not (self.speculative_ngram and self.window_steps == 1)
        return self.pipeline_decode

    @property
    def mixed_enabled(self) -> bool:
        """Resolved mixed-step gate: auto (None) turns on unless the
        LEGACY host-side speculative path is active (mixed steps coexist
        with K-step windows — speculative or not: the scheduler picks
        K=1 mixed steps while a prompt waits and K>1 pure-decode windows
        otherwise).  The engine additionally clears ``mixed_batch`` when
        the mesh has a dp/sp axis (the packed mixed batch is not
        dp/sp-shardable)."""
        if self.mixed_batch is None:
            return not (self.speculative_ngram and self.window_steps == 1)
        return self.mixed_batch

    @property
    def mixed_window_enabled(self) -> bool:
        """Resolved mixed K-step window gate: auto (None) turns on
        whenever BOTH parents are active — mixed steps (the chunk
        machinery) and K>1 windows (the scan machinery).  An explicit
        True still requires both parents: the fused plan shape does not
        exist without them."""
        if self.mixed_window is False:
            return False
        return self.mixed_enabled and self.window_steps > 1

    @property
    def multi_prompt_window_enabled(self) -> bool:
        """Resolved packed-window gate: auto (None) rides
        mixed_window_enabled — packing is the default whenever mixed
        K-step windows exist.  False (--no-multi-prompt-window) keeps
        the windows but restores the single-head planner and its
        adaptive clamp exactly."""
        if self.multi_prompt_window is False:
            return False
        return self.mixed_window_enabled

    def mixed_window_clamp(self, num_waiting: int) -> int:
        """Adaptive per-window iteration clamp keyed to waiting-queue
        depth: the head prompt gets the full window to itself, and each
        EXTRA waiter halves it (deep queue -> shorter windows -> more
        frequent admission re-evaluation), so no waiter's TTFT regresses
        more than one window's worth behind the head's chunks."""
        extra = max(0, num_waiting - 1)
        return max(1, self.window_steps >> min(extra, 8))

    @property
    def admission_enabled(self) -> bool:
        """Resolved bounded-admission gate: auto (None) means ON."""
        if self.admission_control is None:
            return True
        return bool(self.admission_control)

    @property
    def queued_requests_cap(self) -> int:
        """Resolved waiting-queue request bound."""
        if self.max_queued_requests is not None:
            return self.max_queued_requests
        return 4 * self.max_num_seqs

    @property
    def queued_tokens_cap(self) -> int:
        """Resolved waiting-queue prompt-token bound."""
        if self.max_queued_tokens is not None:
            return self.max_queued_tokens
        return 2 * self.max_num_seqs * self.max_model_len

    @property
    def encode_lane_enabled(self) -> bool:
        """Resolved encode-lane gate: auto (None) means ON.  The server
        additionally clears it under multi-host lockstep (leader-only
        encode forwards would desync SPMD followers)."""
        if self.encode_lane is None:
            return True
        return bool(self.encode_lane)

    @property
    def queued_encode_texts_cap(self) -> int:
        """Resolved encode-queue text bound (admission)."""
        if self.max_queued_encode_texts is not None:
            return self.max_queued_encode_texts
        return 32 * self.encode_batch_buckets[-1]

    @property
    def batched_tokens_budget(self) -> int:
        """Resolved per-step token budget for mixed steps."""
        if self.max_num_batched_tokens is not None:
            return self.max_num_batched_tokens
        return self.max_num_seqs + self.prefill_chunk_buckets[-1]


@dataclasses.dataclass
class LoraServingConfig:
    """Multi-LoRA slots (engine/lora.py); max_loras=0 disables the path."""

    max_loras: int = 0
    max_rank: int = 16

    @property
    def enabled(self) -> bool:
        return self.max_loras > 0

    @property
    def num_slots(self) -> int:
        # +1 for the identity slot 0 (base model).
        return self.max_loras + 1


@dataclasses.dataclass
class ObsConfig:
    """Observability layer (production_stack_tpu/obs): request tracing,
    /debug/requests ring buffers, and the per-step phase histograms.

    ``tracing=False`` is the fast-path gate: every obs hook in the engine
    core returns before touching any state (no histogram observes, no
    trace allocations per step) — the pre-tracing hot path, verified by
    tests/test_observability.py."""

    # stackcheck: allow=SC401 reason=tracing default-on is the standing contract (--no-tracing restores the untraced fast path, verified by a zero-state + greedy-parity test)
    tracing: bool = True
    # Completed request timelines kept per component (bounds /debug memory).
    trace_ring_size: int = 256
    # Byte bound on the completed-trace ring: long-prompt records are
    # hundreds of times larger than short ones, so the count bound alone
    # does not bound resident memory.  Oldest records are evicted past
    # this and counted in tpu:obs_trace_dropped_total.  0 disables the
    # byte bound (count bound only).
    trace_ring_bytes: int = 8 * 1024 * 1024
    # Completed window flight-recorder records kept (obs/flight_recorder):
    # one per engine dispatch, served at GET /debug/windows and joined
    # into /debug/requests/{id}.
    window_ring_size: int = 1024

    def __post_init__(self):
        if self.trace_ring_size < 1:
            raise ValueError("trace_ring_size must be >= 1")
        if self.trace_ring_bytes < 0:
            raise ValueError("trace_ring_bytes must be >= 0")
        if self.window_ring_size < 1:
            raise ValueError("window_ring_size must be >= 1")


@dataclasses.dataclass
class EngineConfig:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    cache: CacheConfig = dataclasses.field(default_factory=CacheConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    lora: LoraServingConfig = dataclasses.field(default_factory=LoraServingConfig)
    obs: ObsConfig = dataclasses.field(default_factory=ObsConfig)
    seed: int = 0
    tokenizer: Optional[str] = None  # HF tokenizer path; None -> byte fallback
    weights_path: Optional[str] = None  # safetensors dir; None -> random init
    # Draft-model checkpoint (scheduler.speculative_model); None -> the
    # same deterministic random init the target uses, seeded identically
    # on every replica (lockstep-safe by construction).
    draft_weights_path: Optional[str] = None

    def __post_init__(self):
        # The scheduler must not admit sequences the cache cannot hold.
        self.scheduler.max_model_len = min(
            self.scheduler.max_model_len, self.model.max_model_len
        )


def config_from_preset(name: str, **overrides) -> EngineConfig:
    if name not in PRESETS:
        raise ValueError(f"Unknown model preset {name!r}; available: {sorted(PRESETS)}")
    model = dataclasses.replace(PRESETS[name])
    cfg = EngineConfig(model=model)
    for key, value in overrides.items():
        obj = cfg
        *path, last = key.split(".")
        for part in path:
            obj = getattr(obj, part)
        setattr(obj, last, value)
    # setattr bypasses dataclass validation: re-run every sub-config's
    # __post_init__ so invalid override COMBINATIONS (e.g. speculative +
    # multi-step, disagg without a store URL) fail at construction, not
    # as undefined runtime behavior.
    for sub in (cfg.model, cfg.cache, cfg.scheduler, cfg.parallel, cfg.lora,
                cfg.obs):
        post = getattr(sub, "__post_init__", None)
        if post is not None:
            post()
    return cfg
