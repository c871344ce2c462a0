"""LLMEngine: the serving engine core (PyTorch).

Counterpart of ``production_stack_tpu/engine/core/engine.py``, slimmed to
the main serving path.  ``step()`` is ``dispatch()`` then ``collect()``, as
in the JAX engine: dispatch launches device work without reading anything
back, filling the pipeline to its depth (2 with the one-step lookahead, 1
without), and collect finalizes the oldest dispatched step.  A plan is a
(possibly chunked) prefill of one sequence, a mixed step (every running
sequence decodes one token beside one prefill chunk), a mixed K-step
window, a K-step decode window, or one single-token decode step:

- prefills, K=1 mixed steps and decode batches whose rows need
  host-visible sampling state (logprobs, ``logit_bias``, guided decoding)
  run synchronously and sample on the host side of one device read; a
  guided row's choice is checked against its JSON automaton
  (``engine/guided.py``, ``engine/guided_schema.py``) and replaced by the
  best valid candidate when the device's pick does not fit;
- an ``echo`` + ``logprobs`` prompt runs the dedicated prefill with its
  next-token targets: the lm_head sweeps the chunk's rows in slices and
  the per-position logprobs are stitched across chunks;
- a pure-decode plan runs as a K-step window (``decode_window``, default
  8): K decode+sample iterations with the penalties, the ``min_tokens``
  floor and per-row stop masking on the device, the carry (tokens,
  positions, ctx, done, min_left, occurrence counts) in static buffers
  that a chained window continues from without a host round-trip;
- while prompts wait, a mixed K-step window (``mixed_window``, on by
  default; ``multi_prompt_window`` packs chunks of several prompts into
  one window): each iteration runs the fused ``[S decode rows + T chunk
  rows]`` forward, the decode rows advancing the same carry as a plain
  window, the chunk at its own cursor (tokens, cached and valid lengths,
  new blocks, prefix table) read on the device; a final chunk's tail
  logits are kept and its first token sampled at collect, with the step
  ordinal of its iteration.  Mixed and plain windows chain from one
  another's carry;
- with windows off (``multi_step_window=False``), a pure-decode batch that
  needs no host state runs as a pipelined single-token step whose input
  tokens chain from the previous step's in-flight sample.

Speculative decoding (greedy batches only, so streams equal plain ones):
with ``speculative_ngram`` or ``speculative_model`` a greedy decode window
is a speculative window, each iteration drafting up to D tokens a row (a
prompt lookup in the carried history, or D+1 forwards of the draft model
over its own dense KV pool), verifying them beside the committed token in
one decode over S x (D+1) rows and folding the accepted tokens into the
carry; with windows off, ``speculative_ngram`` runs the legacy host path
(drafts built on the host, one wide verify step read back at once).

On the card each window, each mixed-window iteration and each pipelined
step is one CUDA-graph replay (``cuda_graphs.py``); the one host sync a
dispatch waits on is its own event, in ``collect``.

Owns the params and the paged KV caches on one device, the block pool
(hash-chained prefix cache, null block 0) and the scheduler.  The caches
are dense in the model dtype or, with ``cache.kv_cache_dtype="int8"``,
int8 ``(data, scale)`` tuples (``kv/quant.py``).  Prefill runs the
flash-prefill kernel and decode the paged-decode kernel for the cache
type whenever the tensors live on a CUDA device (``ops/attention.py``).

The KV tiers (``kv/offload.py``, ``kv/prefetch.py``, ``kvserver/``):
with ``preemption_mode="offload"`` (the default) and ``host_offload_gb >
0`` a preempted sequence's blocks are gathered on the device and staged
into pinned host memory off the step thread, then restored into fresh
blocks in place of a recompute; ``remote_kv_url`` adds the shared store
behind the host tier; ``disagg_role`` prefill / decode / both exports
full prompt blocks under content keys after each final prefill and
imports them at admission into the prefix cache.  Every gather, copy and
write of these paths is enqueued on the stream the steps and graph
replays run on, without a host sync; the writes go into the pool's own
tensors in place.

The encode lane (``embed``, ``encode_batch``): embed/rerank/score texts
run as one ``[B, T]``-bucketed ``llama.encode_batch`` forward, no KV
written, through flash prefill's batched entry; the token rows and
lengths go up in one non-blocking copy and the ``[B, hidden]`` vectors
come back in one device-to-host copy.  ``encode_batch`` runs on the step
thread, between windows, on the stream the steps run on; the serial
``embed`` (the lane off) runs from a worker thread on a CUDA stream of its
own, so it never joins the legacy default stream while the step thread
captures a graph.

Multi-LoRA (``lora.max_loras > 0``): the adapter slot stacks
(``engine/lora.py``) are allocated at boot, before the KV pool is sized,
and every forward takes each row's slot: a scalar for a prefill, ``[S]``
in the pipelined step's and the window's static buffers, one slot an
iteration in a mixed window's chunk schedule (its T rows share it), each
row's slot repeated W times for a speculative verify.  An adapter load
stages its factors on a stream of its own from the caller's thread, then
commits them into the stacks in place on the stream the steps run on,
between dispatches: on the thread bound by :meth:`bind_commit_thread`
(the serving step loop) at its drain point :meth:`run_commits`, or on the
caller's thread when none is bound.  No graph is captured again.

Observability (``obs.tracing``, on by default as in the JAX engine;
``obs/``): ``self.obs`` (``EngineObs``) is fed from the step thread at the
JAX engine's places: the step-phase histograms (schedule, dispatch,
collect, sample, mixed), the request hooks (first scheduled, first token,
token gaps, finish, abort), one flight record per dispatch of every kind
(K=1 and pipelined steps, plain, mixed and speculative windows, the legacy
host verify, prefill and the synchronous fallbacks) completed at collect
from what collect copied back, the KV spans and the transfer plane's
histograms.  A compile event is the first use of a ``GraphRunner`` key
(``obs/compile_tracker.py``), and also the first load of a kernel library
(``ops/_build.py``: the ``nvcc`` build when nothing is built, then the
``dlopen``), which can land inside a first request as Pallas lowering does
inside an XLA compile; both are drained after each dispatch into the
owning record and the co-scheduled requests' traces.  No hook reads a
device tensor, syncs the host or touches what a graph body reads.  With
tracing off every hook returns before touching state and the runner gets
no first-use hook.

Weights: ``weights_path`` (and ``draft_weights_path`` for the drafter)
name an HF safetensors checkpoint (``models/weights.py``); without one the
seeded random init.  With ``model.quantization="int8"`` the target's
projections and untied lm_head become int8 ``{"q", "s"}`` pairs after
loading (``llama.quantize_params``), and every forward runs them through
the W8A16 kernel; the drafter stays in the model dtype, as in the JAX
engine.

The engine serves the JAX package's default configuration, mixed and
packed K-step windows, the KV tiers, speculation, the encode lane,
multi-LoRA, tracing, guided decoding and prompt logprobs included
(``SLICE_OVERRIDES`` is empty; HF weights for the target or the drafter;
dense models and Mixtral-style sparse MoE ones, whose block
``llama._moe_mlp`` runs inside every forward and captured graph; dense or
int8 KV; ``mixed_window=False`` restores K=1 mixed steps while prompts
wait).  Tensor parallelism (``parallel.tensor_parallel``) runs over a
mesh of devices (``engine/parallel/``), in the JAX engine's order:
``validate_tp``, ``validate_sp_mode``, the mesh, then the params cut into
one tree per tp position (the draft model's on the same mesh) and the KV
pool into one pool a position by heads; every dispatch and graph body
takes them as they are, so each window and mixed iteration stays one
CUDA-graph replay holding every position's launches and reductions.  The
positions sit on one device of this process, or, in a multi-process group
(``parallel/distributed.py``: the JAX package's ``PSTPU_*`` contract, one
process a card, formed before the engine is built), this process runs its
own ``tp / (world / sp)`` positions on its card: it draws or reads each
weight and keeps only its slices, sizes its pool by its own card, and
each graph holds the NCCL all-reduces and the lm_head's all-gather over
its tp subgroup (the ranks of its sp position), so the
ranks, stepped in lockstep (the leader's event batches), launch the same
graphs in the same order.  The tiers move full-head blocks, gathered from
the positions' pools and scattered back.  In a group every transfer
outcome is decided on the step thread and agreed over the group: offload
and restore move each rank's own heads (its remote snapshot keyed by the
rank), the store holds full-head blocks under one engine's keys (process 0
gathers its tp subgroup's heads and writes; every rank reads and writes
its own heads, the blocks taken the least any rank found), and the
encode routes run the serial ``embed`` on every rank between steps.  The
asynchronous transfer plane (``cache.remote_prefetch``) resolves to off
in a group when left on auto, as the JAX server does, and an explicit
True is served: its fetcher and stager threads run on every rank, and
the group agrees on their jobs' states once a front dispatch while a job
is live (``_agree_transfers``: one all-reduce MIN of a small vector), so
a chain lands, a page-in is ready or missing and the stager's slot frees
on every rank at the same step; a handoff's chain job rides the event
batch (``StepEvents.handoffs``).  Speculative decoding runs in a group
as in one process: the drafter cut to the rank's positions as it is made,
its pool one tp position's heads a rank, every rank drafting, verifying
and accepting the same tokens.

Data and sequence parallelism (``parallel.data_parallel``,
``parallel.sequence_parallel``) run in one process, every position of the
mesh on the engine's device, and sp also runs in a group, one sp position
a rank (its tp subgroup's ranks hold that position's tp positions), after
the JAX engine's gates in its order
(``max_num_seqs`` divisible by dp; mixed steps auto-resolved to off, an
explicit ``mixed_batch=True`` refused, so mixed windows are off too; at sp
> 1 no sliding window, buckets and ``max_model_len`` divisible by
``block_size * sp``).  The dp and sp positions share the device's weight
trees and pool.  dp changes which decode buckets exist (dp, 2dp, 4dp, ...,
as in the JAX engine; each dp position holds S/dp contiguous rows, which
run as one batch through every product, kernel and graph); sp runs every
prefill's attention over the sp positions' shards, the ring or Ulysses
(``llama.prefill``), and the decode rows as at sp = 1.  In a group each
rank runs its own rows of a prefill chunk and the ring or Ulysses over its
sp column (NCCL send/recv and all-to-all on the card), every rank writes
the same replicated pool and samples the same token, and the decode
windows run replicated over sp, each rank's graphs reducing over its tp
subgroup only.  It raises ``NotImplementedError`` at construction, by
name, for the one setting outside it: dp > 1 in a multi-process group.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import queue
import threading
import time
import zlib
from collections import OrderedDict, deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from production_stack_tpu_torch.engine import sampling as sampling_lib
from production_stack_tpu_torch.engine.config import PRESETS, EngineConfig
from production_stack_tpu_torch.engine.core.cuda_graphs import GraphRunner
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
    host_state_flags,
)
from production_stack_tpu_torch.engine.guided import JsonGuide, TokenTextCache
from production_stack_tpu_torch.engine.guided_schema import (
    SchemaGuide,
    validate_instance,
)
from production_stack_tpu_torch.engine.kv import quant as kv_quant
from production_stack_tpu_torch.engine.kv.block_pool import (
    BlockPool,
    prefix_block_hashes,
)
from production_stack_tpu_torch.engine.kv.offload import (
    HostOffloadManager,
    OffloadStager,
    _layers_nbytes,
)
from production_stack_tpu_torch.engine.kv.prefetch import (
    PrefetchedChain,
    PrefetchManager,
)
from production_stack_tpu_torch.engine.lora import (
    AdapterRegistry,
    load_peft_safetensors,
)
from production_stack_tpu_torch.engine.models import llama
from production_stack_tpu_torch.engine.models.weights import load_params
from production_stack_tpu_torch.engine.ops import _build
from production_stack_tpu_torch.engine.ops.kernels import paged_attention, w8a16
from production_stack_tpu_torch.engine.parallel import collectives, distributed, shardings
from production_stack_tpu_torch.engine.parallel.mesh import build_mesh
from production_stack_tpu_torch.engine.tokenizer import get_tokenizer
from production_stack_tpu_torch.kvserver.client import RemoteKVClient
from production_stack_tpu_torch.kvserver.protocol import KVWireStats
from production_stack_tpu_torch.obs.engine import EngineObs
from production_stack_tpu_torch.obs.histogram import Histogram

logger = logging.getLogger(__name__)

# The configuration this engine serves, as ``config_from_preset``
# overrides: none, the JAX engine's defaults (K-step windows with the
# lookahead pipeline, mixed steps, mixed and packed K-step windows, offload
# preemption, the encode lane, tracing).
SLICE_OVERRIDES: Dict[str, object] = {}


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


def _unsupported(config: EngineConfig, group=None) -> List[str]:
    """Settings outside the served configuration, by name, each with its
    reason: in one process every mesh is served; in a multi-process group
    dp above 1 is not."""
    par = config.parallel
    grouped = group is not None and group.world > 1
    checks = [
        (grouped and par.data_parallel > 1,
         "data_parallel > 1 in a multi-process group (dp across cards is no "
         "port step: the JAX server refuses dp in a multi-host group too; "
         "scale replicas instead)"),
    ]
    return [name for bad, name in checks if bad]


def _check_mesh_gates(config: EngineConfig) -> None:
    """The JAX engine's gates on a dp or sp mesh, in its order, after
    ``validate_tp`` and ``validate_sp_mode``: ``max_num_seqs`` divides by
    dp; mixed steps (the packed ``[S + T]`` batch, whose two segments would
    shard differently) auto-resolve to off, and an explicit True raises;
    the chunk buckets divide into whole blocks when mixed steps are on; at
    sp > 1 no sliding window, and every prefill bucket and
    ``max_model_len`` divide by ``block_size * sp`` (the ring shards the
    chunk and the prefix's block table over sp)."""
    par, sched = config.parallel, config.scheduler
    if sched.max_num_seqs % par.data_parallel:
        raise ValueError(
            f"max_num_seqs={sched.max_num_seqs} must be "
            f"divisible by data_parallel={par.data_parallel}"
        )
    if par.data_parallel > 1 or par.sequence_parallel > 1:
        if sched.mixed_batch:
            raise ValueError(
                "mixed_batch=True requires data_parallel == "
                "sequence_parallel == 1 (the packed mixed token batch "
                "cannot be dp/sp-sharded); drop the flag or the mesh "
                "axis"
            )
        sched.mixed_batch = False
    _check_chunk_buckets(config)
    if par.sequence_parallel > 1:
        if config.model.sliding_window is not None:
            raise ValueError(
                "sequence_parallel>1 is not supported with "
                "sliding_window models (the ring path has no local-"
                "attention mask); use sp=1"
            )
        span = config.cache.block_size * par.sequence_parallel
        for bucket in sched.prefill_buckets:
            if bucket % span:
                raise ValueError(
                    f"prefill bucket {bucket} not divisible by "
                    f"block_size*sp={span}"
                )
        if sched.max_model_len % span:
            raise ValueError(
                f"max_model_len={sched.max_model_len} not "
                f"divisible by block_size*sp={span} (the cached-prefix "
                "ring shards the prefix block table over sp)"
            )


def _group_of_process():
    """The multi-process group this process belongs to
    (``distributed.initialize``), or None.  An environment that declares a
    group this process has not formed raises: one rank alone is not the
    group."""
    group = distributed.tp_group()
    denv = distributed.detect_env()
    if group is None and denv is not None:
        raise RuntimeError(
            f"the environment declares a multi-process group "
            f"(PSTPU_NUM_PROCESSES={denv.num_processes}) this process has not "
            "formed: call parallel.distributed.maybe_initialize() before "
            "building the engine"
        )
    return group


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


def _pow2_bucket(n: int, floor: int) -> int:
    """The window's shape bucketing for its stop-id and occurrence arrays:
    O(log) shapes, not one per length."""
    b = floor
    while b < n:
        b *= 2
    return b


def _param_count(tree) -> int:
    """Parameters in a tree (or in the tp positions' trees, a replicated
    tensor counted once), without the engine's fp32 lm_head copy."""
    seen: Dict[int, int] = {}

    def walk(node):
        if isinstance(node, dict):
            for k, v in node.items():
                if k != llama.LM_HEAD_FP32:
                    walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        else:
            seen[id(node)] = node.numel()

    walk(tree)
    return sum(seen.values())


def _ban_stops(logits: torch.Tensor, stop_mask: torch.Tensor,
               min_left: torch.Tensor) -> torch.Tensor:
    """The host path's -1e9 logit bias on the stop set while a row's
    min_tokens floor is unmet (+0.0 elsewhere is the identity, bit for
    bit)."""
    return logits + (stop_mask & (min_left > 0)[:, None]).float() * -1e9


def _hits_stop(tokens: torch.Tensor, stop_ids: torch.Tensor) -> torch.Tensor:
    """[S] whether each row's token is in its stop set (-1 padded)."""
    return ((tokens[:, None] == stop_ids) & (stop_ids >= 0)).any(dim=1)


def _count_tokens(counts: torch.Tensor, seen: torch.Tensor, tokens: torch.Tensor,
                  keep: torch.Tensor) -> None:
    """The occurrence state the penalties read, in place: each row's token
    counted and seen where ``keep``."""
    idx = tokens[:, None].long()
    counts.scatter_add_(1, idx, keep[:, None].float())
    seen.scatter_(1, idx, torch.gather(seen, 1, idx) | keep[:, None])


def _advance_tables(tables: torch.Tensor, cols: torch.Tensor,
                    vals: torch.Tensor) -> None:
    """Block-table growth in place: ``tables[r, cols[r, j]] = vals[r, j]``
    where ``cols >= 0`` (col -1 = no growth; those write the value column 0
    already holds)."""
    valid = cols >= 0
    safe = torch.where(valid, cols, 0).long()
    keep = torch.gather(tables, 1, safe)
    tables.scatter_(1, safe, torch.where(valid, vals, keep))


class _Commit:
    """A write into the adapter stacks, queued for the commit thread."""

    def __init__(self, fn):
        self.fn = fn
        self.done = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None

    def run(self) -> None:
        try:
            self.result = self.fn()
        except Exception as e:  # handed back to the waiting caller
            self.error = e
        finally:
            self.done.set()


@dataclasses.dataclass
class _PendingStep:
    """One dispatched-but-not-yet-collected engine step.

    Synchronous steps carry their ``outputs``; pipelined decode steps carry
    the batch rows and a pinned host copy of the still-in-flight sample
    (``host``, ready when the ``ready`` event has passed; no event on the
    CPU): [S] for a single-token step, [K, S] emitted tokens for a K-step
    window (``steps`` holds the rows' token budgets and ``win_key`` the
    shape key of the window's static carry, which the next window chains
    from).  A mixed window also carries its chunk schedule, the tail
    logits of its iterations ([k_eff, V] on the device, this step's own
    copy; None when no chunk is final) and the step ordinal of its first
    iteration.  A speculative window (``spec_drafter`` "ngram" or
    "model") reads back [K, W + 2, S]: per iteration the W emitted rows,
    then the drafted and the accepted counts."""

    outputs: Optional[List[StepOutput]] = None
    seqs: Optional[List[Sequence]] = None
    host: Optional[torch.Tensor] = None
    ready: Optional[object] = None  # torch.cuda.Event
    is_decode: bool = False
    host_s: float = 0.0  # host time spent dispatching this step
    steps: Optional[List[int]] = None
    win_key: Optional[tuple] = None
    chunk_sched: Optional[List[PrefillPlan]] = None
    chunk_tails: Optional[torch.Tensor] = None
    chunk_ordinal: int = 0
    spec_drafter: Optional[str] = None
    # The flight record (obs/flight_recorder.WindowRecord) stamped at
    # dispatch, which collect completes; None with tracing off or when the
    # step completed its record at dispatch.
    rec: Optional[object] = None

    def read(self) -> np.ndarray:
        """The sample, waiting for its copy to land (the step's one host
        sync)."""
        if self.ready is not None:
            self.ready.synchronize()
        return self.host.numpy()


class LLMEngine:
    def __init__(self, config: EngineConfig, device=None, params=None,
                 draft_params=None):
        """``device``: where the model runs (default CUDA; raises without
        one): one device, which then holds every position of the mesh, or
        the mesh's device list (``parallel/mesh.build_mesh``; None at tp >
        1: the visible CUDA devices, one a position).  ``params``: a full
        parameter tree (e.g. from ``weights.params_from_numpy``); None
        loads ``weights_path`` or boots the seeded random init.  At tp > 1
        it is cut into one tree per tp position (``shardings.shard_params``).
        ``draft_params``: the same for the draft model of
        ``scheduler.speculative_model``.

        In a multi-process group (``parallel/distributed.py``, formed
        before this) the device is this rank's card (or the CPU the group
        was formed on; ``device`` may name only its type), the mesh spans
        the group's ranks, and the weights this engine loads or draws
        itself are cut to the rank's positions as they are made
        (``shardings.RankSlicer``); a given ``params`` is the full tree."""
        cfg, par = config.model, config.parallel
        group = _group_of_process()
        # The JAX engine's order: tp and sp-mode validation, then the
        # dp/sp gates, then the mesh; the settings of a multi-process
        # group that the port does not serve are refused before the gates.
        shardings.validate_tp(cfg, par.tensor_parallel)
        shardings.validate_sp_mode(cfg, par)
        bad = _unsupported(config, group)
        if bad:
            raise NotImplementedError(
                "the PyTorch engine does not serve these settings yet: "
                + ", ".join(bad)
            )
        _check_mesh_gates(config)
        if group is not None and config.cache.remote_prefetch is None:
            # As the JAX server in a group: the asynchronous transfer plane
            # (fetcher threads, the off-step offload stager) goes off
            # unless asked for, so every transfer outcome is decided on the
            # step thread, where the group agrees on it.  An explicit True
            # runs it, its jobs' states agreed once a step.
            config.cache.remote_prefetch = False
        self.config = config
        world = int(np.prod(par.mesh_shape))
        if group is not None:
            if device is not None and torch.device(device).type != group.device.type:
                raise ValueError(f"device {device!r}: this process's group runs "
                                 f"on {group.device}")
            devices = None
        elif isinstance(device, (list, tuple)):
            devices = [resolve_device(d) for d in device]
        elif device is None and world > 1:
            devices = None
        else:
            devices = [resolve_device(device)] * world
        self.mesh = build_mesh(par, devices, group)
        self.group = group
        self.tp = par.tensor_parallel
        # This process's tp positions (all of them outside a group).
        self.tp_local = len(self.mesh.local_tp())
        self.device = self.mesh.tp_devices()[self.mesh.local_tp()[0]]
        # Observability hub: request tracer + step-phase/latency histograms
        # + window flight recorder + compile-event tracker (all hooks no-op
        # when config.obs.tracing is off).
        self.obs = EngineObs(
            enabled=config.obs.tracing,
            ring_size=config.obs.trace_ring_size,
            ring_bytes=config.obs.trace_ring_bytes,
            window_ring_size=config.obs.window_ring_size,
        )
        self.tokenizer = get_tokenizer(config.tokenizer)
        if self.tokenizer.vocab_size > cfg.vocab_size:
            raise ValueError(
                f"Tokenizer vocab ({self.tokenizer.vocab_size}) exceeds model "
                f"vocab ({cfg.vocab_size})"
            )
        logger.info("Loading params for %s on %s ...", cfg.name, self.device)
        loaded = params is None
        # A rank of a group never holds the full tree: each weight is cut
        # to its positions as it is made (quantized whole first).
        sliced = loaded and group is not None and self.tp > 1
        if loaded:
            params = load_params(cfg, config.weights_path, seed=config.seed,
                                 device=self.device,
                                 place=self._rank_slicer(cfg) if sliced else None)
        if cfg.quantization is not None and not sliced:
            # As the JAX engine: the loaded (or given) tree, then its
            # projections to int8.  A tree loaded here is quantized in
            # place, weight by weight, each full-precision weight freed
            # once its pair is written (the peak: the model, its int8
            # pairs and one weight's fp32 temporaries, before the pool is
            # sized); a caller's tree is left as it was.
            logger.info("Quantizing projections to %s ...", cfg.quantization)
            params = llama.quantize_params(params, cfg, in_place=loaded)
        if self.tp > 1:
            # As the JAX engine places the tree by param_shardings.
            params = shardings.shard_params(params, cfg, self.mesh, consume=loaded)
        self.params = params
        self._load_draft_model(draft_params)
        llama.add_fp32_lm_head(self.params, cfg)
        # Multi-LoRA slot stacks (engine/lora.py), before the pool is sized
        # from what is left; None keeps the model's LoRA-free code path.
        self.lora_registry = None
        if config.lora.enabled:
            self.lora_registry = AdapterRegistry(
                cfg, config.lora, llama.param_dtype(cfg), self.device
            )
        # Stack writes queued for the bound commit thread (run_commits).
        self._commit_lock = threading.Lock()
        self._commit_thread: Optional[threading.Thread] = None
        self._commit_wake = None
        self._commits: List[_Commit] = []

        num_blocks = self._decide_num_blocks()
        self.block_pool = BlockPool(
            num_blocks,
            config.cache.block_size,
            enable_prefix_caching=config.cache.enable_prefix_caching,
        )
        # Cross-engine prefix sharing (cache.disagg_role): content-keyed
        # block export/import through the remote store.
        self._disagg_role = config.cache.disagg_role
        self._exports = self._disagg_role in ("prefill", "both")
        self._imports = self._disagg_role in ("decode", "both")
        # digest -> export expiry: entries re-export after the TTL so a
        # store-side eviction doesn't silently end sharing.
        self._exported_hashes: "OrderedDict[bytes, float]" = OrderedDict()
        self._export_ttl_s = 300.0
        self._export_queue: Optional[queue.Queue] = None
        self._export_thread: Optional[threading.Thread] = None
        # Guards the export thread/queue handles: lazily started from the
        # step thread, retired from the close path.
        self._export_lock = threading.Lock()
        self.remote_prefix_blocks_fetched = 0
        self.remote_prefix_blocks_exported = 0
        # Bytes of the prefix blocks this engine (this rank, in a group)
        # read from the store, the blocks its group dropped included.
        self.remote_prefix_bytes_read = 0
        # Disaggregated serving counters, written only by the API server's
        # event loop: prefill-phase primes served, and decode-phase handoff
        # prefetch outcomes.
        self.disagg_prefill_primes = 0
        self.disagg_handoff_hits = 0
        self.disagg_handoff_misses = 0
        # In a group with the asynchronous plane: the agreements over its
        # jobs' states (steps that ran one) and their host seconds; the
        # handoff chains the leader's server threads queue for the step
        # loop to publish, each with the ticket its waiter blocks on.
        self.transfer_agreements = 0
        self.transfer_agreement_s = 0.0
        self._handoff_lock = threading.Lock()
        self._handoffs: List[tuple] = []
        self.scheduler = Scheduler(
            config.scheduler,
            self.block_pool,
            offload_cb=self.offload_seq_blocks,
            restore_cb=self.restore_seq_blocks,
            remote_prefix_cb=self.fetch_remote_prefix if self._imports else None,
        )
        self.kv_caches = self._allocate_kv(num_blocks)
        logger.info(
            "KV pool: %d blocks x %d tokens (%.2f GiB on this device)",
            num_blocks, config.cache.block_size,
            self._kv_bytes(num_blocks) * self.tp_local / self.tp / 2**30,
        )
        self._init_kv_tiers()
        self._init_draft_pool()

        self._bmax = config.scheduler.max_model_len // config.cache.block_size
        self._smax = config.scheduler.max_num_seqs
        self._step_counter = 0
        self._bias_cache = None
        # Guided decoding: token id -> text, and [V] "may be valid" (the id
        # has text, or is EOS), built at the first guided scan.
        self._token_texts = TokenTextCache(self.tokenizer)
        self._guided_live: Optional[np.ndarray] = None
        # Cumulative counters for stats().  admission_rejected is written
        # by the server's event loop, the rest by the step thread.
        self.total_prompt_tokens = 0
        self.total_generated_tokens = 0
        self.total_finished = 0
        # Prompt tokens prefilled inside mixed steps (nonzero: prompts
        # chunk alongside live decodes instead of stalling them).
        self.prefill_chunk_tokens = 0
        # The part of those that rode mixed K-step windows.
        self.mixed_window_chunk_tokens = 0
        # Distinct prompts whose chunks rode each mixed K-step window
        # (tpu:mixed_window_prompts_per_window).
        self.mixed_window_prompts_hist = Histogram(
            bounds=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0)
        )
        # Host seconds spent staging a chained mixed window's chunk arrays
        # while the previous window still ran on the device.
        self.window_transfer_overlap_s = 0.0
        # Requests shed on an expired client deadline: deadline_expired by
        # the step thread (queued-expiry sweep), deadline_expired_admission
        # by the server's event loop (admission sheds), one writer each;
        # stats() reports the sum.
        self.deadline_expired = 0
        self.deadline_expired_admission = 0
        self.admission_rejected = 0
        self.num_steps = 0
        self._step_time_accum = 0.0
        # (end time, busy seconds) of the steps collected in the trailing
        # _busy_window_s: duty_cycle is their busy fraction.
        self._busy_window: List[tuple] = []
        self._busy_window_s = 10.0

        # -- K-step windows and the one-step lookahead pipeline ------------
        self._window_steps = config.scheduler.window_steps
        self._pipeline_enabled = config.scheduler.pipeline_enabled
        # Chained-window block-table delta width: a window grows a row by
        # at most window_max_tokens tokens.
        self._win_delta_cols = (
            config.scheduler.window_max_tokens // config.cache.block_size + 2
        )
        self._pending: Deque[_PendingStep] = deque()
        # Static device buffers per graph key (the carry and the inputs a
        # captured body reads), made on first use and kept.
        self._buffers: Dict[tuple, Dict[str, torch.Tensor]] = {}
        self.graphs = GraphRunner(self.device)
        if self.obs.enabled:
            # Each graph key's first use is a compile event; kernel
            # libraries first loaded after this boot are too.
            self.graphs.track_first_use(self.obs.compile_tracker.first_use_hook())
            self._csrc_loads_seen = len(_build.first_loads)
        if self.device.type == "cuda":
            # fp32 products stay fp32 (a MoE router's logits, which pick
            # the experts, and the lm_head's): no TF32, which rounds their
            # operands to 10 bits of mantissa.  PyTorch's default; the
            # switch is process-wide.
            torch.backends.cuda.matmul.allow_tf32 = False
            # Before any capture: a capture must never grow them.
            paged_attention.reserve_split_counters(
                self.device, self._decode_pairs()
            )
            if self.config.model.quantization is not None:
                w8a16.prepare(self.device)
        # Host mirrors of how many block-table columns of each row the
        # device tables hold (window carry / pipelined step).
        self._win_table_lens: List[int] = []
        self._pipe_table_lens: List[int] = []
        self._pipe_key: Optional[tuple] = None
        # Single-step fallbacks of K>1 plans by reason, and emitted window
        # tokens that could not be delivered (abort while the window flew).
        self.multistep_fallback: Dict[str, int] = {}
        self._last_window_decline: Optional[str] = None
        self.multistep_wasted_tokens = 0
        self.windows_dispatched = 0
        self.windows_chained = 0
        self.mixed_windows_dispatched = 0
        self.mixed_windows_chained = 0
        self.mixed_window_iterations = 0
        # decode_host_gap_ms: host time between one decode step retiring
        # and the next decode launch while the device had nothing queued.
        self._gap_total_s = 0.0
        self._gap_steps = 0
        self._last_decode_end: Optional[float] = None
        self._init_speculation()

        # -- the encode lane ------------------------------------------------
        # Counters of the tpu:encode_* families: the batch counter and
        # histograms are written by the step thread only (encode_batch);
        # encode_queue_depth is a gauge the batcher overwrites from either
        # side (a snapshot, never summed).
        self.encode_texts_total = 0
        self.encode_batch_size_hist = Histogram(
            bounds=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0)
        )
        self.encode_seconds_hist = Histogram(
            bounds=(0.005, 0.02, 0.05, 0.1, 0.25, 1.0, 4.0)
        )
        self.encode_queue_depth = 0
        # The serial embed's own stream (the lane off: a worker thread),
        # ordered once after the boot's work on this thread's stream.
        self._embed_stream = None
        # Adapter uploads' own stream (a loader's thread stages on it).
        self._lora_stream = None
        if self.device.type == "cuda":
            if group is None:
                # In a group every rank embeds on its step thread's stream:
                # a forward's collectives on a second stream could order
                # differently on each rank against the step's.
                self._embed_stream = torch.cuda.Stream(self.device)
                self._embed_stream.wait_stream(torch.cuda.current_stream(self.device))
            if self.lora_registry is not None:
                self._lora_stream = torch.cuda.Stream(self.device)
                self._lora_stream.wait_stream(torch.cuda.current_stream(self.device))

    # -- speculative decoding: the drafters' state ------------------------

    # Backward-scan bound of the legacy path's host drafter.
    _DRAFT_SCAN_WINDOW = 1024
    # The fused drafters' carried history [S, H] (a static shape: the
    # graph keys never depend on context length).
    _SPEC_HIST_WINDOW = 128
    # Model drafter: windows that chain off one causal prime of the draft
    # cache before the next; it also sizes the draft pool's rows.
    _DRAFT_PRIME_CHAIN = 8

    def _load_draft_model(self, draft_params) -> None:
        """The draft model of ``scheduler.speculative_model``, checked at
        boot as the JAX engine checks it (a known preset sharing the
        target's vocab); its parameters are loaded only when the fused
        window will run."""
        cfg, sched = self.config.model, self.config.scheduler
        self.draft_cfg = None
        self.draft_params = None
        name = sched.speculative_model
        if name is None:
            return
        if name not in PRESETS:
            raise ValueError(
                f"Unknown speculative_model preset {name!r}; "
                f"available: {sorted(PRESETS)}"
            )
        draft_cfg = dataclasses.replace(PRESETS[name])
        if draft_cfg.vocab_size != cfg.vocab_size:
            raise ValueError(
                f"speculative_model {name!r} vocab ({draft_cfg.vocab_size}) "
                f"!= target {cfg.name!r} vocab ({cfg.vocab_size}): the "
                "drafter must share the target's tokenizer/vocab; refusing "
                "to boot"
            )
        shardings.validate_tp(draft_cfg, self.tp)
        self.draft_cfg = draft_cfg
        if not sched.spec_window_enabled:
            return
        logger.info("Loading draft params for %s on %s ...", name, self.device)
        loaded = draft_params is None
        if loaded:
            place = (self._rank_slicer(draft_cfg)
                     if self.group is not None and self.tp > 1 else None)
            draft_params = load_params(draft_cfg, self.config.draft_weights_path,
                                       seed=self.config.seed, device=self.device,
                                       place=place)
        if self.tp > 1:
            # Sharded on the target's mesh.
            draft_params = shardings.shard_params(draft_params, draft_cfg, self.mesh,
                                                  consume=loaded)
        self.draft_params = draft_params
        llama.add_fp32_lm_head(self.draft_params, draft_cfg)

    def _rank_slicer(self, cfg) -> shardings.RankSlicer:
        """The cut of each weight to this rank's positions as it is made."""
        return shardings.RankSlicer(
            cfg, self.mesh,
            quantize=llama.quantize_weight if cfg.quantization is not None else None,
        )

    def _init_draft_pool(self) -> None:
        """The draft model's own dense KV pool and ``BlockPool``: each row
        holds a causal prime of the history window plus
        ``_DRAFT_PRIME_CHAIN`` windows of max-acceptance growth; the
        default size fits every decode row at once (+ null block 0).  An
        undersized explicit pool declines windows to plain ones."""
        self.draft_block_pool = None
        self.draft_kv_caches = None
        self._draft_blocks_per_row = 0
        # Whether the draft cache extends the batch's committed context,
        # windows chained since the last prime, this batch's draft blocks,
        # and whether the last build could allocate them.
        self._draft_primed = False
        self._draft_windows_since_prime = 0
        self._draft_block_alloc: List[int] = []
        self._draft_tables_ok = False
        if self.draft_params is None:
            return
        sched = self.config.scheduler
        bs = self.config.cache.block_size
        cap = self._SPEC_HIST_WINDOW + self._DRAFT_PRIME_CHAIN * sched.window_max_tokens
        self._draft_blocks_per_row = -(-cap // bs)
        pool_blocks = sched.speculative_draft_pool_blocks
        if pool_blocks is None:
            pool_blocks = sched.max_num_seqs * self._draft_blocks_per_row + 1
        self.draft_block_pool = BlockPool(pool_blocks, bs, enable_prefix_caching=False)
        shape = self._pool_shape(pool_blocks, self.draft_cfg)
        dtype = llama.param_dtype(self.draft_cfg)
        self.draft_kv_caches = [
            (torch.zeros(shape, dtype=dtype, device=self.device),
             torch.zeros(shape, dtype=dtype, device=self.device))
            for _ in range(self.draft_cfg.num_layers)
        ]
        logger.info("Draft KV pool: %d blocks x %d tokens (%d blocks/row)",
                    pool_blocks, bs, self._draft_blocks_per_row)

    def _init_speculation(self) -> None:
        """Which speculation runs and its counters (the JAX engine's):
        the fused drafter inside K-step windows, and the legacy host path
        (``speculative_ngram`` on every greedy K=1 decode pass: all of
        them with windows off, single steps between windows with them on)."""
        sched = self.config.scheduler
        self._spec_window = sched.spec_window_enabled and self._window_steps > 1
        self._spec_len = sched.spec_draft_len
        self._legacy_spec = sched.speculative_ngram
        self.spec_tokens_drafted = 0
        self.spec_tokens_accepted = 0
        # Draft tokens accepted / rejected inside fused windows, and fused
        # window tokens undeliverable at collect.
        self.spec_window_tokens: Dict[str, int] = {
            "accepted": 0, "rejected": 0, "wasted": 0,
        }
        # Collect-wait seconds attributed to the model drafter's forwards
        # by a static split: per iteration D+1 draft rows (plus the
        # amortized prime) through the draft parameters beside D+1 verify
        # rows through the target's.
        self.spec_draft_fraction_s = 0.0
        self._draft_cost_fraction = 0.0
        if self.draft_params is not None:
            tgt_n, dft_n = _param_count(self.params), _param_count(self.draft_params)
            draft_rows = (self._spec_len + 1) + (self._SPEC_HIST_WINDOW - 1) / (
                self._DRAFT_PRIME_CHAIN * self._window_steps
            )
            self._draft_cost_fraction = (draft_rows * dft_n) / (
                draft_rows * dft_n + (self._spec_len + 1) * tgt_n
            )

    def _decode_pairs(self) -> int:
        """The most (row, KV head) pairs one decode call of this
        configuration makes: a decode batch, a verify of S x W rows (fused
        or legacy), a draft step, the draft model's prime of S x (H - 1)
        rows.  The split-KV arrival counters are reserved for it at boot.
        Under tp a position's call makes 1/tp of the pairs, and the
        positions' calls run one after another on one stream, each leaving
        the counters zero, so they share them."""
        sched, S = self.config.scheduler, self._smax
        kv = self.config.model.num_kv_heads
        pairs = [S * kv * (sched.spec_draft_len + 1)]
        if self.draft_cfg is not None:
            pairs.append(S * (self._SPEC_HIST_WINDOW - 1) * self.draft_cfg.num_kv_heads)
        return max(pairs)

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
        over all layers, in a group the least over its ranks' cards; 512
        blocks on the CPU, as the JAX engine keeps."""
        cache = self.config.cache
        if cache.num_blocks is not None:
            return cache.num_blocks
        if self.device.type != "cuda":
            return 512
        # mem_get_info does not see the blocks the caching allocator keeps
        # (the bf16 weights that quantization or loading freed, say).
        torch.cuda.empty_cache()
        free, _total = torch.cuda.mem_get_info(self.device)
        # A device holds 1/tp of a block for each tp position it hosts (the
        # JAX engine's divide by tp, one position a device): every
        # position this process runs shares this one, and in a group the
        # other ranks' positions sit on their own cards (which may carry
        # the same name, so the mesh's owners count, not the devices).
        per_block = self._kv_bytes(1) * self.tp_local // self.tp
        num_blocks = max(int(free * cache.hbm_utilization // per_block), 16)
        # The ranks of a group step the same plans, so they share one pool
        # size: the least that any rank's card holds.
        return num_blocks if self.group is None else distributed.agree_min(num_blocks)

    def _pool_shape(self, num_blocks: int, cfg) -> tuple:
        """A pool side's data shape: [N, bs, K, D], or at tp > 1 one [N,
        bs, K/tp, D] pool a position this process runs, stacked on a
        leading axis (``kv/quant.shard_side``)."""
        shape = (num_blocks, self.config.cache.block_size,
                 cfg.num_kv_heads // self.tp, cfg.head_dim)
        return shape if self.tp == 1 else (self.tp_local, *shape)

    def _allocate_kv(self, num_blocks: int):
        cfg = self.config.model
        shape = self._pool_shape(num_blocks, cfg)
        if self.config.cache.kv_cache_dtype == "int8":
            # (data int8, scale fp32 [N, bs, K]) per side — kv/quant.py.
            def side():
                return (torch.zeros(shape, dtype=torch.int8, device=self.device),
                        torch.zeros(shape[:-1], dtype=torch.float32,
                                    device=self.device))
        else:
            def side():
                return torch.zeros(shape, dtype=llama.param_dtype(cfg),
                                   device=self.device)
        return [(side(), side()) for _ in range(cfg.num_layers)]

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> tensor on the engine's device, without a host
        sync on the card: a non-blocking copy from pinned memory (the
        caching host allocator keeps the pinned block until the copy has
        run)."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _upload(self, bufs: Dict[str, torch.Tensor],
                arrays: Dict[str, np.ndarray]) -> None:
        """Host arrays into the static buffers of the same names with one
        transfer: every array packed as int32 (fp32 bitcast), then each
        slice copied, and cast, into its buffer on the device."""
        flat = [a.view(np.int32) if a.dtype == np.float32 else a.astype(np.int32)
                for a in arrays.values()]
        stage = self._put(np.concatenate([a.ravel() for a in flat]))
        at = 0
        for (name, a), f in zip(arrays.items(), flat):
            part = stage[at:at + f.size].view(f.shape)
            bufs[name].copy_(part.view(torch.float32) if a.dtype == np.float32 else part)
            at += f.size

    # -- the encode lane ---------------------------------------------------

    def encode_max_len(self) -> int:
        """Longest input (tokens) the embedding path accepts: the bound both
        ``embed`` and ``encode_batch`` check, for the API layer to reject
        over-long inputs before queueing."""
        return min(
            self.config.scheduler.prefill_buckets[-1],
            self.config.scheduler.max_model_len,
        )

    def check_encode_input(self, ids: List[int]) -> None:
        """Raise ValueError on an input the embedding path refuses: empty,
        or longer than ``encode_max_len``."""
        if not ids:
            # An embedding of the pad token would be silent garbage.
            raise ValueError("input produced no tokens")
        max_len = self.encode_max_len()
        if len(ids) > max_len:
            # Silent truncation would embed a prefix while reporting the
            # full token count.
            raise ValueError(
                f"input is {len(ids)} tokens; the embedding path supports "
                f"up to {max_len}"
            )

    def _encode_rows(self, batch_token_ids: List[List[int]], B: int,
                     T: int) -> np.ndarray:
        """The texts as a [B, T] batch (token rows zero-padded, padding
        rows of length 0) through ``llama.encode_batch``: the rows and
        lengths go up in one non-blocking copy, and the texts' vectors
        [len(batch_token_ids), hidden] come back in one copy."""
        n = len(batch_token_ids)
        host = np.zeros(B * T + B, np.int32)
        for i, ids in enumerate(batch_token_ids):
            host[i * T:i * T + len(ids)] = ids
            host[B * T + i] = len(ids)
        stage = self._put(host)
        out = llama.encode_batch(self.params, self.config.model,
                                 stage[:B * T].view(B, T), stage[B * T:])
        return out[:n].cpu().numpy()

    def embed(self, prompt_token_ids: List[int]) -> np.ndarray:
        """Normalized mean-pooled embedding [hidden] (fp32) of one prompt,
        padded to the nearest prefill bucket (the serial path: the encode
        lane off).  On the card it runs on the engine's embed stream, never
        on the legacy default stream, so a caller's thread can run it while
        the step thread replays or captures a window graph; the copy back
        waits for that stream only.  In a multi-process group every rank
        calls it on its step thread, between steps, in the same order (the
        leader's event batch carries the texts), and it runs on the step
        thread's stream: the forward's reductions over the tp subgroup pair
        up across the ranks as the steps' do.  At sp > 1 every rank runs the
        whole text, as the JAX ``embed`` runs full attention on an sp mesh."""
        self.check_encode_input(prompt_token_ids)
        T = next(b for b in self.config.scheduler.prefill_buckets
                 if b >= len(prompt_token_ids))
        if self._embed_stream is None:
            return self._encode_rows([prompt_token_ids], 1, T)[0]
        with torch.cuda.stream(self._embed_stream):
            return self._encode_rows([prompt_token_ids], 1, T)[0]

    def encode_batch(self, batch_token_ids: List[List[int]]) -> np.ndarray:
        """Batched embeddings: one [B, T]-bucketed ``llama.encode_batch``
        forward for up to ``encode_batch_buckets[-1]`` texts (B pads to an
        encode-batch bucket, T to a prefill bucket).  Vectors equal
        per-text ``embed`` output up to the order of float sums.  The
        step thread is its one caller in serving (the EncodeBatcher): it
        queues on the stream the windows run on, behind a window in
        flight, and its copy back waits for both."""
        if not batch_token_ids:
            raise ValueError("encode_batch needs at least one input")
        sched = self.config.scheduler
        if len(batch_token_ids) > sched.encode_batch_buckets[-1]:
            raise ValueError(
                f"encode_batch of {len(batch_token_ids)} texts exceeds the "
                f"largest encode batch bucket "
                f"({sched.encode_batch_buckets[-1]})"
            )
        for ids in batch_token_ids:
            self.check_encode_input(ids)
        B = next(b for b in sched.encode_batch_buckets if b >= len(batch_token_ids))
        T = next(b for b in sched.prefill_buckets
                 if b >= max(len(ids) for ids in batch_token_ids))
        t0 = time.time()
        vectors = self._encode_rows(batch_token_ids, B, T)
        # One batch an observation; the seconds include the copy back.
        self.encode_texts_total += len(batch_token_ids)
        self.encode_batch_size_hist.observe(float(len(batch_token_ids)))
        self.encode_seconds_hist.observe(time.time() - t0)
        return vectors

    # -- multi-LoRA admin (engine/lora.py) ---------------------------------

    def _require_lora(self) -> AdapterRegistry:
        if self.lora_registry is None:
            raise ValueError("engine started with max_loras=0")
        return self.lora_registry

    def load_lora(self, name: str, layer_factors, rank: int,
                  alpha: float = 16.0) -> int:
        """Install adapter ``name`` (per-layer {proj: (A [in, r], B [r,
        out])}); returns its slot.  The factors are validated and staged on
        the calling thread (on the engine's LoRA stream on the card), then
        committed into the slot by the commit thread; this returns once the
        commit is enqueued, so a request admitted afterwards runs the
        adapter and a window already in flight finishes on the old values."""
        registry = self._require_lora()
        staged = registry.stage(layer_factors, rank, stream=self._lora_stream)
        return self._on_commit_thread(lambda: registry.commit(name, staged, alpha))

    def load_lora_from_path(self, name: str, path: str,
                            alpha: float = 16.0) -> int:
        factors, rank = load_peft_safetensors(path, self.config.model.num_layers)
        return self.load_lora(name, factors, rank, alpha)

    def unload_lora(self, name: str) -> None:
        """Free ``name``'s slot (its B factors and scale zeroed on the
        commit thread); rows still running on it carry on as the base
        model, as in the JAX engine."""
        registry = self._require_lora()
        self._on_commit_thread(lambda: registry.unload(name))

    def loaded_adapters(self) -> List[str]:
        return [] if self.lora_registry is None else self.lora_registry.loaded()

    def bind_commit_thread(self, wake) -> None:
        """Make the calling thread (the serving step loop) the one that
        writes the adapter stacks, at :meth:`run_commits`; ``wake()``
        rouses it when a write is queued."""
        with self._commit_lock:
            self._commit_thread = threading.current_thread()
            self._commit_wake = wake

    def release_commit_thread(self) -> None:
        """The bound thread's exit: writes still queued run here, later
        ones on their callers' threads."""
        with self._commit_lock:
            self._commit_thread = None
        self.run_commits()

    def run_commits(self) -> None:
        """The step loop's drain point, between dispatches: run the queued
        adapter writes on the calling thread's stream, the one the steps
        run on (in order behind the steps already enqueued)."""
        with self._commit_lock:
            commits, self._commits = self._commits, []
        for commit in commits:
            commit.run()

    def _on_commit_thread(self, fn):
        """``fn()`` on the commit thread (queued, then waited for), or here
        when no thread is bound or this is it; its result or its error."""
        with self._commit_lock:
            owner = self._commit_thread
            commit = None
            if owner is not None and owner is not threading.current_thread():
                commit = _Commit(fn)
                self._commits.append(commit)
        if commit is None:
            return fn()
        self._commit_wake()
        commit.done.wait()
        if commit.error is not None:
            raise commit.error
        return commit.result

    def _lora_kwargs(self, adapter_idx) -> dict:
        """A forward's LoRA arguments: the slot stacks and the rows' slots
        (a device tensor, or a host int32 array uploaded here); none
        without LoRA."""
        if self.lora_registry is None:
            return {}
        if isinstance(adapter_idx, np.ndarray):
            adapter_idx = self._put(adapter_idx)
        return {"lora": self.lora_registry.params, "adapter_idx": adapter_idx}

    @staticmethod
    def _adapter_rows(seqs: List[Sequence], S: int, width: int = 1) -> np.ndarray:
        """[S * width] int32: each sequence's slot repeated ``width`` times
        (a speculative chain's verify rows), padding rows on slot 0."""
        rows = np.zeros((S * width,), np.int32)
        for i, seq in enumerate(seqs):
            rows[i * width:(i + 1) * width] = seq.adapter_idx
        return rows

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
        guide = None
        rf = params_obj.response_format
        if rf == "json_object":
            guide = JsonGuide(require_object=True)
            # Completion forces EOS; ignore_eos would append EOS text
            # forever.  Enforced here (not only at the API boundary) so
            # direct engine users get the same behaviour.
            params_obj.ignore_eos = False
        elif isinstance(rf, dict) and rf.get("type") == "json_schema":
            # Raises SchemaCompileError (a ValueError) for schemas outside
            # the supported subset: a 400 at the API boundary.
            guide = SchemaGuide(rf.get("schema") or {})
            params_obj.ignore_eos = False
        elif rf not in (None, "text"):
            raise ValueError(f"Unsupported response_format {rf!r}")
        adapter_idx = 0
        cache_ns = 0
        if adapter:
            if self.lora_registry is None:
                raise ValueError(
                    "LoRA adapter requested but the engine was started with "
                    "max_loras=0"
                )
            adapter_idx = self.lora_registry.slot_of(adapter)  # raises if unknown
            cache_ns = self.lora_registry.namespace_of(adapter)
        seq = Sequence(
            seq_id=request_id,
            prompt_token_ids=list(prompt_token_ids),
            sampling_params=params_obj,
            adapter=adapter,
            adapter_idx=adapter_idx,
            cache_ns=cache_ns,
            echo_prompt_len=len(prompt_token_ids),
            guide=guide,
        )
        self.scheduler.add_seq(seq)
        self.total_prompt_tokens += len(prompt_token_ids)
        # Admission-time prefetch: resolve the prefix-cache miss tail
        # against the remote store now, off the step thread, so by the time
        # the scheduler considers this prompt its blocks are (often) staged.
        if self.kv_prefetch is not None and self._imports:
            self._submit_prefix_prefetch(seq)

    def abort_request(self, request_id: str) -> None:
        seq = self.scheduler.abort_seq(request_id)
        if seq is not None:
            seq.status = SequenceStatus.FINISHED
            seq.finish_reason = FinishReason.ABORT
        self._release_transfers(request_id)
        self.obs.on_abort(request_id)

    def _release_transfers(self, request_id: str) -> None:
        """Abort/finish hook of the transfer plane: cancel the request's
        prefetches, tombstone a snapshot still staging (before the discard,
        so it is never inserted or PUT after the DEL), drop its snapshot
        from every tier."""
        if self.kv_prefetch is not None:
            self.kv_prefetch.cancel(request_id)
        if self._offload_stager is not None:
            self._offload_stager.discard(request_id)
        self.offload.discard(request_id)

    def has_unfinished(self) -> bool:
        return self.scheduler.has_unfinished()

    def scan_expired_deadlines(self, now: float) -> List[str]:
        """Ids of waiting or preempted sequences whose client deadline has
        passed at ``now``.  A pure scan: the step loop aborts them.
        Running sequences are exempt: they are streaming tokens, and
        cutting them is the client's call."""
        expired = []
        for queue in (self.scheduler.waiting, self.scheduler.preempted):
            for seq in queue:
                d = seq.sampling_params.deadline
                if d is not None and now > d:
                    expired.append(seq.seq_id)
        return expired

    # -- KV tiers: host offload, the remote store, prefix export/import ----

    def _init_kv_tiers(self) -> None:
        """The transfer plane (the JAX engine's constructor wiring): the
        host-DRAM tier, the remote store's client, the wire accounting,
        the admission-time prefetcher and the off-step offload stager."""
        config = self.config
        offload_bytes = int(config.cache.host_offload_gb * 2**30)
        # Wire representation for offload/remote snapshots
        # (cache.kv_wire_format): with an int8 cache the tiers carry the
        # native (data, scale) tuples end to end.
        self._wire_quantized = config.cache.wire_quantized
        self.kv_wire_stats = KVWireStats()
        remote_client = None
        if config.cache.remote_kv_url:
            remote_client = RemoteKVClient(
                config.cache.remote_kv_url, wire_stats=self.kv_wire_stats,
                require_v2=config.cache.kv_wire_format == "int8",
            )
        self.offload = HostOffloadManager(
            offload_bytes, remote_client,
            quantized_wire=self._wire_quantized,
            wire_stats=self.kv_wire_stats,
            pinned=self.device.type == "cuda",
            # In a group each rank's snapshot holds its own heads: its
            # remote copy is keyed by the rank, so no rank reads another's.
            remote_key_suffix="" if self.group is None else f"@rank{self.group.rank}",
        )
        # The asynchronous transfer plane (cache.remote_prefetch):
        # admission-time remote-prefix prefetch on fetcher threads, async
        # restore page-in.  It delivers through the prefix cache, so a
        # config without caching keeps the synchronous extension.
        self.kv_prefetch: Optional[PrefetchManager] = None
        self._offload_stager: Optional[OffloadStager] = None
        if (
            remote_client is not None
            and config.cache.remote_prefetch_enabled
            and config.cache.enable_prefix_caching
        ):
            self.kv_prefetch = PrefetchManager(
                remote_client,
                restore_sink=self.offload,
                num_threads=config.cache.prefetch_threads,
                observe_fetch=lambda s: self.obs.kv_phase("remote_kv_fetch", s),
                grouped=self.group is not None,
            )
        # The stager covers host-DRAM-only offload too: the D2H wait is a
        # step-thread stall either way.  Only an explicit
        # remote_prefetch=False keeps the blocking save.
        if offload_bytes > 0 and config.cache.remote_prefetch is not False:
            self._offload_stager = OffloadStager(
                self.offload,
                observe_stage=lambda s: self.obs.kv_phase("offload_stage", s),
                grouped=self.group is not None,
            )
        # Completed prefetches awaiting import into the prefix cache (kept
        # across steps under transient pool pressure).
        self._pending_prefetch_imports: List[PrefetchedChain] = []
        if remote_client is not None or self.group is not None:
            # The content-key prefix reads a weight row back from the
            # device (in a group, process 0's, broadcast): once, here, on
            # every rank alike, not in a dispatch.
            self._px_key_prefix()

    # -- offload preemption (scheduler offload_cb) -------------------------

    def offload_seq_blocks(self, seq: Sequence, block_ids: List[int]) -> bool:
        """Scheduler offload_cb.  Async plane: enqueue the device gather of
        the sequence's blocks (a fresh buffer, so the pool may reuse the
        blocks at once: later writes to them are enqueued after it) and its
        copy into a region of the host tier's page-locked arena (reserved
        here, evicting older snapshots: bookkeeping only), record the event
        that marks it landed, and hand both to the stager's writer thread,
        which waits on the event and inserts the snapshot (and PUTs it to
        the remote tier).  The step thread never waits.  A snapshot the
        tier cannot hold returns False: the sequence recomputes.  Legacy mode
        (no stager, ``remote_prefetch=False``) saves synchronously: the
        copies are waited for on the step thread, its documented A/B
        baseline contract.  In a group the slot is the group's (taken while
        any rank's writer holds a snapshot, as last agreed), and the
        stage's reservations are agreed: when any rank fails, the others
        release theirs and every rank recomputes."""
        if self._offload_stager is None or self.offload.capacity_bytes <= 0:
            t0 = time.time()
            saved = self.offload.save(
                seq.seq_id, self.kv_caches, block_ids, num_tokens=seq.num_tokens
            )
            if self.group is not None and not distributed.agree_min(int(saved)):
                # A rank whose tier could not hold its heads recomputes, so
                # every rank does: the plans must not part.
                if saved:
                    self.offload.discard(seq.seq_id)
                saved = False
            if saved and self.obs.enabled:
                # Preemption paging on the request's timeline: the span
                # names why this request's decode stalled.
                self.obs.tracer.add_span(
                    seq.seq_id, "engine.kv_offload", t0, time.time(),
                    blocks=len(block_ids),
                )
            return saved
        stager = self._offload_stager
        if not block_ids:
            return False
        if self.group is not None and stager.busy:
            stager.skipped += 1
            return False  # the group's slot is busy: recompute on every rank
        t0 = time.time()
        staged = self._stage_offload(seq.seq_id, block_ids)
        if self.group is not None and not distributed.agree_min(int(staged is not None)):
            if staged is not None:
                stager.release(seq.seq_id)
                self.offload.drop_region(staged[1])
            return False
        if staged is None:
            return False
        host_layers, region, ready = staged
        stager.commit(seq.seq_id, host_layers, seq.num_tokens, region, ready=ready)
        if self.obs.enabled:
            # Step-thread cost only (the gather's dispatch): the D2H wait
            # lives in tpu:offload_stage_seconds, observed by the writer.
            self.obs.tracer.add_span(
                seq.seq_id, "engine.kv_offload", t0, time.time(),
                blocks=len(block_ids), staged=True,
            )
        return True

    def _stage_offload(self, seq_id: str, block_ids: List[int]):
        """The stager's reservation, the gather and its copy into a region
        of the host tier: (host sides, region, ready event), or None, the
        reservation released, when the slot is busy, the tier cannot hold
        the snapshot or the dispatch failed (the sequence recomputes)."""
        if not self._offload_stager.reserve(seq_id):
            return None  # slot busy: recompute fallback (double-buffer)
        reserved = None
        try:
            ids = self._put(np.asarray(block_ids, np.int64))
            # Quantized wire: the gather stays int8 (data, scale) — half
            # the D2H bytes, and restore adopts the tuples untransformed.
            wire = [
                (kv_quant.gather_blocks_wire(k_cache, ids, self._wire_quantized),
                 kv_quant.gather_blocks_wire(v_cache, ids, self._wire_quantized))
                for k_cache, v_cache in self.kv_caches
            ]
            reserved = self.offload.reserve(wire)
            if reserved is None:
                self._offload_stager.release(seq_id)
                return None  # the host tier cannot hold it: recompute
            host_layers, ready = kv_quant.stage_to_host(wire, out=reserved[0])
        except Exception:
            self._offload_stager.release(seq_id)
            if reserved is not None:
                self.offload.drop_region(reserved[1])
            logger.exception("offload gather dispatch failed; recomputing")
            return None
        return host_layers, reserved[1], ready

    # -- restore (scheduler restore_cb) ------------------------------------

    # Sentinel: a remote restore page-in is in flight — schedule again next
    # pass instead of blocking.
    _RESTORE_PENDING = object()

    def restore_seq_blocks(self, seq: Sequence) -> str:
        """Scheduler restore_cb: page an offloaded sequence's KV snapshot
        back into freshly allocated blocks.  Returns "restored" (the
        sequence now holds the blocks as a partial-prefill prefix: its
        suffix prefills over them, no recompute), "gone" (no snapshot:
        recompute), or "retry" (transient pool pressure or a transfer in
        flight: try again next step).  With tracing on, a restore that is
        not a retry is an ``engine.kv_restore`` span of the request."""
        if not self.obs.enabled:
            return self._restore_seq_blocks(seq)
        t0 = time.time()
        result = self._restore_seq_blocks(seq)
        if result != "retry":
            self.obs.tracer.add_span(
                seq.seq_id, "engine.kv_restore", t0, time.time(), result=result,
            )
        return result

    def _restore_seq_blocks(self, seq: Sequence) -> str:
        entry = self._restore_entry(seq.seq_id)
        if entry is self._RESTORE_PENDING:
            return "retry"
        num_tokens = None if entry is None else entry.num_tokens
        if self.group is not None:
            # Each rank holds its own heads' snapshot (its host tier, or
            # the store under its rank's key): the group restores only
            # what every rank found, and any rank's miss makes every rank
            # recompute.
            num_tokens = distributed.agree_min(num_tokens or 0) or None
            if num_tokens is None and entry is not None:
                self.offload.release(entry)
                entry = None
        if entry is None:
            return "gone"  # fall back to recompute via normal prefill
        bs = self.block_pool.block_size
        usable_tokens = min(num_tokens, len(seq.prompt_token_ids) - 1)
        usable_blocks = usable_tokens // bs
        if usable_blocks == 0:
            self.offload.release(entry)
            return "gone"
        if not self.block_pool.can_allocate(usable_blocks):
            # Transient pool pressure must not cost the snapshot.
            self.offload.reinsert(entry)
            return "retry"
        restored = self.block_pool.allocate(usable_blocks)
        ids = self._put(np.asarray(restored, np.int64))
        for (k_cache, v_cache), (k_host, v_host) in zip(self.kv_caches, entry.layers):
            # Dense hosts quantize into int8 pools on the device; native
            # (data, scale) tuples are adopted untransformed.
            kv_quant.set_blocks(
                k_cache, v_cache, ids,
                kv_quant.slice_host_side(k_host, usable_blocks),
                kv_quant.slice_host_side(v_host, usable_blocks),
            )
        # The snapshot's arena bytes are reused once the uploads that read
        # them have run.
        self.offload.release(entry, kv_quant.copies_done(self.device))
        seq.block_table = restored
        seq.num_cached_tokens = usable_blocks * bs
        seq.partial_prefill = True
        return "restored"

    def _restore_entry(self, seq_id: str):
        """Snapshot lookup for restore: local host-DRAM tier first; a
        remote-tier miss starts an async page-in (a prefetch worker lands
        it in the local tier) and returns the pending sentinel, so the
        scheduler re-checks instead of blocking on the RPC.  Legacy mode
        (no prefetcher) keeps the blocking fetch."""
        if (
            self._offload_stager is not None
            and self._offload_stager.is_inflight(seq_id)
        ):
            # The snapshot is still between device and host.
            return self._RESTORE_PENDING
        if self.kv_prefetch is None:
            return self.offload.restore(seq_id)
        if self.group is not None:
            return self._restore_entry_agreed(seq_id)
        entry = self.offload.restore_local(seq_id)
        if entry is not None:
            # Consume a completed page-in job, if one fed this entry.
            self.kv_prefetch.poll_restore(seq_id)
            return entry
        if self.offload.remote_client is None:
            return None
        state = self.kv_prefetch.poll_restore(seq_id)
        if state == "absent":
            self.kv_prefetch.submit_restore(seq_id)
            return self._RESTORE_PENDING
        if state == "inflight":
            return self._RESTORE_PENDING
        if state == "ready":
            return self.offload.restore_local(seq_id)
        return None  # "missing": recompute

    def _restore_entry_agreed(self, seq_id: str):
        """``_restore_entry`` in a group with the prefetcher: the page-in's
        agreed state, else the host tiers if every rank holds the
        snapshot there (agreed), else a page-in from the store started on
        every rank.  ``_restore_seq_blocks`` then agrees on the tokens."""
        state = self.kv_prefetch.poll_restore(seq_id)
        if state == "inflight":
            return self._RESTORE_PENDING
        if state == "ready":
            return self.offload.restore_local(seq_id)
        entry = self.offload.restore_local(seq_id)
        if state == "missing" or not distributed.agree_min(int(entry is not None)):
            if entry is not None:
                # Another rank lacks it: this rank's copy is never used.
                self.offload.release(entry)
            entry = None
        if entry is not None or state == "missing" or self.offload.remote_client is None:
            return entry
        self.kv_prefetch.submit_restore(seq_id)
        return self._RESTORE_PENDING

    # -- cross-engine prefix sharing (cache.disagg_role) -------------------

    def _px_key_prefix(self) -> str:
        """Content-key namespace binding blocks to this model's identity:
        the structural shape and a weight fingerprint (the float32 bytes of
        the embedding's row 0), as the JAX engine hashes them, so engines
        of either package exchange KV exactly when they run the same
        weights.  The first call (at boot, with a store or in a group)
        reads the row from the device."""
        if not hasattr(self, "_px_prefix_cache"):
            import hashlib

            cfg = self.config.model
            h = hashlib.blake2b(digest_size=8)
            h.update(
                f"{cfg.name}|{cfg.num_layers}|{cfg.num_kv_heads}|"
                f"{cfg.head_dim}|{cfg.dtype}|{self.block_pool.block_size}"
                .encode()
            )
            row = None
            if self.group is None or self.group.rank == 0:
                # Row 0 of the full table: tp position 0's first row, which
                # process 0 of a group holds (the others hold other vocab
                # slices), broadcast so every rank keys as one engine does.
                embed = llama.shard_trees(self.params)[0]["embed_tokens"]
                row = embed[0].float().cpu().numpy().tobytes()
            if self.group is not None:
                row = distributed.broadcast_from_leader(row)
            h.update(row)
            self._px_prefix_cache = f"px:{h.hexdigest()}:"
        return self._px_prefix_cache

    def _seq_prefix_hashes(self, seq) -> List[bytes]:
        """Per-sequence memo of the prompt's block hash chain, keyed on the
        prompt length so recompute-preemption (which absorbs generated
        tokens into the prompt) invalidates it."""
        key = len(seq.prompt_token_ids)
        if getattr(seq, "_px_hashes_key", None) != key:
            seq._px_hashes = prefix_block_hashes(
                seq.prompt_token_ids,
                self.block_pool.block_size,
                namespace=seq.cache_ns,
            )
            seq._px_hashes_key = key
        return seq._px_hashes

    def _transfer_inflight(self) -> bool:
        """Any async KV transfer the scheduler may be waiting out (in a
        group, as last agreed)."""
        if self._offload_stager is not None and self._offload_stager.busy:
            return True
        return self.kv_prefetch is not None and self.kv_prefetch.inflight > 0

    def has_live_transfers(self) -> bool:
        """In a group, a job of the asynchronous transfer plane is live, so
        the group keeps stepping (the leader publishing) until its
        agreement retires it; False outside a group."""
        if self.group is None:
            return False
        return bool((self.kv_prefetch is not None and self.kv_prefetch.has_live())
                    or (self._offload_stager is not None and self._offload_stager.busy))

    def _agree_transfers(self) -> None:
        """In a group, while a job of the asynchronous plane is live: one
        all-reduce MIN of every live job's state on this rank (the
        prefetcher's chains and page-ins, the stager's slot, in an order
        every rank shares: the jobs are created and retired at the same
        points on every rank), applied as the group's view that the
        scheduler callbacks read until the next front dispatch."""
        if self.group is None:
            return
        states = []
        if self.kv_prefetch is not None:
            states += self.kv_prefetch.group_states()
        split = len(states)
        if self._offload_stager is not None:
            states += self._offload_stager.group_states()
        if not states:
            return
        t0 = time.perf_counter()
        agreed = distributed.agree_vector([value for _, value in states])
        if split:
            self.kv_prefetch.apply_agreed([key for key, _ in states[:split]], agreed[:split])
        if len(states) > split:
            self._offload_stager.apply_agreed(agreed[split])
        self.transfer_agreements += 1
        self.transfer_agreement_s += time.perf_counter() - t0

    # -- admission-time remote-prefix prefetch -----------------------------

    def _submit_prefix_prefetch(self, seq) -> None:
        """Queue a background fetch of the sequence's local prefix-cache
        miss tail (at admission, and from the scheduler callback after
        recompute-preemption grows the prompt).  Host hashing and a queue
        put: no RPC, no device work."""
        hashes = self._seq_prefix_hashes(seq)
        if not hashes:
            return
        start = self.block_pool.count_cached_prefix(hashes)
        if start >= len(hashes):
            return
        # One fetch per distinct miss tail, memoized only on an accepted
        # submit (a declined one stays retryable).
        memo = (len(hashes), start)
        if getattr(seq, "_px_prefetch_memo", None) == memo:
            return
        key_prefix = self._px_key_prefix()
        if self.kv_prefetch.submit_chain(
            seq.seq_id,
            [key_prefix + d.hex() for d in hashes[start:]],
            hashes[start:],
            start,
        ):
            seq._px_prefetch_memo = memo

    def _drain_prefetched(self) -> None:
        """Step-thread landing point for completed prefetches: import the
        staged host blocks into freshly allocated pool blocks (enqueued
        copies, no wait), bind them to their chain digests in the prefix
        cache and park them in the reclaimable cached-free tier, so the
        next match_prefix serves them like a local hit.  Transient pool
        pressure keeps a chain pending for a bounded number of retries;
        anything undeliverable counts as prefetch waste."""
        if self.kv_prefetch is None:
            return
        self._pending_prefetch_imports.extend(self.kv_prefetch.pop_completed())
        if not self._pending_prefetch_imports:
            return
        keep: List[PrefetchedChain] = []
        for chain in self._pending_prefetch_imports:
            outcome = self._import_prefetch_to_cache(chain)
            if outcome == "retry":
                chain.attempts += 1
                if chain.attempts < 16:
                    keep.append(chain)
                else:
                    self.kv_prefetch.note_waste(len(chain.blocks))
        self._pending_prefetch_imports = keep

    def _import_blocks(self, ids: List[int], blocks: List[list]) -> None:
        """Write fetched blocks (per block, per layer (k, v) one-block wire
        sides) into pool blocks ``ids``, in place, converted to the pool's
        format on the device.  A mixed fleet can interleave dense and int8
        blocks in one chain: each format's blocks go in together, so a
        dense block bound for an int8 pool is quantized by the int8 cache
        writer and an int8 block bound for a dense pool is dequantized on
        the device."""
        runs: Dict[bool, list] = {}
        for block_id, layers in zip(ids, blocks):
            quantized = any(kv_quant.is_quantized(side) for kv in layers for side in kv)
            runs.setdefault(quantized, []).append((block_id, layers))
        for run in runs.values():
            idx = self._put(np.asarray([block_id for block_id, _ in run], np.int64))
            for layer_idx, (k_cache, v_cache) in enumerate(self.kv_caches):
                kv_quant.set_blocks(
                    k_cache, v_cache, idx,
                    kv_quant.stack_wire_blocks([b[layer_idx][0] for _, b in run]),
                    kv_quant.stack_wire_blocks([b[layer_idx][1] for _, b in run]),
                )

    def _rank_blocks(self, blocks: List[list]) -> List[list]:
        """Fetched full-head blocks cut to the heads of this process's tp
        positions: a rank of a group writes only its own heads; in one
        process (every position local) the blocks as they are."""
        local = self.mesh.local_tp()
        if len(local) == self.tp:
            return blocks
        cut = lambda side: kv_quant.head_range(side, local[0], local[-1] + 1, self.tp)  # noqa: E731
        return [[(cut(k), cut(v)) for k, v in layers] for layers in blocks]

    def _import_prefetch_to_cache(self, chain: PrefetchedChain) -> str:
        """Returns "done" (imported / nothing left to do), "retry" (pool
        pressure), or "drop" (malformed entries: degrade)."""
        # A chain is only usable as a prefix: skip leading digests the
        # cache already holds, stop at the first one after those.
        ready = []
        for digest, layers in zip(chain.hashes, chain.blocks):
            if self.block_pool.has_digest(digest):
                if not ready:
                    continue
                break
            ready.append((digest, layers))
        dropped = len(chain.blocks) - len(ready)
        if not ready:
            if dropped:
                self.kv_prefetch.note_waste(dropped)
            return "done"
        if not self.block_pool.can_allocate(len(ready)):
            return "retry"
        ids = self.block_pool.allocate(len(ready))
        try:
            self._import_blocks(ids, self._rank_blocks([b for _, b in ready]))
            copied = True
        except Exception:
            logger.exception("prefetched block import failed; continuing")
            copied = False
        if self.group is not None:
            # A copy-in that failed on any rank is dropped on every rank.
            copied = bool(distributed.agree_min(int(copied)))
        if not copied:
            # Malformed store entry (wrong layer count / block shape): free
            # and degrade; unreferenced cache lines are harmless.
            self.block_pool.free(ids)
            self.kv_prefetch.note_waste(len(chain.blocks))
            return "drop"
        for (digest, _), block in zip(ready, ids):
            self.block_pool.adopt_prefix_block(digest, block)
        self.block_pool.free(ids)
        self.kv_prefetch.note_hit(len(ids))
        if dropped:
            self.kv_prefetch.note_waste(dropped)
        self.remote_prefix_blocks_fetched += len(ids)
        return "done"

    def flush_prefix_imports(self, timeout: float = 10.0) -> None:
        """Block until in-flight prefetches have resolved (tests; drain).
        The cache import itself happens on the step thread at its next
        dispatch."""
        if self.kv_prefetch is not None:
            self.kv_prefetch.wait_idle(timeout)

    def fetch_remote_prefix(self, seq, prefix_blocks, cached_len):
        """Scheduler remote_prefix_cb.  With the async plane it never
        blocks: completed prefetches were imported before schedule() ran,
        and this only makes sure a fetch is in flight for a remaining miss
        tail.  Without it (``remote_prefetch=False``), the synchronous
        per-block GET loop."""
        client = self.offload.remote_client
        if client is None:
            return prefix_blocks, cached_len
        if self.kv_prefetch is not None:
            if not self.kv_prefetch.has_job(seq.seq_id):
                self._submit_prefix_prefetch(seq)
            return prefix_blocks, cached_len
        return self._fetch_remote_prefix_sync(seq, prefix_blocks, cached_len)

    def _fetch_remote_prefix_sync(self, seq, prefix_blocks, cached_len):
        """The synchronous remote-prefix extension: one blocking GET per
        block inside the scheduler callback (the legacy A/B baseline, and
        the import of a multi-process group).  Never raises: a store outage
        or a malformed entry degrades to a local prefill.

        In a group every rank GETs the full-head blocks itself, and the
        blocks taken are the group's least count (``agree_min``, before any
        block is allocated), since a block written or evicted between two
        ranks' GETs, or an outage one rank sees, would otherwise part the
        ranks' plans; each rank writes its own heads, and a copy-in that
        fails on any rank is dropped on every rank."""
        client = self.offload.remote_client
        bs = self.block_pool.block_size
        hashes = self._seq_prefix_hashes(seq)
        start = cached_len // bs
        if start >= len(hashes):
            return prefix_blocks, cached_len
        # At least one prompt token is always left to prefill.
        max_ext_blocks = (seq.num_prompt_tokens - 1 - cached_len) // bs
        if max_ext_blocks <= 0:
            return prefix_blocks, cached_len
        # Don't fetch what admission can't hold.
        remaining_blocks = -(-(seq.num_prompt_tokens - cached_len) // bs)
        if not self.block_pool.can_allocate(remaining_blocks):
            return prefix_blocks, cached_len
        key_prefix = self._px_key_prefix()
        fetched: List = []
        try:
            for digest in hashes[start : start + max_ext_blocks]:
                entry = client.get_blocks(key_prefix + digest.hex())
                if entry is None:
                    break
                fetched.append(entry[0])
                self.remote_prefix_bytes_read += _layers_nbytes(entry[0])
        except Exception:
            logger.exception("remote prefix fetch failed; continuing local")
            fetched = []
        if self.group is not None:
            fetched = fetched[:distributed.agree_min(len(fetched))]
        if not fetched or not self.block_pool.can_allocate(len(fetched)):
            return prefix_blocks, cached_len
        ids = self.block_pool.allocate(len(fetched))
        try:
            self._import_blocks(ids, self._rank_blocks(fetched))
            copied = True
        except Exception:
            logger.exception("remote prefix copy-in failed; continuing local")
            copied = False
        if self.group is not None:
            copied = bool(distributed.agree_min(int(copied)))
        if not copied:
            self.block_pool.free(ids)
            return prefix_blocks, cached_len
        self.remote_prefix_blocks_fetched += len(ids)
        return prefix_blocks + ids, cached_len + len(ids) * bs

    # -- prefix export -----------------------------------------------------

    def _export_worker(self) -> None:
        """The px-export writer: waits for each export's device-to-host
        copies (its event), then writes the blocks with batched MPUTs.
        Queue items are whole exports (one prompt's chain each), so a long
        prompt is never cut by the queue bound."""
        client = self.offload.remote_client
        while True:
            item = self._export_queue.get()
            if item is None:
                self._export_queue.task_done()
                return
            # Coalesce the backlog into one MPUT call.
            batch = [item]
            while len(batch) < 32:
                try:
                    nxt = self._export_queue.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    self._export_queue.task_done()
                    self._export_queue.put(None)  # re-arm shutdown
                    break
                batch.append(nxt)
            try:
                entries = []
                for export_entries, ready in batch:
                    if ready is not None:
                        ready.synchronize()
                    entries.extend(export_entries)
                client.mput_blocks(entries)
                self.remote_prefix_blocks_exported += len(entries)
            except Exception:
                logger.exception("remote prefix export failed; continuing")
            finally:
                for _ in batch:
                    self._export_queue.task_done()

    def _export_prefix_blocks(self, seq) -> None:
        """After a final prefill: push every full prompt block to the
        shared store under its chain-hash content key, so peer engines
        (and this one after a restart) import instead of recomputing.  The
        step thread enqueues the gather and its copy into pinned host
        memory and records an event; the writer thread waits on it and
        makes the RPCs.  Dedupe entries expire after a TTL, so a store-side
        eviction doesn't end sharing for good.

        In a multi-process group the store holds full-head blocks under
        the keys one engine uses: process 0 decides which blocks go (its
        TTLs are its own clock's) and broadcasts the list; the ranks of its
        tp subgroup gather their head groups onto it (``gather_first``,
        outside any graph), it merges them in tp order and alone writes;
        the ranks of the other sp positions hold replicas of the same
        pool and do nothing."""
        client = self.offload.remote_client
        if client is None:
            return
        bs = self.block_pool.block_size
        hashes = self._seq_prefix_hashes(seq)
        now = time.time()
        leader = self.group is None or self.group.rank == 0
        todo = [
            (i, digest)
            for i, digest in enumerate(hashes)
            if self._exported_hashes.get(digest, 0.0) < now
        ] if leader else []
        if self.group is not None:
            rows = distributed.broadcast_from_leader([i for i, _ in todo])
            todo = [(i, hashes[i]) for i in rows]
            if self.mesh.sp_index != 0:
                return
        if not todo:
            return
        ids = self._put(np.asarray([seq.block_table[i] for i, _ in todo], np.int64))
        try:
            layers = self._gather_export(ids)
            if layers is None:
                return  # a rank that gave its heads to process 0
            host_layers, ready = kv_quant.stage_to_host(layers)
        except Exception:
            logger.exception("prefix export gather failed; continuing")
            return
        with self._export_lock:
            if self._export_thread is None:
                self._export_queue = queue.Queue(maxsize=64)
                self._export_thread = threading.Thread(
                    target=self._export_worker, name="px-export", daemon=True
                )
                self._export_thread.start()
        key_prefix = self._px_key_prefix()
        entries = [
            (key_prefix + digest.hex(),
             [(kv_quant.row_host_side(k, row), kv_quant.row_host_side(v, row))
              for k, v in host_layers],
             bs)
            for row, (_, digest) in enumerate(todo)
        ]
        try:
            self._export_queue.put_nowait((entries, ready))
        except queue.Full:
            return  # writer backlogged: drop this export
        for _, digest in todo:
            self._exported_hashes[digest] = now + self._export_ttl_s
        while len(self._exported_hashes) > 65536:
            self._exported_hashes.popitem(last=False)

    def _gather_export(self, ids: torch.Tensor) -> Optional[list]:
        """The blocks ``ids`` of every layer as full-head wire sides on the
        device: per layer ``(k, v)``, dense, or the int8 cache's native
        ``(data, scale)`` tuples with the quantized wire (serde v2; the
        client's probe falls back to a dense v1 encode against a legacy
        store; with the dense wire an int8 cache dequantizes here so any
        peer can import).  In a group the ranks of the tp subgroup gather
        their head groups onto its first rank, stacked over the layers
        into one tensor a dtype; None on the other ranks."""
        layers = [
            (kv_quant.gather_blocks_wire(k_cache, ids, self._wire_quantized),
             kv_quant.gather_blocks_wire(v_cache, ids, self._wire_quantized))
            for k_cache, v_cache in self.kv_caches
        ]
        if self.group is None:
            return layers
        parts = layers[0][0] if kv_quant.is_quantized(layers[0][0]) else (layers[0][0],)
        gathered = []
        for i in range(len(parts)):
            def part(side):
                return side[i] if kv_quant.is_quantized(side) else side
            stacked = torch.stack([torch.stack([part(k), part(v)]) for k, v in layers])
            gathered.append(collectives.gather_first(stacked, self.group))
        if gathered[0] is None:
            return None
        # [L, 2, n, bs, heads, ...] a rank -> full heads, in tp order.
        merged = [torch.cat(g, dim=4) for g in gathered]
        if len(merged) == 1:
            return [(m[0], m[1]) for m in merged[0]]
        return [((d[0], s[0]), (d[1], s[1])) for d, s in zip(*merged)]

    def flush_prefix_exports(self, timeout: float = 10.0) -> None:
        """Block until queued exports have been written (tests; graceful
        shutdown).  No-op when nothing was ever exported."""
        if self._export_queue is None:
            return
        deadline = time.time() + timeout
        while time.time() < deadline:
            if self._export_queue.unfinished_tasks == 0:
                return
            time.sleep(0.01)

    def close(self, timeout: float = 10.0) -> None:
        """Release every worker thread and socket the engine owns.
        Producers stop before their sinks: the export writer, the prefetch
        fetchers and the offload stager first, the host tier's deleter
        (flushing queued remote DELs) second, the remote client's sockets
        last.  ``timeout`` is one budget shared by all stages."""
        deadline = time.monotonic() + timeout

        def left() -> float:
            return max(0.0, deadline - time.monotonic())

        with self._export_lock:
            export_thread, self._export_thread = self._export_thread, None
        if export_thread is not None:
            self.flush_prefix_exports(left())
            try:
                # Bounded put: the queue is full exactly when the writer
                # is wedged mid-RPC against a hung store.
                self._export_queue.put(None, timeout=left())
            except queue.Full:
                logger.warning(
                    "prefix-export writer still wedged at shutdown; "
                    "abandoning its daemon thread past the close deadline"
                )
            export_thread.join(left())
        if self.kv_prefetch is not None:
            self.kv_prefetch.shutdown(left())
        if self._offload_stager is not None:
            self._offload_stager.shutdown(left())
        self.offload.close(left())
        if self.offload.remote_client is not None:
            self.offload.remote_client.close()

    # -- disaggregated prefill/decode handoff ------------------------------

    def cache_ns_of(self, adapter: Optional[str]) -> int:
        """The prefix-cache namespace a request with this adapter would
        hash under (mirrors add_request; 0 = base model)."""
        if adapter and self.lora_registry is not None:
            return self.lora_registry.namespace_of(adapter)
        return 0

    def handoff_token(self, prompt_token_ids: List[int], cache_ns: int = 0) -> dict:
        """The prefill-phase handoff token: the prompt's prefix hash chain
        (store content keys) and length, and the model-identity key prefix
        so a decode peer can check it shares the weights before waiting on
        imports.  ``exported`` says whether this engine can have exported
        the chain (a store and the prefill role); it is not a per-block
        receipt."""
        hashes = prefix_block_hashes(
            prompt_token_ids, self.block_pool.block_size, namespace=cache_ns
        )
        key_prefix = self._px_key_prefix()
        return {
            "chain": [key_prefix + d.hex() for d in hashes],
            "chain_len": len(hashes),
            "chain_tail": hashes[-1].hex() if hashes else "",
            "prompt_tokens": len(prompt_token_ids),
            "block_size": self.block_pool.block_size,
            "px": key_prefix,
            "exported": bool(
                self._exports and self.offload.remote_client is not None
            ),
        }

    def wait_handoff_prefix(self, prompt_token_ids: List[int], cache_ns: int,
                            handoff: dict, timeout: float) -> str:
        """Decode-phase handoff: make sure a prefetch of the prompt's chain
        is in flight and wait (bounded) for the fetch to land in host
        staging.  A staged chain is imported by the step thread at the top
        of its next dispatch, before any schedule(), so a request admitted
        after "hit" serves its whole prompt from the prefix cache.  Runs on
        a worker thread of the server.  Returns "hit", "partial", "miss",
        or "disabled" (no prefetch plane, imports off, or other weights).

        In a group the chain job is queued for the step loop, which
        publishes it (``StepEvents.handoffs``) and has every rank submit it
        at one point of the iteration (:meth:`submit_handoff`); the wait
        then reads the group's agreed state of the job."""
        if self.kv_prefetch is None or not self._imports:
            return "disabled"
        hashes = prefix_block_hashes(
            prompt_token_ids, self.block_pool.block_size, namespace=cache_ns
        )
        if not hashes:
            return "hit"  # shorter than one block: nothing to import
        peer_px = handoff.get("px")
        if peer_px and peer_px != self._px_key_prefix():
            return "disabled"
        start = self.block_pool.count_cached_prefix(hashes)
        if start >= len(hashes):
            return "hit"
        deadline = time.time() + max(0.0, timeout)
        sid = self._handoff_sid(hashes)
        if self.group is None:
            submitted = self._submit_handoff_chain(sid, hashes, start)
        else:
            ticket = {"done": threading.Event(), "submitted": False}
            with self._handoff_lock:
                self._handoffs.append((list(prompt_token_ids), cache_ns, ticket))
            if self._commit_wake is not None:
                self._commit_wake()
            ticket["done"].wait(max(0.0, deadline - time.time()))
            submitted = ticket["submitted"]
        if not submitted:
            # A same-head job is already in flight: poll coverage on a
            # shortened budget.
            deadline = min(deadline, time.time() + 0.5)
        grace_until: Optional[float] = None
        while time.time() < deadline:
            covered = self.block_pool.count_cached_prefix(hashes)
            if covered >= len(hashes):
                return "hit"
            status = self.kv_prefetch.chain_status(sid)
            if status == "done":
                return "hit"
            if status == "absent" and submitted:
                # Our fetch settled empty, or the step thread consumed it:
                # one short grace window for coverage, then classify.
                if grace_until is None:
                    grace_until = time.time() + 0.1
                elif time.time() >= grace_until:
                    break
            time.sleep(0.005)
        covered = self.block_pool.count_cached_prefix(hashes)
        if covered >= len(hashes):
            return "hit"
        return "partial" if covered > start else "miss"

    @staticmethod
    def _handoff_sid(hashes: List[bytes]) -> str:
        return f"handoff-{hashes[-1].hex()[:16]}"

    def _submit_handoff_chain(self, sid: str, hashes: List[bytes], start: int) -> bool:
        key_prefix = self._px_key_prefix()
        return self.kv_prefetch.submit_chain(
            sid,
            [key_prefix + d.hex() for d in hashes[start:]],
            hashes[start:],
            start,
        )

    def take_handoffs(self) -> List[tuple]:
        """The handoff chains queued by :meth:`wait_handoff_prefix` in a
        group, ``[(prompt_token_ids, cache_ns, ticket)]``, for the step loop
        to publish and submit."""
        with self._handoff_lock:
            taken, self._handoffs = self._handoffs, []
        return taken

    def submit_handoff(self, prompt_token_ids: List[int], cache_ns: int,
                       ticket: Optional[dict] = None) -> bool:
        """Submit a handoff's chain job (every rank of a group, at the same
        point of an iteration: the step loop, then ``follower_loop``),
        from the prefix cache as it stands there; ``ticket`` (the leader's)
        tells the waiter whether a job was submitted."""
        hashes = prefix_block_hashes(
            prompt_token_ids, self.block_pool.block_size, namespace=cache_ns
        )
        start = self.block_pool.count_cached_prefix(hashes) if hashes else 0
        submitted = start < len(hashes) and self._submit_handoff_chain(
            self._handoff_sid(hashes), hashes, start)
        if ticket is not None:
            ticket["submitted"] = submitted
            ticket["done"].set()
        return submitted

    # -- stepping ----------------------------------------------------------

    def step(self) -> List[StepOutput]:
        """One engine step: top up the device pipeline, then collect the
        oldest in-flight step.  With the lookahead on, the collected
        outputs belong to a step whose successor is already running on the
        device; greedy token streams are the same as synchronous stepping.
        Returns [] when nothing was schedulable."""
        self.dispatch()
        return self.collect()

    def has_pending(self) -> bool:
        """A dispatched step is awaiting collection."""
        return bool(self._pending)

    def dispatch(self) -> bool:
        """Launch device work without reading anything back, filling the
        pipeline to its depth (2 with lookahead, 1 otherwise).  Returns
        True when at least one step was dispatched."""
        depth = 2 if self._pipeline_enabled else 1
        launched = False
        while len(self._pending) < depth:
            ok = (
                self._dispatch_lookahead()
                if self._pending
                else self._dispatch_front()
            )
            if not ok:
                break
            launched = True
        return launched

    def collect(self) -> List[StepOutput]:
        """Wait for the oldest dispatched step and finalize it: append
        sampled tokens and run finish checks; rows whose sequence finished
        while the step was in flight drop their token (a discarded
        overrun, vLLM multi-step semantics)."""
        if not self._pending:
            return []
        t0 = time.time()
        p = self._pending.popleft()
        if p.outputs is not None:
            outputs = p.outputs
        elif p.steps is not None:
            outputs = self._collect_window(p)
        else:
            arr = p.read()
            if self.obs.enabled:
                self.obs.step_phase("collect", time.time() - t0)
            t_post = time.time()
            live = [(i, s) for i, s in enumerate(p.seqs) if not s.is_finished]
            outputs = self._append_and_check(
                [s for _, s in live], [int(arr[i]) for i, _ in live],
                first_token=False,
            )
            if self.obs.enabled:
                self.obs.step_phase("sample", time.time() - t_post)
            if p.rec is not None:
                # Rows whose sequence finished while the step flew sampled
                # a discarded overrun token.
                self._note_compiles([s.seq_id for s in p.seqs], p.rec)
                self.obs.recorder.on_collect(
                    p.rec, host_s=p.host_s,
                    tokens_emitted=len(p.seqs),
                    tokens_delivered=len(live),
                    tokens_wasted=len(p.seqs) - len(live),
                )
        if p.outputs is None:
            # Drop in-flight successors whose every row has now finished:
            # pure overrun steps produce no outputs and must not wedge the
            # pipeline when the engine drains.  Never a mixed window: its
            # chunks are not decode rows, and dropping it would skip a
            # final chunk's first token and the chunk accounting.
            while (
                self._pending
                and self._pending[0].host is not None
                and self._pending[0].chunk_sched is None
                and all(s.is_finished for s in self._pending[0].seqs)
            ):
                d = self._pending.popleft()
                if d.rec is not None:
                    # Every dispatched step appears exactly once: a plain
                    # window's rows are all frozen (the device emitted
                    # nothing), a single step sampled one discarded token
                    # a row.
                    n = 0 if d.steps is not None else len(d.seqs)
                    self.obs.recorder.on_collect(
                        d.rec, host_s=d.host_s, tokens_emitted=n, tokens_wasted=n,
                    )
            if self.obs.enabled:
                # Only pipelined steps have a pure-dispatch host_s: a
                # synchronous step's fuses the build, the device compute
                # and the sampling, so it feeds only the schedule phase.
                self.obs.step_phase("dispatch", p.host_s)
        now = time.time()
        self._last_decode_end = now if p.is_decode else None
        busy = (now - t0) + p.host_s
        self._step_time_accum += busy
        self._busy_window.append((now, busy))
        cutoff = now - self._busy_window_s
        self._busy_window = [(t, d) for (t, d) in self._busy_window if t > cutoff]
        self.num_steps += 1
        return outputs

    def _dispatch_front(self) -> bool:
        """Dispatch with nothing in flight: full scheduler knowledge
        (admission, preemption, partial-prefill rollback); the only place
        synchronous plans run."""
        # Land completed remote-prefix prefetches in the prefix cache
        # before planning, so this schedule()'s match_prefix can serve them
        # (the copy-in is enqueued on the device, not waited for); in a
        # group, what landed is what the group agreed on just now.
        self._agree_transfers()
        self._drain_prefetched()
        t0 = time.time()
        plan = self.scheduler.schedule()
        if self.obs.enabled:
            self.obs.step_phase("schedule", time.time() - t0)
        if plan.is_empty:
            if self._transfer_inflight():
                # Nothing schedulable because a restore page-in or an
                # offload stage is in flight: yield a tick so a tight
                # caller loop does not spin faster than the workers land
                # the bytes.  The device is idle here: pacing, not a wait.
                time.sleep(0.001)
            return False
        if plan.window_fallback:
            self.multistep_fallback[plan.window_fallback] = (
                self.multistep_fallback.get(plan.window_fallback, 0) + 1
            )
        if plan.decode is None:
            outputs = self._run_prefill(plan.prefill_chunk)
            self._step_counter += 1
            host_s = time.time() - t0
            if self.obs.enabled:
                self._record_sync_step(
                    "prefill", t0, host_s, (), plan.prefill_chunk, len(outputs),
                    len(outputs), fallback=plan.window_fallback,
                )
            self._pending.append(_PendingStep(outputs=outputs, host_s=host_s))
            return True
        if plan.chunk_schedule is not None:
            # Mixed K-step window: the waiting prompts' chunks ride the
            # decode iterations; a final chunk's first token is sampled at
            # collect.
            self._pending.append(self._dispatch_mixed_window(plan, chain_from=None))
            return True
        if plan.prefill_chunk is not None:
            # Fused decode+prefill-chunk step: synchronous (the chunk's
            # admission and finalization need collected state), so the
            # lookahead pauses for the step.
            gap = self._recorder_gap(t0) if self.obs.enabled else 0.0
            outputs = self._run_mixed(plan)
            self._step_counter += 1
            host_s = time.time() - t0
            if self.obs.enabled:
                self._record_sync_step(
                    "mixed", t0, host_s, plan.decode.seqs, plan.prefill_chunk,
                    len(outputs), len(outputs), fallback=plan.window_fallback,
                    host_gap_s=gap,
                )
            self._pending.append(_PendingStep(
                outputs=outputs, is_decode=True, host_s=host_s,
            ))
            return True
        seqs = plan.decode.seqs
        if plan.decode_window > 1 and self._can_window(seqs):
            self._pending.append(self._dispatch_window(plan, chain_from=None))
            return True
        # A K>1 plan that fell out of the window path carries the decline
        # reason onto the replacing K=1 dispatch's flight record.
        decline = plan.window_fallback or (
            self._last_window_decline if plan.decode_window > 1 else None
        )
        if self._can_pipeline(seqs):
            p = self._dispatch_decode_async(seqs, False)
            if p.rec is not None and decline:
                p.rec.fallback = decline
            self._pending.append(p)
        else:
            gap = self._recorder_gap(t0) if self.obs.enabled else 0.0
            outputs = self._run_decode(plan.decode)
            self._step_counter += 1
            host_s = time.time() - t0
            if self.obs.enabled:
                self._record_sync_step(
                    "decode", t0, host_s, seqs, None, len(seqs), len(outputs),
                    fallback=decline, host_gap_s=gap,
                )
            self._pending.append(_PendingStep(
                outputs=outputs, is_decode=True, host_s=host_s,
            ))
        return True

    def _record_sync_step(self, kind: str, t0: float, host_s: float, seqs,
                          chunk: Optional[PrefillPlan], emitted: int,
                          delivered: int, **stamp) -> None:
        """The flight record of a synchronous step (prefill, K=1 mixed step,
        sync decode), stamped and completed at once: its decode rows
        ``seqs``, then the chunk's prompt; ``stamp`` carries the fallback
        and the host gap."""
        sids = tuple(s.seq_id for s in seqs)
        chunk_kw = {}
        if chunk is not None:
            sids += (chunk.seq.seq_id,)
            chunk_kw = dict(chunk_prompts=1, chunk_tokens_planned=chunk.num_new_tokens)
        rec = self.obs.recorder.on_dispatch(
            kind, k=1, rows=len(seqs), seq_ids=sids, now=t0, **chunk_kw, **stamp,
        )
        self._note_compiles(sids, rec)
        self.obs.recorder.on_collect(
            rec, host_s=host_s, tokens_emitted=emitted, tokens_delivered=delivered,
            chunk_tokens_delivered=chunk.num_new_tokens if chunk is not None else 0,
        )

    def _dispatch_lookahead(self) -> bool:
        """Provisionally dispatch decode N+1 while N is still in flight.
        The scheduler plans under the optimistic no-finish assumption
        (collect discards the overrun when wrong); inputs chain from N's
        device-resident state, the [S] in-flight sample of a single step
        or the whole window carry, so no host sync separates them."""
        if not self._pipeline_enabled:
            return False
        prev = self._pending[-1]
        if prev.host is None:
            return False  # only pipelined decode steps chain
        if prev.win_key is not None:
            t0 = time.time()
            plan = self.scheduler.schedule_provisional_window(
                prev.seqs, prev.steps
            )
            if self.obs.enabled:
                self.obs.step_phase("schedule", time.time() - t0)
            if plan is None:
                return False
            if plan.chunk_schedule is not None:
                # A waiting head's chunks chain onto the in-flight carry as
                # a mixed window: the pipeline never drains for admission.
                self._pending.append(self._dispatch_mixed_window(plan, chain_from=prev))
            else:
                self._pending.append(self._dispatch_window(plan, chain_from=prev))
            return True
        if not self._can_pipeline(prev.seqs):
            return False
        t0 = time.time()
        plan = self.scheduler.schedule_provisional(prev.seqs)
        if self.obs.enabled:
            self.obs.step_phase("schedule", time.time() - t0)
        if plan is None:
            return False
        self._pending.append(self._dispatch_decode_async(plan.seqs, True))
        return True

    # (window_fallback, classic_fallback, greedy), cached per sequence.
    _host_state_flags = staticmethod(host_state_flags)

    def _can_window(self, seqs: List[Sequence]) -> bool:
        """K-step windows serve everything except host-sampled features
        (logprobs, logit_bias, guided decoding); each fallback is counted
        by reason (a row's first of logprobs, logit_bias, guided), once a
        reason a dispatch, and the first reason by name is remembered for
        the flight record of the K=1 dispatch that replaces the window."""
        self._last_window_decline = None
        if self._window_steps <= 1:
            return False
        reasons = {
            "logprobs" if s.sampling_params.logprobs
            else "logit_bias" if s.sampling_params.logit_bias
            else "guided"
            for s in seqs if self._host_state_flags(s)[0]
        }
        for reason in reasons:
            self.multistep_fallback[reason] = (
                self.multistep_fallback.get(reason, 0) + 1
            )
        self._last_window_decline = min(reasons) if reasons else None
        return not reasons

    def _can_pipeline(self, seqs: List[Sequence]) -> bool:
        """The single-step pipeline's sampler has no penalty or floor path,
        so penalty batches and pending min_tokens floors run synchronous
        single steps (K-step windows serve those on the device)."""
        return self._pipeline_enabled and not any(
            self._host_state_flags(s)[1] or s._min_tok_pending
            for s in seqs
        )

    def _recorder_gap(self, t0: float) -> float:
        """Host gap this dispatch inherited from the previous window (the
        device idle since the last decode retired), stamped onto the flight
        record.  Read before the launch bookkeeping clears it."""
        last = self._last_decode_end
        return max(0.0, t0 - last) if last is not None else 0.0

    def _note_compiles(self, seq_ids, rec=None) -> None:
        """Drain the compile events the dispatch just made (graph keys
        used for the first time, kernel libraries loaded for the first
        time since this engine booted) and attribute them: the flight
        record goes compile-tainted and every co-scheduled request's trace
        is tagged compile=true."""
        if not self.obs.enabled:
            return
        loads = _build.first_loads
        if len(loads) > self._csrc_loads_seen:
            for name, seconds in loads[self._csrc_loads_seen:]:
                self.obs.compile_tracker.record("csrc", name, seconds)
            self._csrc_loads_seen = len(loads)
        self.obs.on_compile(seq_ids, self.obs.compile_tracker.drain_events(), rec)

    def _note_decode_launch(self) -> None:
        """Host-gap bookkeeping: time since the previous decode step
        retired with the device left idle.  Lookahead dispatches count a
        zero gap by construction (the device was still busy)."""
        if self._last_decode_end is not None:
            self._gap_total_s += max(0.0, time.time() - self._last_decode_end)
            self._gap_steps += 1
        self._last_decode_end = None

    def _note_lookahead_launch(self) -> None:
        self._gap_steps += 1  # device busy: zero gap by construction
        self._last_decode_end = None

    def _key_seed(self, step_ordinal: Optional[int] = None) -> int:
        """The step seed of step ``step_ordinal`` (default: this dispatch's),
        masked to 31 bits: below 2**31 step ordinals (years of serving) the
        schedule is engine seed + step counter, the same for every window
        size."""
        ordinal = self._step_counter if step_ordinal is None else step_ordinal
        return (self.config.seed + ordinal) & 0x7FFFFFFF

    def _buffers_for(self, key: tuple, make) -> Dict[str, torch.Tensor]:
        bufs = self._buffers.get(key)
        if bufs is None:
            bufs = self._buffers[key] = make()
        return bufs

    # -- pipelined single-token steps ----------------------------------------

    def _pipe_buffers(self, S: int) -> Dict[str, torch.Tensor]:
        dev = self.device
        i32 = dict(dtype=torch.int32, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        return {
            "tokens": torch.zeros(S, dtype=torch.int64, device=dev),
            "tables": torch.zeros((S, self._bmax), **i32),
            "temps": torch.zeros(S, **f32),
            "top_ps": torch.ones(S, **f32),
            "top_ks": torch.zeros(S, **i32),
            "min_ps": torch.zeros(S, **f32),
            "seeds": torch.zeros(S, dtype=torch.int64, device=dev),
            # positions, ctx_lens, table cols, table vals, then the step seed
            "delta": torch.zeros(4 * S + 1, **i32),
            "sampled": torch.zeros(S, **i32),
            **({"adapter": torch.zeros(S, **i32)} if self.lora_registry else {}),
        }

    def _pipe_body(self, b: Dict[str, torch.Tensor], all_greedy: bool) -> None:
        """One decode+sample step over static buffers: the table growth and
        positions from ``delta``, slots looked up on the device, the sample
        written to ``sampled`` and to ``tokens`` (the next step's input)."""
        bs = self.block_pool.block_size
        S = b["tokens"].shape[0]
        d = b["delta"]
        positions, ctx_lens = d[:S], d[S:2 * S]
        _advance_tables(b["tables"], d[2 * S:3 * S, None], d[3 * S:4 * S, None])
        blk = torch.gather(b["tables"], 1, (positions // bs).long()[:, None])[:, 0]
        logits = llama.decode(
            self.params, self.config.model,
            tokens=b["tokens"],
            positions=positions,
            block_tables=b["tables"],
            ctx_lens=ctx_lens,
            slot_block_ids=torch.where(ctx_lens > 0, blk, 0),
            slot_offsets=positions % bs,
            kv_caches=self.kv_caches,
            **self._lora_kwargs(b.get("adapter")),
        )
        sampled = sampling_lib.sample_tokens(
            logits, b["temps"], b["top_ps"], b["top_ks"], d[4 * S:].long(),
            b["seeds"], min_p=b["min_ps"], all_greedy=all_greedy,
        )
        b["sampled"].copy_(sampled)
        b["tokens"].copy_(sampled)

    def _dispatch_decode_async(self, seqs: List[Sequence],
                               lookahead: bool) -> _PendingStep:
        """Enqueue one decode+sample step and return without a host
        round-trip.  ``lookahead=False`` (re)builds the static batch state
        from host bookkeeping (one packed transfer); ``lookahead=True`` is
        the steady "same batch, +1 token" path: one [4S+1] delta, tokens
        chained on the device from the in-flight sample."""
        t0 = time.time()
        gap = self._recorder_gap(t0) if self.obs.enabled else 0.0
        if not lookahead:
            S = self._decode_bucket(len(seqs))
            all_greedy = all(self._host_state_flags(s)[2] for s in seqs)
            key = ("pipe", S, all_greedy)
            b = self._buffers_for(key, lambda: self._pipe_buffers(S))
            (tokens, positions, tables, ctx_lens, _sb, _so) = (
                self._decode_batch_arrays(seqs, S)
            )
            temps, top_ps, top_ks, min_ps, seeds = self._sampling_arrays(seqs, S)
            self._upload(b, {
                "tokens": tokens, "tables": tables, "temps": temps,
                "top_ps": top_ps, "top_ks": top_ks, "min_ps": min_ps,
                "seeds": seeds,
                **({"adapter": self._adapter_rows(seqs, S)} if "adapter" in b else {}),
            })
            cols = np.full((S,), -1, np.int32)
            vals = np.zeros((S,), np.int32)
            self._pipe_table_lens = [len(s.block_table) for s in seqs]
            self._pipe_key = key
            self._note_decode_launch()
        else:
            key = self._pipe_key
            b = self._buffers[key]
            S = key[1]
            positions = np.zeros((S,), np.int32)
            ctx_lens = np.zeros((S,), np.int32)
            cols = np.full((S,), -1, np.int32)
            vals = np.zeros((S,), np.int32)
            for i, seq in enumerate(seqs):
                pos = seq.num_tokens  # consumes the in-flight token
                positions[i] = pos
                ctx_lens[i] = pos + 1
                have = self._pipe_table_lens[i]
                if len(seq.block_table) > have:
                    # schedule_provisional grows by at most one block.
                    cols[i] = have
                    vals[i] = seq.block_table[have]
                    self._pipe_table_lens[i] = have + 1
            self._note_lookahead_launch()
        delta = np.concatenate([positions, ctx_lens, cols, vals,
                                np.array([self._key_seed()], np.int32)])
        b["delta"].copy_(self._put(delta))
        self.graphs.run(key, lambda: self._pipe_body(b, key[2]))
        host, ready = kv_quant.stage_to_host(b["sampled"])
        self._step_counter += 1
        rec = None
        if self.obs.enabled:
            sids = tuple(s.seq_id for s in seqs)
            rec = self.obs.recorder.on_dispatch(
                "decode", k=1, rows=len(seqs), seq_ids=sids,
                provisional=lookahead, host_gap_s=gap, now=t0,
            )
            self._note_compiles(sids, rec)
        return _PendingStep(
            seqs=list(seqs), host=host, ready=ready, is_decode=True,
            host_s=time.time() - t0, rec=rec,
        )

    # -- K-step device-resident decode windows -------------------------------

    def _window_buffers(self, S: int, B: int, use_penalties: bool,
                        use_min_floor: bool) -> Dict[str, torch.Tensor]:
        dev = self.device
        i32 = dict(dtype=torch.int32, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        vocab = self.config.model.vocab_size
        V = vocab if use_penalties else 1
        C = self._win_delta_cols
        bufs = {
            "tokens": torch.zeros(S, dtype=torch.int64, device=dev),
            "done": torch.ones(S, dtype=torch.bool, device=dev),
            "tables": torch.zeros((S, self._bmax), **i32),
            "stop_ids": torch.full((S, B), -1, **i32),
            "counts": torch.zeros((S, V), **f32),
            "seen": torch.zeros((S, V), dtype=torch.bool, device=dev),
            # The stop set as an [S, vocab] mask, written at each build.
            "stop_mask": torch.zeros((S, vocab if use_min_floor else 1),
                                     dtype=torch.bool, device=dev),
            "seeds": torch.zeros(S, dtype=torch.int64, device=dev),
            # max_steps, table cols [S, C], table vals [S, C], the key base
            "delta": torch.zeros(S * (1 + 2 * C) + 1, **i32),
            "emitted": torch.zeros((self._window_steps, S), **i32),
        }
        for name in ("positions", "ctx_lens", "min_left", "top_ks"):
            bufs[name] = torch.zeros(S, **i32)
        for name in ("temps", "top_ps", "min_ps", "presence", "frequency",
                     "repetition"):
            bufs[name] = torch.zeros(S, **f32)
        if self._spec_window:
            # The drafters' carried history (left -1-padded, the committed
            # token last) and a speculative window's outputs.
            bufs["hist"] = torch.full((S, self._SPEC_HIST_WINDOW), -1, **i32)
            bufs["spec_out"] = torch.zeros(
                (self._window_steps, self._spec_len + 3, S), **i32)
        if self.draft_block_pool is not None:
            bufs["draft_tables"] = torch.zeros((S, self._draft_blocks_per_row), **i32)
            bufs["draft_pos"] = torch.zeros(S, **i32)
        if self.lora_registry is not None:
            bufs["adapter"] = torch.zeros(S, **i32)  # each row's LoRA slot
        return bufs

    def _window_body(self, b: Dict[str, torch.Tensor], use_penalties: bool,
                     use_min_floor: bool, all_greedy: bool) -> None:
        """K decode+sample iterations over the static carry (the JAX
        engine's ``multi_window``).  Each iteration decodes every active
        row (not done, within its token budget), applies the penalties from
        the carried occurrence state and the ``min_tokens`` ban while the
        floor is unmet, samples with step seed ``key base + t``, and
        freezes a row that hits its stop set: frozen and padded rows park
        their KV write on null block 0 and emit -1.  The carry is written
        back in place; ``emitted`` holds the [K, S] tokens."""
        bs = self.block_pool.block_size
        max_steps, key_base = self._apply_window_delta(b)
        stop_mask = b["stop_mask"] if use_min_floor else None
        carry = tuple(b[name] for name in self._CARRY)
        for t in range(self._window_steps):
            tokens, positions, ctx_lens, done, _ = carry
            active = ~done & (t < max_steps)
            blk = torch.gather(b["tables"], 1, (positions // bs).long()[:, None])[:, 0]
            logits = llama.decode(
                self.params, self.config.model,
                tokens=tokens,
                positions=positions,
                block_tables=b["tables"],
                ctx_lens=ctx_lens,
                slot_block_ids=torch.where(active, blk, 0),
                slot_offsets=positions % bs,
                kv_caches=self.kv_caches,
                **self._lora_kwargs(b.get("adapter")),
            )
            carry = self._sample_and_advance(
                b, logits, t, active, carry, key_base, stop_mask,
                use_penalties, all_greedy,
            )
        for name, value in zip(self._CARRY, carry):
            b[name].copy_(value)

    # The per-row window carry a chained window continues from.
    _CARRY = ("tokens", "positions", "ctx_lens", "done", "min_left")

    def _apply_window_delta(self, b: Dict[str, torch.Tensor]):
        """A window's delta on the device: the block-table growth applied in
        place (idempotent: a second call rewrites the same columns); returns
        the rows' token budgets [S] and the key base [1]."""
        S = b["tokens"].shape[0]
        C = self._win_delta_cols
        d = b["delta"]
        _advance_tables(b["tables"], d[S:S + S * C].view(S, C),
                        d[S + S * C:S + 2 * S * C].view(S, C))
        return d[:S], d[-1:].long()

    def _stop_mask(self, b: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The stop set as an [S, V] mask: the min_tokens ban set is the
        stop set (vLLM semantics)."""
        stop_ids = b["stop_ids"]
        stop_valid = stop_ids >= 0
        hits = torch.zeros((stop_ids.shape[0], self.config.model.vocab_size),
                           dtype=torch.float32, device=stop_ids.device)
        hits.scatter_add_(1, torch.where(stop_valid, stop_ids, 0).long(),
                          stop_valid.float())
        return hits > 0

    def _sample_and_advance(self, b, logits, t, active, carry, key_base, stop_mask,
                            use_penalties: bool, all_greedy: bool) -> tuple:
        """The sampling half of window iteration ``t`` (a host int, or a
        [1] device counter in a mixed window): penalties from the carried
        occurrence state, the min_tokens ban while the floor is unmet, the
        draw with step seed ``key base + t``, the stop masks; writes row t
        of ``emitted`` and the occurrence state, returns the next carry."""
        tokens, positions, ctx_lens, done, min_left = carry
        counts, seen = b["counts"], b["seen"]
        if use_penalties:
            logits = sampling_lib.apply_penalties_state(
                logits, counts, seen, b["presence"], b["frequency"], b["repetition"],
            )
        if stop_mask is not None:
            logits = _ban_stops(logits, stop_mask, min_left)
        sampled = sampling_lib.sample_tokens(
            logits, b["temps"], b["top_ps"], b["top_ks"], key_base + t,
            b["seeds"], min_p=b["min_ps"], all_greedy=all_greedy,
        )
        stop_hit = active & _hits_stop(sampled, b["stop_ids"])
        row = torch.where(active, sampled, -1)
        if isinstance(t, int):
            b["emitted"][t].copy_(row)
        else:
            b["emitted"].index_copy_(0, t, row[None].to(b["emitted"].dtype))
        appended = active & ~stop_hit
        if use_penalties:
            _count_tokens(counts, seen, sampled, appended)
        step = active.int()
        return (torch.where(active, sampled, tokens), positions + step,
                ctx_lens + step, done | stop_hit, torch.clamp(min_left - step, min=0))

    # -- fused speculative windows -------------------------------------------

    def _spec_body(self, b: Dict[str, torch.Tensor], use_penalties: bool,
                   use_min_floor: bool, do_prime: bool) -> None:
        """K speculative iterations over the window carry (the JAX
        engine's ``spec_window``), greedy only.  Each iteration proposes up
        to D drafts a row (n-gram lookup in the carried history, or D+1
        sequential draft-model forwards), verifies them beside the
        committed token in one decode over S x W rows (W = D + 1; row j of
        a sequence at position pos + j, so the decode's write-then-attend
        lets it see rows < j; dead rows park on null block 0), then
        replays the W rows in order with the penalties, the min_tokens ban
        and the stop set: a row emits the argmax of each verify row while
        the drafts before agree, so it advances 1..W tokens.  The row's
        budget gates tokens, not iterations.  The history shifts by the
        tokens emitted; the model drafter's cursor by the same count.
        ``spec_out[t]`` holds iteration t's [W, S] tokens, then the drafted
        and the accepted counts.  ``do_prime`` first rebuilds the draft
        cache from the history in one causal decode."""
        bs = self.block_pool.block_size
        D = self._spec_len
        W = D + 1
        H = self._SPEC_HIST_WINDOW
        model = self.draft_params is not None
        max_steps, _ = self._apply_window_delta(b)
        tables, stop_ids = b["tables"], b["stop_ids"]
        S, bmax = tables.shape
        dev = tables.device
        stop_mask = b["stop_mask"] if use_min_floor else None
        counts, seen, hist = b["counts"], b["seen"], b["hist"]
        tokens, positions, ctx_lens, done, min_left = (b[n] for n in self._CARRY)
        draft_pos = b["draft_pos"] if model else None
        if model and do_prime:
            draft_pos = self._draft_prime(b, positions, hist)
        emitted_cnt = torch.zeros_like(positions)
        offs = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
        d_idx = torch.arange(D, device=dev)[None, :]
        wide_tables = tables.repeat_interleave(W, dim=0)
        # Each row's LoRA slot on its W verify rows (the drafters run the
        # base model, as in the JAX engine).
        wide_lora = self._lora_kwargs(
            b["adapter"].repeat_interleave(W) if "adapter" in b else None)
        for t in range(self._window_steps):
            active = ~done & (emitted_cnt < max_steps)
            # Drafts: the bonus token always takes one budget slot.
            room = torch.clamp(max_steps - emitted_cnt - 1, min=0)
            if model:
                draft = self._draft_propose(b, tokens, positions, min_left, draft_pos,
                                            active, use_penalties, stop_mask)
                dvalid = (d_idx < room[:, None]) & active[:, None]
            else:
                draft, dvalid = self._ngram_propose(hist, D)
                dvalid &= (d_idx < room[:, None]) & active[:, None]
            # Only a contiguous prefix of the drafts is verifiable.
            dvalid = torch.cumsum((~dvalid).int(), dim=1) == 0
            draft = torch.where(dvalid, draft.to(tokens.dtype), 0)
            chain = torch.cat([tokens[:, None], draft], dim=1)
            row_live = torch.cat([active[:, None], dvalid], dim=1)
            wpos = positions[:, None] + offs
            blk = torch.gather(tables, 1, torch.clamp(wpos // bs, 0, bmax - 1).long())
            logits = llama.decode(
                self.params, self.config.model,
                tokens=chain.reshape(-1),
                positions=torch.where(row_live, wpos, 0).reshape(-1),
                block_tables=wide_tables,
                ctx_lens=torch.where(row_live, ctx_lens[:, None] + offs, 0).reshape(-1),
                slot_block_ids=torch.where(row_live, blk, 0).reshape(-1),
                slot_offsets=(wpos % bs).reshape(-1),
                kv_caches=self.kv_caches,
                **wide_lora,
            ).view(S, W, -1)
            # The sequential verify: every accepted token through the
            # plain window's penalty, ban and stop code, in order.
            alive, last_tok, new_done = active, tokens, done
            adv = torch.zeros_like(positions)
            acc_cnt = torch.zeros_like(positions)
            out = b["spec_out"][t]
            for j in range(W):
                lj = logits[:, j]
                if use_penalties:
                    lj = sampling_lib.apply_penalties_state(
                        lj, counts, seen, b["presence"], b["frequency"],
                        b["repetition"])
                if use_min_floor:
                    lj = _ban_stops(lj, stop_mask, min_left)
                tok_j = torch.argmax(lj, dim=-1)
                stop_hit = alive & _hits_stop(tok_j, stop_ids)
                out[j].copy_(torch.where(alive, tok_j, -1))
                appended = alive & ~stop_hit
                if use_penalties:
                    _count_tokens(counts, seen, tok_j, appended)
                step = alive.int()
                adv = adv + step
                min_left = torch.clamp(min_left - step, min=0)
                last_tok = torch.where(alive, tok_j, last_tok)
                new_done = new_done | stop_hit
                if j < W - 1:
                    alive = appended & dvalid[:, j] & (tok_j == draft[:, j])
                    acc_cnt = acc_cnt + alive.int()
            out[W].copy_(dvalid.sum(dim=1))
            out[W + 1].copy_(acc_cnt)
            # Fold: the history shifts by the emitted count.
            cat = torch.cat([hist, torch.clamp(out[:W].T, min=0)], dim=1)
            hidx = torch.arange(H, device=dev)[None, :] + adv[:, None]
            hist = torch.gather(cat, 1, hidx.long())
            tokens = torch.where(active, last_tok, tokens)
            positions, ctx_lens = positions + adv, ctx_lens + adv
            done = new_done
            emitted_cnt = emitted_cnt + adv
            if model:
                # Accepted + 1 slots now hold the context before the new
                # committed token; the next write lands on the first
                # rejected draft's slot.
                draft_pos = draft_pos + adv
        for name, value in zip(self._CARRY, (tokens, positions, ctx_lens, done, min_left)):
            b[name].copy_(value)
        b["hist"].copy_(hist)
        if model:
            b["draft_pos"].copy_(draft_pos)

    def _ngram_propose(self, hist: torch.Tensor, D: int):
        """On-device prompt lookup over the carried history [S, H]: the D
        tokens after the most recent earlier occurrence of the trailing
        bigram, else of the committed token alone.  Returns (draft [S, D],
        valid [S, D])."""
        H = hist.shape[1]
        dev = hist.device
        key0, key1 = hist[:, H - 2:H - 1], hist[:, H - 1:H]
        starts = torch.arange(H - 2, device=dev)[None, :]
        head, nxt = hist[:, :H - 2], hist[:, 1:H - 1]
        match2 = (head == key0) & (nxt == key1) & (head >= 0)
        best2 = torch.where(match2, starts, -1).amax(dim=1)
        match1 = (nxt == key1) & (nxt >= 0)
        best1 = torch.where(match1, starts, -1).amax(dim=1)
        best = torch.where(best2 >= 0, best2, best1)
        dpos = best[:, None] + 2 + torch.arange(D, device=dev)[None, :]
        draft = torch.gather(hist, 1, torch.clamp(dpos, 0, H - 1))
        valid = (best >= 0)[:, None] & (dpos < H) & (draft >= 0)
        return draft, valid

    def _draft_propose(self, b, tokens, positions, min_left, draft_pos, active,
                       use_penalties, stop_mask) -> torch.Tensor:
        """D+1 sequential draft-model forwards: d = 0 consumes the
        committed token (its KV at compact slot ``draft_pos``, RoPE at the
        true position), each d < D takes the argmax, with the penalties and
        the ban the verifier will apply given the drafts before it, as the
        next proposal; the last forward only writes the last draft's KV.
        Inactive rows park on the draft pool's null block 0; ``stop_mask``
        is None without a min_tokens floor.  Returns the drafts [S, D]."""
        bs = self.block_pool.block_size
        D = self._spec_len
        tables = b["draft_tables"]
        dbmax = tables.shape[1]
        if use_penalties:
            dcounts, dseen = b["counts"].clone(), b["seen"].clone()
        dmin = min_left
        cur, drafts = tokens, []
        for d in range(D + 1):
            dslot = draft_pos + d
            dblk = torch.gather(
                tables, 1, torch.clamp(dslot // bs, 0, dbmax - 1).long()[:, None])[:, 0]
            dlogits = llama.decode(
                self.draft_params, self.draft_cfg,
                tokens=cur,
                positions=positions + d,
                block_tables=tables,
                ctx_lens=torch.where(active, dslot + 1, 0),
                slot_block_ids=torch.where(active, dblk, 0),
                slot_offsets=dslot % bs,
                kv_caches=self.draft_kv_caches,
            )
            if d == D:
                break
            if use_penalties:
                dlogits = sampling_lib.apply_penalties_state(
                    dlogits, dcounts, dseen, b["presence"], b["frequency"],
                    b["repetition"])
            if stop_mask is not None:
                dlogits = _ban_stops(dlogits, stop_mask, dmin)
            cur = torch.argmax(dlogits, dim=-1)
            drafts.append(cur)
            if use_penalties:
                # The verifier's append gate: a proposed stop is not counted.
                _count_tokens(dcounts, dseen, cur, active & ~_hits_stop(cur, b["stop_ids"]))
            if stop_mask is not None:
                dmin = torch.clamp(dmin - active.int(), min=0)
        return torch.stack(drafts, dim=1)

    def _draft_prime(self, b, positions, hist) -> torch.Tensor:
        """The draft cache rebuilt from the history in one causal decode
        over S x (H - 1) rows: history column c of a row with ``live``
        entries goes to compact slot c - (H - live) at true position
        positions + 1 - H + c, with ctx slot + 1, so write-then-attend
        makes each row attend exactly the slots before it; left padding
        parks on null block 0.  The committed token is left for the first
        draft forward.  Returns the draft cursor (live - 1)."""
        bs = self.block_pool.block_size
        H = self._SPEC_HIST_WINDOW
        tables = b["draft_tables"]
        dbmax = tables.shape[1]
        live = torch.clamp(positions + 1, max=H)
        cols = torch.arange(H - 1, dtype=torch.int32, device=tables.device)[None, :]
        slots = cols - (H - live)[:, None]
        valid = slots >= 0
        safe = torch.where(valid, slots, 0)
        blk = torch.gather(tables, 1, torch.clamp(safe // bs, 0, dbmax - 1).long())
        llama.decode_kv(
            self.draft_params, self.draft_cfg,
            tokens=torch.clamp(hist[:, :H - 1], min=0).reshape(-1),
            positions=torch.where(valid, positions[:, None] + 1 - H + cols, 0).reshape(-1),
            block_tables=tables.repeat_interleave(H - 1, dim=0),
            ctx_lens=torch.where(valid, slots + 1, 0).reshape(-1),
            slot_block_ids=torch.where(valid, blk, 0).reshape(-1),
            slot_offsets=(safe % bs).reshape(-1),
            kv_caches=self.draft_kv_caches,
        )
        return live - 1

    def _window_host_state(self, seqs: List[Sequence]) -> dict:
        """Host arrays and static flags for a window batch (re)build."""
        S = self._decode_bucket(len(seqs))
        (tokens, positions, tables, ctx_lens, _sb, _so) = (
            self._decode_batch_arrays(seqs, S)
        )
        pad = S - len(seqs)
        done = np.ones((S,), np.int32)
        done[: len(seqs)] = 0
        min_left = np.array(
            [max(0, s.sampling_params.min_tokens - len(s.output_token_ids))
             for s in seqs] + [0] * pad,
            np.int32,
        )

        def per_row(attr, fill):
            return np.array(
                [getattr(s.sampling_params, attr) for s in seqs] + [fill] * pad,
                np.float32,
            )

        presence = per_row("presence_penalty", 0.0)
        frequency = per_row("frequency_penalty", 0.0)
        repetition = per_row("repetition_penalty", 1.0)
        stop_lists = [self._stop_set_ids(s) for s in seqs]
        B = _pow2_bucket(max([len(ids) for ids in stop_lists] + [1]), 1)
        stop_ids = np.full((S, B), -1, np.int32)
        for i, ids in enumerate(stop_lists):
            stop_ids[i, : len(ids)] = ids
        return {
            "S": S, "B": B, "tokens": tokens, "positions": positions,
            "tables": tables, "ctx_lens": ctx_lens, "done": done,
            "min_left": min_left, "presence": presence,
            "frequency": frequency, "repetition": repetition,
            "stop_ids": stop_ids,
            "use_penalties": bool(
                np.any(presence) or np.any(frequency)
                or np.any(repetition != 1.0)
            ),
            "use_min_floor": bool(np.any(min_left > 0)),
            "all_greedy": all(self._host_state_flags(s)[2] for s in seqs),
        }

    def _window_build(self, seqs: List[Sequence]) -> tuple:
        """Full batch (re)build: every window input to its static buffer
        in one packed transfer (plus the occurrence state the penalties
        read).  Returns the graph key; steady-state windows chain through
        :meth:`_window_table_delta` instead."""
        h = self._window_host_state(seqs)
        S = h["S"]
        key = ("window", S, h["B"], h["use_penalties"], h["use_min_floor"],
               h["all_greedy"])
        b = self._buffers_for(
            key, lambda: self._window_buffers(S, h["B"], h["use_penalties"],
                                              h["use_min_floor"])
        )
        temps, top_ps, top_ks, min_ps, seeds = self._sampling_arrays(seqs, S)
        arrays = {
            "tokens": h["tokens"], "positions": h["positions"],
            "ctx_lens": h["ctx_lens"], "done": h["done"],
            "min_left": h["min_left"], "tables": h["tables"],
            "stop_ids": h["stop_ids"], "presence": h["presence"],
            "frequency": h["frequency"], "repetition": h["repetition"],
            "temps": temps, "top_ps": top_ps, "top_ks": top_ks,
            "min_ps": min_ps, "seeds": seeds,
        }
        if "adapter" in b:
            arrays["adapter"] = self._adapter_rows(seqs, S)
        if self._spec_window:
            # The drafters' history: the last H tokens, left -1-padded;
            # windows carry it on the device, only a build transfers it.
            H = self._SPEC_HIST_WINDOW
            hist = np.full((S, H), -1, np.int32)
            for i, s in enumerate(seqs):
                ids = s.all_token_ids[-H:]
                hist[i, H - len(ids):] = ids
            arrays["hist"] = hist
        if self.draft_block_pool is not None:
            arrays.update(self._draft_build(len(seqs), S))
        self._upload(b, arrays)
        if h["use_min_floor"]:
            # Once a build: chained windows keep the rows and their stop sets.
            b["stop_mask"].copy_(self._stop_mask(b))
        if h["use_penalties"]:
            # The occurrence state from the bucketed id arrays (the same
            # content as the host path's arrays, so penalty values match).
            L = _pow2_bucket(max([len(s.output_token_ids) for s in seqs] + [1]), 64)
            Lc = _pow2_bucket(max(len(s.all_token_ids) for s in seqs), 64)
            out_tokens = np.full((S, L), -1, np.int32)
            ctx_tokens = np.full((S, Lc), -1, np.int32)
            for i, s in enumerate(seqs):
                ids = s.output_token_ids[-L:]
                out_tokens[i, : len(ids)] = ids
                ids = s.all_token_ids[-Lc:]
                ctx_tokens[i, : len(ids)] = ids
            counts, seen = sampling_lib.occurrence_state(
                self._put(out_tokens), self._put(ctx_tokens),
                self.config.model.vocab_size,
            )
            b["counts"].copy_(counts)
            b["seen"].copy_(seen)
        self._win_table_lens = [len(s.block_table) for s in seqs]
        return key

    def _draft_build(self, n: int, S: int) -> Dict[str, np.ndarray]:
        """The model drafter's part of a batch build: the previous batch's
        draft blocks freed, fresh ones for its n rows (so a preempted,
        aborted or restored sequence's draft KV never survives: the next
        prime rebuilds it from the history), the cursor at 0.  A pool that
        cannot hold them declines this batch's windows to plain ones."""
        self._draft_primed = False
        if self._draft_block_alloc:
            self.draft_block_pool.free(self._draft_block_alloc)
            self._draft_block_alloc = []
        bd = self._draft_blocks_per_row
        tables = np.zeros((S, bd), np.int32)
        self._draft_tables_ok = self.draft_block_pool.can_allocate(n * bd)
        if self._draft_tables_ok:
            self._draft_block_alloc = self.draft_block_pool.allocate(n * bd)
            tables[:n] = np.asarray(self._draft_block_alloc, np.int32).reshape(n, bd)
        return {"draft_tables": tables, "draft_pos": np.zeros((S,), np.int32)}

    def _window_table_delta(self, seqs: List[Sequence], S: int):
        """The block-table columns each row gained since the device tables
        were last written (cols, vals [S, C]; col -1 = no growth): all a
        chained window transfers besides its budgets, since its carry is
        the previous window's, still in flight on the device."""
        C = self._win_delta_cols
        cols = np.full((S, C), -1, np.int32)
        vals = np.zeros((S, C), np.int32)
        for i, seq in enumerate(seqs):
            have = self._win_table_lens[i]
            new = seq.block_table[have:][:C]
            cols[i, : len(new)] = np.arange(have, have + len(new))
            vals[i, : len(new)] = new
            self._win_table_lens[i] = have + len(new)
        return cols, vals

    def _dispatch_window(self, plan, chain_from: Optional[_PendingStep] = None
                         ) -> _PendingStep:
        """Enqueue one K-step decode window and return without a host
        round-trip.  ``chain_from=None`` (re)builds the static window state
        from host bookkeeping; otherwise the window continues from the
        previous window's in-flight carry (the device never drains between
        them).  Either way one [S(1+2C)+1] delta (budgets, table growth,
        key base) transfers, then one replay and one copy of the emitted
        tokens into this step's pinned host buffer."""
        t0 = time.time()
        seqs = plan.decode.seqs
        gap = self._recorder_gap(t0) if self.obs.enabled else 0.0
        if chain_from is None:
            key = self._window_build(seqs)
            self._note_decode_launch()
        else:
            key = chain_from.win_key
            self._note_lookahead_launch()
            self.windows_chained += 1
        S = key[1]
        cols, vals = self._window_table_delta(seqs, S)
        b = self._buffers[key]
        max_steps = np.zeros((S,), np.int32)
        max_steps[: len(plan.decode.steps)] = plan.decode.steps
        b["delta"].copy_(self._put(np.concatenate([
            max_steps, cols.ravel(), vals.ravel(),
            np.array([self._key_seed()], np.int32),
        ])))
        drafter = self._spec_drafter_for(key)
        if drafter is None:
            # Any other window advances positions without extending the
            # draft cache: the next model-drafter window re-primes.
            self._draft_primed = False
            self.graphs.run(key, lambda: self._window_body(b, *key[3:]))
            host, ready = kv_quant.stage_to_host(b["emitted"])
        else:
            # Re-prime after any break in the chain and every
            # _DRAFT_PRIME_CHAIN windows (the draft pool's row capacity).
            do_prime = drafter == "model" and (
                not self._draft_primed
                or self._draft_windows_since_prime >= self._DRAFT_PRIME_CHAIN
            )
            skey = ("spec",) + key[1:] + (drafter, self._spec_len + 1, do_prime)
            self.graphs.run(skey, lambda: self._spec_body(b, key[3], key[4], do_prime))
            host, ready = kv_quant.stage_to_host(b["spec_out"])
            if drafter == "model":
                self._draft_windows_since_prime = (
                    0 if do_prime else self._draft_windows_since_prime + 1
                )
                self._draft_primed = True
        # One step ordinal per iteration: single-token stepping would use
        # exactly these seeds for the same tokens (a greedy speculative
        # window draws none, and advances the counter all the same).
        self._step_counter += self._window_steps
        self.windows_dispatched += 1
        rec = None
        if self.obs.enabled:
            depth = 0
            if chain_from is not None and chain_from.rec is not None:
                depth = chain_from.rec.chain_depth + 1
            sids = tuple(s.seq_id for s in seqs)
            rec = self.obs.recorder.on_dispatch(
                "spec" if drafter is not None else "decode",
                k=self._window_steps, rows=len(seqs), seq_ids=sids,
                chain_depth=depth, provisional=chain_from is not None,
                spec_width=(self.config.scheduler.spec_draft_len
                            if drafter is not None else 0),
                drafter=drafter or "",
                fallback=plan.window_fallback, host_gap_s=gap, now=t0,
            )
            self._note_compiles(sids, rec)
        return _PendingStep(
            seqs=list(seqs), host=host, ready=ready, is_decode=True,
            host_s=time.time() - t0, steps=list(plan.decode.steps),
            win_key=key, spec_drafter=drafter, rec=rec,
        )

    def _spec_drafter_for(self, key: tuple) -> Optional[str]:
        """The drafter a window of this key runs: speculation only for
        all-greedy batches (acceptance compares the argmax), so a sampled
        batch takes the plain window with its per-iteration seeds; a
        model-drafter batch whose build found no draft blocks declines to
        a plain window, counted as ``multistep_fallback["draft_pool"]``
        once a dispatch."""
        if not self._spec_window or not key[5]:
            return None
        if self.draft_params is None:
            return "ngram"
        if not self._draft_tables_ok:
            self.multistep_fallback["draft_pool"] = (
                self.multistep_fallback.get("draft_pool", 0) + 1
            )
            return None
        return "model"

    # -- mixed K-step windows ------------------------------------------------

    def _chunk_buffers(self, T: int) -> Dict[str, torch.Tensor]:
        """A mixed window's chunk schedule for chunk bucket T, one row an
        iteration, and the device counter that picks the row: each replay
        of the iteration graph reads row ``iter`` and advances it."""
        dev = self.device
        K = self._window_steps
        i32 = dict(dtype=torch.int32, device=dev)
        return {
            "iter": torch.zeros(1, dtype=torch.int64, device=dev),
            "tokens": torch.zeros((K, T), **i32),
            "cached": torch.zeros(K, **i32),
            "valid": torch.zeros(K, **i32),
            "new_blocks": torch.zeros((K, T // self.block_pool.block_size), **i32),
            "prefix": torch.zeros((K, max(self._bmax, 1)), **i32),
            # Each iteration's chunk tail logits (the last valid row).
            "tails": torch.zeros((K, self.config.model.vocab_size),
                                 dtype=torch.float32, device=dev),
            # Each iteration's chunk's LoRA slot (its T rows share it).
            **({"adapter": torch.zeros(K, **i32)} if self.lora_registry else {}),
        }

    def _mixed_body(self, b: Dict[str, torch.Tensor], c: Dict[str, torch.Tensor],
                    use_penalties: bool, use_min_floor: bool,
                    all_greedy: bool) -> None:
        """One iteration of a mixed K-step window (the scan body of the JAX
        engine's ``mixed_window``): the fused [S decode rows + T chunk rows]
        forward, the decode rows advancing the window carry ``b`` exactly
        as :meth:`_window_body` does, the chunk at row ``iter`` of the
        schedule ``c`` (its tokens, cached and valid lengths, new blocks
        and prefix table, all read on the device).  The chunk's tail
        logits go to row ``iter`` of ``c["tails"]``, the decode rows'
        tokens to row ``iter`` of ``emitted``; then ``iter`` advances."""
        bs = self.block_pool.block_size
        max_steps, key_base = self._apply_window_delta(b)
        t = c["iter"]

        def row(name):
            return c[name].index_select(0, t)

        carry = tuple(b[name] for name in self._CARRY)
        tokens, positions, ctx_lens, done, _ = carry
        active = ~done & (t < max_steps)
        blk = torch.gather(b["tables"], 1, (positions // bs).long()[:, None])[:, 0]
        rows = None
        if "adapter" in c:  # [S decode rows + T chunk rows sharing one slot]
            rows = torch.cat([b["adapter"],
                              row("adapter").expand(c["tokens"].shape[1])])
        logits = llama.mixed_step(
            self.params, self.config.model,
            dec_tokens=tokens,
            dec_positions=positions,
            dec_block_tables=b["tables"],
            dec_ctx_lens=ctx_lens,
            dec_slot_block_ids=torch.where(active, blk, 0),
            dec_slot_offsets=positions % bs,
            pf_tokens=row("tokens")[0],
            pf_cached_len=row("cached"),
            pf_prefix_block_ids=row("prefix")[0],
            pf_new_block_ids=row("new_blocks")[0],
            pf_valid_len=row("valid"),
            kv_caches=self.kv_caches,
            **self._lora_kwargs(rows),
        )
        S = tokens.shape[0]
        c["tails"].index_copy_(0, t, logits[S:])
        stop_mask = b["stop_mask"] if use_min_floor else None
        carry = self._sample_and_advance(
            b, logits[:S], t, active, carry, key_base, stop_mask,
            use_penalties, all_greedy,
        )
        if self._spec_window:
            # Keep the drafters' history warm: one committed token an
            # active row.
            hist = b["hist"]
            H = hist.shape[1]
            cat = torch.cat([hist, torch.where(active, carry[0], 0)[:, None].to(hist.dtype)], dim=1)
            hidx = torch.arange(H, device=hist.device)[None, :] + active.long()[:, None]
            b["hist"].copy_(torch.gather(cat, 1, hidx))
        for name, value in zip(self._CARRY, carry):
            b[name].copy_(value)
        c["iter"].add_(1)

    def _dispatch_mixed_window(self, plan, chain_from: Optional[_PendingStep] = None
                               ) -> _PendingStep:
        """Enqueue one mixed K-step window of k_eff = len(plan.chunk_schedule)
        iterations and return without a host round-trip (the JAX engine's
        ``_dispatch_mixed_window``).  The decode rows' carry is built or
        chained as in :meth:`_dispatch_window` (mixed and plain windows of
        one (S, stop width, flags) share it); the chunk schedule, one
        cursor an iteration (packed windows switch prompts between
        iterations; the prefix row is the prompt's prefix blocks then its
        new blocks), goes to the static chunk buffers in the same
        transfer as the delta.  Then k_eff replays of the one-iteration
        graph: the JAX scan's dead power-of-two iterations change nothing
        but the null block, so none runs.  Right after, the emitted
        [k_eff, S] tokens go to this step's pinned host buffer and, when a
        chunk is final, the iterations' tail logits to this step's own
        device copy: the next window rewrites both static buffers."""
        t0 = time.time()
        seqs = plan.decode.seqs
        sched = plan.chunk_schedule
        k_eff = len(sched)
        gap = self._recorder_gap(t0) if self.obs.enabled else 0.0
        if self.obs.enabled:
            for cp in sched:
                if cp.seq.first_scheduled_time is None:
                    cp.seq.first_scheduled_time = t0
                    self.obs.on_first_scheduled(cp.seq, t0)
        if chain_from is None:
            key = self._window_build(seqs)
            self._note_decode_launch()
        else:
            key = chain_from.win_key
            self._note_lookahead_launch()
            self.mixed_windows_chained += 1
        # Mixed windows advance positions without extending the draft
        # cache: the next model-drafter window re-primes.
        self._draft_primed = False
        S = key[1]
        cols, vals = self._window_table_delta(seqs, S)
        b = self._buffers[key]
        t_stage = time.time()
        T = sched[0].bucket_len
        c = self._buffers_for(("chunk", T), lambda: self._chunk_buffers(T))
        K = self._window_steps
        tokens = np.zeros((K, T), np.int32)
        cached = np.zeros((K,), np.int32)
        valid = np.zeros((K,), np.int32)
        new_blocks = np.zeros(tuple(c["new_blocks"].shape), np.int32)
        prefix = np.zeros(tuple(c["prefix"].shape), np.int32)
        adapter = np.zeros((K,), np.int32)
        for i, cp in enumerate(sched):
            toks = cp.seq.prompt_token_ids[cp.cached_len:cp.cached_len + cp.num_new_tokens]
            tokens[i, :len(toks)] = toks
            cached[i] = cp.cached_len
            valid[i] = cp.num_new_tokens
            new_blocks[i, :len(cp.new_block_ids)] = cp.new_block_ids
            full = list(cp.prefix_block_ids) + list(cp.new_block_ids)
            prefix[i, :len(full)] = full
            adapter[i] = cp.seq.adapter_idx
        max_steps = np.zeros((S,), np.int32)
        max_steps[: len(plan.decode.steps)] = plan.decode.steps
        delta = np.concatenate([max_steps, cols.ravel(), vals.ravel(),
                                np.array([self._key_seed()], np.int32)])
        lora = "adapter" in c
        self._upload(
            {"delta": b["delta"], "iter": c["iter"], "tokens": c["tokens"],
             "cached": c["cached"], "valid": c["valid"],
             "new_blocks": c["new_blocks"], "prefix": c["prefix"],
             **({"adapter": c["adapter"]} if lora else {})},
            {"delta": delta, "iter": np.zeros((1,), np.int32), "tokens": tokens,
             "cached": cached, "valid": valid, "new_blocks": new_blocks,
             "prefix": prefix, **({"adapter": adapter} if lora else {})},
        )
        overlap_s = 0.0
        if chain_from is not None:
            # The previous window still runs on the device: this staging
            # overlapped its compute.
            overlap_s = time.time() - t_stage
            self.window_transfer_overlap_s += overlap_s
        mkey = ("mixed", S, T) + key[2:]
        for _ in range(k_eff):
            self.graphs.run(mkey, lambda: self._mixed_body(b, c, *key[3:]))
        host, ready = kv_quant.stage_to_host(b["emitted"][:k_eff])
        tails = c["tails"][:k_eff].clone() if any(cp.is_final for cp in sched) else None
        # A final chunk at iteration i is the K=1 world's step (base + i):
        # its first token burns that ordinal at collect.
        ordinal = self._step_counter
        self._step_counter += k_eff
        self.mixed_windows_dispatched += 1
        self.mixed_window_iterations += k_eff
        rec = None
        if self.obs.enabled:
            depth = 0
            if chain_from is not None and chain_from.rec is not None:
                depth = chain_from.rec.chain_depth + 1
            sids = tuple(s.seq_id for s in seqs) + tuple(
                dict.fromkeys(cp.seq.seq_id for cp in sched)
            )
            rec = self.obs.recorder.on_dispatch(
                "mixed", k=k_eff, rows=len(seqs), seq_ids=sids,
                chain_depth=depth, provisional=chain_from is not None,
                chunk_prompts=len({cp.seq.seq_id for cp in sched}),
                chunk_tokens_planned=sum(cp.num_new_tokens for cp in sched),
                fallback=plan.window_fallback, host_gap_s=gap,
                transfer_overlap_s=overlap_s, now=t0,
            )
            self._note_compiles(sids, rec)
        return _PendingStep(
            seqs=list(seqs), host=host, ready=ready, is_decode=True,
            host_s=time.time() - t0, steps=list(plan.decode.steps),
            win_key=key, chunk_sched=list(sched), chunk_tails=tails,
            chunk_ordinal=ordinal, rec=rec,
        )

    def _collect_chunks(self, p: _PendingStep) -> tuple:
        """The chunk half of a mixed window's collect: account the chunk
        tokens that rode the window and finalize each packed prompt whose
        final chunk landed, through :meth:`_finalize_final_prefill` with
        its iteration's step ordinal, as the K=1 mixed step would.  A
        prompt aborted while the window flew skips its finalize and its
        chunk tokens count as waste; the other prompts are unaffected.
        Returns (outputs, chunk tokens delivered)."""
        by_seq = []  # [(seq, [(iteration, chunk), ...])] in order
        for i, cp in enumerate(p.chunk_sched):
            if by_seq and by_seq[-1][0] is cp.seq:
                by_seq[-1][1].append((i, cp))
            else:
                by_seq.append((cp.seq, [(i, cp)]))
        outputs: List[StepOutput] = []
        delivered = 0
        for seq, chunks in by_seq:
            n = sum(cp.num_new_tokens for _, cp in chunks)
            if seq.is_finished:
                self.multistep_wasted_tokens += n
                continue
            self.prefill_chunk_tokens += n
            self.mixed_window_chunk_tokens += n
            delivered += n
            for i, cp in chunks:
                if cp.is_final:
                    outputs.extend(self._finalize_final_prefill(
                        seq, p.chunk_tails[i], step_ordinal=p.chunk_ordinal + i,
                    ))
        self.mixed_window_prompts_hist.observe(len(by_seq))
        return outputs, delivered

    def _collect_window(self, p: _PendingStep) -> List[StepOutput]:
        """Read one window's [K, S] emitted tokens (a speculative window's
        [K, W, S], in emission order) and replay them through the finish
        protocol token by token, as single stepping would.  Frozen rows
        emitted -1 (their stop already retired); tokens of rows that
        finished while the window flew (abort) count as multistep waste,
        and for a speculative window as its wasted tokens beside the
        drafts it accepted and rejected."""
        t_sync = time.time()
        arr = p.read()
        sync_s = time.time() - t_sync
        if self.obs.enabled:
            self.obs.step_phase("collect", sync_s)
        t_post = time.time()
        spec = p.spec_drafter is not None
        if spec:
            W = self._spec_len + 1
            drafts = arr[:, W:, : len(p.seqs)]
            arr = arr[:, :W].reshape(-1, arr.shape[-1])  # [K * W, S]
        outputs: List[StepOutput] = []
        delivered = [0] * len(p.seqs)
        alive = [(i, s) for i, s in enumerate(p.seqs) if not s.is_finished]
        for t in range(arr.shape[0]):
            batch, toks = [], []
            for i, s in alive:
                if delivered[i] >= p.steps[i]:
                    continue  # token budget exhausted
                tok = int(arr[t, i])
                if tok < 0:
                    continue  # frozen row
                batch.append((i, s))
                toks.append(tok)
            if not batch:
                if spec:
                    # A row that accepted fewer drafts than another pads
                    # its iteration with -1: not the end of the window.
                    continue
                break  # done and budget masks are monotone in a window
            outputs.extend(self._append_and_check(
                [s for _, s in batch], toks, first_token=False
            ))
            for i, _ in batch:
                delivered[i] += 1
            alive = [(i, s) for i, s in alive if not s.is_finished]
        emitted = int((arr[:, : len(p.seqs)] >= 0).sum())
        wasted = emitted - sum(delivered)
        self.multistep_wasted_tokens += wasted
        drafted = accepted = chunk_delivered = 0
        if spec:
            drafted, accepted = int(drafts[:, 0].sum()), int(drafts[:, 1].sum())
            self.spec_tokens_drafted += drafted
            self.spec_tokens_accepted += accepted
            self.spec_window_tokens["accepted"] += accepted
            self.spec_window_tokens["rejected"] += drafted - accepted
            self.spec_window_tokens["wasted"] += wasted
            if p.spec_drafter == "model":
                # A floor: a pipelined window's wait hides part of it.
                self.spec_draft_fraction_s += self._draft_cost_fraction * sync_s
        if p.chunk_sched is not None:
            chunk_outputs, chunk_delivered = self._collect_chunks(p)
            outputs.extend(chunk_outputs)
        if self.obs.enabled:
            self.obs.step_phase("sample", time.time() - t_post)
        if p.rec is not None:
            # A final chunk's first-token sample ran above: drain its
            # compile events onto this record, then complete it.
            self._note_compiles([s.seq_id for s in p.seqs], p.rec)
            self.obs.recorder.on_collect(
                p.rec, host_s=p.host_s,
                tokens_emitted=emitted, tokens_delivered=emitted - wasted,
                tokens_wasted=wasted, chunk_tokens_delivered=chunk_delivered,
                drafted=drafted, accepted=accepted,
            )
        return outputs

    # -- synchronous steps ---------------------------------------------------

    def _run_prefill(self, plan: PrefillPlan) -> List[StepOutput]:
        seq = plan.seq
        if self.obs.enabled and seq.first_scheduled_time is None:
            seq.first_scheduled_time = time.time()
            self.obs.on_first_scheduled(seq, seq.first_scheduled_time)
        tokens, new_block_ids, prefix_ids, lens = self._prefill_plan_arrays(plan)
        if self.lora_registry is not None:
            lens = np.append(lens, np.int32(seq.adapter_idx))  # up in one copy
        lens = self._put(lens)
        sp = seq.sampling_params
        want_plp = sp.echo and sp.logprobs
        plp_kwargs = {}
        if want_plp:
            # Row t's target is the next prompt token (absolute position
            # cached_len + t + 1); rows at or past the prompt's tail target
            # 0 and their entries are discarded.
            targets = np.zeros((len(tokens),), np.int32)
            m = min(plan.num_new_tokens,
                    len(seq.prompt_token_ids) - plan.cached_len - 1)
            if m > 0:
                targets[:m] = seq.prompt_token_ids[
                    plan.cached_len + 1 : plan.cached_len + 1 + m
                ]
            # A fixed k, as the JAX engine's (a static jit argument there);
            # _collect_prompt_logprobs slices to the request's k.
            plp_kwargs = {"prompt_targets": self._put(targets), "prompt_topk": 20}
        out = llama.prefill(
            self.params, self.config.model,
            tokens=self._put(tokens),
            cached_len=lens[:1],
            prefix_block_ids=self._put(prefix_ids),
            new_block_ids=self._put(new_block_ids),
            valid_len=lens[1:2],
            kv_caches=self.kv_caches,
            sp=self.mesh.sp,
            sp_mode=self.config.parallel.sequence_parallel_mode,
            sp_group=self.mesh.sp_group,
            **plp_kwargs,
            **self._lora_kwargs(lens[2:]),
        )
        if want_plp:
            logits, plp = out
            self._collect_prompt_logprobs(seq, plan, plp)
        else:
            logits = out
        if not plan.is_final:
            # Non-final chunk of a long prompt: KV is written, the logits
            # are mid-prompt — nothing to sample yet.
            return []
        outputs = self._finalize_final_prefill(seq, logits)
        if want_plp and outputs and seq.prompt_lp is not None:
            # The assembled per-position entries ride the request's first
            # event (position 0 has no predictor: None).
            outputs[0].prompt_logprobs = [(None, None)] + [
                seq.prompt_lp.get(pos, (None, None))
                for pos in range(1, seq.echo_prompt_len)
            ]
        return outputs

    def _collect_prompt_logprobs(self, seq: Sequence, plan: PrefillPlan, plp) -> None:
        """Stitch one chunk's (target_lp [T], top_ids [T, k], top_lps
        [T, k]) into the sequence's absolute-position map (a prompt longer
        than the largest bucket arrives in several chunks)."""
        tlp, top_ids, top_lps = (t.cpu().numpy() for t in plp)
        if seq.prompt_lp is None:
            seq.prompt_lp = {}
        k = min(seq.sampling_params.top_logprobs or 0, top_ids.shape[1])
        for t in range(plan.num_new_tokens):
            pos = plan.cached_len + t + 1  # the entry of the predicted token
            if pos >= seq.echo_prompt_len:
                break
            pairs = (
                [(int(top_ids[t, j]), float(top_lps[t, j])) for j in range(k)]
                if k else None
            )
            seq.prompt_lp[pos] = (float(tlp[t]), pairs)

    def _prefill_plan_arrays(self, plan: PrefillPlan):
        """(tokens [T], new_block_ids [T//bs], prefix_ids [Bmax], lengths
        [cached_len, valid_len]) host arrays for one PrefillPlan: the
        prefix ids padded to the block-table width, as in the JAX engine
        (the kernel reads the first cached_len tokens through them and
        never walks the padding)."""
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
        prefix_ids = np.zeros((max(self._bmax, 1),), np.int32)
        prefix_ids[: len(plan.prefix_block_ids)] = plan.prefix_block_ids
        lens = np.array([plan.cached_len, plan.num_new_tokens], np.int32)
        return tokens, new_block_ids, prefix_ids, lens

    def _finalize_final_prefill(
        self, seq: Sequence, last_logits: torch.Tensor,
        step_ordinal: Optional[int] = None,
    ) -> List[StepOutput]:
        """Shared tail of every final prefill: the max_tokens == 0 scoring
        sentinel, or the request's first token sampled from the last valid
        row's logits [V].  A mixed window's final chunk passes
        ``step_ordinal``, the K=1 step its iteration stands for, whose seed
        the draw must take instead of the live step counter's.  An
        exporting engine (disagg role prefill / both) first pushes the
        prompt's full blocks to the store."""
        if self._exports:
            self._export_prefix_blocks(seq)
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
        token_ids, logprob_info = self._sample_batch(
            last_logits[None, :], [seq], step_ordinal=step_ordinal
        )
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
        """Decode batch sizes: the smallest bucket of the (dp, 2dp, 4dp,
        ...) set holding ``n`` rows, capped at max_num_seqs, as in the JAX
        engine: each dp position holds S/dp contiguous rows
        (``shardings.decode_batch_spec``)."""
        return min(_pow2_bucket(n, max(1, self.config.parallel.data_parallel)), self._smax)

    def _run_decode(self, plan: DecodePlan) -> List[StepOutput]:
        seqs = plan.seqs
        # The legacy speculative path: greedy rows without host-state
        # features only (acceptance compares the argmax); any other batch
        # takes a plain step.
        if self._legacy_spec and all(
            s.sampling_params.temperature <= 0
            and not s.sampling_params.presence_penalty
            and not s.sampling_params.frequency_penalty
            and s.sampling_params.repetition_penalty == 1.0
            and not s.sampling_params.min_tokens
            and not s.sampling_params.logprobs
            and not s.sampling_params.logit_bias
            and s.guide is None
            for s in seqs
        ):
            return self._run_decode_speculative(plan, self._legacy_spec)
        S = self._decode_bucket(len(seqs))
        (tokens, positions, block_tables, ctx_lens, slot_blocks,
         slot_offsets) = self._decode_batch_arrays(seqs, S)
        self._note_decode_launch()
        logits = llama.decode(
            self.params, self.config.model,
            tokens=self._put(tokens),
            positions=self._put(positions),
            block_tables=self._put(block_tables),
            ctx_lens=self._put(ctx_lens),
            slot_block_ids=self._put(slot_blocks),
            slot_offsets=self._put(slot_offsets),
            kv_caches=self.kv_caches,
            **self._lora_kwargs(self._adapter_rows(seqs, S)),
        )
        token_ids, logprob_info = self._sample_batch(logits[: len(seqs)], seqs)
        return self._append_and_check(
            seqs, token_ids, first_token=False, logprob_info=logprob_info
        )

    @classmethod
    def _draft_ngram(cls, seq: Sequence, k: int, n: int = 2) -> List[int]:
        """Prompt-lookup drafting: the k tokens that followed the most
        recent earlier occurrence of the trailing n-gram, within
        ``_DRAFT_SCAN_WINDOW`` tokens of the sequence's own history; empty
        when none (the step is then a plain decode)."""
        hist = seq.all_token_ids
        if len(hist) < n + 1:
            return []
        key = tuple(hist[-n:])
        lo = max(0, len(hist) - n - 1 - cls._DRAFT_SCAN_WINDOW)
        for start in range(len(hist) - n - 1, lo - 1, -1):
            if tuple(hist[start:start + n]) == key:
                return list(hist[start + n:start + n + k])
        return []

    def _run_decode_speculative(self, plan: DecodePlan, k: int) -> List[StepOutput]:
        """The legacy host path: up to k host-drafted tokens a sequence
        verified in one decode over S x (k+1) rows.  Row j of a sequence
        consumes the token at position pos0 + j (the last real token, then
        the drafts) with ctx num_tokens + j, so the decode's
        write-then-attend makes it see rows < j.  The argmax of every row
        is read once (this path's one sync); each sequence takes its
        longest agreeing draft prefix, then the model's own next token.
        Rejected rows' KV lies past the accepted tokens, overwritten
        before any row attends it."""
        seqs = plan.seqs
        S = self._decode_bucket(len(seqs))
        W = k + 1
        R = S * W
        bs = self.block_pool.block_size
        tokens = np.zeros((R,), np.int32)
        positions = np.zeros((R,), np.int32)
        block_tables = np.zeros((R, self._bmax), np.int32)
        ctx_lens = np.zeros((R,), np.int32)
        slot_blocks = np.zeros((R,), np.int32)
        slot_offsets = np.zeros((R,), np.int32)
        drafts: List[List[int]] = []
        for i, seq in enumerate(seqs):
            # Drafts fit the plan's budget (blocks back steps[i] tokens).
            nd = min(k, plan.steps[i] - 1)
            draft = self._draft_ngram(seq, nd) if nd > 0 else []
            drafts.append(draft)
            pos0 = seq.num_tokens - 1
            table = seq.block_table[: self._bmax]
            for j, tok in enumerate([seq.all_token_ids[-1]] + draft):
                r = i * W + j
                tokens[r] = tok
                positions[r] = pos0 + j
                block_tables[r, : len(table)] = table
                ctx_lens[r] = seq.num_tokens + j
                slot_blocks[r] = seq.block_table[(pos0 + j) // bs]
                slot_offsets[r] = (pos0 + j) % bs
            # Rows past the chain stay dead: null block 0, ctx 0.
        self._note_decode_launch()
        logits = llama.decode(
            self.params, self.config.model,
            tokens=self._put(tokens),
            positions=self._put(positions),
            block_tables=self._put(block_tables),
            ctx_lens=self._put(ctx_lens),
            slot_block_ids=self._put(slot_blocks),
            slot_offsets=self._put(slot_offsets),
            kv_caches=self.kv_caches,
            **self._lora_kwargs(self._adapter_rows(seqs, S, W)),
        )
        greedy = torch.argmax(logits, dim=-1).tolist()  # the step's device read
        outputs: List[StepOutput] = []
        for i, seq in enumerate(seqs):
            base, draft = i * W, drafts[i]
            m = 0
            while m < len(draft) and greedy[base + m] == draft[m]:
                m += 1
            self.spec_tokens_drafted += len(draft)
            self.spec_tokens_accepted += m
            for tok in draft[:m] + [greedy[base + m]]:
                outs = self._append_and_check([seq], [tok], first_token=False)
                outputs.extend(outs)
                if outs and outs[0].finished:
                    break
        return outputs

    def _run_mixed(self, step_plan) -> List[StepOutput]:
        """One fused step over the packed [decode bucket + chunk bucket]
        token batch: every running sequence decodes as in _run_decode, and
        the head waiting sequence's prefill chunk rides along.  Decode rows
        are sampled first; only a final chunk samples its last valid row,
        through _finalize_final_prefill, as _run_prefill does."""
        t_start = time.time()
        plan = step_plan.prefill_chunk
        seqs = step_plan.decode.seqs
        if self.obs.enabled and plan.seq.first_scheduled_time is None:
            plan.seq.first_scheduled_time = t_start
            self.obs.on_first_scheduled(plan.seq, t_start)
        S = self._decode_bucket(len(seqs))
        (tokens, positions, block_tables, ctx_lens, slot_blocks,
         slot_offsets) = self._decode_batch_arrays(seqs, S)
        pf_tokens, pf_new_blocks, pf_prefix, pf_lens = self._prefill_plan_arrays(plan)
        pf_lens = self._put(pf_lens)
        # [S decode rows + T chunk rows sharing the chunk's slot]
        rows = np.concatenate([self._adapter_rows(seqs, S),
                               np.full(len(pf_tokens), plan.seq.adapter_idx, np.int32)])
        logits = llama.mixed_step(
            self.params, self.config.model,
            dec_tokens=self._put(tokens),
            dec_positions=self._put(positions),
            dec_block_tables=self._put(block_tables),
            dec_ctx_lens=self._put(ctx_lens),
            dec_slot_block_ids=self._put(slot_blocks),
            dec_slot_offsets=self._put(slot_offsets),
            pf_tokens=self._put(pf_tokens),
            pf_cached_len=pf_lens[:1],
            pf_prefix_block_ids=self._put(pf_prefix),
            pf_new_block_ids=self._put(pf_new_blocks),
            pf_valid_len=pf_lens[1:],
            kv_caches=self.kv_caches,
            **self._lora_kwargs(rows),
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
        if self.obs.enabled:
            self.obs.step_phase("mixed", time.time() - t_start)
        return outputs

    # -- sampling ----------------------------------------------------------

    def _stop_set_ids(self, seq: Sequence) -> tuple:
        """The per-sequence stop set: ``stop_token_ids`` plus EOS unless
        ``ignore_eos`` — what ends generation at sampling time, and
        exactly what an unmet min_tokens floor suppresses (the window's
        device stop mask and the host path's ban share it).  Out-of-vocab
        ids can never be sampled and are dropped."""
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
        seeds = np.array([
            s.sampling_params.seed if s.sampling_params.seed is not None else idx
            for idx, s in enumerate(seqs)
        ] + [0] * pad, np.int32)
        return temps, top_ps, top_ks, min_ps, seeds

    def _sample_batch(self, logits: torch.Tensor, seqs: List[Sequence],
                      step_ordinal: Optional[int] = None):
        """Returns (token_ids, logprob_info): penalties, logit_bias and the
        min_tokens ban on the fp32 logits, then greedy/sampled choice with
        the step seed of ``step_ordinal`` (default: the live step
        counter); logprob_info holds None or (chosen_logprob, [(token_id,
        logprob), ...]) per sequence."""
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
            L = _pow2_bucket(max_len, 64)
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
                Lc = _pow2_bucket(max(len(s.all_token_ids) for s in seqs), 64)
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
            step_seed=self._put(np.array([self._key_seed(step_ordinal)], np.int32)),
            seq_seeds=self._put(seeds),
            min_p=self._put(min_ps),
            all_greedy=all(s.sampling_params.temperature <= 0 for s in seqs),
        )
        token_ids = out[: len(seqs)].tolist()  # the step's device read
        any_logprobs = any(s.sampling_params.logprobs for s in seqs)
        if any(s.guide is not None for s in seqs):
            token_ids = self._guided_override(logits, seqs, token_ids)
            if any_logprobs:
                # The logprobs gather below reads the constrained choices.
                out = self._put(np.array(token_ids + [0] * pad, np.int32))

        logprob_info: List = [None] * len(seqs)
        if any_logprobs:
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

    def _guided_live_mask(self, V: int) -> np.ndarray:
        """[V] bool: the ids a guide could accept, those with text and EOS
        (an id with no text never advances an automaton), decoded once."""
        if self._guided_live is None or len(self._guided_live) != V:
            live = np.array([bool(self._token_texts.text(t)) for t in range(V)])
            eos = self.tokenizer.eos_token_id
            if eos is not None and 0 <= eos < V:
                live[eos] = True
            self._guided_live = live
        return self._guided_live

    def _guided_override(self, logits: torch.Tensor, seqs: List[Sequence],
                         token_ids: List[int]) -> List[int]:
        """Constrained choice for guided sequences (engine/guided.py), as
        the JAX engine makes it: the device's pick is kept when the
        automaton accepts it; otherwise candidates are checked in
        descending-logit order (post bias and penalties) and the best valid
        one replaces it, or with temperature one of the first 8 valid ones
        is drawn from a per-sequence numpy stream.  A completed JSON value
        forces EOS.  The guided rows' logits come back in one copy, at the
        first row whose pick does not fit."""
        cache = self._token_texts
        eos = self.tokenizer.eos_token_id or 0
        out = list(token_ids)
        rows = None  # guided row index -> host logits [V]
        for i, seq in enumerate(seqs):
            guide = seq.guide
            if guide is None:
                continue
            if guide.done:
                out[i] = eos
                continue
            # Budget-aware closing: near the bytes needed to close the
            # value, admit only closure-reducing tokens so it completes
            # instead of truncating (a token is >= 1 byte).
            sp = seq.sampling_params
            remaining = min(
                sp.max_tokens - seq.num_generated,
                self.config.scheduler.max_model_len - seq.num_tokens,
            )
            guide.closing = remaining <= guide.closure_cost() + 4
            # Fast path: the unconstrained choice usually fits.  EOS at a
            # may-finish point is a valid choice to end.
            if out[i] == eos and guide.may_finish():
                guide.finalize()
                continue
            fast_bytes = cache.text(out[i]).encode()
            st = guide.try_token(fast_bytes)
            if st is not None and out[i] != eos:
                guide.accept(st, fast_bytes)
                continue
            if rows is None:
                idx = [j for j, s in enumerate(seqs)
                       if s.guide is not None and not s.guide.done]
                rows = dict(zip(idx, logits[idx].float().cpu().numpy()))
            row = rows[i]
            live = self._guided_live_mask(len(row))
            # Valid tokens sit at the top of the distribution in practice:
            # scan an argpartitioned top slice first and pay the full sort
            # only when it has none.  Ids that cannot be valid are skipped.
            want = 1 if sp.temperature <= 0 else 8
            valid: List = []
            for scope in (64, len(row)):
                if scope >= len(row):
                    order = np.argsort(-row)
                else:
                    top = np.argpartition(-row, scope)[:scope]
                    order = top[np.argsort(-row[top])]
                for tid in order[live[order]].tolist():
                    if tid == eos:
                        if guide.may_finish():
                            valid.append((tid, "FINISH"))
                            if len(valid) >= want:
                                break
                        continue
                    st = guide.try_token(cache.text(tid).encode())
                    if st is not None:
                        valid.append((tid, st))
                        if len(valid) >= want:
                            break
                if valid:
                    break
            if not valid:
                # No token makes progress: end the request rather than loop.
                logger.warning(
                    "guided decoding: no valid continuation for %s", seq.seq_id
                )
                out[i] = eos
                continue
            if len(valid) == 1:
                tid, st = valid[0]
            else:
                lps = np.array([row[t] for t, _ in valid], np.float64)
                lps = lps / max(sp.temperature, 1e-5)
                p = np.exp(lps - lps.max())
                p /= p.sum()
                rng = np.random.default_rng(
                    # A stream a sequence: co-batched guided choices (the
                    # n > 1 fan-out) must not collapse to the same picks.
                    (sp.seed if sp.seed is not None else 0) * 1000003
                    + self._step_counter * 31
                    + zlib.crc32(seq.seq_id.encode())
                )
                tid, st = valid[int(rng.choice(len(valid), p=p))]
            if st == "FINISH":
                guide.finalize()
            else:
                guide.accept(st, cache.text(tid).encode())
            out[i] = tid
        return out

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
                if seq._min_tok_pending and (
                    len(seq.output_token_ids) >= sp.min_tokens
                ):
                    # The one boundary crossing of the cached verdict.
                    seq._min_tok_pending = False
            if seq.first_token_time is None:
                seq.first_token_time = now
                if self.obs.enabled:
                    self.obs.on_first_token(seq, now)
            elif self.obs.enabled and seq.last_token_time is not None:
                self.obs.on_token_gap(seq, now - seq.last_token_time)
            if self.obs.enabled:
                seq.last_token_time = now
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
        registration, counters, registry removal.  Returns the final
        reason: a guided sequence's assembled text is checked again, and
        one that does not parse (or, for json_schema, validate) finishes
        as GUIDED_INVALID."""
        rf = seq.sampling_params.response_format
        if (
            reason == FinishReason.STOP
            and seq.guide is not None
            and (rf == "json_object" or isinstance(rf, dict))
        ):
            # The automaton checked each token's text from decode([id]);
            # the assembled text is what the client receives.
            try:
                obj = json.loads(self.tokenizer.decode(seq.output_token_ids))
                valid = not isinstance(rf, dict) or validate_instance(
                    rf.get("schema") or {}, obj)
            except (ValueError, RecursionError):  # a JSONDecodeError, deep nesting
                valid = False
            if not valid:
                logger.warning(
                    "guided json output failed final parse for %s", seq.seq_id
                )
                reason = FinishReason.GUIDED_INVALID
        seq.finish_reason = reason
        self.scheduler.finish_seq(seq)
        self._release_transfers(seq.seq_id)
        self.total_finished += 1
        self.obs.on_finish(seq)
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

    # -- compile inventory -------------------------------------------------

    # The JAX engine's jit families that run eagerly here (no graph key, so
    # no compile event): the prefill and the K=1 mixed step launch their
    # kernels from the host, the host-side sampler is eager PyTorch, and an
    # encode batch is one eager forward.
    EAGER_FAMILIES = {
        "prefill_fn": "llama.prefill, eager",
        "mixed_fn": "llama.mixed_step (K=1 mixed step), eager",
        "sample_fn": "_sample_batch, eager (windows and pipelined steps "
                     "sample inside their graphs)",
        "encode_batch_fn": "llama.encode_batch, eager",
    }

    def compile_inventory(self) -> Dict[str, int]:
        """Config-derived expected graph keys per family, the denominator
        of /debug/compiles' warmup coverage report (the JAX engine's over
        its jit families).  Upper bounds on the steady-state inventory at
        one stop-width bucket and one flag set a family: a deployment that
        never sees a shape never captures it; the point is naming families
        still cold.  ``pipe`` stands for the JAX ``decode_fn`` (a pipelined
        decode+sample step), ``window`` / ``spec`` / ``mixed`` for
        ``window_fn`` / ``spec_window_fn`` / ``mixed_window_fn`` (here one
        graph an iteration per (decode bucket, chunk bucket), replayed
        k_eff times, where the JAX scan compiles one executable per
        power-of-two scan length)."""
        sched = self.config.scheduler
        decode_buckets = 1
        b = max(1, self.config.parallel.data_parallel)  # the buckets start at dp
        while b < sched.max_num_seqs:
            b *= 2
            decode_buckets += 1
        inv: Dict[str, int] = {}
        if sched.pipeline_enabled:
            inv["pipe"] = decode_buckets
        if sched.window_steps > 1:
            inv["window"] = decode_buckets
            if sched.spec_window_enabled:
                # The model drafter's prime / no-prime keys double it.
                inv["spec"] = decode_buckets * (
                    2 if sched.spec_drafter == "model" else 1
                )
            if sched.mixed_window_enabled:
                inv["mixed"] = decode_buckets * len(sched.prefill_chunk_buckets)
        return inv

    def compiles_payload(self) -> Dict:
        """GET /debug/compiles: per-executable compile events (most
        expensive first) + the warmup coverage join (first-used keys per
        graph family against :meth:`compile_inventory`), and the JAX jit
        families that run eagerly here."""
        rows = self.obs.compile_tracker.snapshot()
        by_family: Dict[str, int] = {}
        for r in rows:
            fam = r["executable"].split("[", 1)[0]
            by_family[fam] = by_family.get(fam, 0) + 1
        coverage = {
            fam: {"compiled": by_family.get(fam, 0), "expected": exp}
            for fam, exp in self.compile_inventory().items()
        }
        return {
            "enabled": self.obs.enabled,
            "compiled_shapes": self.obs.compile_tracker.compiled_shapes(),
            "compile_seconds": round(self.obs.compile_tracker.compile_seconds(), 6),
            "executables": rows,
            "coverage": coverage,
            "eager": dict(self.EAGER_FAMILIES),
        }

    # -- stats -------------------------------------------------------------

    def _duty_cycle(self) -> float:
        """Fraction of the trailing window spent inside collected steps."""
        cutoff = time.time() - self._busy_window_s
        busy = sum(
            # A step straddling the window's edge counts its in-window part.
            min(d, t - cutoff)
            for (t, d) in self._busy_window
            if t > cutoff
        )
        return min(1.0, busy / self._busy_window_s)

    def stats(self) -> Dict[str, float]:
        """The JAX engine's stats keys (its ``/metrics`` reads them), plus
        the port's own window, graph and offload counters."""
        return {
            "num_requests_running": self.scheduler.num_running,
            "num_requests_waiting": self.scheduler.num_waiting,
            "hbm_kv_usage_perc": self.block_pool.usage,
            "num_kv_blocks": self.block_pool.num_blocks,
            "prefix_cache_hit_rate": self.block_pool.prefix_hit_rate,
            "prefix_cache_hit_tokens": self.block_pool.hit_tokens,
            "prefix_cache_query_tokens": self.block_pool.query_tokens,
            "prefix_cache_blocks": self.block_pool.num_cached_blocks,
            "host_kv_usage_perc": self.offload.usage,
            "duty_cycle": self._duty_cycle(),
            "total_prompt_tokens": self.total_prompt_tokens,
            "total_generated_tokens": self.total_generated_tokens,
            "total_finished": self.total_finished,
            "num_preemptions": self.scheduler.num_preemptions,
            "prefill_chunk_tokens": self.prefill_chunk_tokens,
            "mixed_window_chunk_tokens": self.mixed_window_chunk_tokens,
            "window_transfer_overlap_seconds": self.window_transfer_overlap_s,
            "num_steps": self.num_steps,
            "step_seconds_total": self._step_time_accum,
            "admission_rejected_total": self.admission_rejected,
            "deadline_expired_total": (
                self.deadline_expired + self.deadline_expired_admission
            ),
            "queued_prompt_tokens": self.scheduler.queued_prompt_tokens,
            "encode_texts_total": self.encode_texts_total,
            "encode_queue_depth": self.encode_queue_depth,
            "loaded_loras": len(self.loaded_adapters()),
            "remote_prefix_blocks_fetched": self.remote_prefix_blocks_fetched,
            "remote_prefix_blocks_exported": self.remote_prefix_blocks_exported,
            "disagg_prefill_primes": self.disagg_prefill_primes,
            "disagg_handoff_hits": self.disagg_handoff_hits,
            "disagg_handoff_misses": self.disagg_handoff_misses,
            "kv_prefetch_hit": self.kv_prefetch.hit_blocks if self.kv_prefetch else 0,
            "kv_prefetch_waste": self.kv_prefetch.waste_blocks if self.kv_prefetch else 0,
            "kv_prefetch_inflight": self.kv_prefetch.inflight if self.kv_prefetch else 0,
            "spec_tokens_drafted": self.spec_tokens_drafted,
            "spec_tokens_accepted": self.spec_tokens_accepted,
            "spec_window_tokens": dict(self.spec_window_tokens),
            "spec_drafter": self.config.scheduler.spec_drafter or "",
            "spec_draft_fraction_seconds": self.spec_draft_fraction_s,
            "kv_wire_bytes": self.kv_wire_stats.wire_bytes(),
            "kv_snapshot_format": self.kv_wire_stats.snapshot_formats(),
            # Compile events (obs/compile_tracker.py: graph keys' first
            # use, kernel libraries' first load): seconds per executable
            # key and the distinct-key count, and trace-ring evictions.
            "compile_seconds": self.obs.compile_tracker.seconds_by_executable(),
            "compiled_shapes": self.obs.compile_tracker.compiled_shapes(),
            "obs_trace_dropped": self.obs.tracer.dropped,
            # Mean host-side serialization per decode step (ms): time the
            # device sat idle between decode steps; about 0 when the
            # lookahead keeps the device fed.
            "decode_host_gap_ms": (
                1000.0 * self._gap_total_s / self._gap_steps
                if self._gap_steps else 0.0
            ),
            # K-step windows: single-step fallbacks by reason, emitted but
            # undeliverable window tokens (and chunk tokens of prompts
            # aborted in flight), plain windows dispatched and chained,
            # mixed windows dispatched, chained, and their iterations.
            "multistep_fallback": dict(self.multistep_fallback),
            "multistep_wasted_tokens": self.multistep_wasted_tokens,
            "windows_dispatched": self.windows_dispatched,
            "windows_chained": self.windows_chained,
            "mixed_windows_dispatched": self.mixed_windows_dispatched,
            "mixed_windows_chained": self.mixed_windows_chained,
            "mixed_window_iterations": self.mixed_window_iterations,
            # CUDA graphs (0 on the CPU): keys captured, replays, and the
            # seconds all captures took (per key: graphs.capture_seconds).
            "graph_captures": self.graphs.captures,
            "graph_replays": self.graphs.replays,
            "graph_capture_seconds": sum(self.graphs.capture_seconds.values()),
            # The host tier: snapshots saved, restored and evicted.
            "offload_saves": self.offload.saves,
            "offload_restores": self.offload.restores,
            "offload_evictions": self.offload.evictions,
        }
