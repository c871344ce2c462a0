"""Multi-process groups: bootstrap and the lockstep serving protocol.

Counterpart of ``production_stack_tpu/engine/parallel/distributed.py``,
with ``torch.distributed`` in place of ``jax.distributed``.  The JAX
package runs one SPMD program across the worker processes of a slice; here
one process is one card, and a group of N cards is N processes: every
process calls :func:`maybe_initialize` against process 0's coordinator,
holds one sp position and its tp positions' shards on its own card
(``mesh.build_mesh``: sp outer, tp inner), and the partial sums of a layer
are reduced by NCCL inside each rank's CUDA graphs over the rank's tp
subgroup (``collectives.psum``; gloo on the CPU).  At sp > 1 a prefill's
rows are sharded over the sp positions and its attention runs the ring or
Ulysses over the rank's sp subgroup (``collectives.ppermute`` /
``all_to_all``); decode runs replicated over sp.

Serving on top needs one more ingredient, as in the JAX package: every
process must launch the same graphs, with the same collectives, in the
same order.  The engine is deterministic given its request stream, so the
leader (process 0, the only one serving HTTP) broadcasts each iteration's
event batch (new requests, aborts, shutdown) over a separate gloo group,
the control plane, so an event broadcast never touches a card's stream;
every follower applies it to its own engine and steps in lockstep.
Outputs are read on the leader: every rank ends a step with the same full
logits (the lm_head's all-gather), so every rank samples the same tokens.

Environment contract (the JAX package's; set by the Helm chart's
multi-host StatefulSet mode):

  PSTPU_NUM_PROCESSES       total processes in the group
  PSTPU_PROCESS_ID          this process's ordinal (0 = the leader)
  PSTPU_COORDINATOR_ADDRESS process 0's host:port (its TCPStore)

GKE TPU pod environments (TPU_WORKER_ID / TPU_WORKER_HOSTNAMES) are
honored as a fallback, as there.  A process's card is ``cuda:<local
rank>``: ``LOCAL_RANK`` when set, else the process id modulo the visible
devices (one visible device: ``cuda:0``).
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from production_stack_tpu_torch.engine.parallel.collectives import (
    SPGroup,
    TPGroup,
    all_to_all,
    group_layout,
    ppermute,
)

logger = logging.getLogger(__name__)

_COORD_PORT = 8476

# How long a member waits for the others to reach the coordinator, and the
# control plane's collective timeout.
_BOOT_TIMEOUT_S = 600.0

# Monotonic epoch guard: two epochs minted in the same millisecond (or a
# clock step backwards across a fast restart) must still order strictly.
_last_epoch = 0
_epoch_lock = threading.Lock()


def new_epoch() -> int:
    """A leader boot nonce, strictly larger than any epoch this process
    minted before: wall-clock milliseconds, bumped past the previous
    value on collision.  Restarted groups therefore always carry a
    STRICTLY larger epoch — the split-brain guard's ordering."""
    global _last_epoch
    with _epoch_lock:
        _last_epoch = max(int(time.time() * 1000), _last_epoch + 1)
        return _last_epoch


def fatal_exit(code: int = 1) -> None:
    """Terminate the process immediately after flushing log handlers.

    Used when a lockstep member must die NOW: ``sys.exit`` would run
    atexit hooks (the process group's teardown blocks on collectives the
    dead/desynced group will never complete), turning a clean restart
    into a hung process.  Module-level indirection so tests can
    monkeypatch it."""
    logging.shutdown()
    os._exit(code)


@dataclasses.dataclass(frozen=True)
class DistributedEnv:
    coordinator_address: str
    num_processes: int
    process_id: int

    @property
    def is_leader(self) -> bool:
        return self.process_id == 0


def detect_env(environ=None) -> Optional[DistributedEnv]:
    """Multi-process topology from the environment, or None for the
    ordinary single-process case.

    Explicit PSTPU_* variables win; the GKE TPU pod contract
    (TPU_WORKER_ID + TPU_WORKER_HOSTNAMES) is the fallback.  A
    single-entry hostname list (TPU_WORKER_HOSTNAMES=localhost) is
    single-process.
    """
    env = os.environ if environ is None else environ
    if "PSTPU_NUM_PROCESSES" in env:
        n = int(env["PSTPU_NUM_PROCESSES"])
        if n <= 1:
            return None
        return DistributedEnv(
            coordinator_address=env["PSTPU_COORDINATOR_ADDRESS"],
            num_processes=n,
            process_id=int(env["PSTPU_PROCESS_ID"]),
        )
    hostnames = [
        h for h in env.get("TPU_WORKER_HOSTNAMES", "").split(",") if h
    ]
    if len(hostnames) > 1:
        return DistributedEnv(
            coordinator_address=f"{hostnames[0]}:{_COORD_PORT}",
            num_processes=len(hostnames),
            process_id=int(env.get("TPU_WORKER_ID", "0")),
        )
    return None


@dataclasses.dataclass
class _Group:
    """The formed group of this process (``initialize``): the coordinator's
    store, the control-plane gloo group and the data plane's ``TPGroup``
    (its tp subgroup and, at sp > 1, its sp subgroup)."""

    denv: DistributedEnv
    store: Any
    control: Any
    tp: TPGroup


# The process's group, as ``jax.distributed.global_state``: one process
# joins at most one group, and ``torch.distributed``'s own default group
# is process-wide too.
_group: Optional[_Group] = None


def _local_device(denv: DistributedEnv, device, environ) -> torch.device:
    """This process's device: ``device`` as given when it names an index or
    is not CUDA, else ``cuda:<local rank>``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: a group on the card needs one card a process; "
            "pass device='cpu' to form a gloo group on the CPU on purpose"
        )
    if dev.index is not None:
        return dev
    env = os.environ if environ is None else environ
    local = int(env.get("LOCAL_RANK", denv.process_id % torch.cuda.device_count()))
    return torch.device("cuda", local)


def initialize(denv: DistributedEnv, device=None, environ=None,
               timeout_s: float = _BOOT_TIMEOUT_S, sequence_parallel: int = 1) -> TPGroup:
    """Form the group ``denv`` describes: a ``TCPStore`` at the
    coordinator address (process 0 serves it), the default process group
    over it (NCCL on a card, gloo on the CPU; a card whose NCCL
    communicator cannot form raises, nothing falls back to gloo), a gloo
    group for the control plane, and one warm-up all-reduce and
    all-gather, so the communicator exists before any CUDA graph capture
    records a collective.

    At ``sequence_parallel`` sp > 1 every rank then forms, in the same
    order (``collectives.group_layout``), a tp subgroup per sp position and
    an sp subgroup per tp column (``world % sp`` must be 0), and warms each
    of its own: one all-reduce on each, and on its sp subgroup one ring
    send/receive and one all-to-all, so no communicator or peer connection
    is made inside a prefill.  At sp = 1 the tp subgroup is the whole
    group.  Returns the data plane's ``TPGroup``."""
    global _group
    import torch.distributed as dist

    if _group is not None:
        raise RuntimeError("this process already belongs to a group")
    tp_ranks, sp_ranks = group_layout(denv.num_processes, sequence_parallel)
    dev = _local_device(denv, device, environ)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    host, port = denv.coordinator_address.rsplit(":", 1)
    timeout = datetime.timedelta(seconds=timeout_s)
    logger.info(
        "initializing torch.distributed (%s): coordinator=%s process %d/%d on %s, sp=%d",
        backend, denv.coordinator_address, denv.process_id, denv.num_processes, dev,
        sequence_parallel,
    )
    store = dist.TCPStore(host, int(port), denv.num_processes,
                          is_master=denv.is_leader, timeout=timeout)
    dist.init_process_group(
        backend, store=store, rank=denv.process_id,
        world_size=denv.num_processes, timeout=timeout,
        **({"device_id": dev} if dev.type == "cuda" else {}),
    )
    control = dist.new_group(backend="gloo", timeout=timeout)
    probe = torch.ones(2, device=dev)
    dist.all_reduce(probe)
    gathered = [torch.empty_like(probe) for _ in range(denv.num_processes)]
    dist.all_gather(gathered, probe)
    if float(probe[0]) != denv.num_processes:
        raise RuntimeError(f"warm-up all-reduce gave {float(probe[0])}, "
                           f"not {denv.num_processes}")
    data, sp_group = dist.group.WORLD, None
    if sequence_parallel > 1:
        data = _subgroup(tp_ranks, denv.process_id, timeout)
        ranks = next(r for r in sp_ranks if denv.process_id in r)
        sp_group = SPGroup(index=ranks.index(denv.process_id), size=len(ranks),
                           ranks=tuple(ranks),
                           group=_subgroup(sp_ranks, denv.process_id, timeout))
        _warm(data, len(tp_ranks[0]), sp_group, dev)
    tp = TPGroup(rank=denv.process_id, world=denv.num_processes, device=dev,
                 group=data, sp_group=sp_group)
    _group = _Group(denv=denv, store=store, control=control, tp=tp)
    return tp


def _subgroup(layout, rank: int, timeout):
    """Every subgroup of ``layout`` formed (each rank calls ``new_group``
    for every one, in the same order); returns the one holding ``rank``."""
    import torch.distributed as dist

    mine = None
    for ranks in layout:
        pg = dist.new_group(ranks, timeout=timeout)
        if rank in ranks:
            mine = pg
    return mine


def _warm(tp_pg, tp_size: int, sp: SPGroup, dev: torch.device) -> None:
    """One all-reduce on the tp subgroup; one all-reduce, one ring step and
    one all-to-all on the sp subgroup, each checked."""
    import torch.distributed as dist

    probe = torch.ones(2, device=dev)
    dist.all_reduce(probe, group=tp_pg)
    total = torch.ones(2, device=dev)
    dist.all_reduce(total, group=sp.group)
    mine = torch.full((sp.size, 2), float(sp.index), device=dev)
    ring = ppermute(mine, [(i, (i + 1) % sp.size) for i in range(sp.size)], sp)
    swapped = all_to_all(mine, 0, 0, sp)
    got = (float(probe[0]), float(total[0]), float(ring[0, 0]), swapped[:, 0].tolist())
    want = (tp_size, sp.size, float((sp.index - 1) % sp.size),
            [float(i) for i in range(sp.size)])
    if got != want:
        raise RuntimeError(f"warm-up of the subgroups gave {got}, not {want}")


def maybe_initialize(environ=None, device=None,
                     sequence_parallel: int = 1) -> Optional[DistributedEnv]:
    """Form the group when the environment declares a multi-process
    topology (:func:`initialize`, this process's card from ``device``:
    default CUDA, its subgroups for ``sequence_parallel``).  Must run
    before the engine is built; after it the engine's mesh spans the
    group.  Returns the detected topology (None = single process, nothing
    done)."""
    denv = detect_env(environ)
    if denv is None:
        return None
    initialize(denv, device, environ, sequence_parallel=sequence_parallel)
    return denv


def agree_min(value: int) -> int:
    """The least of every member's ``value`` (an all-reduce MIN over the
    control plane; ``value`` itself outside a group): a size each rank
    measured on its own card, agreed so that every rank plans over the
    same one."""
    import torch.distributed as dist

    if _group is None:
        return value
    box = torch.tensor([value], dtype=torch.int64)
    dist.all_reduce(box, op=dist.ReduceOp.MIN, group=_group.control)
    return int(box[0])


def agree_vector(values: Sequence[int]) -> List[int]:
    """The element-wise least of every member's ``values`` (one all-reduce
    MIN of an int64 vector over the control plane; ``values`` themselves
    outside a group): the asynchronous transfer plane's states, one entry
    a live job in an order every member shares, agreed in one call a
    step."""
    import torch.distributed as dist

    if _group is None:
        return list(values)
    box = torch.tensor(list(values), dtype=torch.int64)
    dist.all_reduce(box, op=dist.ReduceOp.MIN, group=_group.control)
    return box.tolist()


def broadcast_from_leader(obj: Any) -> Any:
    """``obj`` as process 0 holds it, on every member (a broadcast over the
    control plane, beside :func:`agree_min`; ``obj`` itself outside a
    group): a small host value one rank decides or reads for the group,
    such as the embedding row the prefix keys hash, or the blocks an
    export takes."""
    if _group is None:
        return obj
    return broadcast_pyobj(obj, is_source=_group.denv.is_leader)


def tp_group() -> Optional[TPGroup]:
    """The data plane of this process's group; None outside a group."""
    return None if _group is None else _group.tp


def shutdown() -> None:
    """Leave the group, every member together: a barrier on the control
    plane, then every process group destroyed (NCCL's teardown waits on
    its peers, and process 0 serves the store the others' teardown still
    reads, so no member may run ahead into it).  A clean exit; a member
    that must die now calls :func:`fatal_exit` instead."""
    global _group
    import torch.distributed as dist

    if _group is None:
        return
    group, _group = _group, None
    dist.barrier(group=group.control)
    dist.destroy_process_group()


# -- group control-plane side channel (acks, drain relay, group fail) ------
#
# The lockstep broadcast is a COLLECTIVE: it can only prove liveness of
# members that still participate, and it hangs — rather than reporting —
# when one is gone.  Group liveness therefore rides a tiny key/value side
# channel: followers write monotonic ack ordinals after every received
# event batch, the leader's monitor thread polls them, a follower relays
# drain intent the same way, and the leader's group-fail marker tells
# followers to restart even when the collective transport is wedged.
# Nothing on this channel ever feeds a step plan directly — every
# plan-affecting decision still flows through the leader's published
# event batches, so lockstep determinism holds by construction.


def _ack_key(epoch: int, process_id: int, ordinal: int) -> str:
    # Ordinal-suffixed keys: every write lands on a FRESH key, so the
    # channel works on write-once stores as well as overwriting ones.
    return f"pstpu/{epoch}/ack/{process_id}/{ordinal}"


def _drain_key(epoch: int, process_id: int) -> str:
    return f"pstpu/{epoch}/drain/{process_id}"


def _mismatch_key(epoch: int, process_id: int) -> str:
    # Written by a follower observing epoch ``epoch`` from a group it
    # does not belong to, read by THAT group's leader (it owns the
    # epoch) so the fleet can tell split-brain restarts from silence.
    return f"pstpu/{epoch}/mismatch/{process_id}"


def _fail_key(epoch: int) -> str:
    return f"pstpu/{epoch}/fail"


class LocalAckStore:
    """In-process ack store: the single-process stand-in (tests, fake
    slice groups) for the coordinator's store."""

    def __init__(self) -> None:
        self._data: Dict[str, str] = {}
        self._lock = threading.Lock()

    def set(self, key: str, value: str) -> None:
        with self._lock:
            self._data[key] = value

    def get(self, key: str) -> Optional[str]:
        with self._lock:
            return self._data.get(key)


class CoordinatorAckStore:
    """Ack store over the group's coordinator ``TCPStore`` — the side
    channel every member can already reach (it bootstrapped through it).
    Reads never block (``check`` first: a ``get`` of an absent key waits
    for it), and all failures degrade to None/no-op: a flaky read must
    never take down a healthy group; prolonged silence is what the
    monitor reacts to."""

    def __init__(self, store=None) -> None:
        if store is None:
            if _group is None:
                raise RuntimeError("torch.distributed group is not initialized")
            store = _group.store
        self._store = store

    def set(self, key: str, value: str) -> None:
        try:
            self._store.set(key, value)
        except Exception:
            logger.debug("coordinator store set failed for %s", key, exc_info=True)

    def get(self, key: str) -> Optional[str]:
        try:
            if not self._store.check([key]):
                return None
            return self._store.get(key).decode()
        except Exception:
            return None


def _maybe_coordinator_store() -> Optional[CoordinatorAckStore]:
    try:
        return CoordinatorAckStore()
    except Exception:
        return None


class GroupEpochMismatch(RuntimeError):
    """A follower observed an event batch from a different group
    incarnation (epoch change after adoption, or a mid-stream join): its
    engine state cannot be in lockstep with that group — the only safe
    move is fatal_exit into a fresh parallel group restart."""


# -- lockstep event channel ------------------------------------------------


def broadcast_pyobj(obj: Any, is_source: bool) -> Any:
    """Broadcast a picklable object from process 0 to all processes over
    the control plane's gloo group (``broadcast_object_list``: the
    payload's length, then its bytes, on the host).  The lockstep payload
    is request metadata (token ids, sampling params), thousands of times
    smaller than one decode step's activations, and it never touches a
    card's stream."""
    import torch.distributed as dist

    if _group is None:
        raise RuntimeError("torch.distributed group is not initialized")
    box = [obj if is_source else None]
    dist.broadcast_object_list(box, src=0, group=_group.control)
    return box[0]


@dataclasses.dataclass
class StepEvents:
    """One lockstep iteration's inputs, leader -> followers."""

    requests: list = dataclasses.field(default_factory=list)
    # (request_id, prompt_token_ids, SamplingParams, adapter)
    aborts: list = dataclasses.field(default_factory=list)
    # (encode_id, token_ids): texts every rank embeds (``LLMEngine.embed``)
    # on its step thread before this iteration's step.
    encodes: list = dataclasses.field(default_factory=list)
    # (prompt_token_ids, cache_ns): disagg handoff chains every rank
    # submits (``LLMEngine.submit_handoff``) after the admissions, so the
    # job is live on every rank from the same point of the iteration.
    handoffs: list = dataclasses.field(default_factory=list)
    shutdown: bool = False
    # Group identity: the leader's boot nonce and a monotonic publish
    # ordinal, stamped by LockstepChannel.publish.  A follower adopts
    # (epoch, seq=1) from its first event and fatal-exits on any
    # mismatch thereafter — a restarted member can never replay into a
    # newer (or older) group incarnation.
    epoch: int = 0
    seq: int = 0


class LockstepChannel:
    """Leader/follower event exchange for a multi-process group.

    The leader calls :meth:`publish` with each iteration's event batch
    right before stepping its engine; followers call :meth:`receive` and
    apply the same batch to their engine, keeping every process's
    scheduler state — and therefore every graph launch and collective —
    identical.  Idle iterations are not published beyond a periodic
    empty HEARTBEAT batch (liveness signal), so followers block in
    ``receive`` without spinning collectives.

    Group liveness: every received batch is acknowledged back to the
    leader through the ``ack_store`` side channel (throttled to
    ``member_timeout_s/4``); the leader's :class:`GroupLivenessMonitor`
    fails the group's ``/health`` when a member stays silent past
    ``member_timeout_s``.  Every publish carries the group ``epoch``
    (leader boot nonce) and a monotonic ``seq``; followers adopt the
    first and die loudly on any change (:class:`GroupEpochMismatch`).
    """

    def __init__(
        self,
        denv: DistributedEnv,
        heartbeat_seconds: float = 10.0,
        member_timeout_s: float = 10.0,
        ack_store=None,
    ):
        self.denv = denv
        self.member_timeout_s = float(member_timeout_s)
        # Leader publishes an empty batch at least this often while idle;
        # followers treat event staleness beyond a few heartbeats as a
        # dead leader (follower /health fails -> the process is
        # restarted; a group cannot heal a lost member in place).  The
        # idle heartbeat must outpace the member-liveness window, or an
        # idle group would trip the monitor between heartbeats.
        if self.member_timeout_s > 0:
            heartbeat_seconds = min(
                heartbeat_seconds, self.member_timeout_s / 3.0
            )
        self.heartbeat_seconds = heartbeat_seconds
        self.last_event_time = time.time()
        # The control-plane side channel; None disables group liveness
        # (single-process tests, or no coordinator store).
        self.ack_store = (
            ack_store if ack_store is not None else _maybe_coordinator_store()
        )
        self.epoch = new_epoch() if denv.is_leader else 0
        self.seq = 0
        self._epoch_adopted = denv.is_leader
        # Follower ack throttle state.
        self._ack_ordinal = 0
        self._last_ack_time = 0.0
        self._drain_relayed = False

    def publish(self, events: StepEvents) -> None:
        if not self.denv.is_leader:
            raise RuntimeError("only the leader publishes")
        self.seq += 1
        events.epoch = self.epoch
        events.seq = self.seq
        broadcast_pyobj(events, is_source=True)
        self.last_event_time = time.time()

    def receive(self) -> StepEvents:
        if self.denv.is_leader:
            raise RuntimeError("the leader does not receive")
        events = broadcast_pyobj(None, is_source=False)
        self.last_event_time = time.time()
        self._check_epoch(events)
        self.seq = getattr(events, "seq", 0)
        self._maybe_ack()
        return events

    def _check_epoch(self, events: StepEvents) -> None:
        epoch = getattr(events, "epoch", 0)
        seq = getattr(events, "seq", 0)
        if not epoch:
            return  # pre-epoch peer (tests with hand-rolled events)
        if not self._epoch_adopted:
            if seq > 1:
                # First event this process ever saw is mid-stream: a
                # restarted member attaching to a RUNNING group.  Its
                # engine state is steps behind the group's — replaying
                # from here would silently desync the launches.
                self._report_epoch_mismatch(epoch)
                raise GroupEpochMismatch(
                    f"joined group epoch {epoch} at seq {seq}: a restarted "
                    "member cannot replay into a running group"
                )
            self.epoch = epoch
            self._epoch_adopted = True
            if self._drain_relayed and self.ack_store is not None:
                # A drain relayed BEFORE adoption (SIGTERM during the
                # leader's boot) was keyed under epoch 0, which no
                # monitor polls — re-relay under the adopted epoch so
                # the intent is never silently lost.
                self.ack_store.set(
                    _drain_key(self.epoch, self.denv.process_id),
                    str(time.time()),
                )
            return
        if epoch != self.epoch:
            self._report_epoch_mismatch(epoch)
            raise GroupEpochMismatch(
                f"group epoch changed {self.epoch} -> {epoch}: this member "
                "belongs to a dead incarnation and must restart"
            )

    def _report_epoch_mismatch(self, observed_epoch: int) -> None:
        """Tell the OBSERVED group's leader (it owns that epoch and its
        monitor polls it) that a member of another incarnation saw its
        events — tpu:lockstep_member_failures_total{reason="epoch_mismatch"}."""
        if self.ack_store is not None and observed_epoch:
            self.ack_store.set(
                _mismatch_key(observed_epoch, self.denv.process_id),
                str(self.epoch),
            )

    def _maybe_ack(self) -> None:
        """Write a liveness ack (monotonic ordinal -> latest seq seen),
        throttled so an idle-heartbeat cadence and a busy step cadence
        cost the same: at most ~4 store writes per member timeout."""
        if self.ack_store is None or self.member_timeout_s <= 0:
            return
        now = time.time()
        interval = self.member_timeout_s / 4.0
        if self._ack_ordinal and now - self._last_ack_time < interval:
            return
        self._ack_ordinal += 1
        self._last_ack_time = now
        self.ack_store.set(
            _ack_key(self.epoch, self.denv.process_id, self._ack_ordinal),
            str(self.seq),
        )

    def relay_drain(self) -> bool:
        """Follower-side drain intent (SIGTERM / preStop POST /drain):
        RELAY to the leader through the side channel instead of leaving
        the collectives — the follower keeps stepping until the leader
        announces shutdown, so in-flight streams finish before any
        member exits.  Returns False when no side channel exists (the
        caller falls back to waiting out the staleness window)."""
        if self.ack_store is None:
            return False
        self._drain_relayed = True
        self.ack_store.set(
            _drain_key(self.epoch, self.denv.process_id), str(time.time())
        )
        return True

    @property
    def drain_relayed(self) -> bool:
        return self._drain_relayed

    def group_failed(self) -> Optional[str]:
        """The leader's group-fail marker, readable by any member even
        when the collective transport is wedged."""
        if self.ack_store is None or not self.epoch:
            return None
        return self.ack_store.get(_fail_key(self.epoch))

    def mark_group_failed(self, reason: str) -> None:
        if self.ack_store is not None and self.epoch:
            self.ack_store.set(_fail_key(self.epoch), reason)

    def stale(self, factor: float = 6.0) -> bool:
        """No event for ``factor`` heartbeats: the leader is gone."""
        return time.time() - self.last_event_time \
            > factor * self.heartbeat_seconds


class GroupLivenessMonitor:
    """Leader-side member-liveness watchdog for a lockstep group.

    A dedicated thread (never the step thread: ack reads are round trips
    to the coordinator's store) polls every follower's ack ordinals.  A
    member whose acks stop advancing for ``member_timeout_s`` while
    events are being published fails the whole group: :meth:`problem`
    turns non-None (the leader's ``/health`` conjoins it -> 503 within
    the timeout, so the router's breaker routes around the group in
    seconds), the group-fail marker is written so live followers restart
    in parallel, and — with ``exit_on_failure`` — the leader
    ``fatal_exit``s so the whole group restarts together.  The same poll
    carries the follower->leader drain relay (``on_drain_relay`` fires
    once).
    """

    FAILURE_REASONS = ("member_silent", "epoch_mismatch")

    def __init__(
        self,
        channel: LockstepChannel,
        *,
        on_drain_relay: Optional[Callable[[], None]] = None,
        exit_on_failure: bool = True,
        poll_interval_s: Optional[float] = None,
        clock: Callable[[], float] = time.time,
    ):
        self.channel = channel
        self.on_drain_relay = on_drain_relay
        self.exit_on_failure = exit_on_failure
        timeout = max(channel.member_timeout_s, 0.05)
        self.poll_interval_s = (
            poll_interval_s if poll_interval_s is not None
            else max(0.05, timeout / 8.0)
        )
        self._clock = clock
        self._lock = threading.Lock()
        now = clock()
        members = range(1, channel.denv.num_processes)
        self._next_ordinal = {pid: 1 for pid in members}
        self._last_progress = {pid: now for pid in members}
        self._last_seq = {pid: 0 for pid in members}
        self._armed = False  # becomes True once the leader published
        self._problem: Optional[str] = None
        self._drain_seen: set = set()
        self._mismatch_seen: set = set()
        self.member_failures: Dict[str, int] = {}
        self.drain_relays = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="slice-monitor", daemon=True
        )
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout)

    # -- reads (health endpoint / metrics, asyncio loop) -------------------

    def problem(self) -> Optional[str]:
        with self._lock:
            return self._problem

    def member_ack_ages(self) -> Dict[int, float]:
        """Seconds since each member's acks last advanced (0.0 before the
        first publish arms the monitor) — tpu:lockstep_member_last_ack_seconds."""
        now = self._clock()
        with self._lock:
            if not self._armed:
                return {pid: 0.0 for pid in self._last_progress}
            return {
                pid: max(0.0, now - t)
                for pid, t in self._last_progress.items()
            }

    def record_failure(self, reason: str) -> None:
        with self._lock:
            self.member_failures[reason] = (
                self.member_failures.get(reason, 0) + 1
            )

    # -- the monitor thread ------------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            self.poll_once()
            if self.problem() is not None:
                break
            self._stop.wait(self.poll_interval_s)
        problem = self.problem()
        if problem is None or self._stop.is_set():
            return
        # Bounded fail-and-restart: the marker restarts live followers
        # in parallel (they poll it off-collective), one short beat lets
        # in-flight health probes observe the 503, then the leader exits
        # nonzero so the whole group restarts together.  No shutdown
        # broadcast: a publish is a collective and would wedge on the
        # very member whose death we just detected.
        self.channel.mark_group_failed(problem)
        if self.exit_on_failure:
            if self._stop.wait(min(1.0, 2 * self.poll_interval_s)):
                # stop() landed during the beat: the process is shutting
                # down cleanly — do not turn an exit-0 into a restart.
                return
            logger.error("slice group failed (%s); restarting group", problem)
            fatal_exit(1)

    def poll_once(self) -> None:
        """One ack/relay sweep (separable for deterministic tests)."""
        store = self.channel.ack_store
        if store is None:
            return
        now = self._clock()
        epoch = self.channel.epoch
        with self._lock:
            if not self._armed:
                if self.channel.seq == 0:
                    # Nothing published yet: members have nothing to ack.
                    for pid in self._last_progress:
                        self._last_progress[pid] = now
                    return
                self._armed = True
            members = list(self._next_ordinal)
        for pid in members:
            # Per-member clock read: a slow store must not let sweep
            # duration inflate another member's measured silence.
            now = self._clock()
            advanced = False
            # Bounded catch-up: followers write at most ~4 acks per
            # timeout, so a handful of probes always reaches the head.
            for _ in range(64):
                with self._lock:
                    ordinal = self._next_ordinal[pid]
                value = store.get(_ack_key(epoch, pid, ordinal))
                if value is None:
                    break
                advanced = True
                with self._lock:
                    self._next_ordinal[pid] = ordinal + 1
                    try:
                        self._last_seq[pid] = int(value)
                    except ValueError:
                        pass
            with self._lock:
                if advanced:
                    self._last_progress[pid] = now
                silent_s = now - self._last_progress[pid]
                timeout = self.channel.member_timeout_s
                if (
                    self._problem is None
                    and timeout > 0
                    and silent_s > timeout
                ):
                    self._problem = (
                        f"slice member {pid} silent for {silent_s:.1f}s "
                        f"(member timeout {timeout:.1f}s); the group "
                        "cannot heal a lost member in place"
                    )
                    self.member_failures["member_silent"] = (
                        self.member_failures.get("member_silent", 0) + 1
                    )
            if store.get(_drain_key(epoch, pid)) is not None:
                # Consume only when a callback is wired: a relay seen
                # during the start()->callback-assignment window (or one
                # already on the channel at leader boot) must survive
                # until someone can actually begin the drain.
                cb = self.on_drain_relay
                fire = False
                with self._lock:
                    if pid not in self._drain_seen and cb is not None:
                        self._drain_seen.add(pid)
                        self.drain_relays += 1
                        fire = True
                if fire and cb is not None:
                    logger.info(
                        "slice member %d relayed drain intent; draining "
                        "the whole group through the leader", pid,
                    )
                    cb()
            if store.get(_mismatch_key(epoch, pid)) is not None:
                count = False
                with self._lock:
                    if pid not in self._mismatch_seen:
                        self._mismatch_seen.add(pid)
                        count = True
                if count:
                    # A member of another incarnation observed this
                    # group's events (split-brain restart in flight);
                    # it fatal-exited itself — count the reason so the
                    # fleet can tell mismatches from plain silence.
                    self.record_failure("epoch_mismatch")


def follower_loop(engine, channel: LockstepChannel) -> None:
    """Run a follower: apply the leader's event batches and step in
    lockstep until shutdown.  Outputs are discarded — the leader owns the
    HTTP surface; this process contributes its tp positions' shards and
    their collectives.

    ``engine.step()`` here is the same dispatch/collect pipeline the
    leader's loop drives, under the same condition (a sequence unfinished,
    a dispatched step uncollected, or a live job of the asynchronous
    transfer plane, whose agreement runs in the step), so with the
    lookahead on every
    rank enqueues the identical launch sequence (collects are host reads
    of the rank's own copy of the sampled tokens — no collectives),
    keeping the group in sync."""
    logger.info("follower %d: entering lockstep loop", channel.denv.process_id)
    try:
        _follow(engine, channel)
    finally:
        log_transfers(engine, f"follower {channel.denv.process_id}")


def log_transfers(engine, who: str) -> None:
    """One log line of what this rank moved through the KV tiers (the
    store reads are each rank's own; the server's leader logs it at exit
    too)."""
    offload = getattr(engine, "offload", None)
    if offload is None:
        return
    logger.info("%s: remote store: %d prefix blocks fetched, %d bytes read, %d exported; "
                "offload: %d saves, %d restores, %d from the store", who,
                engine.remote_prefix_blocks_fetched, engine.remote_prefix_bytes_read,
                engine.remote_prefix_blocks_exported, offload.saves, offload.restores,
                offload.remote_restores)


def _follow(engine, channel: LockstepChannel) -> None:
    while True:
        try:
            events = channel.receive()
        except GroupEpochMismatch:
            # Split-brain guard: this member belongs to a different group
            # incarnation than the one publishing (leader restarted, or
            # this member restarted into a running group).  Its engine
            # state cannot be in lockstep — exit nonzero so the whole
            # group restarts into one fresh epoch together.
            logger.exception(
                "follower: group epoch mismatch; exiting for a clean "
                "parallel group restart"
            )
            fatal_exit(1)
            return  # unreachable except under monkeypatched exit
        if events.shutdown:
            logger.info("follower: leader announced shutdown")
            return
        for request_id in events.aborts:
            engine.abort_request(request_id)
        for request_id, token_ids, params, adapter in events.requests:
            try:
                engine.add_request(
                    request_id,
                    prompt_token_ids=token_ids,
                    sampling_params=params,
                    adapter=adapter,
                )
            except Exception:
                # The leader hit the same validation error and already
                # answered the client; stay in lockstep.
                logger.exception("follower: add_request failed")
        for encode_id, token_ids in getattr(events, "encodes", ()):
            # The leader's embeds, at the same point of the iteration: the
            # forward's reductions pair up with the leader's.
            try:
                engine.embed(token_ids)
            except Exception:
                logger.exception("follower: embed %s failed", encode_id)
        for token_ids, cache_ns in getattr(events, "handoffs", ()):
            engine.submit_handoff(token_ids, cache_ns)
        # A live transfer job steps too: its agreement runs in the step.
        if engine.has_unfinished() or engine.has_pending() or engine.has_live_transfers():
            try:
                engine.step()
            except Exception:
                # An unguarded step error would kill this process while
                # the leader keeps publishing, wedging the group in
                # collectives until a partial restart that cannot rejoin
                # the running group anyway.  Exit nonzero promptly so the
                # WHOLE group restarts together (a group cannot heal a
                # lost member in place).
                logger.exception(
                    "follower: engine.step failed; exiting nonzero so "
                    "the slice group restarts together"
                )
                fatal_exit(1)
                return  # unreachable except under monkeypatched exit
