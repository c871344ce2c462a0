"""The port's group control plane (``parallel/distributed.py``) against
the JAX package's, on the same inputs and fake clocks, in one process:

- ``detect_env`` reads the same environments to the same topology;
- ``new_epoch`` strictly increases; a publish stamps epoch and seq;
- a follower adopts the first epoch, and an epoch change, a mid-stream
  join or a drain relayed before adoption end as they do in the JAX
  package (the same exception, epoch and side-channel keys);
- ack keys and the ack throttle write the same keys under the same clock;
- ``GroupLivenessMonitor`` finds a silent member at the same poll, with
  the same ages and failure counts, fires a drain relay once and holds it
  until a callback is wired, and its thread marks the group failed;
- ``follower_loop`` exits nonzero on a step failure or an epoch mismatch;
- the port's ack store over a real ``TCPStore`` reads without blocking;
- the port's ``AsyncEngine`` under a recording channel publishes every
  batch before it steps (deadline expiries folded into the aborts), a
  heartbeat while idle and a shutdown on close, and a failed step is
  fatal; ``--data-parallel 2`` in a group exits with the JAX message.
"""

import asyncio
import dataclasses
import datetime

import pytest

from production_stack_tpu.engine.parallel import distributed as jdist
from production_stack_tpu_torch.engine.config import config_from_preset
from production_stack_tpu_torch.engine.core.sequence import SamplingParams
from production_stack_tpu_torch.engine.parallel import distributed as tdist
from production_stack_tpu_torch.engine.server import api_server as port_server
from production_stack_tpu_torch.engine.server.async_engine import AsyncEngine
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

PACKAGES = {"jax": jdist, "port": tdist}


@pytest.mark.parametrize("env", [
    {},
    {"PSTPU_NUM_PROCESSES": "1"},
    {"PSTPU_NUM_PROCESSES": "4", "PSTPU_PROCESS_ID": "2",
     "PSTPU_COORDINATOR_ADDRESS": "engine-0.engine:8476"},
    {"PSTPU_NUM_PROCESSES": "2", "PSTPU_PROCESS_ID": "0",
     "PSTPU_COORDINATOR_ADDRESS": "h:1", "TPU_WORKER_HOSTNAMES": "a,b,c"},
    {"TPU_WORKER_HOSTNAMES": "localhost"},
    {"TPU_WORKER_HOSTNAMES": "w0,w1,w2,w3", "TPU_WORKER_ID": "3"},
    {"TPU_WORKER_HOSTNAMES": "w0,w1"},
])
def test_detect_env_reads_what_jax_reads(env):
    want, got = jdist.detect_env(env), tdist.detect_env(env)
    assert (got is None) == (want is None)
    if want is not None:
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert got.is_leader == want.is_leader


@pytest.mark.parametrize("pkg", PACKAGES)
def test_new_epoch_strictly_increases_and_publish_stamps_it(pkg, monkeypatch):
    d = PACKAGES[pkg]
    epochs = [d.new_epoch() for _ in range(5)]
    assert all(b > a for a, b in zip(epochs, epochs[1:]))
    sent = []
    monkeypatch.setattr(d, "broadcast_pyobj", lambda obj, is_source: sent.append(obj))
    leader = d.LockstepChannel(d.DistributedEnv("x:1", 3, 0), member_timeout_s=1.0,
                               ack_store=d.LocalAckStore())
    leader.publish(d.StepEvents())
    leader.publish(d.StepEvents(shutdown=True))
    assert [e.seq for e in sent] == [1, 2]
    assert sent[0].epoch == sent[1].epoch == leader.epoch > epochs[-1]


def _receive_all(d, monkeypatch, events, relay_first=False):
    """A follower of a 3-process group receiving ``[(epoch, seq)]``:
    (what ended it, its epoch and seq, the side channel's keys)."""
    store = d.LocalAckStore()
    follower = d.LockstepChannel(d.DistributedEnv("x:1", 3, 1), member_timeout_s=100.0,
                                 ack_store=store)
    if relay_first:
        follower.relay_drain()
    for epoch, seq in events:
        ev = d.StepEvents()
        ev.epoch, ev.seq = epoch, seq
        monkeypatch.setattr(d, "broadcast_pyobj", lambda obj, is_source, ev=ev: ev)
        try:
            follower.receive()
        except d.GroupEpochMismatch:
            return "mismatch", follower.epoch, follower.seq, sorted(store._data)
    return "ok", follower.epoch, follower.seq, sorted(store._data)


@pytest.mark.parametrize("case,events,relay_first", [
    ("adopt", [(12345, 1), (12345, 2), (12345, 3)], False),
    ("epoch-change", [(100, 1), (100, 2), (200, 1)], False),
    ("mid-stream-join", [(100, 7)], False),
    ("pre-epoch-peer", [(0, 0), (0, 0)], False),
    ("drain-before-adoption", [(9000, 1)], True),
])
def test_epoch_adoption_and_mismatch_as_jax(case, events, relay_first, monkeypatch):
    want = _receive_all(jdist, monkeypatch, events, relay_first)
    got = _receive_all(tdist, monkeypatch, events, relay_first)
    assert got == want
    assert want[0] == ("mismatch" if "change" in case or "join" in case else "ok")


def _acks(d, monkeypatch, times, timeout):
    clock = [0.0]
    monkeypatch.setattr(d.time, "time", lambda: clock[0])
    store = d.LocalAckStore()
    follower = d.LockstepChannel(d.DistributedEnv("x:1", 2, 1),
                                 member_timeout_s=timeout, ack_store=store)
    for seq, t in enumerate(times, start=1):
        clock[0] = t
        ev = d.StepEvents()
        ev.epoch, ev.seq = 77, seq
        monkeypatch.setattr(d, "broadcast_pyobj", lambda obj, is_source, ev=ev: ev)
        follower.receive()
    return dict(store._data)


@pytest.mark.parametrize("times,timeout", [
    ([0.0, 0.1, 0.2, 0.3], 1.0),
    ([0.0, 0.3, 0.6, 0.9, 1.2], 1.0),
    ([0.0, 5.0, 5.1, 10.0], 4.0),
    ([0.0, 1.0], 0.0),  # liveness off: no acks
])
def test_ack_keys_and_throttle_as_jax(times, timeout, monkeypatch):
    assert tdist._ack_key(5, 1, 2) == jdist._ack_key(5, 1, 2)
    assert tdist._drain_key(5, 1) == jdist._drain_key(5, 1)
    assert tdist._mismatch_key(5, 1) == jdist._mismatch_key(5, 1)
    assert tdist._fail_key(5) == jdist._fail_key(5)
    want = _acks(jdist, monkeypatch, times, timeout)
    got = _acks(tdist, monkeypatch, times, timeout)
    assert got == want
    assert bool(want) == (timeout > 0)


def _silence(d, monkeypatch):
    monkeypatch.setattr(d, "broadcast_pyobj", lambda obj, is_source: obj)
    store, clock = d.LocalAckStore(), [0.0]
    leader = d.LockstepChannel(d.DistributedEnv("x:1", 3, 0), member_timeout_s=1.0,
                               ack_store=store)
    mon = d.GroupLivenessMonitor(leader, exit_on_failure=False, clock=lambda: clock[0])
    seen = []
    clock[0] += 100.0
    mon.poll_once()  # unarmed before the first publish
    seen.append((mon.problem(), mon.member_ack_ages()))
    leader.publish(d.StepEvents())
    store.set(d._ack_key(leader.epoch, 1, 1), "1")
    store.set(d._ack_key(leader.epoch, 2, 1), "1")
    mon.poll_once()
    seen.append((mon.problem(), mon.member_ack_ages()))
    clock[0] += 1.5
    store.set(d._ack_key(leader.epoch, 2, 2), "1")
    mon.poll_once()
    problem = mon.problem()
    return seen, problem is not None and "member 1" in problem, mon.member_failures, \
        mon.member_ack_ages()


def test_monitor_finds_a_silent_member_as_jax(monkeypatch):
    want = _silence(jdist, monkeypatch)
    got = _silence(tdist, monkeypatch)
    assert got == want
    assert want[1] and want[2] == {"member_silent": 1}


def _relays(d, monkeypatch, wired):
    monkeypatch.setattr(d, "broadcast_pyobj", lambda obj, is_source: obj)
    store = d.LocalAckStore()
    leader = d.LockstepChannel(d.DistributedEnv("x:1", 3, 0), member_timeout_s=100.0,
                               ack_store=store)
    leader.publish(d.StepEvents())
    relays = []
    mon = d.GroupLivenessMonitor(
        leader, exit_on_failure=False,
        on_drain_relay=(lambda: relays.append(1)) if wired else None)
    follower = d.LockstepChannel(d.DistributedEnv("x:1", 3, 1), member_timeout_s=100.0,
                                 ack_store=store)
    follower.epoch, follower._epoch_adopted = leader.epoch, True
    counts = [follower.relay_drain(), follower.drain_relayed]
    mon.poll_once()
    counts.append(mon.drain_relays)
    mon.on_drain_relay = lambda: relays.append(1)
    mon.poll_once()
    mon.poll_once()
    return counts + [mon.drain_relays, len(relays)]


@pytest.mark.parametrize("wired", [True, False], ids=["wired", "held-until-wired"])
def test_drain_relay_fires_once_as_jax(wired, monkeypatch):
    want = _relays(jdist, monkeypatch, wired)
    assert _relays(tdist, monkeypatch, wired) == want
    assert want[-2:] == [1, 1]


def test_monitor_thread_marks_the_group_failed_and_exits(monkeypatch):
    exits = []
    monkeypatch.setattr(tdist, "fatal_exit", exits.append)
    monkeypatch.setattr(tdist, "broadcast_pyobj", lambda obj, is_source: obj)
    store = tdist.LocalAckStore()
    leader = tdist.LockstepChannel(tdist.DistributedEnv("x:1", 2, 0),
                                   member_timeout_s=0.2, ack_store=store)
    leader.publish(tdist.StepEvents())
    mon = tdist.GroupLivenessMonitor(leader, poll_interval_s=0.05)
    mon.start()
    try:
        mon._thread.join(5.0)
    finally:
        mon.stop()
    assert exits == [1]
    assert "member 1" in store.get(tdist._fail_key(leader.epoch))


class _StepEngine:
    def __init__(self):
        self.added = []

    def has_unfinished(self):
        return bool(self.added)

    def has_pending(self):
        return False

    def abort_request(self, rid):
        pass

    def add_request(self, rid, **kw):
        self.added.append(rid)

    def step(self):
        raise RuntimeError("collective desync")


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("failure", ["step", "epoch-mismatch"])
def test_follower_loop_exits_nonzero(pkg, failure, monkeypatch):
    d = PACKAGES[pkg]
    exits = []
    monkeypatch.setattr(d, "fatal_exit", exits.append)

    class Channel:
        denv = d.DistributedEnv("x:1", 2, 1)

        def receive(self):
            if failure == "epoch-mismatch":
                raise d.GroupEpochMismatch("epoch changed 1 -> 2")
            return d.StepEvents(requests=[("r1", [1, 2], None, None)])

    d.follower_loop(_StepEngine(), Channel())
    assert exits == [1]


def test_coordinator_ack_store_reads_a_tcp_store_without_blocking():
    import torch.distributed as dist

    store = dist.TCPStore("127.0.0.1", 0, 1, is_master=True,
                          timeout=datetime.timedelta(seconds=30))
    acks = tdist.CoordinatorAckStore(store)
    assert acks.get("pstpu/1/ack/1/1") is None  # absent: None at once
    acks.set("pstpu/1/ack/1/1", "7")
    assert acks.get("pstpu/1/ack/1/1") == "7"

    class Broken:
        def set(self, *a):
            raise RuntimeError("store down")

        def check(self, *a):
            raise RuntimeError("store down")

    broken = tdist.CoordinatorAckStore(Broken())
    broken.set("k", "v")  # degrades to a no-op
    assert broken.get("k") is None
    with pytest.raises(RuntimeError, match="not initialized"):
        tdist.CoordinatorAckStore()


class _RecordingChannel:
    def __init__(self, heartbeat_seconds=10.0):
        self.heartbeat_seconds = heartbeat_seconds
        self.published = []

    def publish(self, events):
        self.published.append(events)


def _config(**extra):
    return config_from_preset("tiny-llama", **{
        "scheduler.max_num_seqs": 2, "scheduler.max_model_len": 128,
        "cache.num_blocks": 64, **extra})


async def test_leader_publishes_every_batch_before_it_steps():
    """One publish per step (K = 1 steps here), the request's token ids
    in the first, a shutdown on close; no encode lane under lockstep."""
    channel = _RecordingChannel()
    aeng = AsyncEngine(_config(**{"scheduler.multi_step_window": False}),
                       device="cpu", lockstep=channel)
    steps = []
    step = aeng.engine.step

    def counted():
        steps.append(len(channel.published))
        return step()

    aeng.engine.step = counted
    await aeng.start()
    try:
        tokens = [ev.token_id async for ev in aeng.generate(
            prompt="hello world", sampling_params=SamplingParams(max_tokens=3),
            request_id="r1")]
    finally:
        await aeng.close()
    assert len(tokens) == 3
    requests = [r for ev in channel.published for r in ev.requests]
    assert [r[0] for r in requests] == ["r1"] and requests[0][1]
    assert channel.published[-1].shutdown
    # Every step ran after a publish of its own.
    assert steps == sorted(set(steps)) and steps[0] >= 1
    assert sum(1 for ev in channel.published if not ev.shutdown) >= len(steps)


async def test_leader_folds_deadline_expiry_into_the_published_aborts():
    """A queued request past its deadline is aborted through the
    published batch (the followers replay the leader's clock): one batch
    slot, held by a long stream, while a request whose deadline has
    passed waits."""
    channel = _RecordingChannel()
    aeng = AsyncEngine(_config(**{"scheduler.max_num_seqs": 1}), device="cpu",
                       lockstep=channel)
    gate = asyncio.Event()
    dispatch = aeng.engine.dispatch
    loop = asyncio.get_running_loop()

    def held():
        # Hold the first dispatch until the late request is queued.
        asyncio.run_coroutine_threadsafe(gate.wait(), loop).result(10)
        return dispatch()

    aeng.engine.dispatch = held
    await aeng.start()
    try:
        live = aeng.generate(prompt="a", sampling_params=SamplingParams(max_tokens=30),
                             request_id="live")
        first = asyncio.ensure_future(live.__anext__())
        await asyncio.sleep(0.2)
        late = aeng.generate(prompt="b", request_id="late",
                             sampling_params=SamplingParams(max_tokens=2, deadline=1.0))
        late_first = asyncio.ensure_future(late.__anext__())
        await asyncio.sleep(0.2)
        gate.set()
        with pytest.raises(Exception, match="missed its deadline"):
            await asyncio.wait_for(late_first, 10)
        await asyncio.wait_for(first, 10)
        async for _ in live:
            pass
    finally:
        gate.set()
        await aeng.close()
    assert ["late"] in [ev.aborts for ev in channel.published]


async def test_leader_heartbeats_while_idle():
    channel = _RecordingChannel(heartbeat_seconds=0.2)
    aeng = AsyncEngine(_config(), device="cpu", lockstep=channel)
    assert aeng.encode_batcher is not None  # a stub channel has no denv
    await aeng.start()
    try:
        await asyncio.sleep(1.0)
    finally:
        await aeng.close()
    beats = [ev for ev in channel.published
             if not ev.requests and not ev.aborts and not ev.shutdown]
    assert len(beats) >= 3


async def test_leader_step_failure_under_lockstep_is_fatal(monkeypatch):
    exits = []
    monkeypatch.setattr(tdist, "fatal_exit", exits.append)
    channel = _RecordingChannel()
    aeng = AsyncEngine(_config(), device="cpu", lockstep=channel)
    aeng.engine.dispatch = None  # any step raises TypeError
    await aeng.start()
    try:
        async def one_token():
            async for _ in aeng.generate(prompt="x",
                                         sampling_params=SamplingParams(max_tokens=1)):
                break

        with pytest.raises(asyncio.TimeoutError):
            await asyncio.wait_for(one_token(), timeout=5.0)
    finally:
        await aeng.close()
    assert exits == [1]
    assert any(ev.shutdown for ev in channel.published)


def test_data_parallel_inside_a_group_exits_with_the_jax_message(monkeypatch):
    monkeypatch.setenv("PSTPU_NUM_PROCESSES", "2")
    monkeypatch.setenv("PSTPU_PROCESS_ID", "0")
    monkeypatch.setenv("PSTPU_COORDINATOR_ADDRESS", "127.0.0.1:1")
    with pytest.raises(SystemExit, match=r"--data-parallel > 1 is not supported "
                       "inside a multi-host slice group; scale replicas with the "
                       "chart's replicaCount"):
        port_server.main(["--device", "cpu", "--data-parallel", "2"])
    assert tdist.tp_group() is None  # refused before any group formed
