"""Tensor parallelism across processes: two ranks of a gloo group on the
CPU (``parallel/distributed.py``), each holding one tp position of
tp = 2, against the JAX engine's tp = 2 mesh and the port's in-process
tp = 2 engine.

- Two processes (``torch_group_worker.py``) run float32 tiny-llama and a
  tiny MoE model with its experts over tp through the real
  ``LockstepChannel`` and ``follower_loop``: the leader's greedy streams
  equal the JAX tp = 2 engine's token for token (8 virtual devices,
  tests/conftest.py); both ranks' teacher-forced logits equal the
  in-process tp = 2 engine's bit for bit (a sum of two fp32 operands does
  not depend on their order); both ranks sample the same tokens at every
  step, and each holds one position's pool.
- The leader's and the follower's real ``api_server`` with the
  ``PSTPU_*`` variables: a stream over HTTP that equals the in-process
  tp = 2 engine's, the follower's ``/health`` and ``/ready``, and a
  ``/drain`` on the follower relayed to the leader, after which both
  exit 0.
- A one-rank gloo group in this process at tp = 2 (dense, int8 weights,
  MoE): the weights cut as they are drawn, logits equal to the
  in-process tp = 2 engine's bit for bit.

Two tests spawn a group; each bounds its processes' time and kills them
when it runs out (a rank that diverges leaves the other waiting in a
collective forever).
"""

import json
import os
import pickle
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
from torch_group_worker import SCHED, port_config, teacher_forced

from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine.core.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.core.sequence import SamplingParams as JaxSP
from production_stack_tpu_torch.engine.core.engine import LLMEngine
from production_stack_tpu_torch.engine.core.sequence import SamplingParams
from production_stack_tpu_torch.engine.models.weights import params_from_numpy
from production_stack_tpu_torch.engine.parallel import distributed as tdist
from production_stack_tpu_torch.engine.server import api_server as port_server
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_group_worker.py")
MODELS = {"dense": None,
          "moe": dict(num_experts=4, num_experts_per_tok=2, intermediate_size=64)}
LONG = "the quick brown fox jumps over the lazy dog, " * 3
PROMPTS = [
    (0, "a", LONG, 10),
    (0, "b", "sequence parallel ring attention on a tpu mesh", 12),
    (2, "c", "short", 9),
    (5, "d", "a prompt arriving while the others decode " * 2, 8),
]
TOKENS = [3, 77, 150, 9, 300, 41, 41, 222, 5, 381, 64, 12, 199, 250, 7, 100, 33]
GROUP_TIMEOUT_S = 240


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return np.asarray(tree)


def jax_tp2_engine(model) -> JaxEngine:
    """tests/test_parallel.py's ``mesh_engine`` at tp = 2 (its
    ``moe_engine`` with ``model``)."""
    return JaxEngine(jcfg.EngineConfig(
        model=jcfg.ModelConfig(dtype="float32", **(model or {})),
        cache=jcfg.CacheConfig(block_size=4, num_blocks=128),
        parallel=jcfg.ParallelConfig(tensor_parallel=2),
        scheduler=jcfg.SchedulerConfig(**SCHED),
    ))


def drive(engine, reqs, SP):
    """Run [(arrival step, id, prompt, max_tokens)] to the end; {id: tokens}."""
    outs, pending, step = {}, sorted(reqs, key=lambda r: r[0]), 0
    while pending or engine.has_unfinished() or getattr(engine, "has_pending", bool)():
        while pending and pending[0][0] <= step:
            _, rid, prompt, n = pending.pop(0)
            engine.add_request(rid, prompt=prompt, sampling_params=SP(max_tokens=n))
        for out in engine.step():
            outs.setdefault(out.seq_id, []).append(out.new_token_id)
        step += 1
        assert step < 500, "engine failed to drain"
    return outs


def wait_all(procs, timeout_s: float) -> list:
    """The processes' exit codes; all of them killed, and the test failed,
    if any is still running after ``timeout_s``."""
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pytest.fail(f"the group did not finish within {timeout_s} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
    return [p.returncode for p in procs]


def env_for(rank: int, coordinator: str) -> dict:
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2", PSTPU_NUM_PROCESSES="2",
                PSTPU_PROCESS_ID=str(rank), PSTPU_COORDINATOR_ADDRESS=coordinator)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX tp = 2 engines' weights (numpy) and streams per model, and
    both ranks' results ({model: {streams, steps, logits, pool, ...}});
    the JAX engines run while the group does."""
    engines = {name: jax_tp2_engine(model) for name, model in MODELS.items()}
    params = {name: to_numpy(engine.params) for name, engine in engines.items()}
    spec = {
        "world": 2, "coordinator": f"127.0.0.1:{free_port()}",
        "cases": {name: {"model": MODELS[name], "params": params[name],
                         "requests": PROMPTS, "tokens": TOKENS}
                  for name in MODELS},
    }
    path = str(tmp_path_factory.mktemp("group") / "spec.pkl")
    with open(path, "wb") as f:
        pickle.dump(spec, f)
    # Two threads a rank: the JAX engines run beside them.
    procs = [subprocess.Popen([sys.executable, WORKER, path, str(rank)], cwd=REPO,
                              env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"))
             for rank in range(2)]
    try:
        streams = {name: drive(engine, PROMPTS, JaxSP) for name, engine in engines.items()}
    finally:
        rcs = wait_all(procs, GROUP_TIMEOUT_S)
    assert rcs == [0, 0]
    ranks = []
    for rank in range(2):
        with open(f"{path}.{rank}", "rb") as f:
            ranks.append(pickle.load(f))
    return {"params": params, "streams": streams, "ranks": ranks}


@pytest.mark.parametrize("case", list(MODELS))
def test_group_streams_match_the_jax_tp2_engine(case, runs):
    leader = runs["ranks"][0][case]
    assert leader["streams"] == runs["streams"][case]
    assert leader["windows"] > 0


@pytest.mark.parametrize("case", list(MODELS))
def test_group_logits_equal_the_in_process_tp2_engine(case, runs):
    cfg = port_config(2, MODELS[case])
    port = LLMEngine(cfg, device=["cpu"] * 2,
                     params=params_from_numpy(cfg.model, runs["params"][case], "cpu"))
    want = teacher_forced(port, TOKENS)
    for rank in range(2):
        np.testing.assert_array_equal(runs["ranks"][rank][case]["logits"], want)


@pytest.mark.parametrize("case", list(MODELS))
def test_group_ranks_sample_the_same_tokens_at_every_step(case, runs):
    leader, follower = runs["ranks"][0][case], runs["ranks"][1][case]
    assert leader["steps"] == follower["steps"]
    assert sum(len(s) for s in leader["steps"]) == sum(
        len(t) for t in leader["streams"].values())
    # One tp position a rank: a [1, N, bs, K/tp, D] pool side each.
    assert leader["pool"] == follower["pool"] == (1, 128, 4, 1, 16)


@pytest.mark.parametrize("case", ["dense", "int8-weights", "moe"])
def test_a_one_rank_group_cuts_its_draw_to_the_in_process_logits(case):
    """A one-rank gloo group formed in this process at tp = 2 (both
    positions here; ``psum`` all-reduces over the group, the lm_head
    all-gathers): the engine cuts each weight as it draws it
    (``RankSlicer``; an int8 projection quantized whole first) and gives
    the in-process tp = 2 engine's logits bit for bit."""
    model = {"dense": {}, "int8-weights": {"quantization": "int8"},
             "moe": MODELS["moe"]}[case]
    local = LLMEngine(port_config(2, model), device=["cpu"] * 2)  # the seeded draw
    want = teacher_forced(local, TOKENS)
    tdist.initialize(tdist.DistributedEnv(f"127.0.0.1:{free_port()}", 1, 0), device="cpu")
    try:
        eng = LLMEngine(port_config(2, model), device="cpu")
        assert (eng.group.world, eng.tp_local, eng.params.group) == (1, 2, eng.group)
        np.testing.assert_array_equal(teacher_forced(eng, TOKENS), want)
    finally:
        tdist.shutdown()
    assert tdist.tp_group() is None


def http(method: str, url: str, body=None, timeout=30.0):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"content-type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def wait_ready(url: str, procs, timeout_s: float) -> None:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if any(p.poll() is not None for p in procs):
            pytest.fail("a group member exited during boot")
        try:
            if http("GET", url, timeout=2.0)[0] == 200:
                return
        except OSError:
            pass
        time.sleep(0.2)
    pytest.fail(f"{url} not ready within {timeout_s} s")


def test_server_pair_streams_and_relays_a_follower_drain():
    flags = ["--model", "tiny-llama", "--dtype", "float32", "--tensor-parallel", "2",
             "--max-num-seqs", "4", "--max-model-len", "256", "--num-blocks", "64",
             "--no-prefix-caching", "--slice-member-timeout-s", "4"]
    coordinator = f"127.0.0.1:{free_port()}"
    ports = [free_port(), free_port()]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "production_stack_tpu_torch.engine.server.api_server",
         "--device", "cpu", "--port", str(ports[rank]), *flags],
        cwd=REPO, env=env_for(rank, coordinator),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL) for rank in range(2)]
    leader, follower = (f"http://127.0.0.1:{p}" for p in ports)
    try:
        wait_ready(leader + "/ready", procs, 120)
        status, body = http("GET", follower + "/health")
        assert status == 200 and json.loads(body)["role"] == "follower"
        assert http("GET", follower + "/ready")[0] == 200
        prompt = "the quick brown fox jumps over the lazy dog"
        status, body = http("POST", leader + "/v1/completions", {
            "model": "tiny-llama", "prompt": prompt, "max_tokens": 12,
            "temperature": 0, "stream": True, "ignore_eos": True})
        assert status == 200
        chunks = [json.loads(line[len("data: "):]) for line in body.splitlines()
                  if line.startswith("data: ") and line != "data: [DONE]"]
        text = "".join(c["choices"][0]["text"] for c in chunks)
        assert body.rstrip().endswith("data: [DONE]")
        # The in-process tp = 2 engine on the same seeded weights.
        cfg = port_server.config_from_args(port_server.build_parser().parse_args(flags))
        local = LLMEngine(cfg, device=["cpu"] * 2)
        local.add_request("r", prompt=prompt, sampling_params=SamplingParams(
            max_tokens=12, temperature=0.0, ignore_eos=True))
        tokens = []
        while local.has_unfinished() or local.has_pending():
            tokens += [o.new_token_id for o in local.step()]
        assert text == local.tokenizer.decode(tokens)
        # A drain on the follower is relayed: the leader drains the group.
        status, body = http("POST", follower + "/drain")
        assert status == 200 and json.loads(body)["relayed"] is True
        assert wait_all(procs, 60) == [0, 0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
