"""The encode routes inside a multi-process group: gloo groups on the CPU
(``parallel/distributed.py``) against the JAX ``embed`` on the same mesh.

- Two ranks of ``tests/torch_group_worker.py`` at tp = 2, and two at sp =
  2: the leader publishes texts to embed beside streaming requests
  (``StepEvents.encodes``), every rank runs the serial ``embed`` before
  the iteration's step, and the leader keeps the vectors.  They equal the
  JAX engine's ``embed`` on a one-process mesh of the same shape within
  1e-5 (at sp = 2 every rank runs the whole text, as the JAX ``embed``
  runs full attention on an sp mesh); the streams equal the JAX engine's
  token for token; each follower ran as many encode forwards and
  attentions as the leader.
- The real ``api_server`` as a tp = 2 pair, the JAX engine's weights
  loaded from an HF checkpoint (``--weights-path``): ``/v1/embeddings``,
  ``/v1/rerank`` and ``/v1/score`` answer 200 with the JAX ``embed``'s
  vectors and their dot products within 1e-5, and a stream served around
  them gives the JAX engine's greedy text.

Each spawn bounds its processes' time and kills them when it runs out.
"""

import json
import os
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from test_torch_group import env_for, free_port, http, to_numpy, wait_all, wait_ready
from torch_group_worker import SCHED

from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine.core.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.core.sequence import SamplingParams as JaxSP
from production_stack_tpu_torch.engine.tokenizer import get_tokenizer
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_group_worker.py")
PROMPTS = [
    (0, "a", "the quick brown fox jumps over the lazy dog, " * 2, 10),
    (1, "b", "a stream that runs while texts are embedded", 12),
    (4, "c", "short", 8),
]
TEXTS = ["an embedding of a short text", "embed me while the streams decode " * 3,
         "x", "a fourth text, embedded with the third in one iteration"]
# (arrival step, text index): one text before any stream, the others
# while they decode, two in one iteration.
ENCODES = [(0, 0), (2, 1), (5, 2), (5, 3)]
TOL = 1e-5
SPAWN_TIMEOUT_S = 240
# case -> (world, (tp, sp))
CASES = {"tp2": (2, (2, 1)), "sp2": (2, (1, 2))}


def jax_engine(tp=1, sp=1):
    return JaxEngine(jcfg.EngineConfig(
        model=jcfg.ModelConfig(dtype="float32"),
        cache=jcfg.CacheConfig(block_size=4, num_blocks=128),
        parallel=jcfg.ParallelConfig(tensor_parallel=tp, sequence_parallel=sp),
        scheduler=jcfg.SchedulerConfig(**SCHED),
    ))


def drive(engine, reqs):
    outs, pending, step = {}, sorted(reqs, key=lambda r: r[0]), 0
    while pending or engine.has_unfinished():
        while pending and pending[0][0] <= step:
            _, rid, prompt, n = pending.pop(0)
            engine.add_request(rid, prompt=prompt, sampling_params=JaxSP(max_tokens=n))
        for out in engine.step():
            outs.setdefault(out.seq_id, []).append(out.new_token_id)
        step += 1
        assert step < 500, "engine failed to drain"
    return outs


def token_ids(text):
    return get_tokenizer(None).encode(text)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per case: the JAX engine's vectors of ``TEXTS`` and streams on the
    case's mesh, and both ranks' results."""
    refs = {case: jax_engine(tp, sp) for case, (_, (tp, sp)) in CASES.items()}
    params = to_numpy(refs["tp2"].params)
    work = tmp_path_factory.mktemp("group_encode")
    procs, paths = [], {}
    for case, (world, (tp, sp)) in CASES.items():
        paths[case] = str(work / f"{case}.pkl")
        with open(paths[case], "wb") as f:
            pickle.dump({"world": world, "coordinator": f"127.0.0.1:{free_port()}",
                         "sequence_parallel": sp,
                         "cases": {case: {
                             "model": None, "params": params, "requests": PROMPTS,
                             "skip_checks": True,
                             "parallel": dict(tensor_parallel=tp, sequence_parallel=sp),
                             "encodes": [(step, token_ids(TEXTS[i])) for step, i in ENCODES],
                         }}}, f)
        procs += [subprocess.Popen([sys.executable, WORKER, paths[case], str(rank)], cwd=REPO,
                                   env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
                  for rank in range(world)]
    try:
        want = {case: ([np.asarray(ref.embed(token_ids(TEXTS[i]))) for _, i in ENCODES],
                       drive(ref, PROMPTS)) for case, ref in refs.items()}
    finally:
        rcs = wait_all(procs, SPAWN_TIMEOUT_S)
    assert rcs == [0] * len(procs)
    ranks = {}
    for case, path in paths.items():
        ranks[case] = []
        for rank in range(CASES[case][0]):
            with open(f"{path}.{rank}", "rb") as f:
                ranks[case].append(pickle.load(f)[case])
    return {"params": params, "want": want, "ranks": ranks, "jax_tp2": refs["tp2"]}


@pytest.mark.parametrize("case", list(CASES))
def test_group_embeddings_equal_the_jax_embed_on_the_same_mesh(case, runs):
    leader = runs["ranks"][case][0]
    vectors, _ = runs["want"][case]
    assert len(leader["vectors"]) == len(ENCODES)
    for got, want in zip(leader["vectors"], vectors):
        np.testing.assert_allclose(got, want, atol=TOL)
        assert abs(np.linalg.norm(got) - 1.0) < 1e-5


@pytest.mark.parametrize("case", list(CASES))
def test_embeds_between_steps_leave_the_streams_equal_to_the_jax_engine(case, runs):
    leader, follower = runs["ranks"][case]
    _, streams = runs["want"][case]
    assert leader["streams"] == streams
    assert leader["steps"] == follower["steps"]


@pytest.mark.parametrize("case", list(CASES))
def test_followers_run_the_leaders_encode_forwards(case, runs):
    leader, follower = runs["ranks"][case]
    assert leader["encodes"] == follower["encodes"]
    assert leader["encodes"]["forwards"] == len(ENCODES)
    assert leader["encodes"]["attentions"] == len(ENCODES) * 2  # two layers a forward
    assert follower["vectors"] == []  # the leader keeps the vectors


def write_checkpoint(params, path) -> None:
    """``params`` (the JAX layout, numpy) as an HF safetensors checkpoint:
    the names and torch's [out, in] Linear layout."""
    from safetensors.torch import save_file

    t = lambda a: torch.from_numpy(np.array(a, order="C"))  # noqa: E731
    hf = {"model.embed_tokens.weight": t(params["embed_tokens"]),
          "model.norm.weight": t(params["norm"]), "lm_head.weight": t(params["lm_head"].T)}
    for i, layer in enumerate(params["layers"]):
        p = f"model.layers.{i}."
        hf[p + "input_layernorm.weight"] = t(layer["input_layernorm"])
        hf[p + "post_attention_layernorm.weight"] = t(layer["post_attention_layernorm"])
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            hf[p + f"self_attn.{name}.weight"] = t(layer[name].T)
        for name in ("gate_proj", "up_proj", "down_proj"):
            hf[p + f"mlp.{name}.weight"] = t(layer[name].T)
    os.makedirs(path, exist_ok=True)
    save_file(hf, os.path.join(path, "model.safetensors"))


def test_server_pair_answers_the_encode_routes_with_the_jax_vectors(runs, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    write_checkpoint(runs["params"], ckpt)
    flags = ["--model", "tiny-llama", "--dtype", "float32", "--tensor-parallel", "2",
             "--max-num-seqs", "4", "--max-model-len", "256", "--num-blocks", "64",
             "--weights-path", ckpt, "--slice-member-timeout-s", "4"]
    coordinator = f"127.0.0.1:{free_port()}"
    ports = [free_port(), free_port()]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "production_stack_tpu_torch.engine.server.api_server",
         "--device", "cpu", "--port", str(ports[rank]), *flags],
        cwd=REPO, env=env_for(rank, coordinator),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL) for rank in range(2)]
    leader = f"http://127.0.0.1:{ports[0]}"
    jax = runs["jax_tp2"]
    want = {text: np.asarray(jax.embed(token_ids(text))) for text in TEXTS}
    try:
        wait_ready(leader + "/ready", procs, 120)
        prompt = PROMPTS[0][2]
        with ThreadPoolExecutor(1) as pool:
            stream = pool.submit(http, "POST", leader + "/v1/completions", {
                "model": "tiny-llama", "prompt": prompt, "max_tokens": 16,
                "temperature": 0, "stream": True, "ignore_eos": True})
            status, body = http("POST", leader + "/v1/embeddings",
                                {"model": "tiny-llama", "input": TEXTS[:2]})
            assert status == 200, body
            for item, text in zip(json.loads(body)["data"], TEXTS[:2]):
                np.testing.assert_allclose(item["embedding"], want[text], atol=TOL)
            status, body = http("POST", leader + "/v1/rerank", {
                "model": "tiny-llama", "query": TEXTS[0], "documents": TEXTS[1:]})
            assert status == 200, body
            for r in json.loads(body)["results"]:
                np.testing.assert_allclose(
                    r["relevance_score"],
                    float(np.dot(want[TEXTS[0]], want[TEXTS[1 + r["index"]]])), atol=TOL)
            status, body = http("POST", leader + "/v1/score", {
                "model": "tiny-llama", "text_1": TEXTS[2], "text_2": TEXTS[3]})
            assert status == 200, body
            np.testing.assert_allclose(json.loads(body)["data"][0]["score"],
                                       float(np.dot(want[TEXTS[2]], want[TEXTS[3]])),
                                       atol=TOL)
            status, body = stream.result(60)
        assert status == 200 and body.rstrip().endswith("data: [DONE]")
        text = "".join(json.loads(line[6:])["choices"][0]["text"]
                       for line in body.splitlines()
                       if line.startswith("data: ") and line != "data: [DONE]")
        jax.add_request("s", prompt=prompt,
                        sampling_params=JaxSP(max_tokens=16, temperature=0.0, ignore_eos=True))
        tokens = []
        while jax.has_unfinished():
            tokens += [o.new_token_id for o in jax.step()]
        assert text == jax.tokenizer.decode(tokens)
        assert http("POST", leader + "/drain")[0] == 200
        assert wait_all(procs, 60) == [0, 0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
