"""Guided decoding in the PyTorch engine against the JAX engine.

- The port's copies of the JSON automaton and the schema compiler
  (``engine/guided.py``, ``engine/guided_schema.py``) against the JAX
  package's: the same states, verdicts, closure costs and finish points
  over random token strings, the same compile results and errors over a
  grid of schemas, the same ``validate_instance`` answers.
- Both engines serve float32 tiny-llama with the same weights at the JAX
  engine's defaults (K=8 windows with the lookahead, mixed and packed
  K-step windows): greedy ``json_object`` and ``json_schema`` streams
  beside plain rows, one closing on a small budget, one in K=1 mixed steps
  while a prompt waits, must be equal token for token, with equal finish
  reasons, fallback counters and flight records (declines named
  ``"guided"``).
- Sampled guided rows (temperature 0.8, a seed) parse, and two port
  engines give the same stream; they are not held to JAX (the draws
  differ).
"""

import dataclasses
import json

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from production_stack_tpu.engine import config as jcfg
from production_stack_tpu.engine import guided as jguided
from production_stack_tpu.engine import guided_schema as jschema
from production_stack_tpu.engine.core.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.core.sequence import SamplingParams as JaxSP
from production_stack_tpu_torch.engine import config as tcfg
from production_stack_tpu_torch.engine import guided as tguided
from production_stack_tpu_torch.engine import guided_schema as tschema
from production_stack_tpu_torch.engine.core.engine import SLICE_OVERRIDES, LLMEngine
from production_stack_tpu_torch.engine.core.sequence import SamplingParams
from production_stack_tpu_torch.engine.models.weights import params_from_numpy
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SCHEMA = {
    "type": "object",
    "properties": {
        "name": {"type": "string"},
        "age": {"type": "integer"},
        "mode": {"enum": ["fast", "slow"]},
        "tags": {"type": "array", "items": {"type": "string"}, "maxItems": 2},
    },
}

SCHEMAS = [
    SCHEMA,
    {"type": "integer"},
    {"type": "string"},
    {"enum": [1, 12, "x", None, True]},
    {"type": "array", "items": {"type": "number"}, "minItems": 1, "maxItems": 3},
    {"type": "object", "properties": {}},
    {"properties": {"a": {}, "b": {"type": "boolean"}, "c": {"type": "null"}}},
    {"type": "object", "properties": {"o": SCHEMA}, "required": ["o"]},
    # outside the subset
    {"anyOf": [{"type": "string"}]},
    {"type": "object", "properties": {"x": {"$ref": "#/defs/x"}}},
    {"type": "weird"},
    {"enum": []},
    {"enum": [[1]]},
    {"type": "array", "minItems": 3, "maxItems": 1},
    {"type": "object", "properties": [1]},
    "not a schema",
]

# Bytes and short strings that walk the automata past their first byte.
PIECES = [b"{", b"}", b"[", b"]", b'"', b":", b",", b" ", b"\n", b"\\", b"u",
          b"0", b"1", b"9", b"-", b".", b"e", b"+", b"a", b"x", b"true", b"null",
          b"false", b'"name"', b'"age"', b'"mode"', b'"tags"', b'"fast"', b'{"',
          b'":', b"\xc3\xa9", b"12", b"\t"]
TOKENS = st.lists(st.one_of(st.sampled_from(PIECES), st.binary(min_size=0, max_size=3)),
                  max_size=24)


def norm(x):
    """A guide state as plain tuples: each package's FSMState becomes its
    fields, so the two packages' states compare."""
    if dataclasses.is_dataclass(x):
        return ("FSMState",) + tuple(norm(v) for v in dataclasses.astuple(x))
    if isinstance(x, tuple):
        return tuple(norm(v) for v in x)
    return x


def guide_pairs():
    yield jguided.JsonGuide(True), tguided.JsonGuide(True)
    yield jguided.JsonGuide(False), tguided.JsonGuide(False)
    for schema in SCHEMAS[:8]:
        yield jschema.SchemaGuide(schema), tschema.SchemaGuide(schema)


def compare(jg, tg):
    assert jg.done == tg.done
    assert jg.may_finish() == tg.may_finish()
    assert jg.closure_cost() == tg.closure_cost()


@settings(max_examples=150, deadline=None, database=None)
@given(tokens=TOKENS, closing=st.lists(st.booleans(), min_size=24, max_size=24))
def test_automata_match_the_jax_package(tokens, closing):
    """try_token / accept over a random token string, closing mode
    toggled: equal verdicts, states, closure costs and finish points; and
    advance_bytes over the whole string."""
    for require_object in (True, False):
        data = b"".join(tokens)
        want = jguided.advance_bytes(jguided.initial_state(require_object), data)
        got = tguided.advance_bytes(tguided.initial_state(require_object), data)
        assert norm(got) == norm(want)
    for jg, tg in guide_pairs():
        compare(jg, tg)
        for tok, close in zip(tokens, closing):
            jg.closing = tg.closing = close
            js, ts = jg.try_token(tok), tg.try_token(tok)
            assert norm(ts) == norm(js)
            if js is not None:
                jg.accept(js, tok)
                tg.accept(ts, tok)
            compare(jg, tg)
        if jg.may_finish():
            jg.finalize()
            tg.finalize()
            compare(jg, tg)


@pytest.mark.parametrize("i", range(len(SCHEMAS)))
def test_compile_schema_matches_the_jax_package(i):
    """Each schema compiles to the same node tree in both packages, or
    both refuse it with the same message (a ValueError: a 400 upstream)."""
    schema = SCHEMAS[i]
    try:
        want = jschema.compile_schema(schema)
    except jschema.SchemaCompileError as e:
        with pytest.raises(tschema.SchemaCompileError) as got:
            tschema.compile_schema(schema)
        assert str(got.value) == str(e)
        assert isinstance(got.value, ValueError)
        return
    assert tschema.compile_schema(schema) == want
    assert tschema.compile_schema_cached(schema) == want


def test_validate_instance_matches_the_jax_package():
    ok = {"name": "a", "age": 1, "mode": "slow", "tags": ["x", "y"]}
    instances = [ok, {**ok, "age": "1"}, {**ok, "age": True}, {**ok, "mode": "medium"},
                 {**ok, "tags": ["x", "y", "z"]}, {**ok, "extra": 1}, [], None, 12,
                 "x", 1.5, True, [1.0], [1, 2, 3, 4], {}, {"a": 1, "b": False, "c": None},
                 {"o": ok}]
    for schema in SCHEMAS[:8]:
        for value in instances:
            assert (tschema.validate_instance(schema, value)
                    == jschema.validate_instance(schema, value)), (schema, value)


# -- the engines -------------------------------------------------------------

SCHED = dict(max_num_seqs=4, prefill_buckets=(16, 32, 64), max_model_len=192)
RECORD_FIELDS = ("kind", "k", "rows", "seq_ids", "fallback", "tokens_emitted",
                 "tokens_delivered", "tokens_wasted", "chunk_prompts",
                 "chunk_tokens_planned", "chunk_tokens_delivered")


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_numpy(v) for v in tree]
    return np.asarray(tree)


def port_engine(tree, **sched):
    cfg = tcfg.EngineConfig(
        model=tcfg.ModelConfig(dtype="float32"),
        cache=tcfg.CacheConfig(block_size=4, num_blocks=160),
        scheduler=tcfg.SchedulerConfig(**SCHED, **sched),
    )
    for key, value in SLICE_OVERRIDES.items():
        part, name = key.split(".")
        setattr(getattr(cfg, part), name, value)
    return LLMEngine(cfg, device="cpu", params=params_from_numpy(cfg.model, tree, "cpu"))


@pytest.fixture(scope="module")
def pair():
    ref = JaxEngine(jcfg.EngineConfig(
        model=jcfg.ModelConfig(dtype="float32"),
        cache=jcfg.CacheConfig(block_size=4, num_blocks=160),
        scheduler=jcfg.SchedulerConfig(**SCHED, preemption_mode="recompute"),
    ))
    port = port_engine(to_numpy(ref.params))
    assert port._window_steps == ref._window_steps == 8
    return ref, port


def drive(engine, reqs):
    """Run [(arrival step, id, prompt, params)] to the end; returns
    (streams, finish reasons)."""
    outs, finish = {}, {}
    pending = sorted(reqs, key=lambda r: r[0])
    step = 0
    while pending or engine.has_unfinished() or engine.has_pending():
        while pending and pending[0][0] <= step:
            _, rid, prompt, sp = pending.pop(0)
            engine.add_request(rid, prompt=prompt, sampling_params=sp)
        for out in engine.step():
            outs.setdefault(out.seq_id, []).append(out.new_token_id)
            if out.finished:
                finish[out.seq_id] = out.finish_reason.value
        step += 1
        assert step < 400, "engine failed to drain"
    return outs, finish


def records(engine, rids):
    """The flight records of the dispatches that rode any of ``rids``, in
    dispatch order, without times."""
    snap = sorted(engine.obs.recorder.snapshot(), key=lambda d: d["window_id"])
    return [tuple(d.get(f) for f in RECORD_FIELDS) for d in snap
            if set(d["seq_ids"]) & set(rids)]


def counters(engine):
    s = engine.stats()
    return (dict(s["multistep_fallback"]), s["multistep_wasted_tokens"],
            s["prefill_chunk_tokens"])


def text(engine, ids):
    return engine.tokenizer.decode([t for t in ids if t >= 0])


def test_greedy_guided_streams_match_the_jax_engine(pair):
    """json_object and json_schema rows beside plain rows: one closing on
    an 8-token budget, a prompt of 90 tokens arriving while they run (K=1
    mixed steps carry its chunks), a guided row arriving last; then the
    plain rows finish alone in K-step windows again."""
    ref, port = pair
    schema_rf = {"type": "json_schema", "schema": SCHEMA}

    def reqs(SP):
        return [
            (0, "obj", "hello", SP(max_tokens=40, response_format="json_object")),
            (0, "plain", "plain text", SP(max_tokens=70, ignore_eos=True)),
            (0, "tight", "abc", SP(max_tokens=8, response_format="json_object")),
            (2, "schema", "produce json:", SP(max_tokens=64, response_format=schema_rf)),
            (3, "long", "a long prompt that waits " * 4, SP(max_tokens=30, ignore_eos=True)),
            (9, "late", "x", SP(max_tokens=24, response_format="json_object",
                                ignore_eos=True)),
        ]

    rids = [r[1] for r in reqs(SamplingParams)]
    want = drive(ref, reqs(JaxSP))
    windows = port.windows_dispatched
    got = drive(port, reqs(SamplingParams))
    assert got == want
    assert counters(port) == counters(ref)
    assert counters(port)[0].get("guided", 0) > 0
    assert records(port, rids) == records(ref, rids)
    assert "guided" in {r[4] for r in records(port, rids)}
    streams, finish = got
    for rid in ("obj", "tight", "schema", "late"):
        assert finish[rid] == "stop", (rid, finish)
        value = json.loads(text(port, streams[rid]))
        assert isinstance(value, dict)
    assert tschema.validate_instance(SCHEMA, json.loads(text(port, streams["schema"])))
    assert len(streams["tight"]) <= 8
    # The plain rows ran windows again once the guided rows were done.
    assert port.windows_dispatched > windows
    assert port.stats()["prefill_chunk_tokens"] > 0


def test_guided_rows_are_skipped_by_the_legacy_speculative_path(pair):
    """A guided row keeps the batch off the legacy n-gram verify, as in
    the JAX engine's predicate; finishing guided rows pass the final check
    of the assembled text."""
    legacy = port_engine(to_numpy(pair[0].params), speculative_ngram=3,
                         multi_step_window=False, pipeline_decode=False,
                         mixed_batch=False)
    assert legacy._legacy_spec == 3
    guided_in_verify = []
    real = legacy._run_decode_speculative

    def spy(plan, k):
        guided_in_verify.append(any(s.guide is not None for s in plan.seqs))
        return real(plan, k)

    legacy._run_decode_speculative = spy
    streams, finish = drive(legacy, [
        (0, "g", "hello", SamplingParams(max_tokens=32, response_format="json_object")),
        (0, "p", "plain", SamplingParams(max_tokens=60, ignore_eos=True)),
    ])
    # The plain row speculates once the guided row is done, never beside it.
    assert guided_in_verify and not any(guided_in_verify)
    assert finish["g"] == "stop"
    assert isinstance(json.loads(text(legacy, streams["g"])), dict)


def test_sampled_guided_rows_parse_and_repeat_across_port_engines(pair):
    ref, _ = pair
    tree = to_numpy(ref.params)

    def reqs():
        return [
            (0, "s1", "hello", SamplingParams(max_tokens=48, temperature=0.8, seed=11,
                                              response_format="json_object")),
            (0, "s2", "schema:", SamplingParams(
                max_tokens=64, temperature=0.8, seed=12,
                response_format={"type": "json_schema", "schema": SCHEMA})),
            (1, "p", "plain", SamplingParams(max_tokens=20, temperature=0.8, seed=13)),
        ]

    runs = [drive(port_engine(tree), reqs()) for _ in range(2)]
    assert runs[0] == runs[1]
    engine = port_engine(tree)
    streams, finish = runs[0]
    assert isinstance(json.loads(text(engine, streams["s1"])), dict)
    assert tschema.validate_instance(SCHEMA, json.loads(text(engine, streams["s2"])))
    assert finish["s1"] == finish["s2"] == "stop"


def test_final_check_rewrites_an_invalid_assembled_text(pair):
    """The automaton checks each token's own text; the finish re-checks
    the assembled text and rewrites the reason to guided_invalid when it
    does not parse, as the JAX engine does."""
    _, port = pair
    real = port.tokenizer.decode

    def corrupting(ids, *a, **k):
        return "not json {" if len(ids) > 1 else real(ids, *a, **k)

    port.tokenizer.decode = corrupting
    try:
        _, finish = drive(port, [(0, "bad", "hello", SamplingParams(
            max_tokens=40, response_format="json_object"))])
    finally:
        del port.tokenizer.decode
    assert finish["bad"] == "guided_invalid"
