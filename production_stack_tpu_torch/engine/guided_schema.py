"""Schema-constrained structured outputs (``response_format: json_schema``).

vLLM compiles JSON schemas to token-level grammars (outlines/xgrammar);
the same capability here rides the byte-level machinery of
``engine/guided.py``, schema-first: the schema compiles to a SCRIPT of
forced structural literals (braces, canonical ``"key":`` headers,
commas) interleaved with typed VALUE SLOTS the model fills — so output
conforms BY CONSTRUCTION, the model only ever chooses the values, and
the host-side candidate-validation loop (engine._guided_override) works
unchanged because :class:`SchemaGuide` duck-types ``JsonGuide``.

Output is canonical: keys in schema order, no insignificant whitespace.
Supported schema subset (everything the OpenAI structured-outputs strict
mode guarantees for flat-to-moderately-nested tool schemas):

* ``type: object`` with ``properties`` (all treated as required, emitted
  in declaration order; ``additionalProperties`` are never produced),
* scalar types ``string`` / ``number`` / ``integer`` / ``boolean`` /
  ``null``,
* ``enum`` of strings or numbers,
* ``type: array`` with ``items`` (+ ``minItems`` / ``maxItems``),
* nested objects/arrays of all of the above,
* absent/unknown ``type``: a free-form JSON value slot.

Unsupported constructs (``anyOf``, ``$ref``, patterns, numeric ranges)
raise :class:`SchemaCompileError` at request admission — a 400, never a
silently ignored constraint.
"""

from __future__ import annotations

import json
from typing import List, Optional, Tuple

from production_stack_tpu_torch.engine.guided import (
    DONE,
    NUM,
    _N_TERMINAL,
    closure_cost as value_closure_cost,
    initial_state,
    step_byte,
)


class SchemaCompileError(ValueError):
    pass


# -- schema -> nodes -------------------------------------------------------
#
# Node forms (plain tuples, hashable):
#   ("lit", bytes)                       forced literal
#   ("seq", (node, ...))                 fixed sequence
#   ("val", restrict)                    one JSON value; restrict in
#                                        ("", "string", "number",
#                                         "integer", "boolean", "null")
#   ("enum", (bytes, ...))               one of fixed JSON literals
#   ("arr", node, min_items, max_items)  [-1 = unbounded]

_SCALARS = {"string", "number", "integer", "boolean", "null"}
_ANNOTATIONS = {
    "title", "description", "default", "examples", "$schema", "required",
    "additionalProperties",
}


def compile_schema(schema: dict):
    """Schema dict -> node tree.  Raises SchemaCompileError on anything
    outside the supported subset."""
    if not isinstance(schema, dict):
        raise SchemaCompileError("schema must be an object")
    unsupported = {
        k for k in schema
        if k not in _ANNOTATIONS
        and k not in ("type", "properties", "items", "enum", "minItems",
                      "maxItems")
    }
    if unsupported:
        raise SchemaCompileError(
            f"unsupported schema keywords: {sorted(unsupported)}"
        )
    if "enum" in schema:
        choices = []
        for v in schema["enum"]:
            if not isinstance(v, (str, int, float, bool)) and v is not None:
                raise SchemaCompileError("enum values must be scalars")
            choices.append(json.dumps(v).encode())
        if not choices:
            raise SchemaCompileError("enum must be non-empty")
        return ("enum", tuple(choices))
    stype = schema.get("type")
    if stype == "object" or (stype is None and "properties" in schema):
        props = schema.get("properties") or {}
        if not isinstance(props, dict):
            raise SchemaCompileError("'properties' must be an object")
        if not props:
            return ("lit", b"{}")
        parts: List = []
        for i, (key, sub) in enumerate(props.items()):
            header = ("," if i else "") + json.dumps(key) + ":"
            parts.append(("lit", header.encode()))
            parts.append(compile_schema(sub))
        return ("seq", (("lit", b"{"), *parts, ("lit", b"}")))
    if stype == "array":
        items = compile_schema(schema.get("items", {}))
        min_items = int(schema.get("minItems", 0))
        max_items = int(schema.get("maxItems", -1))
        if max_items != -1 and max_items < min_items:
            raise SchemaCompileError("maxItems < minItems")
        return ("arr", items, min_items, max_items)
    if stype in _SCALARS:
        return ("val", stype)
    if stype is None:
        return ("val", "")  # free-form JSON value
    raise SchemaCompileError(f"unsupported type {stype!r}")


def _node_min_len(node) -> int:
    kind = node[0]
    if kind == "lit":
        return len(node[1])
    if kind == "seq":
        return sum(_node_min_len(n) for n in node[1])
    if kind == "enum":
        return min(len(c) for c in node[1])
    if kind == "arr":
        _, items, min_items, _ = node
        if min_items == 0:
            return 2  # []
        return 2 + min_items * _node_min_len(items) + (min_items - 1)
    # val: shortest JSON values per restriction.
    restrict = node[1]
    return {"string": 2, "number": 1, "integer": 1, "boolean": 4,
            "null": 4, "": 1}[restrict]


# -- execution: a stack machine over frames --------------------------------
#
# Frame forms:
#   ("lit", bytes, off)
#   ("seq", nodes, idx)        children entered lazily via _enter
#   ("arr", item_node, count, phase)   phase: "open" | "after"
#   ("val", FSMState, restrict)
#   ("enum", choices, off)

_INT_FORBIDDEN = frozenset(b".eE")
_RESTRICT_FIRST = {
    "string": frozenset(b'"'),
    "number": frozenset(b"-0123456789"),
    "integer": frozenset(b"-0123456789"),
    "boolean": frozenset(b"tf"),
    "null": frozenset(b"n"),
}


def _frame_of(node):
    kind = node[0]
    if kind == "lit":
        return ("lit", node[1], 0)
    if kind == "seq":
        return ("seq", node[1], 0)
    if kind == "arr":
        return ("arr", node[1], node[2], node[3], 0, "open")
    if kind == "enum":
        return ("enum", node[1], 0)
    return ("val", initial_state(require_object=False), node[1])


def _enter(stack: Tuple) -> Tuple:
    """Push child frames until the top is a leaf (lit/val/enum/arr)."""
    while stack:
        top = stack[-1]
        if top[0] == "seq":
            nodes, idx = top[1], top[2]
            if idx >= len(nodes):
                # exhausted seq: pop, advance parent
                stack = _pop(stack[:-1])
                continue
            stack = stack + (_frame_of(nodes[idx]),)
            continue
        return stack
    return stack


def _pop(stack: Tuple) -> Tuple:
    """A child frame completed: advance the parent and re-enter."""
    if not stack:
        return stack
    top = stack[-1]
    if top[0] == "seq":
        advanced = ("seq", top[1], top[2] + 1)
        return _enter(stack[:-1] + (advanced,))
    if top[0] == "arr":
        _, item, mn, mx, count, _phase = top
        return stack[:-1] + (("arr", item, mn, mx, count + 1, "after"),)
    return stack


def _completable(frame) -> bool:
    kind = frame[0]
    if kind == "lit":
        return frame[2] >= len(frame[1])
    if kind == "enum":
        return any(frame[2] == len(c) for c in frame[1])
    if kind == "val":
        st = frame[1]
        return st.mode == DONE or (
            st.mode == NUM and st.aux in _N_TERMINAL and not st.stack
        )
    if kind == "arr":
        return False  # closes only via its ']' byte
    return False


def _frame_step(frame, b: int):
    """Byte into the top frame.  Returns a tuple of replacement frames
    (possibly with a pushed child), or None if the byte doesn't fit."""
    kind = frame[0]
    c = bytes([b])
    if kind == "lit":
        data, off = frame[1], frame[2]
        if off < len(data) and data[off] == b:
            return (("lit", data, off + 1),)
        return None
    if kind == "enum":
        choices, off = frame[1], frame[2]
        nxt = tuple(ch for ch in choices if len(ch) > off and ch[off] == b)
        if not nxt:
            return None
        return (("enum", nxt, off + 1),)
    if kind == "val":
        st, restrict = frame[1], frame[2]
        if st.mode == "value" and not st.stack:
            allowed = _RESTRICT_FIRST.get(restrict)
            if allowed is not None and b not in allowed:
                return None
        if restrict == "integer" and st.mode == NUM and b in _INT_FORBIDDEN:
            return None
        if c in b" \t\n\r" and st.mode != "str":
            # Canonical form: no insignificant whitespace in slots (string
            # CONTENTS may of course contain spaces).
            return None
        ns = step_byte(st, b)
        if ns is None:
            return None
        return (("val", ns, restrict),)
    if kind == "arr":
        _, item, mn, mx, count, phase = frame
        if phase == "open":
            if b != 0x5B:  # [
                return None
            if mn == 0:
                # Either close immediately or start the first element:
                # the ']' case is handled when it arrives (phase after
                # with count 0 allows ']').
                return (("arr", item, mn, mx, 0, "after_open"),)
            return (("arr", item, mn, mx, 0, "elems"), "PUSH")
        if phase == "after_open":
            if b == 0x5D:  # ] — empty array
                return "COMPLETE"
            if mx == 0:
                # maxItems 0: only [] conforms — reject starting an
                # element by construction instead of leaning on the
                # finish-time validate_instance re-check.
                return None
            # First element begins with this byte: push the item frame
            # and re-dispatch.
            return (("arr", item, mn, mx, 0, "elems"), "REPUSH", b)
        if phase == "after":
            if b == 0x2C:  # ,
                if mx != -1 and count >= mx:
                    return None
                return (("arr", item, mn, mx, count, "elems"), "PUSH")
            if b == 0x5D and count >= mn:  # ]
                return "COMPLETE"
            return None
        return None
    return None


def _exhausted(frame) -> bool:
    """Completable AND unable to consume any further byte — such frames
    pop eagerly so ``done`` reads true right after the final byte."""
    kind = frame[0]
    if kind == "lit":
        return frame[2] >= len(frame[1])
    if kind == "enum":
        return all(len(c) <= frame[2] for c in frame[1]) and _completable(
            frame
        )
    if kind == "val":
        # DONE consumes only whitespace, which slots reject.
        return frame[1].mode == DONE
    return False


def _normalize(stack: Tuple) -> Tuple:
    while stack and _exhausted(stack[-1]):
        stack = _pop(stack[:-1])
    return stack


def _machine_step(stack: Tuple, b: int) -> Optional[Tuple]:
    """One byte through the stack machine; None = invalid."""
    if not stack:
        return None  # script complete: nothing may follow
    top = stack[-1]
    result = _frame_step(top, b)
    if result == "COMPLETE":
        return _normalize(_pop(stack[:-1]))
    if result is not None:
        if len(result) >= 2 and result[1] == "PUSH":
            base = stack[:-1] + (result[0],)
            return _normalize(_enter(base + (_frame_of(result[0][1]),)))
        if len(result) >= 2 and result[1] == "REPUSH":
            base = stack[:-1] + (result[0],)
            entered = _enter(base + (_frame_of(result[0][1]),))
            return _machine_step(entered, result[2])
        return _normalize(stack[:-1] + result)
    # Top frame can't take the byte: if it is completable, pop and retry
    # (e.g. a number slot ends exactly when the next literal begins).
    if _completable(top):
        return _machine_step(_pop(stack[:-1]), b)
    return None


def _stack_closure_cost(stack: Tuple) -> int:
    total = 0
    for frame in stack:
        kind = frame[0]
        if kind == "lit":
            total += len(frame[1]) - frame[2]
        elif kind == "enum":
            matching = [len(c) - frame[2] for c in frame[1]
                        if len(c) >= frame[2]]
            total += min(matching) if matching else 0
        elif kind == "val":
            total += value_closure_cost(frame[1])
        elif kind == "seq":
            nodes, idx = frame[1], frame[2]
            # idx's child (if any) rides as its own frame above this one;
            # count only the elements AFTER it.
            total += sum(_node_min_len(n) for n in nodes[idx + 1:])
        elif kind == "arr":
            _, item, mn, mx, count, phase = frame
            if phase == "open":
                total += _node_min_len(("arr", item, mn, mx))
            else:
                remaining = max(mn - count, 0)
                # when an element is in flight (frames above), it is
                # counted by those frames; each remaining element costs
                # a ',' + its minimal bytes; plus the closing ']'.
                total += remaining * (1 + _node_min_len(item)) + 1
    return total


def _poppable_to_empty(stack: Tuple) -> bool:
    """Could the script complete HERE, with every in-flight frame at a
    valid end state?  Root-position scalars make this genuinely
    ambiguous (after "42" an integer may end or grow another digit), so
    completion is a CHOICE the engine expresses by picking EOS — see
    SchemaGuide.may_finish."""
    while stack:
        if not _completable(stack[-1]):
            return False
        stack = _pop(stack[:-1])
    return True


_COMPILE_CACHE: dict = {}


def compile_schema_cached(schema: dict):
    """compile_schema with a content-keyed cache: admission validates
    the schema and the per-sequence guides reuse the same node tree."""
    key = json.dumps(schema, sort_keys=True)
    node = _COMPILE_CACHE.get(key)
    if node is None:
        node = compile_schema(schema)
        if len(_COMPILE_CACHE) > 256:
            _COMPILE_CACHE.clear()
        _COMPILE_CACHE[key] = node
    return node


class SchemaGuide:
    """Duck-types :class:`engine.guided.JsonGuide` for the engine's
    host-side candidate-validation loop, but over a schema script."""

    def __init__(self, schema: dict):
        self.root = compile_schema_cached(schema)
        self.schema = schema
        self.stack: Tuple = _enter((_frame_of(("seq", (self.root,))),))
        self.closing = False

    @property
    def done(self) -> bool:
        return not self.stack

    def may_finish(self) -> bool:
        """True when EOS is a valid choice: every in-flight frame sits at
        a valid end state (root scalars: "42" may end OR grow; nested
        positions complete via their following structural byte instead)."""
        return _poppable_to_empty(self.stack)

    def finalize(self) -> None:
        """The engine chose EOS at a may_finish() point: collapse the
        remaining completable frames so ``done`` holds."""
        assert self.may_finish()
        self.stack = ()

    def closure_cost(self) -> int:
        return _stack_closure_cost(self.stack)

    def try_token(self, token_bytes: bytes):
        if not token_bytes:
            return None
        stack = self.stack
        for b in token_bytes:
            stack = _machine_step(stack, b)
            if stack is None:
                return None
        if self.closing and _stack_closure_cost(stack) >= self.closure_cost():
            return None
        return stack

    def accept(self, new_stack, token_bytes: bytes) -> None:
        self.stack = new_stack


# -- minimal instance validator (finish-time re-check + tests) -------------


def validate_instance(schema: dict, value) -> bool:
    """Does ``value`` conform?  Mirrors exactly the compile subset."""
    if "enum" in schema:
        return any(value == v for v in schema["enum"])
    stype = schema.get("type")
    if stype == "object" or (stype is None and "properties" in schema):
        if not isinstance(value, dict):
            return False
        props = schema.get("properties") or {}
        if set(value) != set(props):
            return False
        return all(validate_instance(sub, value[k])
                   for k, sub in props.items())
    if stype == "array":
        if not isinstance(value, list):
            return False
        mn = int(schema.get("minItems", 0))
        mx = int(schema.get("maxItems", -1))
        if len(value) < mn or (mx != -1 and len(value) > mx):
            return False
        items = schema.get("items", {})
        return all(validate_instance(items, v) for v in value)
    if stype == "string":
        return isinstance(value, str)
    if stype == "integer":
        return isinstance(value, int) and not isinstance(value, bool)
    if stype == "number":
        return isinstance(value, (int, float)) and not isinstance(value, bool)
    if stype == "boolean":
        return isinstance(value, bool)
    if stype == "null":
        return value is None
    return True  # free-form slot
