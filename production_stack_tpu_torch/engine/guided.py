"""Guided decoding: JSON-constrained generation (response_format).

The OpenAI ``response_format: {"type": "json_object"}`` contract — the
model's output must parse as a JSON object.  The reference stack proxies
whatever its engine supports; vLLM implements this with grammar FSMs
(outlines/xgrammar).  TPU twist: rather than shipping a [V]-wide allowed
mask to the device every step (a per-token host->HBM transfer that would
defeat fused decode), sampling for guided sequences moves host-side: the
logits row comes back once per token and candidates are validated in
probability order against a byte-level JSON pushdown automaton until one
fits.  Typically the first candidate is already valid, so the common cost
is one FSM simulation per token.

The automaton accepts exactly the JSON value grammar (RFC 8259: objects,
arrays, strings with escapes incl. \\uXXXX, numbers, true/false/null,
insignificant whitespace), tracks nesting with an explicit stack, and for
``json_object`` requires the top-level value to be an object.  When the
value completes, only whitespace may follow and EOS becomes the forced
choice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

WS = b" \t\n\r"
DIGITS = b"0123456789"
HEX = b"0123456789abcdefABCDEF"

# Scalar modes (the stack holds container contexts).
V_START = "value"  # expecting a value
STR = "str"  # inside a string
STR_ESC = "esc"  # after backslash
STR_U = "u"  # inside \uXXXX (state carries remaining hex count)
NUM = "num"  # inside a number (sub-state tracks part)
LIT = "lit"  # inside true/false/null (state carries remainder)
AFTER = "after"  # a value just closed: , } ] or end
OBJ_KEY = "okey"  # expecting a key string (or })
OBJ_COLON = "colon"  # expecting :
DONE = "done"  # top-level value complete: whitespace only

_LITERALS = (b"true", b"false", b"null")

# Number sub-states: what the next byte may be.
N_SIGN = "sign"  # after leading '-'
N_INT = "int"  # in integer part
N_Z = "zero"  # leading zero consumed (no more int digits)
N_DOT = "dot"  # after '.' (need digit)
N_FRAC = "frac"  # in fraction digits
N_E = "e"  # after e/E (need sign or digit)
N_ESIGN = "esign"  # after exponent sign (need digit)
N_EXP = "exp"  # in exponent digits

# A number is "complete" (may be followed by , } ] ws) in these sub-states.
_N_TERMINAL = {N_INT, N_Z, N_FRAC, N_EXP}


@dataclasses.dataclass(frozen=True)
class FSMState:
    mode: str = V_START
    stack: Tuple[str, ...] = ()  # "{" and "[" container contexts
    aux: str = ""  # literal remainder / number sub-state / hex count


def initial_state(require_object: bool = True) -> FSMState:
    # require_object: json_object mode — the first non-ws byte must be '{'.
    return FSMState(mode=V_START, stack=(), aux="{" if require_object else "")


def _close_value(state: FSMState) -> FSMState:
    """A value finished: what comes next depends on the container."""
    if not state.stack:
        return FSMState(mode=DONE, stack=(), aux="")
    return FSMState(mode=AFTER, stack=state.stack, aux="")


def step_byte(state: FSMState, b: int) -> Optional[FSMState]:
    """One byte through the automaton; None = invalid."""
    c = bytes([b])
    mode = state.mode

    if mode == DONE:
        return state if c in WS else None

    if mode == STR:
        if b == 0x22:  # closing quote
            # A key string closes into the colon state; a value string
            # closes the value.
            if state.aux == "key":
                return FSMState(OBJ_COLON, state.stack, "")
            return _close_value(state)
        if b == 0x5C:  # backslash
            return FSMState(STR_ESC, state.stack, state.aux)
        if b < 0x20:  # control chars must be escaped
            return None
        return state

    if mode == STR_ESC:
        if c in b'"\\/bfnrt':
            return FSMState(STR, state.stack, state.aux)
        if b == 0x75:  # u
            return FSMState(STR_U, state.stack, state.aux + "|4")
        return None

    if mode == STR_U:
        if c not in HEX:
            return None
        aux, n = state.aux.rsplit("|", 1)
        n = int(n) - 1
        if n == 0:
            return FSMState(STR, state.stack, aux)
        return FSMState(STR_U, state.stack, f"{aux}|{n}")

    if mode == LIT:
        if state.aux and b == state.aux.encode()[0]:
            rest = state.aux[1:]
            if rest:
                return FSMState(LIT, state.stack, rest)
            return _close_value(state)
        return None

    if mode == NUM:
        sub = state.aux
        if c in DIGITS:
            if sub in (N_SIGN, N_INT):
                # "0" may not be followed by more int digits.
                if sub == N_SIGN and b == 0x30:
                    return FSMState(NUM, state.stack, N_Z)
                return FSMState(NUM, state.stack, N_INT)
            if sub == N_Z:
                return None
            if sub in (N_DOT, N_FRAC):
                return FSMState(NUM, state.stack, N_FRAC)
            if sub in (N_E, N_ESIGN, N_EXP):
                return FSMState(NUM, state.stack, N_EXP)
        if b == 0x2E and sub in (N_INT, N_Z):  # .
            return FSMState(NUM, state.stack, N_DOT)
        if c in b"eE" and sub in _N_TERMINAL - {N_EXP}:
            return FSMState(NUM, state.stack, N_E)
        if c in b"+-" and sub == N_E:
            return FSMState(NUM, state.stack, N_ESIGN)
        if sub in _N_TERMINAL:
            # The number ends; re-dispatch this byte in the closed state.
            return step_byte(_close_value(state), b)
        return None

    if mode == OBJ_KEY:
        if c in WS:
            return state
        if b == 0x22:
            return FSMState(STR, state.stack, "key")
        if b == 0x7D:
            if state.aux == "first":
                return None  # {..., } — trailing comma
            return step_close_container(state, "}")
        return None

    if mode == OBJ_COLON:
        if c in WS:
            return state
        if b == 0x3A:  # :
            return FSMState(V_START, state.stack, "")
        return None

    if mode == AFTER:
        if c in WS:
            return state
        top = state.stack[-1]
        if b == 0x2C:  # ,
            if top == "{":
                return FSMState(OBJ_KEY, state.stack, "first")
            return FSMState(V_START, state.stack, "")
        if b == 0x7D and top == "{":
            return step_close_container(state, "}")
        if b == 0x5D and top == "[":
            return step_close_container(state, "]")
        return None

    if mode == V_START:
        if c in WS:
            return state
        if state.aux == "{" and b != 0x7B:
            return None  # json_object: top level must be an object
        if b == 0x7B:  # {
            return FSMState(OBJ_KEY, state.stack + ("{",), "")
        if b == 0x5B:  # [
            # An array may immediately close.
            return FSMState(V_START, state.stack + ("[",), "maybe_empty")
        if b == 0x5D and state.stack and state.stack[-1] == "[" \
                and state.aux == "maybe_empty":
            return step_close_container(state, "]")
        if b == 0x22:
            return FSMState(STR, state.stack, "")
        if b == 0x2D:  # -
            return FSMState(NUM, state.stack, N_SIGN)
        if b == 0x30:
            return FSMState(NUM, state.stack, N_Z)
        if c in DIGITS:
            return FSMState(NUM, state.stack, N_INT)
        for lit in _LITERALS:
            if b == lit[0]:
                rest = lit[1:].decode()
                if rest:
                    return FSMState(LIT, state.stack, rest)
                return _close_value(state)
        return None

    return None


def step_close_container(state: FSMState, _which: str) -> FSMState:
    popped = FSMState(state.mode, state.stack[:-1], "")
    return _close_value(popped)


def advance_bytes(state: FSMState, data: bytes) -> Optional[FSMState]:
    for b in data:
        state = step_byte(state, b)
        if state is None:
            return None
    return state


def closure_cost(state: FSMState) -> int:
    """Lower bound on the bytes needed to complete the JSON value from
    ``state`` (each open container costs its closer; a string its quote;
    an object key its quote+colon+minimal value; ...).  Drives the
    budget-aware closing mode."""
    depth = len(state.stack)
    mode = state.mode
    if mode == DONE:
        return 0
    if mode == AFTER:
        return depth
    if mode == STR:
        # The leading 1 is the closing quote; a key then needs ':' plus a
        # minimal value (2 more).
        extra = 2 if state.aux == "key" else 0
        return 1 + extra + depth
    if mode == STR_ESC:
        return 2 + depth + (2 if state.aux == "key" else 0)
    if mode == STR_U:
        n = int(state.aux.rsplit("|", 1)[1])
        return 1 + n + depth + (2 if "key" in state.aux else 0)
    if mode == NUM:
        return depth if state.aux in _N_TERMINAL else 1 + depth
    if mode == LIT:
        return len(state.aux) + depth
    if mode == OBJ_KEY:
        if state.aux == "first":  # after comma: a key is mandatory
            return 4 + depth  # "" : v  then closers
        return depth  # '}' closes directly
    if mode == OBJ_COLON:
        return 2 + depth  # ':' + minimal value
    if mode == V_START:
        if state.aux == "{":
            return 2  # {}
        return 1 + depth  # minimal value then closers
    return depth


class JsonGuide:
    """Per-sequence guided-decoding state + token validation.

    Two anti-stall measures for models that wander inside the (infinite)
    JSON language: consecutive whitespace-only tokens are capped, and
    when the engine reports the remaining token budget is close to the
    closure cost, ``closing`` mode admits only tokens that strictly
    reduce it — the value completes instead of truncating mid-string."""

    MAX_WS_RUN = 2

    def __init__(self, require_object: bool = True):
        self.state = initial_state(require_object)
        self.ws_run = 0
        self.closing = False

    @property
    def done(self) -> bool:
        return self.state.mode == DONE

    def may_finish(self) -> bool:
        # A closed top-level JSON value is unambiguous: done == may end.
        return self.done

    def finalize(self) -> None:
        pass  # done already holds when may_finish() does

    def closure_cost(self) -> int:
        return closure_cost(self.state)

    @staticmethod
    def _is_ws(token_bytes: bytes) -> bool:
        return all(bytes([b]) in WS for b in token_bytes)

    def try_token(self, token_bytes: bytes) -> Optional[FSMState]:
        """State after consuming token_bytes, or None if any byte is
        invalid.  Empty-text tokens are invalid (no progress).  Pure:
        several candidates may be tried before one is accept()ed."""
        if not token_bytes:
            return None
        if self._is_ws(token_bytes) and self.ws_run >= self.MAX_WS_RUN:
            return None
        state = advance_bytes(self.state, token_bytes)
        if state is None:
            return None
        if self.closing and closure_cost(state) >= closure_cost(self.state):
            return None
        return state

    def accept(self, new_state: FSMState, token_bytes: bytes) -> None:
        self.state = new_state
        self.ws_run = self.ws_run + 1 if self._is_ws(token_bytes) else 0


class TokenTextCache:
    """token id -> decoded text, computed once per tokenizer (the guided
    sampler validates candidates in probability order)."""

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer
        self._cache: dict = {}

    def text(self, token_id: int) -> str:
        got = self._cache.get(token_id)
        if got is None:
            got = self.tokenizer.decode([token_id])
            self._cache[token_id] = got
        return got
