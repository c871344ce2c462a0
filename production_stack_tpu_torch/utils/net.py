"""Request-parsing helpers.

A copy of ``parse_deadline`` from ``production_stack_tpu/utils/net.py``: the
port imports nothing of the JAX package, and the router parses the same
contract with the original.
"""

from __future__ import annotations

from typing import Optional


def parse_deadline(headers, body, now: float) -> Optional[float]:
    """Per-request deadline contract, shared by the router and the engine
    server (docs/robustness.md): an ``X-Request-Deadline`` header carries
    absolute epoch seconds (what the router propagates) and wins over an
    OpenAI ``timeout``-style body field (seconds from now).  Returns an
    absolute epoch float or None; raises ValueError on malformed input.
    The router parses with the original; tests hold this copy to the same
    answers, so the two cannot drift apart on the client-facing contract."""
    hdr = headers.get("x-request-deadline") if headers is not None else None
    if hdr is not None:
        try:
            return float(hdr)
        except (TypeError, ValueError):
            raise ValueError(
                f"X-Request-Deadline must be epoch seconds, got {hdr!r}"
            ) from None
    timeout = (body or {}).get("timeout")
    if timeout is None:
        return None
    if isinstance(timeout, bool) or not isinstance(timeout, (int, float)):
        raise ValueError(
            f"'timeout' must be a number of seconds, got {timeout!r}"
        )
    if timeout <= 0:
        raise ValueError(f"'timeout' must be > 0 seconds, got {timeout}")
    return now + float(timeout)
