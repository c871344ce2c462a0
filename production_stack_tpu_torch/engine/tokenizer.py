"""Tokenizer abstraction: HF tokenizer when available, byte-level fallback.

The byte fallback keeps the engine fully functional in zero-egress
environments (CI, clusterless smoke tests): deterministic, reversible,
vocab of 256 bytes + 4 specials.
"""

from __future__ import annotations

import logging
from functools import lru_cache
from typing import List, Optional

logger = logging.getLogger(__name__)


class ByteTokenizer:
    """Reversible byte-level tokenizer: token = byte value + 4 specials."""

    PAD, BOS, EOS, UNK = 0, 1, 2, 3
    OFFSET = 4

    def __init__(self):
        self.vocab_size = 256 + self.OFFSET
        self.bos_token_id = self.BOS
        self.eos_token_id = self.EOS
        self.pad_token_id = self.PAD
        self.chat_template: Optional[str] = None  # Jinja override

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = [b + self.OFFSET for b in text.encode("utf-8")]
        return ([self.BOS] if add_bos else []) + ids

    def decode(self, ids: List[int]) -> str:
        # Ids beyond the byte range can appear when the model's vocab is
        # padded larger than the tokenizer's (random-init smoke models).
        data = bytes(
            i - self.OFFSET for i in ids if self.OFFSET <= i < self.OFFSET + 256
        )
        return data.decode("utf-8", errors="replace")

    def apply_chat_template(self, messages, tools=None) -> str:
        if self.chat_template is not None:
            return _render_jinja(
                self.chat_template, messages, bos="", eos="", tools=tools
            )
        parts = [f"<|{m.get('role', 'user')}|>{m.get('content', '')}" for m in messages]
        if tools:
            import json as _json

            parts.insert(0, "<|tools|>" + _json.dumps(tools))
        return "\n".join(parts) + "\n<|assistant|>"


class HFTokenizer:
    """Thin wrapper over transformers.AutoTokenizer (local files only)."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.vocab_size = len(self._tok)
        self.bos_token_id = self._tok.bos_token_id
        self.eos_token_id = self._tok.eos_token_id
        self.pad_token_id = self._tok.pad_token_id or 0
        self.chat_template: Optional[str] = None  # Jinja override

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        return self._tok.encode(text, add_special_tokens=add_bos)

    def decode(self, ids: List[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)

    def apply_chat_template(self, messages, tools=None) -> str:
        tool_kwargs = {"tools": tools} if tools else {}
        if self.chat_template is not None:
            # An explicitly configured template must never be silently
            # replaced by the degenerate fallback: the server validates it
            # at startup, and any later failure should surface loudly.
            return self._tok.apply_chat_template(
                messages,
                tokenize=False,
                add_generation_prompt=True,
                chat_template=self.chat_template,
                **tool_kwargs,
            )
        try:
            return self._tok.apply_chat_template(
                messages, tokenize=False, add_generation_prompt=True,
                **tool_kwargs,
            )
        except Exception:
            parts = [f"{m.get('role')}: {m.get('content', '')}" for m in messages]
            return "\n".join(parts) + "\nassistant:"


@lru_cache(maxsize=8)
def _compile_jinja(template: str):
    """Compile once per template string: rendering sits on the request hot
    path.  StrictUndefined so typos fail the startup validation render
    instead of silently emitting empty strings."""
    import jinja2

    env = jinja2.Environment(undefined=jinja2.StrictUndefined, autoescape=False)
    return env.from_string(template)


def _render_jinja(template: str, messages, bos: str, eos: str, tools=None) -> str:
    """Render a custom chat template (the reference chart's chatTemplate
    ConfigMap, deployment-vllm-multi.yaml:260-270, passed to vllm serve as
    --chat-template).  jinja2 ships with transformers in this image.
    ``bos_token``/``eos_token`` are provided because standard HF templates
    reference them."""
    return _compile_jinja(template).render(
        messages=messages,
        add_generation_prompt=True,
        bos_token=bos,
        eos_token=eos,
        tools=tools,
    )


def get_tokenizer(path: Optional[str]):
    if path:
        try:
            return HFTokenizer(path)
        except Exception:
            logger.exception(
                "Could not load HF tokenizer from %s; using byte fallback", path
            )
    return ByteTokenizer()
