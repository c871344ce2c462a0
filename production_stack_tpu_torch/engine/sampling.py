"""Token sampling: greedy / temperature / top-k / top-p / min-p, penalties
and logprobs (PyTorch).

Counterpart of ``production_stack_tpu/engine/sampling.py``.  The filters
and penalties follow the same math, so on the same fp32 logits they mask
and shift the same entries; greedy is the same argmax (first index on
ties).

Random draws cannot match the JAX package's (threefry keys).  The port's
own schedule: each sampled row's Gumbel noise comes from a counter-based
hash (splitmix64) of the step seed (engine seed + step counter), the row's
sequence seed and the vocab index, computed in int64 tensor ops on the
logits' device.  Nothing is read back to the host, so a draw runs inside a
K-step window and a CUDA graph, and the CPU and the card give the same
bits; the same seeds give the same stream on any engine instance.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _signed64(c: int) -> int:
    """A 64-bit constant as the int64 value with the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


_GOLDEN = _signed64(0x9E3779B97F4A7C15)
_MIX1 = _signed64(0xBF58476D1CE4E5B9)
_MIX2 = _signed64(0x94D049BB133111EB)


def _apply_top_k(logits: torch.Tensor, top_k: torch.Tensor) -> torch.Tensor:
    """Mask logits below the k-th largest.  top_k <= 0 disables."""
    V = logits.shape[-1]
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    k = top_k.long().clamp(1, V)
    kth = torch.gather(sorted_desc, 1, (k - 1)[:, None])  # [S, 1]
    masked = logits.masked_fill(logits < kth, NEG_INF)
    return torch.where((top_k > 0)[:, None], masked, logits)


def _apply_top_p(logits: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Nucleus filtering.  top_p >= 1 disables."""
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_desc, dim=-1)
    cumulative = torch.cumsum(probs, dim=-1)
    # Keep tokens whose exclusive cumulative mass is below top_p; the
    # first token is always kept.  The smallest kept logit is the cut.
    keep = (cumulative - probs) < top_p[:, None]
    threshold = torch.where(keep, sorted_desc, torch.inf).min(dim=-1, keepdim=True).values
    masked = logits.masked_fill(logits < threshold, NEG_INF)
    return torch.where((top_p < 1.0)[:, None], masked, logits)


def _apply_min_p(logits: torch.Tensor, min_p: torch.Tensor) -> torch.Tensor:
    """vLLM min_p: drop tokens whose probability is below
    ``min_p * max_prob``.  min_p <= 0 disables."""
    probs = torch.softmax(logits, dim=-1)
    cut = probs.max(dim=-1, keepdim=True).values * min_p[:, None]
    masked = logits.masked_fill(probs < cut, NEG_INF)
    return torch.where((min_p > 0)[:, None], masked, logits)


def filter_logits(
    logits: torch.Tensor,  # [S, V] fp32
    temperature: torch.Tensor,  # [S]
    top_p: torch.Tensor,  # [S]
    top_k: torch.Tensor,  # [S] int
    min_p: Optional[torch.Tensor] = None,  # [S]; None -> disabled
) -> torch.Tensor:
    """Temperature-scaled logits with the top-k, top-p and min-p masks
    applied (masked entries at NEG_INF) — what the sampled rows draw from."""
    safe_temp = torch.where(temperature > 0, temperature, torch.ones_like(temperature))
    scaled = logits / safe_temp[:, None]
    scaled = _apply_top_k(scaled, top_k)
    scaled = _apply_top_p(scaled, top_p)
    if min_p is not None:
        scaled = _apply_min_p(scaled, min_p)
    return scaled


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits (torch's ``>>`` is arithmetic)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer on int64 tensors: the multiplies wrap mod
    2**64 as the unsigned ones do, and the shifts are logical."""
    x = (x ^ _shr(x, 30)) * _MIX1
    x = (x ^ _shr(x, 27)) * _MIX2
    return x ^ _shr(x, 31)


def draw_uniform(
    step_seed: torch.Tensor,  # [] or [1] int: engine seed + step counter
    seq_seeds: torch.Tensor,  # [S] int per-sequence seeds
    vocab_size: int,
) -> torch.Tensor:
    """Uniform draws in (0, 1), [S, V] fp32 on ``seq_seeds``' device:
    ``(x + 0.5) / 2**23`` for x the top 23 bits of splitmix64 over row key
    ``mix(step * golden + seed)`` plus ``(v + 1) * golden`` (splitmix64's
    stream at counter v), exact in fp32.  Each value depends only on
    (step, row seed, v), whatever the batch or the device."""
    seeds = seq_seeds.long()
    row = _mix64(step_seed.long().reshape(-1)[:1] * _GOLDEN + seeds)  # [S]
    idx = torch.arange(1, vocab_size + 1, dtype=torch.int64, device=seeds.device)
    bits = _mix64(row[:, None] + idx[None, :] * _GOLDEN)
    return (_shr(bits, 41).float() + 0.5) * (1.0 / (1 << 23))


def sample_tokens(
    logits: torch.Tensor,  # [S, V] fp32
    temperature: torch.Tensor,  # [S]
    top_p: torch.Tensor,  # [S]
    top_k: torch.Tensor,  # [S] int
    step_seed: torch.Tensor,  # [] int: engine seed + step counter
    seq_seeds: torch.Tensor,  # [S] int per-sequence seeds
    min_p: Optional[torch.Tensor] = None,  # [S]; None -> disabled
    all_greedy: bool = False,
) -> torch.Tensor:
    """Sampled token ids [S] (int64, on the logits' device): argmax (first
    index on ties) for rows with temperature <= 0, a Gumbel-max draw from
    the filtered distribution (:func:`draw_uniform`) otherwise, chosen per
    row by ``torch.where`` — no value is read back to the host.
    ``all_greedy`` (a static fact of the batch, known on the host) skips
    the filters and the draw, as the JAX package's static arguments do."""
    greedy = torch.argmax(logits, dim=-1)
    if all_greedy:
        return greedy
    scaled = filter_logits(logits, temperature, top_p, top_k, min_p)
    u = draw_uniform(step_seed, seq_seeds, logits.shape[-1])
    sampled = torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)
    return torch.where(temperature > 0, sampled, greedy)


def compute_logprobs(logits: torch.Tensor, token_ids: torch.Tensor) -> torch.Tensor:
    """Log-prob of the chosen tokens: [S, V], [S] -> [S]."""
    logp = torch.log_softmax(logits, dim=-1)
    return torch.gather(logp, 1, token_ids.long()[:, None])[:, 0]


def occurrence_state(
    out_tokens: torch.Tensor,  # [S, L] int generated-so-far, -1 padded
    ctx_tokens: torch.Tensor,  # [S, Lc] int prompt+generated, -1 padded
    vocab_size: int,
):
    """(counts [S, V] of generated tokens, seen [S, V] bool over prompt and
    generated tokens), built by scatter from the id arrays."""
    S = out_tokens.shape[0]
    valid = out_tokens >= 0
    ids = torch.where(valid, out_tokens, 0).long()
    counts = torch.zeros((S, vocab_size), dtype=torch.float32, device=out_tokens.device)
    counts.scatter_add_(1, ids, valid.float())
    cvalid = ctx_tokens >= 0
    cids = torch.where(cvalid, ctx_tokens, 0).long()
    seen = torch.zeros((S, vocab_size), dtype=torch.float32, device=ctx_tokens.device)
    seen.scatter_add_(1, cids, cvalid.float())
    return counts, seen > 0


def apply_penalties_state(
    logits: torch.Tensor,  # [S, V] fp32
    counts: torch.Tensor,  # [S, V] generated-token occurrence counts
    seen: torch.Tensor,  # [S, V] bool prompt+generated occurrence bitmap
    presence: torch.Tensor,  # [S]
    frequency: torch.Tensor,  # [S]
    repetition: torch.Tensor,  # [S]; 1.0 = off
) -> torch.Tensor:
    """HF/vLLM ``repetition_penalty`` over prompt AND generated tokens on
    the raw logits first (positive logits divide, negative multiply), then
    the OpenAI presence/frequency penalties over the generated tokens:
    ``logit[t] -= presence*[count(t)>0] + frequency*count(t)``."""
    rep = repetition[:, None]
    scaled = torch.where(logits > 0, logits / rep, logits * rep)
    logits = torch.where(seen, scaled, logits)
    countsf = counts.float()
    penalty = presence[:, None] * (countsf > 0) + frequency[:, None] * countsf
    return logits - penalty


def apply_penalties(
    logits: torch.Tensor,  # [S, V] fp32
    out_tokens: torch.Tensor,  # [S, L] int generated-so-far, -1 padded
    presence: torch.Tensor,  # [S]
    frequency: torch.Tensor,  # [S]
    repetition: Optional[torch.Tensor] = None,  # [S]; 1.0 = off
    ctx_tokens: Optional[torch.Tensor] = None,  # [S, Lc] prompt+generated
) -> torch.Tensor:
    """Build the occurrence state from per-step id arrays and apply the
    penalties.  ``repetition=None`` skips the seen bitmap (presence and
    frequency only)."""
    V = logits.shape[-1]
    counts, seen = occurrence_state(
        out_tokens,
        ctx_tokens if ctx_tokens is not None else out_tokens,
        V,
    )
    if repetition is None:
        penalty = presence[:, None] * (counts > 0) + frequency[:, None] * counts
        return logits - penalty
    return apply_penalties_state(
        logits, counts, seen, presence, frequency, repetition
    )


def top_logprobs_of(
    logits: torch.Tensor,  # [S, V] fp32
    token_ids: torch.Tensor,  # [S] chosen tokens
    k: int,
):
    """Chosen-token logprob + top-k alternatives (OpenAI ``logprobs``).
    Returns (chosen [S], top_ids [S, k], top_logps [S, k])."""
    logp = torch.log_softmax(logits, dim=-1)
    chosen = torch.gather(logp, 1, token_ids.long()[:, None])[:, 0]
    top_logps, top_ids = torch.topk(logp, k, dim=-1)
    return chosen, top_ids, top_logps
