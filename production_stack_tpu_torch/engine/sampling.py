"""Token sampling: greedy / temperature / top-k / top-p / min-p, penalties
and logprobs (PyTorch).

Counterpart of ``production_stack_tpu/engine/sampling.py``.  The filters
and penalties follow the same math, so on the same fp32 logits they mask
and shift the same entries; greedy is the same argmax (first index on
ties).

Random draws cannot match the JAX package's (threefry keys).  The port's
own schedule: each sampled row draws its Gumbel noise from a
``torch.Generator`` seeded by mixing the step seed (engine seed + step
counter) with the row's sequence seed, so the same seed gives the same
stream on any engine instance.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30
_MASK64 = (1 << 64) - 1


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


def row_seed(step_seed: int, seq_seed: int) -> int:
    """The seed of one row's generator: splitmix64 over (step, sequence)."""
    x = (step_seed * 0x9E3779B97F4A7C15 + seq_seed) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) & ((1 << 63) - 1)


def sample_tokens(
    logits: torch.Tensor,  # [S, V] fp32
    temperature: torch.Tensor,  # [S]
    top_p: torch.Tensor,  # [S]
    top_k: torch.Tensor,  # [S] int
    step_seed: int,  # engine seed + step counter
    seq_seeds: list,  # [S] per-sequence seeds (host ints)
    min_p: Optional[torch.Tensor] = None,  # [S]; None -> disabled
) -> torch.Tensor:
    """Sampled token ids [S] (int64, on the logits' device): argmax for
    rows with temperature <= 0, a Gumbel-max draw from the filtered
    distribution otherwise."""
    out = torch.argmax(logits, dim=-1)
    rows = [i for i, t in enumerate(temperature.tolist()) if t > 0]
    if not rows:
        return out
    scaled = filter_logits(logits, temperature, top_p, top_k, min_p)
    for i in rows:
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(row_seed(step_seed, int(seq_seeds[i])))
        u = torch.rand(logits.shape[-1], generator=gen, device=logits.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
        out[i] = torch.argmax(scaled[i] + gumbel)
    return out


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
