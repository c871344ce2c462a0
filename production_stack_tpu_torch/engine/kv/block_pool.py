"""KV block pool with hash-chain prefix caching.

vLLM-style paged KV management rebuilt for the TPU engine: fixed-size token
blocks, ref-counted sharing of cached prefixes, and LRU eviction of
freed-but-cached blocks.  The prefix-cache hit rate measured here feeds the
``tpu:prefix_cache_hit_rate`` gauge the router's KV-aware routing and the
Grafana dashboard key off (reference scrapes the same concept from vLLM as
``vllm:gpu_prefix_cache_hit_rate``, stats/engine_stats.py:52-53).

Block 0 is the reserved *null block*: padding scatter targets land there and
it is never read or allocated.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple


def _chain_hash(prev: Optional[bytes], tokens: Sequence[int]) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    h.update(prev or b"\x00" * 16)
    h.update(b",".join(str(t).encode() for t in tokens))
    return h.digest()


def prefix_block_hashes(
    token_ids: Sequence[int], block_size: int, namespace: int = 0
) -> List[bytes]:
    """Chain hash of every full block of ``token_ids`` (leaving >= 1 token
    uncached, mirroring match_prefix).  These digests are the content keys
    for cross-engine prefix sharing through the remote KV store — two
    engines hashing the same tokens under the same namespace produce the
    same keys."""
    usable = len(token_ids) - 1
    prev: Optional[bytes] = (
        _chain_hash(None, [namespace]) if namespace else None
    )
    out: List[bytes] = []
    for start in range(0, usable - usable % block_size, block_size):
        prev = _chain_hash(prev, token_ids[start : start + block_size])
        out.append(prev)
    return out


class BlockPool:
    def __init__(self, num_blocks: int, block_size: int, enable_prefix_caching: bool = True):
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (block 0 is the null block)")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.enable_prefix_caching = enable_prefix_caching
        self._free: List[int] = list(range(1, num_blocks))  # 0 = null block
        self._ref_counts: Dict[int, int] = {}
        # Prefix cache: chain hash -> block id; and reverse map.
        self._hash_to_block: Dict[bytes, int] = {}
        self._block_to_hash: Dict[int, bytes] = {}
        # Freed blocks whose content is still valid, LRU-ordered.
        self._cached_free: "OrderedDict[int, None]" = OrderedDict()
        # Metrics (token-granularity, like vLLM's hit-rate gauge).
        self.query_tokens = 0
        self.hit_tokens = 0

    # -- capacity ----------------------------------------------------------

    @property
    def num_free_blocks(self) -> int:
        return len(self._free) + len(self._cached_free)

    @property
    def usage(self) -> float:
        """Fraction of non-null blocks currently referenced by sequences."""
        total = self.num_blocks - 1
        return (total - self.num_free_blocks) / total if total else 0.0

    @property
    def prefix_hit_rate(self) -> float:
        if not self.query_tokens:
            return 0.0
        return self.hit_tokens / self.query_tokens

    @property
    def num_cached_blocks(self) -> int:
        """Blocks whose content is reusable through the prefix cache
        (referenced or cached-free).  Exported as the
        ``tpu:prefix_cache_blocks`` gauge — the router's popularity view
        reconciles its owner map against this truth: a collapse to ~0
        means the engine restarted (or flushed) and every prefix the
        router believes resident there is gone."""
        return len(self._block_to_hash)

    # -- allocation --------------------------------------------------------

    def can_allocate(self, n: int) -> bool:
        return self.num_free_blocks >= n

    def allocate(self, n: int) -> List[int]:
        """Allocate n blocks, evicting LRU cached-free blocks as needed."""
        if not self.can_allocate(n):
            raise RuntimeError(
                f"KV pool exhausted: need {n} blocks, have {self.num_free_blocks}"
            )
        out: List[int] = []
        for _ in range(n):
            if self._free:
                block = self._free.pop()
            else:
                block, _ = self._cached_free.popitem(last=False)  # LRU evict
                self._evict_hash(block)
            self._ref_counts[block] = 1
            out.append(block)
        return out

    def free(self, blocks: Sequence[int]) -> None:
        for block in blocks:
            if block == 0:
                continue
            refs = self._ref_counts.get(block, 0) - 1
            if refs > 0:
                self._ref_counts[block] = refs
                continue
            self._ref_counts.pop(block, None)
            if block in self._block_to_hash:
                # Content still valid: keep it reclaimable via the prefix
                # cache until LRU eviction.
                self._cached_free[block] = None
                self._cached_free.move_to_end(block)
            else:
                self._free.append(block)

    def _evict_hash(self, block: int) -> None:
        digest = self._block_to_hash.pop(block, None)
        if digest is not None and self._hash_to_block.get(digest) == block:
            del self._hash_to_block[digest]

    # -- prefix caching ----------------------------------------------------

    @staticmethod
    def _namespace_seed(namespace: int) -> Optional[bytes]:
        """Seed the hash chain per namespace (e.g. LoRA adapter slot): KV
        computed under one adapter must never be served to another.
        Namespace 0 keeps the legacy unseeded chain."""
        return _chain_hash(None, [namespace]) if namespace else None

    def match_prefix(
        self, token_ids: Sequence[int], namespace: int = 0
    ) -> Tuple[List[int], int]:
        """Longest cached full-block prefix of token_ids.

        Returns (block_ids, num_cached_tokens); increments the matched
        blocks' refcounts (caller owns them until free()).  At least one
        token is always left uncached so prefill has work to do.
        """
        self.query_tokens += len(token_ids)
        if not self.enable_prefix_caching:
            return [], 0
        bs = self.block_size
        usable = len(token_ids) - 1  # leave >=1 token for prefill
        blocks: List[int] = []
        prev: Optional[bytes] = self._namespace_seed(namespace)
        for start in range(0, usable - usable % bs, bs):
            digest = _chain_hash(prev, token_ids[start : start + bs])
            block = self._hash_to_block.get(digest)
            if block is None:
                break
            blocks.append(block)
            prev = digest
        for block in blocks:
            if block in self._cached_free:
                del self._cached_free[block]
                self._ref_counts[block] = 1
            else:
                self._ref_counts[block] = self._ref_counts.get(block, 0) + 1
        cached = len(blocks) * bs
        self.hit_tokens += cached
        return blocks, cached

    def count_cached_prefix(self, digests: Sequence[bytes]) -> int:
        """How many LEADING chain digests the cache currently holds,
        WITHOUT claiming them (no refcount change) — the admission-time
        prefetch planner uses this to size the remote miss tail."""
        if not self.enable_prefix_caching:
            return 0
        n = 0
        for digest in digests:
            if digest not in self._hash_to_block:
                break
            n += 1
        return n

    def has_digest(self, digest: bytes) -> bool:
        return digest in self._hash_to_block

    def adopt_prefix_block(self, digest: bytes, block: int) -> bool:
        """Bind an imported (remote-prefetched) block's content to its
        chain digest so match_prefix can serve it.  The caller owns the
        block (allocated, refcount 1) and frees it right after adoption,
        parking it in the reclaimable cached-free tier.  False when the
        digest is already mapped (a concurrent local prefill won the
        race): the caller's block frees as plain storage."""
        if not self.enable_prefix_caching or digest in self._hash_to_block:
            return False
        self._evict_hash(block)  # block may have held older content
        self._hash_to_block[digest] = block
        self._block_to_hash[block] = digest
        return True

    def register_prefix(
        self,
        token_ids: Sequence[int],
        block_table: Sequence[int],
        namespace: int = 0,
    ) -> None:
        """Record hash chain for every *full* block of this sequence so later
        requests with the same prefix hit the cache."""
        if not self.enable_prefix_caching:
            return
        bs = self.block_size
        prev: Optional[bytes] = self._namespace_seed(namespace)
        for i in range(len(token_ids) // bs):
            digest = _chain_hash(prev, token_ids[i * bs : (i + 1) * bs])
            block = block_table[i]
            existing = self._hash_to_block.get(digest)
            if existing is None:
                self._evict_hash(block)  # block may have held older content
                self._hash_to_block[digest] = block
                self._block_to_hash[block] = digest
            prev = digest
