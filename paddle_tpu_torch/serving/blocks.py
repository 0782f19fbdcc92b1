"""Paged-KV block accounting: the host half of PagedAttention-style
decode (vLLM; Kwon et al. 2023).

A copy of ``paddle_tpu/serving/blocks.py`` (stdlib only): the port imports
nothing of the JAX package.

The decoder's K/V live in ONE preallocated pool of fixed-size blocks
(``[num_blocks, block_size, heads, dh]`` per layer, device-side); this
module owns everything about those blocks that is pure host
bookkeeping:

  * a lowest-index-first free list (``alloc``/``release``) with
    per-block REFCOUNTS, so a prompt-prefix block can back many
    resident sequences at once;
  * a content-hash prefix cache: every FULL prompt block registers
    under a chained hash (``h_i = sha1(h_{i-1} || tokens_i)`` — the
    chain makes a block's identity its whole prefix, not just its own
    tokens, so two prompts sharing block 3 necessarily share blocks
    0-2);
  * LRU retention: a registered block whose refcount drops to zero is
    NOT returned to the plain free list — it parks in an LRU side pool,
    still answering ``lookup`` hits (a popular system prompt stays warm
    between requests) but evictable the moment ``alloc`` finds the
    free list empty.

Block 0 is RESERVED as the scratch sink: hole rows in a padded decode
step and pad rows of a prefill chunk scatter their garbage K/V into
``pool[0]`` (never gathered by a live sequence — per-slot position
masks see to it), so the executables stay branch-free.  The allocator
never hands out block 0.

Pool exhaustion raises the typed ``KVPoolExhausted``; the serving
engine converts it to ``Overloaded(reason="kv_blocks")`` (HTTP 429 +
Retry-After) — running out of KV memory is an overload condition, not
a server fault.

Thread contract: batcher thread only (same as the decoder it feeds).
"""

from __future__ import annotations

import hashlib
import heapq
from collections import OrderedDict
from typing import Optional


class KVPoolExhausted(RuntimeError):
    """No free KV block: the plain free list is empty and no
    refcount-zero cached block can be evicted.  The engine sheds the
    requesting sequence with ``Overloaded(reason="kv_blocks")``."""


def chain_hash(prev: Optional[bytes], tokens) -> bytes:
    """Chained content hash of one FULL prompt block: the previous
    block's hash (``None`` for block 0) concatenated with this block's
    token ids.  Chaining makes the hash cover the whole prefix, so a
    lookup hit on block ``i`` guarantees blocks ``0..i`` match too."""
    h = hashlib.sha1(prev or b"\x00")
    h.update(bytes(memoryview(tokens).cast("B")))
    return h.digest()


class BlockAllocator:
    """Refcounted fixed-size KV-block free list with a content-hash
    prefix cache (module docstring has the design).

    ``num_blocks`` counts the WHOLE pool including the ``reserved``
    scratch prefix (block 0); ``capacity`` is what is actually
    allocatable.  All counters are plain ints read by ``stats()``.
    """

    __slots__ = ("num_blocks", "block_size", "reserved", "_free",
                 "_ref", "_hash_of", "_by_hash", "_lru",
                 "prefix_hits", "prefix_misses", "evictions",
                 "cow_copies", "alloc_count", "release_count")

    def __init__(self, num_blocks: int, block_size: int,
                 reserved: int = 1):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if num_blocks <= reserved:
            raise ValueError(
                f"need more than {reserved} reserved block(s), got "
                f"num_blocks={num_blocks}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.reserved = int(reserved)
        self._free = list(range(self.reserved, self.num_blocks))
        heapq.heapify(self._free)
        self._ref: dict = {}              # block -> refcount (> 0)
        self._hash_of: dict = {}          # block -> chain hash
        self._by_hash: dict = {}          # chain hash -> block
        # refcount-0 registered blocks, oldest-first (the LRU victim
        # order); values unused
        self._lru: OrderedDict = OrderedDict()
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.evictions = 0
        self.cow_copies = 0
        self.alloc_count = 0
        self.release_count = 0

    # ------------------------------------------------------------ alloc
    @property
    def capacity(self) -> int:
        return self.num_blocks - self.reserved

    def alloc(self) -> int:
        """One fresh PRIVATE block (refcount 1).  Prefers the plain
        free list; falls back to evicting the least-recently-used
        refcount-zero cached block (dropping its hash registration).
        Raises ``KVPoolExhausted`` when neither has a block."""
        if self._free:
            b = heapq.heappop(self._free)
        elif self._lru:
            b, _ = self._lru.popitem(last=False)
            h = self._hash_of.pop(b)
            del self._by_hash[h]
            self.evictions += 1
        else:
            raise KVPoolExhausted(
                f"kv block pool exhausted: {self.used} of "
                f"{self.capacity} blocks hold live sequences and no "
                f"cached prefix block is evictable")
        self._ref[b] = 1
        self.alloc_count += 1
        return b

    def incref(self, b: int) -> None:
        self._ref[b] += 1

    def release(self, b: int) -> None:
        """Drop one reference.  At zero, a hash-registered block parks
        in the LRU cache (still a ``lookup`` hit, evictable on
        demand); an unregistered block returns to the free list."""
        rc = self._ref.get(b)
        if rc is None:
            raise ValueError(f"block {b} is not allocated")
        if rc > 1:
            self._ref[b] = rc - 1
            return
        del self._ref[b]
        self.release_count += 1
        if b in self._hash_of:
            self._lru[b] = None           # newest at the end
        else:
            heapq.heappush(self._free, b)

    # ----------------------------------------------------- prefix cache
    def lookup(self, h: bytes) -> Optional[int]:
        """Prefix-cache consult for one full prompt block.  A hit
        RETURNS THE BLOCK WITH A REFERENCE TAKEN (resurrecting it from
        the LRU pool if it was parked); a miss returns None."""
        b = self._by_hash.get(h)
        if b is None:
            self.prefix_misses += 1
            return None
        if b in self._lru:                # parked at refcount 0
            del self._lru[b]
            self._ref[b] = 1
        else:
            self._ref[b] += 1
        self.prefix_hits += 1
        return b

    def register(self, h: bytes, b: int) -> int:
        """Publish a WRITTEN full prompt block under its chain hash.
        First writer wins: if the hash is already mapped (a concurrent
        identical prompt registered first, or this block came FROM the
        cache), the existing mapping stands and this block stays
        private.  Returns 1 if the block became shareable, else 0."""
        if h in self._by_hash:
            return 0
        if b in self._hash_of:            # block already published
            return 0
        self._by_hash[h] = b
        self._hash_of[b] = h
        return 1

    # ------------------------------------------------------------ stats
    @property
    def used(self) -> int:
        """Blocks holding live (refcount > 0) data."""
        return len(self._ref)

    @property
    def cached(self) -> int:
        """Refcount-zero prefix blocks parked in the LRU pool."""
        return len(self._lru)

    @property
    def free(self) -> int:
        return len(self._free)

    def shared(self) -> int:
        """Blocks currently backing MORE than one sequence."""
        return sum(1 for rc in self._ref.values() if rc > 1)

    def leaked(self) -> list:
        """Blocks still referenced — after every sequence has retired
        this must be empty (the no-leak test surface; cached/parked
        blocks are deliberate retention, not leaks)."""
        return sorted(self._ref)

    def stats(self) -> dict:
        return {"num_blocks": self.num_blocks,
                "block_size": self.block_size,
                "capacity": self.capacity,
                "used": self.used,
                "free": self.free,
                "cached": self.cached,
                "shared": self.shared(),
                "prefix_hits": self.prefix_hits,
                "prefix_misses": self.prefix_misses,
                "evictions": self.evictions,
                "cow_copies": self.cow_copies,
                "utilization_pct": round(
                    self.used / self.capacity * 100.0, 2)
                if self.capacity else 0.0}
