"""KV block pool: free-list block allocation + block-granularity
prefix caching over one preallocated paged slab.

Counterpart of ``deeplearning4j_tpu/serving/paged/pool.py`` (host code,
copied): ``BlockPool``, ``prefix_block_hashes``, ``blocks_for_tokens``,
``PoolExhaustedError``. The slab is carved into fixed-size token blocks,
requests hold per-request BLOCK TABLES of block ids, and capacity is
proportional to tokens actually held:

- **block 0 is the NULL block**: never allocated, the target of every
  unused table entry; the paged attention kernel never reads it for
  a row, since it stops at the row's last key.
- **refcounts**: a block is held by every request whose table points at
  it; prefix-cache hits retain shared blocks. ``release()`` of a block
  not currently held raises (the double-free invariant).
- **prefix cache**: full blocks of a prompt are content-addressed by a
  CHAIN hash (each block's hash folds in its predecessor's). A cached
  block whose refcount drops to zero becomes EVICTABLE and parks in an
  LRU; allocation evicts from it only when the free list is empty.
- **leak detection**: :meth:`BlockPool.check_invariant` asserts
  ``free + held + evictable == num_blocks - 1`` and, given the live block
  tables, that every refcount equals the number of tables holding the
  block.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.serving.queue import ServerOverloadedError

#: the reserved null/trash block id (see module docstring)
NULL_BLOCK = 0


class PoolExhaustedError(ServerOverloadedError):
    """Typed capacity shed: the block pool cannot hold the request's
    worst-case token footprint right now. A
    :class:`~deeplearning4j_tpu_torch.serving.queue.ServerOverloadedError`,
    so clients back off with ``retry_after_s`` exactly as for a full
    queue — pool pressure is load, not a crash."""


def prefix_block_hashes(tokens: np.ndarray, block_size: int,
                        n_blocks: Optional[int] = None) -> List[bytes]:
    """Chain hashes of the FULL blocks of ``tokens``: entry ``u`` is
    ``H(entry[u-1] || tokens[u*bs:(u+1)*bs])``, so two requests share
    hash ``u`` iff their first ``(u+1)*block_size`` tokens are
    identical — the content address of a reusable KV block. Partial
    trailing blocks are never hashed (their KV rows are still being
    appended to)."""
    toks = np.asarray(tokens, np.int32).reshape(-1)
    full = int(toks.size) // int(block_size)
    if n_blocks is not None:
        full = min(full, int(n_blocks))
    out: List[bytes] = []
    h_prev = b""
    for u in range(full):
        block = toks[u * block_size:(u + 1) * block_size]
        h = hashlib.blake2b(h_prev + block.tobytes(),
                            digest_size=16).digest()
        out.append(h)
        h_prev = h
    return out


class BlockPool:
    """Refcounted free-list allocator + prefix cache over
    ``num_blocks`` KV blocks of ``block_size`` tokens each.

    Block states (block 0 excluded — it is the permanent null block):

    - *free*: on the free list, contents meaningless;
    - *held*: refcount >= 1 — referenced by that many live block
      tables (a private block has refcount 1, a shared cached prefix
      block has one per reader);
    - *evictable*: refcount 0 but registered in the prefix cache — its
      K/V rows are intact and a future prefix hit revives it for free;
      reclaimed LRU-first when the free list runs dry.
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError(
                f"need at least 2 blocks (1 null + 1 usable), "
                f"got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        # pop() hands out block 1 first — block 0 is never listed
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self._refs: Dict[int, int] = {}
        # content addressing: hash -> block id, block id -> hash
        self._by_hash: Dict[bytes, int] = {}
        self._hash_of: Dict[int, bytes] = {}
        # zero-ref cached blocks, oldest-released first
        self._evictable: "OrderedDict[int, None]" = OrderedDict()
        self.evictions = 0

    # -- capacity -------------------------------------------------------
    @property
    def capacity(self) -> int:
        """Usable blocks (the null block is overhead)."""
        return self.num_blocks - 1

    def free_count(self) -> int:
        """Blocks on the free list proper."""
        return len(self._free)

    def usable_free_count(self) -> int:
        """Blocks allocatable RIGHT NOW: free + evictable-cached."""
        return len(self._free) + len(self._evictable)

    def held_count(self) -> int:
        return len(self._refs)

    def cached_count(self) -> int:
        """Blocks with live cache registrations (held or evictable)."""
        return len(self._by_hash)

    # -- allocation -----------------------------------------------------
    def alloc(self) -> int:
        """Pop a free block (evicting the LRU cached block if the free
        list is empty). The caller holds one reference. Raises
        :class:`PoolExhaustedError` when nothing is reclaimable."""
        if not self._free:
            if not self._evictable:
                raise PoolExhaustedError(
                    f"KV block pool exhausted: all {self.capacity} "
                    f"blocks held by live requests", retry_after_s=0.1)
            b, _ = self._evictable.popitem(last=False)      # LRU
            self._uncache(b)
            self.evictions += 1
            self._free.append(b)
        b = self._free.pop()
        self._refs[b] = 1
        return b

    def retain(self, b: int) -> None:
        """Take one more reference on a held or evictable block (the
        prefix-cache hit path revives evictable blocks here)."""
        if b == NULL_BLOCK:
            raise ValueError("the null block cannot be retained")
        if b in self._refs:
            self._refs[b] += 1
        elif b in self._evictable:
            del self._evictable[b]
            self._refs[b] = 1
        else:
            raise RuntimeError(f"block {b} retained while free")

    def release(self, b: int) -> None:
        """Drop one reference. At zero the block returns to the free
        list — or parks evictable when it is a registered prefix block.
        Releasing an unheld block raises (the double-free invariant)."""
        refs = self._refs.get(b)
        if refs is None:
            raise RuntimeError(
                f"block {b} released twice (or never allocated)")
        if refs > 1:
            self._refs[b] = refs - 1
            return
        del self._refs[b]
        if b in self._hash_of:
            self._evictable[b] = None       # newest at the MRU end
        else:
            self._free.append(b)

    # -- prefix cache ---------------------------------------------------
    def lookup(self, hashes: Sequence[bytes],
               max_blocks: Optional[int] = None) -> List[int]:
        """Longest cached prefix of ``hashes`` (bounded by
        ``max_blocks``), each returned block RETAINED for the caller —
        chain hashing makes a per-position match imply the whole
        prefix matches."""
        out: List[int] = []
        limit = len(hashes) if max_blocks is None \
            else min(len(hashes), int(max_blocks))
        for u in range(limit):
            b = self._by_hash.get(hashes[u])
            if b is None:
                break
            self.retain(b)
            out.append(b)
        return out

    def register(self, h: bytes, b: int) -> bool:
        """Content-address a HELD block the caller just filled. A block
        already registered under another hash, or a hash already naming
        another block (a concurrent fill of the same prefix), leaves
        the cache unchanged — the caller's block stays private."""
        if b == NULL_BLOCK or b not in self._refs:
            raise RuntimeError(f"block {b} must be held to register")
        if h in self._by_hash or b in self._hash_of:
            return False
        self._by_hash[h] = b
        self._hash_of[b] = h
        return True

    def _uncache(self, b: int) -> None:
        h = self._hash_of.pop(b, None)
        if h is not None:
            self._by_hash.pop(h, None)

    def flush_cache(self) -> int:
        """Drop every prefix-cache registration — the hot-reload path:
        cached blocks content-address K/V computed with superseded
        weights, so no FUTURE lookup may reuse them. Evictable blocks
        (refcount 0, kept alive only by their registration) return to
        the free list; held shared blocks keep their refcounts so
        in-flight readers finish — the same accepted in-flight
        staleness as the dense server's ``update_model`` — and, now
        unregistered, go straight back to the free list on their last
        release. Returns the number of registrations dropped."""
        dropped = len(self._by_hash)
        self._by_hash.clear()
        self._hash_of.clear()
        self._free.extend(self._evictable)
        self._evictable.clear()
        return dropped

    # -- lifecycle ------------------------------------------------------
    def reset(self) -> None:
        """Forget everything — the crash-recovery path: a respawned
        worker's slab contents are mid-dispatch garbage, so every held
        block is released and the prefix cache (which addresses slab
        CONTENTS) is dropped wholesale."""
        self._free = list(range(self.num_blocks - 1, 0, -1))
        self._refs.clear()
        self._by_hash.clear()
        self._hash_of.clear()
        self._evictable.clear()

    # -- leak detection -------------------------------------------------
    def check_invariant(
            self,
            tables: Optional[Iterable[Sequence[int]]] = None) -> None:
        """Assert pool accounting is exact: every usable block is in
        exactly one of {free, held, evictable}, and — when the live
        block ``tables`` are provided — every refcount equals the
        number of tables holding that block. Raises AssertionError on
        any leak or double-count."""
        free = set(self._free)
        held = set(self._refs)
        evict = set(self._evictable)
        assert NULL_BLOCK not in free | held | evict, \
            "null block entered the pool"
        assert not (free & held), f"blocks both free and held: " \
            f"{sorted(free & held)}"
        assert not (free & evict), f"blocks both free and evictable: " \
            f"{sorted(free & evict)}"
        assert not (held & evict), f"blocks both held and evictable: " \
            f"{sorted(held & evict)}"
        n = len(free) + len(held) + len(evict)
        assert n == self.capacity, \
            (f"block leak: {len(free)} free + {len(held)} held + "
             f"{len(evict)} evictable = {n} != capacity {self.capacity}")
        for b, h in self._hash_of.items():
            assert self._by_hash.get(h) == b, \
                f"cache maps out of sync for block {b}"
        assert len(self._by_hash) == len(self._hash_of)
        if tables is not None:
            counts: Dict[int, int] = {}
            for table in tables:
                for b in table:
                    b = int(b)
                    if b != NULL_BLOCK:
                        counts[b] = counts.get(b, 0) + 1
            assert counts == dict(self._refs), \
                (f"refcounts diverge from live tables: pool="
                 f"{dict(sorted(self._refs.items()))} "
                 f"tables={dict(sorted(counts.items()))}")

    def stats(self) -> Dict[str, int]:
        return {"capacity": self.capacity,
                "free": len(self._free),
                "held": len(self._refs),
                "evictable": len(self._evictable),
                "cached": len(self._by_hash),
                "evictions": self.evictions}


def blocks_for_tokens(n_tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``n_tokens`` KV rows."""
    return -(-int(n_tokens) // int(block_size))


__all__ = ["BlockPool", "PoolExhaustedError", "NULL_BLOCK",
           "prefix_block_hashes", "blocks_for_tokens"]
