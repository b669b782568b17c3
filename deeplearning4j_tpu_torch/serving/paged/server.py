"""Paged-KV generative serving: block pool + prefix cache over the
continuous-batching scheduler.

Counterpart of ``deeplearning4j_tpu/serving/paged/server.py``
(``PagedGenerativeSpec`` :74, ``PagedMetrics`` :136,
``PagedGenerativeServer`` :218 with its speculative hooks :605-680),
copied and adapted to tensors on the card. K/V live in fixed-size token BLOCKS carved from one preallocated
slab ``[layers, num_blocks, heads, block_size, head_dim]``, and each
request holds a BLOCK TABLE grown one block at a time at decode-step
boundaries; every layer of a decode step is one ``paged_decode_attention``
launch that writes the step's K/V rows and reads each lane's blocks
through its table.

- **block pool** (``pool.py``): admission is gated on BLOCKS two ways:
  ``submit`` reserves each request's worst-case block footprint against
  pool capacity (shedding typed :class:`PoolExhaustedError` with a
  ``retry_after_s`` hint; the reservation is released exactly once via
  the request future's done callback), and ``_can_place`` holds a queued
  request at the FRONT until enough blocks are actually free.
- **prefix caching**: full prompt blocks are content-addressed by chain
  hash; a repeated prefix prefills only its SUFFIX (``hist`` cached
  tokens reuse their blocks). Refcounts release exactly once on
  completion, shed, cancel and crash-recovery requeue (``pool.reset()``
  on worker respawn); a hot reload (``update_model``) flushes the cache
  at the worker's next step boundary, since cached K/V belong to the
  superseded weights.
- **speculative decoding** (``draft_spec=``): the draft runs dense on its
  own slabs, prefilled with the full prefix; before a round every active
  lane's table grows to cover the window rows its token budget can use
  (else the round is a plain step), and the verify writes those rows
  through the table. A rejected tail releases no block: the blocks stay
  the lane's, and its positions never advance over the rejected rows.
- **tensor parallel** (``tp > 1``) is not ported yet and raises.

Correctness contract: with ``max_blocks_per_req * block_size ==
max_seq`` the paged server's greedy tokens equal the dense
:func:`~deeplearning4j_tpu_torch.serving.generative.greedy_decode`'s, bit
for bit: the kernel's sums run in an order set by key position alone.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.memory import AllocationsTracker
from deeplearning4j_tpu_torch.monitor import memstats
from deeplearning4j_tpu_torch.serving.generative import (GenerationHandle,
                                                         GenerationRequest,
                                                         GenerativeMetrics,
                                                         GenerativeServer,
                                                         SlotAllocator, _slab)
from deeplearning4j_tpu_torch.serving.metrics import safe_ratio
from deeplearning4j_tpu_torch.serving.paged.pool import (NULL_BLOCK,
                                                         BlockPool,
                                                         PoolExhaustedError,
                                                         blocks_for_tokens,
                                                         prefix_block_hashes)


@dataclass
class PagedGenerativeSpec:
    """A model's PAGED generative-serving contract (produced by
    ``zoo.gpt.gpt_paged_spec``).

    - ``params()`` pulls the current parameter tensors by name.
    - ``make_fns(block_size, max_blocks_per_req)`` builds the
      ``(prefill_fn, decode_fn, verify_fn)`` triple for one block
      geometry (io contracts on ``zoo.gpt.gpt_paged_decode_fns``).
    - ``kv_shape(num_blocks, block_size)`` is the shape of ONE slab:
      ``[layers, num_blocks, heads, block_size, head_dim]``.
    """

    params: Callable[[], Dict[str, torch.Tensor]]
    make_fns: Callable[[int, int], tuple]
    kv_shape: Callable[[int, int], tuple]
    vocab_size: int
    max_seq_len: int
    num_heads: int
    kv_dtype: str = "float32"
    eos_id: Optional[int] = None


class PagedMetrics(GenerativeMetrics):
    """GenerativeMetrics plus the paged lanes: pool occupancy (held
    blocks per decode step over capacity), prefix-cache hit rate,
    blocks per retired request, alloc/release counters. Every ratio is
    :func:`safe_ratio`: 0.0 at cold start, never NaN."""

    def __init__(self, max_slots: int = 0, num_blocks: int = 0,
                 block_size: int = 0):
        super().__init__(max_slots)
        self.num_blocks = int(num_blocks)     # usable (non-null) blocks
        self.block_size = int(block_size)
        for c in ("prefix_lookups", "prefix_hits", "prefix_blocks_hit",
                  "prefix_cache_flushes",
                  "blocks_allocated", "blocks_released",
                  "blocks_held_sum", "pool_samples",
                  "request_blocks_sum", "requests_retired"):
            self.counters[c] = 0
        self._pool_stats: Dict[str, int] = {}

    def observe_pool(self, held: int, stats: Optional[dict] = None) -> None:
        """One per-decode-step occupancy sample (held blocks)."""
        with self._lock:
            self.counters["blocks_held_sum"] += int(held)
            self.counters["pool_samples"] += 1
            if stats is not None:
                self._pool_stats = dict(stats)

    def observe_prefix(self, looked_up: bool, blocks_hit: int) -> None:
        with self._lock:
            if looked_up:
                self.counters["prefix_lookups"] += 1
            if blocks_hit > 0:
                self.counters["prefix_hits"] += 1
                self.counters["prefix_blocks_hit"] += int(blocks_hit)

    def observe_blocks(self, allocated: int = 0, released: int = 0) -> None:
        with self._lock:
            self.counters["blocks_allocated"] += int(allocated)
            self.counters["blocks_released"] += int(released)

    def observe_request_blocks(self, n: int) -> None:
        with self._lock:
            self.counters["request_blocks_sum"] += int(n)
            self.counters["requests_retired"] += 1

    def to_record(self) -> dict:
        rec = super().to_record()
        with self._lock:
            c = self.counters
            rec["paged"] = {
                "num_blocks": self.num_blocks,
                "block_size": self.block_size,
                "pool_occupancy": round(safe_ratio(
                    c["blocks_held_sum"],
                    c["pool_samples"] * self.num_blocks), 4),
                "prefix_hit_rate": round(safe_ratio(
                    c["prefix_hits"], c["prefix_lookups"]), 4),
                "prefix_blocks_hit": c["prefix_blocks_hit"],
                "blocks_per_request": round(safe_ratio(
                    c["request_blocks_sum"], c["requests_retired"]), 3),
                "blocks_allocated": c["blocks_allocated"],
                "blocks_released": c["blocks_released"],
                "prefix_cache_flushes": c["prefix_cache_flushes"],
                "evictions": self._pool_stats.get("evictions", 0),
                "cached_blocks": self._pool_stats.get("cached", 0),
                "held_blocks": self._pool_stats.get("held", 0)}
        return rec

    def stats(self) -> str:
        rec = self.to_record()
        p = rec["paged"]
        return "\n".join([
            super().stats(),
            f"  paged: {p['num_blocks']} blocks x {p['block_size']} "
            f"tokens, occupancy {p['pool_occupancy']:.1%}, prefix hit "
            f"rate {p['prefix_hit_rate']:.1%} "
            f"({p['prefix_blocks_hit']} blocks), "
            f"{p['blocks_per_request']} blocks/request, "
            f"{p['evictions']} evictions"])


class PagedGenerativeServer(GenerativeServer):
    """Continuous-batching server over a paged KV block pool.

    ::

        spec = zoo.gpt.gpt_paged_spec(sd, cfg)
        srv = PagedGenerativeServer(spec, max_slots=8, block_size=16,
                                    kv_hbm_bytes=1 << 30)
        tokens = srv.generate([1, 2, 3], max_new_tokens=32)

    - ``block_size``: tokens per KV block.
    - ``num_blocks`` / ``kv_hbm_bytes``: pool size, directly or as a
      device-memory budget (``num_blocks = max(2, budget //
      bytes_per_block)``, ``bytes_per_block`` from the spec's
      ``kv_dtype``: an int8 pool holds 4x the float32 blocks). Default:
      the dense-equivalent worst case (``max_slots`` requests at full
      ``max_seq``), whose short requests release what they do not use.
    - ``max_blocks_per_req``: a block table's entries (default: enough for
      ``max_seq_len``; fewer raises).
    - ``tp``: tensor-parallel ways; only 1 is ported.
    - ``prefix_cache=False`` disables content-addressed block reuse.
    - ``debug_leaks=True`` runs the pool's full accounting invariant
      against the live block tables after EVERY decode step.

    Everything else (admission, queueing, SLO shed, streaming,
    supervision, crash requeue) is inherited from
    :class:`GenerativeServer` unchanged.
    """

    def __init__(self, spec, max_slots: int = 8, block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 kv_hbm_bytes: Optional[int] = None,
                 max_blocks_per_req: Optional[int] = None, tp: int = 1,
                 prefix_cache: bool = True, debug_leaks: bool = False, **kw):
        if int(block_size) < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if int(tp) < 1:
            raise ValueError(f"tp must be >= 1, got {tp}")
        if int(tp) > 1:
            raise NotImplementedError(
                "tensor-parallel serving (tp > 1) is not ported yet "
                "(ROADMAP queue 1 item 2.7)")
        # subclass knobs FIRST: super().__init__ calls the _make_metrics
        # and _init_kv hooks below, which read them
        self.block_size = int(block_size)
        self._num_blocks_arg = num_blocks
        self._kv_hbm_bytes_arg = kv_hbm_bytes
        self._maxb_arg = max_blocks_per_req
        self.prefix_cache_enabled = bool(prefix_cache)
        self.debug_leaks = bool(debug_leaks)
        self._commit_lock = threading.Lock()
        self._committed = 0          # reserved worst-case blocks
        # hot-reload fence: set by update_model(), consumed by the
        # worker at its next step boundary (the pool is worker-owned)
        self._prefix_flush_pending = threading.Event()
        super().__init__(spec, max_slots=max_slots, **kw)

    # -- hook overrides -------------------------------------------------
    def _coerce_spec(self, spec):
        if not isinstance(spec, PagedGenerativeSpec):
            if hasattr(spec, "paged_spec"):
                spec = spec.paged_spec()
            else:
                raise TypeError(
                    f"{type(spec).__name__} is not paged-servable: pass "
                    f"a PagedGenerativeSpec (e.g. from "
                    f"zoo.gpt.gpt_paged_spec)")
        return spec

    def _make_metrics(self) -> PagedMetrics:
        # the pool geometry is resolved later in _init_kv, which
        # backfills num_blocks/block_size on this instance
        return PagedMetrics(self.max_slots, 0, self.block_size)

    def _slab_shape(self) -> tuple:
        return tuple(self.spec.kv_shape(self._num_blocks, self.block_size))

    def _init_kv(self) -> None:
        """Allocate the paged memory tier: one K + one V slab shaped
        ``[layers, num_blocks, heads, block_size, head_dim]`` (block 0
        reserved as the null block), the block pool, per-slot block
        tables, and the geometry's decode functions."""
        spec = self.spec
        BS = self.block_size
        self._maxb = int(self._maxb_arg) if self._maxb_arg is not None \
            else blocks_for_tokens(self.max_seq_len, BS)
        if self._maxb * BS < self.max_seq_len:
            raise ValueError(
                f"max_blocks_per_req {self._maxb} x block_size {BS} "
                f"cannot hold max_seq_len {self.max_seq_len}")
        itemsize = torch.empty((), dtype=getattr(
            torch, spec.kv_dtype)).element_size()
        self.bytes_per_block = 2 * int(np.prod(spec.kv_shape(1, BS))) \
            * itemsize
        if self._num_blocks_arg is not None:
            num_blocks = int(self._num_blocks_arg)
        elif self._kv_hbm_bytes_arg is not None:
            num_blocks = max(2, int(self._kv_hbm_bytes_arg)
                             // self.bytes_per_block)
        else:
            # the dense-equivalent floor, every slot at full max_seq
            num_blocks = 1 + self.max_slots * self._maxb
        self._num_blocks = num_blocks
        shape = self._slab_shape()
        self.kv_slab_bytes = 2 * int(np.prod(shape)) * itemsize
        memstats.check_headroom(
            self.kv_slab_bytes,
            f"paged KV slabs ({num_blocks} blocks x {BS} tokens)",
            self.device)
        self._kc = _slab(shape, spec.kv_dtype, self.device)
        self._vc = _slab(shape, spec.kv_dtype, self.device)
        AllocationsTracker.get_instance().allocate("kv_slab",
                                                   self.kv_slab_bytes)
        # host scheduler state (the worker thread owns mutation)
        self.pool = BlockPool(num_blocks, BS)
        self.metrics.num_blocks = self.pool.capacity
        self.metrics.block_size = BS
        self._slots = SlotAllocator(self.max_slots)
        self._slot_reqs: List[Optional[GenerationRequest]] = \
            [None] * self.max_slots
        self._tokens = np.zeros(self.max_slots, np.int32)
        self._positions = np.zeros(self.max_slots, np.int32)
        self._active = np.zeros(self.max_slots, bool)
        self._tables = np.zeros((self.max_slots, self._maxb), np.int32)
        self._nblocks = np.zeros(self.max_slots, np.int32)
        fns = spec.make_fns(BS, self._maxb)
        self._prefill_disp, self._decode_disp, self._verify_disp = fns

    # -- block-commitment admission (submit thread) ---------------------
    def _worst_case_blocks(self, prompt_len: int,
                           max_new_tokens: int) -> int:
        return blocks_for_tokens(
            min(int(prompt_len) + int(max_new_tokens), self.max_seq_len),
            self.block_size)

    def _uncommit(self, n: int) -> None:
        with self._commit_lock:
            self._committed -= int(n)

    def submit(self, prompt, max_new_tokens: int = 16,
               **kw) -> GenerationHandle:
        """:meth:`GenerativeServer.submit` plus block-pool admission:
        the request's WORST-CASE block footprint (prompt + full token
        budget) is reserved against pool capacity up front, so a placed
        request can never fail a block allocation mid-decode. A request
        the pool cannot hold alongside the committed load sheds typed
        (:class:`PoolExhaustedError` with a ``retry_after_s`` hint). The
        reservation is released exactly once, whenever the request's
        future resolves. Validation runs BEFORE the commitment: an
        invalid request raises its permanent ValueError even when the
        pool is fully committed."""
        p = self._validate_submit(prompt, max_new_tokens)
        need = self._worst_case_blocks(p.size, max_new_tokens)
        with self._commit_lock:
            if self._committed + need > self.pool.capacity:
                self.metrics.inc("requests_submitted")
                self.metrics.inc("requests_shed")
                hint = (self.admission.retry_hint_s(
                            self._queue.pending() + 1)
                        if self.admission is not None else 0.25)
                raise PoolExhaustedError(
                    f"KV block pool cannot hold the request: needs "
                    f"{need} blocks worst-case, {self._committed} of "
                    f"{self.pool.capacity} already committed — shed at "
                    f"admission", retry_after_s=hint)
            self._committed += need
        try:
            handle = super().submit(p, max_new_tokens, **kw)
        except BaseException:
            self._uncommit(need)
            raise
        handle._req.future.add_done_callback(
            lambda _f, n=need: self._uncommit(n))
        return handle

    def _can_place(self, req: GenerationRequest) -> bool:
        """Step-boundary gate: hold a queued request at the FRONT until
        its prefill's blocks are actually free (free list + evictable
        cached blocks)."""
        need = blocks_for_tokens(int(req.prefix().size), self.block_size)
        return self.pool.usable_free_count() >= need

    # -- worker: prefill / decode / retire ------------------------------
    def _consume_prefix_flush(self) -> None:
        """Hot-reload fence, worker side: update_model() swapped the
        weights, so every cached block holds K/V of the OLD model.
        Consumed at every step boundary AND immediately before each
        prefill's cache lookup (``_admit`` blocks on the queue inside a
        step). In-flight holders keep their refcounts and finish."""
        if self._prefix_flush_pending.is_set():
            self._prefix_flush_pending.clear()
            self.pool.flush_cache()
            self.metrics.inc("prefix_cache_flushes")

    def _step(self, slot) -> bool:
        self._consume_prefix_flush()
        return super()._step(slot)

    def _prefill(self, s: int, req: GenerationRequest) -> None:
        prefix = req.prefix()
        L = int(prefix.size)
        if L > self.max_seq_len - 1:
            # crash-requeued request whose prefix already fills the
            # sequence: nothing left to decode
            self._retire(s)
            return
        BS = self.block_size
        hashes: List[bytes] = []
        hit: List[int] = []
        if self.prefix_cache_enabled:
            self._consume_prefix_flush()
            hashes = prefix_block_hashes(prefix, BS)
            # reuse stops one block short of the full prefix: at least
            # one suffix token runs through prefill (its logits give the
            # first generated token)
            hit = self.pool.lookup(hashes, max_blocks=(L - 1) // BS)
            self.metrics.observe_prefix(True, len(hit))
        hist = len(hit) * BS
        suffix = prefix[hist:]
        Ls = L - hist
        fresh: List[int] = []
        try:
            for _ in range(blocks_for_tokens(L, BS) - len(hit)):
                fresh.append(self.pool.alloc())
        except PoolExhaustedError:
            # roll back BOTH the fresh allocations and the cache-hit
            # retains — the request fails typed without leaking a block
            for b in fresh + hit:
                self.pool.release(b)
            raise
        blocks = hit + fresh
        self.metrics.observe_blocks(allocated=len(fresh))
        self._tables[s, :] = NULL_BLOCK
        self._tables[s, :len(blocks)] = blocks
        self._nblocks[s] = len(blocks)
        bucket = self._buckets.bucket_for(Ls)
        padded = np.zeros(bucket, np.int32)
        padded[:Ls] = suffix
        io = {"tokens": padded, "length": np.int32(Ls),
              "hist": np.int32(hist), "table": self._tables[s].copy()}
        t0 = time.perf_counter()
        out = self._dispatch(self._prefill_disp, io, "serving.prefill",
                             bucket=bucket, slot=s, hist=hist)
        tok = self._resolve_token(req, int(out[2]), out[3])
        self.metrics.observe_prefill((time.perf_counter() - t0) * 1000.0)
        if self.prefix_cache_enabled:
            # content-address the freshly FILLED full blocks (the
            # trailing partial block is still being appended to)
            for u in range(len(hit), min(len(hashes), L // BS)):
                self.pool.register(hashes[u], int(blocks[u]))
        self._positions[s] = L
        self._tokens[s] = tok
        self._active[s] = True
        self._emit(s, req, tok)
        # the draft has no prefix cache: it prefills the FULL prefix into
        # its own dense slabs
        self._draft_prefill(s, prefix, L)

    def _decode_once(self, slot) -> None:
        BS = self.block_size
        # block-table growth at the step boundary: a lane whose next
        # write position crosses into an unallocated block gets one (the
        # submit-side commitment guarantees it; the typed retire is the
        # defensive belt)
        for s in np.flatnonzero(self._active):
            s = int(s)
            u = int(self._positions[s]) // BS
            if u >= int(self._nblocks[s]):
                try:
                    b = self.pool.alloc()
                except PoolExhaustedError as e:   # pragma: no cover
                    self._retire(s, error=e)
                    continue
                self._tables[s, u] = b
                self._nblocks[s] = u + 1
                self.metrics.observe_blocks(allocated=1)
        if not self._active.any():
            return
        super()._decode_once(slot)

    def _decode_io(self) -> dict:
        io = super()._decode_io()
        BS = self.block_size
        wb = np.full(self.max_slots, NULL_BLOCK, np.int32)
        wo = np.zeros(self.max_slots, np.int32)
        for s in np.flatnonzero(io["active"]):
            pos = int(self._positions[s])
            wb[s] = self._tables[s, pos // BS]
            wo[s] = pos % BS
        io.update(tables=self._tables.copy(), write_block=wb, write_off=wo)
        return io

    # -- speculative decoding over the paged tier -----------------------
    def _usable_rows(self, s: int) -> int:
        """Window rows of lane ``s`` within its remaining token budget: the
        rows the submit-side worst-case commitment reserved blocks for
        (the lane retires at its budget, so no later row is read)."""
        req = self._slot_reqs[s]
        rem = (req.max_new_tokens - len(req.generated)
               if req is not None else 0)
        return min(self.speculate_k, max(rem, 0))

    def _spec_ready(self) -> bool:
        """The base readiness, and every active lane's block table grown
        UP FRONT to cover the window's usable rows. If the pool cannot
        (the commitment makes that a defensive case), the round is a plain
        step, whose one-block growth handles it."""
        if not super()._spec_ready():
            return False
        BS = self.block_size
        for s in np.flatnonzero(self._active):
            s = int(s)
            usable = self._usable_rows(s)
            if usable < 1:
                continue
            need = (int(self._positions[s]) + usable - 1) // BS + 1
            while int(self._nblocks[s]) < need:
                try:
                    b = self.pool.alloc()
                except PoolExhaustedError:    # pragma: no cover
                    return False
                self._tables[s, int(self._nblocks[s])] = b
                self._nblocks[s] = int(self._nblocks[s]) + 1
                self.metrics.observe_blocks(allocated=1)
        return True

    def _verify_io(self, window: np.ndarray, positions: np.ndarray,
                   active: np.ndarray) -> dict:
        """The window's write places, ``[S, W]`` (block, offset) pairs
        through each lane's table; rows past a lane's usable rows (and an
        inactive lane's) write nothing (-1), so speculation never writes a
        block the commitment did not reserve."""
        BS = self.block_size
        S, W = window.shape
        wb = np.full((S, W), -1, np.int32)
        wo = np.zeros((S, W), np.int32)
        for s in np.flatnonzero(active):
            s = int(s)
            for j in range(self._usable_rows(s)):
                p = int(positions[s]) + j
                wb[s, j] = self._tables[s, p // BS]
                wo[s, j] = p % BS
        return {"tokens": window, "positions": positions.copy(),
                "active": active.copy(), "tables": self._tables.copy(),
                "write_block": wb, "write_off": wo}

    def _observe_step(self) -> None:
        self.metrics.observe_pool(self.pool.held_count(),
                                  stats=self.pool.stats())

    def _after_step(self) -> None:
        if self.debug_leaks:
            self.pool.check_invariant(tables=[
                self._tables[s, :int(self._nblocks[s])]
                for s in range(self.max_slots)
                if self._slot_reqs[s] is not None])

    def _retire(self, s: int, error: Optional[BaseException] = None,
                timed_out: bool = False, cancelled: bool = False) -> None:
        """Release slot ``s``'s blocks (decrementing shared prefix
        refcounts) exactly once, then the base retirement."""
        req = self._slot_reqs[s]
        if req is not None:
            if (error is None and not cancelled
                    and self.prefix_cache_enabled and req.generated):
                self._register_generated(s, req)
            n = int(self._nblocks[s])
            for u in range(n):
                self.pool.release(int(self._tables[s, u]))
            self.metrics.observe_blocks(released=n)
            self.metrics.observe_request_blocks(n)
            self._tables[s, :] = NULL_BLOCK
            self._nblocks[s] = 0
        super()._retire(s, error=error, timed_out=timed_out,
                        cancelled=cancelled)

    def _register_generated(self, s: int, req) -> None:
        """Content-address the GENERATED span's full blocks at clean
        retirement, not just the prompt's: only blocks whose every
        position was written to KV qualify — the written region is
        ``[0, positions[s])`` (the final emitted token is never written
        back), so exactly ``positions // block_size`` blocks are full.
        Must run BEFORE the release loop (registration needs the block
        held)."""
        BS = self.block_size
        n_full = min(int(self._positions[s]) // BS,
                     int(self._nblocks[s]))
        if n_full <= 0:
            return
        hashes = prefix_block_hashes(req.prefix(), BS, n_blocks=n_full)
        for u, h in enumerate(hashes):
            self.pool.register(h, int(self._tables[s, u]))

    def _reset_state(self) -> None:
        """Crash-recovery respawn: fresh slabs, a hard pool reset (every
        held block released ONCE, the prefix cache dropped: it addresses
        slab rows that may be half written), clean tables. The requeued
        requests keep their submit-side block commitment and re-enter at
        prefill."""
        super()._reset_state()
        self.pool.reset()
        # the wholesale reset already dropped the prefix cache — a
        # pending hot-reload flush is thereby satisfied
        self._prefix_flush_pending.clear()
        self._tables[:] = NULL_BLOCK
        self._nblocks[:] = 0

    # -- warmup ---------------------------------------------------------
    def _warm_calls(self, bucket_list):
        """The decode step with no lane active (it writes nothing), each
        prefill bucket with a table of null blocks (it writes only the
        null block) and, with a draft, the verify at the window's shape
        with no lane active and the draft's own calls."""
        S, MAXB = self.max_slots, self._maxb
        zeros = np.zeros(S, np.int32)
        off = {"positions": zeros, "active": np.zeros(S, bool),
               "tables": np.zeros((S, MAXB), np.int32)}
        yield (f"paged_decode_s{S}", "target", self._decode_disp, self._kc,
               self._vc, {**off, "tokens": zeros, "write_block": zeros,
                          "write_off": zeros})
        for b in bucket_list:
            yield (f"paged_prefill_b{b}", "target", self._prefill_disp,
                   self._kc, self._vc,
                   {"tokens": np.zeros(b, np.int32), "length": np.int32(b),
                    "hist": np.int32(0), "table": np.zeros(MAXB, np.int32)})
        if self.draft_spec is not None:
            W = self.speculate_k
            wz = np.zeros((S, W), np.int32)
            yield (f"paged_verify_s{S}w{W}", "target", self._verify_disp,
                   self._kc, self._vc, {**off, "tokens": wz,
                                        "write_block": wz - 1,
                                        "write_off": wz})
            yield from self._warm_draft_calls(bucket_list)

    def update_model(self) -> None:
        """Re-pull the parameters, and fence the prefix cache: cached
        blocks are content-addressed by token ids alone, but their K/V
        were computed with the weights being replaced. The pool is
        worker-owned, so the flush is flagged here and consumed at the
        next step boundary."""
        super().update_model()
        self._prefix_flush_pending.set()


__all__ = ["PagedGenerativeSpec", "PagedGenerativeServer", "PagedMetrics"]
