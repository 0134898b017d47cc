"""Paged block-pool cache manager: block tables, refcounts, copy-on-write
sharing (PyTorch port of ``repro/serving/cache_manager.py``).

The monolithic serving caches (``transformer.init_cache``) back every
request with a contiguous ``(B, max_len, ...)`` buffer per layer: growing a
session means ``grow_cache``'s whole-buffer copy, and a system prompt
absorbed once is re-materialised per slot.  Engines built with
``paged=True`` use this module instead:

* **Block pool** — every attention layer's K/V lives in a fixed pool of
  fixed-size blocks (``attention.KVPool``: ``(n_blocks, block_len,
  kv_heads, head_dim)``, positions alongside, plus the sink block that
  dropped writes land in); every recurrent layer's state (RG-LRU, SSD)
  lives in ``n_rows`` state rows (plus a sink row).  The pools are built by
  ``transformer.init_block_pool`` and owned by one :class:`CachePool` per
  engine.
* **Block tables and state rows** — a session references storage through
  a ``(B, nb)`` int32 table of pool block ids and a ``(B,)`` state-row id
  per row.  A dispatch uploads its tables and rows once and reads and
  writes the pools through them.  Every session row holds a row, also on a
  model without recurrent layers (as in the reference), so rows gate
  admission beside blocks.
* **Growth without copy** — extending a session appends freshly reset
  blocks to its table; nothing existing is copied (the engine's
  ``grow_copy`` counter stays 0).
* **Copy-on-write prefix sharing** — fanning a session out to N rows copies
  its *table* and bumps per-block refcounts; blocks at or past the next
  write position are COW-copied per row (at most the one partially filled
  tail block, plus a local-attention ring's blocks), everything earlier is
  shared read-only; state rows are rewritten every step, so a fork gets
  its own copy of them (``transformer.copy_rows``).  A shared block
  (refcount > 1) is never in a
  dispatch's write range: the dispatches write only the blocks covering the
  positions they write (``attention.paged_scatter_blocks`` /
  ``paged_scatter_delta``), and ``extend`` / ``admit_row`` COW-copy every
  shared block in that range first.  So one absorbed system prompt serves
  N sessions with exactly one prefill.
* **Eviction / TTL** — handles are registered with the pool;
  ``evict_idle(ttl_s)`` releases those idle past the TTL and returns their
  blocks and rows.  Reusing an evicted handle raises.
* **On a mesh** (the reference's ``act_pool``: the pool's block and
  state-row dims over the batch axes) every rank owns a pool of its own:
  its share of the blocks and rows (``sharding.pool_share``: ``n / d``
  over d data ranks) holding its own KV heads, with a host allocator of its
  own.  The rows a rank computes live in its pool: its B/d rows of a batch
  the data axes split, every row of one they replicate (``serve()``'s
  batch-1 admissions, a batch d does not divide), so a replicated row
  takes room on every data rank.  Ranks of one data coordinate hold the
  same rows and make the same calls, so their allocators stay equal; data
  ranks may not.  Every decision that could differ between them is agreed
  before anything acts on it (``reserve``, ``free_counts``,
  ``evict_idle``: ``sharding.Comm.agree`` over the batch axes), so all
  ranks raise, defer or evict together and their counters read alike: a
  rank that raised alone while the others went on to a collective would
  hang the run.  Off a mesh, and on a mesh with one data rank, nothing is
  agreed and no collective is issued.

Host bookkeeping is numpy (heap free lists, refcounts); the device work is
block and row reset and copy, written in place (``index_put_``,
``index_fill_``, ``index_copy_``), O(the blocks and rows touched): captured
dispatches and live handles hold the pools' addresses, so a pool is never
re-made.  JAX's
pool is a value that each dispatch returns and ``CachePool.commit`` swaps
in; the port's dispatches write the pools in place, so the port's pool has
no ``commit``.
"""

from __future__ import annotations

import dataclasses
import heapq
import time

import numpy as np

from repro_torch.distributed import sharding as sh
from repro_torch.models import quant as Q
from repro_torch.models import transformer as T
from repro_torch.serving.faults import PoolExhaustedError


class EvictedSessionError(ValueError):
    """A paged session handle was used after release / TTL eviction."""


class QuantMismatchError(ValueError):
    """A session checkpoint's cache representation does not match the
    restoring engine's (``cache_quant`` differs, or a quantized paged
    checkpoint meets a monolithic engine).  Raised instead of silently
    changing the session's numeric precision mid-conversation."""


@dataclasses.dataclass
class PagedHandle:
    """A session's view into a :class:`CachePool`.

    ``tables`` holds only the *covered* blocks (positions written so far,
    rounded up to a block); the engine re-extends to the dispatch width with
    freshly reset blocks — the content the monolithic cache has there —
    before running, so trimming does not change the numbers.  ``epoch`` is
    the pool epoch at creation; with ``sid`` it makes stale reuse loud."""

    tables: np.ndarray          # (B, nb_covered) int32 pool block ids
    rows: np.ndarray            # (B,) int32 state-row ids
    sid: int                    # session id in the owning pool
    epoch: int                  # pool epoch at creation

    @property
    def batch(self) -> int:
        return int(self.tables.shape[0])


class CachePool:
    """Fixed pool of KV blocks and recurrent-state rows with a host
    allocator.

    One per paged ``InferenceEngine``.  Owns the device pools
    (``self.arrays``: one per layer, ``transformer.init_block_pool``),
    written in place by the dispatches.  Allocation takes the
    lowest-numbered free blocks and rows (heaps), so a slot's run stays as
    contiguous as the churn allows."""

    def __init__(self, cfg, block_len: int, n_blocks: int, n_rows: int, *,
                 cache_quant: str | None = None, device=None,
                 clock=time.monotonic, comm=None, axes=()):
        # on a mesh: ``cfg`` the rank's (its KV heads), ``n_blocks`` and
        # ``n_rows`` its share, ``comm`` the mesh's collectives and
        # ``axes`` the batch axes the data ranks agree over
        self.comm, self.axes = comm, tuple(axes)
        self.shard, self.shards = 0, 1
        if comm is not None:
            self.shard, self.shards = sh.shard_index(self.axes, comm.mesh)
        self.cfg = cfg
        self.block_len = int(block_len)
        self.n_blocks = int(n_blocks)
        self.n_rows = int(n_rows)
        self.cache_quant = Q.check_quant(cache_quant)
        self._clock = clock
        # local-attention layers view the FIRST ring_blocks table entries as
        # a ring (slot = position % window): once decode wraps, any of them
        # is in the write range whatever the linear write position, so COW
        # treats them as writable when shared
        self.ring_blocks = 0
        if cfg.window is not None and any(
                m == "attn_local" for m, _ in cfg.layer_plan()):
            self.ring_blocks = max(cfg.window // block_len, 1)
        self.arrays = T.init_block_pool(cfg, n_blocks, block_len, n_rows,
                                        cache_quant=cache_quant,
                                        device=device)
        self._free = list(range(n_blocks))
        heapq.heapify(self._free)
        self._free_rows = list(range(n_rows))
        heapq.heapify(self._free_rows)
        self.ref = np.zeros((n_blocks,), np.int64)
        self.row_ref = np.zeros((n_rows,), np.int64)
        self.epoch = 0
        self._sessions: dict[int, dict] = {}
        self._next_sid = 0
        # the reference's counters: ``row_copies`` counts the session rows
        # forked by ``fork`` / ``admit_row`` (each copies a state row)
        self.counters = {"blocks_alloc": 0, "blocks_freed": 0,
                         "blocks_reset": 0, "cow_copies": 0,
                         "row_copies": 0, "evictions": 0, "high_water": 0}

    # ------------------------------------------------------------------
    # raw block allocation
    # ------------------------------------------------------------------

    @property
    def blocks_in_use(self) -> int:
        return self.n_blocks - len(self._free)

    @property
    def rows_in_use(self) -> int:
        return self.n_rows - len(self._free_rows)

    @property
    def block_bytes(self) -> int:
        """Device bytes per served block over all layers, in the stored
        representation (quantized payload plus f32 scales)."""
        return sum(t.nbytes for pool in T._kv_pools(self.arrays)
                   for t in pool.served() if t is not None) // self.n_blocks

    @property
    def row_bytes(self) -> int:
        """Device bytes per state row over all recurrent layers (the sink
        row not counted)."""
        return sum(t[0].nbytes for pool in T._state_pools(self.arrays)
                   for t in pool)

    @property
    def pool_bytes(self) -> int:
        """Device bytes of the served blocks (the sink not counted)."""
        return self.block_bytes * self.n_blocks

    @property
    def quant_label(self) -> str:
        return self.cache_quant or "bf16"

    def _famine_detail(self) -> str:
        return (f"{self.quant_label} blocks of "
                f"{self.block_bytes / 1024:.1f} KiB, pool "
                f"{self.pool_bytes / 2**20:.1f} MiB")

    def can_alloc(self, n_blocks: int, n_rows: int = 0) -> bool:
        return (len(self._free) >= n_blocks
                and len(self._free_rows) >= n_rows)

    def _agree(self, x, op: str):
        """``x`` agreed over the data ranks (``sharding.Comm.agree``), as
        a list; ``x`` itself off a mesh."""
        if self.comm is None:
            return list(x)
        return self.comm.agree(x, self.axes, op).tolist()

    def reserve(self, n_blocks: int, n_rows: int = 0) -> None:
        """Raise ``PoolExhaustedError`` on every data rank unless each has
        the free blocks and rows it asks for (its own need: the ranks'
        may differ).  Called before an operation allocates, so a short
        pool changes nothing and no rank goes on alone."""
        ok = self.can_alloc(n_blocks, n_rows)
        short = self._agree([int(not ok)], "sum")[0]
        if short:
            where = ("" if self.shards == 1 else
                     f" on {short} of {self.shards} data ranks"
                     + ("" if ok else f" (this one, data rank {self.shard})"))
            raise PoolExhaustedError(
                f"cache pool exhausted{where}: need {n_blocks} blocks and "
                f"{n_rows} state rows, {len(self._free)}/{self.n_blocks} "
                f"blocks and {len(self._free_rows)}/{self.n_rows} rows free "
                f"({self._famine_detail()}) — grow pool_blocks, release "
                "sessions, or enable TTL eviction")

    def free_counts(self) -> np.ndarray:
        """(d, 2) free blocks and free rows of every data rank's pool, the
        same array on every rank (one agreement; this pool's own counts off
        a mesh): ``serve()`` decides each slot's admission against the
        pool of the rank that holds the slot."""
        x = np.zeros((self.shards, 2), np.int64)
        x[self.shard] = (len(self._free), len(self._free_rows))
        return np.asarray(self._agree(x, "sum"), np.int64)

    def alloc_blocks(self, n: int, *,
                     reset: bool | str = True) -> np.ndarray:
        """Take ``n`` free blocks (refcount 1).  ``reset=True`` zeroes their
        K/V and sets pos -1: O(n), the paged replacement for the monolithic
        ``grow_cache`` copy; ``"dispatch"`` leaves that to the caller's
        dispatch (``alloc``)."""
        if len(self._free) < n:
            raise PoolExhaustedError(
                f"cache pool exhausted: need {n} blocks, "
                f"{len(self._free)}/{self.n_blocks} free "
                f"({self._famine_detail()}) — grow pool_blocks, "
                "release sessions, or enable TTL eviction")
        ids = np.array([heapq.heappop(self._free) for _ in range(n)],
                       np.int32)
        self.ref[ids] = 1
        self.counters["blocks_alloc"] += n
        self.counters["high_water"] = max(self.counters["high_water"],
                                          self.blocks_in_use)
        if reset and n:
            if reset != "dispatch":
                T.reset_blocks(self.cfg, self.arrays, ids)
            self.counters["blocks_reset"] += n
        return ids

    def free_blocks(self, ids: np.ndarray) -> None:
        """Drop one reference per id; blocks at refcount 0 return to the
        free list (repeats in ``ids`` drop that many references)."""
        for i in np.asarray(ids, np.int64).ravel():
            self.ref[i] -= 1
            assert self.ref[i] >= 0, f"double free of block {i}"
            if self.ref[i] == 0:
                heapq.heappush(self._free, int(i))
                self.counters["blocks_freed"] += 1

    def share_blocks(self, ids: np.ndarray) -> None:
        np.add.at(self.ref, np.asarray(ids, np.int64).ravel(), 1)

    def alloc_rows(self, n: int, *, reset: bool | str = True) -> np.ndarray:
        """Take ``n`` free state rows, zeroed in place (refcount 1)."""
        if len(self._free_rows) < n:
            raise PoolExhaustedError(
                f"cache pool exhausted: need {n} state rows, "
                f"{len(self._free_rows)}/{self.n_rows} free")
        ids = np.array([heapq.heappop(self._free_rows) for _ in range(n)],
                       np.int32)
        self.row_ref[ids] = 1
        if n and reset != "dispatch":
            T.reset_rows(self.cfg, self.arrays, ids)
        return ids

    def free_rows(self, ids: np.ndarray) -> None:
        """Drop one reference per row id; rows at refcount 0 return to the
        free list."""
        for i in np.asarray(ids, np.int64).ravel():
            self.row_ref[i] -= 1
            assert self.row_ref[i] >= 0, f"double free of row {i}"
            if self.row_ref[i] == 0:
                heapq.heappush(self._free_rows, int(i))

    # ------------------------------------------------------------------
    # session handles
    # ------------------------------------------------------------------

    def register(self, tables: np.ndarray, rows: np.ndarray) -> PagedHandle:
        sid = self._next_sid
        self._next_sid += 1
        h = PagedHandle(np.asarray(tables, np.int32).copy(),
                        np.asarray(rows, np.int32).copy(), sid, self.epoch)
        self._sessions[sid] = {"handle": h, "last_used": self._clock()}
        return h

    def alloc(self, batch: int, nb: int, *,
              reset: bool | str = True) -> PagedHandle:
        """A fresh session: ``batch`` runs of ``nb`` reset blocks and
        ``batch`` zeroed state rows.  ``reset="dispatch"``: the caller's
        next dispatch writes every block and row of the session whole (a
        cold whole-generation dispatch writes the reset values past its
        span), so nothing is written here; the blocks still count in
        ``counters["blocks_reset"]``."""
        self.reserve(batch * nb, batch)
        tables = self.alloc_blocks(batch * nb, reset=reset).reshape(batch,
                                                                    nb)
        return self.register(tables, self.alloc_rows(batch, reset=reset))

    def check(self, handle: PagedHandle) -> None:
        """Validate + touch a handle; raises on released/evicted ones."""
        meta = self._sessions.get(handle.sid)
        if meta is None or meta["handle"] is not handle:
            raise EvictedSessionError(
                f"paged session {handle.sid} (pool epoch {handle.epoch}) was "
                f"released or TTL-evicted (pool epoch now {self.epoch}); its "
                "blocks are recycled — re-absorb the context")
        meta["last_used"] = self._clock()

    def release(self, handle: PagedHandle) -> None:
        """Return a session's blocks and rows to the pool and invalidate
        it."""
        self.check(handle)
        del self._sessions[handle.sid]
        self.free_blocks(handle.tables)
        self.free_rows(handle.rows)

    def evict_idle(self, ttl_s: float, now: float | None = None,
                   exclude=()) -> int:
        """Release every registered session idle for more than ``ttl_s``
        seconds, except the session ids in ``exclude`` (serve() passes the
        handles its queued warm requests still reference); bumps the epoch
        when anything was evicted."""
        now = self._clock() if now is None else now
        # on a mesh the data ranks' clocks differ: a session idle on any
        # rank is evicted on all (the ranks hold the same session ids)
        sids = sorted(self._sessions)
        idle = [int(now - self._sessions[sid]["last_used"] > ttl_s
                    and sid not in exclude) for sid in sids]
        if sids:
            idle = self._agree(idle, "max")
        victims = [sid for sid, f in zip(sids, idle) if f]
        for sid in victims:
            h = self._sessions.pop(sid)["handle"]
            self.free_blocks(h.tables)
            self.free_rows(h.rows)
            self.counters["evictions"] += 1
        if victims:
            self.epoch += 1
        return len(victims)

    @property
    def live_sessions(self) -> int:
        return len(self._sessions)

    # ------------------------------------------------------------------
    # COW table operations
    # ------------------------------------------------------------------

    def _cow_and_grow(self, run: np.ndarray, nb: int, write_pos: int,
                      cow_src: list, cow_dst: list,
                      fresh: list) -> np.ndarray:
        """One table row made safe to write from ``write_pos`` and extended
        to ``nb`` blocks.  Shared blocks in the write range — linear blocks
        at or past the write position, plus the first ``ring_blocks``
        entries a local layer may wrap into — are queued for COW copy;
        missing tail blocks for fresh allocation.  The caller batches the
        device copies and resets (``_flush``)."""
        row = [int(b) for b in run]
        for j in range(len(row)):
            if not self._writable(j, len(row), write_pos):
                continue                       # read-only prefix: share
            if self.ref[row[j]] > 1:
                nbk = int(self.alloc_blocks(1, reset=False)[0])
                cow_src.append(row[j])
                cow_dst.append(nbk)
                self.free_blocks(np.array([row[j]]))   # drop our shared ref
                row[j] = nbk
        if len(row) < nb:
            new = self.alloc_blocks(nb - len(row), reset=False)
            fresh.extend(int(b) for b in new)
            row.extend(int(b) for b in new)
        return np.asarray(row[:nb], np.int32)

    def _writable(self, j: int, n: int, write_pos: int) -> bool:
        """Whether entry ``j`` of an ``n``-block table row is in the write
        range from ``write_pos``: at or past its block, or a ring block."""
        return not (self.ring_blocks <= j < min(write_pos // self.block_len,
                                                 n))

    def _grow_need(self, run: np.ndarray, nb: int, write_pos: int) -> int:
        """The blocks ``_cow_and_grow`` takes for one table row: its
        shared blocks in the write range and its missing tail."""
        cow = sum(1 for j, b in enumerate(run)
                  if self._writable(j, len(run), write_pos)
                  and self.ref[b] > 1)
        return cow + max(nb - len(run), 0)

    def _flush(self, cow_src: list, cow_dst: list, fresh: list) -> None:
        if cow_src:
            T.copy_blocks(self.cfg, self.arrays, cow_src, cow_dst)
            self.counters["cow_copies"] += len(cow_src)
        if fresh:
            T.reset_blocks(self.cfg, self.arrays, fresh)
            self.counters["blocks_reset"] += len(fresh)

    def extend(self, handle: PagedHandle, nb: int,
               write_pos: np.ndarray) -> np.ndarray:
        """Grow ``handle`` (in place) to ``nb`` blocks per row, COW-copying
        any shared block in the per-row write range.  Returns the new
        ``(B, nb)`` tables."""
        self.check(handle)
        write_pos = np.asarray(write_pos, np.int64).reshape(-1)
        self.reserve(sum(self._grow_need(handle.tables[b], nb,
                                         int(write_pos[b]))
                         for b in range(handle.batch)))
        cow_src, cow_dst, fresh = [], [], []
        rows = [self._cow_and_grow(handle.tables[b], nb, int(write_pos[b]),
                                   cow_src, cow_dst, fresh)
                for b in range(handle.batch)]
        self._flush(cow_src, cow_dst, fresh)
        handle.tables = np.stack(rows, axis=0)
        return handle.tables

    def fork(self, tables: np.ndarray, rows: np.ndarray) -> PagedHandle:
        """A NEW handle over ``tables`` (B, nb), copied by reference
        (refcount++; a repeated row fans one row out), and fresh copies of
        state rows ``rows`` (B,) (``copy_rows``): ``state_select``'s fork,
        O(table + state rows), never O(cache).  The caller reserves the
        rows (``reserve``)."""
        return self.register(tables, self.share_run(tables, rows))

    def share_run(self, tables: np.ndarray, rows: np.ndarray) -> np.ndarray:
        """``fork``'s work without the handle: a reference on every block
        of ``tables`` and fresh copies of state rows ``rows``, returned."""
        self.share_blocks(tables)
        new = self.alloc_rows(len(rows))
        T.copy_rows(self.cfg, self.arrays, rows, new)
        self.counters["row_copies"] += len(rows)
        return new

    def admit_row(self, handle: PagedHandle, nb: int, write_pos: int,
                  row_index: int = 0) -> tuple[np.ndarray, int]:
        """Serve-slot admission off a (possibly shared) handle: the slot
        gets its own table row — prefix blocks shared by reference,
        write-range blocks COW-copied, tail freshly allocated — and its own
        copy of the state row.  The handle itself is untouched, so N
        requests can admit off one absorbed prefix.  Returns (run, row)."""
        self.check(handle)
        self.share_blocks(handle.tables[row_index])   # our working reference
        cow_src, cow_dst, fresh = [], [], []
        run = self._cow_and_grow(handle.tables[row_index], nb, write_pos,
                                 cow_src, cow_dst, fresh)
        self._flush(cow_src, cow_dst, fresh)
        row = int(self.alloc_rows(1)[0])
        T.copy_rows(self.cfg, self.arrays,
                    handle.rows[row_index:row_index + 1], [row])
        self.counters["row_copies"] += 1
        return run, row

    def alloc_run(self, nb: int) -> tuple[np.ndarray, int]:
        """A cold serve-slot run: ``nb`` reset blocks and one zeroed row."""
        return self.alloc_blocks(nb), int(self.alloc_rows(1)[0])

    def adopt(self, blocks: np.ndarray, row: int,
              covered_blocks: int) -> PagedHandle:
        """Turn an owned serve-slot run and its row into a session handle,
        trimmed to ``covered_blocks`` (the rest is freed: a session keeps
        O(len), not O(max_len))."""
        blocks = np.asarray(blocks, np.int32)
        keep, drop = blocks[:covered_blocks], blocks[covered_blocks:]
        if len(drop):
            self.free_blocks(drop)
        return self.register(keep[None], np.array([row], np.int32))

    def trim(self, handle: PagedHandle, covered_blocks: int) -> None:
        """Free blocks past ``covered_blocks`` in every row of ``handle``
        (never written there; re-extension resets fresh blocks to the same
        contents)."""
        if covered_blocks >= handle.tables.shape[1]:
            return
        self.free_blocks(handle.tables[:, covered_blocks:])
        handle.tables = handle.tables[:, :covered_blocks].copy()
