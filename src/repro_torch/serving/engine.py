"""Inference engine: prefill, decode loop, the integrated Eq. 2-4 probe,
warm sessions and the paged block pool (PyTorch).

Mirrors the single-device branches of ``repro/serving/engine.py``:

  * **prefill** absorbs the whole (bucketed, left-padded) prompt in one
    pass that fills every layer cache;
  * **decode** runs ``max_new`` steps of ``transformer.decode_step`` with
    the probe inside; token ``t``'s probe terms come from the logits
    *entering* step ``t`` (the logits that chose it), through the fused
    uncertainty op;
  * **one device call per generate**: on the card a whole ``generate`` —
    the bucketing columns' positions, prefill, the first token's logits,
    the decode loop with the probe, the Eq. 4 combine and, on a paged
    engine, the gather and the scatter back — is ONE replay of a captured
    CUDA graph (``serving/graphs.py``), the port of the reference's
    ``_generate_fused`` / ``_generate_continue`` and their paged siblings.
    The prompt's length and a continuation's start are staged as device
    inputs, so one graph serves every prompt length of a bucket.  A
    decode-only extension and each ``serve()`` chunk are one replay of a
    decode graph (``_decode_scan``); ``absorb`` and ``serve()``'s
    admissions prefill eagerly.  The eager Python route runs the same
    bodies: it is the oracle and the CPU's route;
  * **sessions**: ``generate(..., return_state=True)`` and ``absorb`` hand
    back a ``SessionState``; ``generate(span, k, state=...)`` absorbs a new
    span by ONE continuation prefill (right-padded, the cached context
    never re-absorbed) and ``generate(None, k, state=...)`` extends
    decode-only; ``state_select`` / ``fanout`` fork rows of it;
  * **serve()** streams requests through the ``ContinuousBatcher``: admit
    into free slots (a cold prefill, a warm continuation prefill, or a pure
    decode resume), decode a chunk over all slots (one replay), retire at
    stop token / ``max_new``, combine the Eq. 2-3 means into U at
    retirement, and hand sessions back (``Request.return_state``); a
    ``FaultPlan`` injects pool famine, forced eviction, slot failure and
    decode straggles, and ``step_time_ms`` runs the deadline clock;
  * **paged** engines (``paged=True``) keep KV in a block pool and
    recurrent state in pooled state rows (``serving/cache_manager.py``),
    read through per-session block tables and row ids: growth appends
    blocks, fan-out shares a prefix copy-on-write and copies the rows, and
    decode reads the pool in place through the block-table kernel
    (``attn_decode_impl="kernel"``, the default) or through the gathered
    monolithic view (``"gather"``, the oracle).  ``cache_quant`` stores the
    pool int8 or fp8 with per-row scales.

Prompt shapes are bucketed (left-padded to the next power of two; spans of
a continuation right-padded); bucket columns get negative positions, which
prefill treats as inert.  PAD=0 columns inside the caller's array are real
tokens at real positions, as in the reference.

The engine runs on CUDA unless the caller passes ``device="cpu"``; with
``device=None`` and no card it raises instead of running on the CPU.

**Meshes.**  ``mesh`` (a ``launch.mesh.serving_mesh`` (data, model)
``DeviceMesh``) serves a dense attention model SPMD, one engine per rank:
``transformer.shard_params`` places the weights as
``sharding.SERVE_RULES`` does (heads, KV heads, d_ff and the vocabulary
over 'model', the rest replicated), and the model sums its row-parallel
products over 'model' (``distributed/sharding.py``).  Where the KV heads
cannot go over 'model', they stay whole on every rank and a monolithic
cache cuts its slots over it where their count divides them, as the
reference's ``act_kv_seq`` does: the ranks attend their own slots and
merge (``models/attention.py``).  Where the vocabulary is cut, a
dispatch keeps the logits cut: the greedy and sampled tokens and the
probe (row 3's partials mode) are merged over 'model' each step, and the
logits, a session's ``last`` and a checkpoint's are gathered once, at the
end of the dispatch.  A batch of B is split over 'data' when the data axes
divide B and replicated otherwise (``serve()``'s batch-1 admissions
replicate); tokens, logits, the probe terms and a session's ``pos`` /
``cur`` / ``last`` are gathered, so every rank and the caller see the
whole result, while a ``SessionState``'s cache holds the rank's own rows
and slots (``state_select`` gathers the rows it picks and re-splits
them).  A paged
engine on a mesh keeps a pool of its own on every rank: its share of the
blocks and state rows over the batch axes and its own KV heads, the rows
it computes in it (``serving/cache_manager.py``; its data ranks agree on
every pool decision, so they raise, defer and evict together); a selected
row that changes data rank is copied over (``_move_rows``).
``weight_quant`` quantizes the whole model, then cuts payload and scales
(``quant.quantize_param_axes``).  Every decoder family serves so: the
RG-LRU's width and the SSD's heads (``ssm_inner``) and the MoE's experts
go over 'model' as well (``models/rglru.py``, ``models/ssm.py``,
``models/moe.py``), a rank's recurrent state and pooled state rows hold
its own width or heads, and a session's whole view joins them back.
Session checkpoints gather the whole view and restore onto any layout.
On the (1, 1) mesh no collective is issued and the engine is the
single-device one, CUDA graphs included; on a mesh of more than one rank
it runs the eager route (``counters["mesh_eager"]`` counts those
dispatches).  Still refused on a mesh, with ``NotImplementedError``: graph
capture over more than one rank.  The engine places its weights by
``SERVE_RULES``; training on a mesh takes ``shard_params`` under the
training rules (``training/train.py``), which refuse the head counts only
the sequence-sharded cache serves.
``weight_quant`` (``"int8"`` / ``"fp8"``, monolithic or paged) serves from
``quant.quantize_params``'s copy of the model: the attention, MLP and
expert matmul weights and an untied head stored per-row quantized and
dequantized at each matmul, the caller's model untouched.  An encoder config
(``causal=False``, hubert) has no decode step and is refused when the engine
is built; a config with a ``frontend`` (llava-next) serves its token
backbone, as the reference's engine does.

``checkpoint_session`` / ``restore_session`` persist a session through
``training/checkpoint.py`` in its slot-linear monolithic view, so a chat
survives an engine restart and moves between paged and monolithic
engines, one device and any mesh, in either direction.

Unlike JAX's immutable arrays, the port's caches and pools are written in
place: a monolithic ``SessionState`` is single use (extending it writes its
cache), and ``state_select`` on a monolithic engine copies the rows it
selects; on a paged engine it is a refcounted table copy, and the first
write COW-copies any shared block in its range.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import uncertainty as U
from repro_torch.core.uncertainty import UncertaintyConfig
from repro_torch.distributed import sharding as sh
from repro_torch.models import quant as Q
from repro_torch.models import transformer as T
from repro_torch.models.common import (ModelConfig, resolve_device,
                                       use_f32_accumulation)
from repro_torch.serving.cache_manager import (CachePool,
                                               EvictedSessionError,
                                               PagedHandle,
                                               QuantMismatchError)
from repro_torch.serving import graphs
from repro_torch.serving.faults import PoolExhaustedError
from repro_torch.serving.scheduler import ContinuousBatcher, Request
from repro_torch.training import checkpoint as ck

PAD = 0


def bucket_len(s: int, granularity: int = 512, floor: int = 8) -> int:
    """Shape bucket for prompt lengths: next power of two up to
    ``granularity``, then multiples of ``2 * granularity``."""
    if s <= floor:
        return floor
    if s <= granularity:
        return 1 << (s - 1).bit_length()
    g2 = 2 * granularity
    return -(-s // g2) * g2


@dataclasses.dataclass
class SessionState:
    """Warm cache handle: everything needed to continue a generation.

    Returned by ``generate(..., return_state=True)``, by ``absorb`` and by
    ``serve()`` for requests with ``return_state=True``; accepted back by
    ``generate(..., state=...)`` and by warm ``serve()`` requests
    (``Request.state``).  The handle is engine-specific and SINGLE USE: the
    cache is written in place, so extending a state overwrites it.  Fork
    with ``state_select`` / ``fanout`` before extending if both timelines
    are needed.

    * ``cache`` — one ``KVCache`` (or recurrent state) per layer,
      populated through position ``pos - 1``; on a paged engine a
      ``PagedHandle`` (block tables and state rows in the engine's pool,
      valid until ``engine.release`` or TTL eviction);
    * ``pos`` (B,) int32 — next absolute write position per row;
    * ``cur`` (B,) int32 — the last sampled token, not yet absorbed or
      emitted: an extension resumes from it bitwise;
    * ``last`` (B, V) f32 — ``cur``'s logits;
    * ``max_len`` — cache length (slots; a paged handle's logical
      capacity, which keeps paged dispatch shapes equal to the monolithic
      ones after the pool trims the tables); ``offset`` — host-side upper
      bound of ``pos``, which sizes growth without a device sync;
    * ``gen`` — the sampling generator the decode loop drew from (None for
      greedy), so a sampled extension continues the same stream;
    * ``exact`` — False when ``serve()`` captured the handle off a slot
      that decoded past the request's stop token: the KV up to ``pos`` is
      exact but ``cur``/``last`` are not, so only a continuation prefill may
      use it.
    """
    cache: Any
    pos: torch.Tensor
    cur: torch.Tensor
    last: torch.Tensor
    max_len: int
    offset: int
    gen: torch.Generator | None = None
    exact: bool = True

    @property
    def batch(self) -> int:
        return int(self.pos.shape[0])


def _fork(gen: torch.Generator | None) -> torch.Generator | None:
    """An independent generator at ``gen``'s state (JAX keys are values)."""
    if gen is None:
        return None
    out = torch.Generator(device=gen.device)
    out.set_state(gen.get_state())
    return out


class _RankDraw(NamedTuple):
    """A sampled stream on a mesh whose batch axes split its batch: every
    rank draws the noise of the whole ``batch`` from ``gen`` and keeps its
    own rows (``InferenceEngine._next``), so a seed gives the stream one
    device gives, on any layout."""
    gen: torch.Generator
    batch: int


class _KVHeads(NamedTuple):
    """The KV heads a rank's attention holds: ``count`` from ``start``, and
    where 'model' cuts them, each model shard's first head (``starts``)
    and the axes of the cut."""
    start: int
    count: int
    starts: tuple = ()
    axes: tuple = ()


def _cache_tree(cache: list) -> dict:
    """A per-layer cache list as the checkpoint's nested dict {layer:
    {field: tensor}}, sharing the tensors (restore fills them in place)."""
    return {str(i): dict(zip(c._fields, c)) for i, c in enumerate(cache)}


@dataclasses.dataclass
class InferenceEngine:
    """One swarm member: a model + its two-phase serving runtime.

    ``params`` is the port's ``Transformer`` (from ``init_params`` or
    ``convert.from_jax_params``); it is moved to ``device``.  On a CUDA
    device, building an engine sets torch's process-wide matmul precision
    flags (``models.common.use_f32_accumulation``).

    ``paged=True`` keeps the KV cache in a block pool of ``pool_blocks``
    blocks of ``block_len`` slots (default: 16 full-length sessions) and
    ``pool_rows`` state rows (default: as many as the blocks hold
    full-length sessions, at least 16; every session row takes one, as in
    the reference);
    ``attn_decode_impl`` picks its decode: ``"kernel"`` (None resolves to
    it) reads the pool in place through the block-table kernel,
    ``"gather"`` gathers the monolithic view and runs the monolithic decode
    (the oracle: bitwise the monolithic engine).  ``cache_quant``
    (``"int8"`` / ``"fp8"``, paged only) stores the pool quantized with
    per-row f32 scales.  ``weight_quant`` (``"int8"`` / ``"fp8"``) serves
    from a copy of ``params`` whose matmul weights are ``quant.QTensor``s
    (``quant.quantize_params``, after the move to ``device``); ``params``
    itself is not changed.  ``mesh``: serving on a mesh (module
    docstring); ``comm`` then counts the mesh's collectives."""
    name: str
    cfg: ModelConfig
    params: Any
    ucfg: UncertaintyConfig = dataclasses.field(
        default_factory=UncertaintyConfig)
    max_len: int = 128
    device: Any = None
    paged: bool = False
    mesh: Any = None
    block_len: int = 64
    pool_blocks: int | None = None
    pool_rows: int | None = None
    attn_decode_impl: str | None = None
    cache_quant: str | None = None
    weight_quant: str | None = None

    def __post_init__(self):
        if self.mesh is not None:
            # what the mesh path does not serve yet raises: ``_no_capture``
            # a captured dispatch over more than one rank
            sh.check_mesh(self.mesh)
        if not self.cfg.causal:
            raise NotImplementedError(
                f"{self.cfg.name}: an encoder-only config (causal=False) has "
                "no decode step; run transformer.forward or train it "
                "instead of serving it")
        self.device = resolve_device(self.device, "InferenceEngine")
        if self.device.type == "cuda":
            use_f32_accumulation()
        # whole generations and decode dispatches: one CUDA-graph replay
        # each on the card (``_generate_fused``, ``_dispatch``); None runs
        # the same bodies eagerly, the oracle
        self._graphs = (graphs.DecodeGraphs(graphs.CudaGraphs(self.device))
                        if self.device.type == "cuda" else None)
        # a mesh of more than one rank runs the eager route: gloo cannot be
        # captured, and a multi-card NCCL capture is unchecked
        self._multi_rank = (self.mesh is not None and math.prod(
            sh.axis_sizes(self.mesh).values()) > 1)
        if self._multi_rank:
            self._graphs = None
        # host-side dispatch accounting: cold prefills, warm continuation
        # prefills and decode-only resumes (the gateway tests assert the
        # swarm round adds no probe prefill), whole-cache growth copies
        # (always 0 when paged), the failure-domain counters the gateway
        # reads (``famine_deferred`` counts injected famine, as in the
        # reference), and the queued requests a paged serve() round left
        # waiting for blocks (``backpressure_deferred``, the port's own)
        self.counters = {"prefill": 0, "prefill_continue": 0,
                         "decode_only": 0, "grow_copy": 0,
                         "famine_deferred": 0, "shed": 0, "expired": 0,
                         "requeued": 0, "reprefill_cold": 0,
                         "backpressure_deferred": 0, "mesh_eager": 0,
                         "rows_moved": 0, "blocks_moved": 0}
        # ``_mcfg``: the config the model computes with, a rank's own heads
        # and d_ff on a mesh (``transformer.shard_params``); ``comm`` runs
        # the mesh's collectives and counts them
        self._mcfg, self.comm = self.cfg, None
        Q.check_quant(self.weight_quant)
        # the data shard this rank holds of a split batch, and how many
        self._dshard, self._dshards = 0, 1
        if self.mesh is not None:
            self.comm = sh.Comm(self.mesh)
            self._dshard, self._dshards = sh.shard_index(
                sh.batch_axes(self.mesh), self.mesh)
            params = self.params
            if self.weight_quant is not None:
                # the whole model first: each rank's payload and scales are
                # then the slices of the full quantized tree (scales taken
                # over a rank's own columns would not be)
                params = Q.quantize_params(params, self.weight_quant)
            self.params = T.shard_params(params, self.cfg, self.mesh,
                                         comm=self.comm)
            self._mcfg = self.params.cfg
        # the vocabulary's cut over 'model' (a dispatch keeps its logits
        # cut), and the cut of a monolithic cache's slots (a paged pool
        # has no sequence axis: its views are whole)
        self._vocab = getattr(self.params, "tp", None)
        self._kv_seq = next((layer.mixer.seq for layer in self.params.layers
                             if hasattr(layer.mixer, "seq")), None)
        if self._kv_seq is not None and self.paged:
            self._mcfg = dataclasses.replace(self._mcfg, kv_seq_shards=1)
            self._kv_seq = None
        self.params = self.params.to(self.device)
        if self.weight_quant is not None and self.mesh is None:
            self.params = Q.quantize_params(self.params, self.weight_quant)
        self._kv_heads = self._kv_placement()
        # a recurrent state type's cut over 'model' (RG-LRU width, SSD
        # heads): a session's whole view gathers it, a restore cuts it
        self._state_cut = {}
        for layer, (mixer, _) in zip(self.params.layers,
                                     self.cfg.layer_plan()):
            tp = getattr(layer.mixer, "tp", None)
            if mixer in ("rglru", "ssd") and tp is not None:
                kind = (T.rglru.RGLRUState if mixer == "rglru"
                        else T.ssm.SSMState)
                self._state_cut[kind] = (tp.axes, tp.index, T.state_columns(
                    self.cfg, mixer, tp.shards))
        self._recurrent = any(m in ("rglru", "ssd")
                              for m, _ in self.cfg.layer_plan())
        kvb = self.cfg.attn_kv_block
        if self.max_len > kvb and self.max_len % kvb:
            self.max_len = -(-self.max_len // kvb) * kvb
        Q.check_quant(self.cache_quant)
        if self.cache_quant is not None and not self.paged:
            raise ValueError(
                "cache_quant requires paged=True: quantization is per pool "
                "block (scales ride the block pool); the monolithic cache "
                "stays in the model dtype")
        self.pool = None
        if not self.paged:
            return
        L = self.block_len
        if self.max_len % L:
            self.max_len = self._round_len(self.max_len)
        if (self.cfg.window is not None and self.cfg.window % L
                and any(m == "attn_local" for m, _ in self.cfg.layer_plan())):
            raise ValueError(
                f"paged cache: block_len={L} must divide the local-attention "
                f"window {self.cfg.window} (the ring view is assembled from "
                "whole blocks)")
        if self.attn_decode_impl is None:
            self.attn_decode_impl = "kernel"
        if self.attn_decode_impl not in ("kernel", "gather"):
            raise ValueError(f"attn_decode_impl must be 'kernel' or "
                             f"'gather', got {self.attn_decode_impl!r}")
        n_blocks = self.pool_blocks or max(64, 16 * self.max_len // L)
        n_rows = self.pool_rows or max(16, n_blocks * L // self.max_len)
        axes = ()
        if self.mesh is not None:
            # the rank's pool: its share of the blocks and rows over the
            # batch axes (act_pool), its own KV heads (``_mcfg``)
            n_blocks = sh.pool_share(n_blocks, self.mesh)
            n_rows = sh.pool_share(n_rows, self.mesh)
            axes = sh.batch_axes(self.mesh)
        self.pool = CachePool(self._mcfg, L, n_blocks, n_rows,
                              cache_quant=self.cache_quant,
                              device=self.device, comm=self.comm, axes=axes)

    def _no_capture(self) -> None:
        """A mesh of more than one rank runs the eager route: a graph
        handed to it raises (gloo cannot be captured, and a multi-card NCCL
        capture is unchecked)."""
        if self._graphs is not None and self._multi_rank:
            raise NotImplementedError(
                "graph capture over more than one rank is not ported: a mesh "
                "of more than one rank runs the eager route")

    def _kv_placement(self) -> "_KVHeads":
        """The KV heads this rank's attention holds: case (a) of
        ``shard_params`` a slice, case (b) the one head its query heads
        read; case (s) (its cache's slots cut instead), a (1, 1) mesh and
        one device all of them."""
        K, K_l = self.cfg.num_kv_heads, self._mcfg.num_kv_heads
        if K_l == K:
            return _KVHeads(0, K)
        tp = next(layer.mixer.tp for layer, (mixer, _) in zip(
            self.params.layers, self.cfg.layer_plan())
            if mixer in T.ATTN and hasattr(layer.mixer, "tp"))
        H = self.cfg.num_heads
        m = math.prod(self.comm.sizes[a] for a in tp.axes)
        starts = tuple(r * tp.size * K // H for r in range(m))
        return _KVHeads(tp.start * K // H, K_l, starts, tp.axes)

    def weight_bytes(self) -> int:
        """Bytes the served model's weights hold on the device: parameters
        and buffers (a ``QTensor``'s payload and scales), each once."""
        return sum(t.nbytes for t in {id(t): t for t in [
            *self.params.parameters(), *self.params.buffers()]}.values())

    # ------------------------------------------------------------------
    def _round_len(self, need: int) -> int:
        """Bucket a cache length: multiples of 64, and of ``attn_kv_block``
        once the cache outgrows one KV chunk; a paged engine rounds to the
        lcm with ``block_len`` so its tables stay whole blocks (the default
        64 leaves the lengths, and the numbers, those of the monolithic
        engine)."""
        g = math.lcm(64, self.block_len) if self.paged else 64
        n = -(-need // g) * g
        kvb = self.cfg.attn_kv_block
        if n > kvb:
            gk = math.lcm(kvb, self.block_len) if self.paged else kvb
            n = -(-n // gk) * gk
        return n

    def _cache_len(self, s_bucket: int, max_new: int) -> int:
        need = s_bucket + max_new
        if need <= self.max_len:
            return self.max_len
        return self._round_len(need)

    def _grown_cache(self, state: SessionState, need: int):
        """(cache, max_len) with at least ``need`` slots: the session's own
        cache, or a longer copy of it (new slots empty) counted in
        ``counters["grow_copy"]``.  Paged sessions grow by
        ``_paged_grown`` instead."""
        if need <= state.max_len:
            return state.cache, state.max_len
        new_len = self._round_len(need)
        self.counters["grow_copy"] += 1
        rows = len(range(state.batch)[self._rows(state.batch)])
        if self._kv_seq is None:
            return (T.grow_cache(self._mcfg, state.cache, rows, new_len,
                                 device=self.device), new_len)
        # a cut cache's slots move between ranks as it grows: grow the
        # whole view and cut it again
        whole = T.grow_cache(
            dataclasses.replace(self._mcfg, kv_seq_shards=1),
            [self._seq_whole(c) for c in state.cache], rows, new_len,
            device=self.device)
        return [self._seq_mine(c) for c in whole], new_len

    def _bucket(self, prompts: np.ndarray) -> tuple[np.ndarray, int]:
        B, S = prompts.shape
        gran = max(self.cfg.attn_q_block, self.cfg.attn_kv_block)
        Sb = bucket_len(S, gran)
        if Sb == S:
            return prompts, S
        out = np.zeros((B, Sb), np.int32)
        out[:, Sb - S:] = prompts
        return out, S

    def _bucket_right(self, prompts: np.ndarray) -> tuple[np.ndarray, int]:
        """Bucket a continuation span RIGHT-padded, so no padding sits
        between the cached context and the new tokens."""
        B, S = prompts.shape
        gran = max(self.cfg.attn_q_block, self.cfg.attn_kv_block)
        Sb = bucket_len(S, gran)
        if Sb == S:
            return prompts, S
        out = np.zeros((B, Sb), np.int32)
        out[:, :S] = prompts
        return out, S

    def _tokens(self, prompts: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(prompts, dtype=torch.int32, device=self.device)

    def _span(self, prompts: np.ndarray, s_orig: int, device=None):
        """A bucketed span and its real length as int32 tensors (B, Sb) and
        (1,), on ``device`` (default: the engine's).  The length is data, not
        a shape: a captured dispatch stages it, so one graph serves every
        length of a bucket."""
        dev = self.device if device is None else device
        return (torch.as_tensor(prompts, dtype=torch.int32, device=dev),
                torch.tensor([s_orig], dtype=torch.int32, device=dev))

    def _full(self, B: int, value) -> torch.Tensor:
        return torch.full((B,), value, dtype=torch.int32, device=self.device)

    # ------------------------------------------------------------------
    # the batch over the mesh's 'data' axes
    # ------------------------------------------------------------------

    def _batch_part(self, B: int):
        """The spec entry of a batch of B over the mesh (``act_batch``):
        its batch axes when they divide B, else None (replicated)."""
        spec = sh.spec_for((B,), ("act_batch",), self.mesh,
                           sh.SERVE_RULES.act_rules)
        return spec[0] if spec else None

    def _rows(self, B: int) -> slice:
        """This rank's rows of a batch of B: its shard over the batch axes,
        or every row where the batch is replicated (as ``act_batch``'s chain
        falls back) and off a mesh."""
        if self.mesh is None:
            return slice(None)
        return sh.local_slices((B,), (self._batch_part(B),), self.mesh)[0]

    def _nrows(self, B: int) -> int:
        """How many rows of a batch of B this rank holds."""
        return len(range(B)[self._rows(B)])

    def _holders(self, B: int) -> list[range]:
        """The rows of a batch of B that each data shard holds, in shard
        order (shards over every batch axis, major to minor, as
        ``_dshard`` counts them): each shard's slice by the batch's spec
        (``_batch_part``), which may cut B over fewer batch axes than the
        mesh has (a ('pod', 'data') mesh falls back to 'data' where
        pod * data does not divide B) or none (every row on every
        shard)."""
        if self.mesh is None:
            return [range(B)]
        sizes, axes = sh.axis_sizes(self.mesh), sh.batch_axes(self.mesh)
        used = sh.axes_of(self._batch_part(B))
        b = B // math.prod(sizes[a] for a in used)
        out = []
        for o in range(self._dshards):
            coord, rest = {}, o
            for a in reversed(axes):
                rest, coord[a] = divmod(rest, sizes[a])
            idx = 0
            for a in used:
                idx = idx * sizes[a] + coord[a]
            out.append(range(idx * b, (idx + 1) * b))
        return out

    def _mine(self, x):
        """This rank's rows of ``x``, a batch along dim 0 that every rank
        holds whole."""
        return sh.constrain(x, ("act_batch",) + (None,) * (x.ndim - 1),
                            self.mesh, sh.SERVE_RULES)

    def _whole(self, xs, B: int):
        """The whole batch of per-rank tensors (this rank's rows of a batch
        of B each, or None): gathered over the batch axes in rank order, so
        every rank and the caller see every row."""
        if self.mesh is None:
            return xs
        part = self._batch_part(B)
        out = [None if x is None else self.comm.all_gather(x, part, 0)
               for x in xs]
        return type(xs)(*out) if hasattr(xs, "_fields") else type(xs)(out)

    def _slot_cache(self, cache: list, i: int, n: int) -> list:
        """Slot ``i`` of a ``serve()`` cache over ``n`` slots as a batch-1
        cache of its own that every rank holds (on a mesh whose batch axes
        split the slots, the owner's row, gathered)."""
        mine = range(n)[self._rows(n)]
        if len(mine) == n:
            return [type(c)(*(t[i:i + 1].clone() for t in c)) for c in cache]
        j = i - mine.start if i in mine else 0
        owner = i // len(mine)
        return [type(c)(*(t[owner:owner + 1] for t in self._whole(
            type(c)(*(t[j:j + 1] for t in c)), n))) for c in cache]

    # ------------------------------------------------------------------
    # prefill and decode bodies
    # ------------------------------------------------------------------

    def _prefill_into(self, tokens: torch.Tensor, s_orig: torch.Tensor,
                      cache):
        """Cold prefill of a bucketed, LEFT-padded span ``tokens`` (B, Sb)
        of ``s_orig`` (1,) real tokens into ``cache`` (a fresh monolithic
        cache, or the view of freshly reset pool blocks) -> (first greedy
        token (B,) int32, its logits (B, V) f32, cache).  No host sync."""
        B, S = tokens.shape
        # columns left of the caller's prompt get negative positions (inert)
        positions = (torch.arange(S, dtype=torch.int32, device=tokens.device)
                     - (S - s_orig)).expand(B, S)
        # the head runs on the last column only (a vocabulary-parallel
        # shard gathers that column's logits only)
        at = torch.arange(S - 1, S, device=tokens.device)
        logits, cache = T.prefill(self.params, self._mcfg, tokens, cache,
                                  positions, logits_at=at)
        # contiguous: in an f32 model ``.float()`` is the strided view,
        # and the uncertainty kernel takes contiguous rows
        last = logits[:, 0].float().contiguous()
        return self._argmax(last), last, cache

    def _prefill_absorb(self, tokens, s_orig, max_len: int):
        """Monolithic cold prefill into a fresh (B, max_len) cache; the span
        as tensors, or as a numpy array and an int."""
        if not isinstance(tokens, torch.Tensor):
            tokens, s_orig = self._span(tokens, s_orig)
        cache = T.init_cache(self._mcfg, tokens.shape[0], max_len,
                             device=tokens.device)
        return self._prefill_into(tokens, s_orig, cache)

    def _prefill_continue(self, tokens: torch.Tensor, s_orig: torch.Tensor,
                          start: torch.Tensor, cache):
        """Continuation prefill: absorb a RIGHT-padded span ``tokens`` (B,
        Sb) of ``s_orig`` (1,) real tokens into a filled cache at positions
        ``start`` (B,) onward -> (first greedy token, its logits, cache).
        The rows of ``start`` must agree (the caller checks:
        ``transformer.check_positions``); nothing here syncs the host."""
        B, S = tokens.shape
        col = torch.arange(S, dtype=torch.int32, device=tokens.device)[None]
        positions = torch.where(col < s_orig, start[:, None] + col, col - S)
        at = (s_orig - 1).long()
        logits, cache = T.prefill(self.params, self._mcfg, tokens, cache,
                                  positions.to(torch.int32),
                                  continuation=True, check=False,
                                  logits_at=at)
        last = logits[:, 0].float().contiguous()
        return self._argmax(last), last, cache

    # ------------------------------------------------------------------
    # logits whose vocabulary is cut over 'model' (``_vocab``)
    # ------------------------------------------------------------------

    def _cols(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's vocabulary columns of whole logits ``x`` (..., V);
        ``x`` itself where the vocabulary is whole."""
        v = self._vocab
        return x if v is None else x[..., v.start:v.start + v.size]

    def _vocab_whole(self, x):
        """Logits of this rank's vocabulary columns joined into whole rows
        (one all-gather over 'model'); ``x`` itself (or None) where the
        vocabulary is whole."""
        if x is None or self._vocab is None:
            return x
        return self._vocab.gather(x.contiguous(), -1)

    def _argmax(self, lg: torch.Tensor) -> torch.Tensor:
        """The greedy tokens of logits ``lg`` (B, V or the rank's columns),
        int32: ties to the lowest index of the whole row."""
        if self._vocab is None:
            return lg.argmax(-1).to(torch.int32)
        return sh.vocab_argmax(lg, self._vocab).to(torch.int32)

    def _next(self, lg: torch.Tensor, greedy: bool,
              gen: torch.Generator | None) -> torch.Tensor:
        if greedy:
            return self._argmax(lg)
        # torch.multinomial's one-sample draw (an exponential race over the
        # probabilities, the same numbers), without its validity check: a
        # host sync, which a captured dispatch cannot hold.  The noise of
        # the whole (B, V) batch is drawn on every rank (``_RankDraw``),
        # each keeping its rows and vocabulary columns
        v = self._vocab
        V = lg.shape[-1] if v is None else v.size * v.shards
        if isinstance(gen, _RankDraw):
            q = lg.new_empty((gen.batch, V)).exponential_(
                1, generator=gen.gen)[self._rows(gen.batch)]
        else:
            q = lg.new_empty((lg.shape[0], V)).exponential_(1, generator=gen)
        if v is None:
            return (torch.softmax(lg, dim=-1) / q).argmax(-1).to(torch.int32)
        # vocabulary-parallel: exp(lg - M) / q with M the whole row's max,
        # its argmax merged over 'model' (the softmax's sum, a positive
        # factor of the row, does not move it)
        M = v.comm.all_reduce(lg.amax(-1), v.axes, op="max")
        return self._argmax(torch.exp(lg - M[:, None]) / self._cols(q))

    def _decode(self, cur, last, pos, steps: int, greedy: bool, gen, step,
                with_logits: bool = True):
        """The eager decode loop: ``steps`` iterations; ``step(tokens
        (B,1), pos (B,), t)`` runs one model step and returns its logits
        (B,1,V).  cur (B,) token entering the span, last (B,V) its logits,
        pos (B,) its position; where the vocabulary is cut over 'model',
        every logits tensor here is the rank's columns (``_vocab``).  Emits
        the tokens (and logits) *entering* each step plus their Eq. 2-3
        terms; returns (tokens, logits | None, h, v, (cur, last, pos)), each
        (B, steps).  No host sync: a dispatch captures it whole
        (``_dispatch``)."""
        toks, lgs, hs, vs = [], [], [], []
        for t in range(steps):
            h, v = U.uncertainty_terms(last[:, None, :], cur[:, None],
                                       self.ucfg, vocab=self._vocab)
            lg = step(cur[:, None], pos, t)[:, -1].float()
            toks.append(cur)
            hs.append(h[:, 0])
            vs.append(v[:, 0])
            if with_logits:
                lgs.append(last)
            cur, last, pos = self._next(lg, greedy, gen), lg, pos + 1
        stack = (lambda xs: torch.stack(xs, dim=1))
        return (stack(toks), stack(lgs) if with_logits else None, stack(hs),
                stack(vs), (cur, last, pos))

    def _mono_body(self, cur, last, cache, pos, steps, greedy, gen,
                   with_logits=True):
        """Decode over a monolithic cache (or a gathered view), in place."""
        def step(tokens, index, t):
            return T.decode_step(self.params, self._mcfg, tokens, cache,
                                 index)[0]
        return self._decode(cur, last, pos, steps, greedy, gen, step,
                            with_logits)

    @property
    def _route(self) -> str:
        """The decode route of the engine's own caches."""
        return self.attn_decode_impl if self.paged else "mono"

    def _dispatch(self, route: str, cur, last, cache, pos, steps: int,
                  greedy: bool, gen, with_logits: bool = True):
        """One decode dispatch of ``steps`` tokens -> (tokens, logits |
        None, h, v, (cur, last, pos)), the port of one ``lax.scan`` call of
        the reference's ``_decode_scan`` family.  ``route``: ``"mono"``
        (``cache`` a per-layer list of ``KVCache`` and recurrent states,
        written in place), ``"kernel"`` or ``"gather"`` (``cache`` a paged
        dict; the pool written in place).

        On the card it is one replay of a captured graph
        (``serving/graphs.py``): the caller's cur/last/pos (and table and
        state rows) go through the graph's staging buffers, a monolithic
        cache (KV and states) through its arena, and the outputs come back
        as clones.  ``self._graphs`` None
        runs the eager loop: the CPU's route, and the card's oracle (a
        test sets it)."""
        body = _BODIES[route]
        gen = None if greedy else gen
        self._no_capture()
        if self._graphs is None:
            self.counters["mesh_eager"] += self._multi_rank
            return body(self, cur, last, cache, pos, steps, greedy, gen,
                        with_logits)
        inputs = {"cur": cur, "last": last, "pos": pos}
        io, fill = (), None
        if route == "mono":
            io, types = _flatten(cache)
            width = _width(cache)

            def run(staged, arena, g):
                return body(self, staged["cur"], staged["last"],
                            _unflatten(types, arena), staged["pos"], steps,
                            greedy, g, with_logits), None
        else:
            inputs["table"] = cache["table"]
            inputs["rows"] = cache["rows"]
            width = cache["table"].shape[1]
            # a capture writes the sink block and the sink row
            fill = {"table": self.pool.n_blocks, "rows": self.pool.n_rows}

            def run(staged, arena, g):
                c = T.paged_cache(self.pool.arrays, staged["table"],
                                  staged["rows"])
                return body(self, staged["cur"], staged["last"], c,
                            staged["pos"], steps, greedy, g,
                            with_logits), None
        key = (route, int(cur.shape[0]), width, steps, greedy, with_logits)
        return self._graphs.run(key, run, inputs, io, gen=gen,
                                fill=fill)[0]

    def _generator(self, greedy: bool, seed: int):
        if greedy:
            return None
        return torch.Generator(device=self.device).manual_seed(seed)

    def _draw(self, gen: torch.Generator | None, B: int):
        """``gen`` as a dispatch over a batch of B draws from it: a
        ``_RankDraw`` where the mesh's batch axes split B, else ``gen``."""
        if gen is None or len(range(B)[self._rows(B)]) == B:
            return gen
        return _RankDraw(gen, B)

    # ------------------------------------------------------------------
    # paged dispatches
    # ------------------------------------------------------------------

    def _paged_dev_cache(self, tables: np.ndarray, rows: np.ndarray) -> dict:
        """The paged cache of one dispatch: the engine's pools + this
        dispatch's tables and state rows, uploaded once."""
        def dev(a):
            return torch.as_tensor(np.asarray(a, np.int32),
                                   device=self.device)
        return T.paged_cache(self.pool.arrays, dev(tables), dev(rows))

    def _paged_grown(self, state: SessionState, need: int):
        """Extend a paged session's tables to the dispatch length (fresh
        reset blocks appended, shared blocks in the write range COW-copied)
        — never a whole-cache copy.  Returns (dispatch cache, max_len); the
        length follows the monolithic formula, so the shapes match."""
        handle = state.cache
        self.pool.check(handle)
        disp = (state.max_len if need <= state.max_len
                else self._round_len(need))
        tables = self.pool.extend(handle, disp // self.block_len,
                                  self._mine(state.pos).cpu().numpy())
        return self._paged_dev_cache(tables, handle.rows), disp

    def _prefill_into_paged(self, tokens, s_orig: torch.Tensor,
                            cache: dict):
        """Paged cold prefill: gather -> ``_prefill_into`` -> write blocks
        [0, s_orig) back."""
        B = tokens.shape[0]
        lin = T.paged_gather(self._mcfg, cache)
        cur, last, lin = self._prefill_into(tokens, s_orig, lin)
        T.paged_scatter_back(self._mcfg, cache, lin, self._full(B, 0),
                             s_orig.expand(B))
        return cur, last, cache

    def _prefill_continue_paged(self, tokens, s_orig: torch.Tensor,
                                start: torch.Tensor, cache: dict):
        """Paged continuation prefill: gather -> ``_prefill_continue`` ->
        write blocks [start, start + s_orig) back."""
        lin = T.paged_gather(self._mcfg, cache)
        cur, last, lin = self._prefill_continue(tokens, s_orig, start, lin)
        T.paged_scatter_back(self._mcfg, cache, lin, start, start + s_orig)
        return cur, last, cache

    def _kernel_body(self, cur, last, cache: dict, pos, steps: int,
                     greedy: bool, gen, with_logits: bool = True):
        """Kernel-first paged decode: every layer attends the pool in place
        through the block table (``transformer.paged_decode_step``) plus
        the dispatch's delta rows, allocated here (inside a capture: by
        every replay); the delta rows go into the pool once, at the end of
        the dispatch."""
        p0 = pos
        delta = T.paged_decode_carry(self._mcfg, cache, steps)

        def step(tokens, index, t):
            return T.paged_decode_step(self.params, self._mcfg, tokens, cache,
                                       delta, index, t, p0)[0]
        out = self._decode(cur, last, pos, steps, greedy, gen, step,
                           with_logits)
        T.paged_scatter_decode(self._mcfg, cache, delta, p0)
        return out

    def _gather_body(self, cur, last, cache: dict, pos, steps: int,
                     greedy: bool, gen, with_logits: bool = True):
        """Gather-path paged decode: gather the monolithic view, decode it
        and write blocks [pos, pos + steps) back."""
        lin = T.paged_gather(self._mcfg, cache)
        out = self._mono_body(cur, last, lin, pos, steps, greedy, gen,
                              with_logits)
        T.paged_scatter_back(self._mcfg, cache, lin, pos, pos + steps)
        return out

    # ------------------------------------------------------------------
    # whole generation in one dispatch
    # ------------------------------------------------------------------

    def _generate_body(self, route: str, tokens, s_orig, start, cache,
                       max_len: int, max_new: int, greedy: bool, gen):
        """Prefill + decode + the Eq. 4 combine: the body of one fused
        ``generate`` (the reference's ``_generate_fused`` with
        ``start=None``, else ``_generate_continue``; their ``_paged``
        siblings for ``route`` "kernel" and "gather").  tokens (B, Sb), the
        real length s_orig (1,) and start (B,) are device tensors, so
        nothing here syncs the host.  Returns ((tokens, logits, u, h_mean,
        v_mean, cur, last, pos), cache): the cache a cold monolithic
        generate made, else None.

        Cold monolithic: the cache is made here, as the reference makes it
        inside its trace; captured, it lives in the graph's memory pool.
        Cold paged: the session's blocks come unreset from the pool
        (``CachePool.alloc(reset="dispatch")``); the prefill runs on a
        fresh cache, the view of reset blocks, and writes the whole table
        back (its reset values past the span).  ``"kernel"`` writes the
        prefill back, then decodes in place through the block table;
        ``"gather"`` decodes the view and writes back the written range.
        Warm: the continuation prefill over the session's cache (paged:
        its gathered view)."""
        B = tokens.shape[0]
        cold = start is None
        if cold:
            start = torch.zeros((B,), dtype=torch.int32, device=tokens.device)
        pos = start + s_orig
        if route == "mono":
            if cold:
                cache = T.init_cache(self._mcfg, B, max_len,
                                     device=tokens.device)
                cur, last, cache = self._prefill_into(tokens, s_orig, cache)
            else:
                cur, last, cache = self._prefill_continue(tokens, s_orig,
                                                          start, cache)
            out = self._mono_body(cur, last, cache, pos, max_new, greedy,
                                  gen)
            return _combine(out, self.ucfg), (cache if cold else None)
        if cold:
            lin = T.init_cache(self._mcfg, B, max_len, device=tokens.device)
            cur, last, lin = self._prefill_into(tokens, s_orig, lin)
            end = torch.full((B,), max_len, dtype=torch.int32,
                             device=tokens.device)
        else:
            lin = T.paged_gather(self._mcfg, cache)
            cur, last, lin = self._prefill_continue(tokens, s_orig, start,
                                                    lin)
            end = pos if route == "kernel" else pos + max_new
        if route == "kernel":
            T.paged_scatter_back(self._mcfg, cache, lin, start, end)
            out = self._kernel_body(cur, last, cache, pos, max_new, greedy,
                                    gen)
        else:
            out = self._mono_body(cur, last, lin, pos, max_new, greedy, gen)
            T.paged_scatter_back(self._mcfg, cache, lin, start, end)
        return _combine(out, self.ucfg), None

    def _generate_fused(self, prompts: np.ndarray, s_orig: int, start,
                        cache, max_len: int, max_new: int, greedy: bool,
                        gen, keep_cache: bool = False):
        """One whole ``generate`` as one dispatch: cold with ``start`` None
        (``cache`` None on a monolithic engine), else a continuation from
        ``start`` (B,) over ``cache`` (a per-layer list, written in place)
        or a paged dict.  Returns ``_generate_body``'s pair; the cold
        monolithic cache only when ``keep_cache``.

        On the card it is one replay of the graph of its key (kind, route,
        B, bucket, cache length or table width, max_new, greedy and, cold
        monolithic, ``keep_cache``): the span, its length, the start and a
        paged table and state rows go through staging buffers, a warm
        monolithic cache through the graph's arena (copied in and out, as a
        decode dispatch's is); a cold monolithic cache is made inside the
        graph and copied out only when the caller keeps it, so a one-shot
        generate copies no cache.  ``self._graphs`` None runs the same body
        eagerly: the CPU's route and the card's oracle."""
        route = self._route
        B, Sb = prompts.shape
        gen = None if greedy else gen
        host = torch.device("cpu")
        tokens, s_len = self._span(prompts, s_orig, device=host)
        inputs = {"tokens": tokens, "s_orig": s_len}
        if start is not None:
            inputs["start"] = start
        io, types, fill = (), None, {"s_orig": 1}
        if route != "mono":
            inputs["table"], inputs["rows"] = cache["table"], cache["rows"]
            width = cache["table"].shape[1]
            # a Rerun capture runs the body: it writes the sinks
            fill.update(table=self.pool.n_blocks, rows=self.pool.n_rows)
        elif start is not None:
            io, types = _flatten(cache)
            width = _width(cache)
        else:
            width = max_len

        def run(staged, arena, g):
            if route != "mono":
                c = T.paged_cache(self.pool.arrays, staged["table"],
                                  staged["rows"])
            else:
                c = None if start is None else _unflatten(types, arena)
            out, made = self._generate_body(
                route, staged["tokens"], staged["s_orig"],
                staged.get("start"), c, max_len, max_new, greedy, g)
            return out, (made if keep_cache else None)

        self._no_capture()
        if self._graphs is None:
            self.counters["mesh_eager"] += self._multi_rank
            staged = {n: t.to(self.device) for n, t in inputs.items()}
            return run(staged, list(io), gen)
        kind = "cold" if start is None else "warm"
        key = ("generate", kind, route, B, Sb, width, max_new, greedy,
               keep_cache)
        return self._graphs.run(key, run, inputs, io, gen=gen, fill=fill,
                                extra=keep_cache)

    # ------------------------------------------------------------------
    # session handles
    # ------------------------------------------------------------------

    def release(self, state: SessionState) -> None:
        """Return a paged session's blocks to the pool and invalidate the
        handle (no-op for monolithic states)."""
        if self.paged and isinstance(state.cache, PagedHandle):
            self.pool.release(state.cache)

    def evict_idle_sessions(self, ttl_s: float) -> int:
        """TTL sweep over registered paged sessions (see CachePool)."""
        return self.pool.evict_idle(ttl_s) if self.paged else 0

    def fanout(self, state: SessionState, n: int) -> SessionState:
        """Fan a batch-1 session out to ``n`` rows sharing its prefix: on a
        paged engine a refcounted table copy (no prefill, no cache copy;
        the first write COW-copies the tail block), on a monolithic one a
        copy of the row ``n`` times."""
        if state.batch != 1:
            raise ValueError(f"fanout needs a batch-1 state, got "
                             f"{state.batch}")
        return self.state_select(state, np.zeros((n,), np.int32))

    # ------------------------------------------------------------------
    # session durability: checkpoint and restore through
    # training/checkpoint.py
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def checkpoint_session(self, state: SessionState, ckpt_dir: str, *,
                           step: int = 0, keep: int = 3) -> str:
        """Write a session to disk (``training/checkpoint.save``: an atomic
        publish) so a chat survives an engine restart.  Returns the path.

        The cache is saved in its slot-linear MONOLITHIC view (a paged
        session's blocks and state rows gathered and dequantized first by
        ``transformer.paged_gather``), so a checkpoint restores on a paged
        or a monolithic engine alike.  Global-attention KV and recurrent
        state rows round-trip bitwise; a local-attention ring that has
        wrapped is clamped to its window view.  ``pos``, ``cur``, ``last``,
        ``max_len``, ``offset``, ``exact``, the engine's ``cache_quant`` and
        the sampling generator's state go with it.

        On a mesh the file is the same: every rank gathers its rows over the
        batch axes and its KV heads and recurrent state columns over
        'model' (case (b)'s repeated heads and an SSD's shared B/C columns
        taken once: ``_entry_whole``), global rank 0 writes it, and every
        rank waits at a barrier after the publish; ``restore_session`` cuts
        the view onto any engine's layout (``launch.mesh.elastic_mesh``'s
        re-meshing)."""
        self._state_kind_check(state)
        if self.paged:
            h = state.cache
            cov_len = int(h.tables.shape[1]) * self.block_len
            cache = T.paged_gather(
                self._mcfg, self._paged_dev_cache(h.tables, h.rows))
        else:
            cov_len = int(state.max_len)
            cache = state.cache
        if self.mesh is not None:
            cache = [self._entry_whole(self._whole(c, state.batch))
                     for c in cache]
        tree = {"cache": _cache_tree(cache), "pos": state.pos,
                "cur": state.cur, "last": state.last}
        if state.gen is not None:
            tree["gen"] = state.gen.get_state()
        extra = {"kind": "session", "batch": state.batch,
                 "max_len": int(state.max_len), "offset": int(state.offset),
                 "cov_len": cov_len, "exact": bool(state.exact),
                 "has_gen": state.gen is not None,
                 # the saved view is dequantized, but a quantized session's
                 # numbers are budgeted, not bitwise: restore refuses
                 # another representation (QuantMismatchError)
                 "cache_quant": self.cache_quant}
        if self.mesh is None:
            return ck.save(ckpt_dir, step, tree, extra=extra, keep=keep)
        if dist.get_rank() == 0:
            ck.save(ckpt_dir, step, tree, extra=extra, keep=keep)
        self.comm.barrier()
        return ck.step_path(ckpt_dir, step)

    def _cuts(self, c) -> tuple:
        """How the model axes cut a cache entry of this rank: ``(axes,
        this rank's shard, {field: (dim, each shard's columns of the
        whole)})`` — an attention entry's KV heads (case (a) or (b) of
        ``shard_params``), a recurrent entry's state (``transformer.
        state_columns``) — or None where nothing is cut."""
        if isinstance(c, T.attention.KVCache):
            kv = self._kv_heads
            if not kv.starts:
                return None
            per = [list(range(a, a + kv.count)) for a in kv.starts]
            return kv.axes, kv.starts.index(kv.start), {"k": (2, per),
                                                        "v": (2, per)}
        return self._state_cut.get(type(c))

    def _entry_whole(self, c):
        """A cache entry of the rank's KV heads or state columns as one of
        the whole model's: gathered over the axes they are cut over, each
        head or column once (``sharding.gather_cols``).  An uncut entry as
        it is."""
        cut = self._cuts(c)
        if cut is None:
            return self._seq_whole(c)
        axes, _, fields = cut
        return c._replace(**{f: sh.gather_cols(self.comm, getattr(c, f),
                                               axes, d, per)
                             for f, (d, per) in fields.items()})

    def _entry_mine(self, c):
        """This rank's rows, and KV heads or state columns, of a whole
        cache entry."""
        B = c[0].shape[0]
        c = type(c)(*(t[self._rows(B)] for t in c))
        cut = self._cuts(c)
        if cut is not None:
            _, r, fields = cut
            c = c._replace(**{f: sh.take_cols(getattr(c, f), d, per[r])
                              for f, (d, per) in fields.items()})
        c = self._seq_mine(c)
        return type(c)(*(t.contiguous() for t in c))

    def _seq_whole(self, c):
        """A ``SeqKVCache`` entry's whole cache: its slots gathered over
        the model axes in rank order (``attention.SeqKVCache``); any other
        entry as it is."""
        if not isinstance(c, T.attention.SeqKVCache):
            return c
        return T.attention.KVCache(*(self.comm.all_gather(
            t, self._kv_seq.axes, 1) for t in c))

    def _seq_mine(self, c):
        """A whole KV cache entry as this rank holds it where its layer
        cuts the slots (``attention.init_kv_cache``): its run of them where
        the model axes divide their count; any other entry as it is."""
        seq = self._kv_seq
        if seq is None or type(c) is not T.attention.KVCache \
                or c.k.shape[1] % seq.shards:
            return c
        n = c.k.shape[1] // seq.shards
        return T.attention.SeqKVCache(*(
            t[:, seq.index * n:(seq.index + 1) * n] for t in c))

    @torch.inference_mode()
    def restore_session(self, ckpt_dir: str,
                        step: int | None = None) -> SessionState:
        """A checkpointed session rebuilt on THIS engine (the latest
        checkpoint when ``step`` is None).  A paged engine scatters the
        saved linear view into freshly allocated blocks and state rows
        (``transformer.paged_scatter_back``) and registers the handle; a
        monolithic one adopts the view as its cache.  The resumed chat
        continues bitwise where the round trip is exact
        (``checkpoint_session``).  Raises ``FileNotFoundError`` without a
        checkpoint, ``ValueError`` for one that is not a session's and
        ``QuantMismatchError`` for another cache representation.  On a
        mesh every rank reads the file and keeps its rows, KV heads and state
        columns (``_entry_mine``), on whatever layout the session was saved
        from."""
        if step is None:
            step = ck.latest_step(ckpt_dir)
            if step is None:
                raise FileNotFoundError(f"no session checkpoint in "
                                        f"{ckpt_dir!r}")
        extra = ck.read_extra(ckpt_dir, step)
        if extra.get("kind") != "session":
            raise ValueError(f"checkpoint at {ckpt_dir!r} step {step} is "
                             "not a session checkpoint")
        saved_q = extra.get("cache_quant")
        if saved_q != self.cache_quant:
            raise QuantMismatchError(
                f"session checkpoint at {ckpt_dir!r} step {step} was saved "
                f"from a cache_quant={saved_q!r} engine but this engine is "
                f"cache_quant={self.cache_quant!r}"
                + ("" if self.paged else " (monolithic)")
                + "; restoring would silently change the session's numeric "
                "precision: restore on a matching engine or re-absorb the "
                "conversation")
        B, cov_len = int(extra["batch"]), int(extra["cov_len"])
        if self.paged and cov_len % self.block_len:
            raise ValueError(f"a {cov_len}-slot session does not fill whole "
                             f"blocks of {self.block_len}")
        cache = T.init_cache(self.cfg, B, cov_len, device=self.device)
        like = {"cache": _cache_tree(cache),
                "pos": self._full(B, 0), "cur": self._full(B, 0),
                "last": torch.zeros((B, self.cfg.vocab_size),
                                    dtype=torch.float32, device=self.device)}
        gen = None
        if extra["has_gen"]:
            gen = torch.Generator(device=self.device)
            like["gen"] = gen.get_state()
        tree, _ = ck.restore(ckpt_dir, step, like)
        if gen is not None:
            gen.set_state(tree["gen"])
        max_len = int(extra["max_len"])
        if not self.paged and max_len > cov_len:
            # a monolithic cache is as long as its max_len: a paged-saved
            # session arrives trimmed to the blocks it covers and grows back
            # to its max_len (empty slots), so its dispatches keep the
            # source's shapes (on the card another length tiles the decode
            # kernel's keys otherwise, and the sums differ in their last
            # bits)
            cache = T.grow_cache(self.cfg, cache, B, max_len,
                                 device=self.device)
        if self.mesh is not None:
            cache = [self._entry_mine(c) for c in cache]
        if self.paged:
            n = self._nrows(B)
            handle = self.pool.alloc(n, cov_len // self.block_len)
            T.paged_scatter_back(
                self._mcfg, self._paged_dev_cache(handle.tables, handle.rows),
                cache, self._full(n, 0), self._full(n, cov_len))
            cache = handle
        return SessionState(cache, tree["pos"], tree["cur"], tree["last"],
                            max_len, int(extra["offset"]), gen,
                            bool(extra["exact"]))

    def _state_kind_check(self, state: SessionState):
        """A paged engine takes only PagedHandle states and a monolithic
        one only cache lists; a paged handle must still be registered
        (released / evicted ones raise ``EvictedSessionError``)."""
        got = isinstance(state.cache, PagedHandle)
        if got != self.paged:
            raise ValueError(
                f"session state is {'paged' if got else 'monolithic'} but "
                f"this engine is {'paged' if self.paged else 'monolithic'}")
        if self.paged:
            self.pool.check(state.cache)

    def _check_state(self, state: SessionState, *, extension: bool):
        """An inexact handle (captured past a stop token) supports only a
        continuation prefill on an attention-only model: its pending token
        is not the session's, and a recurrent state has absorbed the steps
        past the stop."""
        self._state_kind_check(state)
        if state.exact:
            return
        if extension or self._recurrent:
            raise ValueError(
                "inexact session state (captured after a mid-chunk stop "
                "retirement in serve()): "
                + ("pure decode extension needs the pending token"
                   if extension else
                   "recurrent-mixer state absorbed post-stop steps")
                + "; continue it with a prompt on an attention-only model "
                  "instead")

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def generate(self, prompts: np.ndarray | None, max_new: int, *,
                 greedy: bool = True, seed: int = 0,
                 state: SessionState | None = None,
                 return_state: bool = False) -> dict:
        """prompts (B, S) int32, LEFT-padded with PAD=0.  Prefill + a decode
        loop with the probe inside it.  Returns ``{"tokens": (B, max_new)
        int32, "u": (B,) Eq. 4 difficulty, "logits": (B, max_new, V) f32
        tensor on the engine's device, "h_mean"/"v_mean": (B,) raw Eq. 2-3
        means, "prompt_lengths": (B,)}``.  Sampling (``greedy=False``) draws
        from a ``torch.Generator`` seeded with ``seed``: other numbers than
        the JAX engine's for the same seed.

        ``return_state=True`` adds ``"state"``: a ``SessionState`` over the
        prompt and every emitted token.  ``state=<handle>`` continues it:
        ``prompts`` is the NEW span only, absorbed by one continuation
        prefill (greedy tokens those of a cold prefill of the
        concatenation, tie-aware); with ``prompts=None`` it is a decode-only
        extension, the tokens one longer generation would have emitted
        next.  Either writes the handle's cache in place."""
        if prompts is not None:
            prompts = np.asarray(prompts, np.int32)
        max_new, greedy = int(max_new), bool(greedy)
        if state is not None and (prompts is None or prompts.shape[1] == 0):
            self._check_state(state, extension=True)
            return self._extend(max_new, state, greedy, seed, return_state)
        if state is not None:
            self._check_state(state, extension=False)
        B = prompts.shape[0]
        gen = self._generator(greedy, seed)
        draw = self._draw(gen, B)
        if state is None:
            pb, s_orig = self._bucket(prompts)
            max_len = self._cache_len(pb.shape[1], max_new)
            self.counters["prefill"] += 1
            if self.paged:
                # the dispatch writes every block of the new session; on a
                # mesh the rank's rows, in its own pool
                cache = self.pool.alloc(self._nrows(B),
                                        max_len // self.block_len,
                                        reset="dispatch")
                out, _ = self._generate_fused(
                    self._mine(pb), s_orig, None,
                    self._paged_dev_cache(cache.tables, cache.rows),
                    max_len, max_new, greedy, draw)
            else:
                out, cache = self._generate_fused(
                    self._mine(pb), s_orig, None, None, max_len, max_new,
                    greedy, draw, keep_cache=return_state)
            offset = s_orig + max_new
        else:
            if state.batch != B:
                raise ValueError(f"state batch {state.batch} != prompt "
                                 f"batch {B}")
            # one position row serves the batch: checked on the host here,
            # outside the dispatch (a captured prefill cannot read it)
            T.check_positions(state.pos[:, None])
            pb, s_orig = self._bucket_right(prompts)
            need = state.offset + pb.shape[1] + max_new
            self.counters["prefill_continue"] += 1
            if self.paged:
                cache = state.cache
                dev, max_len = self._paged_grown(state, need)
            else:
                cache, max_len = self._grown_cache(state, need)
                dev = cache
            out, _ = self._generate_fused(
                self._mine(pb), s_orig, self._mine(state.pos), dev,
                max_len, max_new, greedy, draw)
            offset = state.offset + s_orig + max_new
        toks, lgs, u, h, v, cur, last, pos = self._whole(out, B)
        lgs, last = self._vocab_whole(lgs), self._vocab_whole(last)
        res = {"tokens": toks.cpu().numpy(), "u": u.cpu().numpy(),
               "logits": lgs, "h_mean": h.cpu().numpy(),
               "v_mean": v.cpu().numpy(),
               "prompt_lengths": (prompts != PAD).sum(axis=1)}
        if self.paged and not return_state and state is None:
            self.pool.release(cache)        # one-shot: blocks back now
        elif self.paged:
            self.pool.trim(cache, -(-offset // self.block_len))
        if return_state:
            res["state"] = SessionState(cache, pos, cur, last, max_len,
                                        offset, gen)
        return res

    def _result(self, toks, lgs, h_per, v_per, prompt_lengths) -> dict:
        h, v = h_per.mean(-1), v_per.mean(-1)
        return {"tokens": toks.cpu().numpy(),
                "u": U.combine_terms(h, v, self.ucfg).cpu().numpy(),
                "logits": lgs,
                "h_mean": h.cpu().numpy(), "v_mean": v.cpu().numpy(),
                "prompt_lengths": prompt_lengths}

    def _extend(self, max_new: int, state: SessionState, greedy: bool,
                seed: int, return_state: bool) -> dict:
        """Decode-only continuation from the session's pending token: the
        tokens a longer original generation would have emitted next
        (bitwise: the decode loop is the same sequence of steps, and the
        carried generator resumes a sampled stream)."""
        need = state.offset + max_new
        if self.paged:
            cache, max_len = self._paged_grown(state, need)
        else:
            cache, max_len = self._grown_cache(state, need)
        self.counters["decode_only"] += 1
        gen = state.gen if state.gen is not None else self._generator(
            greedy, seed)
        B = state.batch
        toks, lgs, h_per, v_per, (cur, last, pos) = self._dispatch(
            self._route, self._mine(state.cur),
            self._cols(self._mine(state.last)).contiguous(), cache,
            self._mine(state.pos), max_new, greedy, self._draw(gen, B))
        toks, lgs, h_per, v_per, cur, last, pos = self._whole(
            (toks, lgs, h_per, v_per, cur, last, pos), B)
        lgs, last = self._vocab_whole(lgs), self._vocab_whole(last)
        res = self._result(toks, lgs, h_per, v_per,
                           np.zeros((state.batch,), np.int64))
        offset = state.offset + max_new
        if self.paged:
            cache = state.cache
            self.pool.trim(cache, -(-offset // self.block_len))
        if return_state:
            res["state"] = SessionState(cache, pos, cur, last, max_len,
                                        offset, gen)
        return res

    @torch.inference_mode()
    def absorb(self, prompts: np.ndarray, *,
               state: SessionState | None = None) -> SessionState:
        """Prefill only: absorb a context into a fresh (or, with ``state``,
        a live) cache and return the session handle; no decode step runs.
        The handle's pending token is the prefill argmax, so
        ``generate(None, n, state=eng.absorb(p))`` emits the greedy tokens
        ``generate(p, n)`` would.  Cache a shared context once and fan
        generations out of it (``fanout``)."""
        prompts = np.asarray(prompts, np.int32)
        B = prompts.shape[0]
        if state is None:
            pb, s_orig = self._bucket(prompts)
            max_len = self._cache_len(pb.shape[1], 0)
            self.counters["prefill"] += 1
            tokens, s_len = self._span(self._mine(pb), s_orig)
            if self.paged:
                cache = self.pool.alloc(self._nrows(B),
                                        max_len // self.block_len)
                cur, last, _ = self._prefill_into_paged(
                    tokens, s_len,
                    self._paged_dev_cache(cache.tables, cache.rows))
            else:
                cur, last, cache = self._prefill_absorb(tokens, s_len,
                                                        max_len)
            pos, offset = self._full(B, s_orig), s_orig
        else:
            if state.batch != B:
                raise ValueError(f"state batch {state.batch} != prompt "
                                 f"batch {B}")
            self._state_kind_check(state)
            T.check_positions(state.pos[:, None])
            pb, s_orig = self._bucket_right(prompts)
            tokens, s_len = self._span(self._mine(pb), s_orig)
            need = state.offset + pb.shape[1]
            self.counters["prefill_continue"] += 1
            if self.paged:
                cache = state.cache
                dev, max_len = self._paged_grown(state, need)
                cur, last, _ = self._prefill_continue_paged(
                    tokens, s_len, self._mine(state.pos), dev)
            else:
                cache, max_len = self._grown_cache(state, need)
                cur, last, cache = self._prefill_continue(
                    tokens, s_len, self._mine(state.pos), cache)
            pos, offset = state.pos + s_orig, state.offset + s_orig
        if self.paged:
            self.pool.trim(cache, -(-offset // self.block_len))
        cur, last = self._whole((cur, last), B)
        return SessionState(cache, pos, cur, self._vocab_whole(last),
                            max_len, offset)

    @torch.inference_mode()
    def state_select(self, state: SessionState, idx) -> SessionState:
        """Rows ``idx`` of a session (repeated indices fan out).  The
        gateway hands the swarm round the probe's state for just the
        SWARM-routed queries this way.  Monolithic: a COPY of the rows, KV and
        recurrent states alike (the caches are written in place, so
        extending the selection must leave the source untouched).  Paged: a
        refcounted table copy and fresh copies of the state rows
        (``CachePool.fork``); the selection's first write COW-copies any
        shared block in its range, so the source's blocks and rows stay as
        they were.

        On a mesh a selected row that stays on its data rank keeps its
        refcounted table (no copy); one that moves to another data rank
        (the selection is split otherwise than the source, or replicated
        where the source was split) has its covered blocks and state row
        gathered over the batch axes and written into fresh blocks and a
        fresh row on its new rank (``_move_rows``, counted in
        ``counters["rows_moved"]`` / ``["blocks_moved"]``)."""
        idx_np = np.asarray(idx, np.int64).reshape(-1)
        idx = torch.as_tensor(idx_np, device=self.device)
        if self.paged:
            self._state_kind_check(state)
            cache = self._paged_select(state.cache, state.batch, idx_np)
        else:
            # on a mesh the rows it picks may sit on other ranks: gather the
            # whole batch, pick, and keep this rank's rows of the selection
            cache = [self._whole(c, state.batch) for c in state.cache]
            mine = self._mine(idx)
            cache = [type(c)(*(t.index_select(0, mine) for t in c))
                     for c in cache]
        return SessionState(cache, state.pos.index_select(0, idx),
                            state.cur.index_select(0, idx),
                            state.last.index_select(0, idx), state.max_len,
                            state.offset, _fork(state.gen), state.exact)

    def _paged_select(self, h: PagedHandle, B: int,
                      idx: np.ndarray) -> PagedHandle:
        """``state_select`` of a paged handle over a batch of B: the rows
        this rank holds of the selection.  A row it held already is forked
        off its own (shared blocks, a copied state row); a row moved in
        from another data rank (``_move_rows``) is its own fresh run (a
        repeat of it is forked off that run)."""
        n, me = len(idx), self._dshard
        src, dst = self._holders(B), self._holders(n)
        owner = {}                          # moved source row -> its shard
        for r in range(self._dshards):
            for s in {int(idx[g]) for g in dst[r]} - set(src[r]):
                owner[s] = next(o for o in range(self._dshards)
                                if s in src[o])
        nbc = h.tables.shape[1]
        moves = [(s, owner[s], nbc) for s in sorted(owner)]
        need = {int(idx[g]) for g in dst[me]} - set(src[me])
        self.pool.reserve(nbc * len(need), len(dst[me]))
        lo = src[me].start
        held = {s: (h.tables[s - lo], int(h.rows[s - lo]))
                for s in src[me] if s in owner}
        got = self._move_rows(moves, held, need) if moves else {}
        # a moved-in run is the selection's row as it is (its first time);
        # every other row is forked off its run (shared blocks, a copied
        # state row), as one device forks
        runs, fork = [], []
        for g in dst[me]:
            s = int(idx[g])
            if s in got and not any(r is got[s] for r in runs):
                runs.append(got[s])
            else:
                fork.append(len(runs))
                runs.append(got[s] if s in got else
                            (h.tables[s - lo], h.rows[s - lo]))
        tabs = np.stack([b for b, _ in runs]).astype(np.int32)
        rows = np.asarray([r for _, r in runs], np.int32)
        if fork:
            rows[fork] = self.pool.share_run(tabs[fork], rows[fork])
        return self.pool.register(tabs, rows)

    def _move_rows(self, moves: list, held: dict, need: set) -> dict:
        """Copy session rows between data ranks.  ``moves``: ``(key, owner
        data shard, covered blocks)`` of every moved row, the same list on
        every rank; ``held``: ``{key: (blocks, state row)}`` of the moved
        rows this rank owns; ``need``: the keys this rank receives (the
        caller reserved their blocks and rows).  Every rank gathers the
        moved rows' covered blocks (raw: a quantized block keeps its
        payload and scales) and state rows over the batch axes, one
        all-gather per pool tensor, and writes those it needs into fresh
        blocks and a fresh row.  Returns ``{key: (blocks, row)}``."""
        pool, d = self.pool, self._dshards
        by = [[m for m in moves if m[1] == o] for o in range(d)]
        c = max(len(x) for x in by)
        nbm = max(n for _, _, n in moves)
        blk = np.full((c, nbm), pool.n_blocks, np.int64)    # the sink
        row = np.full((c,), pool.n_rows, np.int64)
        for j, (k, _, n) in enumerate(by[self._dshard]):
            blk[j, :n] = held[k][0][:n]
            row[j] = held[k][1]
        bi = torch.as_tensor(blk.reshape(-1), device=self.device)
        ri = torch.as_tensor(row, device=self.device)
        got = {k: (pool.alloc_blocks(n, reset=False),
                   int(pool.alloc_rows(1, reset="dispatch")[0]))
               for k, _, n in moves if k in need}
        axes = sh.batch_axes(self.mesh)
        for layer in pool.arrays:
            kv = isinstance(layer, T.attention.KVPool)
            for t in layer:
                if t is None:
                    continue
                r = T.attention.raw(t)
                part = (r.index_select(0, bi).view(c, nbm, *r.shape[1:])
                        if kv else r.index_select(0, ri))
                every = self.comm.all_gather(part, axes, 0)
                for k, o, n in moves:
                    if k not in need:
                        continue
                    j = o * c + [m[0] for m in by[o]].index(k)
                    b, rw = got[k]
                    if kv:
                        r[torch.as_tensor(b, device=self.device).long()] = \
                            every[j, :n]
                    else:
                        r[rw] = every[j]
        self.counters["rows_moved"] += len(moves)
        self.counters["blocks_moved"] += sum(n for _, _, n in moves)
        return got

    @torch.inference_mode()
    def generate_stepwise(self, prompts: np.ndarray, max_new: int, *,
                          greedy: bool = True, seed: int = 0) -> dict:
        """One-token-at-a-time absorption (S + max_new decode steps) over a
        monolithic cache: the port's own oracle for ``generate``.  The
        cache length comes from the same bucket ``generate`` uses; only the
        real S columns are absorbed."""
        prompts = np.asarray(prompts, np.int32)
        B, S = prompts.shape
        pb, _ = self._bucket(prompts)
        cache = T.init_cache(self._mcfg, B, self._cache_len(pb.shape[1],
                                                          max_new),
                             device=self.device)
        gen = self._generator(greedy, seed)
        tok = self._tokens(prompts)

        def step(tokens, index, greedy):
            logits, _ = T.decode_step(self.params, self._mcfg, tokens, cache,
                                      self._full(B, index))
            lg = logits[:, -1].float()
            return self._next(lg, greedy, gen), lg

        for t in range(S):                   # absorption always runs greedy
            cur, last = step(tok[:, t:t + 1], t, True)
        toks, lgs = [], []
        for n in range(max_new):
            toks.append(cur)
            lgs.append(last)
            cur, last = step(cur[:, None], S + n, greedy)
        tokens = torch.stack(toks, dim=1)
        logits = self._vocab_whole(torch.stack(lgs, dim=1))
        u = U.difficulty(logits, tokens, self.ucfg)
        return {"tokens": tokens.cpu().numpy(), "u": u.cpu().numpy(),
                "logits": logits,
                "prompt_lengths": (prompts != PAD).sum(axis=1)}

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def serve(self, requests: Sequence[Request] | None = None, *,
              batcher: ContinuousBatcher | None = None, n_slots: int = 4,
              decode_chunk: int = 8, stop_token: int | None = None,
              greedy: bool = True, seed: int = 0,
              session_ttl_s: float | None = None, faults=None,
              overload: str = "raise",
              step_time_ms: float | None = None) -> list[dict]:
        """Streaming entry point: admit queued requests into free slots,
        decode one chunk over ALL slots, record tokens, retire finished
        slots (stop token or max_new), repeat until idle.  Returns
        ``{"rid", "tokens", "u"}`` per request in completion order (plus
        ``"state"`` for ``return_state`` requests and ``"shed": True`` for
        shed ones); with ``greedy=True`` the tokens are those ``generate``
        gives for the same prompt row.  Empty slots decode garbage that
        stays finite and touches no other slot.

        Admission: a cold request is one prefill into its slot; a warm one
        (``Request.state``) one continuation prefill of its new span over
        the session's cache, or with an empty prompt a pure decode resume.
        The decode chunk is clamped to a ``return_state`` request's
        remaining budget, so its handle is captured at its last step
        (``SessionState.exact``).

        Paged engines: slots read the pool through per-slot tables and
        state rows (empty slots hold sentinels, whose reads are skipped or
        clamped and whose writes land in the sinks); admission asks the pool
        for blocks and a row (requests that do not fit wait, counted per
        round in ``counters["backpressure_deferred"]``); a warm admission is
        a refcounted table copy off the handle plus a copy of its state
        row, so N queued requests carrying one absorbed handle fan out with
        no extra prefill; retirement, expiry, eviction and slot failure free
        the slot's blocks and its row once, and ``return_state`` is a table
        and row adoption trimmed to the covered length.  When nothing decodes and nothing fits,
        ``session_ttl_s`` evicts idle sessions (sparing handles still
        queued), then ``overload="shed"`` sheds the least urgent request or
        ``"raise"`` raises ``PoolExhaustedError``.  A warm request whose
        handle was evicted re-admits cold from ``Request.cold_prompt`` (or
        its prompt), counted in ``counters["reprefill_cold"]``.

        ``faults`` (a ``FaultPlan``), as in the reference: a "pool" famine
        defers one admission round (``counters["famine_deferred"]``, the
        queued requests); a "session" evict releases the next warm paged
        admission's handle, which then re-admits cold or retires shed; a
        "slot" fail frees the lowest active slot after a chunk and requeues
        its request (``counters["requeued"]``); a "decode" straggle adds its
        delay to the clock.  ``step_time_ms`` runs that clock: each chunk
        advances it by ``chunk * step_time_ms``, and requests past their
        ``deadline_ms`` retire shed (``counters["expired"]``).  All of it
        is host work between dispatches."""
        if overload not in ("raise", "shed"):
            raise ValueError(f"overload must be 'raise' or 'shed', got "
                             f"{overload!r}")
        if (requests is None) == (batcher is None):
            raise ValueError("pass exactly one of requests / batcher")
        if batcher is None:
            batcher = ContinuousBatcher(n_slots)
            for r in requests:
                batcher.submit(r)
        if any(s is not None for s in batcher.slots):
            raise ValueError("serve() requires an un-admitted batcher: "
                             "submit requests to the queue only")
        pending = list(batcher.queue)
        if not pending:
            return []
        n_slots = batcher.n_slots
        gran = max(self.cfg.attn_q_block, self.cfg.attn_kv_block)

        def need(r: Request) -> int:
            # warm requests need room for the session so far + the new span
            off = r.state.offset if r.state is not None else 0
            sb = bucket_len(len(r.prompt), gran) if r.prompt else 0
            n = self._cache_len(off + sb, r.max_new)
            if r.cold_prompt:
                # the slot must also fit the cold re-prefill fallback
                n = max(n, self._cache_len(
                    bucket_len(len(r.cold_prompt), gran), r.max_new))
            return max(n, r.state.max_len) if r.state is not None else n

        max_len = max(need(r) for r in pending)
        paged = self.paged
        dev = self.device
        cur = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
        # the slots' logits: this rank's vocabulary columns (``_vocab``)
        last = torch.zeros((n_slots, self.cfg.vocab_size if self._vocab is
                            None else self._vocab.size),
                           dtype=torch.float32, device=dev)
        pos = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
        # on a mesh whose batch axes divide n_slots, a data rank decodes
        # its own slots (``mine``, held in its cache or pool) and admits
        # into them alone; otherwise every rank holds every slot
        mine = range(n_slots)[self._rows(n_slots)]
        holders = self._holders(n_slots)
        if paged:
            nb = max_len // self.block_len
            # sentinel tables and rows: an empty slot's reads are skipped
            # or clamped and its writes land in the sinks
            slot_tables = np.full((len(mine), nb), self.pool.n_blocks,
                                  np.int32)
            slot_rows = np.full((len(mine),), self.pool.n_rows, np.int32)
            slot_run: list = [None] * n_slots   # the (blocks, row) it owns
            cache = None
        else:
            cache = T.init_cache(self._mcfg, len(mine), max_len, device=dev)
        gen = self._generator(greedy, seed)
        acc: dict[int, list] = {}           # rid -> [sum_h, sum_v, n]
        states: dict[int, SessionState] = {}
        pos0: dict[int, int] = {}           # slot -> position at admission
        results: list[dict] = []

        def drain():
            for req in batcher.drain_finished():
                h, v, n = acc.pop(req.rid, (0.0, 0.0, 0))
                d = max(n, 1)
                out = {"rid": req.rid,
                       "tokens": np.asarray(req.generated, np.int32),
                       "u": float(U.combine_terms(h / d, v / d, self.ucfg))}
                if req.shed:
                    out["shed"] = True
                if req.rid in states:
                    out["state"] = states.pop(req.rid)
                results.append(out)

        # per data rank: its pool's free blocks and rows (agreed once per
        # admission round) and the slots admit() promised it this round
        free = [None]
        promised = [None]

        def fund():
            free[0] = self.pool.free_counts()
            promised[0] = np.zeros((self._dshards,), np.int64)

        def fits(r: Request) -> bool:
            # a cold request needs a full run and a state row, a warm one at
            # most that, from the pool of every rank that holds the slot
            # admit() is filling (its lowest free one); every rank decides
            # alike from the agreed counts
            i = batcher.slots.index(None)
            own = [o for o in range(self._dshards) if i in holders[o]]
            p = promised[0]
            ok = all(free[0][o, 0] >= (p[o] + 1) * nb
                     and free[0][o, 1] >= p[o] + 1 for o in own)
            if ok:
                p[own] += 1
            return ok

        def free_slot(i: int):
            # free the blocks and the row a slot still owns and repoint it
            # at the sentinels: its garbage decode writes the sinks from now
            if paged and i in mine:
                if slot_run[i] is not None:
                    blocks, row = slot_run[i]
                    self.pool.free_blocks(blocks)
                    self.pool.free_rows(np.array([row]))
                    slot_run[i] = None
                slot_tables[i - mine.start, :] = self.pool.n_blocks
                slot_rows[i - mine.start] = self.pool.n_rows
            pos0.pop(i, None)

        now_ms = 0.0            # the deadline clock (step_time_ms)
        while not batcher.idle:
            if (faults is not None and batcher.queue
                    and faults.consume("pool") is not None):
                # injected famine: this admission round sees no free
                # block; the queue waits the round out while anything
                # active decodes, and with nothing active no chunk runs
                self.counters["famine_deferred"] += len(batcher.queue)
                admitted = []
                if not batcher.active():
                    continue
            else:
                if paged:
                    fund()
                admitted = batcher.admit(fits=fits if paged else None)
            if paged and not admitted and not batcher.active() \
                    and batcher.queue:
                # famine with nothing decoding: TTL-evict idle sessions
                # (sparing the handles queued requests reference), retry
                if session_ttl_s is not None:
                    keep = {r.state.cache.sid for r in batcher.queue
                            if r.state is not None
                            and isinstance(r.state.cache, PagedHandle)}
                    self.pool.evict_idle(session_ttl_s, exclude=keep)
                fund()
                admitted = batcher.admit(fits=fits)
                if not admitted:
                    if overload == "shed" and batcher.shed_one() is not None:
                        self.counters["shed"] += 1
                        continue
                    raise PoolExhaustedError(
                        f"cache pool exhausted: {self.pool.blocks_in_use}/"
                        f"{self.pool.n_blocks} blocks "
                        f"({self.pool._famine_detail()}) held by "
                        f"{self.pool.live_sessions} sessions and no slot "
                        "can admit — grow pool_blocks, release sessions, or "
                        "pass session_ttl_s")
            if paged and batcher.queue and None in batcher.slots:
                # backpressure: queued requests wait for retirements
                self.counters["backpressure_deferred"] += len(batcher.queue)
            for i in admitted:
                req = batcher.slots[i]
                st = req.state
                if (st is not None and faults is not None
                        and isinstance(st.cache, PagedHandle)
                        and faults.consume("session") is not None):
                    # injected forced eviction: the handle is really
                    # released, so the recovery below is the real path
                    self.release(st)
                if st is not None:
                    try:
                        self._check_state(st, extension=not req.prompt)
                    except EvictedSessionError:
                        # the handle is gone: re-admit COLD from the full
                        # conversation instead of failing the request
                        req.state = st = None
                        if req.cold_prompt is not None:
                            req.prompt = list(req.cold_prompt)
                        if not req.prompt:
                            req.done = req.shed = True
                            batcher.finished.append(req)
                            batcher.slots[i] = None
                            self.counters["shed"] += 1
                            continue
                        self.counters["reprefill_cold"] += 1
                if st is not None and req.prompt:
                    # warm admission: continuation prefill of the new span
                    pb, s_orig = self._bucket_right(
                        np.asarray(req.prompt, np.int32)[None])
                    self.counters["prefill_continue"] += 1
                    p0 = st.offset + s_orig
                elif st is not None:                 # pure decode resume
                    self.counters["decode_only"] += 1
                    p0 = st.offset
                else:
                    pb, s_orig = self._bucket(
                        np.asarray(req.prompt, np.int32)[None])
                    self.counters["prefill"] += 1
                    p0 = s_orig
                pos0[i] = p0
                if paged and i not in mine:
                    continue            # another data rank holds the slot
                li = i - mine.start
                if paged:
                    run, row = (self.pool.admit_row(st.cache, nb,
                                                    int(st.pos[0]))
                                if st is not None
                                else self.pool.alloc_run(nb))
                    slot_tables[li, :] = run
                    slot_rows[li] = row
                    slot_run[i] = (run, row)
                    c1g = self._paged_dev_cache(slot_tables[li:li + 1],
                                                slot_rows[li:li + 1])
                elif st is not None:
                    c1g, _ = self._grown_cache(st, max_len)
                if st is not None and req.prompt:
                    fn = (self._prefill_continue_paged if paged
                          else self._prefill_continue)
                    c1, l1, k1 = fn(*self._span(pb, s_orig), st.pos, c1g)
                elif st is not None:
                    c1, l1, k1 = st.cur, self._cols(st.last), c1g
                else:
                    span = self._span(pb, s_orig)
                    if paged:
                        c1, l1, k1 = self._prefill_into_paged(*span, c1g)
                    else:
                        c1, l1, k1 = self._prefill_absorb(*span, max_len)
                if not paged and i in mine:          # splice into slot i
                    for dst, src in zip(cache, k1):
                        for a, b in zip(dst, src):
                            a[li].copy_(b[0])
                cur[i] = c1[0]
                last[i] = l1[0]
                pos[i] = p0

            # a return_state request's last step lands on a chunk boundary,
            # so its slot state is captured exactly
            chunk = min([int(decode_chunk)] +
                        [r.max_new - len(r.generated)
                         for _, r in batcher.active() if r.return_state])
            toks, _, h_per, v_per, (cur, last, pos) = self._dispatch(
                self._route, self._mine(cur),
                self._mine(last),
                self._paged_dev_cache(slot_tables, slot_rows) if paged
                else cache, self._mine(pos),
                chunk, bool(greedy), self._draw(gen, n_slots),
                with_logits=False)
            toks, h_per, v_per, cur, last, pos = self._whole(
                (toks, h_per, v_per, cur, last, pos), n_slots)
            toks_np = toks.cpu().numpy()
            h_np, v_np = h_per.cpu().numpy(), v_per.cpu().numpy()
            slot_of = {r.rid: i for i, r in batcher.active()}
            retired_at: dict[int, int] = {}
            for t in range(chunk):
                active = batcher.active()
                if not active:
                    break
                for i, req in active:
                    a = acc.setdefault(req.rid, [0.0, 0.0, 0])
                    a[0] += float(h_np[i, t])
                    a[1] += float(v_np[i, t])
                    a[2] += 1
                batcher.record_tokens(toks_np[:, t], stop_token)
                for i, req in active:
                    if req.done:
                        retired_at.setdefault(req.rid, t)
            for req in batcher.finished:          # retired this chunk
                i = slot_of.get(req.rid)
                if i is None:
                    continue
                want_state = req.return_state and req.rid not in states
                end = pos0.pop(i) + len(req.generated)
                # a stop-token retirement mid-chunk left the slot decoding
                # past the stop: its pending token is not the session's
                exact = retired_at.get(req.rid) == chunk - 1
                if want_state:
                    handle = None
                    if not paged:
                        handle = self._slot_cache(cache, i, n_slots)
                    else:
                        handle = self._slot_handle(slot_run, i, mine,
                                                   -(-end // self.block_len))
                    states[req.rid] = SessionState(
                        handle, self._full(1, end), cur[i:i + 1].clone(),
                        self._vocab_whole(last[i:i + 1]).clone(), max_len,
                        end, exact=exact)
                free_slot(i)
            if step_time_ms is not None:
                # the simulated clock: each decode step costs step_time_ms,
                # plus any injected straggle; requests past their deadline
                # retire shed (queued ones before they take a slot)
                now_ms += chunk * float(step_time_ms)
                if faults is not None:
                    ev = faults.consume("decode")
                    if ev is not None:
                        now_ms += 1000.0 * float(ev.delay_s)
                for i, req in batcher.expire(now_ms):
                    self.counters["expired"] += 1
                    if i is not None:
                        free_slot(i)
            if faults is not None and faults.consume("slot") is not None:
                # injected slot failure: the lowest active slot dies after
                # this chunk; its progress is lost and the request goes
                # back to the queue (re-admitted warm off a still-valid
                # handle, else cold)
                act = batcher.active()
                if act:
                    i, req = act[0]
                    free_slot(i)
                    acc.pop(req.rid, None)
                    batcher.requeue(i)
                    self.counters["requeued"] += 1
            drain()
        drain()
        return results

    def _slot_handle(self, slot_run: list, i: int, mine: range,
                     covered: int):
        """A retired paged serve slot's session handle, trimmed to its
        ``covered`` blocks: the slot's own run adopted where this rank
        holds the slot; on the other data ranks of a split (the handle is
        batch 1, so every rank holds it) a copy of the owner's covered
        blocks and row (``_move_rows``)."""
        if len(mine) == len(slot_run):
            if slot_run[i] is None:
                return None
            blocks, row = slot_run[i]
            slot_run[i] = None
            return self.pool.adopt(blocks, row, covered)
        owner = next(o for o, rows in enumerate(self._holders(len(slot_run)))
                     if i in rows)
        mine_ = i in mine
        self.pool.reserve(0 if mine_ else covered, 0 if mine_ else 1)
        held = {i: slot_run[i]} if mine_ else {}
        got = self._move_rows([(i, owner, covered)], held,
                              set() if mine_ else {i})
        if mine_:
            blocks, row = slot_run[i]
            slot_run[i] = None
            return self.pool.adopt(blocks, row, covered)
        blocks, row = got[i]
        return self.pool.register(blocks[None], np.array([row], np.int32))

    # ------------------------------------------------------------------
    def token_count(self, prompts: np.ndarray, max_new: int) -> np.ndarray:
        return (np.asarray(prompts) != PAD).sum(axis=1) + max_new


def _flatten(cache: list):
    """A monolithic cache's tensors in layer order, and the (type, count)
    of each layer entry to rebuild it (``_unflatten``)."""
    return ([t for c in cache for t in c],
            [(type(c), len(c)) for c in cache])


def _unflatten(types, tensors) -> list:
    out, i = [], 0
    for kind, n in types:
        out.append(kind(*tensors[i:i + n]))
        i += n
    return out


def _width(cache: list) -> int:
    """The longest KV cache of a monolithic cache (0 without attention)."""
    return max((c.k.shape[1] for c in cache
                if not isinstance(c, T.STATE_TYPES)), default=0)


def _combine(out, ucfg: UncertaintyConfig):
    """A decode dispatch's (tokens, logits, h, v, (cur, last, pos)) as
    (tokens, logits, u, h_mean, v_mean, cur, last, pos): the Eq. 2-3 means
    and the Eq. 4 combine, on the device."""
    toks, lgs, h_per, v_per, (cur, last, pos) = out
    h, v = h_per.mean(-1), v_per.mean(-1)
    return toks, lgs, U.combine_terms(h, v, ucfg), h, v, cur, last, pos


# the eager body of each decode route (``InferenceEngine._dispatch``)
_BODIES = {"mono": InferenceEngine._mono_body,
           "kernel": InferenceEngine._kernel_body,
           "gather": InferenceEngine._gather_body}
