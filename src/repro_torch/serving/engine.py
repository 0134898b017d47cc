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
Meshes are not ported yet and raise ``NotImplementedError``.
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
engines in either direction.

Unlike JAX's immutable arrays, the port's caches and pools are written in
place: a monolithic ``SessionState`` is single use (extending it writes its
cache), and ``state_select`` on a monolithic engine copies the rows it
selects; on a paged engine it is a refcounted table copy, and the first
write COW-copies any shared block in its range.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core import uncertainty as U
from repro_torch.core.uncertainty import UncertaintyConfig
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


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported to the PyTorch engine "
                               "yet")


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
    itself is not changed."""
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
            raise _not_ported("mesh-sharded serving")
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
                         "backpressure_deferred": 0}
        self.params = self.params.to(self.device)
        Q.check_quant(self.weight_quant)
        if self.weight_quant is not None:
            self.params = Q.quantize_params(self.params, self.weight_quant)
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
        self.pool = CachePool(self.cfg, L, n_blocks, n_rows,
                              cache_quant=self.cache_quant,
                              device=self.device)

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
        return (T.grow_cache(self.cfg, state.cache, state.batch, new_len,
                             device=self.device), new_len)

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
        logits, cache = T.prefill(self.params, self.cfg, tokens, cache,
                                  positions)
        # contiguous: in an f32 model ``.float()`` is the strided view,
        # and the uncertainty kernel takes contiguous rows
        last = logits[:, -1].float().contiguous()
        return last.argmax(-1).to(torch.int32), last, cache

    def _prefill_absorb(self, tokens, s_orig, max_len: int):
        """Monolithic cold prefill into a fresh (B, max_len) cache; the span
        as tensors, or as a numpy array and an int."""
        if not isinstance(tokens, torch.Tensor):
            tokens, s_orig = self._span(tokens, s_orig)
        cache = T.init_cache(self.cfg, tokens.shape[0], max_len,
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
        logits, cache = T.prefill(self.params, self.cfg, tokens, cache,
                                  positions.to(torch.int32),
                                  continuation=True, check=False)
        last = logits.index_select(1, (s_orig - 1).long())[:, 0]
        last = last.float().contiguous()
        return last.argmax(-1).to(torch.int32), last, cache

    def _next(self, lg: torch.Tensor, greedy: bool,
              gen: torch.Generator | None) -> torch.Tensor:
        if greedy:
            return lg.argmax(-1).to(torch.int32)
        # torch.multinomial's one-sample draw (an exponential race over the
        # probabilities, the same numbers), without its validity check: a
        # host sync, which a captured dispatch cannot hold
        probs = torch.softmax(lg, dim=-1)
        q = torch.empty_like(probs).exponential_(1, generator=gen)
        return (probs / q).argmax(-1).to(torch.int32)

    def _decode(self, cur, last, pos, steps: int, greedy: bool, gen, step,
                with_logits: bool = True):
        """The eager decode loop: ``steps`` iterations; ``step(tokens
        (B,1), pos (B,), t)`` runs one model step and returns its logits
        (B,1,V).  cur (B,) token entering the span, last (B,V) its logits,
        pos (B,) its position.  Emits the tokens (and logits) *entering*
        each step plus their Eq. 2-3 terms; returns (tokens, logits | None,
        h, v, (cur, last, pos)), each (B, steps).  No host sync: a
        dispatch captures it whole (``_dispatch``)."""
        toks, lgs, hs, vs = [], [], [], []
        for t in range(steps):
            h, v = U.uncertainty_terms(last[:, None, :], cur[:, None],
                                       self.ucfg)
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
            return T.decode_step(self.params, self.cfg, tokens, cache,
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
        if self._graphs is None:
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
                                  state.pos.cpu().numpy())
        return self._paged_dev_cache(tables, handle.rows), disp

    def _prefill_into_paged(self, tokens, s_orig: torch.Tensor,
                            cache: dict):
        """Paged cold prefill: gather -> ``_prefill_into`` -> write blocks
        [0, s_orig) back."""
        B = tokens.shape[0]
        lin = T.paged_gather(self.cfg, cache)
        cur, last, lin = self._prefill_into(tokens, s_orig, lin)
        T.paged_scatter_back(self.cfg, cache, lin, self._full(B, 0),
                             s_orig.expand(B))
        return cur, last, cache

    def _prefill_continue_paged(self, tokens, s_orig: torch.Tensor,
                                start: torch.Tensor, cache: dict):
        """Paged continuation prefill: gather -> ``_prefill_continue`` ->
        write blocks [start, start + s_orig) back."""
        lin = T.paged_gather(self.cfg, cache)
        cur, last, lin = self._prefill_continue(tokens, s_orig, start, lin)
        T.paged_scatter_back(self.cfg, cache, lin, start, start + s_orig)
        return cur, last, cache

    def _kernel_body(self, cur, last, cache: dict, pos, steps: int,
                     greedy: bool, gen, with_logits: bool = True):
        """Kernel-first paged decode: every layer attends the pool in place
        through the block table (``transformer.paged_decode_step``) plus
        the dispatch's delta rows, allocated here (inside a capture: by
        every replay); the delta rows go into the pool once, at the end of
        the dispatch."""
        p0 = pos
        delta = T.paged_decode_carry(self.cfg, cache, steps)

        def step(tokens, index, t):
            return T.paged_decode_step(self.params, self.cfg, tokens, cache,
                                       delta, index, t, p0)[0]
        out = self._decode(cur, last, pos, steps, greedy, gen, step,
                           with_logits)
        T.paged_scatter_decode(self.cfg, cache, delta, p0)
        return out

    def _gather_body(self, cur, last, cache: dict, pos, steps: int,
                     greedy: bool, gen, with_logits: bool = True):
        """Gather-path paged decode: gather the monolithic view, decode it
        and write blocks [pos, pos + steps) back."""
        lin = T.paged_gather(self.cfg, cache)
        out = self._mono_body(cur, last, lin, pos, steps, greedy, gen,
                              with_logits)
        T.paged_scatter_back(self.cfg, cache, lin, pos, pos + steps)
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
                cache = T.init_cache(self.cfg, B, max_len,
                                     device=tokens.device)
                cur, last, cache = self._prefill_into(tokens, s_orig, cache)
            else:
                cur, last, cache = self._prefill_continue(tokens, s_orig,
                                                          start, cache)
            out = self._mono_body(cur, last, cache, pos, max_new, greedy,
                                  gen)
            return _combine(out, self.ucfg), (cache if cold else None)
        if cold:
            lin = T.init_cache(self.cfg, B, max_len, device=tokens.device)
            cur, last, lin = self._prefill_into(tokens, s_orig, lin)
            end = torch.full((B,), max_len, dtype=torch.int32,
                             device=tokens.device)
        else:
            lin = T.paged_gather(self.cfg, cache)
            cur, last, lin = self._prefill_continue(tokens, s_orig, start,
                                                    lin)
            end = pos if route == "kernel" else pos + max_new
        if route == "kernel":
            T.paged_scatter_back(self.cfg, cache, lin, start, end)
            out = self._kernel_body(cur, last, cache, pos, max_new, greedy,
                                    gen)
        else:
            out = self._mono_body(cur, last, lin, pos, max_new, greedy, gen)
            T.paged_scatter_back(self.cfg, cache, lin, start, end)
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

        if self._graphs is None:
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
        the sampling generator's state go with it."""
        self._state_kind_check(state)
        if self.paged:
            h = state.cache
            cov_len = int(h.tables.shape[1]) * self.block_len
            cache = T.paged_gather(
                self.cfg, self._paged_dev_cache(h.tables, h.rows))
        else:
            cov_len = int(state.max_len)
            cache = state.cache
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
        return ck.save(ckpt_dir, step, tree, extra=extra, keep=keep)

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
        ``QuantMismatchError`` for another cache representation."""
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
        if self.paged:
            handle = self.pool.alloc(B, cov_len // self.block_len)
            T.paged_scatter_back(
                self.cfg, self._paged_dev_cache(handle.tables, handle.rows),
                cache, self._full(B, 0), self._full(B, cov_len))
            cache, max_len = handle, int(extra["max_len"])
        else:
            # a monolithic cache is as long as its max_len: a paged-saved
            # session arrives trimmed to the blocks it covers and grows back
            # to its max_len (empty slots), so its dispatches keep the
            # source's shapes (on the card another length tiles the decode
            # kernel's keys otherwise, and the sums differ in their last
            # bits)
            max_len = int(extra["max_len"])
            if max_len > cov_len:
                cache = T.grow_cache(self.cfg, cache, B, max_len,
                                     device=self.device)
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
        if state is None:
            pb, s_orig = self._bucket(prompts)
            max_len = self._cache_len(pb.shape[1], max_new)
            self.counters["prefill"] += 1
            if self.paged:
                # the dispatch writes every block of the new session
                cache = self.pool.alloc(B, max_len // self.block_len,
                                        reset="dispatch")
                out, _ = self._generate_fused(
                    pb, s_orig, None,
                    self._paged_dev_cache(cache.tables, cache.rows),
                    max_len, max_new, greedy, gen)
            else:
                out, cache = self._generate_fused(
                    pb, s_orig, None, None, max_len, max_new, greedy, gen,
                    keep_cache=return_state)
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
            out, _ = self._generate_fused(pb, s_orig, state.pos, dev,
                                          max_len, max_new, greedy, gen)
            offset = state.offset + s_orig + max_new
        toks, lgs, u, h, v, cur, last, pos = out
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
        toks, lgs, h_per, v_per, (cur, last, pos) = self._dispatch(
            self._route, state.cur, state.last, cache, state.pos, max_new,
            greedy, gen)
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
            tokens, s_len = self._span(pb, s_orig)
            if self.paged:
                cache = self.pool.alloc(B, max_len // self.block_len)
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
            tokens, s_len = self._span(pb, s_orig)
            need = state.offset + pb.shape[1]
            self.counters["prefill_continue"] += 1
            if self.paged:
                cache = state.cache
                dev, max_len = self._paged_grown(state, need)
                cur, last, _ = self._prefill_continue_paged(
                    tokens, s_len, state.pos, dev)
            else:
                cache, max_len = self._grown_cache(state, need)
                cur, last, cache = self._prefill_continue(
                    tokens, s_len, state.pos, cache)
            pos, offset = state.pos + s_orig, state.offset + s_orig
        if self.paged:
            self.pool.trim(cache, -(-offset // self.block_len))
        return SessionState(cache, pos, cur, last, max_len, offset)

    @torch.inference_mode()
    def state_select(self, state: SessionState, idx) -> SessionState:
        """Rows ``idx`` of a session (repeated indices fan out).  The
        gateway hands the swarm round the probe's state for just the
        SWARM-routed queries this way.  Monolithic: a COPY of the rows, KV and
        recurrent states alike (the caches are written in place, so
        extending the selection must leave the source untouched).  Paged: a
        refcounted table copy and fresh copies of the state rows
        (``CachePool.select``); the selection's first write COW-copies any
        shared block in its range, so the source's blocks and rows stay as
        they were."""
        idx_np = np.asarray(idx, np.int64)
        idx = torch.as_tensor(idx_np, device=self.device)
        if self.paged:
            self._state_kind_check(state)
            cache = self.pool.select(state.cache, idx_np)
        else:
            cache = [type(c)(*(t.index_select(0, idx) for t in c))
                     for c in state.cache]
        return SessionState(cache, state.pos.index_select(0, idx),
                            state.cur.index_select(0, idx),
                            state.last.index_select(0, idx), state.max_len,
                            state.offset, _fork(state.gen), state.exact)

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
        cache = T.init_cache(self.cfg, B, self._cache_len(pb.shape[1],
                                                          max_new),
                             device=self.device)
        gen = self._generator(greedy, seed)
        tok = self._tokens(prompts)

        def step(tokens, index, greedy):
            logits, _ = T.decode_step(self.params, self.cfg, tokens, cache,
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
        logits = torch.stack(lgs, dim=1)
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
        last = torch.zeros((n_slots, self.cfg.vocab_size),
                           dtype=torch.float32, device=dev)
        pos = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
        if paged:
            nb = max_len // self.block_len
            # sentinel tables and rows: an empty slot's reads are skipped
            # or clamped and its writes land in the sinks
            slot_tables = np.full((n_slots, nb), self.pool.n_blocks,
                                  np.int32)
            slot_rows = np.full((n_slots,), self.pool.n_rows, np.int32)
            slot_run: list = [None] * n_slots   # the (blocks, row) it owns
            cache = None
        else:
            cache = T.init_cache(self.cfg, n_slots, max_len, device=dev)
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

        promised = [0]          # slots admitted this round, not yet funded

        def fits(r: Request) -> bool:
            # a cold request needs a full run and a state row, a warm one at
            # most that; count the slots admit() already promised this round
            ok = self.pool.can_alloc((promised[0] + 1) * nb, promised[0] + 1)
            promised[0] += ok
            return ok

        def free_slot(i: int):
            # free the blocks and the row a slot still owns and repoint it
            # at the sentinels: its garbage decode writes the sinks from now
            if paged:
                if slot_run[i] is not None:
                    blocks, row = slot_run[i]
                    self.pool.free_blocks(blocks)
                    self.pool.free_rows(np.array([row]))
                    slot_run[i] = None
                slot_tables[i, :] = self.pool.n_blocks
                slot_rows[i] = self.pool.n_rows
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
                promised[0] = 0
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
                promised[0] = 0
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
                if paged:
                    run, row = (self.pool.admit_row(st.cache, nb,
                                                    int(st.pos[0]))
                                if st is not None
                                else self.pool.alloc_run(nb))
                    slot_tables[i, :] = run
                    slot_rows[i] = row
                    slot_run[i] = (run, row)
                    c1g = self._paged_dev_cache(slot_tables[i:i + 1],
                                                slot_rows[i:i + 1])
                elif st is not None:
                    c1g, _ = self._grown_cache(st, max_len)
                if st is not None and req.prompt:
                    # warm admission: continuation prefill of the new span
                    pb, s_orig = self._bucket_right(
                        np.asarray(req.prompt, np.int32)[None])
                    self.counters["prefill_continue"] += 1
                    fn = (self._prefill_continue_paged if paged
                          else self._prefill_continue)
                    c1, l1, k1 = fn(*self._span(pb, s_orig), st.pos, c1g)
                    p0 = st.offset + s_orig
                elif st is not None:                 # pure decode resume
                    self.counters["decode_only"] += 1
                    c1, l1, k1 = st.cur, st.last, c1g
                    p0 = st.offset
                else:
                    pb, s_orig = self._bucket(
                        np.asarray(req.prompt, np.int32)[None])
                    self.counters["prefill"] += 1
                    span = self._span(pb, s_orig)
                    if paged:
                        c1, l1, k1 = self._prefill_into_paged(*span, c1g)
                    else:
                        c1, l1, k1 = self._prefill_absorb(*span, max_len)
                    p0 = s_orig
                if not paged:                        # splice into slot i
                    for dst, src in zip(cache, k1):
                        for a, b in zip(dst, src):
                            a[i].copy_(b[0])
                cur[i] = c1[0]
                last[i] = l1[0]
                pos[i] = p0
                pos0[i] = p0

            # a return_state request's last step lands on a chunk boundary,
            # so its slot state is captured exactly
            chunk = min([int(decode_chunk)] +
                        [r.max_new - len(r.generated)
                         for _, r in batcher.active() if r.return_state])
            toks, _, h_per, v_per, (cur, last, pos) = self._dispatch(
                self._route, cur, last,
                self._paged_dev_cache(slot_tables, slot_rows) if paged
                else cache, pos,
                chunk, bool(greedy), gen, with_logits=False)
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
                        handle = [type(c)(*(t[i:i + 1].clone() for t in c))
                                  for c in cache]
                    elif slot_run[i] is not None:
                        blocks, row = slot_run[i]
                        handle = self.pool.adopt(
                            blocks, row, -(-end // self.block_len))
                        slot_run[i] = None
                    states[req.rid] = SessionState(
                        handle, self._full(1, end), cur[i:i + 1].clone(),
                        last[i:i + 1].clone(), max_len, end, exact=exact)
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
