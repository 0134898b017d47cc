"""Inference engine, monolithic caches: prefill, decode loop, the
integrated Eq. 2-4 probe and the session handles the gateway uses
(PyTorch).

Mirrors the monolithic, single-device branches of
``repro/serving/engine.py``:

  * **prefill** absorbs the whole (bucketed, left-padded) prompt in one
    pass that fills every layer cache;
  * **decode** runs ``max_new`` steps as a Python loop over
    ``transformer.decode_step`` in place of the JAX ``lax.scan``; token
    ``t``'s probe terms come from the logits *entering* step ``t`` (the
    logits that chose it), through the fused uncertainty op;
  * **serve()** streams cold requests through the ``ContinuousBatcher``:
    admit into free slots, prefill the slot, decode a chunk over all slots,
    retire at stop token / ``max_new``, combine the Eq. 2-3 means into U at
    retirement;
  * **sessions**: ``generate(..., return_state=True)`` hands back a
    ``SessionState`` (the decode carry and the filled cache),
    ``generate(None, k, state=...)`` extends it decode-only, and
    ``state_select`` copies rows of it out.

Prompt shapes are bucketed (left-padded to the next power of two); bucket
columns get negative positions, which prefill treats as inert.  PAD=0
columns inside the caller's array are real tokens at real positions, as in
the reference.

The engine runs on CUDA unless the caller passes ``device="cpu"``; with
``device=None`` and no card it raises instead of running on the CPU.
Continuation prefill (``state=`` with prompts), ``absorb``, warm
``serve()`` requests, paged caches, meshes and fault injection are not
ported yet and raise ``NotImplementedError``.

Unlike JAX's immutable arrays, the port's caches are written in place: a
``SessionState`` is single use (extending it writes its cache), and
``state_select`` copies the rows it selects.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core import uncertainty as U
from repro_torch.core.uncertainty import UncertaintyConfig
from repro_torch.models import transformer as T
from repro_torch.models.common import (ModelConfig, resolve_device,
                                       use_f32_accumulation)
from repro_torch.serving.scheduler import ContinuousBatcher, Request

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

    Returned by ``generate(..., return_state=True)``; accepted back by
    ``generate(None, k, state=...)`` (decode-only extension).  The handle is
    engine-specific and SINGLE USE: the cache is written in place, so
    extending a state overwrites it, and a second extension of the same
    handle would continue from a cache the first one already wrote.  Fork
    with ``state_select``, which copies, before extending if both
    timelines are needed.

    * ``cache`` — one ``KVCache`` per layer, populated through position
      ``pos - 1``;
    * ``pos`` (B,) int32 — next absolute write position per row;
    * ``cur`` (B,) int32 — the last sampled token, not yet absorbed or
      emitted: an extension resumes from it bitwise;
    * ``last`` (B, V) f32 — ``cur``'s logits;
    * ``max_len`` — cache length (slots); ``offset`` — host-side upper
      bound of ``pos``, which sizes cache growth without a device sync;
    * ``gen`` — the sampling generator the decode loop drew from (None for
      greedy), so a sampled extension continues the same stream.
    """
    cache: list
    pos: torch.Tensor
    cur: torch.Tensor
    last: torch.Tensor
    max_len: int
    offset: int
    gen: torch.Generator | None = None

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


@dataclasses.dataclass
class InferenceEngine:
    """One swarm member: a model + its two-phase serving runtime.

    ``params`` is the port's ``Transformer`` (from ``init_params`` or
    ``convert.from_jax_params``); it is moved to ``device``.  On a CUDA
    device, building an engine sets torch's process-wide matmul precision
    flags (``models.common.use_f32_accumulation``)."""
    name: str
    cfg: ModelConfig
    params: Any
    ucfg: UncertaintyConfig = dataclasses.field(
        default_factory=UncertaintyConfig)
    max_len: int = 128
    device: Any = None
    paged: bool = False
    mesh: Any = None

    def __post_init__(self):
        if self.paged:
            raise _not_ported("the paged block-pool cache")
        if self.mesh is not None:
            raise _not_ported("mesh-sharded serving")
        self.device = resolve_device(self.device, "InferenceEngine")
        if self.device.type == "cuda":
            use_f32_accumulation()
        # host-side dispatch accounting: cold prefills and decode-only
        # resumes (the gateway tests assert the swarm round adds no probe
        # prefill), whole-cache growth copies, and the failure-domain
        # counters the gateway reads (0 here: no pool, no fault injection)
        self.counters = {"prefill": 0, "decode_only": 0, "grow_copy": 0,
                         "famine_deferred": 0, "shed": 0, "expired": 0,
                         "requeued": 0, "reprefill_cold": 0}
        self.params = self.params.to(self.device)
        kvb = self.cfg.attn_kv_block
        if self.max_len > kvb and self.max_len % kvb:
            self.max_len = -(-self.max_len // kvb) * kvb

    # ------------------------------------------------------------------
    def _round_len(self, need: int) -> int:
        """Bucket a cache length: multiples of 64, and of ``attn_kv_block``
        once the cache outgrows one KV chunk."""
        n = -(-need // 64) * 64
        kvb = self.cfg.attn_kv_block
        if n > kvb:
            n = -(-n // kvb) * kvb
        return n

    def _cache_len(self, s_bucket: int, max_new: int) -> int:
        need = s_bucket + max_new
        if need <= self.max_len:
            return self.max_len
        return self._round_len(need)

    def _grown_cache(self, state: SessionState, need: int):
        """(cache, max_len) with at least ``need`` slots: the session's own
        cache, or a longer copy of it (new slots empty) counted in
        ``counters["grow_copy"]``."""
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

    # ------------------------------------------------------------------
    def _prefill_absorb(self, prompts: np.ndarray, s_orig: int,
                        max_len: int):
        """Cold prefill of bucketed ``prompts`` (B, Sb) into a fresh
        (B, max_len) cache -> (first greedy token (B,) int32, its logits
        (B, V) f32, cache)."""
        B, S = prompts.shape
        tokens = torch.as_tensor(prompts, dtype=torch.int32,
                                 device=self.device)
        # columns left of the caller's prompt get negative positions (inert)
        positions = (torch.arange(S, dtype=torch.int32, device=self.device)
                     - (S - s_orig)).expand(B, S)
        cache = T.init_cache(self.cfg, B, max_len, device=self.device)
        logits, cache = T.prefill(self.params, self.cfg, tokens, cache,
                                  positions)
        last = logits[:, -1].float()
        return last.argmax(-1).to(torch.int32), last, cache

    def _next(self, lg: torch.Tensor, greedy: bool,
              gen: torch.Generator | None) -> torch.Tensor:
        if greedy:
            return lg.argmax(-1).to(torch.int32)
        probs = torch.softmax(lg, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].to(
            torch.int32)

    def _decode(self, cur, last, cache, pos, steps: int, greedy: bool,
                gen, with_logits: bool = True):
        """``steps`` decode iterations.  cur (B,) token entering the span,
        last (B,V) its logits, pos (B,) its position.  Emits the tokens (and
        logits) *entering* each step plus their Eq. 2-3 terms; returns
        (tokens, logits | None, h, v, (cur, last, pos)), each (B, steps)."""
        toks, lgs, hs, vs = [], [], [], []
        for _ in range(steps):
            h, v = U.uncertainty_terms(last[:, None, :], cur[:, None],
                                       self.ucfg)
            logits, cache = T.decode_step(self.params, self.cfg,
                                          cur[:, None], cache, pos)
            lg = logits[:, -1].float()
            toks.append(cur)
            hs.append(h[:, 0])
            vs.append(v[:, 0])
            if with_logits:
                lgs.append(last)
            cur, last, pos = self._next(lg, greedy, gen), lg, pos + 1
        stack = (lambda xs: torch.stack(xs, dim=1))
        return (stack(toks), stack(lgs) if with_logits else None, stack(hs),
                stack(vs), (cur, last, pos))

    def _generator(self, greedy: bool, seed: int):
        if greedy:
            return None
        return torch.Generator(device=self.device).manual_seed(seed)

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
        prompt and every emitted token.  ``state=<handle>`` with
        ``prompts=None`` is a decode-only extension: ``max_new`` more
        tokens from the session's pending token, the ones one longer
        generation would have emitted next (no prefill).  The extension
        writes the handle's cache in place."""
        if prompts is not None:
            prompts = np.asarray(prompts, np.int32)
        if state is not None:
            if prompts is not None and prompts.shape[1] > 0:
                raise _not_ported("continuation prefill (state= with "
                                  "prompts)")
            return self._extend(int(max_new), state, bool(greedy), seed,
                                return_state)
        B = prompts.shape[0]
        pb, s_orig = self._bucket(prompts)
        max_len = self._cache_len(pb.shape[1], max_new)
        self.counters["prefill"] += 1
        cur, last, cache = self._prefill_absorb(pb, s_orig, max_len)
        pos = torch.full((B,), s_orig, dtype=torch.int32, device=self.device)
        gen = self._generator(greedy, seed)
        toks, lgs, h_per, v_per, carry = self._decode(
            cur, last, cache, pos, int(max_new), bool(greedy), gen)
        res = self._result(toks, lgs, h_per, v_per,
                           (prompts != PAD).sum(axis=1))
        if return_state:
            res["state"] = SessionState(cache, carry[2], carry[0], carry[1],
                                        max_len, s_orig + int(max_new), gen)
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
        cache, max_len = self._grown_cache(state, state.offset + max_new)
        self.counters["decode_only"] += 1
        gen = state.gen if state.gen is not None else self._generator(
            greedy, seed)
        toks, lgs, h_per, v_per, (cur, last, pos) = self._decode(
            state.cur, state.last, cache, state.pos, max_new, greedy, gen)
        res = self._result(toks, lgs, h_per, v_per,
                           np.zeros((state.batch,), np.int64))
        if return_state:
            res["state"] = SessionState(cache, pos, cur, last, max_len,
                                        state.offset + max_new, gen)
        return res

    @torch.inference_mode()
    def state_select(self, state: SessionState, idx) -> SessionState:
        """Rows ``idx`` of a session (repeated indices fan out), as a COPY:
        the caches are written in place, so extending the selection must
        leave the source untouched.  The gateway hands the swarm round the
        probe's state for just the SWARM-routed queries this way."""
        idx = torch.as_tensor(np.asarray(idx, np.int64), device=self.device)
        cache = [type(c)(*(t.index_select(0, idx) for t in c))
                 for c in state.cache]
        return SessionState(cache, state.pos.index_select(0, idx),
                            state.cur.index_select(0, idx),
                            state.last.index_select(0, idx), state.max_len,
                            state.offset, _fork(state.gen))

    def absorb(self, prompts: np.ndarray):
        raise _not_ported("absorb (prefill-only sessions)")

    @torch.inference_mode()
    def generate_stepwise(self, prompts: np.ndarray, max_new: int, *,
                          greedy: bool = True, seed: int = 0) -> dict:
        """One-token-at-a-time absorption (S + max_new decode steps): the
        port's own oracle for ``generate``.  The cache length comes from the
        same bucket ``generate`` uses; only the real S columns are
        absorbed."""
        prompts = np.asarray(prompts, np.int32)
        B, S = prompts.shape
        pb, _ = self._bucket(prompts)
        cache = T.init_cache(self.cfg, B, self._cache_len(pb.shape[1],
                                                          max_new),
                             device=self.device)
        gen = self._generator(greedy, seed)
        tok = torch.as_tensor(prompts, dtype=torch.int32, device=self.device)

        def step(tokens, index, greedy):
            logits, _ = T.decode_step(
                self.params, self.cfg, tokens, cache,
                torch.full((B,), index, dtype=torch.int32,
                           device=self.device))
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
              greedy: bool = True, seed: int = 0, faults=None,
              overload: str = "raise",
              step_time_ms: float | None = None) -> list[dict]:
        """Streaming entry point for cold requests: admit queued requests
        into free slots (one prefill each, copied into the slot cache), one
        decode chunk over ALL slots, record tokens, retire finished slots
        (stop token or max_new), repeat until idle.  Empty slots decode
        garbage at position 0 against an empty cache; it stays finite and
        touches no other slot.  Returns ``{"rid", "tokens", "u"}`` per
        request in completion order; with ``greedy=True`` the tokens are
        those ``generate`` gives for the same prompt row.  ``overload``
        ("raise" or "shed") is taken as the JAX engine takes it; a
        monolithic engine has no block pool, so nothing is ever shed."""
        if overload not in ("raise", "shed"):
            raise ValueError(f"overload must be 'raise' or 'shed', got "
                             f"{overload!r}")
        if faults is not None:
            raise _not_ported("fault injection")
        if step_time_ms is not None:
            raise _not_ported("the deadline clock (step_time_ms)")
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
        if any(r.state is not None or r.return_state or r.cold_prompt
               for r in pending):
            raise _not_ported("warm requests (session state)")
        if not pending:
            return []
        n_slots = batcher.n_slots
        gran = max(self.cfg.attn_q_block, self.cfg.attn_kv_block)
        max_len = max(self._cache_len(bucket_len(len(r.prompt), gran),
                                      r.max_new) for r in pending)
        dev = self.device
        cur = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
        last = torch.zeros((n_slots, self.cfg.vocab_size),
                           dtype=torch.float32, device=dev)
        pos = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
        cache = T.init_cache(self.cfg, n_slots, max_len, device=dev)
        gen = self._generator(greedy, seed)
        acc: dict[int, list] = {}           # rid -> [sum_h, sum_v, n]
        results: list[dict] = []

        def drain():
            for req in batcher.drain_finished():
                h, v, n = acc.pop(req.rid, (0.0, 0.0, 0))
                d = max(n, 1)
                results.append({
                    "rid": req.rid,
                    "tokens": np.asarray(req.generated, np.int32),
                    "u": float(U.combine_terms(h / d, v / d, self.ucfg))})

        while not batcher.idle:
            for i in batcher.admit():
                req = batcher.slots[i]
                pb, s_orig = self._bucket(
                    np.asarray(req.prompt, np.int32)[None])
                self.counters["prefill"] += 1
                c1, l1, k1 = self._prefill_absorb(pb, s_orig, max_len)
                for dst, src in zip(cache, k1):      # splice into slot i
                    for a, b in zip(dst, src):
                        a[i].copy_(b[0])
                cur[i] = c1[0]
                last[i] = l1[0]
                pos[i] = s_orig
            toks, _, h_per, v_per, (cur, last, pos) = self._decode(
                cur, last, cache, pos, int(decode_chunk), bool(greedy), gen,
                with_logits=False)
            toks_np = toks.cpu().numpy()
            h_np, v_np = h_per.cpu().numpy(), v_per.cpu().numpy()
            for t in range(int(decode_chunk)):
                active = batcher.active()
                if not active:
                    break
                for i, req in active:
                    a = acc.setdefault(req.rid, [0.0, 0.0, 0])
                    a[0] += float(h_np[i, t])
                    a[1] += float(v_np[i, t])
                    a[2] += 1
                batcher.record_tokens(toks_np[:, t], stop_token)
            drain()
        drain()
        return results
