"""Model assembler: embeddings -> layers -> LM head (PyTorch).

Mirrors ``repro/models/transformer.py`` for the mixers the port serves:
GQA attention (global and windowed ``attn_local``), the RG-LRU recurrence
(``models/rglru.py``) and the Mamba-2 SSD block (``models/ssm.py``), each
followed by the gated MLP or the mixture of experts (``models/moe.py``;
none after an SSD layer).  A config with a ``frontend`` (llava-next's
vision patches, hubert's audio frames) takes precomputed embeddings in the
batch's ``frontend_embeds``, placed ahead of any text tokens
(``embed_inputs``); ``causal=False`` makes the attention bidirectional.
MoE layers run ``moe_block``
on the full-sequence path (``forward`` returns their summed aux loss),
``moe_prefill_block`` in ``prefill`` and ``moe_decode_block`` in the
decode steps.  The JAX package scans stacked stage parameters;
here the layers are an ``nn.ModuleList`` in layer order and each parameter
keeps its JAX layout, so converting a JAX parameter tree is a copy
(``repro_torch.convert``).

The functions keep the JAX signatures with the model in the ``params``
slot.  ``forward`` runs the full-sequence path (``run_layers``, shared with
the safety encoder), through the kernels for inference or, with
``train=True``, through ``attention.chunked_attention`` for autograd
(``loss_fn``, the training loss); ``prefill`` and ``decode_step`` write the
per-layer caches in place.  A monolithic cache is a list with one entry
per layer: an ``attention.KVCache``, an ``rglru.RGLRUState`` or an
``ssm.SSMState`` (the reference's ``LayerCache`` with its one used field).
Parameters are created without ``requires_grad``; a training step turns it
on for the step's own backward only (``training/train.py::value_and_grad``),
so the weights it hands to serving are frozen as before.

The paged block pool (``serving/cache_manager.py`` owns the allocator) is
a list with one entry per layer: an ``attention.KVPool`` of KV blocks for
an attention layer, or the layer's state type holding ``n_rows`` state
rows (plus a sink row) for a recurrent one.  A dispatch sees it as the dict
``paged_cache(layers, table, rows)``: block tables (B, nb) and state-row
ids (B,).  The JAX package keeps repeat-stacked pools and folds a
``layer * N`` offset into its block ids; the port's per-layer list has no
such offset.  State rows are gathered at a dispatch's start, carried
through it and scattered back at its end; ``reset_rows`` and ``copy_rows``
write the row pools in place, because captured dispatches and live handles
hold their addresses.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention, ffn, moe, rglru, ssm
from repro_torch.models import quant as Q
from repro_torch.models.common import ModelConfig, frozen_zeros, rmsnorm

ATTN = ("attn", "attn_local")
STATE_TYPES = (rglru.RGLRUState, ssm.SSMState)


class Block(nn.Module):
    """One layer: ``mixer`` (attention, RG-LRU or SSD) and, unless the
    layer plan says "none", the FFN ``ffn``: an MLP or an MoE."""

    def __init__(self, cfg: ModelConfig, kind: tuple[str, str], device=None):
        super().__init__()
        mixer, f = kind
        if mixer in ATTN:
            self.mixer = attention.Attention(cfg, device)
        elif mixer == "rglru":
            self.mixer = rglru.RGLRU(cfg, device)
        elif mixer == "ssd":
            self.mixer = ssm.SSD(cfg, device)
        if f == "mlp":
            self.ffn = ffn.MLP(cfg, device=device)
        elif f == "moe":
            self.ffn = moe.MoE(cfg, device)


class Transformer(nn.Module):
    """Zero-filled parameters; fill them with ``init_params`` or
    ``convert.from_jax_params``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        for mixer, f in cfg.layer_plan():
            if mixer not in ATTN + ("rglru", "ssd") or f not in (
                    "mlp", "moe", "none"):
                raise NotImplementedError(
                    f"{cfg.name}: layer kind {(mixer, f)} is not ported yet "
                    "(attention, RG-LRU and SSD mixers with an MLP or an "
                    "MoE)")
        self.cfg = cfg
        D, V = cfg.d_model, cfg.vocab_size
        z = dict(dtype=cfg.dtype, device=device)
        self.embed = frozen_zeros(V, D, **z)
        self.final_norm = frozen_zeros(D, **z)
        self.layers = nn.ModuleList(Block(cfg, kind, device)
                                    for kind in cfg.layer_plan())
        if not cfg.tie_embeddings:
            self.lm_head = frozen_zeros(D, V, **z)

    def head(self) -> torch.Tensor:
        """(D, V): the tied ``embed.T`` or the untied ``lm_head`` (a
        ``quant.QTensor`` in a model from ``quant.quantize_params``)."""
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    def forward(self, batch: dict, *, train: bool = False):
        """``forward(self, self.cfg, batch, train=train)``: lets
        ``torch.func.functional_call`` run the model on substituted
        parameters (``models/lora.py::merge``)."""
        return forward(self, self.cfg, batch, train=train)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Transformer:
    """Random weights with the JAX init distribution (``init_weights``)
    for a fresh ``Transformer(cfg)`` on ``device``.  Draws on
    ``generator``'s device; the numbers differ from JAX's for the same seed
    (tests convert JAX's weights instead)."""
    return init_weights(Transformer(cfg, device), cfg, generator)


# leaves the JAX init sets to zero, and leaves with an init of their own
_ZERO_LEAVES = ("norm", "final_norm", "bq", "bk", "bv", "head_b", "conv_b",
                "ba", "bx", "gnorm")
_SPECIAL_INIT = {"lam": rglru.lam_init, "A_log": ssm.a_init,
                 "dt_bias": ssm.dt_init}


def init_weights(model: nn.Module, cfg: ModelConfig,
                 generator: torch.Generator) -> nn.Module:
    """Fill ``model`` in place with the JAX init distribution: normal(0.02)
    drawn in f32 then cast (the MoE router and expert stacks too), the
    output projections (``wo``, ``w_down`` of MLPs, experts and shared
    experts, ``w_out``, ``out_proj``) at 0.02/sqrt(2L), norms and biases 0, the
    recurrences' own inits for ``lam``, ``A_log`` and ``dt_bias``, and
    ``D_skip`` 1.  Shared by every module built on the ``Transformer`` body
    (the safety classifier too)."""
    std_o = 0.02 / (2 * cfg.num_layers) ** 0.5
    gdev = generator.device
    with torch.no_grad():
        for name, prm in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in _ZERO_LEAVES:
                continue                                   # zeros
            if leaf == "D_skip":
                prm.fill_(1.0)
                continue
            if leaf in _SPECIAL_INIT:
                prm.copy_(_SPECIAL_INIT[leaf](prm.shape, generator))
                continue
            std = std_o if leaf in ("wo", "w_down", "w_out",
                                    "out_proj") else 0.02
            w = torch.randn(prm.shape, generator=generator, device=gdev,
                            dtype=torch.float32) * std
            prm.copy_(w.to(prm.dtype))
    return model


def _init_state(cfg: ModelConfig, mixer: str, batch: int, device=None):
    """A zero recurrent state of ``batch`` rows for a layer of ``mixer``."""
    if mixer == "rglru":
        return rglru.init_rglru_state(cfg, batch, device=device)
    return ssm.init_ssm_state(cfg, batch, device=device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> list:
    """One entry per layer: a ``KVCache`` (k/v zeros, pos -1) for an
    attention layer, a zero ``RGLRUState`` / ``SSMState`` for a recurrent
    one."""
    return [attention.init_kv_cache(cfg, batch, max_len,
                                    local=(mixer == "attn_local"),
                                    device=device)
            if mixer in ATTN else _init_state(cfg, mixer, batch, device)
            for mixer, _ in cfg.layer_plan()]


def grow_cache(cfg: ModelConfig, cache: list, batch: int, new_len: int,
               device=None) -> list:
    """A copy of every layer cache at ``new_len`` slots (>= the current
    length): the old slots copied in, the new ones empty (k/v 0, pos -1).
    Window-clamped ring caches that keep their size and recurrent states
    (they have no length) pass through."""
    out = []
    for tmpl, c in zip(init_cache(cfg, batch, new_len, device=device),
                       cache):
        if isinstance(c, STATE_TYPES) or tmpl.k.shape == c.k.shape:
            out.append(c)
            continue
        T = c.k.shape[1]
        for t, old in zip(tmpl, c):
            t[:, :T].copy_(old)
        out.append(tmpl)
    return out


def embed_inputs(params: Transformer, cfg: ModelConfig,
                 batch: dict) -> torch.Tensor:
    """The batch's inputs as (B, S, D) in the compute dtype: its
    ``frontend_embeds`` (B, F, D) and the embedding rows of its ``tokens``
    (B, S_text), either or both; with both, [frontend | text] along the
    sequence."""
    parts = []
    if "frontend_embeds" in batch:
        parts.append(batch["frontend_embeds"].to(cfg.comp_dtype))
    if batch.get("tokens") is not None:
        parts.append(params.embed[batch["tokens"].long()].to(cfg.comp_dtype))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def _logits(params: Transformer, cfg: ModelConfig,
            x: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    return x @ Q.cast(params.head(), x.dtype)


def _ffn(layer: Block, x: torch.Tensor, cfg: ModelConfig,
         positions: torch.Tensor | None = None) -> torch.Tensor:
    """A serving step's FFN: the MLP, or the MoE's prefill dispatch over
    ``positions`` (its decode dispatch when None); the MoE aux is dropped,
    as the reference's serving path drops it."""
    f = getattr(layer, "ffn", None)
    if isinstance(f, moe.MoE):
        if positions is None:
            return moe.moe_decode_block(f, x, cfg)[0]
        return moe.moe_prefill_block(f, x, cfg, positions)[0]
    return x if f is None else ffn.mlp_block(f, x, cfg)


def run_layers(layers: nn.ModuleList, x: torch.Tensor, cfg: ModelConfig,
               *, train: bool = False, moe_groups: int = 1
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Every layer's full-sequence block over x (B,S,D), in layer order: the
    counterpart of the JAX ``_run_stage`` over all stages (attention at
    positions 0..S-1, no cache; the recurrences from a zero state; MoE
    layers through ``moe_block`` in ``moe_groups`` groups).  Returns (x,
    the MoE layers' aux losses summed in f32, 0 without MoE layers).
    ``train=True`` attends through ``attention.chunked_attention``,
    differentiable by autograd (the other mixers and the FFNs are plain
    PyTorch either way)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer, (mixer, f) in zip(layers, cfg.layer_plan()):
        if mixer in ATTN:
            x = attention.attn_block(layer.mixer, x, cfg,
                                     local=(mixer == "attn_local"),
                                     train=train)
        elif mixer == "rglru":
            x = rglru.rglru_block(layer.mixer, x, cfg)
        else:
            x = ssm.ssd_block(layer.mixer, x, cfg)
        if f == "moe":
            x, a = moe.moe_block(layer.ffn, x, cfg, groups=moe_groups)
            aux = aux + a
        elif f == "mlp":
            x = ffn.mlp_block(layer.ffn, x, cfg)
    return x, aux


def forward(params: Transformer, cfg: ModelConfig, batch: dict, *,
            train: bool = False,
            moe_groups: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> (logits (B,S,V), moe_aux): the MoE layers'
    aux losses summed in f32 (0 without MoE layers)."""
    x, aux = run_layers(params.layers, embed_inputs(params, cfg, batch), cfg,
                        train=train, moe_groups=moe_groups)
    return _logits(params, cfg, x), aux


def loss_fn(params: Transformer, cfg: ModelConfig, batch: dict, *,
            aux_coef: float = 0.01,
            moe_groups: int = 1) -> tuple[torch.Tensor, dict]:
    """Next-token (for an encoder, masked-unit) cross entropy over the
    training forward: logsumexp - gold logit under ``loss_mask``, in f32.
    Frontend positions carry no labels: the logits cover [frontend |
    text] and the labels the text (llava-next), or every frame (hubert),
    so the logits are cut to the labels' last positions.  Returns (loss,
    metrics {nll, moe_aux, tokens}), the metrics detached; ``aux_coef``
    weighs the MoE aux loss into the loss.  The reference takes the gold
    logit with an iota compare (a gather on a vocab-sharded dim would
    all-gather the logits); on one device a gather is the same number."""
    logits, aux = forward(params, cfg, batch, train=True,
                          moe_groups=moe_groups)
    labels = batch["labels"].long()
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    if logits.shape[1] != labels.shape[1]:
        logits = logits[:, logits.shape[1] - labels.shape[1]:]
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, labels[..., None])[..., 0]
    nll = (lse - gold) * mask
    denom = mask.sum().clamp_min(1.0)
    loss = nll.sum() / denom + aux_coef * aux
    metrics = {"nll": (nll.sum() / denom).detach(), "moe_aux": aux.detach(),
               "tokens": mask.sum()}
    return loss, metrics


def prefill(params: Transformer, cfg: ModelConfig, tokens: torch.Tensor,
            cache: list, positions: torch.Tensor, *,
            continuation: bool = False,
            check: bool = True) -> tuple[torch.Tensor, list]:
    """Absorb a whole span in one pass, filling every layer cache in place.

    tokens (B,S); positions (B,S) int32 absolute positions (negative = inert
    bucket padding), identical across the batch: the attention reads one
    position row for the whole batch.  ``continuation=False`` (cold): a
    freshly initialised cache and a LEFT-padded span starting at position
    0, the same row for every batch row by construction.
    ``continuation=True`` (warm): a RIGHT-padded span absorbed into an
    already-filled cache at offset positions, whose rows must agree (one
    check per call, not per layer; ``check=False`` skips it for a caller
    that checked already: the check reads the positions on the host, which
    a captured prefill cannot do); attention then reads the whole cache.
    Returns (logits (B,S,V), cache)."""
    if continuation and check:
        check_positions(positions)
    x = embed_inputs(params, cfg, {"tokens": tokens})
    for layer, c, (mixer, _) in zip(params.layers, cache, cfg.layer_plan()):
        if mixer in ATTN:
            x, _ = attention.attn_prefill(layer.mixer, x, c, positions, cfg,
                                          local=(mixer == "attn_local"),
                                          continuation=continuation)
        else:
            fn = rglru.rglru_prefill if mixer == "rglru" else ssm.ssd_prefill
            x, _ = fn(layer.mixer, x, c, positions, cfg,
                      continuation=continuation)
        x = _ffn(layer, x, cfg, positions)
    return _logits(params, cfg, x), cache


def check_positions(positions: torch.Tensor) -> None:
    """Raise unless every batch row of ``positions`` is the same: one
    position row serves the whole batch (the reference reads row 0's).
    Reads the positions on the host."""
    if positions.shape[0] > 1 and not torch.equal(
            positions, positions[:1].expand_as(positions)):
        raise ValueError("prefill needs the same positions in every batch "
                         "row (sessions of one batch advance together)")


def _state_decode(layer: Block, x: torch.Tensor, state, cfg: ModelConfig,
                  mixer: str) -> torch.Tensor:
    """One recurrent decode step on ``state``, in place."""
    fn = rglru.rglru_decode if mixer == "rglru" else ssm.ssd_decode
    return fn(layer.mixer, x, state, cfg)[0]


def decode_step(params: Transformer, cfg: ModelConfig, tokens: torch.Tensor,
                cache: list, index: torch.Tensor) -> tuple[torch.Tensor, list]:
    """tokens (B,1); index (B,) int32 positions -> (logits (B,1,V), cache),
    the cache updated in place."""
    x = embed_inputs(params, cfg, {"tokens": tokens})
    for layer, c, (mixer, _) in zip(params.layers, cache, cfg.layer_plan()):
        if mixer in ATTN:
            x, _ = attention.attn_decode(layer.mixer, x, c, index, cfg,
                                         local=(mixer == "attn_local"))
        else:
            x = _state_decode(layer, x, c, cfg, mixer)
        x = _ffn(layer, x, cfg)
    return _logits(params, cfg, x), cache


# ---------------------------------------------------------------------------
# Paged block pool
# ---------------------------------------------------------------------------

def is_paged(cache) -> bool:
    """True for the paged cache dict ``{"layers", "table", "rows",
    "cut"}``."""
    return isinstance(cache, dict)


def _kv_pools(layers: list) -> list:
    return [p for p in layers if isinstance(p, attention.KVPool)]


def _state_pools(layers: list) -> list:
    return [p for p in layers if isinstance(p, STATE_TYPES)]


def cache_is_quantized(cache) -> bool:
    """True when a paged cache's KV pools carry scales (int8/fp8 storage)."""
    return any(c.k_scale is not None for c in _kv_pools(cache["layers"]))


def paged_cache(layers: list, table: torch.Tensor,
                rows: torch.Tensor) -> dict:
    """One dispatch's paged cache: the engine-wide pools, this dispatch's
    block tables (B, nb) and state-row ids (B,), int32 on the pools'
    device, uploaded once per dispatch.  ``layer_table`` caches each
    window-cut table here, so a dispatch cuts and copies it once."""
    return {"layers": layers, "table": table, "rows": rows, "cut": {}}


def init_block_pool(cfg: ModelConfig, n_blocks: int, block_len: int,
                    n_rows: int, cache_quant: str | None = None,
                    device=None) -> list:
    """One entry per layer: an ``attention.KVPool`` of ``n_blocks`` blocks
    (+ the sink block) for an attention layer; for a recurrent layer its
    state type over ``n_rows`` rows + a sink row (row ``n_rows``, where
    the writes of empty serve slots land), the same leaves as a
    batch-(n_rows + 1) monolithic state.  ``cache_quant`` quantizes the KV
    blocks only: state rows keep the monolithic state's dtypes (f32
    recurrences; a requantized recurrence would drift)."""
    return [attention.init_paged_kv(cfg, n_blocks, block_len, cache_quant,
                                    device=device)
            if mixer in ATTN else _init_state(cfg, mixer, n_rows + 1, device)
            for mixer, _ in cfg.layer_plan()]


def _local_nb(cfg: ModelConfig, nb: int, block_len: int, mixer: str) -> int:
    """Blocks a layer's slot-linear view spans: the full table, clamped to
    the window for local-attention layers (the engine checks that
    block_len divides the window)."""
    if mixer == "attn_local" and cfg.window is not None:
        return min(nb, max(cfg.window // block_len, 1))
    return nb


def layer_table(cfg: ModelConfig, cache: dict, mixer: str) -> torch.Tensor:
    """The dispatch's table cut to an attention layer's view, contiguous;
    cut once per dispatch and reused by every layer and step.  The cut
    lives in the dispatch's own dict, so a captured dispatch cuts its
    staged table inside the graph, anew on every replay."""
    table = cache["table"]
    L = _kv_pools(cache["layers"])[0].k.shape[1]
    nbl = _local_nb(cfg, table.shape[1], L, mixer)
    if nbl == table.shape[1]:
        return table
    cut = cache["cut"].get(nbl)
    if cut is None:
        cut = cache["cut"][nbl] = table[:, :nbl].contiguous()
    return cut


def _row_ids(cache: dict, pool) -> torch.Tensor:
    """The dispatch's state-row ids as gather/scatter indices: a sentinel
    (>= n_rows, an empty serve slot) becomes the pool's sink row."""
    return cache["rows"].long().clamp(0, pool[0].shape[0] - 1)


def _gather_rows(cache: dict, pool):
    """A batch-B state holding the dispatch's rows of ``pool`` (a copy)."""
    ids = _row_ids(cache, pool)
    return type(pool)(*(t.index_select(0, ids) for t in pool))


def _scatter_rows(cache: dict, pool, state) -> None:
    """Write a batch-B state into the dispatch's rows of ``pool``, in
    place; sentinel rows write the sink."""
    ids = _row_ids(cache, pool)
    for t, v in zip(pool, state):
        t.index_copy_(0, ids, v.to(t.dtype))


def paged_gather(cfg: ModelConfig, cache: dict) -> list:
    """The slot-linear MONOLITHIC view of a paged cache: per attention
    layer a (B, nb*L) ``KVCache`` gathered through the (window-cut) table,
    dequantized to ``cfg.dtype``; per recurrent layer the dispatch's state
    rows.  With the same writes applied it equals what ``init_cache`` would
    hold, so the unchanged monolithic prefill and decode run on it (the
    gather path)."""
    return [attention.paged_view(pool, layer_table(cfg, cache, mixer),
                                 cfg.dtype)
            if mixer in ATTN else _gather_rows(cache, pool)
            for pool, (mixer, _) in zip(cache["layers"], cfg.layer_plan())]


def paged_scatter_back(cfg: ModelConfig, cache: dict, lin: list,
                       lo: torch.Tensor, hi: torch.Tensor) -> list:
    """Write a dispatch's results back into the pools in place: the blocks
    covering positions [lo, hi) per row (``attention.paged_scatter_blocks``
    — shared prefix blocks are never touched) and the state rows.
    Sentinel entries write to the sink."""
    for pool, view, (mixer, _) in zip(cache["layers"], lin,
                                      cfg.layer_plan()):
        if mixer not in ATTN:
            _scatter_rows(cache, pool, view)
            continue
        win = cfg.window if mixer == "attn_local" else None
        attention.paged_scatter_blocks(
            pool, layer_table(cfg, cache, mixer), view, lo, hi, window=win)
    return cache["layers"]


def _block_ids(ids, device) -> torch.Tensor:
    return torch.as_tensor(ids, dtype=torch.long, device=device)


def reset_blocks(cfg: ModelConfig, layers: list, ids) -> list:
    """Re-initialise pool blocks ``ids`` in every KV pool, in place: k/v
    and scales 0, pos -1.  O(len(ids)).  State rows are untouched."""
    for pool in _kv_pools(layers):
        i = _block_ids(ids, pool.k.device)
        for t in pool:
            if t is not None:
                attention.raw(t)[i] = -1 if t is pool.pos else 0
    return layers


def copy_blocks(cfg: ModelConfig, layers: list, src, dst) -> list:
    """Copy pool blocks ``src`` -> ``dst`` in every KV pool, in place (the
    copy-on-write copy); scales travel with their blocks."""
    for pool in _kv_pools(layers):
        s = _block_ids(src, pool.k.device)
        d = _block_ids(dst, pool.k.device)
        for t in pool:
            if t is not None:
                r = attention.raw(t)
                r[d] = r[s]
    return layers


def reset_rows(cfg: ModelConfig, layers: list, ids) -> list:
    """Zero state rows ``ids`` in every state pool, in place
    (``index_fill_``): a fresh row equals ``init_cache``'s zero state."""
    for pool in _state_pools(layers):
        i = _block_ids(ids, pool[0].device)
        for t in pool:
            t.index_fill_(0, i, 0)
    return layers


def copy_rows(cfg: ModelConfig, layers: list, src, dst) -> list:
    """Copy state rows ``src`` -> ``dst`` in every state pool, in place
    (``index_copy_``).  State rows are rewritten every decode step, so a
    forked session gets its own copy instead of a shared reference."""
    for pool in _state_pools(layers):
        s = _block_ids(src, pool[0].device)
        d = _block_ids(dst, pool[0].device)
        for t in pool:
            t.index_copy_(0, d, t.index_select(0, s))
    return layers


def paged_decode_carry(cfg: ModelConfig, cache: dict, steps: int) -> list:
    """Per attention layer an O(B * steps) delta write buffer
    (``attention.init_decode_delta``): a dispatch's decode writes, kept out
    of the pool until ``paged_scatter_decode``; per recurrent layer the
    dispatch's state rows, gathered here and carried through the steps.
    Made on the table's device without a host sync: inside a captured
    dispatch the capture allocates them and every replay refills them."""
    B = cache["table"].shape[0]
    dev = cache["table"].device
    return [attention.init_decode_delta(cfg, B, steps, device=dev)
            if mixer in ATTN else _gather_rows(cache, pool)
            for pool, (mixer, _) in zip(cache["layers"], cfg.layer_plan())]


def paged_decode_step(params: Transformer, cfg: ModelConfig,
                      tokens: torch.Tensor, cache: dict, delta: list,
                      index: torch.Tensor, t: int,
                      p0: torch.Tensor) -> tuple[torch.Tensor, list]:
    """Block-table ``decode_step``: tokens (B,1), index (B,) -> (logits
    (B,1,V), delta).  Attention reads each pool in place through the table
    (``attention.attn_decode_paged``) and writes the step's K/V into delta
    row ``t``; a recurrent layer runs the monolithic decode on its carried
    state rows; both in place."""
    x = embed_inputs(params, cfg, {"tokens": tokens})
    for layer, pool, d, (mixer, _) in zip(params.layers, cache["layers"],
                                          delta, cfg.layer_plan()):
        if mixer in ATTN:
            x, _ = attention.attn_decode_paged(
                layer.mixer, x, pool, layer_table(cfg, cache, mixer), d,
                index, t, p0, cfg, local=(mixer == "attn_local"))
        else:
            x = _state_decode(layer, x, d, cfg, mixer)
        x = _ffn(layer, x, cfg)
    return _logits(params, cfg, x), delta


def paged_scatter_decode(cfg: ModelConfig, cache: dict, delta: list,
                         p0: torch.Tensor) -> list:
    """End-of-dispatch writeback, in place: each attention layer's delta
    rows into their pool slots through the table
    (``attention.paged_scatter_delta``), each recurrent layer's carried
    state into its rows.  The pools then equal the gather path's
    ``paged_scatter_back``."""
    for pool, d, (mixer, _) in zip(cache["layers"], delta, cfg.layer_plan()):
        if mixer not in ATTN:
            _scatter_rows(cache, pool, d)
            continue
        win = cfg.window if mixer == "attn_local" else None
        attention.paged_scatter_delta(
            pool, layer_table(cfg, cache, mixer), d, p0, window=win)
    return cache["layers"]
