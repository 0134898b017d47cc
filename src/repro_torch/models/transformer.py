"""Dense GQA decoder: embeddings -> layers -> LM head (PyTorch).

Mirrors the dense path of ``repro/models/transformer.py``.  The JAX package
scans stacked stage parameters; here the layers are an ``nn.ModuleList`` in
layer order and each parameter keeps its JAX layout, so converting a JAX
parameter tree is a copy (``repro_torch.convert``).  Only the attention +
MLP block of the four gateway tiers is ported; other mixers raise.

The functions keep the JAX signatures with the model in the ``params``
slot.  ``forward`` runs the full-sequence path (``run_layers``, shared with
the safety encoder), through the kernels for inference or, with
``train=True``, through ``attention.chunked_attention`` for autograd
(``loss_fn``, the training loss); ``prefill`` and ``decode_step`` write the
KV cache in place.  Parameters are created without ``requires_grad``; a
training step turns it on for the step's own backward only
(``training/train.py::value_and_grad``), so the weights it hands to serving
are frozen as before.

The paged block pool (``serving/cache_manager.py`` owns the allocator) is a
list of one ``attention.KVPool`` per layer, and a dispatch sees it as the
dict ``paged_cache(layers, table)``.  The JAX package keeps
repeat-stacked pools and folds a ``layer * N`` offset into its block ids;
the port's per-layer list has no such offset.  The port's mixers are
attention only, so the pool holds no recurrent-state rows and the
reference's ``reset_rows`` / ``copy_rows`` have no counterpart.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention, ffn
from repro_torch.models.common import ModelConfig, frozen_zeros, rmsnorm


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.mixer = attention.Attention(cfg, device)
        self.ffn = ffn.MLP(cfg, device)


class Transformer(nn.Module):
    """Zero-filled parameters; fill them with ``init_params`` or
    ``convert.from_jax_params``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        for kind in cfg.layer_plan():
            if kind not in (("attn", "mlp"), ("attn_local", "mlp")):
                raise NotImplementedError(
                    f"{cfg.name}: layer kind {kind} is not ported yet "
                    "(dense attention + MLP only)")
        self.cfg = cfg
        D, V = cfg.d_model, cfg.vocab_size
        z = dict(dtype=cfg.dtype, device=device)
        self.embed = frozen_zeros(V, D, **z)
        self.final_norm = frozen_zeros(D, **z)
        self.layers = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.num_layers))
        if not cfg.tie_embeddings:
            self.lm_head = frozen_zeros(D, V, **z)

    def head(self) -> torch.Tensor:
        """(D, V): the tied ``embed.T`` or the untied ``lm_head``."""
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


def init_weights(model: nn.Module, cfg: ModelConfig,
                 generator: torch.Generator) -> nn.Module:
    """Fill ``model`` in place with the JAX init distribution: normal(0.02)
    drawn in f32 then cast, ``wo``/``w_down`` at 0.02/sqrt(2L), norms and
    biases 0.  Shared by every module built on the ``Transformer`` body
    (the safety classifier too)."""
    std_o = 0.02 / (2 * cfg.num_layers) ** 0.5
    gdev = generator.device
    with torch.no_grad():
        for name, prm in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("norm", "final_norm", "bq", "bk", "bv", "head_b"):
                continue                                   # zeros
            std = std_o if leaf in ("wo", "w_down") else 0.02
            w = torch.randn(prm.shape, generator=generator, device=gdev,
                            dtype=torch.float32) * std
            prm.copy_(w.to(cfg.dtype))
    return model


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> list[attention.KVCache]:
    """One ``KVCache`` per layer: k/v zeros, pos -1."""
    return [attention.init_kv_cache(cfg, batch, max_len,
                                    local=(mixer == "attn_local"),
                                    device=device)
            for mixer, _ in cfg.layer_plan()]


def grow_cache(cfg: ModelConfig, cache: list, batch: int, new_len: int,
               device=None) -> list:
    """A copy of every layer cache at ``new_len`` slots (>= the current
    length): the old slots copied in, the new ones empty (k/v 0, pos -1).
    Window-clamped ring caches that keep their size pass through."""
    out = []
    for tmpl, c in zip(init_cache(cfg, batch, new_len, device=device),
                       cache):
        if tmpl.k.shape == c.k.shape:
            out.append(c)
            continue
        T = c.k.shape[1]
        for t, old in zip(tmpl, c):
            t[:, :T].copy_(old)
        out.append(tmpl)
    return out


def embed_inputs(params: Transformer, cfg: ModelConfig,
                 batch: dict) -> torch.Tensor:
    """batch["tokens"] (B,S) -> (B,S,D) in the compute dtype."""
    return params.embed[batch["tokens"].long()].to(cfg.comp_dtype)


def _logits(params: Transformer, cfg: ModelConfig,
            x: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    return x @ params.head().to(x.dtype)


def run_layers(layers: nn.ModuleList, x: torch.Tensor, cfg: ModelConfig,
               *, train: bool = False) -> torch.Tensor:
    """Every layer's full-sequence block over x (B,S,D), in layer order: the
    counterpart of the JAX ``_run_stage`` over all stages (attention at
    positions 0..S-1, no cache).  ``train=True`` attends through
    ``attention.chunked_attention``, differentiable by autograd."""
    for layer, (mixer, _) in zip(layers, cfg.layer_plan()):
        x = attention.attn_block(layer.mixer, x, cfg,
                                 local=(mixer == "attn_local"), train=train)
        x = ffn.mlp_block(layer.ffn, x, cfg)
    return x


def forward(params: Transformer, cfg: ModelConfig, batch: dict, *,
            train: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> (logits (B,S,V), moe_aux = 0)."""
    tokens = batch["tokens"]
    x = run_layers(params.layers, embed_inputs(params, cfg, batch), cfg,
                   train=train)
    return (_logits(params, cfg, x),
            torch.zeros((), dtype=torch.float32, device=tokens.device))


def loss_fn(params: Transformer, cfg: ModelConfig, batch: dict, *,
            aux_coef: float = 0.01) -> tuple[torch.Tensor, dict]:
    """Next-token cross entropy over the training forward: logsumexp -
    gold logit under ``loss_mask``, in f32.  Returns (loss, metrics
    {nll, moe_aux, tokens}), the metrics detached.  The reference takes
    the gold logit with an iota compare (a gather on a vocab-sharded dim
    would all-gather the logits); on one device a gather is the same
    number."""
    logits, aux = forward(params, cfg, batch, train=True)
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
            continuation: bool = False) -> tuple[torch.Tensor, list]:
    """Absorb a whole span in one pass, filling every layer cache in place.

    tokens (B,S); positions (B,S) int32 absolute positions (negative = inert
    bucket padding), identical across the batch: the attention reads one
    position row for the whole batch.  ``continuation=False`` (cold): a
    freshly initialised cache and a LEFT-padded span starting at position
    0, the same row for every batch row by construction.
    ``continuation=True`` (warm): a RIGHT-padded span absorbed into an
    already-filled cache at offset positions, whose rows must agree (one
    check per call, not per layer); attention then reads the whole cache.
    Returns (logits (B,S,V), cache)."""
    if continuation and positions.shape[0] > 1 and not torch.equal(
            positions, positions[:1].expand_as(positions)):
        raise ValueError("prefill needs the same positions in every batch "
                         "row (sessions of one batch advance together)")
    x = embed_inputs(params, cfg, {"tokens": tokens})
    for layer, c, (mixer, _) in zip(params.layers, cache, cfg.layer_plan()):
        x, _ = attention.attn_prefill(layer.mixer, x, c, positions, cfg,
                                      local=(mixer == "attn_local"),
                                      continuation=continuation)
        x = ffn.mlp_block(layer.ffn, x, cfg)
    return _logits(params, cfg, x), cache


def decode_step(params: Transformer, cfg: ModelConfig, tokens: torch.Tensor,
                cache: list, index: torch.Tensor) -> tuple[torch.Tensor, list]:
    """tokens (B,1); index (B,) int32 positions -> (logits (B,1,V), cache),
    the cache updated in place."""
    x = embed_inputs(params, cfg, {"tokens": tokens})
    for layer, c, (mixer, _) in zip(params.layers, cache, cfg.layer_plan()):
        x, _ = attention.attn_decode(layer.mixer, x, c, index, cfg,
                                     local=(mixer == "attn_local"))
        x = ffn.mlp_block(layer.ffn, x, cfg)
    return _logits(params, cfg, x), cache


# ---------------------------------------------------------------------------
# Paged block pool
# ---------------------------------------------------------------------------

def is_paged(cache) -> bool:
    """True for the paged cache dict ``{"layers", "table", "cut"}``."""
    return isinstance(cache, dict)


def cache_is_quantized(cache) -> bool:
    """True when a paged cache's pools carry scales (int8/fp8 storage)."""
    return any(c.k_scale is not None for c in cache["layers"])


def paged_cache(layers: list, table: torch.Tensor) -> dict:
    """One dispatch's paged cache: the engine-wide pools and this
    dispatch's block tables (B, nb), int32 on the pools' device, uploaded
    once per dispatch.  ``layer_table`` caches each window-cut table here,
    so a dispatch cuts and copies it once."""
    return {"layers": layers, "table": table, "cut": {}}


def init_block_pool(cfg: ModelConfig, n_blocks: int, block_len: int,
                    cache_quant: str | None = None, device=None) -> list:
    """One ``attention.KVPool`` per layer."""
    return [attention.init_paged_kv(cfg, n_blocks, block_len, cache_quant,
                                    device=device)
            for _ in cfg.layer_plan()]


def _local_nb(cfg: ModelConfig, nb: int, block_len: int, mixer: str) -> int:
    """Blocks a layer's slot-linear view spans: the full table, clamped to
    the window for local-attention layers (the engine checks that
    block_len divides the window)."""
    if mixer == "attn_local" and cfg.window is not None:
        return min(nb, max(cfg.window // block_len, 1))
    return nb


def layer_table(cfg: ModelConfig, cache: dict, mixer: str) -> torch.Tensor:
    """The dispatch's table cut to a layer's view, contiguous; cut once per
    dispatch and reused by every layer and step."""
    table = cache["table"]
    L = cache["layers"][0].k.shape[1]
    nbl = _local_nb(cfg, table.shape[1], L, mixer)
    if nbl == table.shape[1]:
        return table
    cut = cache["cut"].get(nbl)
    if cut is None:
        cut = cache["cut"][nbl] = table[:, :nbl].contiguous()
    return cut


def paged_gather(cfg: ModelConfig, cache: dict) -> list:
    """The slot-linear MONOLITHIC view of a paged cache: per layer a
    (B, nb*L) ``KVCache`` gathered through the (window-cut) table,
    dequantized to ``cfg.dtype``.  With the same writes applied it equals
    what ``init_cache`` would hold, so the unchanged monolithic prefill and
    decode run on it (the gather path)."""
    return [attention.paged_view(pool, layer_table(cfg, cache, mixer),
                                 cfg.dtype)
            for pool, (mixer, _) in zip(cache["layers"], cfg.layer_plan())]


def paged_scatter_back(cfg: ModelConfig, cache: dict, lin: list,
                       lo: torch.Tensor, hi: torch.Tensor) -> list:
    """Write a dispatch's results back into the pools in place: the blocks
    covering positions [lo, hi) per row (``attention.paged_scatter_blocks``
    — shared prefix blocks are never touched).  Sentinel entries write to
    the sink."""
    for pool, view, (mixer, _) in zip(cache["layers"], lin,
                                      cfg.layer_plan()):
        win = cfg.window if mixer == "attn_local" else None
        attention.paged_scatter_blocks(
            pool, layer_table(cfg, cache, mixer), view, lo, hi, window=win)
    return cache["layers"]


def _block_ids(ids, device) -> torch.Tensor:
    return torch.as_tensor(ids, dtype=torch.long, device=device)


def reset_blocks(cfg: ModelConfig, layers: list, ids) -> list:
    """Re-initialise pool blocks ``ids`` in every pool, in place: k/v and
    scales 0, pos -1.  O(len(ids))."""
    for pool in layers:
        i = _block_ids(ids, pool.k.device)
        for t in pool:
            if t is not None:
                attention.raw(t)[i] = -1 if t is pool.pos else 0
    return layers


def copy_blocks(cfg: ModelConfig, layers: list, src, dst) -> list:
    """Copy pool blocks ``src`` -> ``dst`` in every pool, in place (the
    copy-on-write copy); scales travel with their blocks."""
    for pool in layers:
        s = _block_ids(src, pool.k.device)
        d = _block_ids(dst, pool.k.device)
        for t in pool:
            if t is not None:
                r = attention.raw(t)
                r[d] = r[s]
    return layers


def paged_decode_carry(cfg: ModelConfig, cache: dict, steps: int) -> list:
    """Per layer an O(B * steps) delta write buffer
    (``attention.init_decode_delta``): a dispatch's decode writes, kept out
    of the pool until ``paged_scatter_decode``."""
    B = cache["table"].shape[0]
    dev = cache["table"].device
    return [attention.init_decode_delta(cfg, B, steps, device=dev)
            for _ in cache["layers"]]


def paged_decode_step(params: Transformer, cfg: ModelConfig,
                      tokens: torch.Tensor, cache: dict, delta: list,
                      index: torch.Tensor, t: int,
                      p0: torch.Tensor) -> tuple[torch.Tensor, list]:
    """Block-table ``decode_step``: tokens (B,1), index (B,) -> (logits
    (B,1,V), delta).  Attention reads each pool in place through the table
    (``attention.attn_decode_paged``); the step's K/V go into delta row
    ``t`` of each layer, in place."""
    x = embed_inputs(params, cfg, {"tokens": tokens})
    for layer, pool, d, (mixer, _) in zip(params.layers, cache["layers"],
                                          delta, cfg.layer_plan()):
        x, _ = attention.attn_decode_paged(
            layer.mixer, x, pool, layer_table(cfg, cache, mixer), d, index,
            t, p0, cfg, local=(mixer == "attn_local"))
        x = ffn.mlp_block(layer.ffn, x, cfg)
    return _logits(params, cfg, x), delta


def paged_scatter_decode(cfg: ModelConfig, cache: dict, delta: list,
                         p0: torch.Tensor) -> list:
    """End-of-dispatch writeback: each layer's delta rows into their pool
    slots through the table (``attention.paged_scatter_delta``), in place.
    The pools then equal the gather path's ``paged_scatter_back``."""
    for pool, d, (mixer, _) in zip(cache["layers"], delta, cfg.layer_plan()):
        win = cfg.window if mixer == "attn_local" else None
        attention.paged_scatter_delta(
            pool, layer_table(cfg, cache, mixer), d, p0, window=win)
    return cache["layers"]
