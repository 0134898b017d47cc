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

On a mesh a rank holds the shard ``shard_params`` cut for it: each module
whose dim was cut (attention's heads, the MLP's d_ff, the RG-LRU's width,
the SSD's heads, the MoE's experts) carries a ``sharding.Split`` as
``.tp`` and sums its row-parallel product, gathers its operand or joins
its experts' rows over the mesh axes, and a model whose vocabulary was
cut looks its tokens up vocabulary-parallel and gathers its logits in
``forward`` and the loss (``_embed``, ``_logits``); the serving steps
``prefill``, ``decode_step`` and ``paged_decode_step`` return the rank's
vocabulary columns, which the engine samples and probes
vocabulary-parallel.  An attention layer whose KV heads
'model' cannot take keeps them whole and cuts its cache's slots
(``models/attention.py``, "Sequence-sharded caches").
Without a ``.tp`` nothing crosses a mesh: a (1, 1) mesh, and every model
off a mesh, computes as one device does.

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

import dataclasses
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.distributed import sharding as sh
from repro_torch.models import attention, ffn, moe, rglru, ssm
from repro_torch.models import quant as Q
from repro_torch.models.common import (ModelConfig, RankConfig,
                                       frozen_zeros, rmsnorm, shallow_copy)

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
    ``convert.from_jax_params``.  A rank's shard on a mesh comes from
    ``shard_params``."""

    #: each parameter's logical axes, as the reference's ``model_defs``
    #: tags them (``distributed/sharding.py``)
    AXES = {"embed": ("vocab", "embed"), "final_norm": ("norm",),
            "lm_head": ("embed", "vocab")}

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
        if isinstance(tmpl, attention.SeqKVCache) or isinstance(
                c, attention.SeqKVCache):
            raise ValueError("a sequence-sharded cache grows through its "
                             "whole view (its slots move between ranks)")
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
        parts.append(_embed(params, batch["tokens"]).to(cfg.comp_dtype))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def _embed(params: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows of ``tokens``.  Vocabulary-parallel on a mesh
    (``shard_params``): a rank holds rows [start, start + size), looks up
    the tokens in its range and writes zeros for the rest, and the rows are
    summed over the axes the vocabulary was cut over.  Exactly one rank
    adds a nonzero row, so the sum is exact."""
    tokens = tokens.long()
    tp = getattr(params, "tp", None)
    if tp is None:
        return params.embed[tokens]
    local = tokens - tp.start
    mine = (local >= 0) & (local < tp.size)
    rows = params.embed[local.clamp(0, tp.size - 1)]
    return tp.reduce(rows * mine[..., None].to(rows.dtype))


def _head(params: Transformer, cfg: ModelConfig,
          x: torch.Tensor) -> torch.Tensor:
    """Final norm and head: on a vocabulary-parallel shard, the logits of
    the rank's vocabulary range only."""
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    return x @ Q.cast(params.head(), x.dtype)


def _logits(params: Transformer, cfg: ModelConfig,
            x: torch.Tensor) -> torch.Tensor:
    """``_head`` with a vocabulary-parallel shard's columns gathered along
    the last dim into whole rows (``forward`` and the loss)."""
    out = _head(params, cfg, x)
    tp = getattr(params, "tp", None)
    return out if tp is None else tp.gather(out, -1)


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


def _layer(layer: Block, x: torch.Tensor, cfg: ModelConfig, mixer: str,
           f: str, train: bool, moe_groups: int):
    """One layer's full-sequence block -> (x, its MoE aux or None), its
    FSDP leaves joined first (``sharding.gathered``)."""
    layer = sh.gathered(layer)
    if mixer in ATTN:
        x = attention.attn_block(layer.mixer, x, cfg,
                                 local=(mixer == "attn_local"), train=train)
    elif mixer == "rglru":
        x = rglru.rglru_block(layer.mixer, x, cfg)
    else:
        x = ssm.ssd_block(layer.mixer, x, cfg)
    if f == "moe":
        return moe.moe_block(layer.ffn, x, cfg, groups=moe_groups)
    if f == "mlp":
        x = ffn.mlp_block(layer.ffn, x, cfg)
    return x, None


class _Remat(torch.autograd.Function):
    """A layer run without keeping its activations and run again in the
    backward: ``forward(ctx, run, x, *leaves)`` calls ``run(x, leaves)`` ->
    (x, aux or None) with no graph; ``backward`` calls it again on
    detached copies that ask for a gradient and differentiates that graph
    (``torch.autograd.grad``), so the gradients go to ``x`` and the leaves
    as the function's own inputs.  The ops, and so the bits, are those of a
    run kept whole; the collectives inside run again in the same order on
    every rank."""

    @staticmethod
    def forward(ctx, run, x, *leaves):
        ctx.run = run
        ctx.save_for_backward(x, *leaves)
        return run(x, leaves)

    @staticmethod
    def backward(ctx, gx, ga):
        x, *leaves = ctx.saved_tensors
        need = ctx.needs_input_grad[1:]
        ins = [t.detach().requires_grad_(n) for t, n in zip([x] + leaves,
                                                             need)]
        with torch.enable_grad():
            y, a = ctx.run(ins[0], ins[1:])
        outs, gouts = ([y], [gx]) if a is None else ([y, a], [gx, ga])
        asked = [t for t in ins if t.requires_grad]
        got = iter(torch.autograd.grad(outs, asked, gouts, allow_unused=True))
        return (None,) + tuple(next(got) if n else None for n in need)


def _remat_layer(layer: Block, x: torch.Tensor, *args):
    """``_layer(layer, x, *args)`` recomputed in the backward (``_Remat``):
    the layer's tensors, as they stand for this call (also where
    ``torch.func.functional_call`` substituted them: ``models/lora.py``),
    are the function's inputs, and each run reads them from a shallow copy
    of the layer whose tables hold the ones it is given."""
    named = list(layer.named_parameters(remove_duplicate=False))
    copy = shallow_copy(layer)
    slots = []
    for name, _ in named:
        *path, leaf = name.split(".")
        m = copy
        for part in path:
            m = m._modules[part]
        slots.append((m._parameters, leaf))

    def run(xi, leaves):
        for (table, leaf), t in zip(slots, leaves):
            table[leaf] = t
        return _layer(copy, xi, *args)

    return _Remat.apply(run, x, *(t for _, t in named))


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
    PyTorch either way); with ``cfg.remat`` and a gradient asked for, each
    layer then keeps none of its activations and is recomputed in the
    backward (``_Remat``), its FSDP gather included (the reference's
    ``jax.checkpoint`` with ``nothing_saveable``)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = train and cfg.remat and torch.is_grad_enabled()
    for layer, (mixer, f) in zip(layers, cfg.layer_plan()):
        if remat:
            # no layer draws random numbers: no RNG state to keep
            x, a = _remat_layer(layer, x, cfg, mixer, f, train, moe_groups)
        else:
            x, a = _layer(layer, x, cfg, mixer, f, train, moe_groups)
        if a is not None:
            aux = aux + a
    return x, aux


def forward(params: Transformer, cfg: ModelConfig, batch: dict, *,
            train: bool = False,
            moe_groups: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> (logits (B,S,V), moe_aux): the MoE layers'
    aux losses summed in f32 (0 without MoE layers)."""
    top = sh.gathered(params, children=False)
    x, aux = run_layers(params.layers, embed_inputs(top, cfg, batch), cfg,
                        train=train, moe_groups=moe_groups)
    return _logits(top, cfg, x), aux


def _vocab_parallel_nll(top: Transformer, cfg: ModelConfig, x: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """(B, S_labels) f32 cross entropy of the rank's vocabulary columns'
    logits, never gathered: the row max is taken over 'model' with no
    gradient, the sum of exponentials is ``reduce``d, and the gold logit
    is the rank's column that matches the label (the reference's
    iota-compare-select), ``reduce``d (one rank holds it)."""
    tp = top.tp
    if bool((labels >= cfg.vocab_size).any()):
        raise IndexError(f"a label outside the vocabulary of "
                         f"{cfg.vocab_size}")
    h = tp.enter(rmsnorm(x, top.final_norm, cfg.norm_eps))
    lf = (h @ Q.cast(top.head(), h.dtype)).float()
    if lf.shape[1] != labels.shape[1]:
        lf = lf[:, lf.shape[1] - labels.shape[1]:]
    m = tp.comm.all_reduce(lf.detach().amax(-1), tp.axes, op="max")
    lse = torch.log(tp.reduce(torch.exp(lf - m[..., None]).sum(-1))) + m
    cols = torch.arange(tp.start, tp.start + tp.size, device=lf.device)
    gold = tp.reduce(torch.where(cols == labels[..., None], lf,
                                 torch.zeros((), device=lf.device)).sum(-1))
    return lse - gold


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
    all-gather the logits); on one device a gather is the same number.

    On a mesh shard (``shard_params``) the batch holds the rank's rows: a
    vocabulary cut over 'model' takes the vocabulary-parallel loss
    (``_vocab_parallel_nll``: the logits are never gathered), the loss is
    the rank's nll sum over the token count of the whole batch (summed over
    the batch axes) plus its MoE aux (its groups' share of the mean,
    ``moe.moe_block``), so that the losses' sum over the batch axes is the
    one device's, and the metrics are the whole batch's."""
    top = sh.gathered(params, children=False)
    ids = batch.get("tokens")
    if getattr(top, "tp", None) is not None and ids is not None and bool(
            (ids >= cfg.vocab_size).any()):
        # one device's lookup raises; a vocabulary-parallel one would read
        # zeros
        raise IndexError(f"a token outside the vocabulary of "
                         f"{cfg.vocab_size}")
    x, aux = run_layers(params.layers, embed_inputs(top, cfg, batch), cfg,
                        train=True, moe_groups=moe_groups)
    labels = batch["labels"].long()
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    if getattr(top, "tp", None) is not None:
        nll = _vocab_parallel_nll(top, cfg, x, labels) * mask
    else:
        logits = _logits(top, cfg, x)
        if logits.shape[1] != labels.shape[1]:
            logits = logits[:, logits.shape[1] - labels.shape[1]:]
        lf = logits.float()
        lse = torch.logsumexp(lf, dim=-1)
        gold = lf.gather(-1, labels[..., None])[..., 0]
        nll = (lse - gold) * mask
    comm = getattr(params, "comm", None)
    dp = () if comm is None else sh.batch_axes(comm.mesh)
    tokens = mask.sum()
    if comm is not None:
        tokens = comm.all_reduce(tokens.detach(), dp)
    denom = tokens.clamp_min(1.0)
    loss = nll.sum() / denom + aux_coef * aux
    nll_s, aux_s = nll.sum().detach(), aux.detach()
    if comm is not None and comm._live(dp):
        nll_s, aux_s = comm.all_reduce(torch.stack([nll_s, aux_s]), dp)
    metrics = {"nll": nll_s / denom, "moe_aux": aux_s, "tokens": tokens}
    return loss, metrics


def prefill(params: Transformer, cfg: ModelConfig, tokens: torch.Tensor,
            cache: list, positions: torch.Tensor, *,
            continuation: bool = False, check: bool = True,
            logits_at: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, list]:
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
    Returns (logits (B,S,V), cache); with ``logits_at`` (k,) int, the logits
    of those columns only (B,k,V): the head multiplies k columns, not all
    S (the engine's prefill reads its last one).  On a vocabulary-parallel
    shard the logits are the rank's vocabulary columns (B,·,V/m), not
    gathered (``_head``)."""
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
    if logits_at is not None:
        x = x.index_select(1, logits_at)
    return _head(params, cfg, x), cache


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
                cache: list, index: torch.Tensor
                ) -> tuple[torch.Tensor, list]:
    """tokens (B,1); index (B,) int32 positions -> (logits (B,1,V), cache),
    the cache updated in place; a vocabulary-parallel shard's logits are
    its columns (B,1,V/m) (``_head``)."""
    x = embed_inputs(params, cfg, {"tokens": tokens})
    for layer, c, (mixer, _) in zip(params.layers, cache, cfg.layer_plan()):
        if mixer in ATTN:
            x, _ = attention.attn_decode(layer.mixer, x, c, index, cfg,
                                         local=(mixer == "attn_local"))
        else:
            x = _state_decode(layer, x, c, cfg, mixer)
        x = _ffn(layer, x, cfg)
    return _head(params, cfg, x), cache


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
                      index: torch.Tensor, t: int, p0: torch.Tensor
                      ) -> tuple[torch.Tensor, list]:
    """Block-table ``decode_step``: tokens (B,1), index (B,) -> (logits
    (B,1,V), delta; a vocabulary-parallel shard's are its columns).  Attention reads each
    pool in place through the table (``attention.attn_decode_paged``) and
    writes the step's K/V into delta row ``t``; a recurrent layer runs the
    monolithic decode on its carried state rows; both in place."""
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
    return _head(params, cfg, x), delta


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


# ---------------------------------------------------------------------------
# Mesh placement
# ---------------------------------------------------------------------------

def param_axes(model: nn.Module) -> dict[str, tuple]:
    """{parameter name: its logical axes}: the reference's ``param_axes``
    under the port's names, read from each module class's ``AXES`` table
    (what ``ParamDef.axes`` carries there).  A ``quant.QTensor`` weight is
    listed by its weight's name (``quant.quantize_param_axes`` splits it
    into payload and scales).  The reference stacks repeated layers under
    a leading "layers" axis, which no rule shards; the port's layers are
    separate modules."""
    out = {}
    for mname, mod in model.named_modules():
        if isinstance(mod, Q.QTensor):
            continue
        names = [n for n, _ in mod.named_parameters(recurse=False)]
        names += [n for n, c in mod.named_children()
                  if isinstance(c, Q.QTensor)]
        for pname in names:
            out[f"{mname}.{pname}" if mname else pname] = \
                type(mod).AXES[pname]
    return out


def cache_axes(cfg: ModelConfig) -> list:
    """The logical axes of ``init_cache``'s tensors, entry for entry (the
    reference's ``cache_axes`` without the repeat axis).  A mesh rank's
    state follows their specs but for an SSD conv tail, whose
    ``act_ssm_inner`` dim holds the rank's x channels and its groups' B/C
    columns (``state_columns``) where the spec would take a contiguous
    cut; a KV cache in case (b) holds the one KV head the rank's query
    heads read (``shard_params``).  A KV cache whose heads the model axes
    cannot take cuts its slots (``act_kv_seq``) as the spec does
    (``attention.init_kv_cache``)."""
    kv = attention.KVCache(
        k=("act_batch", "act_kv_seq", "act_kv_heads", None),
        v=("act_batch", "act_kv_seq", "act_kv_heads", None),
        pos=("act_batch", "act_kv_seq"))
    rg = rglru.RGLRUState(h=("act_batch", "act_ssm_inner"),
                          conv=("act_batch", None, "act_ssm_inner"))
    sd = ssm.SSMState(ssd=("act_batch", "act_heads", None, None),
                      conv=("act_batch", None, "act_ssm_inner"))
    return [kv if mixer in ATTN else rg if mixer == "rglru" else sd
            for mixer, _ in cfg.layer_plan()]


def _leaves(model: nn.Module) -> dict[str, torch.Tensor]:
    """{name: tensor} of a model's weights: its parameters, and each
    ``QTensor`` weight's payload and scales as ``<name>.q`` and
    ``<name>.scale``."""
    out = dict(model.named_parameters())
    for n, m in model.named_modules():
        if isinstance(m, Q.QTensor):
            out[f"{n}.q"], out[f"{n}.scale"] = m.q, m.scale
    return out


#: the logical axes a rank's shard may cut: the tensor-parallel ones, whose
#: products the model sums (row-parallel), gathers (the vocabulary, the
#: RG-LRU's gate input, the router logits) or joins (the experts' rows)
_TP_AXES = ("vocab", "heads", "bias_heads", "kv_heads", "ffn", "ssm_inner",
            "experts")


def shard_params(model: Transformer, cfg: ModelConfig, mesh, comm=None,
                 rules=sh.SERVE_RULES) -> Transformer:
    """This rank's shard of ``model`` on ``mesh``: a new model (``model`` is
    not changed) holding each parameter cut as ``sharding.spec_for`` under
    ``rules`` places it, and a config (a ``common.RankConfig`` where the
    SSD heads are cut) with the rank's ``num_heads``, ``num_kv_heads``,
    ``d_ff``, RG-LRU ``rnn_width`` and SSD heads and groups (the vocabulary
    and the experts' count stay whole: the logits are gathered and the
    routing runs whole).  ``SERVE_RULES`` (the engine's) puts the heads, KV
    heads, QKV biases, d_ff, the recurrent width (``ssm_inner``), the
    experts and the vocabulary over 'model' and replicates the rest; a
    tensor the spec does not cut is shared with ``model``, so a (1, 1) mesh
    copies nothing.  The training rules (``DEFAULT_RULES``, ``SP_RULES``)
    also cut d_model (``embed``) over the batch axes (FSDP): such a leaf is
    joined just before its layer runs (``sharding.gathered``, from
    ``run_layers`` and ``forward``), and its gradient comes back summed over
    the batch axes and cut again.

    Attention takes one of three placements, by the size m of the model
    axes (``attention_placement``):

    (a) m divides H and K: heads and KV heads are split, each rank's G
        unchanged;
    (b) K divides m and m divides H: each rank holds its H/m query heads,
        which read one KV head.  Under ``SERVE_RULES`` the rank holds that
        head only (its wk/wv columns and biases, as Megatron-LM places
        them) and the cache is held by heads; under any other rules it
        holds every KV head's wk/wv, as the spec replicates them, projects
        them whole and keeps its head after the projection (``.kv_pick``),
        so their gradient is whole on every rank and the optimizer state
        matches ``training.train.opt_shardings``;
    (s) any other shape, under ``SERVE_RULES``: the reference's spec.  The
        KV heads (wk, wv and their biases) stay whole on every rank, and
        the KV cache cuts its slots over the model axes where m divides
        them (``attention.SeqKVCache``; the layer gets a
        ``sharding.SeqCut`` as ``.seq``, the config ``kv_seq_shards`` m);
        where m divides H, wq, bq and wo are cut by heads too (``.tp``).

    Under the training rules a shape that is neither (a) nor (b) runs
    attention whole on every rank where m does not divide H, and raises
    ``NotImplementedError`` where it does: the sequence-sharded cache is
    a serving placement.

    The recurrent mixers and the MoE (``models/rglru.py``,
    ``models/ssm.py``, ``models/moe.py``): an RG-LRU holds W/m of its width
    (every ``ssm_inner`` column, w_out's rows); an SSD layer H/m heads, its
    in_proj and conv cut segment by segment (``ssm.rank_columns``), not
    contiguously as the spec would; an MoE E/m experts and their router
    columns, its shared expert cut over d_ff as an MLP, and
    ``.data_shards``, the batch axes' size, over which ``moe_block`` splits
    its groups.  A dim the axes do not divide stays whole (the module runs
    whole on every rank).

    A quantized model (``quant.quantize_params`` of the whole model) is cut
    the same way: a ``QTensor``'s payload like its weight and its row
    scales like the weight minus its trailing dim
    (``quant.quantize_param_axes``), so each rank holds the slices of the
    full quantized tree; rules that cut d_model refuse it (its weights are
    served, not trained).

    Each module whose dim was cut gets a ``sharding.Split`` as ``.tp``
    (attention: wo's heads; the MLP and a shared expert: w_down's d_ff; an
    RG-LRU: its width; an SSD: its heads; an MoE: its experts), and the
    model one when its vocabulary was cut; each module with a leaf cut over
    the batch axes a ``sharding.FSDP`` as ``.fsdp``.  The shard carries
    ``cuts`` ({leaf name: ``sharding.Cut``}: where each of its leaves lies
    in the whole, which the training step and the checkpoints read),
    ``comm`` (a ``sharding.Comm`` of the mesh, made when None, which runs
    every collective) and ``rules``."""
    sh.check_mesh(mesh)
    comm = comm or sh.Comm(mesh)
    axes = Q.quantize_param_axes(param_axes(model), model)
    named = _leaves(model)
    specs = {n: sh.spec_for(p.shape, axes[n], mesh, rules.param_rules)
             for n, p in named.items()}
    sizes = sh.axis_sizes(mesh)
    batch = set(sh.BATCH_AXES)
    # an SSD layer's leaves are cut by its heads below, segment by segment
    ssd_pre = tuple(f"{n}." for n, m in model.named_modules()
                    if isinstance(m, ssm.SSD))
    cuts = {}
    for n, spec in specs.items():
        tp, dp = ((), 0), ((), 0)
        for d, p in enumerate(spec):
            a = sh.axes_of(p)
            if sh._axis_size(sizes, a) == 1:
                continue
            if set(a) <= batch:
                dp = (a, d)
            elif axes[n][d] not in _TP_AXES:
                raise NotImplementedError(
                    f"{n}: its {axes[n][d]!r} dim over {p!r}: only the "
                    "tensor-parallel dims go over 'model'")
            elif not n.startswith(ssd_pre):
                tp = (a, d)
        cuts[n] = sh.Cut(tp_axes=tp[0], tp_dim=tp[1], dp_axes=dp[0],
                         dp_dim=dp[1])
    if any(c.dp_axes for c in cuts.values()):
        Q.refuse_quantized(model, "a shard whose rules cut d_model over the "
                           "batch axes (FSDP)")

    def part(name: str, dim: int):
        spec = specs.get(name, specs.get(name + ".q"))
        p = spec[dim] if dim < len(spec) else None
        return None if p is None or set(sh.axes_of(p)) <= batch else p

    def split(p, size: int) -> sh.Split:
        idx, _ = sh.shard_index(p, mesh)
        return sh.Split(comm, sh.axes_of(p), idx * size, size)

    def cols_cut(name: str, p, dim: int, per_rank) -> None:
        # a cut by columns (SSD segments, case (b)'s KV head): any FSDP cut
        # of the spec stays
        if name in cuts:
            r, _ = sh.shard_index(p, mesh)
            per_rank = tuple(tuple(c) for c in per_rank)
            cuts[name] = dataclasses.replace(
                cuts[name], tp_axes=sh.axes_of(p), tp_dim=dim, cols=per_rank,
                shared=sh.shared_columns(per_rank, r))

    new = shallow_copy(model)
    mods = dict(new.named_modules())
    local = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                 d_ff=cfg.d_ff)
    for i, (layer, (mixer, f)) in enumerate(zip(new.layers,
                                                cfg.layer_plan())):
        pre = f"layers.{i}."
        if mixer in ATTN:
            local.update(_shard_attention(layer.mixer, cfg, pre, part, split,
                                          cols_cut, mesh, comm, rules))
        elif mixer == "rglru":
            wp = part(pre + "mixer.w_in", 1)
            _, m = sh.shard_index(wp, mesh)
            if m > 1:
                W = cfg.rnn_width or cfg.d_model
                layer.mixer.tp = split(wp, W // m)
                local["rnn_width"] = W // m
        else:
            local.update(_shard_ssd(layer.mixer, cfg, pre, part, split,
                                    cols_cut, mesh))
        if f == "mlp":
            fp = part(pre + "ffn.w_up", 1)
            _, n = sh.shard_index(fp, mesh)
            if n > 1:
                local["d_ff"] = cfg.d_ff // n
                layer.ffn.tp = split(fp, cfg.d_ff // n)
        elif f == "moe":
            layer.ffn.data_shards = sh.shard_index(sh.batch_axes(mesh),
                                                   mesh)[1]
            ep = part(pre + "ffn.w_up", 0)
            _, n = sh.shard_index(ep, mesh)
            if n > 1:
                layer.ffn.tp = split(ep, cfg.num_experts // n)
            sp = part(pre + "ffn.shared.w_up", 1)
            _, n = sh.shard_index(sp, mesh)
            if n > 1:
                w = named.get(pre + "ffn.shared.w_up")
                if w is None:                             # a QTensor's
                    w = named[pre + "ffn.shared.w_up.q"]
                fs = w.shape[1]
                layer.ffn.shared.tp = split(sp, fs // n)
    # a cut over axes of size 1 cuts nothing: no Split, so nothing crosses
    # the mesh and the (1, 1) mesh computes as one device does
    vp = part("embed", 0)
    _, n = sh.shard_index(vp, mesh)
    if n > 1:
        new.tp = split(vp, cfg.vocab_size // n)
    with torch.no_grad():
        for name, p in named.items():
            c = cuts[name]
            if not (c.tp_axes or c.dp_axes):
                continue
            mname, _, leaf = name.rpartition(".")
            mod = mods[mname]
            t = c.cut(p, mesh)
            if leaf in mod._parameters:
                mod._parameters[leaf] = nn.Parameter(t, requires_grad=False)
            else:                       # a QTensor's payload or scales
                mod._buffers[leaf] = t
            if c.dp_axes:
                if getattr(mod, "fsdp", None) is None:
                    mod.fsdp = sh.FSDP(comm, {})
                mod.fsdp.leaves[leaf] = (c.dp_dim, c.dp_axes)
    if local.get("ssm_shards", 1) > 1 or local.get("kv_seq_shards", 1) > 1:
        new.cfg = RankConfig.of(cfg, **local)
    else:
        local.pop("ssm_shards", None)
        local.pop("kv_seq_shards", None)
        new.cfg = dataclasses.replace(cfg, **local)
    new.cuts, new.comm, new.rules = cuts, comm, rules
    return new


class Placement(NamedTuple):
    """Attention's placement over model axes of size m
    (``attention_placement``): ``kind`` "" (nothing cut, m = 1), "a", "b",
    "s" (the sequence-sharded cache) or "whole" (training: attention
    whole on every rank), and the rank's query heads, KV heads and
    ``kv_seq_shards`` (``common.RankConfig``)."""
    kind: str
    heads: int
    kv_heads: int
    kv_seq_shards: int = 1


def attention_placement(H: int, K: int, m: int,
                        serve: bool = True) -> Placement:
    """Where ``shard_params`` puts H query heads on K KV heads over model
    axes of size m, under the serving rules or (``serve=False``) the
    training rules; raises ``NotImplementedError`` for the shapes only
    serving places."""
    if m == 1:
        return Placement("", H, K)
    if H % m == 0 and K % m == 0:
        return Placement("a", H // m, K // m)
    if H % m == 0 and m % K == 0:
        return Placement("b", H // m, 1)
    if serve:
        return Placement("s", H // m if H % m == 0 else H, K, m)
    if H % m:
        return Placement("whole", H, K)
    raise NotImplementedError(
        f"{H} heads on {K} KV heads over a {m}-way model axis: training on "
        "a mesh does not take this shape (serving places it with the "
        "sequence-sharded KV cache; the training rules have no such cut)")


def _shard_attention(att, cfg: ModelConfig, pre: str, part, split, cols_cut,
                     mesh, comm, rules) -> dict:
    """Attention's placement (a), (b) or (s) (``shard_params``,
    ``attention_placement``): attaches its ``Split`` (in case (b) narrows
    its KV leaves or sets ``.kv_pick``; in case (s) attaches a ``SeqCut``)
    and returns the rank's head counts and ``kv_seq_shards``."""
    H, K = cfg.num_heads, cfg.num_kv_heads
    hp = part(pre + "mixer.wq", 1)
    seq_axes = sh.kv_seq_axes(mesh, rules)
    m = sh._axis_size(sh.axis_sizes(mesh), seq_axes)
    pl = attention_placement(H, K, m, serve=rules == sh.SERVE_RULES)
    if pl.kind in ("", "whole"):
        return {}
    if pl.kind == "b":
        kv = [s * pl.heads // (H // K) for s in range(m)]
        if rules == sh.SERVE_RULES:
            # the one KV head, a quantized wk/wv's payload and row scales
            # narrowed alike (each scale row is one (d, KV head) row, whole)
            for leaf, dim in (("wk", 1), ("wv", 1), ("bk", 0), ("bv", 0),
                              ("wk.q", 1), ("wk.scale", 1), ("wv.q", 1),
                              ("wv.scale", 1)):
                cols_cut(pre + "mixer." + leaf, hp, dim,
                         [[h] for h in kv])
        else:
            att.kv_pick = kv[sh.shard_index(hp, mesh)[0]]
    elif pl.kind == "s":
        att.seq = sh.SeqCut(comm, seq_axes)
    if hp is not None:                  # the query heads are cut
        att.tp = split(hp, pl.heads)
    out = {"num_heads": pl.heads, "num_kv_heads": pl.kv_heads}
    if pl.kind == "s":
        out["kv_seq_shards"] = m
    return out


#: an SSD layer's leaves cut by its heads: (leaf, dim, how) — "heads" a
#: contiguous cut of H, "inner" of d_inner (the heads' channels), "proj" and
#: "conv" the segment columns of ``ssm.rank_columns``
_SSD_CUTS = (("A_log", 0, "heads"), ("dt_bias", 0, "heads"),
             ("D_skip", 0, "heads"), ("gnorm", 0, "inner"),
             ("out_proj", 0, "inner"), ("in_proj", 1, "proj"),
             ("conv_w", 1, "conv"), ("conv_b", 0, "conv"))


def _shard_ssd(mix, cfg: ModelConfig, pre: str, part, split, cols_cut,
               mesh) -> dict:
    """An SSD layer's heads over the axes its ``A_log`` goes over
    (``"heads"``): every leaf but the norm cut by ``ssm.rank_columns``, or
    left whole when they do not divide H.  Returns the rank's SSD sizes."""
    H = cfg.ssm_nheads
    hp = part(pre + "mixer.A_log", 0)
    r, m = sh.shard_index(hp, mesh)
    if m == 1:
        return {}
    P = cfg.ssm_head_dim
    per = []
    for s in range(m):
        rc = ssm.rank_columns(cfg, s, m)
        per.append({"heads": range(rc.h0, rc.h0 + rc.heads),
                    "inner": range(rc.h0 * P, (rc.h0 + rc.heads) * P),
                    "proj": rc.in_proj, "conv": rc.conv})
    for leaf, dim, how in _SSD_CUTS:
        cols_cut(pre + "mixer." + leaf, hp, dim, [c[how] for c in per])
    mix.tp = split(hp, H // m)
    return {"ssm_shards": m,
            "ssm_ngroups": ssm.rank_columns(cfg, r, m).groups}


def state_columns(cfg: ModelConfig, mixer: str, m: int) -> dict:
    """Where the ranks of a recurrent layer cut m ways hold its state:
    ``{field: (dim, [rank r's columns of the whole dim, for each r])}``
    (an RG-LRU's width; an SSD state's heads and its conv tail's segment
    columns, ``ssm.rank_columns``).  The engine gathers a session's whole
    state by it and cuts a whole one back (``sharding.gather_cols``)."""
    if mixer == "rglru":
        wl = (cfg.rnn_width or cfg.d_model) // m
        cols = [list(range(r * wl, (r + 1) * wl)) for r in range(m)]
        return {"h": (1, cols), "conv": (2, cols)}
    rcs = [ssm.rank_columns(cfg, r, m) for r in range(m)]
    return {"ssd": (1, [list(range(c.h0, c.h0 + c.heads)) for c in rcs]),
            "conv": (2, [c.conv for c in rcs])}
