"""Mixture-of-Experts FFN: capacity-based dispatch (PyTorch).

Mirrors ``repro/models/moe.py`` function for function on one device:
top-k renormalised softmax gating (top-6 + 2 shared experts ==
DeepSeekMoE, top-1 + 1 shared == Llama-4-Scout), a sort-based rank of each
assignment inside its expert, and three dispatch flavours over the same
router and ranking:

* ``moe_block`` — training and the full-sequence forward: ``groups`` flat
  token groups, capacity ``moe_capacity`` (overflow drops), the Switch
  load-balance aux loss; differentiable by autograd;
* ``moe_prefill_block`` — the serving prefill: one dispatch group per
  prompt position, so each group routes exactly the B tokens a decode step
  at that position routes; bucket padding (negative positions) is masked
  out of routing, capacity and the combine;
* ``moe_decode_block`` — the serving decode: the prefill dispatch at S=1
  (``moe_decode_impl="dispatch"``), or the gather of the k selected
  experts' weight rows (``"gather"``: k/E of the expert FLOPs, ~1 bf16 ulp
  off the dispatch).

The dispatch buffer is (E, g*C + 1, D): expert e's rows are its capacity
slots group after group, and the last row is a sink.  The reference
scatters with ``mode="drop"`` into a row past the capacity and slices it
off; a CUDA index out of range asserts, so dropped assignments write the
sink row of the last expert instead, and the sink is sliced off before the
expert products.  Each projection is one ``torch.bmm`` over the E experts
(XLA einsums in the reference, outside any Pallas kernel).  Rounding
follows the reference: the dispatched rows, the expert activations and
outputs in the compute dtype, the combine and the shared expert summed in
f32, the result cast to ``x.dtype``.

Nothing here syncs the host (no ``.item()``, ``nonzero``, boolean-mask
indexing or tensor-count ``repeat_interleave``), so a decode step with MoE
layers can be captured into a CUDA graph.  The router product runs in f32;
the port's entry points leave TF32 off (``use_f32_accumulation``), since a
routing flip is a different expert, not noise.

Expert parallelism on a mesh (``transformer.shard_params``): a rank holds
E/m experts (``"experts"`` over 'model', ``SERVE_RULES``), their slice of
the router's columns, and a ``sharding.Split`` as ``.tp``; the shared
expert is an MLP cut over its d_ff.  The serving dispatches gather the
router logits ((S, B, E), small), so top-k, the ranks inside each expert
and the capacity decisions run whole and alike on every rank; a rank fills
only its experts' rows of the capacity buffer (other assignments go to the
sink), runs its experts' products, and gathers its experts' output row of
each assignment into an (S, B*k, D) tensor, zero where another rank owns
the assignment.  One all-reduce over 'model' joins them: each entry is
nonzero on exactly one rank, so the sum is exact and the combine after it
is the single device's.  The reference keeps the buffer's expert dim
replicated under SPMD; the port moves the routed rows instead.  The
full-sequence dispatch (``moe_block``: training and ``forward``) does the
same over the groups of the rank's rows (``moe_block``), differentiable
(``sharding.enter`` / ``reduce`` / ``gather``).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import ffn
from repro_torch.models import quant as Q
from repro_torch.models.common import (ACTIVATIONS, ModelConfig,
                                       frozen_zeros, rmsnorm)

_MASKED = -1e30          # "-inf" for masked router logits (softmax-safe)


class MoE(nn.Module):
    """Parameters in the JAX layouts (``moe_defs``): norm (D,), router
    (D,E), w_gate/w_up (E,D,Fe), w_down (E,Fe,D), and ``shared``, an
    ``ffn.MLP`` of ``num_shared_experts * expert_d_ff`` with no norm of its
    own (it shares this block's)."""

    #: each parameter's logical axes, as the reference's ``moe_defs`` tags
    #: them (``distributed/sharding.py``; ``shared`` is an ``ffn.MLP``)
    AXES = {"norm": ("norm",), "router": ("embed", "experts"),
            "w_gate": ("experts", "embed", "expert_ffn"),
            "w_up": ("experts", "embed", "expert_ffn"),
            "w_down": ("experts", "expert_ffn", "embed")}

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        D, E, Fe = cfg.d_model, cfg.num_experts, cfg.expert_d_ff

        def p(*shape):
            return frozen_zeros(*shape, dtype=cfg.dtype, device=device)

        self.norm = p(D)
        self.router = p(D, E)
        self.w_gate, self.w_up = p(E, D, Fe), p(E, D, Fe)
        self.w_down = p(E, Fe, D)
        if cfg.num_shared_experts:
            self.shared = ffn.MLP(cfg, d_ff=cfg.num_shared_experts * Fe,
                                  norm=False, device=device)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def moe_capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    c = int(tokens_per_group * cfg.top_k / cfg.num_experts
            * cfg.capacity_factor)
    return max(_round_up(c, 8), 8)


def moe_serve_capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    """Per-group capacity on the serving path: the group size itself by
    default (drop-free, exact top-k), else bounded as the training dispatch
    is, by ``moe_serve_capacity_factor``, between 1 and the group size."""
    f = cfg.moe_serve_capacity_factor
    if f is None:
        return tokens_per_group
    c = int(tokens_per_group * cfg.top_k / cfg.num_experts * f)
    return max(min(_round_up(c, 8), tokens_per_group), 1)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot by comparison (``F.one_hot`` range-checks on the host)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _route_topk(router: torch.Tensor, h: torch.Tensor, cfg: ModelConfig,
                valid: torch.Tensor | None = None, tp=None):
    """Top-k routing in f32: h (g,T,D) -> (gates (g,T,k), idx (g,T,k),
    probs (g,T,E)).  ``valid`` (g,T) masks inert tokens: their logits are
    forced to -1e30 (uniform probs); callers also keep them out of the
    capacity counts and zero their combine weights.  On a mesh (``tp``,
    the ``Split`` of the experts) the rank's logits of its experts are
    gathered whole first."""
    if tp is not None:
        h = tp.enter(h)                  # into the rank's router columns
    logits = h.float() @ router.float()
    if tp is not None:
        logits = tp.gather(logits, -1)
    if valid is not None:
        logits = torch.where(valid[..., None], logits, _MASKED)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return gates, idx, probs


def _rank_in_expert(flat_e: torch.Tensor) -> torch.Tensor:
    """flat_e (g, A) expert ids -> (g, A) position of each assignment in its
    expert's arrival order.  A STABLE argsort (torch's default sort is not
    stable) keeps token order inside each expert's segment, the GShard
    cumsum order; segment starts come from a cummax over boundary markers.
    The inverse permutation is a scatter."""
    groups, A = flat_e.shape
    sort_idx = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = flat_e.gather(1, sort_idx)
    ar = torch.arange(A, device=flat_e.device).expand(groups, A)
    is_new = torch.ones_like(sorted_e, dtype=torch.bool)
    is_new[:, 1:] = sorted_e[:, 1:] != sorted_e[:, :-1]
    seg_start = torch.cummax(torch.where(is_new, ar, 0), dim=1).values
    return torch.empty_like(sort_idx).scatter_(1, sort_idx, ar - seg_start)


def _owned(p: MoE, flat_e: torch.Tensor, keep: torch.Tensor | None = None):
    """(the assignments whose expert this rank holds, of those that hold a
    slot where ``keep`` is given; their experts' local ids, 0 elsewhere).
    Off a mesh ``keep`` and ``flat_e`` themselves."""
    tp = getattr(p, "tp", None)
    if tp is None:
        return keep, flat_e
    local = flat_e - tp.start
    own = (local >= 0) & (local < tp.size)
    if keep is not None:
        own = own & keep
    return own, torch.where(own, local, 0)


def _join(p: MoE, y: torch.Tensor, mine: torch.Tensor) -> torch.Tensor:
    """Every rank's expert outputs of the assignments it owns (``mine``),
    joined: zeros elsewhere, summed over the axes the experts are cut over.
    Each entry is nonzero on one rank, so the sum is exact.  ``y`` itself
    off a mesh."""
    tp = getattr(p, "tp", None)
    if tp is None:
        return y
    m = mine.reshape(mine.shape + (1,) * (y.ndim - mine.ndim))
    return tp.reduce(torch.where(m, y, torch.zeros((), dtype=y.dtype,
                                                   device=y.device)))


def _routed(p: MoE, hf: torch.Tensor, flat_e: torch.Tensor,
            pos: torch.Tensor, keep: torch.Tensor, C: int,
            cfg: ModelConfig) -> torch.Tensor:
    """Dispatch and expert products: each assignment's expert output row,
    (g, T*k, D) in the compute dtype.  hf (g,T,D) normed tokens; flat_e /
    pos / keep (g, T*k) each assignment's expert, rank and whether it holds
    a slot.  On a mesh the rank's experts fill and multiply their rows of
    the buffer and the rows are joined over 'model' (``_join``)."""
    g, T, D = hf.shape
    k = cfg.top_k
    A, M = T * k, g * C
    dt = hf.dtype
    mine, local = _owned(p, flat_e, keep)
    El = p.w_gate.shape[0]
    gl = torch.arange(g, device=hf.device)[:, None]
    # kept: expert e, row gl*C + pos; dropped (and another rank's): the
    # sink row M of the last expert
    e_idx = torch.where(mine, local, El - 1)
    r_idx = torch.where(mine, gl * C + pos, M)
    tp = getattr(p, "tp", None)
    if tp is not None:
        hf = tp.enter(hf)                # into the rank's experts
    src = hf[:, :, None].expand(g, T, k, D).reshape(g, A, D)
    buf = torch.zeros((El, M + 1, D), dtype=dt, device=hf.device)
    buf = buf.index_put_((e_idx, r_idx), src)[:, :M]
    act = ACTIVATIONS[cfg.ffn_act]
    gate_h = torch.bmm(buf, Q.cast(p.w_gate, dt))           # (E, M, Fe)
    up_h = torch.bmm(buf, Q.cast(p.w_up, dt))
    out_buf = torch.bmm(act(gate_h) * up_h, Q.cast(p.w_down, dt))  # (E,M,D)
    # dropped assignments read a real row and weigh it 0
    return _join(p, out_buf[e_idx, torch.where(mine, r_idx, gl * C + C - 1)],
                 mine)


def _experts(p: MoE, hf: torch.Tensor, gates: torch.Tensor,
             flat_e: torch.Tensor, pos: torch.Tensor, keep: torch.Tensor,
             C: int, cfg: ModelConfig) -> torch.Tensor:
    """Dispatch, expert products and combine (``_routed``), gates (g,T,k).
    Returns the routed experts plus the shared expert, (g,T,D) in f32."""
    g, T, D = hf.shape
    k = cfg.top_k
    y = _routed(p, hf, flat_e, pos, keep, C, cfg)
    w = (gates.reshape(g, T * k) * keep).float()
    y = (y.float() * w[..., None]).reshape(g, T, k, D).sum(2)
    if hasattr(p, "shared"):
        y = y + ffn.mlp_body(p.shared, hf, cfg).float()
    return y


def moe_block(p: MoE, x: torch.Tensor, cfg: ModelConfig, *,
              groups: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,D) -> (x + moe(x), aux_loss).  ``groups`` must divide B*S;
    the tokens of each group compete for ``moe_capacity`` slots per
    expert.

    On a mesh shard (``transformer.shard_params`` sets ``.data_shards``,
    d, and the experts' ``.tp``) x holds the rank's rows of the batch, and
    ``groups`` counts the groups of the whole batch, as the reference's
    group-local ``shard_map`` dispatch counts them: the rank dispatches
    ``groups / d`` groups of its own rows, each with the whole batch's
    group size and capacity, and its aux is its groups' mean over d, so
    that the sum over the batch axes is the mean over every group.  The
    routing runs whole (the router logits are gathered over 'model'), each
    rank multiplies its experts' rows, and the rows are joined over
    'model' (``_join``): every rank issues the same collectives, whether
    its experts got tokens or not."""
    if cfg.moe_impl != "sort":
        raise NotImplementedError(
            f"moe_impl={cfg.moe_impl!r}: only the sort ranking is ported "
            "(it gives the one-hot cumsum's positions)")
    d = getattr(p, "data_shards", 1)
    if groups % d:
        raise ValueError(f"{groups} MoE groups over {d} data shards: the "
                         "data shards must divide the groups")
    groups //= d
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.top_k
    T = B * S
    assert T % groups == 0, (T, groups)
    Tg = T // groups
    C = moe_capacity(cfg, Tg)
    h = rmsnorm(x, p.norm, cfg.norm_eps)
    hf = h.reshape(groups, Tg, D)
    gates, idx, probs = _route_topk(p.router, hf, cfg,
                                     tp=getattr(p, "tp", None))
    # Switch load-balance aux: E * mean_e(frac_tokens_e * mean_prob_e)
    aux = E * torch.mean(_one_hot(idx[..., 0], E).mean(1) * probs.mean(1))
    if d > 1:
        aux = aux / d
    flat_e = idx.reshape(groups, Tg * k)
    pos = _rank_in_expert(flat_e)
    y = _experts(p, hf, gates, flat_e, pos, pos < C, C, cfg)
    return x + y.reshape(B, S, D).to(x.dtype), aux


def moe_prefill_block(p: MoE, x: torch.Tensor, cfg: ModelConfig,
                      positions: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The serving prefill: x (B,S,D); positions (B,S), negative marks
    inert bucket padding.  Returns (x + moe(x), aux).

    One dispatch group per position: group s routes the B tokens a decode
    step at position s would route, with ``moe_serve_capacity(cfg, B)``
    slots per expert (B by default: drop-free).  Padding is masked three
    ways, so padded and unpadded prompts dispatch alike: router logits at
    -1e30, assignments moved to a sentinel expert E (which the stable sort
    puts after every real expert, so padding never takes a real expert's
    slot), and a zero combine weight.  The aux loss leaves padding out of
    both factors."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.top_k
    C = moe_serve_capacity(cfg, B)
    h = rmsnorm(x, p.norm, cfg.norm_eps)
    hf = h.transpose(0, 1)                                   # (S, B, D)
    valid = (positions >= 0).transpose(0, 1)                 # (S, B)
    gates, idx, probs = _route_topk(p.router, hf, cfg, valid=valid,
                                     tp=getattr(p, "tp", None))
    A = B * k
    valid_a = valid[..., None].expand(S, B, k).reshape(S, A)
    flat_e = torch.where(valid_a, idx.reshape(S, A), E)      # pad: sentinel
    pos = _rank_in_expert(flat_e)
    keep = (pos < C) & valid_a
    y = _experts(p, hf, gates, flat_e, pos, keep, C, cfg).transpose(0, 1)
    vf = valid.float()[..., None]                            # (S, B, 1)
    cnt = vf.sum().clamp_min(1.0)
    top1 = _one_hot(idx[..., 0], E)
    aux = E * torch.mean(((top1 * vf).sum((0, 1)) / cnt)
                         * ((probs * vf).sum((0, 1)) / cnt))
    return x + y.to(x.dtype), aux


def _take_expert_rows(w, idx: torch.Tensor, dt) -> torch.Tensor:
    """The k selected experts' weight rows, w (E, ...) -> (T, k, ...).  A
    ``QTensor`` gathers payload and scale rows and dequantizes after the
    gather, so the decode reads k/E of the stack's bytes."""
    if isinstance(w, Q.QTensor):
        return w.take_rows(idx, dt)
    return w[idx].to(dt)


def moe_decode_block(p: MoE, x: torch.Tensor, cfg: ModelConfig
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The decode step, x (B,1,D).  ``moe_decode_impl="dispatch"`` (the
    default): the prefill dispatch at S=1, shapes fixed by (B, k, C), so
    prefill and stepwise absorption route alike.  ``"gather"``: gather the
    k selected experts' rows per token and multiply those only (k/E of the
    FLOPs; weight traffic 3·B·k·D·Fe).  Returns (x + moe(x), 0)."""
    B, S, D = x.shape
    if cfg.moe_decode_impl != "gather":
        return moe_prefill_block(p, x, cfg, torch.zeros(
            (B, S), dtype=torch.int32, device=x.device))
    T = B * S
    h = rmsnorm(x, p.norm, cfg.norm_eps)
    hf = h.reshape(T, D)
    gates, idx, _ = _route_topk(p.router, hf[None], cfg,
                                tp=getattr(p, "tp", None))
    gates, idx = gates[0], idx[0]                            # (T, k)
    dt = h.dtype
    act = ACTIVATIONS[cfg.ffn_act]
    # on a mesh the rank's experts' rows (another rank's assignment reads
    # its first expert and is zeroed by the join)
    mine, li = _owned(p, idx)
    hk = hf[:, None, None, :]                                # (T, 1, 1, D)
    gate_h = hk @ _take_expert_rows(p.w_gate, li, dt)        # (T, k, 1, Fe)
    up_h = hk @ _take_expert_rows(p.w_up, li, dt)
    o = (act(gate_h) * up_h) @ _take_expert_rows(p.w_down, li, dt)
    o = _join(p, o[:, :, 0], mine)                           # (T, k, D)
    y = (o.float() * gates[..., None]).sum(1).reshape(B, S, D)
    if hasattr(p, "shared"):
        y = y + ffn.mlp_body(p.shared, h, cfg).float()
    return x + y.to(x.dtype), torch.zeros((), dtype=torch.float32,
                                          device=x.device)
