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
routing flip is a different expert, not noise.  Expert parallelism (the
reference's ``shard_map`` dispatch) is not ported.
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
                valid: torch.Tensor | None = None):
    """Top-k routing in f32: h (g,T,D) -> (gates (g,T,k), idx (g,T,k),
    probs (g,T,E)).  ``valid`` (g,T) masks inert tokens: their logits are
    forced to -1e30 (uniform probs); callers also keep them out of the
    capacity counts and zero their combine weights."""
    logits = h.float() @ router.float()
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


def _experts(p: MoE, hf: torch.Tensor, gates: torch.Tensor,
             flat_e: torch.Tensor, pos: torch.Tensor, keep: torch.Tensor,
             C: int, cfg: ModelConfig) -> torch.Tensor:
    """Dispatch, expert products and combine.  hf (g,T,D) normed tokens;
    gates (g,T,k); flat_e / pos / keep (g, T*k) each assignment's expert,
    rank and whether it holds a slot.  Returns the routed experts plus the
    shared expert, (g,T,D) in f32."""
    g, T, D = hf.shape
    E, k = cfg.num_experts, cfg.top_k
    A, M = T * k, g * C
    dt = hf.dtype
    gl = torch.arange(g, device=hf.device)[:, None]
    # kept: expert e, row gl*C + pos; dropped: the sink row M of expert E-1
    e_idx = torch.where(keep, flat_e, E - 1)
    r_idx = torch.where(keep, gl * C + pos, M)
    src = hf[:, :, None].expand(g, T, k, D).reshape(g, A, D)
    buf = torch.zeros((E, M + 1, D), dtype=dt, device=hf.device)
    buf = buf.index_put_((e_idx, r_idx), src)[:, :M]
    act = ACTIVATIONS[cfg.ffn_act]
    gate_h = torch.bmm(buf, Q.cast(p.w_gate, dt))           # (E, M, Fe)
    up_h = torch.bmm(buf, Q.cast(p.w_up, dt))
    out_buf = torch.bmm(act(gate_h) * up_h, Q.cast(p.w_down, dt))  # (E,M,D)
    # dropped assignments read a real row and weigh it 0
    y = out_buf[e_idx, torch.where(keep, r_idx, gl * C + C - 1)]
    w = (gates.reshape(g, A) * keep).float()
    y = (y.float() * w[..., None]).reshape(g, T, k, D).sum(2)
    if hasattr(p, "shared"):
        y = y + ffn.mlp_body(p.shared, hf, cfg).float()
    return y


def moe_block(p: MoE, x: torch.Tensor, cfg: ModelConfig, *,
              groups: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,D) -> (x + moe(x), aux_loss).  ``groups`` must divide B*S;
    the tokens of each group compete for ``moe_capacity`` slots per
    expert."""
    if cfg.moe_impl != "sort":
        raise NotImplementedError(
            f"moe_impl={cfg.moe_impl!r}: only the sort ranking is ported "
            "(it gives the one-hot cumsum's positions)")
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.top_k
    T = B * S
    assert T % groups == 0, (T, groups)
    Tg = T // groups
    C = moe_capacity(cfg, Tg)
    h = rmsnorm(x, p.norm, cfg.norm_eps)
    hf = h.reshape(groups, Tg, D)
    gates, idx, probs = _route_topk(p.router, hf, cfg)
    # Switch load-balance aux: E * mean_e(frac_tokens_e * mean_prob_e)
    aux = E * torch.mean(_one_hot(idx[..., 0], E).mean(1) * probs.mean(1))
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
    gates, idx, probs = _route_topk(p.router, hf, cfg, valid=valid)
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
    gates, idx, _ = _route_topk(p.router, hf[None], cfg)
    gates, idx = gates[0], idx[0]                            # (T, k)
    dt = h.dtype
    act = ACTIVATIONS[cfg.ffn_act]
    hk = hf[:, None, None, :]                                # (T, 1, 1, D)
    gate_h = hk @ _take_expert_rows(p.w_gate, idx, dt)       # (T, k, 1, Fe)
    up_h = hk @ _take_expert_rows(p.w_up, idx, dt)
    o = (act(gate_h) * up_h) @ _take_expert_rows(p.w_down, idx, dt)
    y = (o[:, :, 0].float() * gates[..., None]).sum(1).reshape(B, S, D)
    if hasattr(p, "shared"):
        y = y + ffn.mlp_body(p.shared, h, cfg).float()
    return x + y.to(x.dtype), torch.zeros((), dtype=torch.float32,
                                          device=x.device)
