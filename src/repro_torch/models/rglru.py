"""RG-LRU recurrent block (Griffin / RecurrentGemma [arXiv:2402.19427]),
PyTorch.

Mirrors ``repro/models/rglru.py``.  The gated linear recurrence
h_t = a_t h_{t-1} + b_t runs in f32.  Over a full sequence it is a log-step
(Hillis-Steele) scan: log2(S) elementwise passes of the reference's
``combine``, where the reference runs ``lax.associative_scan`` (another
tree over the same operator, so the two agree to rounding).  Decode is one
step on a (B, W) f32 state.  The carried state (``RGLRUState``) is written
IN PLACE by ``rglru_prefill`` and ``rglru_decode``, as the attention layers
write their KV caches.

On a mesh (``transformer.shard_params``) a rank holds W/m of the width
``ssm_inner`` (``SERVE_RULES``): the columns of w_in, w_branch, the conv,
wa, wx, their biases and lam, and the rows of w_out, with a
``sharding.Split`` as ``.tp``.  The conv is depthwise and the recurrence
elementwise, so both run on the rank's columns, and its state is
``(B, W/m)`` and ``(B, conv_width-1, W/m)``.  The gate products contract
over the whole W (wa/wx keep their rows), so they read the post-conv
``u`` gathered over 'model' (a copy: exact); w_out's product is
row-parallel (``sharding.row_parallel``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.distributed.sharding import row_parallel
from repro_torch.models.common import (ModelConfig, frozen_zeros, gelu,
                                       rmsnorm, softplus)
from repro_torch.models.ssm import _causal_conv, _causal_conv_step

_C = 8.0  # Griffin's fixed gate sharpness


class RGLRUState(NamedTuple):
    h: torch.Tensor      # (B, W) f32
    conv: torch.Tensor   # (B, conv_width-1, W) in the model dtype


class RGLRU(nn.Module):
    """Parameters in the JAX layouts (``rglru_defs``): w_in/w_branch (D,W),
    conv_w (Wc,W), conv_b, wa/wx (W,W), ba/bx (W,), w_out (W,D), norm (D,)
    in the model dtype; lam (W,) in f32."""

    #: each parameter's logical axes, as the reference's ``rglru_defs``
    #: tags them (``distributed/sharding.py``)
    AXES = {"norm": ("norm",), "w_in": ("embed", "ssm_inner"),
            "w_branch": ("embed", "ssm_inner"),
            "conv_w": ("conv_width", "ssm_inner"), "conv_b": ("ssm_inner",),
            "wa": ("embed", "ssm_inner"), "ba": ("ssm_inner",),
            "wx": ("embed", "ssm_inner"), "bx": ("ssm_inner",),
            "lam": ("ssm_inner",), "w_out": ("ssm_inner", "embed")}

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        D, W = cfg.d_model, cfg.rnn_width or cfg.d_model

        def p(*shape, dtype=cfg.dtype):
            return frozen_zeros(*shape, dtype=dtype, device=device)

        self.norm = p(D)
        self.w_in, self.w_branch = p(D, W), p(D, W)
        self.conv_w, self.conv_b = p(cfg.rnn_conv_width, W), p(W)
        self.wa, self.ba = p(W, W), p(W)
        self.wx, self.bx = p(W, W), p(W)
        self.lam = p(W, dtype=torch.float32)
        self.w_out = p(W, D)


def lam_init(shape, generator: torch.Generator) -> torch.Tensor:
    """lam such that a = sigmoid(lam)^c is uniform-ish in [0.9, 0.999]."""
    u = 0.9 + 0.099 * torch.rand(shape, generator=generator,
                                 device=generator.device)
    a_pow = u ** (1.0 / _C)
    return torch.log(a_pow / (1 - a_pow))


def _gates(p: RGLRU, u: torch.Tensor):
    """u (B,L,W) post-conv -> (a, b) of the recurrence, f32.  On a mesh u
    holds the rank's columns: the gate products read it gathered whole,
    the elementwise terms the rank's own."""
    uf = u.float()
    tp = getattr(p, "tp", None)
    # gathered whole, then into the rank's cut gate columns
    uw = uf if tp is None else tp.enter(tp.gather(u, -1)).float()
    r = torch.sigmoid(uw @ p.wa.float() + p.ba.float())
    i = torch.sigmoid(uw @ p.wx.float() + p.bx.float())
    a = torch.exp(-_C * softplus(p.lam.float()) * r)
    b = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * uf)
    return a, b


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of h_t = a_t h_{t-1} + b_t (h_0 = 0) over dim 1, as
    log2(S) Hillis-Steele passes of the reference's ``combine``: element t
    takes (a_{t-d} a_t, a_t b_{t-d} + b_t) from the element d before it.
    Elements with nothing d before them combine with the identity (1, 0),
    exactly."""
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def _branches(p: RGLRU, x: torch.Tensor, cfg: ModelConfig):
    """The block's two input branches: (u = x W_in, g = gelu(x W_branch)),
    both after the pre-norm, in x's dtype."""
    h = rmsnorm(x, p.norm, cfg.norm_eps)
    tp = getattr(p, "tp", None)
    if tp is not None:
        h = tp.enter(h)                  # into the rank's width columns
    return h @ p.w_in.to(h.dtype), gelu(h @ p.w_branch.to(h.dtype))


def _out(p: RGLRU, x: torch.Tensor, h: torch.Tensor,
         g: torch.Tensor) -> torch.Tensor:
    """x + (h * g) W_out, h the recurrence's f32 output; row-parallel on a
    mesh."""
    return x + row_parallel(p, h.to(x.dtype) * g, p.w_out)


def rglru_block(p: RGLRU, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence Griffin recurrent block.  x (B,S,D)."""
    u, g = _branches(p, x, cfg)
    u, _ = _causal_conv(u, p.conv_w, p.conv_b)
    a, b = _gates(p, u)
    return _out(p, x, linear_scan(a, b), g)


def rglru_prefill(p: RGLRU, x: torch.Tensor, state: RGLRUState,
                  positions: torch.Tensor, cfg: ModelConfig, *,
                  continuation: bool = False
                  ) -> tuple[torch.Tensor, RGLRUState]:
    """Prompt absorption: the full-sequence scan from ``state``, which it
    then overwrites in place with the state after the span's last real
    token.

    positions (B,S): negative positions are inert bucket padding — their
    conv input is zeroed and their step forced to (a=1, b=0), so the
    carried state passes through.  Cold spans are left-padded;
    ``continuation=True`` spans are RIGHT-padded so the conv window of the
    first new token reaches into ``state.conv``, and the conv tail is taken
    at the last real column.  ``state.h`` folds into the first step
    (h_1 = a_1 h_0 + b_1) either way."""
    valid = (positions >= 0)[..., None]                      # (B,S,1)
    u, g = _branches(p, x, cfg)
    u = u.masked_fill(~valid, 0)
    tail_index = valid[..., 0].sum(dim=1) if continuation else None
    u, conv_tail = _causal_conv(u, p.conv_w, p.conv_b, prev=state.conv,
                                tail_index=tail_index)
    a, b = _gates(p, u)
    a = a.masked_fill(~valid, 1.0)
    b = b.masked_fill(~valid, 0.0)
    b = torch.cat([b[:, :1] + a[:, :1] * state.h[:, None], b[:, 1:]], dim=1)
    hseq = linear_scan(a, b)
    out = _out(p, x, hseq, g)
    state.h.copy_(hseq[:, -1])
    state.conv.copy_(conv_tail)
    return out, state


def init_rglru_state(cfg: ModelConfig, batch: int,
                     device=None) -> RGLRUState:
    """A zero state: h in f32 (the recurrence compounds per token; a bf16
    state would drift), the conv tail in the model dtype."""
    W = cfg.rnn_width or cfg.d_model
    return RGLRUState(
        h=torch.zeros((batch, W), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.rnn_conv_width - 1, W), dtype=cfg.dtype,
                         device=device))


def rglru_decode(p: RGLRU, x: torch.Tensor, state: RGLRUState,
                 cfg: ModelConfig) -> tuple[torch.Tensor, RGLRUState]:
    """One-token decode.  x (B,1,D); ``state`` updated in place."""
    u, g = _branches(p, x, cfg)
    u, conv_tail = _causal_conv_step(u, p.conv_w, p.conv_b, state.conv)
    a, b = _gates(p, u)                                      # (B,1,W)
    h_new = a[:, 0] * state.h + b[:, 0]
    out = _out(p, x, h_new[:, None], g)
    state.h.copy_(h_new)
    state.conv.copy_(conv_tail)
    return out, state
