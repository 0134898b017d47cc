"""Mamba-2 (SSD, state-space duality) block: the chunked parallel form for
the full sequence and prefill, and the one-token recurrent decode (PyTorch).

Mirrors ``repro/models/ssm.py``.  The chunked scan is the reference's
[arXiv:2405.21060, Listing 1]: intra-chunk products through the segment
sums, per-chunk input states, a recurrence over the chunks (the
reference's ``lax.scan``, here a loop over S/chunk chunks) and the states'
contribution to the outputs, all in f32.  Decode is the O(1) step on a
(B, H, P, N) f32 state.  The carried state (``SSMState``) is written IN
PLACE by ``ssd_prefill`` and ``ssd_decode``, as the attention layers write
their KV caches: a captured decode dispatch reads and writes the addresses
it saw.

The conv helpers ``_causal_conv`` / ``_causal_conv_step`` serve the RG-LRU
block too (``models/rglru.py``).  Both accumulate the window in f32 and
round to the activation dtype before bias and silu, the numerics the
reference's conv lowering produces.

On a mesh (``transformer.shard_params``) a rank holds H/m of the SSD heads,
cut as Mamba-2's own tensor-parallel layer cuts them: in_proj's columns
segment by segment (``rank_columns``: the rank's z, x and dt, and the B/C
groups its heads read, whole when one group serves every head), the conv
alike (depthwise: local), A_log, dt_bias, D_skip and the gated norm's
weight by heads, and out_proj's rows, row-parallel
(``sharding.row_parallel``).  The reference cuts the concatenated
projection contiguously (XLA reshards it); a contiguous cut would mix the
segments here.  The rank's config (``common.RankConfig``) gives the local
d_inner, heads and groups, so the scan, the decode step and the state,
``ssd (B, H/m, P, N)`` and ``conv (B, W-1, d_inner/m + 2 G_l N)``, run
unchanged on the rank's heads.  The gated RMSNorm normalises over the
whole d_inner: its per-row sum of squares is summed over 'model' in f32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.sharding import row_parallel
from repro_torch.models.common import (ModelConfig, frozen_zeros, rmsnorm,
                                       softplus)


class SSMState(NamedTuple):
    ssd: torch.Tensor      # (B, H, P, N) f32
    conv: torch.Tensor     # (B, W-1, conv_dim) in the model dtype


def _dims(cfg: ModelConfig):
    d_inner = cfg.ssm_d_inner
    H = cfg.ssm_nheads
    P = cfg.ssm_head_dim
    G = cfg.ssm_ngroups
    N = cfg.ssm_state
    conv_dim = d_inner + 2 * G * N
    d_in_proj = 2 * d_inner + 2 * G * N + H
    return d_inner, H, P, G, N, conv_dim, d_in_proj


class SSD(nn.Module):
    """Parameters in the JAX layouts (``ssd_defs``): in_proj (D, d_in_proj),
    conv_w (W, conv_dim), conv_b, gnorm (d_inner,), out_proj (d_inner, D),
    norm (D,) in the model dtype; A_log, dt_bias, D_skip (H,) in f32."""

    #: each parameter's logical axes, as the reference's ``ssd_defs`` tags
    #: them (``distributed/sharding.py``)
    AXES = {"norm": ("norm",), "in_proj": ("embed", "ssm_inner"),
            "conv_w": ("conv_width", "ssm_inner"), "conv_b": ("ssm_inner",),
            "A_log": ("heads",), "dt_bias": ("heads",), "D_skip": ("heads",),
            "gnorm": ("ssm_inner",), "out_proj": ("ssm_inner", "embed")}

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d_inner, H, P, G, N, conv_dim, d_in_proj = _dims(cfg)
        D = cfg.d_model

        def p(*shape, dtype=cfg.dtype):
            return frozen_zeros(*shape, dtype=dtype, device=device)

        self.norm = p(D)
        self.in_proj = p(D, d_in_proj)
        self.conv_w = p(cfg.ssm_conv_width, conv_dim)
        self.conv_b = p(conv_dim)
        self.A_log = p(H, dtype=torch.float32)
        self.dt_bias = p(H, dtype=torch.float32)
        self.D_skip = p(H, dtype=torch.float32)
        self.gnorm = p(d_inner)
        self.out_proj = p(d_inner, D)


def a_init(shape, generator: torch.Generator) -> torch.Tensor:
    """A in [1, 16] (the mamba2 default), stored as A_log."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return torch.log(1.0 + 15.0 * u)


def dt_init(shape, generator: torch.Generator) -> torch.Tensor:
    """dt log-uniform in [1e-3, 0.1], stored through the inverse softplus."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    lo, hi = torch.log(torch.tensor(1e-3)), torch.log(torch.tensor(0.1))
    dt = torch.exp(u * (hi - lo).to(u.device) + lo.to(u.device))
    return dt + torch.log(-torch.expm1(-dt))


class RankColumns(NamedTuple):
    """A rank's share of an SSD layer cut over m ranks, in the whole
    layer's column numbers: its heads [h0, h0 + H/m), its groups [g0, g0 +
    G_l), and the columns of in_proj and of the conv (and its state's conv
    tail) it holds, segment by segment."""
    h0: int
    heads: int
    g0: int
    groups: int
    in_proj: list
    conv: list


def rank_columns(cfg: ModelConfig, r: int, m: int) -> RankColumns:
    """Rank r's columns of an SSD layer whose H heads are cut m ways (m
    divides H).  Its heads read groups: one group (``m % G == 0``: the
    group of its heads, every group when G = 1) or G/m (``G % m == 0``);
    other shapes raise ``NotImplementedError``."""
    d_inner, H, P, G, N, conv_dim, _ = _dims(cfg)
    if m % G == 0:
        g0, gl = r // (m // G), 1
    elif G % m == 0:
        g0, gl = r * (G // m), G // m
    else:
        raise NotImplementedError(
            f"{cfg.name}: {G} SSD groups over a {m}-way model axis: the "
            "groups neither divide the ranks nor split among them")
    hl, dl = H // m, d_inner // m
    x = list(range(r * dl, (r + 1) * dl))
    bc = list(range(g0 * N, (g0 + gl) * N))
    conv = x + [d_inner + c for c in bc] + [d_inner + G * N + c for c in bc]
    proj = (x + [d_inner + c for c in conv]
            + [d_inner + conv_dim + h for h in range(r * hl, (r + 1) * hl)])
    return RankColumns(r * hl, hl, g0, gl, proj, conv)


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    d_inner, H, P, G, N, conv_dim, _ = _dims(cfg)
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:d_inner + conv_dim]
    dt = zxbcdt[..., -H:]
    return z, xBC, dt


def _project(p: "SSD", x: torch.Tensor, cfg: ModelConfig):
    """(z, xBC, dt) of the pre-normed x.  On a mesh x enters the rank's
    columns (``sharding.enter``); the B/C columns that other ranks hold too
    get their gradient summed over those ranks by the training step
    (``sharding.Cut.shared``), not here."""
    h = rmsnorm(x, p.norm, cfg.norm_eps)
    tp = getattr(p, "tp", None)
    if tp is not None:
        h = tp.enter(h)
    return _split_proj(h @ p.in_proj.to(h.dtype), cfg)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: torch.Tensor | None = None,
                 tail_index: torch.Tensor | None = None):
    """Depthwise causal conv1d.  x (B,L,C); w (W,C); prev (B,W-1,C), the
    inputs before the span (zeros when None).  Returns (silu(conv + b),
    tail), the tail being the W-1 inputs the next call's window needs.

    ``tail_index`` (B,): the number of real leading columns per row.  None
    takes the tail from the last W-1 columns (LEFT-padded spans, real
    tokens at the end); continuation spans are RIGHT-padded, and there the
    tail ends at the last real input: padded-input columns [tail_index,
    tail_index + W - 2]."""
    B, L, C = x.shape
    W = w.shape[0]
    if prev is None:
        prev = x.new_zeros((B, W - 1, C))
    xpad = torch.cat([prev.to(x.dtype), x], dim=1)
    wf = w.float()
    acc = xpad[:, 0:L].float() * wf[0]
    for k in range(1, W):
        acc = acc + xpad[:, k:k + L].float() * wf[k]
    out = acc.to(x.dtype)
    out = F.silu(out + b.to(out.dtype))
    if W <= 1:
        tail = x.new_zeros((B, 0, C))
    elif tail_index is None:
        tail = xpad[:, L:]
    else:
        idx = (tail_index.long()[:, None]
               + torch.arange(W - 1, device=x.device)[None])
        tail = xpad.gather(1, idx[..., None].expand(B, W - 1, C))
    return out, tail


def _causal_conv_step(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      prev: torch.Tensor):
    """One-token depthwise causal conv (decode).  x (B,1,C); prev
    (B,W-1,C).  The window is summed in f32 and rounded to x's dtype
    before bias and silu."""
    B, _, C = x.shape
    W = w.shape[0]
    xpad = torch.cat([prev.to(x.dtype), x], dim=1)           # (B, W, C)
    out = (xpad.float() * w.float()[None]).sum(dim=1, keepdim=True)
    out = out.to(x.dtype)
    out = F.silu(out + b.to(out.dtype))
    tail = xpad[:, 1:] if W > 1 else x.new_zeros((B, 0, C))
    return out, tail


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., q) -> (..., q, q): out[i, j] = sum a[j+1..i], -inf above the
    diagonal."""
    q = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    d = cum[..., :, None] - cum[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=a.device).tril()
    return d.masked_fill(~mask, float("-inf"))


def _rep_heads(t: torch.Tensor, rep: int, dim: int) -> torch.Tensor:
    """Each group repeated ``rep`` times along ``dim`` (``jnp.repeat``), as
    a broadcast: ``repeat_interleave`` sums its repeats on the host, a sync
    a captured decode cannot hold."""
    shape = list(t.shape)
    out = t.unsqueeze(dim + 1).expand(*shape[:dim + 1], rep,
                                      *shape[dim + 1:])
    return out.reshape(*shape[:dim], shape[dim] * rep, *shape[dim + 1:])


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
             init_state: torch.Tensor | None = None):
    """Chunked SSD.  x (B,L,H,P); dt (B,L,H) post-softplus; A (H,)
    negative; Bm, Cm (B,L,G,N).  Returns y (B,L,H,P) f32 and the final
    state (B,H,P,N) f32.  The recurrence over chunks is a loop of L/chunk
    steps; everything else is one batched product per term."""
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Q = min(chunk, L)
    if L % Q:
        raise ValueError(f"sequence {L} is not a multiple of the chunk {Q}")
    nc = L // Q
    f32 = torch.float32
    xb = (x * dt[..., None]).to(f32).reshape(Bsz, nc, Q, H, P)
    a = (dt * A[None, None, :]).to(f32)                       # (B,L,H)
    ab = a.reshape(Bsz, nc, Q, H).permute(0, 3, 1, 2)          # (B,H,nc,Q)
    a_cum = torch.cumsum(ab, dim=-1)
    Bh = _rep_heads(Bm.to(f32).reshape(Bsz, nc, Q, G, N), rep, 3)
    Ch = _rep_heads(Cm.to(f32).reshape(Bsz, nc, Q, G, N), rep, 3)

    # 1. intra-chunk (diagonal blocks)
    Ldec = torch.exp(_segsum(ab))                              # (B,H,nc,Q,Q)
    scores = torch.einsum("bclhn,bcshn->bhcls", Ch, Bh)
    y_diag = torch.einsum("bhcls,bcshp->bclhp", scores * Ldec, xb)

    # 2. per-chunk input states
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)          # (B,H,nc,Q)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", Bh, decay_states, xb)

    # 3. the recurrence over chunks
    chunk_decay = torch.exp(a_cum[..., -1])                    # (B,H,nc)
    s = (init_state.to(f32) if init_state is not None
         else x.new_zeros((Bsz, H, P, N), dtype=f32))
    entering = []
    for c in range(nc):
        entering.append(s)
        s = s * chunk_decay[:, :, c, None, None] + states[:, c]
    prev_states = torch.stack(entering, dim=1)                 # (B,nc,H,P,N)

    # 4. the states' contribution to the outputs
    out_decay = torch.exp(a_cum)                               # (B,H,nc,Q)
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", Ch, prev_states,
                         out_decay)
    return (y_diag + y_off).reshape(Bsz, L, H, P), s


def _gated_out(p: SSD, x: torch.Tensor, y: torch.Tensor, xs: torch.Tensor,
               z: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x + out_proj(gnorm((y + D xs) * silu(z))), y (B,S,H,P) f32."""
    B, S, H, P = y.shape
    d_inner = H * P
    y = y + xs.reshape(B, S, H, P).float() * p.D_skip[:, None]
    y = y.reshape(B, S, d_inner)
    y = _gnorm(p, (y * F.silu(z.float())).to(x.dtype), cfg)
    return x + row_parallel(p, y, p.out_proj)


def _gnorm(p: SSD, y: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The gated RMSNorm over the whole d_inner.  On a mesh y holds the
    rank's heads: each row's f32 sum of squares is summed over the axes
    the heads are cut over, then the rank's slice is scaled (``rmsnorm``'s
    arithmetic, its mean taken over the whole width)."""
    tp = getattr(p, "tp", None)
    if tp is None:
        return rmsnorm(y, p.gnorm, cfg.norm_eps)
    yf = y.float()
    # the whole variance scales the rank's own columns: it enters them
    var = tp.enter(tp.reduce(yf.square().sum(-1, keepdim=True))) / (
        yf.shape[-1] * tp.shards)
    out = yf * torch.rsqrt(var + cfg.norm_eps)
    return (out * (1.0 + p.gnorm.float())).to(y.dtype)


def ssd_block(p: SSD, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence mamba2 block.  x (B,S,D)."""
    d_inner, H, P, G, N, conv_dim, _ = _dims(cfg)
    B, S, _ = x.shape
    z, xBC, dt = _project(p, x, cfg)
    xBC, _ = _causal_conv(xBC, p.conv_w, p.conv_b)
    xs = xBC[..., :d_inner]
    Bm = xBC[..., d_inner:d_inner + G * N].reshape(B, S, G, N)
    Cm = xBC[..., d_inner + G * N:].reshape(B, S, G, N)
    dt = softplus(dt.float() + p.dt_bias)
    A = -torch.exp(p.A_log)
    y, _ = ssd_scan(xs.reshape(B, S, H, P), dt, A, Bm, Cm, cfg.ssm_chunk)
    return _gated_out(p, x, y, xs, z, cfg)


def ssd_prefill(p: SSD, x: torch.Tensor, state: SSMState,
                positions: torch.Tensor, cfg: ModelConfig, *,
                continuation: bool = False) -> tuple[torch.Tensor, SSMState]:
    """Prompt absorption: the chunked scan from ``state`` (its carried
    state and conv tail), which it then overwrites in place with the
    state after the span's last real token.

    positions (B,S): negative positions are inert bucket padding — their
    conv input is zeroed and dt forced to 0, so the step decays by exp(0)
    = 1 and adds nothing: the carried state passes through.  Cold spans
    are left-padded; ``continuation=True`` spans are RIGHT-padded so the
    conv window crosses from ``state.conv`` straight into the new tokens,
    and the conv tail is taken at the last real column."""
    d_inner, H, P, G, N, conv_dim, _ = _dims(cfg)
    B, S, _ = x.shape
    valid = (positions >= 0)[..., None]                        # (B,S,1)
    z, xBC, dt = _project(p, x, cfg)
    xBC = xBC.masked_fill(~valid, 0)
    tail_index = valid[..., 0].sum(dim=1) if continuation else None
    xBC, conv_tail = _causal_conv(xBC, p.conv_w, p.conv_b, prev=state.conv,
                                  tail_index=tail_index)
    xs = xBC[..., :d_inner]
    Bm = xBC[..., d_inner:d_inner + G * N].reshape(B, S, G, N)
    Cm = xBC[..., d_inner + G * N:].reshape(B, S, G, N)
    dt = softplus(dt.float() + p.dt_bias)
    dt = dt.masked_fill(~valid, 0.0)
    A = -torch.exp(p.A_log)
    y, s_final = ssd_scan(xs.reshape(B, S, H, P), dt, A, Bm, Cm,
                          cfg.ssm_chunk, init_state=state.ssd)
    out = _gated_out(p, x, y, xs, z, cfg)
    state.ssd.copy_(s_final)
    state.conv.copy_(conv_tail)
    return out, state


def init_ssm_state(cfg: ModelConfig, batch: int, device=None) -> SSMState:
    """A zero state: the SSD state in f32 (a bf16 state would drift over a
    long sequence), the conv tail in the model dtype."""
    d_inner, H, P, G, N, conv_dim, _ = _dims(cfg)
    return SSMState(
        ssd=torch.zeros((batch, H, P, N), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim),
                         dtype=cfg.dtype, device=device))


def ssd_decode(p: SSD, x: torch.Tensor, state: SSMState,
               cfg: ModelConfig) -> tuple[torch.Tensor, SSMState]:
    """One-token decode.  x (B,1,D); ``state`` updated in place."""
    d_inner, H, P, G, N, conv_dim, _ = _dims(cfg)
    B = x.shape[0]
    z, xBC, dt = _project(p, x, cfg)
    xBC, conv_tail = _causal_conv_step(xBC, p.conv_w, p.conv_b, state.conv)
    xs = xBC[:, 0, :d_inner]
    Bm = xBC[:, 0, d_inner:d_inner + G * N].reshape(B, G, N)
    Cm = xBC[:, 0, d_inner + G * N:].reshape(B, G, N)
    dt = softplus(dt[:, 0].float() + p.dt_bias)                     # (B,H)
    A = -torch.exp(p.A_log)
    dA = torch.exp(dt * A[None, :])                                 # (B,H)
    xh = xs.reshape(B, H, P).float() * dt[..., None]
    rep = H // G
    Bh = _rep_heads(Bm.float(), rep, 1)                             # (B,H,N)
    Ch = _rep_heads(Cm.float(), rep, 1)
    s_new = state.ssd * dA[..., None, None] + xh[..., None] * Bh[:, :, None]
    y = torch.einsum("bhpn,bhn->bhp", s_new, Ch)
    out = _gated_out(p, x, y[:, None], xs[:, None], z, cfg)
    state.ssd.copy_(s_new)
    state.conv.copy_(conv_tail)
    return out, state
