"""Fused uncertainty probe: the CUDA kernel for CUDA tensors, the plain
version (``ref.py``) for CPU tensors.  No fallback: a CUDA tensor the kernel
cannot take raises.

``uncertainty_plan`` decides, for a CUDA call, how many blocks (one
thread-block cluster) split each row over the vocabulary and how many
logits each takes; the wrapper passes it to the C entry point.
``UncertaintyPlan.parts`` and ``UncertaintyPlan.owned`` mirror which logits
each block and each of its threads reads (scalar head, 16-byte vector body,
scalar tail), and ``split_merge`` mirrors the kernel's arithmetic over that
walk (partial states per thread, merged per warp, then over the cluster's
warps), so the CPU tests reach every decision the card makes."""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.swarm_uncertainty import ref as R

counts = build.LaunchCounts()
partial_counts = build.LaunchCounts()   # the partials mode (also in counts)

_DTYPES = (torch.float32, torch.bfloat16)
MAX_K = 16              # largest top-k the kernel keeps in registers
SMS = 132               # the H100's streaming multiprocessors
MAX_SPLITS = 8          # blocks per row: the portable cluster size
MIN_CHUNK = 2048        # logits a block streams at least
TARGET_BLOCKS = 3 * SMS  # ~3 blocks an SM; the kernel fits 4: one wave
CHUNK_ALIGN = 8         # chunk starts keep the row's 16-byte phase
THREADS = 256           # csrc/swarm_uncertainty.cu's block
WARPS = THREADS // 32
NEG = -1e30             # the reference's finite mask value
L2E = 1.4426950408889634


@dataclasses.dataclass(frozen=True)
class UncertaintyPlan:
    """How one CUDA call covers its ``rows`` rows of ``V`` logits:
    ``splits`` blocks per row (one cluster), block ``r`` over logits
    [r * chunk, min(V, (r + 1) * chunk)); ``vec`` logits per 16-byte load
    (4 in f32, 8 in bf16)."""

    rows: int
    V: int
    splits: int
    chunk: int
    vec: int

    @property
    def grid(self) -> int:
        return self.splits * self.rows

    def bounds(self, split: int) -> tuple[int, int]:
        c0 = min(self.V, split * self.chunk)
        return c0, min(self.V, c0 + self.chunk)

    def parts(self, row: int, split: int, base: int = 0):
        """(c0, b0, b1, c1): block ``split`` of ``row`` reads [c0, b0) and
        [b1, c1) as scalars and [b0, b1) as 16-byte vectors.  ``base`` is
        the element offset of the tensor's first logit from a 16-byte
        boundary (0 for a fresh allocation): the kernel aligns on the
        address."""
        c0, c1 = self.bounds(split)
        mis = (base + row * self.V + c0) % self.vec
        b0 = min(c1, c0 + (self.vec - mis) % self.vec)
        b1 = b0 + (c1 - b0) // self.vec * self.vec
        return c0, b0, b1, c1

    def owned(self, row: int, split: int, base: int = 0) -> torch.Tensor:
        """(THREADS, n) int64: the logit indices thread t of the block
        reads, -1 where it has fewer: its head element c0 + t, the
        elements of vectors t, t + THREADS, ... of the body, its tail
        element b1 + t."""
        c0, b0, b1, c1 = self.parts(row, split, base)
        t = torch.arange(THREADS)
        nvec = (b1 - b0) // self.vec
        per = -(-nvec // THREADS)
        v = t[:, None] + THREADS * torch.arange(per)[None]
        el = b0 + self.vec * v[..., None] + torch.arange(self.vec)
        el = torch.where((v < nvec)[..., None], el, -1).reshape(THREADS, -1)
        head = torch.where(c0 + t < b0, c0 + t, -1)
        tail = torch.where(b1 + t < c1, b1 + t, -1)
        return torch.cat([head[:, None], el, tail[:, None]], 1)


def uncertainty_plan(rows: int, V: int, k: int, dtype) -> UncertaintyPlan:
    """The launch plan of a CUDA call, or raise: as many splits (at most
    ``MAX_SPLITS``) as it takes for ``rows * splits`` to reach
    ``TARGET_BLOCKS``, while a block keeps at least ``MIN_CHUNK`` logits;
    the chunk a multiple of ``CHUNK_ALIGN`` that leaves no block empty."""
    if dtype not in _DTYPES:
        raise TypeError(f"logits must be float32/bfloat16, got {dtype}")
    if not 1 <= k <= min(V, MAX_K):
        raise ValueError(f"top-k {k} outside [1, min(V={V}, {MAX_K})]: not "
                         "supported by the kernel")
    if rows < 1:
        raise ValueError(f"rows {rows} < 1")
    splits = max(1, min(MAX_SPLITS, V // MIN_CHUNK, -(-TARGET_BLOCKS // rows)))
    while True:
        chunk = -(-V // splits)
        chunk = -(-chunk // CHUNK_ALIGN) * CHUNK_ALIGN
        if (splits - 1) * chunk < V:
            break
        splits -= 1
    return UncertaintyPlan(rows, V, splits, chunk, _vec(dtype))


def _vec(dtype) -> int:
    """Logits in one 16-byte load."""
    return 16 // (4 if dtype == torch.float32 else 2)


def _check_plan(plan: UncertaintyPlan, rows: int, V: int, dtype):
    if (plan.rows, plan.V, plan.vec) != (rows, V, _vec(dtype)):
        raise ValueError(f"plan {plan} is not one for {rows} rows of {V} "
                         f"{dtype} logits")
    if not (1 <= plan.splits <= MAX_SPLITS and plan.chunk % CHUNK_ALIGN == 0
            and (plan.splits - 1) * plan.chunk < V <= plan.splits
            * plan.chunk):
        raise ValueError(f"plan {plan}: splits in [1, {MAX_SPLITS}], a "
                         f"chunk multiple of {CHUNK_ALIGN}, every block "
                         "non-empty and V covered")


def uncertainty(logits, tokens, *, k: int = 10):
    """logits (..., V), tokens (...) -> (h_token, v_topk, h_dist), each (...)
    f32: Eq. 2's chosen-token -p log p, Eq. 3's top-k logit variance and the
    full-distribution entropy normalised by log V."""
    V = logits.shape[-1]
    _check(logits, tokens, k)
    if logits.device.type == "cpu":
        counts.plain += 1
        return R.uncertainty_ref(logits, tokens, k=k)
    return _launch(logits, tokens, k,
                   uncertainty_plan(tokens.numel(), V, k, logits.dtype))


def _check(logits, tokens, k: int):
    V = logits.shape[-1]
    if tokens.shape != logits.shape[:-1]:
        raise ValueError(f"tokens {tuple(tokens.shape)} must match logits "
                         f"{tuple(logits.shape)} without the vocab dim")
    if tokens.dtype != torch.int32 or logits.dtype not in _DTYPES:
        raise TypeError("logits must be float32/bfloat16 and tokens int32")
    if not 1 <= k <= V:
        raise ValueError(f"top-k {k} outside [1, V={V}]")
    if logits.device != tokens.device:
        raise ValueError("logits and tokens must be on one device")
    build.refuse_autograd("swarm_uncertainty", logits)
    if logits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {logits.device}")
    if logits.device.type == "cuda" and not (logits.is_contiguous()
                                             and tokens.is_contiguous()):
        raise ValueError("operands must be contiguous")


def _launch(logits, tokens, k: int, plan: UncertaintyPlan, *,
            partials: bool = False, col0: int = 0):
    """One launch of the kernel on contiguous CUDA operands, with ``plan``
    (the tests give it other plans than ``uncertainty_plan``'s): (h, v,
    hd), or with ``partials`` the (rows..., k + 4) states of
    ``uncertainty_partials``."""
    V = logits.shape[-1]
    _check_plan(plan, tokens.numel(), V, logits.dtype)
    dev = logits.device
    if partials:
        parts = torch.empty(tokens.shape + (k + 4,), dtype=torch.float32,
                            device=dev)
        outs = (None, None, None)
    else:
        parts = None
        outs = tuple(torch.empty(tokens.shape, dtype=torch.float32,
                                 device=dev) for _ in range(3))
    fn = build.kernel("swarm_uncertainty")
    build.check(fn(logits.data_ptr(), tokens.data_ptr(),
                   *(None if o is None else o.data_ptr() for o in outs),
                   None if parts is None else parts.data_ptr(), plan.rows, V,
                   k, plan.splits, plan.chunk, build.dtype_code(logits), col0,
                   math.log(V), build.stream_ptr(logits)),
                "swarm_uncertainty")
    counts.launches += 1
    return parts if partials else outs


def uncertainty_partials(logits, tokens, *, k: int = 10, col0: int = 0):
    """Row 3's partials mode, for logits whose vocabulary is cut over
    ranks: logits (..., V) columns [col0, col0 + V) of the whole rows,
    tokens (...) indices into the whole vocabulary -> (..., k + 4) f32,
    each row's (m, l, s, the chosen token's logit or NEG, its k largest
    logits) (``ref.uncertainty_partials_ref``), which ``merge_partials``
    joins over the cuts into ``uncertainty``'s outputs."""
    _check(logits, tokens, k)
    if logits.device.type == "cpu":
        counts.plain += 1
        partial_counts.plain += 1
        return R.uncertainty_partials_ref(logits, tokens, k=k, col0=col0)
    out = _launch(logits, tokens, k,
                  uncertainty_plan(tokens.numel(), logits.shape[-1], k,
                                   logits.dtype), partials=True, col0=col0)
    partial_counts.launches += 1
    return out


def merge_partials(parts: torch.Tensor, *, k: int, V: int):
    """(h_token, v_topk, h_dist) of whole rows from the partials of every
    cut of their vocabulary, ``parts`` (n, ..., k + 4) f32
    (``uncertainty_partials``), merged as the kernel merges its splits
    (``_merge``): the largest m, l and s rescaled to it, the k largest of
    the cuts' top-k, the chosen logit from the cut that holds it; h_dist
    normalised by log V of the whole vocabulary ``V``."""
    m, l, s = (parts[..., i].movedim(0, -1) for i in range(3))
    M, L, Ssum, top = _merge(m, l, s, parts[..., 4:].movedim(0, -2), k)
    chosen = parts[..., 3].amax(0)
    log_l = torch.log(L.clamp(min=1e-30))
    logp = chosen - M - log_l
    h = -logp.exp() * logp
    hd = (log_l + M - Ssum / L.clamp(min=1e-30)) / math.log(V)
    v = ((top - top.mean(-1, keepdim=True)) ** 2).mean(-1)
    return h, v, hd


def uncertainty_terms(logits, tokens, *, k: int = 10, mode: str = "token"):
    """Per-position (entropy_term, topk_variance); logits (..., N, V).
    ``mode="token"`` gives Eq. 2's chosen-token term, ``"distribution"``
    the full-softmax entropy."""
    h, v, hd = uncertainty(logits, tokens, k=k)
    return (h if mode == "token" else hd), v


# ---------------------------------------------------------------------------
# the mirror of the kernel's split-then-merge arithmetic (CPU, f32)
# ---------------------------------------------------------------------------

def _partial(z: torch.Tensor, mask: torch.Tensor, k: int):
    """The state of each row of ``z`` (..., n) over its ``mask``ed
    entries: (m, l = sum e^(z-m), s = sum z e^(z-m), its k largest,
    descending, padded with NEG), as a thread's online loop ends."""
    zm = torch.where(mask, z, torch.full_like(z, NEG))
    m = zm.max(-1).values
    e = torch.where(mask, torch.exp2((z - m[..., None]) * L2E),
                    torch.zeros_like(z))
    pad = max(0, k - z.shape[-1])
    zp = torch.nn.functional.pad(zm, (0, pad), value=NEG)
    return m, e.sum(-1), (e * torch.where(mask, z, 0.0)).sum(-1), \
        zp.topk(k, -1).values


def _merge(m, l, s, top, k: int):
    """Merge states over their last group dim (m, l, s (..., g); top
    (..., g, k)): a warp over its lanes, rank 0 over the cluster's
    warps."""
    M = m.max(-1).values
    c = torch.exp2((m - M[..., None]) * L2E)
    return M, (l * c).sum(-1), (s * c).sum(-1), \
        top.flatten(-2).topk(k, -1).values


def split_merge(logits: torch.Tensor, tokens: torch.Tensor, *, k: int = 10,
                plan: UncertaintyPlan | None = None, cuts: int = 1):
    """(h_token, v_topk, h_dist) as the kernel computes them, in f32 on the
    CPU: each thread's partial state over the logits ``plan.owned`` gives
    it, merged per warp, then the row's warps of every block of the
    cluster merged by rank 0, and its epilogue.  The kernel takes a warp's
    top-k through a candidate buffer filtered against a lower bound of its
    k-th value: the same values as the k largest of its threads' lists,
    which the mirror merges.  ``cuts`` > 1 cuts each row's vocabulary into
    that many equal runs, as the ranks of a vocabulary cut over 'model'
    hold it: each run's state is the partials mode's over it (a plan of
    its own width, ``plan`` when given), and ``merge_partials`` joins
    them.  ``plan`` defaults to ``uncertainty_plan``'s."""
    V = logits.shape[-1]
    if V % cuts:
        raise ValueError(f"{cuts} cuts do not divide V={V}")
    Vl = V // cuts
    lf = logits.detach().float().cpu().reshape(-1, V)
    tok = tokens.detach().cpu().reshape(-1).long()
    rows = lf.shape[0]
    if plan is None:
        plan = uncertainty_plan(rows, Vl, k, logits.dtype)
    _check_plan(plan, rows, Vl, logits.dtype)
    parts = torch.empty(cuts, rows, k + 4)
    for c in range(cuts):
        for r in range(rows):
            z = lf[r, c * Vl:(c + 1) * Vl]
            warps = []
            for sp in range(plan.splits):
                idx = plan.owned(r, sp)
                mask = idx >= 0
                st = _partial(z[idx.clamp(min=0)], mask, k)      # threads
                warps.append(_merge(*(t.reshape(WARPS, 32, *t.shape[1:])
                                      for t in st), k))          # warps
            m, l, s, top = _merge(*(torch.cat(t) for t in zip(*warps)), k)
            loc = int(tok[r]) - c * Vl
            chosen = z[loc] if 0 <= loc < Vl else torch.tensor(NEG)
            parts[c, r] = torch.cat([torch.stack([m, l, s, chosen]), top])
    h, v, hd = merge_partials(parts, k=k, V=V)
    lead = tokens.shape
    return h.reshape(lead), v.reshape(lead), hd.reshape(lead)
