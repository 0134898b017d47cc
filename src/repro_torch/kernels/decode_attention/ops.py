"""Decode attention, two entry points: over a monolithic cache
(``decode_attention``) and through a block table over a block pool
(``paged_decode_attention``).  The CUDA kernels for CUDA tensors, the plain
versions (``ref.py``) for CPU tensors.  No fallback: a CUDA tensor the
kernels cannot take raises.

Each entry point keeps its own launch count: ``counts`` for
``decode_attention``, ``paged_counts`` for ``paged_decode_attention``;
``lse_counts`` counts ``decode_attention``'s calls with ``lse`` once more.

``decode_plan`` and ``paged_decode_plan`` decide, for a CUDA call, which
body of ``csrc/decode_attention.cu`` runs, its tile rows, ring depth and
split over keys; the wrapper passes the plan to the C entry point.
``DecodePlan.tiles`` mirrors the tiles each split walks and
``DecodePlan.visits`` which of them the kernel loads for given positions
(``cache_slot_valid`` / ``paged_slot_valid``: the kernel's mask), so the
CPU tests reach every decision the card makes."""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import ref as R

counts = build.LaunchCounts()          # decode_attention
paged_counts = build.LaunchCounts()    # paged_decode_attention
lse_counts = build.LaunchCounts()      # decode_attention with lse (also in
                                       # ``counts``)

_DTYPES = (torch.float32, torch.bfloat16)
MAX_GROUP = 16          # query heads per KV head: mma's 16-row A tile
SMS = 132               # the H100's streaming multiprocessors
MAX_SPLIT = 8           # blocks per (b, kv-head): the portable cluster size
SMEM_PER_SM = 233472    # shared memory an SM gives its blocks (227 KB)
SIMT_TILE = 32          # the f32 body's key rows per tile


@dataclasses.dataclass(frozen=True)
class Tile:
    """One tile of a split's walk: rows [start, start + rows) of the row's
    key view (row 2: cache slots; row 5: ``ref.paged_gathered_view``'s
    order, the table's nb*L pool slots and then the S delta rows).
    ``entry`` is the table entry of a pool tile, None otherwise."""

    start: int
    rows: int
    entry: int | None = None
    delta: bool = False


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """How one CUDA call covers its (B, K) (row, kv-head) pairs.

    ``body``: ``"mma"`` (bf16: the tensor-core body) or ``"simt"`` (f32:
    the CUDA-core body).  ``bk`` key rows per tile (16 per warp in the mma
    body), ``stages`` the K/V ring's depth, ``n_split`` the blocks (one
    cluster) per (b, kv-head), each over a contiguous range of tiles (row
    5: of table entries, the delta rows in the last split), ``grid`` the
    CUDA grid.  ``slots`` is the length of a row's key view: T for row 2,
    nb*L + S for row 5 (``nb``, ``L``, ``S`` set; ``nb`` = 0 for row 2).
    ``overlay`` (row 5, mma body, bf16 pool, linear table, S > 0): a covered
    pool slot attends the delta row that rewrote it in the slot's own
    place, as the monolithic cache holds it (``kernel_slot_valid``)."""

    body: str
    bk: int
    stages: int
    n_split: int
    grid: tuple
    slots: int
    nb: int = 0
    L: int = 0
    S: int = 0
    overlay: bool = False

    @property
    def paged(self) -> bool:
        return self.nb > 0

    def tiles(self, split: int) -> list[Tile]:
        """The tiles block ``split`` of a (b, kv-head) walks, in order: the
        kernel's range decode."""
        bk, ns = self.bk, self.n_split
        if not self.paged:
            n = -(-self.slots // bk)
            lo, hi = split * n // ns, (split + 1) * n // ns
            return [Tile(t * bk, min(bk, self.slots - t * bk))
                    for t in range(lo, hi)]
        out = []
        for e in range(split * self.nb // ns, (split + 1) * self.nb // ns):
            out += [Tile(e * self.L + r0, min(bk, self.L - r0), entry=e)
                    for r0 in range(0, self.L, bk)]
        if split == ns - 1:
            base = self.nb * self.L
            out += [Tile(base + d0, min(bk, self.S - d0), delta=True)
                    for d0 in range(0, self.S, bk)]
        return out

    def visits(self, valid: torch.Tensor, sentinel=None) -> list:
        """Per row b and split: the tiles the kernel loads and computes on,
        given ``valid`` (B, slots) bool, the kernel's mask over the row's
        key view, and (row 5) ``sentinel`` (B, nb) bool, the table entries
        the kernel never loads.  The mma body loads the tiles with a valid
        slot, or every non-sentinel tile when the row sees no key; the simt
        body every non-sentinel tile."""
        out = []
        for b in range(valid.shape[0]):
            row_any = bool(valid[b].any()) and self.body == "mma"
            per = []
            for s in range(self.n_split):
                keep = []
                for t in self.tiles(s):
                    if t.entry is not None and sentinel is not None and \
                            bool(sentinel[b, t.entry]):
                        continue
                    if row_any and not bool(
                            valid[b, t.start:t.start + t.rows].any()):
                        continue
                    keep.append(t)
                per.append(keep)
            out.append(per)
        return out


def _body(G: int, D: int, dtype) -> str:
    """The body that takes operands of ``dtype``, or raise: "simt" for
    f32, "mma" for bf16 (D a multiple of 16, mma's k-step)."""
    if G > MAX_GROUP or D > 256:
        raise ValueError(f"G={G} > {MAX_GROUP} or head_dim {D} > 256 is "
                         "not supported by the kernel")
    if dtype == torch.float32:
        return "simt"
    if dtype != torch.bfloat16:
        raise TypeError(f"decode kernels take float32 or bfloat16, got "
                        f"{dtype}")
    if D % 16 or D < 16:
        raise ValueError(f"head_dim {D}: the bf16 kernel takes multiples of "
                         f"16 up to 256 (mma's k-step is 16)")
    return "mma"


def _split(pairs: int, limit: int) -> int:
    """Blocks per (b, kv-head): enough for B*K*n_split to fill the SMs,
    at most one per tile (or table entry) and a cluster's 8."""
    return max(1, min(MAX_SPLIT, limit, -(-SMS // pairs)))


def smem_bytes(D: int, bk: int, stages: int, range_max: int,
               entries_max: int = 0, scaled: bool = False) -> int:
    """A block's dynamic shared memory: ``make_layout`` in the source."""
    dp = 32 if D <= 32 else 64 if D <= 64 else 128 if D <= 128 else 256
    rs = 2 * dp + 16

    def r16(x):
        return (x + 15) // 16 * 16
    ring = max(stages * (2 * bk * rs + (8 * bk if scaled else 0)),
               bk // 16 * 16 * (dp + 8) * 4)
    return (16 * rs + r16(ring) + 8 * (range_max + 3) + r16(4 * range_max)
            + r16(4 * entries_max) + 4 * 16 * 2 * 4 + 2 * 16 * 4 + 16)


def waves(blocks: int, smem: int) -> int:
    """Rounds of blocks the SMs run, by shared memory (an SM gives its
    blocks 227 KB, each 1 KB beside its own)."""
    per_sm = SMEM_PER_SM // (smem + 1024)
    return -(-blocks // (SMS * max(per_sm, 1)))


@functools.lru_cache(maxsize=512)
def decode_plan(B: int, T: int, K: int, G: int, D: int, dtype) -> DecodePlan:
    """The launch of ``decode_attention`` on the card.

    bf16 takes the tensor-core body: tiles of 64 rows (32 at D > 128, whose
    ring would not fit, 32 when the 64-row tiles of every (b, kv-head)
    cannot fill the SMs, and 32 when 64-row tiles would need more rounds of
    blocks than 32-row ones), split over up to 8 blocks per (b, kv-head)
    until B*K*n_split reaches the 132 SMs; a ring of up to 4 stages (3 at
    D > 64), never deeper than a split's tiles need.  f32 takes the
    CUDA-core body: one block per (b, kv-head) over every 32-row tile."""
    if _body(G, D, dtype) == "simt":
        return DecodePlan("simt", SIMT_TILE, 1, 1, (K, B), T)
    pairs = B * K

    def plan(bk):
        n_tiles = -(-T // bk)
        n_split = _split(pairs, n_tiles)
        per = -(-n_tiles // n_split)
        stages = _stages(D, per)
        return (DecodePlan("mma", bk, stages, n_split, (n_split, K, B), T),
                waves(pairs * n_split, smem_bytes(D, bk, stages, per)))
    narrow, w32 = plan(32)
    if D > 128 or (pairs * -(-T // 64) < SMS and T > 32):
        return narrow
    wide, w64 = plan(64)
    return narrow if w32 < w64 else wide


def _stages(D: int, tiles: int) -> int:
    return max(2, min(4 if D <= 64 else 3, tiles))


@functools.lru_cache(maxsize=512)
def paged_decode_plan(B: int, L: int, nb: int, S: int, K: int, G: int,
                      D: int, dtype, *, quantized: bool = False,
                      ring: bool = False) -> DecodePlan:
    """The launch of ``paged_decode_attention`` on the card.

    bf16 q (any pool type) takes the tensor-core body: tiles of the block
    length rounded up to 16-64 rows (a tile never spans two pool blocks;
    at most 32 at D > 128, and at most 32 when 64-row tiles would need
    more rounds of blocks), split over the table entries (up to 8 blocks
    per (b, kv-head), no more than nb) until B*K*n_split reaches the 132
    SMs, the delta rows in the last split.  On a bf16 pool with a linear
    table the covered slots attend their delta rows in place (``overlay``):
    the monolithic decode's tiles, key for key.  f32 q takes the CUDA-core
    body: one block per (b, kv-head)."""
    slots = nb * L + S
    if _body(G, D, dtype) == "simt":
        return DecodePlan("simt", SIMT_TILE, 1, 1, (K, B), slots, nb, L, S)
    n_split = _split(B * K, nb)
    per = -(-nb // n_split)

    def plan(cap):
        bk = 16
        while bk < min(L, cap):
            bk *= 2
        tiles = per * -(-L // bk) + -(-S // bk)
        stages = _stages(D, tiles)
        smem = smem_bytes(D, bk, stages, tiles, per, quantized)
        return (DecodePlan("mma", bk, stages, n_split, (n_split, K, B),
                           slots, nb, L, S,
                           S > 0 and not quantized and not ring),
                waves(B * K * n_split, smem))
    wide, w64 = plan(32 if D > 128 else 64)
    narrow, w32 = plan(32)
    return narrow if w32 < w64 else wide


def cache_slot_valid(pos, index, window=None) -> torch.Tensor:
    """(B, T) bool: the slots row 2 attends (0 <= pos <= index, and index -
    pos < window)."""
    idx = index[:, None]
    valid = (pos >= 0) & (pos <= idx)
    if window is not None:
        valid &= idx - pos < window
    return valid


def paged_slot_valid(pos_pool, table, index, *, window=None, p0=None,
                     delta_pos=None):
    """(valid (B, nb*L + S) bool, sentinel (B, nb) bool): row 5's mask over
    the key view as the kernel computes it, slot by slot — a pool slot of a
    non-sentinel entry is valid when its position passes and the dispatch
    did not rewrite it (covered: linear slots [p0, index]; ring layers,
    ``window`` set, (slot - p0) mod nb*L <= index - p0); a delta row when 0
    <= dpos <= index, within the window and, for ring layers, dpos > index
    - nb*L."""
    N, L = pos_pool.shape
    B, nb = table.shape
    sentinel = (table < 0) | (table >= N)
    blk = table.long().clamp(0, N - 1)
    pos = pos_pool[blk].reshape(B, nb * L)
    idx = index[:, None].long()
    valid = (pos >= 0) & (pos <= idx) & ~sentinel.repeat_interleave(L, 1)
    if window is not None:
        valid &= idx - pos < window
    if delta_pos is None:
        return valid, sentinel
    sl = torch.arange(nb * L, device=pos.device)[None]
    start = p0[:, None].long()
    if window is not None:
        covered = torch.remainder(sl - start, nb * L) <= idx - start
    else:
        covered = (sl >= start) & (sl <= idx)
    dv = (delta_pos >= 0) & (delta_pos <= idx)
    if window is not None:
        dv &= (idx - delta_pos < window) & (delta_pos > idx - nb * L)
    return torch.cat([valid & ~covered, dv], dim=1), sentinel


def kernel_slot_valid(plan: DecodePlan, valid, sentinel, index, p0):
    """``paged_slot_valid``'s mask in the kernel's placement: with
    ``plan.overlay``, delta row s of a row whose slot p0 + s is covered
    (p0 + s <= index), inside the table and of a non-sentinel entry moves
    into that pool slot, and leaves the delta rows; the keys attended are
    the same."""
    if not plan.overlay:
        return valid
    nbl = plan.nb * plan.L
    out = valid.clone()
    for b in range(valid.shape[0]):
        start = int(p0[b])
        if start < 0:
            continue
        n = max(0, min(int(index[b]) - start + 1, plan.S, nbl - start))
        for s in range(n):
            if bool(sentinel[b, (start + s) // plan.L]):
                continue
            out[b, start + s] = valid[b, nbl + s]
            out[b, nbl + s] = False
    return out


def decode_attention(q, k, v, pos, index, *, window=None, lse=False):
    """q (B,K,G,D); k,v (B,T,K,D); pos (B,T) int32 absolute positions of the
    cached keys (-1 = empty); index (B,) int32 current position.
    Returns (B,K,G,D) in q's dtype; with ``lse=True`` (o, lse): o in f32,
    not rounded, and lse (B,K,G) f32 each row's log-sum-exp over its valid
    slots, -inf (and o 0) for a row with none
    (``ref.decode_attention_ref``), for a merge over the slots other ranks
    hold that rounds once (``sharding.merge_attention``)."""
    B, K, G, D = q.shape
    T = k.shape[1]
    if k.shape != (B, T, K, D) or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}: need k,v (B,T,K,D)")
    if pos.shape != (B, T) or index.shape != (B,):
        raise ValueError("pos must be (B,T) and index (B,)")
    if pos.dtype != torch.int32 or index.dtype != torch.int32:
        raise TypeError("pos and index must be int32")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    tensors = (q, k, v, pos, index)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("all operands must be on one device")
    build.refuse_autograd("decode_attention", q, k, v)
    if q.device.type == "cpu":
        counts.plain += 1
        lse_counts.plain += lse
        return R.decode_attention_ref(q, k, v, pos, index, window=window,
                                      lse=lse)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("operands must be contiguous")
    plan = decode_plan(B, T, K, G, D, q.dtype)
    out = torch.empty_like(q, dtype=torch.float32 if lse else q.dtype)
    lse_t = (torch.empty((B, K, G), dtype=torch.float32, device=q.device)
             if lse else None)
    fn = build.kernel("decode_attention")
    build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
                   index.data_ptr(), out.data_ptr(),
                   None if lse_t is None else lse_t.data_ptr(), B, T, K, G, D,
                   int(window or 0), float(D ** -0.5), build.dtype_code(q),
                   plan.n_split, plan.bk, plan.stages, build.stream_ptr(q)),
                "decode_attention")
    counts.launches += 1
    lse_counts.launches += lse
    return (out, lse_t) if lse else out


_QUANT = (torch.int8, torch.float8_e4m3fn)


def paged_decode_attention(q, k_pool, v_pool, pos_pool, table, index, *,
                           window=None, k_scale=None, v_scale=None,
                           delta_k=None, delta_v=None, delta_pos=None,
                           p0=None):
    """One-token decode through a block table.  q (B,K,G,D); k_pool,
    v_pool (N,L,K,D); pos_pool (N,L) int32; table (B,nb) int32 pool block
    ids (>= N: a sentinel, the whole block masked); index (B,) int32.

    ``window`` set = a ring layer: the table is already cut to the window,
    and the ring is its nb*L slots.  ``k_scale``/``v_scale`` (N,L,K) f32 =
    an int8/fp8 pool.  ``delta_k``/``delta_v`` (B,S,K,D) in q's dtype,
    ``delta_pos`` (B,S) int32 and ``p0`` (B,) int32 = the dispatch's own
    decode writes: pool slots it rewrote are masked and the delta rows
    attended instead.  Returns (B,K,G,D) in q's dtype."""
    B, K, G, D = q.shape
    N, L = k_pool.shape[0], k_pool.shape[1]
    nb = table.shape[1]
    if k_pool.shape != (N, L, K, D) or v_pool.shape != k_pool.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k_pool "
                         f"{tuple(k_pool.shape)} v_pool "
                         f"{tuple(v_pool.shape)}: need pools (N,L,K,D)")
    if (pos_pool.shape != (N, L) or table.shape != (B, nb)
            or index.shape != (B,)):
        raise ValueError("pos_pool must be (N,L), table (B,nb) and index "
                         "(B,)")
    ints = [pos_pool, table, index]
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    quantized = k_scale is not None
    if quantized != (v_scale is not None):
        raise ValueError("pass both k_scale and v_scale or neither")
    if quantized:
        if k_pool.dtype not in _QUANT or v_pool.dtype != k_pool.dtype:
            raise TypeError(f"a pool with scales is int8 or float8_e4m3fn, "
                            f"got {k_pool.dtype}/{v_pool.dtype}")
        if (k_scale.shape != (N, L, K) or v_scale.shape != k_scale.shape
                or k_scale.dtype != torch.float32
                or v_scale.dtype != torch.float32):
            raise ValueError("k_scale/v_scale must be (N,L,K) float32")
    elif not (k_pool.dtype == v_pool.dtype == q.dtype):
        raise TypeError(f"q and the pools must share float32 or bfloat16, "
                        f"got {q.dtype}/{k_pool.dtype}/{v_pool.dtype}")
    delta = (delta_k, delta_v, delta_pos, p0)
    if any(t is None for t in delta) != all(t is None for t in delta):
        raise ValueError("pass all of delta_k, delta_v, delta_pos and p0 or "
                         "none")
    S = 0
    if delta_k is not None:
        S = delta_pos.shape[-1]
        if (delta_k.shape != (B, S, K, D) or delta_v.shape != delta_k.shape
                or delta_pos.shape != (B, S) or p0.shape != (B,)):
            raise ValueError("delta_k/delta_v must be (B,S,K,D), delta_pos "
                             "(B,S) and p0 (B,)")
        if delta_k.dtype != q.dtype or delta_v.dtype != q.dtype:
            raise TypeError(f"delta rows must be in q's dtype {q.dtype}, "
                            f"got {delta_k.dtype}/{delta_v.dtype}")
        ints += [delta_pos, p0]
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError("pos_pool, table, index, delta_pos and p0 must be "
                        "int32")
    tensors = [t for t in (q, k_pool, v_pool, k_scale, v_scale, pos_pool,
                           table, index, delta_k, delta_v, delta_pos, p0)
               if t is not None]
    if len({t.device for t in tensors}) != 1:
        raise ValueError("all operands must be on one device")
    kw = dict(window=window, k_scale=k_scale, v_scale=v_scale,
              delta_k=delta_k, delta_v=delta_v, delta_pos=delta_pos, p0=p0)
    build.refuse_autograd("paged_decode_attention", q, k_pool, v_pool,
                          k_scale, v_scale, delta_k, delta_v)
    if q.device.type == "cpu":
        paged_counts.plain += 1
        return R.paged_decode_attention_ref(q, k_pool, v_pool, pos_pool,
                                            table, index, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("operands must be contiguous")
    plan = paged_decode_plan(B, L, nb, S, K, G, D, q.dtype,
                             quantized=quantized, ring=window is not None)
    out = torch.empty_like(q)

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = build.kernel("paged_decode_attention")
    build.check(fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                   ptr(k_scale), ptr(v_scale), pos_pool.data_ptr(),
                   table.data_ptr(), index.data_ptr(),
                   ptr(p0), ptr(delta_k),
                   ptr(delta_v), ptr(delta_pos), out.data_ptr(), B, N, L, nb,
                   S, K, G, D, int(window or 0), int(window is not None),
                   float(D ** -0.5), build.dtype_code(q),
                   build.pool_dtype_code(k_pool), plan.n_split, plan.bk,
                   plan.stages, build.stream_ptr(q)),
                "paged_decode_attention")
    paged_counts.launches += 1
    return out
