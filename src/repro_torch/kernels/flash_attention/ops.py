"""Flash attention, two entry points: positions mode (serving prefill) and
grid-offset mode (the full-sequence forward).  The CUDA kernels for CUDA
tensors, the plain versions (``ref.py``) for CPU tensors.  No fallback: a
CUDA tensor the kernels cannot take raises.

Each entry point keeps its own launch count, so a run can tell them apart:
``counts`` for ``flash_attention_positions``, ``grid_counts`` for
``flash_attention``; ``lse_counts`` counts the positions mode's calls with
``lse`` once more.

``launch_plan`` decides, for a CUDA call, which body of
``csrc/flash_attention.cu`` runs, how its blocks map to output rows and its
tiles; the wrapper passes the plan to the C entry point, and
``LaunchPlan.block_rows`` mirrors the kernel's block -> rows decode, so the
CPU tests reach every decision the card makes."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ref as R

counts = build.LaunchCounts()          # flash_attention_positions
grid_counts = build.LaunchCounts()     # flash_attention
lse_counts = build.LaunchCounts()      # flash_attention_positions with lse
                                       # (also in ``counts``)

_DTYPES = (torch.float32, torch.bfloat16)

WG_ROWS = 64         # query rows of one consumer warpgroup (wgmma's M)
MAX_WARPGROUPS = 2   # consumer warpgroups per block


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one CUDA call covers its (B, S, H) output rows.

    ``body``: ``"wgmma"`` (bf16: the tensor-core body) or ``"simt"`` (f32:
    the CUDA-core body).  ``packed``: one row tile holds the (s, g) pairs of
    the ``G`` query heads that read one KV head (row r -> s = r // G, head
    kv * G + r % G); else each tile holds one head's rows.  ``gp`` is the
    query heads per row group (``G`` packed, 1 per head), ``tile_rows`` the
    rows of a block (64 per consumer warpgroup), ``bk`` the K/V slots per
    tile, ``dp`` the head width padded to the 128-byte swizzle rows,
    ``stages`` the K/V ring's depth, ``grid`` the CUDA grid (1-D for the
    wgmma body, whose causal grid-mode row tiles run heaviest first)."""

    body: str
    packed: bool
    gp: int
    tile_rows: int
    warpgroups: int
    bk: int
    dp: int
    stages: int
    grid: tuple
    B: int
    S: int
    H: int
    heaviest_first: bool

    def block_rows(self, block: int):
        """(b, s, h) index tensors of the output rows block ``block`` (in
        ``range(prod(grid))``, x fastest) stores: the kernel's decode."""
        if self.body == "simt":                  # grid (S tiles, H, B)
            nx, ny = self.grid[0], self.grid[1]
            x, y, z = block % nx, block // nx % ny, block // (nx * ny)
            s = torch.arange(x * self.tile_rows,
                             min((x + 1) * self.tile_rows, self.S))
            return (torch.full_like(s, z), s, torch.full_like(s, y))
        rows = self.S * self.gp
        n_hb = self.H // self.gp
        n_rt = -(-rows // self.tile_rows)
        per = n_hb * self.B
        rt = block // per
        if self.heaviest_first:
            rt = n_rt - 1 - rt
        hb, b = block % per % n_hb, block % per // n_hb
        r = torch.arange(rt * self.tile_rows,
                         min((rt + 1) * self.tile_rows, rows))
        return (torch.full_like(r, b), r // self.gp,
                hb * self.gp + r % self.gp)


def launch_plan(B: int, S: int, T: int, H: int, K: int, D: int, dtype, *,
                grid_mode: bool, causal: bool = True) -> LaunchPlan:
    """The launch of ``flash_attention`` (``grid_mode``) or
    ``flash_attention_positions`` on the card.

    bf16 takes the tensor-core body: D a multiple of 16 (wgmma's k-step),
    padded to 64, 128 or 256; K/V tiles of 128 slots (64 at D > 128).  When
    the S * G rows of one KV head fit a block (128 rows), they share one
    row tile (the gateway's S=8 prefill: K/V loaded once per KV head, not G
    times); longer spans take per-head tiles of 64 or 128 rows.  f32 takes
    the CUDA-core body: (S/64, H, B) blocks of 64 rows."""
    G = H // K
    if dtype == torch.float32:
        return LaunchPlan("simt", False, 1, WG_ROWS, 1, 32, D, 1,
                          (-(-S // WG_ROWS), H, B), B, S, H, False)
    if dtype != torch.bfloat16:
        raise TypeError(f"flash kernels take float32 or bfloat16, got {dtype}")
    if D % 16 or D > 256:
        raise ValueError(f"head_dim {D}: the bf16 kernel takes multiples of "
                         f"16 up to 256 (wgmma's k-step is 16)")
    packed = G > 1 and S * G <= MAX_WARPGROUPS * WG_ROWS
    gp = G if packed else 1
    rows = S * gp
    nwg = 1 if rows <= WG_ROWS else MAX_WARPGROUPS
    dp = 64 if D <= 64 else 128 if D <= 128 else 256
    bk = 64 if dp == 256 else 128
    tile_rows = nwg * WG_ROWS
    n_blocks = -(-rows // tile_rows) * (H // gp) * B
    stages = min(-(-T // bk), 2)       # a K/V ring of two tiles
    return LaunchPlan("wgmma", packed, gp, tile_rows, nwg, bk, dp, stages,
                      (n_blocks,), B, S, H, grid_mode and causal)


def _check_qkv(q, k, v):
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    if k.shape != (B, T, K, D) or v.shape != k.shape or H % K:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}: need k,v (B,T,K,D), H % K == 0")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")


def _check_launch(tensors, D: int):
    """What the CUDA kernels take beyond the plain versions."""
    if tensors[0].device.type != "cuda":
        raise ValueError(f"unsupported device {tensors[0].device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("operands must be contiguous")
    if D > 256:
        raise ValueError(f"head_dim {D} > 256 is not supported by the kernel")
    if tensors[0].dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 for t in tensors[:3]):
        raise ValueError("bf16 q/k/v must start on 16 bytes (TMA, 16-byte "
                         "loads)")


def flash_attention_positions(q, k, v, *, q_positions, kv_positions,
                              causal=True, window=None, lse=False):
    """q (B,S,H,D); k,v (B,T,K,D), H a multiple of K; q_positions (S,) and
    kv_positions (T,) int32 shared across the batch (negative = padding /
    empty slot).  Returns (B,S,H,D) in q's dtype; with ``lse=True`` (o,
    lse): o in f32, not rounded, and lse (B,S,H) f32 each row's
    log-sum-exp over its valid keys, -inf (and o 0) for a row with none
    (``ref.flash_attention_positions_ref``), for a merge over the slots
    other ranks hold that rounds once (``sharding.merge_attention``)."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    _check_qkv(q, k, v)
    if q_positions.shape != (S,) or kv_positions.shape != (T,):
        raise ValueError("q_positions must be (S,) and kv_positions (T,)")
    if q_positions.dtype != torch.int32 or kv_positions.dtype != torch.int32:
        raise TypeError("positions must be int32")
    tensors = (q, k, v, q_positions, kv_positions)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("all operands must be on one device")
    build.refuse_autograd("flash_attention_positions", q, k, v)
    if q.device.type == "cpu":
        counts.plain += 1
        lse_counts.plain += lse
        return R.flash_attention_positions_ref(
            q, k, v, q_positions=q_positions, kv_positions=kv_positions,
            causal=causal, window=window, lse=lse)
    _check_launch(tensors, D)
    plan = launch_plan(B, S, T, H, K, D, q.dtype, grid_mode=False,
                       causal=causal)
    out = torch.empty_like(q, dtype=torch.float32 if lse else q.dtype)
    lse_t = (torch.empty((B, S, H), dtype=torch.float32, device=q.device)
             if lse else None)
    fn = build.kernel("flash_attention_positions")
    build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   q_positions.data_ptr(), kv_positions.data_ptr(),
                   out.data_ptr(), None if lse_t is None else lse_t.data_ptr(),
                   B, S, T, H, K, D, int(causal),
                   int(window or 0), float(D ** -0.5), build.dtype_code(q),
                   plan.gp, plan.warpgroups, plan.stages,
                   build.stream_ptr(q)), "flash_attention_positions")
    counts.launches += 1
    lse_counts.launches += lse
    return (out, lse_t) if lse else out


def flash_attention(q, k, v, *, causal=True, window=None):
    """q (B,S,H,D); k,v (B,T,K,D), H a multiple of K.  Masks from grid
    offsets: query row i and key column j count from 0 (causal: i >= j;
    window: i - j < window), with no padding mask.  Returns (B,S,H,D) in
    q's dtype.  The kernel skips the KV tiles no row of a q tile can see.

    Shapes where a query row sees no key (a window with S - T >= window)
    raise: the plain version would give that row the mean of V over all T,
    the kernel a mean over the tiles it visits."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    _check_qkv(q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if window is not None and S - T >= window:
        raise ValueError(f"S={S}, T={T}, window={window}: query rows from "
                         f"T + window - 1 on see no key")
    if len({t.device for t in (q, k, v)}) != 1:
        raise ValueError("all operands must be on one device")
    build.refuse_autograd("flash_attention", q, k, v)
    if q.device.type == "cpu":
        grid_counts.plain += 1
        return R.flash_attention_ref(q, k, v, causal=causal, window=window)
    _check_launch((q, k, v), D)
    plan = launch_plan(B, S, T, H, K, D, q.dtype, grid_mode=True,
                       causal=causal)
    out = torch.empty_like(q)
    fn = build.kernel("flash_attention")
    build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   B, S, T, H, K, D, int(causal), int(window or 0),
                   float(D ** -0.5), build.dtype_code(q), plan.gp,
                   plan.warpgroups, plan.stages, build.stream_ptr(q)),
                "flash_attention")
    grid_counts.launches += 1
    return out
