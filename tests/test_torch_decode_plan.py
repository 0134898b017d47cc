"""The launch plans of the two decode kernels (``kernels.decode_attention.
ops.decode_plan`` for row 2, ``paged_decode_plan`` for row 5) and the
mirror of the kernels' walk (``DecodePlan.tiles`` / ``DecodePlan.visits``
over ``cache_slot_valid`` / ``paged_slot_valid``), on the CPU: no CUDA
kernel runs here.

* The splits of a (b, kv-head) cover every key slot exactly once, and in
  row 5 every delta row exactly once, in the last split; a tile never
  spans two pool blocks.
* ``n_split`` fills the card's 132 SMs at the main path's shapes.
* The walk skips only tiles with no valid key, and visits every
  non-sentinel tile of a row that sees none; the kernel's mask mirror is
  held to the plain version's (``ref.paged_gathered_view`` / the ``pos``
  mask) on seeded numpy inputs: the gateway's fill (16 valid slots of
  128), the paged gateway's decode, a sentinel tail, a ring dispatch
  longer than its window and the paged kernel tests' cases.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.decode_attention import ref as dref
from test_torch_paged_kernel import CASES, paged_case

BF16 = torch.bfloat16

# (B, T, K, G, D): B 1-50, T 8-2048, G 1-16, D 32-256
DECODE_SHAPES = [
    (1, 8, 1, 1, 32), (1, 100, 2, 8, 32), (1, 2048, 8, 4, 128),
    (2, 2048, 1, 16, 256), (8, 320, 3, 3, 64), (8, 256, 8, 4, 128),
    (8, 2048, 3, 3, 64), (3, 100, 2, 8, 64), (50, 128, 3, 3, 64),
    (50, 128, 8, 8, 128), (50, 2048, 4, 8, 64), (4, 513, 2, 16, 128),
]
# (B, L, nb, S, K, G, D, ring)
PAGED_SHAPES = [
    (1, 64, 1, 0, 1, 1, 32, False), (1, 64, 8, 8, 8, 4, 128, False),
    (8, 64, 8, 8, 3, 3, 64, False), (8, 64, 2, 160, 3, 3, 64, True),
    (8, 64, 2, 8, 3, 3, 64, True), (50, 64, 2, 8, 3, 3, 64, False),
    (50, 64, 2, 8, 8, 8, 128, False), (3, 8, 4, 5, 2, 8, 32, False),
    (3, 4, 2, 21, 2, 4, 64, True), (2, 128, 3, 17, 1, 16, 256, False),
    (4, 48, 5, 0, 2, 2, 64, False), (2, 64, 7, 33, 2, 4, 256, True),
]


def _ids(fmt):
    return lambda s: fmt.format(*s)


@pytest.mark.parametrize("shape", DECODE_SHAPES,
                         ids=_ids("B{}-T{}-K{}-G{}-D{}"))
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=str)
def test_decode_plan_covers_every_slot_once(shape, dtype):
    """Row 2: the grid holds every (b, kv-head) once per split, and the
    splits' tiles hold every cache slot exactly once, in order."""
    B, T, K, G, D = shape
    plan = dops.decode_plan(B, T, K, G, D, dtype)
    assert plan.body == ("mma" if dtype == BF16 else "simt")
    if plan.body == "mma":
        assert plan.grid == (plan.n_split, K, B)
        assert plan.bk in (16, 32, 64) and 2 <= plan.stages <= 4
        assert 1 <= plan.n_split <= dops.MAX_SPLIT
    else:
        assert plan.grid == (K, B) and plan.n_split == 1
    seen = np.zeros(T, np.int32)
    last = 0
    for s in range(plan.n_split):
        tiles = plan.tiles(s)
        assert tiles, f"split {s} walks no tile"
        for t in tiles:
            assert t.start == last and 0 < t.rows <= plan.bk
            seen[t.start:t.start + t.rows] += 1
            last = t.start + t.rows
    assert (seen == 1).all()


@pytest.mark.parametrize("shape", PAGED_SHAPES,
                         ids=_ids("B{}-L{}-nb{}-S{}-K{}-G{}-D{}-ring{}"))
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=str)
def test_paged_plan_covers_every_slot_once(shape, dtype):
    """Row 5: the splits divide the table entries, each entry's L slots in
    tiles that stay inside the entry's block, and the S delta rows come
    once, all in the last split."""
    B, L, nb, S, K, G, D, _ = shape
    plan = dops.paged_decode_plan(B, L, nb, S, K, G, D, dtype)
    assert plan.slots == nb * L + S and plan.n_split <= nb
    seen = np.zeros(nb * L + S, np.int32)
    for s in range(plan.n_split):
        for t in plan.tiles(s):
            assert 0 < t.rows <= plan.bk
            if t.delta:
                assert s == plan.n_split - 1 and t.start >= nb * L
            else:
                e = t.entry
                assert e * L <= t.start and t.start + t.rows <= (e + 1) * L
            seen[t.start:t.start + t.rows] += 1
    assert (seen == 1).all()


def _gateway_tiers():
    from repro_torch.launch.serve import tier_configs
    return [(n, c.num_kv_heads, c.num_heads // c.num_kv_heads, c.head_dim)
            for n, c in tier_configs().items()]


@pytest.mark.parametrize("tier", ["probe", "edge_1b", "edge_qwen", "cloud"])
def test_n_split_fills_the_card_at_the_gateway(tier):
    """At each tier's gateway decode (B=50 over the 128-slot cache; paged:
    two 64-slot blocks and 8 delta rows) B*K*n_split covers the 132 SMs in
    one round of blocks, and both decodes cut the keys into the same tiles
    (with the overlay, the paged decode then runs the monolithic one's
    arithmetic: chip_smoke.py phase 7p)."""
    (_, K, G, D), = [t for t in _gateway_tiers() if t[0] == tier]
    plan = dops.decode_plan(50, 128, K, G, D, BF16)
    paged = dops.paged_decode_plan(50, 64, 2, 8, K, G, D, BF16)
    for p, tiles in ((plan, -(-128 // plan.bk)),
                     (paged, len(paged.tiles(0)))):
        assert 50 * K * p.n_split >= dops.SMS
        smem = dops.smem_bytes(D, p.bk, p.stages, tiles,
                               2 if p.paged else 0)
        assert dops.waves(50 * K * p.n_split, smem) == 1
    assert (plan.bk, plan.n_split) == (paged.bk, paged.n_split)
    assert paged.overlay


@pytest.mark.parametrize("B,T,K,G,D", [(8, 320, 3, 3, 64),
                                       (8, 320, 8, 4, 128),
                                       (8, 256, 3, 3, 64)])
def test_n_split_fills_the_card_at_the_probe_generate(B, T, K, G, D):
    """Phases 4-5's decode (B=8 over the 256/320-slot caches): 24 or 64
    (b, kv-head) pairs, split until the grid covers the 132 SMs."""
    plan = dops.decode_plan(B, T, K, G, D, BF16)
    assert plan.n_split > 1 and B * K * plan.n_split >= dops.SMS
    # the paged probe: 5 blocks of 64 per row
    paged = dops.paged_decode_plan(B, 64, 5, 8, K, G, D, BF16)
    assert B * K * paged.n_split >= min(dops.SMS, B * K * 5)


@pytest.mark.parametrize("D,G", [(24, 3), (8, 2), (272, 2), (64, 17)])
def test_bf16_plan_refuses_what_the_kernel_cannot_take(D, G):
    """The tensor-core body steps D by mma's 16 up to 256 and holds up to
    16 query heads per KV head; f32 takes any D up to 256."""
    with pytest.raises(ValueError):
        dops.decode_plan(2, 64, 2, G, D, BF16)
    with pytest.raises(ValueError):
        dops.paged_decode_plan(2, 64, 2, 0, 2, G, D, BF16)
    if D <= 256 and G <= 16:
        assert dops.decode_plan(2, 64, 2, G, D, torch.float32).body == "simt"


def _check_walk(plan, valid, sentinel=None):
    """The mirror's visits against ``valid`` (B, slots), the plain
    version's mask: in the mma body a row that sees a key visits exactly
    the tiles holding one, in every split; a row that sees none, and every
    row in the simt body, every non-sentinel tile."""
    visits = plan.visits(valid, sentinel)
    n_vis = n_all = 0
    for b, per in enumerate(visits):
        row_any = bool(valid[b].any())
        for s, got in enumerate(per):
            tiles = plan.tiles(s)
            real = [t for t in tiles if t.entry is None or sentinel is None
                    or not bool(sentinel[b, t.entry])]
            if row_any and plan.body == "mma":
                want = [t for t in real
                        if bool(valid[b, t.start:t.start + t.rows].any())]
            else:
                want = real
            assert got == want, (b, s)
            n_vis += len(got)
            n_all += len(tiles)
    return n_vis, n_all


def _gateway_fill(B, T, n_pad, rng):
    """The gateway's monolithic cache at a decode step: prompt columns
    bucketed to 8 (the first n_pad padding, pos -1), then the step's
    positions; index 8-15, every later slot empty."""
    idx = rng.integers(8, 16, B).astype(np.int32)
    ar = np.arange(T, dtype=np.int32)
    pos = np.where(ar[None] <= idx[:, None], ar[None] - n_pad, -1)
    pos = np.where(pos < 0, -1, pos).astype(np.int32)
    return torch.from_numpy(pos), torch.from_numpy(idx - n_pad)


@pytest.mark.parametrize("case", ["gateway-fill", "random-index",
                                  "row-without-key", "window"])
def test_decode_walk_skips_only_empty_tiles(case):
    """Row 2's walk over seeded caches, against the plain version's mask
    (the slots ``decode_attention_ref`` lets through)."""
    rng = np.random.default_rng(7)
    B, T, K, G, D = 50, 128, 3, 3, 64
    window = None
    if case == "gateway-fill":
        pos, idx = _gateway_fill(B, T, 2, rng)
    else:
        idx = torch.from_numpy(rng.integers(T // 2, T, B).astype(np.int32))
        ar = torch.arange(T, dtype=torch.int32)
        pos = torch.where(ar[None] <= idx[:, None], ar[None], -1).to(
            torch.int32)
        if case == "row-without-key":
            pos[0] = -1
        if case == "window":
            window = 32
    valid = dops.cache_slot_valid(pos, idx, window)
    # the plain version's own mask: with q = 0 it weighs the slots it
    # attends alike, and V's one-hot rows (D = T) read them out
    v = torch.eye(T)[None, :, None, :].expand(B, T, 1, T).contiguous()
    out = dref.decode_attention_ref(torch.zeros(B, 1, 1, T),
                                    torch.zeros(B, T, 1, T), v, pos, idx,
                                    window=window)[:, 0, 0]
    seen = valid.any(1)
    assert torch.equal(valid[seen], out[seen] > 0)
    assert not bool(seen[0]) if case == "row-without-key" else seen.all()
    plan = dops.decode_plan(B, T, K, G, D, BF16)
    n_vis, n_all = _check_walk(plan, valid)
    if case == "gateway-fill":                # one tile of two per row
        assert (n_vis, n_all) == (B, 2 * B)
    simt = dops.decode_plan(B, T, K, G, D, torch.float32)
    assert _check_walk(simt, valid) == (B * 4, B * 4)   # every 32-row tile


def test_decode_walk_of_a_split_row_without_key():
    """A split launch (B=2, T=2048: 8 blocks per (b, kv-head)): row 0 sees
    no key and visits every tile of every split; row 1 sees 100 keys and
    visits only the tiles holding them."""
    B, T = 2, 2048
    plan = dops.decode_plan(B, T, 8, 4, 128, BF16)
    assert plan.n_split == 8
    pos = torch.full((B, T), -1, dtype=torch.int32)
    pos[1, 1000:1100] = torch.arange(100, dtype=torch.int32)
    idx = torch.tensor([50, 99], dtype=torch.int32)
    valid = dops.cache_slot_valid(pos, idx)
    visits = plan.visits(valid)
    assert sum(len(v) for v in visits[0]) == -(-T // plan.bk)
    got = [t.start for v in visits[1] for t in v]
    assert got == [t for t in range(0, T, plan.bk)
                   if t + plan.bk > 1000 and t < 1100]


def _paged_torch(c):
    t = {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in c.items() if isinstance(v, np.ndarray)}
    kw = dict(window=c["window"])
    if "dk" in t:
        kw.update(delta_k=t["dk"], delta_v=t["dv"], delta_pos=t["dpos"],
                  p0=t["p0"])
    return t, kw


def _ref_valid(t, kw):
    """The plain version's mask over its gathered view."""
    _, _, pos = dref.paged_gathered_view(t["kp"], t["vp"], t["pos"],
                                         t["table"], t["idx"], **kw)
    idx = t["idx"][:, None]
    valid = (pos >= 0) & (pos <= idx)
    if kw["window"] is not None:
        valid &= idx - pos < kw["window"]
    return valid


def _sources(valid, table, L, nbl, placed=None):
    """Per row, the set of keys a mask attends: ("pool", block, row) or
    ("delta", s); ``placed`` (B, nbl) int maps an overlaid slot to its
    delta row (-1 elsewhere)."""
    out = []
    for b in range(valid.shape[0]):
        keys = set()
        for j in torch.nonzero(valid[b]).flatten().tolist():
            if j >= nbl:
                keys.add(("delta", j - nbl))
            elif placed is not None and int(placed[b, j]) >= 0:
                keys.add(("delta", int(placed[b, j])))
            else:
                keys.add(("pool", int(table[b, j // L]), j % L))
        out.append(keys)
    return out


def _paged_walk(c, dtype=BF16, quantized=False):
    """The plan, the kernel's mask in its own placement and the sentinels
    of case ``c``; the mask mirror is held to the plain version's, and the
    kernel's placement to the same keys."""
    t, kw = _paged_torch(c)
    valid, sentinel = dops.paged_slot_valid(
        t["pos"], t["table"], t["idx"], window=kw["window"],
        p0=kw.get("p0"), delta_pos=kw.get("delta_pos"))
    assert torch.equal(valid, _ref_valid(t, kw))
    B, K, G, D = c["q"].shape
    N, L = c["pos"].shape
    nb = c["table"].shape[1]
    S = c["dpos"].shape[1] if "dpos" in c else 0
    plan = dops.paged_decode_plan(B, L, nb, S, K, G, D, dtype,
                                  quantized=quantized,
                                  ring=kw["window"] is not None)
    placed = dops.kernel_slot_valid(plan, valid, sentinel, t["idx"],
                                    kw.get("p0"))
    nbl = nb * L
    where = torch.full((B, nbl), -1)
    if plan.overlay:
        for b in range(B):
            for j in range(nbl):
                s = j - int(t["p0"][b])
                if 0 <= s < S and j <= int(t["idx"][b]) and \
                        not bool(sentinel[b, j // L]):
                    where[b, j] = s
    assert _sources(placed, t["table"], L, nbl, where) == \
        _sources(valid, t["table"], L, nbl)
    return plan, placed, sentinel


@pytest.mark.parametrize("quantized", [False, True],
                         ids=["bf16-pool", "int8-pool"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_paged_walk_matches_the_plain_mask(name, quantized):
    """Row 5's mask mirror equals the plain version's over its gathered
    view (sentinels, covered slots, ring and linear, delta rows), its
    placement in the kernel (delta rows overlaid on covered slots for a
    bf16 pool) attends the same keys, and the walk visits exactly the
    tiles holding a valid key."""
    c = paged_case(**{"B": 4, "nb": 4, "L": 8, "N": 20, **CASES[name]})
    plan, valid, sentinel = _paged_walk(c, quantized=quantized)
    _check_walk(plan, valid, sentinel)


def _paged_gateway(B=50, nb=2, L=64, S=8, p0=8, N=1024, window=None,
                   seed=0):
    """chip_smoke's row-5 case in numpy: rows of ``nb`` table entries (rows
    0-3 sharing their first block, the last row's tail a sentinel), the
    dispatch's S delta rows from p0, the step at its last row."""
    rng = np.random.default_rng(seed)
    Tl = nb * L
    table = rng.permutation(N)[:B * nb].reshape(B, nb).astype(np.int32)
    table[1:4, 0] = table[0, 0]
    idx = np.full(B, p0 + S - 1, np.int32)
    sl = np.arange(Tl)
    if window is None:
        lin = np.where(sl <= p0 + S - 1, sl, -1)
    else:
        lin = np.maximum(sl + Tl * ((p0 - 1 - sl) // Tl), -1)
    pos = np.full((N, L), -1, np.int32)
    pos[table.reshape(-1)] = np.broadcast_to(lin, (B, Tl)).reshape(B * nb, L)
    table[-1, -1] = N
    D, K, G = 64, 3, 3
    return dict(q=np.zeros((B, K, G, D), np.float32),
                kp=np.zeros((N, L, K, D), np.float32),
                vp=np.zeros((N, L, K, D), np.float32), pos=pos, table=table,
                idx=idx, window=window,
                dk=np.zeros((B, S, K, D), np.float32),
                dv=np.zeros((B, S, K, D), np.float32),
                dpos=np.broadcast_to(p0 + np.arange(S, dtype=np.int32),
                                     (B, S)).copy(),
                p0=np.full(B, p0, np.int32))


def test_paged_walk_at_the_paged_gateway():
    """The paged gateway's decode (two 64-slot blocks, p0=8, S=8): the
    dispatch covers slots 8-15, whose delta rows the bf16 kernel attends in
    place, so a row visits its first block only, 1 of its 3 tiles, and
    the sentinel tail never; an
    int8 pool (no overlay) visits the first block and the delta tile."""
    c = _paged_gateway()
    plan, valid, sentinel = _paged_walk(c)
    n_vis, n_all = _check_walk(plan, valid, sentinel)
    assert plan.overlay and plan.n_split == 1
    assert (n_vis, n_all) == (50, 3 * 50)
    plan, valid, sentinel = _paged_walk(c, quantized=True)
    assert not plan.overlay
    assert _check_walk(plan, valid, sentinel) == (2 * 50, 3 * 50)


def test_paged_walk_of_a_ring_dispatch_longer_than_its_window():
    """A ring of 128 slots under a window of 128 and 160 delta rows: the
    dispatch covers the whole ring, so no pool tile is loaded; the delta
    tiles holding the last 128 positions are."""
    c = _paged_gateway(B=8, S=160, p0=300, window=128)
    plan, valid, sentinel = _paged_walk(c)
    assert not bool(valid[:, :128].any())
    _check_walk(plan, valid, sentinel)
    for per in plan.visits(valid, sentinel):
        assert all(t.delta for tiles in per for t in tiles)


def test_paged_walk_of_rows_without_key():
    """Rows whose index precedes every cached position see no key: they
    visit every tile but the sentinel entry's (the kernel's mean over the
    visited blocks)."""
    c = paged_case(B=2, nb=3, L=8, sentinel=True)
    c["idx"][:] = -1
    plan, valid, sentinel = _paged_walk(c)
    assert not bool(valid.any())
    visits = plan.visits(valid, sentinel)
    assert [sum(len(t) for t in per) for per in visits] == [2, 3]
