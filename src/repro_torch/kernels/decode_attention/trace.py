"""Where a launch of the bf16 decode kernels spends its time, per phase.

    PYTHONPATH=src python -m repro_torch.kernels.decode_attention.trace

Needs one CUDA card and ``nvcc``.  Builds ``csrc/decode_attention.cu``
with ``-DDECODE_TRACE`` (a library of its own beside the normal one: the
normal build has no stamps), runs each case after a warm-up, reads back
the stamps thread 0 of every block took, and prints, over the blocks of
the launch, the median time a block spends in each phase, once with a
cold L2 (as ``chip_smoke.py`` times) and once warm (right after the same
launch):

* ``pos``: from entry to the positions read (its index, Q's copy issued,
  the positions of its range and, for row 5, the table before them);
* ``vis``: to the tiles to visit known (the ballot over tiles, and in a
  split launch the cluster's "any valid key" exchange);
* ``first``: to the first K/V tile in shared memory;
* ``tiles``: to every tile folded into the softmax;
* ``state``: to the block's (m, l, O) reduced over its warps;
* ``out``: to its share of the output written (in a split launch, the
  cluster's combine through distributed shared memory);

and, on the global timer, the spread of the blocks' entries after the
first block's (launch and wave scheduling) and the launch's span from the
first entry to the last exit.  Cycles become ns at the clock the blocks
ran at (their clock64 over global-timer time).  The cases are
``chip_smoke.py`` phase 3's decode shapes.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import ops

MARKS = 9
PHASES = ("pos", "vis", "first", "tiles", "state", "out")


def build_traced() -> ctypes.CDLL:
    src = build.CSRC / "decode_attention.cu"
    flags = (*build.NVCC_FLAGS, "-DDECODE_TRACE")
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(flags).encode())
    lib = build.BUILD_DIR / f"decode_attention-trace-{h.hexdigest()[:16]}.so"
    if not lib.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([build.nvcc(), *flags, "-o", str(lib), str(src)],
                       check=True, capture_output=True, text=True)
    cdll = ctypes.CDLL(str(lib))
    for entry in ("decode_attention", "paged_decode_attention"):
        fn = getattr(cdll, entry)
        fn.argtypes = build.SIGNATURES[entry][1]
        fn.restype = ctypes.c_int
    cdll.decode_trace_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    cdll.decode_trace_read.restype = ctypes.c_int
    return cdll


def decode_case(gen, B, T, K, G, D, fill=None):
    """``chip_smoke.py``'s row-2 case: slots 0..index valid, index from
    [T/2, T) or ``fill`` = (n_pad, lo, hi)."""
    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)
    q, k, v = randn(B, K, G, D), randn(B, T, K, D), randn(B, T, K, D)
    lo, hi = (T // 2, T) if fill is None else fill[1:]
    idx = torch.randint(lo, hi, (B,), generator=gen, device=dev,
                        dtype=torch.int32)
    ar = torch.arange(T, device=dev, dtype=torch.int32)
    pos = torch.where(ar[None] <= idx[:, None], ar[None], -1).to(
        torch.int32).contiguous()
    if fill is not None:
        pos[:, :fill[0]] = -1
    pos[0] = -1
    out = torch.empty_like(q)
    plan = ops.decode_plan(B, T, K, G, D, torch.bfloat16)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
            idx.data_ptr(), out.data_ptr(), None, B, T, K, G, D, 0,
            float(D ** -0.5), 1, plan.n_split, plan.bk, plan.stages,
            torch.cuda.current_stream().cuda_stream)
    keep = (q, k, v, pos, idx, out)
    return plan, "decode_attention", args, keep


def paged_case(gen, B, K, G, D, nb=2, L=64, S=8, p0=8, N=1024):
    """``chip_smoke.py``'s row-5 case at the paged gateway's decode: rows
    0-3 share their first block, the last row's tail is a sentinel, the
    dispatch's S delta rows from p0, the step at its last row."""
    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)
    Tl = nb * L
    q, kp, vp = randn(B, K, G, D), randn(N, L, K, D), randn(N, L, K, D)
    table = torch.randperm(N, generator=gen, device=dev)[:B * nb]
    table = table.view(B, nb).to(torch.int32)
    table[1:4, 0] = table[0, 0]
    idx = torch.full((B,), p0 + S - 1, dtype=torch.int32, device=dev)
    p0t = torch.full((B,), p0, dtype=torch.int32, device=dev)
    sl = torch.arange(Tl, dtype=torch.int32, device=dev)
    lin = torch.where(sl <= p0 + S - 1, sl, -1)
    pos = torch.full((N, L), -1, dtype=torch.int32, device=dev)
    pos[table.reshape(-1).long()] = lin.expand(B, Tl).reshape(B * nb, L)
    table[-1, -1] = N
    dk, dv = randn(B, S, K, D), randn(B, S, K, D)
    dpos = (p0 + torch.arange(S, dtype=torch.int32, device=dev)).expand(
        B, S).contiguous()
    out = torch.empty_like(q)
    plan = ops.paged_decode_plan(B, L, nb, S, K, G, D, torch.bfloat16)
    args = (q.data_ptr(), kp.data_ptr(), vp.data_ptr(), None, None,
            pos.data_ptr(), table.data_ptr(), idx.data_ptr(), p0t.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), dpos.data_ptr(), out.data_ptr(), B,
            N, L, nb, S, K, G, D, 0, 0, float(D ** -0.5), 1, 1, plan.n_split,
            plan.bk, plan.stages, torch.cuda.current_stream().cuda_stream)
    keep = (q, kp, vp, table, idx, p0t, pos, dk, dv, dpos, out)
    return plan, "paged_decode_attention", args, keep


def trace(cdll, plan, entry, args, flush, cold: bool) -> dict:
    fn = getattr(cdll, entry)
    build.check(fn(*args), entry)                        # warm-up
    torch.cuda.synchronize()
    if cold:
        flush.zero_()
        torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    build.check(fn(*args), entry)
    e.record()
    e.synchronize()
    n = int(np.prod(plan.grid))
    buf = np.zeros(n * MARKS, np.uint64)
    build.check(cdll.decode_trace_read(buf.ctypes.data, buf.size),
                "decode_trace_read")
    st = buf.reshape(n, MARKS).astype(np.float64)
    gt0, clk, gt1 = st[:, 0], st[:, 1:8], st[:, 8]
    ghz = (clk[:, -1] - clk[:, 0]).sum() / max((gt1 - gt0).sum(), 1.0)
    phases = np.diff(clk, axis=1) / ghz                  # ns, per block
    return {"blocks": n, "event_us": s.elapsed_time(e) * 1e3, "ghz": ghz,
            "median_ns": dict(zip(PHASES, np.median(phases, 0))),
            "entry_spread_ns": (float(np.median(gt0 - gt0.min())),
                                float(gt0.max() - gt0.min())),
            "span_ns": float(gt1.max() - gt0.min())}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from repro_torch.launch.serve import tier_configs
    cdll = build_traced()
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    cases = []
    for name, tc in tier_configs().items():
        K, G, D = tc.num_kv_heads, tc.num_heads // tc.num_kv_heads, \
            tc.head_dim
        cases += [(f"row 2 gateway {tc.name} B50 T128",
                   decode_case(gen, 50, 128, K, G, D)),
                  (f"row 2 gateway {tc.name} B50 T128 fill 8-15",
                   decode_case(gen, 50, 128, K, G, D, fill=(2, 8, 16))),
                  (f"row 5 paged gateway {tc.name} B50 L64 nb2 S8",
                   paged_case(gen, 50, K, G, D))]
    cases += [("row 2 smollm B8 T320", decode_case(gen, 8, 320, 3, 3, 64)),
              ("row 5 smollm B8 nb8 (T512) S8",
               paged_case(gen, 8, 3, 3, 64, nb=8, p0=400))]
    print(f"{torch.cuda.get_device_name(0)}; phases: median ns per block")
    for label, (plan, entry, args, _keep) in cases:
        for cold in (True, False):
            r = trace(cdll, plan, entry, args, flush, cold)
            ph = " ".join(f"{k} {v:.0f}" for k, v in r["median_ns"].items())
            print(f"{label}, {'cold' if cold else 'warm'} L2: grid "
                  f"{plan.grid} ({r['blocks']} blocks, bk {plan.bk}, "
                  f"{plan.stages} stages) at {r['ghz']:.2f} GHz: {ph}; "
                  f"entries after the first: median "
                  f"{r['entry_spread_ns'][0]:.0f}, last "
                  f"{r['entry_spread_ns'][1]:.0f}; span {r['span_ns']:.0f}; "
                  f"event time {r['event_us']:.1f} us")


if __name__ == "__main__":
    main()
