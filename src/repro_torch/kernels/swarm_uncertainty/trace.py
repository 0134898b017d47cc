"""Where a launch of the uncertainty kernel spends its time, per phase.

    PYTHONPATH=src python -m repro_torch.kernels.swarm_uncertainty.trace

Needs one CUDA card and ``nvcc``.  Builds ``csrc/swarm_uncertainty.cu``
with ``-DUNCERTAINTY_TRACE`` (a library of its own beside the normal one:
the normal build has no stamps), runs each case after a warm-up, reads back
the stamps thread 0 of every block took, and prints, over the blocks of
the launch, the median time a block spends in each phase, with L2 cold (a 64 MB
buffer written, as ``chip_smoke.py`` times), cold and clean (the buffer
read instead: no dirty lines to write back) and warm (right after the
same launch):

* ``first``: from entry to the first vector folded (the scalar head and
  tail folded, the first two rounds of loads issued, the warp's threshold
  seeded);
* ``stream``: to the whole chunk folded into the lanes' online states and
  the warp's candidate buffer (with its refreshes);
* ``topk``: to the warp's sorted top-k and statistics in shared memory
  (the last compaction, the shuffle merge);
* ``barrier``: to the cluster barrier passed (every block's warps out);
* ``merge``: to rank 0's merge of the cluster's warps through distributed
  shared memory (other ranks: nothing);
* ``epilogue``: to the outputs written (rank 0);

and, on the global timer, the spread of the blocks' entries after the
first block's (launch and wave scheduling), the launch's span from the
first entry to the last exit, and the share of the CUDA-event time of the
call outside that span (the launch; a spin kernel keeps the stream busy
while the host enqueues the call, as ``chip_smoke.py`` times it).  Cycles
become ns at the clock the blocks ran at (their clock64 over global-timer
time).  Beside each case, one ``torch.amax`` over the same logits, timed
the same way: a yardstick of what a plain stream of those bytes costs.
The cases are ``chip_smoke.py`` phase 3's row-3 shapes, f32 logits,
k = 10.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import subprocess

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.swarm_uncertainty import ops

MARKS = 9
PHASES = ("first", "stream", "topk", "barrier", "merge", "epilogue")


def build_traced() -> ctypes.CDLL:
    src = build.CSRC / "swarm_uncertainty.cu"
    flags = (*build.NVCC_FLAGS, "-DUNCERTAINTY_TRACE")
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(flags).encode())
    lib = build.BUILD_DIR / f"swarm_uncertainty-trace-{h.hexdigest()[:16]}.so"
    if not lib.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([build.nvcc(), *flags, "-o", str(lib), str(src)],
                       check=True, capture_output=True, text=True)
    cdll = ctypes.CDLL(str(lib))
    cdll.swarm_uncertainty.argtypes = build.SIGNATURES["swarm_uncertainty"][1]
    cdll.swarm_uncertainty.restype = ctypes.c_int
    cdll.uncertainty_trace_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    cdll.uncertainty_trace_read.restype = ctypes.c_int
    return cdll


def case(gen, B, V, dtype=torch.float32, k=10):
    dev = torch.device("cuda")
    lg = (torch.randn((B, V), generator=gen, device=dev) * 3).to(dtype)
    tok = torch.randint(0, V, (B,), generator=gen, device=dev,
                        dtype=torch.int32)
    out = [torch.empty(B, device=dev) for _ in range(3)]
    plan = ops.uncertainty_plan(B, V, k, dtype)
    args = (lg.data_ptr(), tok.data_ptr(), *(o.data_ptr() for o in out),
            None, B, V, k, plan.splits, plan.chunk, build.dtype_code(lg), 0,
            math.log(V), torch.cuda.current_stream().cuda_stream)
    return plan, args, (lg, tok, out)


def evict(flush, l2: str):
    """``"cold"``: write a buffer larger than L2 (``chip_smoke.py``'s
    flush: L2 is left full of dirty lines, written back while the next
    call reads); ``"clean"``: read it instead; ``"warm"``: nothing."""
    if l2 == "cold":
        flush.zero_()
    elif l2 == "clean":
        flush.view(torch.int32).amax()


def _timed(fn, flush, l2: str = "cold") -> float:
    """ms of one call of ``fn`` with L2 as ``l2`` says, the launch queued
    behind a spin kernel (``chip_smoke.py``'s method)."""
    torch.cuda.synchronize()
    evict(flush, l2)
    torch.cuda._sleep(5_000_000)
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e)


def amax_ms(lg, flush, l2: str, iters: int = 20) -> float:
    """A yardstick of the stream: one ``torch.amax`` over the same
    logits, timed as the kernel is (median)."""
    return float(np.median([_timed(lambda: torch.amax(lg, -1), flush, l2)
                            for _ in range(iters)]))


def trace(cdll, plan, args, flush, l2: str) -> dict:
    fn = cdll.swarm_uncertainty
    build.check(fn(*args), "swarm_uncertainty")             # warm-up
    event_ns = _timed(lambda: build.check(fn(*args), "swarm_uncertainty"),
                      flush, l2) * 1e6
    n = plan.grid
    buf = np.zeros(n * MARKS, np.uint64)
    build.check(cdll.uncertainty_trace_read(buf.ctypes.data, buf.size),
                "uncertainty_trace_read")
    st = buf.reshape(n, MARKS).astype(np.float64)
    gt0, clk, gt1 = st[:, 0], st[:, 1:8], st[:, 8]
    ghz = (clk[:, -1] - clk[:, 0]).sum() / max((gt1 - gt0).sum(), 1.0)
    phases = np.diff(clk, axis=1) / ghz                  # ns, per block
    span = float(gt1.max() - gt0.min())
    return {"blocks": n, "event_us": event_ns / 1e3, "ghz": ghz,
            "median_ns": dict(zip(PHASES, np.median(phases, 0))),
            "entry_spread_ns": (float(np.median(gt0 - gt0.min())),
                                float(gt0.max() - gt0.min())),
            "span_ns": span,
            "launch_share": max(0.0, 1.0 - span / max(event_ns, 1.0))}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from repro_torch.launch.serve import tier_configs
    cdll = build_traced()
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    cases = [("probe B8 V49152", case(gen, 8, 49152)),
             ("llama3 B8 V128256", case(gen, 8, 128256))]
    cases += [(f"gateway {tc.name} B50 V{tc.vocab_size}",
               case(gen, 50, tc.vocab_size))
              for tc in tier_configs().values()]
    one = torch.zeros(1, device="cuda")
    floor = np.median([_timed(lambda: one.add_(1.0), flush)
                       for _ in range(20)])
    print(f"{torch.cuda.get_device_name(0)}; phases: median ns per block; "
          f"a 1-element add_ timed as the kernel (cold L2): "
          f"{floor * 1e3:.1f} us")
    for label, (plan, args, keep) in cases:
        for l2 in ("cold", "clean", "warm"):
            r = trace(cdll, plan, args, flush, l2)
            ph = " ".join(f"{k} {v:.0f}" for k, v in r["median_ns"].items())
            print(f"{label}, {l2} L2: {r['blocks']} "
                  f"blocks ({plan.splits} splits of {plan.chunk}) at "
                  f"{r['ghz']:.2f} GHz: {ph}; entries after the first: "
                  f"median {r['entry_spread_ns'][0]:.0f}, last "
                  f"{r['entry_spread_ns'][1]:.0f}; span {r['span_ns']:.0f}; "
                  f"event time {r['event_us']:.1f} us, launch share "
                  f"{r['launch_share']:.2f}; torch.amax over the same "
                  f"logits {amax_ms(keep[0], flush, l2) * 1e3:.1f} us")


if __name__ == "__main__":
    main()
