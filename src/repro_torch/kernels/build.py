"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` is one shared library with a plain C interface,
compiled by ``nvcc`` for ``sm_90a`` into ``<repo>/build/kernels`` (listed in
``.gitignore``) under a name keyed by a hash of the source and the flags, so
an edited source rebuilds and an unchanged one is reused.  Nothing here runs
at import: the CPU tests import every module, and this machine class has no
``nvcc``.  ``build_all`` starts one ``nvcc`` per source at once.

A library may hold more than one C entry point (``flash_attention.cu``
holds the positions-mode and the grid-offset flash attention,
``decode_attention.cu`` the monolithic and the block-table decode), so
``SIGNATURES`` names entry points, each with the library it lives in, and
``kernel`` binds an entry point.  Every C entry point takes device pointers
and the stream as ``c_void_p`` and returns ``cudaGetLastError()`` after its
launch; ``check`` turns a nonzero code into an exception, so a refused
launch never passes silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(os.environ.get(
    "REPRO_TORCH_BUILD_DIR",
    Path(__file__).resolve().parents[3] / "build" / "kernels"))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C entry points: entry point -> (library = csrc/<library>.cu, argtypes)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "flash_attention_positions": ("flash_attention",
                                  [_P] * 6 + [_I] * 8 + [_F] + [_I] * 4
                                  + [_P]),
    "flash_attention": ("flash_attention",
                        [_P] * 4 + [_I] * 8 + [_F] + [_I] * 4 + [_P]),
    "decode_attention": ("decode_attention",
                         [_P] * 6 + [_I] * 6 + [_F] + [_I] * 4 + [_P]),
    "paged_decode_attention": ("decode_attention",
                               [_P] * 13 + [_I] * 10 + [_F] + [_I] * 5
                               + [_P]),
    "swarm_uncertainty": ("swarm_uncertainty",
                          [_P] * 5 + [_I] * 5 + [_I, _F, _P]),
}
LIBRARIES = tuple(dict.fromkeys(lib for lib, _ in SIGNATURES.values()))

_loaded: dict[str, object] = {}   # entry point -> bound ctypes function


def dtype_code(t) -> int:
    """The element-type code every C entry point takes: 0 = float32,
    1 = bfloat16 (the templates each kernel is instantiated for)."""
    import torch
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if t.dtype not in codes:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")
    return codes[t.dtype]


def pool_dtype_code(t) -> int:
    """The paged decode kernel's pool element-type code: ``dtype_code``'s
    0 = float32 and 1 = bfloat16, plus 2 = int8 and 3 = float8_e4m3fn (the
    quantized pools, which come with f32 scales)."""
    import torch
    codes = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
             torch.float8_e4m3fn: 3}
    if t.dtype not in codes:
        raise TypeError(f"pools are float32, bfloat16, int8 or "
                        f"float8_e4m3fn, got {t.dtype}")
    return codes[t.dtype]


def refuse_autograd(name: str, *tensors):
    """Raise when grad mode is on and an operand requires grad.  The
    kernels (and the wrappers' plain versions with them, so the CPU and the
    card behave alike) have no backward formula: an output without a
    ``grad_fn`` would cut the graph there and leave every parameter before
    it untrained.  Training attends through
    ``models.attention.chunked_attention``."""
    import torch
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: an operand requires grad in grad mode. "
            "Call it under torch.no_grad()/inference_mode(), or train "
            "through the training route (attn_block(..., train=True))")


_COUNTERS: list["LaunchCounts"] = []    # every wrapper's, in creation order


class LaunchCounts:
    """Per-wrapper counters: kernel launches, and calls that ran the plain
    PyTorch version instead (CPU tensors).  Every instance is registered,
    so a captured decode graph can take back what its capture counted and
    credit it on each replay (``snapshot``, ``since``, ``restore``,
    ``credit``; ``serving/graphs.py``)."""

    def __init__(self):
        self.launches = 0
        self.plain = 0
        _COUNTERS.append(self)

    def reset(self):
        self.launches = 0
        self.plain = 0


def snapshot() -> list[tuple[int, int]]:
    """(launches, plain) of every registered counter."""
    return [(c.launches, c.plain) for c in _COUNTERS]


def since(snap: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """What every counter added after ``snap``."""
    return [(c.launches - a, c.plain - b)
            for c, (a, b) in zip(_COUNTERS, snap)]


def restore(snap: list[tuple[int, int]]) -> None:
    for c, (a, b) in zip(_COUNTERS, snap):
        c.launches, c.plain = a, b


def credit(delta: list[tuple[int, int]]) -> None:
    """Add ``delta`` (from ``since``) to every counter: one replay of a
    captured graph launches what its capture recorded."""
    for c, (a, b) in zip(_COUNTERS, delta):
        c.launches += a
        c.plain += b


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "(the CUDA kernels are built at first use)")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=LIBRARIES) -> dict[str, dict]:
    """Compile every stale library in ``names`` in parallel.  Returns, per
    name, the library path, the build seconds (0.0 if it was up to date) and
    the ``-Xptxas -v`` report.  Raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, {}
    for name in names:
        lib = library_path(name)
        log = lib.with_suffix(".log")
        if lib.exists():
            out[name] = {"path": lib, "seconds": 0.0,
                         "ptxas": log.read_text() if log.exists() else ""}
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib, log, tmp, time.perf_counter())
    failed = []
    for name, (proc, lib, log, tmp, t0) in procs.items():
        report, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{report}")
            continue
        log.write_text(report)
        os.replace(tmp, lib)                 # atomic: no half-written library
        out[name] = {"path": lib, "seconds": secs, "ptxas": report}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def kernel(entry: str):
    """The ctypes function of C entry point ``entry``, its library built on
    first use."""
    fn = _loaded.get(entry)
    if fn is None:
        name, argtypes = SIGNATURES[entry]
        lib = ctypes.CDLL(str(build_all((name,))[name]["path"]))
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[entry] = fn
    return fn


def check(code: int, name: str):
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {code}")


def stream_ptr(t) -> int:
    """The raw handle of the current CUDA stream on ``t``'s device."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
