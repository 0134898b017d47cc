"""Grid/block-shape selection shared by the Pallas kernels.

Every kernel here tiles a dimension ``D`` with a block ``b`` and a grid
of ``D // b`` steps, which is only legal when ``b`` divides ``D``.  The
historical policy ``b = min(cap, D)`` silently violated that for legal
serving geometries — e.g. a 640-slot cache (a multiple of the 64-slot
growth granule) against the decode kernel's 512 cap, or llama3's
128256-entry vocab against the uncertainty kernel's 2048 cap — and
tripped the kernels' divisibility asserts on TPU.

``snap_block`` keeps the cap as an upper bound but snaps down to the
largest divisor, so every geometry the engine can produce maps to a
legal grid.  The serving dimensions are 64/128-aligned (cache lengths
are multiples of 64, vocabularies multiples of 128), so snapped blocks
stay lane-aligned in practice.  ``tools/swarmlint``'s pallas-grid probe
sweeps every config's geometry through these choosers and fails the
build if a (dim, block) pair stops dividing.
"""
from __future__ import annotations


def snap_block(dim: int, cap: int) -> int:
    """Largest divisor of ``dim`` that is <= ``cap`` (>= 1)."""
    if dim <= 0:
        raise ValueError(f"cannot block a non-positive dim: {dim}")
    b = min(cap, dim)
    while dim % b:
        b -= 1
    return b


def decode_blocks(T: int, bt: int = 512) -> int:
    """Time-tile for ``decode_attention_pallas`` over a T-slot cache."""
    return snap_block(T, bt)


def flash_blocks(S: int, T: int, bq: int = 256,
                 bk: int = 256) -> tuple[int, int]:
    """(query, key) tiles for the flash-attention kernels."""
    return snap_block(S, bq), snap_block(T, bk)


def uncertainty_blocks(N: int, V: int, bn: int = 8,
                       bv: int = 2048) -> tuple[int, int]:
    """(row, vocab) tiles for ``uncertainty_pallas``."""
    return snap_block(N, bn), snap_block(V, bv)
