"""Captured decode dispatches (CUDA graphs): the port of the reference's
jitted ``_decode_scan`` family (``repro/serving/engine.py``:
``_decode_scan``, ``_decode_scan_kernel``, ``_decode_scan_paged``).

A *dispatch* is one call of the engine's decode over ``steps`` tokens: per
step the Eq. 2-3 probe terms (row 3), every layer's decode (row 2 on a
monolithic cache, row 5 through a block table), the next-token choice and
the stacking of the outputs.  The reference runs it as one ``lax.scan``
inside one jit; run eagerly from Python it is hundreds of launches a step,
and the host, not the card, sets the pace.  ``DecodeGraphs`` captures a
whole dispatch into one ``torch.cuda.CUDAGraph`` the first time its key is
seen and replays it after, so a dispatch is one device call.  The key
(route, batch, cache length or table width, steps, greedy, with_logits)
plays the role of jit's static arguments; the cache of graphs is bounded
(least recently used out).

**Static addresses.**  A replay reads and writes the addresses its capture
saw.  Every tensor a dispatch takes from its caller therefore goes through
a buffer the graph owns: ``run`` copies the caller's ``inputs`` (the
pending token, its logits, the position, a block table and its state-row
ids) into the graph's staging buffers, and the caller's ``io`` tensors (a
monolithic cache: KV caches and recurrent states) into the graph's arena
before the replay and back out after it.  Both are
allocated outside the capture, so no graph's memory pool holds them; the
buffers a capture allocates itself (a paged dispatch's delta rows and
gathered state rows, the window-cut tables) are re-made by every replay,
as the eager dispatch makes them anew.

**Nothing that leaves a dispatch aliases the graph.**  A replay overwrites
the graph's outputs, so ``run`` hands back clones.  Every graph of one
``DecodeGraphs`` shares one memory pool; that is safe because replays run
one at a time on one stream and their outputs are cloned before the next
replay, while inputs and arenas live outside the pool.

**Launch counts.**  The kernel wrappers count a launch where their Python
runs.  A capture runs that Python once and launches nothing, so the counts
a capture added are taken back and credited again on every replay
(``kernels.build.snapshot`` / ``credit``): a replayed path counts what the
eager loop counts.

**Sampling.**  A sampling dispatch draws from a generator.  A sampling
graph owns one, registered with the graph before capture; ``run`` sets its
state from the caller's generator before the replay and hands the advanced
state back after, so a sampled stream continues bitwise across dispatches
and equals the eager loop's draws.

**Backends.**  ``CudaGraphs`` captures on the card; the engine takes it on
a CUDA device.  ``Rerun`` is the CPU tests': its capture runs the closure
once and keeps the outputs, and each replay runs it again and copies the
results into those outputs, so staging, arenas, aliasing, counts and
generator plumbing run without a card.  The engine never picks ``Rerun``.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable

import torch

from repro_torch.kernels import build


def _tree(fn, x):
    """``fn`` over every tensor of a nest of tuples/lists (None kept)."""
    if x is None:
        return None
    if isinstance(x, (tuple, list)):
        return type(x)(_tree(fn, y) for y in x)
    return fn(x)


def _leaves(x) -> list[torch.Tensor]:
    out: list[torch.Tensor] = []
    _tree(out.append, x)
    return out


class CudaGraphs:
    """Capture on a side stream into one memory pool shared by every graph
    of the owner.  ``torch.cuda.graph`` is not used: it empties the
    allocator's cache at every capture, and every other engine's next
    dispatch would then allocate its buffers anew."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)

    def allocated(self) -> int:
        return torch.cuda.memory_allocated(self.device)

    def capture(self, fn: Callable, gen: torch.Generator | None):
        """-> (replay, outputs): ``fn()`` recorded, not run."""
        graph = torch.cuda.CUDAGraph()
        if gen is not None:
            graph.register_generator_state(gen)
        caller = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            graph.capture_begin(pool=self.pool)
            try:
                out = fn()
            finally:
                graph.capture_end()
        caller.wait_stream(self.stream)
        return graph.replay, out


class Rerun:
    """CPU stand-in for ``CudaGraphs``: the "capture" runs ``fn`` and keeps
    its outputs; each replay runs ``fn`` again, without counting its
    wrapper calls (the owner credits the capture's), and copies the results
    into the kept outputs."""

    def allocated(self) -> int:
        return 0

    def capture(self, fn: Callable, gen: torch.Generator | None):
        out = fn()

        def replay():
            snap = build.snapshot()
            new = fn()
            build.restore(snap)
            for a, b in zip(_leaves(out), _leaves(new)):
                a.copy_(b)
        return replay, out


@dataclasses.dataclass
class Graph:
    """One captured dispatch: staging ``inputs`` (name -> tensor), the
    ``arena`` for io tensors, the generator it draws from, its static
    ``outputs``, and the counts one replay credits."""
    inputs: dict
    arena: list
    gen: torch.Generator | None
    outputs: object
    replay: Callable
    delta: list


class DecodeGraphs:
    """A bounded cache of captured dispatches, keyed like jit's static
    arguments.  ``stats`` counts captures, replays, capture seconds, the
    memory the captures took (``pool_bytes``: allocated bytes after a
    capture minus before, the staging and arena not included) and the
    bytes ``run`` copied in and out of arenas (``io_bytes``)."""

    def __init__(self, backend, max_graphs: int = 16):
        self.backend = backend
        self.max_graphs = max_graphs
        self.graphs: collections.OrderedDict = collections.OrderedDict()
        self.stats = {"captures": 0, "replays": 0, "capture_s": 0.0,
                      "pool_bytes": 0, "io_bytes": 0}

    def __len__(self) -> int:
        return len(self.graphs)

    def run(self, key, body: Callable, inputs: dict, io=(), *,
            gen: torch.Generator | None = None, fill: dict | None = None):
        """One dispatch as one replay of the graph of ``key``.

        ``body(staged, arena, gen)`` records the dispatch: ``staged`` maps
        the names of ``inputs`` to the graph's staging buffers, ``arena``
        holds one buffer per ``io`` tensor, ``gen`` is the graph's
        generator (None for a greedy dispatch).  A capture sees staging
        buffers of zeros, or of ``fill[name]``: values the dispatch may
        run on harmlessly (a sentinel block table).  Returns the body's
        outputs, cloned."""
        g = self.graphs.get(key)
        if g is None:
            g = self._capture(body, inputs, io, gen, fill or {})
            self.graphs[key] = g
            while len(self.graphs) > self.max_graphs:
                self.graphs.popitem(last=False)
        else:
            self.graphs.move_to_end(key)
        for name, t in inputs.items():
            g.inputs[name].copy_(t)
        if io:
            torch._foreach_copy_(g.arena, list(io))
        if gen is not None:
            g.gen.set_state(gen.get_state())
        g.replay()
        if io:
            torch._foreach_copy_(list(io), g.arena)
            self.stats["io_bytes"] += 2 * sum(t.nbytes for t in io)
        if gen is not None:
            gen.set_state(g.gen.get_state())
        build.credit(g.delta)
        self.stats["replays"] += 1
        return _tree(torch.clone, g.outputs)

    def _capture(self, body, inputs, io, gen, fill) -> Graph:
        staged = {n: (torch.full_like(t, fill[n]) if n in fill
                      else torch.zeros_like(t)) for n, t in inputs.items()}
        arena = [torch.zeros_like(t) for t in io]
        own = None
        if gen is not None:
            own = torch.Generator(device=gen.device)
        before = build.snapshot()
        mem0 = self.backend.allocated()
        t0 = time.perf_counter()
        replay, out = self.backend.capture(
            lambda: body(staged, arena, own), own)
        secs = time.perf_counter() - t0
        pool = self.backend.allocated() - mem0
        delta = build.since(before)
        build.restore(before)
        self.stats["captures"] += 1
        self.stats["capture_s"] += secs
        self.stats["pool_bytes"] += pool
        return Graph(staged, arena, own, out, replay, delta)
