"""Captured dispatches (CUDA graphs): the port of the reference's jitted
whole generations (``repro/serving/engine.py``: ``_generate_fused``,
``_generate_continue``, ``_generate_fused_paged``,
``_generate_continue_paged``) and decode dispatches (``_decode_scan``,
``_decode_scan_kernel``, ``_decode_scan_paged``).

A *generate* dispatch is a whole ``generate``: the positions of the
bucketing columns, the prefill (row 1 in every attention layer), the first
token's logits, then ``max_new`` decode steps and the Eq. 4 combine; a
paged one also gathers the pool's view and writes the blocks back.  A
*decode* dispatch is ``steps`` tokens: per step the Eq. 2-3 probe terms
(row 3), every layer's decode (row 2 on a monolithic cache, row 5 through
a block table), the next-token choice and the stacking of the outputs.  The
reference runs each as one jit; run eagerly from Python it is hundreds of
launches a step, and the host, not the card, sets the pace.
``DecodeGraphs`` captures a dispatch into one ``torch.cuda.CUDAGraph`` the
first time its key is seen and replays it after, so a dispatch is one
device call.  The key plays the role of jit's static arguments: (route,
batch, cache length or table width, steps, greedy, with_logits) for a
decode, ("generate", cold or warm, route, batch, bucket, cache length or
table width, max_new, greedy, keep) for a generate; a prompt's real length
and a continuation's start are staged data, not part of the key.  The
cache of graphs is bounded (least recently used out).

**Static addresses.**  A replay reads and writes the addresses its capture
saw.  Every tensor a dispatch takes from its caller therefore goes through
a buffer the graph owns: ``run`` copies the caller's ``inputs`` (the
pending token, its logits, the position, a block table and its state-row
ids) into the graph's staging buffers, and the caller's ``io`` tensors (a
monolithic cache: KV caches and recurrent states) into the graph's arena
before the replay and back out after it.  Both are
allocated outside the capture, so no graph's memory pool holds them; the
buffers a capture allocates itself (a paged dispatch's delta rows and
gathered state rows, the window-cut tables, a cold generate's monolithic
cache) are re-made by every replay, as the eager dispatch makes them anew.
Staging takes host tensors too (a prompt span from numpy): the buffers
live on the backend's device, and the copy in is the upload.

**Nothing that leaves a dispatch aliases the graph.**  A replay overwrites
the graph's outputs, so ``run`` hands back clones; a body's ``extra``
outputs (a cold generate's cache) are cloned only when the caller keeps
them.  Every graph of one
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
    """``fn`` over every tensor of a nest of tuples, named tuples and lists
    (None kept)."""
    if x is None:
        return None
    if hasattr(x, "_fields"):
        return type(x)(*(_tree(fn, y) for y in x))
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
        # cuBLAS creates its handle at a thread's first product, which a
        # capture cannot hold: a whole-generation graph may be the
        # process's first product, so make one here, on the capture stream
        with torch.cuda.stream(self.stream):
            for dt in (torch.float32, torch.bfloat16):
                a = torch.ones((16, 16), dtype=dt, device=device)
                torch.addmm(a, a, a)
                torch.bmm(a[None], a[None])
        self.stream.synchronize()

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

    device = None          # staging buffers on the inputs' device

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
    bytes ``run`` copied in and out of arenas and out of kept extra outputs
    (``io_bytes``: the caches a dispatch moves besides its results)."""

    def __init__(self, backend, max_graphs: int = 16):
        self.backend = backend
        self.max_graphs = max_graphs
        self.graphs: collections.OrderedDict = collections.OrderedDict()
        self.stats = {"captures": 0, "replays": 0, "capture_s": 0.0,
                      "pool_bytes": 0, "io_bytes": 0}

    def __len__(self) -> int:
        return len(self.graphs)

    def run(self, key, body: Callable, inputs: dict, io=(), *,
            gen: torch.Generator | None = None, fill: dict | None = None,
            extra: bool = False):
        """One dispatch as one replay of the graph of ``key``.

        ``body(staged, arena, gen)`` records the dispatch and returns
        ``(outputs, extra outputs)``: ``staged`` maps the names of
        ``inputs`` to the graph's staging buffers, ``arena`` holds one
        buffer per ``io`` tensor, ``gen`` is the graph's generator (None
        for a greedy dispatch).  A capture sees staging buffers of zeros,
        or of ``fill[name]``: values the dispatch may run on harmlessly (a
        sentinel block table, a span length of 1).  Returns the outputs,
        cloned, and the extra outputs, cloned when ``extra`` (else
        None)."""
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
        out, more = g.outputs
        if not extra:
            return _tree(torch.clone, out), None
        self.stats["io_bytes"] += sum(t.nbytes for t in _leaves(more))
        return _tree(torch.clone, out), _tree(torch.clone, more)

    def _capture(self, body, inputs, io, gen, fill) -> Graph:
        dev = self.backend.device
        staged = {n: torch.full(t.shape, fill.get(n, 0), dtype=t.dtype,
                                device=t.device if dev is None else dev)
                  for n, t in inputs.items()}
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
