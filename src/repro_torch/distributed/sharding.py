"""Logical-axis sharding rules and the collectives of the mesh-sharded
serving and training paths (PyTorch port of
``repro/distributed/sharding.py``).

Every parameter and activation dim is tagged with a *logical* axis name;
the rules map a logical name to a chain of physical mesh axes.  A spec is
built with divisibility checking: a logical axis shards over an axis set
only when the dim's size divides the product of those axes' sizes,
otherwise it falls down its chain (ultimately replicated).  The rule
tables, the chain walk, the priority order and the trailing-``None`` trim
are the reference's, so a spec here equals the reference's
``PartitionSpec`` as a tuple.

The reference hands its specs to XLA, whose SPMD partitioner inserts the
collectives.  The port runs eagerly on each rank's local shards, so the
placement and the collectives are explicit:

* ``spec_for(shape, logical, mesh, rules)`` -> a tuple with, per dim,
  ``None``, an axis name or a tuple of axis names; ``tree_specs`` maps it
  over parallel trees of shapes and logical-axis tuples (the port's
  parameters by name: ``transformer.param_axes``; its caches:
  ``transformer.cache_axes``);
* ``local_slices`` / ``shard`` cut a rank's slice of a tensor out of the
  whole one, as a ``NamedSharding`` of that spec lays it out (a tuple of
  axes is major to minor);
* ``constrain(x, logical, mesh, rules)`` -> the rank's shard of a tensor
  every rank holds whole, by its activation rules; ``x`` itself off a mesh;
* ``Comm``: an all-reduce sum and an all-gather along a dim, each over the
  process groups of some mesh axes, and ``agree``: a host decision (a
  small integer tensor reduced by max, min or sum) that the ranks of some
  axes take alike.  A collective over axes of size 1 is not issued (XLA
  elides such collectives too), so a ``(1, 1)`` mesh computes exactly what
  one device computes, and a CUDA graph can capture it;
* ``pool_share``: a rank's share of the paged pool's blocks and state
  rows (``act_pool`` over the batch axes; a block's KV heads are those
  the rank's attention holds);
* ``Split``: what a module cut over mesh axes needs at run time (the
  collective over those axes and the rank's range of the cut dim).
  ``transformer.shard_params`` attaches one to each module whose
  contraction, vocabulary, recurrent width, SSD heads or experts it cut,
  and ``row_parallel`` sums a cut contraction;
* ``take_cols`` / ``gather_cols``: a rank's columns of a dim that is not
  one contiguous shard (the SSD's ``[z | x | B | C | dt]`` projection cut
  segment by segment, the KV heads case (b) repeats) and the whole dim
  joined back from every rank's columns, each column once;
* training: ``reduce`` / ``enter`` / ``gather`` / ``fsdp_gather``,
  collectives that autograd differentiates under one convention (a tensor
  every rank of some axes holds whole has its whole gradient on each of
  them; built on ``Comm``, so they are counted, staged on gloo and not
  issued over axes of size 1), ``gathered`` (a module's leaves cut over
  the batch axes, FSDP, joined before use) and ``Cut`` (where a rank's
  leaf lies in the whole: the training step's gradient sums and norm, and
  the checkpoints, read it).

Meshes are ``torch.distributed.device_mesh.DeviceMesh`` objects
(``launch/mesh.py``); ``spec_for`` reads only the axis sizes, so anything
with a ``shape`` mapping of axis name to size (a JAX mesh, a stub) will do
there.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import time
from typing import Any, Mapping, Sequence

import torch
import torch.distributed as dist

from repro_torch.models import quant as Q

# ---------------------------------------------------------------------------
# Rule tables (the reference's, entry for entry)
# ---------------------------------------------------------------------------

# Each logical axis maps to a *preference chain*: the first physical-axis
# tuple whose size divides the dimension wins; `None` (replicate) always
# terminates the chain implicitly.
#
# Physical axes: "pod" (cross-pod), "data" (FSDP/batch), "model" (TP).

MeshAxes = tuple[str, ...]
Chain = tuple[MeshAxes, ...]


def _chain(*alts: Sequence[str] | str | None) -> Chain:
    out = []
    for a in alts:
        if a is None:
            continue
        if isinstance(a, str):
            out.append((a,))
        else:
            out.append(tuple(a))
    return tuple(out)


# Parameter logical axes.
PARAM_RULES: dict[str, Chain] = {
    "layers": _chain(),                          # repeat-stacked layer dim
    "vocab": _chain("model"),                    # embedding / lm-head vocab
    "embed": _chain(("pod", "data"), "data"),    # d_model dim (FSDP)
    "heads": _chain("model"),                    # attention q heads (TP)
    "kv_heads": _chain("model"),                 # kv heads (TP when divisible)
    "head_dim": _chain(),
    "ffn": _chain("model"),                      # MLP hidden (TP)
    "experts": _chain("model"),                  # MoE experts (EP)
    "expert_ffn": _chain(),
    "ssm_inner": _chain("model"),                # mamba d_inner / rg-lru width
    "ssm_state": _chain(),
    "conv_width": _chain(),
    "norm": _chain(),
    "bias_ffn": _chain("model"),
    "bias_heads": _chain("model"),
}

# Activation logical axes.
ACT_RULES: dict[str, Chain] = {
    "act_batch": _chain(("pod", "data"), "data"),
    "act_seq": _chain(),                         # SP_RULES remaps this
    "act_embed": _chain(),
    "act_heads": _chain("model"),
    "act_kv_heads": _chain("model"),
    "act_head_dim": _chain(),
    "act_vocab": _chain("model"),
    "act_ffn": _chain("model"),
    "act_experts": _chain("model"),
    "act_expert_cap": _chain(),
    "act_moe_group": _chain(),                   # serving-MoE dispatch group
    "act_topk": _chain(),
    "act_expert_ffn": _chain(),
    "act_ssm_inner": _chain("model"),
    "act_state": _chain(),
    # KV-cache seq: the reference's fallback when kv_heads does not divide
    # the model axis (a sequence-sharded cache; the port does not take it:
    # transformer.shard_params)
    "act_kv_seq": _chain("model"),
    "act_pool": _chain(("pod", "data"), "data"),         # paged pool blocks
    "act_pool_scale": _chain(("pod", "data"), "data"),   # their scales
}

# Dims with lower numbers claim mesh axes first (a KV cache lists seq before
# heads in layout order, but heads should win the 'model' axis when it can).
AXIS_PRIORITY = {
    "act_kv_heads": 0, "act_heads": 0, "heads": 0, "kv_heads": 0,
    "ffn": 0, "experts": 0, "vocab": 0, "act_vocab": 0, "act_ffn": 0,
    "act_experts": 0, "ssm_inner": 0, "act_ssm_inner": 0,
    "act_batch": 0, "act_pool": 0, "act_pool_scale": 0, "embed": 1,
    "act_kv_seq": 2,
}


@dataclasses.dataclass(frozen=True, eq=False)
class ShardingRules:
    """A rule set = param rules + activation rules (both overridable),
    hashable by content (the reference passes one to ``jax.jit`` as a
    static argument)."""

    param_rules: Mapping[str, Chain] = dataclasses.field(
        default_factory=lambda: dict(PARAM_RULES))
    act_rules: Mapping[str, Chain] = dataclasses.field(
        default_factory=lambda: dict(ACT_RULES))

    def _frozen(self) -> tuple:
        return (tuple(sorted(self.param_rules.items())),
                tuple(sorted(self.act_rules.items())))

    def __hash__(self) -> int:
        return hash(self._frozen())

    def __eq__(self, other: object) -> bool:
        return (isinstance(other, ShardingRules)
                and self._frozen() == other._frozen())

    def with_overrides(self, *, params: Mapping[str, Chain] | None = None,
                       acts: Mapping[str, Chain] | None = None
                       ) -> "ShardingRules":
        p = dict(self.param_rules)
        a = dict(self.act_rules)
        if params:
            p.update(params)
        if acts:
            a.update(acts)
        return ShardingRules(param_rules=p, act_rules=a)


DEFAULT_RULES = ShardingRules()

# Sequence-parallel variant: long prefill shards seq over the model axis for
# everything outside attention (norms / MLP); attention re-gathers.
SP_RULES = DEFAULT_RULES.with_overrides(acts={"act_seq": _chain("model")})

# Decode serving: weights replicated over 'data' (pure TP over 'model'), so
# a decode step never re-gathers FSDP shards; the batch stays data-sharded.
SERVE_RULES = DEFAULT_RULES.with_overrides(
    params={"embed": _chain(), "vocab": _chain("model")},
)

RULE_SETS = {"default": DEFAULT_RULES, "sp": SP_RULES, "serve": SERVE_RULES}


# ---------------------------------------------------------------------------
# Spec construction
# ---------------------------------------------------------------------------

def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, or ``dict(mesh.shape)`` of
    anything whose ``shape`` maps axis names to sizes."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def _axis_size(sizes: Mapping[str, int], axes: MeshAxes) -> int:
    size = 1
    for a in axes:
        size *= sizes[a]
    return size


def axes_of(part) -> MeshAxes:
    """A spec entry as a tuple of axis names (() for None)."""
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def spec_for(shape: Sequence[int], logical: Sequence[str | None], mesh,
             rules: Mapping[str, Chain]) -> tuple:
    """The spec of ``shape`` given per-dim logical names.

    Divisibility-aware: each logical axis walks its preference chain and
    takes the first physical-axis tuple (a) whose axes are all present in
    the mesh, (b) not already used by an earlier dim, and (c) whose total
    size divides the dim.  Trailing ``None``s are trimmed."""
    if len(shape) != len(logical):
        raise ValueError(f"shape {tuple(shape)} and logical axes "
                         f"{tuple(logical)} differ in rank")
    sizes = axis_sizes(mesh)
    used: set[str] = set()
    parts: list[Any] = [None] * len(shape)
    order = sorted(range(len(shape)),
                   key=lambda d: AXIS_PRIORITY.get(logical[d], 1))
    for d in order:
        dim, name = shape[d], logical[d]
        if name is None:
            continue
        for axes in rules.get(name, ()):
            if any(a not in sizes for a in axes):
                continue
            if any(a in used for a in axes):
                continue
            if dim % _axis_size(sizes, axes) != 0:
                continue
            parts[d] = axes if len(axes) > 1 else axes[0]
            used.update(axes)
            break
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def _is_axes(x) -> bool:
    """A logical-axes leaf: a plain tuple of names and Nones (a named tuple
    of leaves is a node)."""
    return type(x) is tuple and all(e is None or isinstance(e, str)
                                    for e in x)


def tree_specs(shapes: Any, axes_tree: Any, mesh,
               rules: Mapping[str, Chain]) -> Any:
    """``spec_for`` over parallel trees (dicts, lists, named tuples) of
    shapes and logical-axis tuples.  A shape leaf is a tensor (its
    ``shape``) or a sequence of ints; a None on either side stays None."""
    if shapes is None or axes_tree is None:
        return None
    if _is_axes(axes_tree):
        return spec_for(tuple(getattr(shapes, "shape", shapes)), axes_tree,
                        mesh, rules)
    if isinstance(axes_tree, dict):
        return {k: tree_specs(shapes[k], a, mesh, rules)
                for k, a in axes_tree.items()}
    if isinstance(axes_tree, tuple) and hasattr(axes_tree, "_fields"):
        return type(axes_tree)(*(tree_specs(s, a, mesh, rules)
                                 for s, a in zip(shapes, axes_tree)))
    if isinstance(axes_tree, (list, tuple)):
        return type(axes_tree)(tree_specs(s, a, mesh, rules)
                               for s, a in zip(shapes, axes_tree))
    raise TypeError(f"not a logical-axes tree node: {axes_tree!r}")


# ---------------------------------------------------------------------------
# A rank's shard
# ---------------------------------------------------------------------------

def check_mesh(mesh) -> None:
    """Raise ``TypeError`` unless ``mesh`` is a ``DeviceMesh`` with named
    axes (``launch/mesh.py`` builds them)."""
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh) or mesh.mesh_dim_names is None:
        raise TypeError(f"a mesh is a DeviceMesh with named axes "
                        f"(launch.mesh.serving_mesh), got {type(mesh)!r}")


def coordinates(mesh) -> dict[str, int]:
    """{axis name: this rank's coordinate}."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def shard_index(part, mesh) -> tuple[int, int]:
    """(this rank's index, the shard count) along a dim whose spec entry is
    ``part``: the axes' coordinates read major to minor."""
    sizes, coord = axis_sizes(mesh), coordinates(mesh)
    idx, n = 0, 1
    for a in axes_of(part):
        idx, n = idx * sizes[a] + coord[a], n * sizes[a]
    return idx, n


def local_slices(shape: Sequence[int], spec: tuple, mesh) -> tuple:
    """This rank's slice of each dim of a ``shape`` tensor placed by
    ``spec`` (a ``NamedSharding`` layout: equal contiguous shards)."""
    out = []
    for d, size in enumerate(shape):
        idx, n = shard_index(spec[d] if d < len(spec) else None, mesh)
        b = size // n
        out.append(slice(idx * b, (idx + 1) * b))
    return tuple(out)


def shard(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's shard of ``t``, a copy of its own (``t`` itself when the
    spec cuts nothing)."""
    sl = local_slices(t.shape, spec, mesh)
    if all(s.stop - s.start == n for s, n in zip(sl, t.shape)):
        return t
    return t[sl].clone(memory_format=torch.contiguous_format)


def constrain(x: torch.Tensor, logical: Sequence[str | None], mesh,
              rules: ShardingRules | None = None) -> torch.Tensor:
    """This rank's shard of ``x`` (which every rank holds whole) by the
    activation rules; ``x`` itself off a mesh."""
    if mesh is None:
        return x
    rules = rules or DEFAULT_RULES
    spec = spec_for(x.shape, logical, mesh, rules.act_rules)
    return x[local_slices(x.shape, spec, mesh)]


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

class Comm:
    """Collectives over the process groups of a mesh's axes, counted.

    ``stats``: calls of each collective, the bytes they were given, the
    bytes staged through host memory and the host seconds spent inside
    them.  gloo moves CUDA tensors through host memory (a staging copy each
    way, counted in ``staged_bytes``); NCCL moves them on the device.  An
    all-reduce sums in f32 (a bf16 partial sum is widened first and the
    result rounded once; an f32 ``x``, a caller's fresh partial product,
    is summed in place), so every rank ends with the same bits."""

    def __init__(self, mesh):
        check_mesh(mesh)
        self.mesh = mesh
        self.sizes = axis_sizes(mesh)
        self.stats = {"all_reduce": 0, "all_gather": 0, "agree": 0,
                      "barrier": 0, "bytes": 0, "staged_bytes": 0,
                      "host_s": 0.0}

    def _live(self, axes) -> list[str]:
        return [a for a in axes_of(axes) if self.sizes[a] > 1]

    def _staged(self, t: torch.Tensor, group) -> bool:
        return t.is_cuda and dist.get_backend(group) == "gloo"

    def all_reduce(self, x: torch.Tensor, axes, op: str = "sum"
                   ) -> torch.Tensor:
        """The sum (``op="max"``: the maximum) of ``x`` over every rank of
        ``axes`` (x itself when they have size 1), in ``x``'s dtype."""
        live = self._live(axes)
        if not live:
            return x
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        t0 = time.perf_counter()
        with torch.profiler.record_function("mesh.all_reduce"):
            y = (x if x.dtype == torch.float32 else x.float()
                 if x.is_floating_point() else x.clone())
            for a in live:
                g = self.mesh.get_group(a)
                buf = y.cpu() if self._staged(y, g) else y
                dist.all_reduce(buf, op=red, group=g)
                if buf is not y:
                    y.copy_(buf)
                    self.stats["staged_bytes"] += 2 * buf.nbytes
                self.stats["all_reduce"] += 1
                self.stats["bytes"] += y.nbytes
            out = y.to(x.dtype)
        self.stats["host_s"] += time.perf_counter() - t0
        return out

    def all_gather(self, x: torch.Tensor, axes, dim: int = 0
                   ) -> torch.Tensor:
        """Every rank's ``x`` over ``axes`` concatenated along ``dim`` in
        shard order (a tuple of axes major to minor); x itself when they
        have size 1."""
        live = self._live(axes)
        if not live:
            return x
        t0 = time.perf_counter()
        with torch.profiler.record_function("mesh.all_gather"):
            for a in reversed(live):            # minor axis first
                g = self.mesh.get_group(a)
                src = x.contiguous()
                staged = self._staged(src, g)
                if staged:
                    src = src.cpu()
                parts = [torch.empty_like(src) for _ in range(self.sizes[a])]
                dist.all_gather(parts, src, group=g)
                y = torch.cat(parts, dim)
                if staged:
                    y = y.to(x.device)
                    self.stats["staged_bytes"] += src.nbytes + y.nbytes
                self.stats["all_gather"] += 1
                self.stats["bytes"] += src.nbytes
                x = y
        self.stats["host_s"] += time.perf_counter() - t0
        return x

    def agree(self, x, axes, op: str = "max") -> torch.Tensor:
        """A host decision every rank of ``axes`` takes alike: ``x`` (a
        small integer tensor or array, on the host) reduced elementwise by
        ``op`` ("max", "min" or "sum") over the live axes, as an int64 CPU
        tensor; ``x`` itself where they have size 1, so a (1, 1) mesh
        issues nothing.  The ranks must call it at the same points, as they
        issue every collective: a rank that raises or defers alone while
        the others enter the next collective hangs the run."""
        y = torch.as_tensor(x, dtype=torch.int64).clone()
        live = self._live(axes)
        if not live:
            return y
        red = {"max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
               "sum": dist.ReduceOp.SUM}[op]
        for a in live:
            g = self.mesh.get_group(a)
            buf = (y.cuda() if dist.get_backend(g) == "nccl" else y)
            dist.all_reduce(buf, op=red, group=g)
            y = buf.cpu()
            self.stats["agree"] += 1
        return y

    def barrier(self) -> None:
        """Wait for every rank of the world the mesh spans (nothing on a
        mesh of one rank)."""
        if self._live(tuple(self.sizes)):
            dist.barrier()
            self.stats["barrier"] += 1

    def reset(self) -> None:
        for k in self.stats:
            self.stats[k] = 0.0 if k == "host_s" else 0


#: the batch axes: a batch, the paged pool's blocks and its state rows go
#: over them (``act_batch``, ``act_pool``)
BATCH_AXES = ("pod", "data")


def batch_axes(mesh) -> MeshAxes:
    """The mesh's batch axes, major to minor."""
    sizes = axis_sizes(mesh)
    return tuple(a for a in BATCH_AXES if a in sizes)


def pool_share(n: int, mesh) -> int:
    """A rank's share of ``n`` pool blocks or state rows: ``act_pool``
    puts them over the batch axes when those divide ``n`` (each rank then
    holds ``n / d``), else every rank holds all ``n``."""
    spec = spec_for((n,), ("act_pool",), mesh, SERVE_RULES.act_rules)
    return n // shard_index(spec[0] if spec else None, mesh)[1]


def broadcast_(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Overwrite ``t`` on every rank of the world with global rank
    ``src``'s, in place (nothing in a world of one)."""
    if dist.get_world_size() == 1:
        return t
    staged = t.is_cuda and dist.get_backend() == "gloo"
    buf = t.cpu() if staged else t
    dist.broadcast(buf, src)
    if staged:
        t.copy_(buf)
    return t


# ---------------------------------------------------------------------------
# Collectives autograd differentiates (training on a mesh)
# ---------------------------------------------------------------------------
#
# One convention: a tensor that every rank of some axes holds whole has its
# whole gradient on every one of those ranks.  ``reduce`` (Megatron-LM's g)
# sums the partial products of a cut contraction and passes the gradient
# through; ``enter`` (Megatron-LM's f) passes a whole tensor into a rank's
# cut computation and sums the gradient the ranks' cuts give it; ``gather``
# joins a cut dim and hands each rank its slice of the gradient;
# ``fsdp_gather`` joins leaves cut over the batch axes (one all-gather for
# all of a layer's) and hands each rank its slice of the gradient summed
# over them (a reduce-scatter, built as an all-reduce and a slice, which
# gloo has).  Each is the plain collective (or nothing) where no gradient
# is asked for, and nothing over axes of size 1.


def _fresh(x: torch.Tensor) -> torch.Tensor:
    """A copy ``Comm.all_reduce`` may sum in place (it sums an f32 tensor
    in place)."""
    return x.clone() if x.dtype == torch.float32 else x


def _grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axes):
        return comm.all_reduce(_fresh(x), axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axes):
        ctx.comm, ctx.axes = comm, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(_fresh(g), ctx.axes), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axes, dim):
        ctx.comm, ctx.axes, ctx.dim = comm, axes, dim
        ctx.n = x.shape[dim]
        return comm.all_gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        r = shard_index(ctx.axes, ctx.comm.mesh)[0]
        return g.narrow(ctx.dim, r * ctx.n, ctx.n), None, None, None


def _join_flat(every: torch.Tensor, shapes, dims) -> list:
    """Leaves joined from ``every`` (n, total): row r the ranks' flattened
    shards one after another; leaf i's shards concatenated along
    ``dims[i]`` in shard order."""
    n = every.shape[0]
    out = []
    for part, shape, d in zip(every.split([math.prod(s) for s in shapes],
                                          dim=1), shapes, dims):
        t = part.reshape((n,) + tuple(shape)).movedim(0, d)
        out.append(t.reshape(shape[:d] + (n * shape[d],) + shape[d + 1:]))
    return out


def _split_flat(gs, shapes, dims, n: int) -> torch.Tensor:
    """``_join_flat``'s inverse: (n, total), row r every leaf's shard r."""
    rows = []
    for g, shape, d in zip(gs, shapes, dims):
        t = g.reshape(shape[:d] + (n, shape[d]) + shape[d + 1:])
        rows.append(t.movedim(d, 0).reshape(n, -1))
    return torch.cat(rows, dim=1)


class _FSDPGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, axes, dims, *xs):
        ctx.comm, ctx.axes, ctx.dims = comm, axes, dims
        ctx.shapes = [tuple(x.shape) for x in xs]
        flat = torch.cat([x.reshape(-1) for x in xs])
        every = comm.all_gather(flat, axes, 0).view(-1, flat.numel())
        return tuple(_join_flat(every, ctx.shapes, dims))

    @staticmethod
    def backward(ctx, *gs):
        r, n = shard_index(ctx.axes, ctx.comm.mesh)
        mine = ctx.comm.all_reduce(_split_flat(gs, ctx.shapes, ctx.dims, n),
                                   ctx.axes)[r]
        return (None, None, None) + tuple(
            t.view(shape) for t, shape in zip(
                mine.split([math.prod(s) for s in ctx.shapes]), ctx.shapes))


def reduce(x: torch.Tensor, comm: Comm, axes) -> torch.Tensor:
    """The sum of ``x`` over ``axes``; its gradient passes through."""
    if not comm._live(axes):
        return x
    if _grad(x):
        return _Reduce.apply(x, comm, axes)
    return comm.all_reduce(x, axes)


def enter(x: torch.Tensor, comm: Comm, axes) -> torch.Tensor:
    """``x`` itself; its gradient is summed over ``axes``."""
    if not comm._live(axes) or not _grad(x):
        return x
    return _Enter.apply(x, comm, axes)


def gather(x: torch.Tensor, comm: Comm, axes, dim: int) -> torch.Tensor:
    """Every rank's ``x`` joined along ``dim``; each rank's gradient is
    its slice of the joined one's."""
    if not comm._live(axes):
        return x
    if _grad(x):
        return _Gather.apply(x, comm, axes, dim)
    return comm.all_gather(x, axes, dim)


def fsdp_gather(xs: Sequence[torch.Tensor], comm: Comm, axes,
                dims: Sequence[int]) -> list:
    """Leaves cut over the batch axes ``axes`` (of one dtype), each joined
    along its ``dims`` entry, in one all-gather of their flattened shards;
    each rank's gradient of a leaf is its slice of the joined one's summed
    over ``axes`` (every rank ran other rows through the whole leaf), in
    one all-reduce."""
    if not comm._live(axes):
        return list(xs)
    if any(_grad(x) for x in xs):
        return list(_FSDPGather.apply(comm, tuple(axes), tuple(dims), *xs))
    flat = torch.cat([x.reshape(-1) for x in xs])
    every = comm.all_gather(flat, axes, 0).view(-1, flat.numel())
    return _join_flat(every, [tuple(x.shape) for x in xs], dims)


@dataclasses.dataclass(eq=False)
class Split:
    """A module's dim cut over mesh ``axes``: this rank holds ``[start,
    start + size)`` of it.  ``reduce`` sums a row-parallel product (its
    contraction ran over this rank's slice) over the axes; ``gather``
    joins vocabulary-parallel logits along a dim; ``enter`` passes a whole
    tensor into the rank's cut computation.  All three are
    differentiable under the convention above."""
    comm: Comm
    axes: MeshAxes
    start: int
    size: int

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return reduce(x, self.comm, self.axes)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return gather(x, self.comm, self.axes, dim)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return enter(x, self.comm, self.axes)

    @property
    def shards(self) -> int:
        """How many ranks the dim is cut over (the axes' size)."""
        return _axis_size(self.comm.sizes, self.axes)

    @property
    def index(self) -> int:
        """This rank's shard of the dim, major to minor over the axes."""
        return shard_index(self.axes, self.comm.mesh)[0]


@dataclasses.dataclass(frozen=True)
class Cut:
    """Where a rank's leaf lies in the whole one (``transformer.
    shard_params`` records one per leaf as ``model.cuts``): cut over the
    tensor-parallel axes ``tp_axes`` along ``tp_dim`` (contiguous, or, with
    ``cols``, the columns ``cols[r]`` of the whole dim for shard r), then
    over the batch axes ``dp_axes`` along ``dp_dim`` (FSDP, contiguous).
    Only axes of more than one rank are listed, so on a (1, 1) mesh a leaf
    is its whole.  ``shared``: the rank's columns along ``tp_dim`` that
    other ranks of ``tp_axes`` hold too (an SSD's B/C groups, case (b)'s
    KV head), as (their local positions, their positions in the union of
    the shared columns, the union's size, the local positions of those this
    rank is the first holder of)."""
    tp_axes: MeshAxes = ()
    tp_dim: int = 0
    cols: tuple | None = None
    dp_axes: MeshAxes = ()
    dp_dim: int = 0
    shared: tuple | None = None

    def cut(self, whole: torch.Tensor, mesh) -> torch.Tensor:
        """This rank's leaf from the whole one (a copy of its own; ``whole``
        itself where nothing is cut)."""
        spec = [None] * whole.ndim
        if self.cols is not None:
            whole = take_cols(whole, self.tp_dim, self.cols[shard_index(
                self.tp_axes, mesh)[0]])
        elif self.tp_axes:
            spec[self.tp_dim] = self.tp_axes
        if self.dp_axes:
            spec[self.dp_dim] = self.dp_axes
        return shard(whole, tuple(spec), mesh)

    def join(self, t: torch.Tensor, comm: Comm) -> torch.Tensor:
        """The whole leaf from every rank's (collectives over the cut
        axes: every rank calls it)."""
        if self.dp_axes:
            t = comm.all_gather(t, self.dp_axes, self.dp_dim)
        if self.tp_axes:
            if self.cols is not None:
                t = gather_cols(comm, t, self.tp_axes, self.tp_dim,
                                self.cols)
            else:
                t = comm.all_gather(t, self.tp_axes, self.tp_dim)
        return t


def shared_columns(per_rank: Sequence[Sequence[int]], r: int):
    """``Cut.shared`` of shard r of a dim whose shard s holds the whole
    dim's columns ``per_rank[s]``, or None when no column is held twice."""
    holders: dict[int, list[int]] = {}
    for s, cols in enumerate(per_rank):
        for c in cols:
            holders.setdefault(c, []).append(s)
    union = sorted(c for c, h in holders.items() if len(h) > 1)
    if not union:
        return None
    where = {c: i for i, c in enumerate(union)}
    mine = [(j, c) for j, c in enumerate(per_rank[r]) if c in where]
    return (tuple(j for j, _ in mine), tuple(where[c] for _, c in mine),
            len(union), tuple(j for j, c in mine if holders[c][0] == r))


@dataclasses.dataclass(eq=False)
class FSDP:
    """A module's leaves cut over the batch axes: ``leaves`` maps a leaf's
    name to (the dim, the axes); ``gathered`` joins them before use."""
    comm: Comm
    leaves: dict


def gathered(module, children: bool = True):
    """``module`` with its FSDP leaves joined whole, and with ``children``
    those of every submodule: a shallow copy whose parameter tables hold
    the joined tensors (autograd carries their gradients back to the
    leaves), joined by one ``fsdp_gather`` per set of axes and dtype.
    ``module`` itself where nothing is cut."""
    from repro_torch.models.common import shallow_copy

    def cut(m) -> bool:
        return getattr(m, "fsdp", None) is not None

    subs = list(module.modules()) if children else [module]
    if not any(cut(m) for m in subs):
        return module
    if children:
        new = shallow_copy(module)
        mods = list(new.modules())
    else:
        new = copy.copy(module)
        new._parameters = dict(module._parameters)
        mods = [new]
    groups: dict[tuple, list] = {}
    for m in mods:
        f = getattr(m, "fsdp", None)
        if f is None:
            continue
        for leaf, (dim, axes) in f.leaves.items():
            t = m._parameters[leaf]
            groups.setdefault((id(f.comm), axes, t.dtype), []).append(
                (m, leaf, dim, f.comm))
    for (_, axes, _), entries in groups.items():
        joined = fsdp_gather([m._parameters[leaf] for m, leaf, _, _ in
                              entries], entries[0][3], axes,
                             [d for _, _, d, _ in entries])
        for (m, leaf, _, _), t in zip(entries, joined):
            m._parameters[leaf] = t
    return new


def take_cols(t: torch.Tensor, dim: int, cols: Sequence[int]) -> torch.Tensor:
    """Columns ``cols`` of ``t`` along ``dim``, in that order, as a
    contiguous copy of its own."""
    idx = torch.as_tensor(list(cols), dtype=torch.long, device=t.device)
    return t.index_select(dim, idx).contiguous()


def gather_cols(comm: Comm, x: torch.Tensor, axes, dim: int,
                per_rank: Sequence[Sequence[int]]) -> torch.Tensor:
    """The whole of a dim of which the rank of shard r over ``axes`` holds
    the columns ``per_rank[r]`` (of the whole, in its order; together they
    cover it):
    every rank's ``x`` gathered along ``dim`` in shard order, and each
    whole column taken from the first rank that holds it.  The columns are
    copied, not summed, so the whole is exact."""
    first: dict[int, int] = {}
    off = 0
    for cols in per_rank:
        for j, col in enumerate(cols):
            first.setdefault(col, off + j)
        off += len(cols)
    n = len(first)
    if sorted(first) != list(range(n)):
        raise ValueError(f"the ranks' columns {sorted(first)} do not cover "
                         f"[0, {n})")
    every = comm.all_gather(x, axes, dim)
    return take_cols(every, dim, [first[c] for c in range(n)])


class _MmF32(torch.autograd.Function):
    """cuBLAS's f32-output GEMM of 16-bit operands, differentiable (the
    op has no derivative of its own): the gradients are the 16-bit
    products one device's ``a @ w`` backward runs, of the incoming f32
    gradient rounded to the operands' dtype (it holds 16-bit values: the
    product's result is rounded to them after the sum)."""

    @staticmethod
    def forward(ctx, a2, w):
        ctx.save_for_backward(a2, w)
        return torch.mm(a2, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a2, w = ctx.saved_tensors
        g = g.to(a2.dtype)
        return (g @ w.T if ctx.needs_input_grad[0] else None,
                a2.T @ g if ctx.needs_input_grad[1] else None)


def _mm_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` (a (..., K), w (K, N)) accumulated and returned in f32.
    A 16-bit product on the card reads the operands as stored (cuBLAS's
    f32-output GEMM, through ``_MmF32`` when a gradient is asked for);
    elsewhere they are widened first."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16) \
            and w.dtype == a.dtype:
        a2 = a.reshape(-1, a.shape[-1])
        out = (_MmF32.apply(a2, w) if _grad(a) or _grad(w)
               else torch.mm(a2, w, out_dtype=torch.float32))
        return out.unflatten(0, a.shape[:-1])
    return a.float() @ w.float()


def row_parallel(module, a: torch.Tensor, w) -> torch.Tensor:
    """``a @ w`` in ``a``'s dtype: ``a`` (..., K), ``w`` a matmul weight of
    ``module`` (a tensor, or a ``quant.QTensor``) whose leading dims
    flatten to K.  Where ``shard_params`` cut K (it attaches the ``Split``
    as ``module.tp``) the rank's partial product comes out in f32, is
    summed over the mesh axes and rounded once to ``a``'s dtype, as one
    device's product accumulates in f32 and rounds once; bf16 partial sums
    would round twice.  A cut ``QTensor`` is dequantized to ``a``'s dtype
    first (its payload and row scales are the full quantized weight's
    slices, ``quant.quantize_param_axes``)."""
    K = a.shape[-1]
    tp = getattr(module, "tp", None)
    if tp is None:
        return a @ Q.cast(w, a.dtype).reshape(K, -1)
    if isinstance(w, Q.QTensor):
        # the rank's shard of the quantized weight, dequantized once
        w = Q.cast(w, a.dtype)
    return tp.reduce(_mm_f32(a, w.reshape(K, -1))).to(a.dtype)
