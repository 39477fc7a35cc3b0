"""The device mesh of a job's processes, and its logical sharding rules.

The port of tf_operator_tpu/parallel/mesh.py.  Where the JAX package
builds a `jax.sharding.Mesh` over devices, the port lays the job's ranks
out on the same grid: rank r sits at the coordinates of device r in
JAX's `np.asarray(devices).reshape(shape)` over AXIS_ORDER, so dcn is
outermost and tp innermost (a tp group is consecutive ranks).  The grid
(`rank_grid`, `mesh_shape`) is a pure function of the axis sizes; a
`Mesh` made inside a job of several processes also holds one process
group per set of axes (`Mesh.group`): the ranks that differ only along
those axes, which is what a collective over them spans.

Shardings are specs, JAX's PartitionSpec as a tuple with one entry per
dim: a mesh axis name, a tuple of names (the dim split over their
product, the first name major), or None.  `shard_slices` gives the
block a rank holds, the block jax.device_put puts on its device.

Axes (any may be size 1 and is then effectively disabled): dcn
(cross-slice data parallel), pp, dp (data parallel), fsdp (batch split
and parameter shards), ep (experts), tp (tensor parallel).
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

AXIS_ORDER = ("dcn", "pp", "dp", "fsdp", "ep", "tp")

Axes = Union[str, Tuple[str, ...], None]
Spec = Tuple[Axes, ...]


def mesh_shape(axes: Optional[Dict[str, int]], n: int) -> Dict[str, int]:
    """Every axis's size over `n` devices (ranks), in AXIS_ORDER: missing
    axes get size 1 and at most one may be -1 (inferred), with
    make_mesh's errors."""
    axes = dict(axes or {})
    sizes = {name: axes.get(name, 1) for name in AXIS_ORDER}
    infer = [k for k, v in sizes.items() if v == -1]
    if len(infer) > 1:
        raise ValueError("at most one mesh axis may be -1")
    if infer:
        known = math.prod(v for v in sizes.values() if v != -1)
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[infer[0]] = n // known
    total = math.prod(sizes.values())
    if total != n:
        raise ValueError(
            f"mesh axes {sizes} require {total} devices, have {n}"
        )
    return sizes


def rank_grid(axes: Optional[Dict[str, int]], n: int) -> np.ndarray:
    """The ranks 0..n-1 laid out as make_mesh lays devices 0..n-1 out:
    shape (sizes in AXIS_ORDER), rank r at device r's coordinates."""
    sizes = mesh_shape(axes, n)
    return np.arange(n).reshape(tuple(sizes[a] for a in AXIS_ORDER))


def spec_axes(entry: Axes) -> Tuple[str, ...]:
    """One spec entry's mesh axes as a tuple (None -> ())."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class Mesh:
    """A job's ranks on the JAX mesh grid.

    `shape` is {axis: size} in AXIS_ORDER (what JAX's `dict(mesh.shape)`
    prints); `grid` the rank grid; `rank` this process's rank (None for
    a pure layout, which has no process groups).  In a job of several
    processes every rank builds the same Mesh, and the constructor makes
    the groups of every set of the mesh's axes of size > 1 in one order
    on every rank, as torch.distributed requires."""

    def __init__(self, shape: Dict[str, int], rank: Optional[int] = None,
                 groups: bool = False) -> None:
        self.shape = {a: int(shape.get(a, 1)) for a in AXIS_ORDER}
        self.size = math.prod(self.shape.values())
        self.grid = np.arange(self.size).reshape(
            tuple(self.shape[a] for a in AXIS_ORDER))
        self.rank = rank
        self._groups: Dict[Tuple[str, ...], object] = {}
        # the mesh of a job of processes (collectives over its groups),
        # or a pure layout of one process
        self.in_job = groups
        if groups:
            self._make_groups()

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"

    def _make_groups(self) -> None:
        import torch.distributed as dist

        live = [a for a in AXIS_ORDER if self.shape[a] > 1]
        for k in range(1, len(live) + 1):
            for sub in itertools.combinations(live, k):
                for members in self.members(sub):
                    g = dist.new_group(members)
                    if self.rank in members:
                        self._groups[sub] = g

    def members(self, axes: Sequence[str]):
        """Every group of ranks that differ only along `axes`, each in
        rank order (the chunk order along those axes)."""
        axes = [a for a in AXIS_ORDER if a in axes]
        dims = [AXIS_ORDER.index(a) for a in axes]
        moved = np.moveaxis(self.grid, dims, list(range(-len(dims), 0)))
        flat = moved.reshape(-1, math.prod(self.shape[a] for a in axes))
        return [sorted(int(r) for r in row) for row in flat]

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        r = self.rank if rank is None else rank
        idx = np.unravel_index(r, self.grid.shape)
        return {a: int(i) for a, i in zip(AXIS_ORDER, idx)}

    def axis_size(self, axes: Axes) -> int:
        return math.prod(self.shape[a] for a in spec_axes(axes))

    def axis_index(self, axes: Axes, rank: Optional[int] = None) -> int:
        """This rank's chunk index along `axes` (a name or a tuple, the
        first name major), as a sharded dim is split over them."""
        names = spec_axes(axes)
        c = self.coords(rank)
        idx = 0
        for a in names:
            idx = idx * self.shape[a] + c[a]
        return idx

    def group(self, axes: Axes):
        """The process group of this rank and the ranks that differ from
        it only along `axes`; None when that is this rank alone (or the
        mesh has no groups).  Tuples must name axes in AXIS_ORDER's
        order, the order of their chunks."""
        names = spec_axes(axes)
        if list(names) != [a for a in AXIS_ORDER if a in names]:
            raise NotImplementedError(
                f"axes {names} out of AXIS_ORDER {AXIS_ORDER}")
        live = tuple(a for a in names if self.shape[a] > 1)
        if not live:
            return None
        return self._groups.get(live)


def make_mesh(axes: Optional[Dict[str, int]] = None,
              world: Optional[int] = None,
              rank: Optional[int] = None) -> Mesh:
    """The mesh of `axes` over the job's processes (default: every rank
    of the initialized job, else one process).  Missing axes get size 1;
    at most one axis may be -1 (inferred).  Inside an initialized job
    the mesh holds its process groups; `world` alone (no job) gives a
    pure layout."""
    import torch.distributed as dist

    live = dist.is_available() and dist.is_initialized()
    if world is None:
        world = dist.get_world_size() if live else 1
    if rank is None and live:
        rank = dist.get_rank()
    sizes = mesh_shape(axes, world)
    groups = live and world > 1 and world == dist.get_world_size()
    return Mesh(sizes, rank=0 if rank is None else rank, groups=groups)


@dataclass(frozen=True)
class MeshRules:
    """Logical-axis -> mesh-axis mapping (flax 'logical axis rules' idea,
    kept framework-free)."""

    rules: Tuple[Tuple[str, Axes], ...] = ()

    def mesh_axes(self, logical: Optional[str]):
        if logical is None:
            return None
        for name, target in self.rules:
            if name == logical:
                return target
        return None

    def spec(self, logical_axes: Sequence[Optional[str]]) -> Spec:
        return tuple(self.mesh_axes(a) for a in logical_axes)

    def with_rule(self, name: str, target) -> "MeshRules":
        kept = tuple((n, t) for n, t in self.rules if n != name)
        return MeshRules(rules=kept + ((name, target),))


DEFAULT_RULES = MeshRules(
    rules=(
        ("batch", ("dcn", "dp", "fsdp")),  # batch split over all data axes
        ("embed", "tp"),
        ("heads", "tp"),
        ("kv", None),
        ("mlp", "tp"),
        ("vocab", "tp"),
        ("seq", None),         # activations: sequence unsharded by default
        ("seq_sp", "tp"),      # ring-attention sequence sharding rides tp
        ("expert", "ep"),
        ("stage", "pp"),
        ("params_fsdp", "fsdp"),
    )
)

BATCH_AXES = DEFAULT_RULES.mesh_axes("batch")


def named_sharding(mesh: Mesh, logical_axes: Sequence[Optional[str]],
                   rules: MeshRules = DEFAULT_RULES) -> Spec:
    return rules.spec(logical_axes)


def batch_sharding(mesh: Mesh, rules: MeshRules = DEFAULT_RULES) -> Spec:
    """Inputs: batch dim split over (dcn, dp, fsdp), rest replicated."""
    return (rules.mesh_axes("batch"),)


def replicated(mesh: Mesh) -> Spec:
    return ()


def pick_fsdp_dim(
    shape: Sequence[int],
    fsdp: int,
    min_size: int = 2**14,
    taken: Sequence[int] = (),
) -> Optional[int]:
    """The single fsdp placement rule: for a param of `shape`, return the
    largest fsdp-divisible dim not already sharded (`taken`), or None for
    params below `min_size` (those replicate)."""
    if fsdp <= 1 or not shape or math.prod(shape) < min_size:
        return None
    for d in sorted(range(len(shape)), key=lambda d: shape[d], reverse=True):
        if d not in taken and shape[d] % fsdp == 0:
            return d
    return None


def local_mesh_axes(n_devices: int, prefer_tp: int = 1) -> Dict[str, int]:
    """A reasonable default mesh for n devices: tp as requested (clamped to
    a divisor), rest data parallel."""
    tp = math.gcd(prefer_tp, n_devices) if prefer_tp > 1 else 1
    return {"tp": tp, "dp": n_devices // tp}


# ------------------------------------------------------------- shards
def _full(spec: Spec, ndim: int) -> Spec:
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    return tuple(spec) + (None,) * (ndim - len(spec))


def shard_slices(shape: Sequence[int], spec: Spec, mesh: Mesh,
                 rank: Optional[int] = None) -> Tuple[slice, ...]:
    """The block of a [shape] array that `rank` (default this one) holds
    under `spec`: each sharded dim split evenly over its axes' product,
    the chunk at the rank's index along them."""
    out = []
    for n, entry in zip(shape, _full(spec, len(shape))):
        k = mesh.axis_size(entry)
        if n % k:
            raise ValueError(f"dim {n} not divisible by {entry} ({k})")
        i = mesh.axis_index(entry, rank)
        out.append(slice(i * (n // k), (i + 1) * (n // k)))
    return tuple(out)


def local_shape(shape: Sequence[int], spec: Spec, mesh: Mesh
                ) -> Tuple[int, ...]:
    return tuple(n // mesh.axis_size(e)
                 for n, e in zip(shape, _full(spec, len(shape))))


def shard_of(x, spec: Spec, mesh: Mesh, rank: Optional[int] = None):
    """`rank`'s block of the whole array `x` (a view)."""
    return x[shard_slices(x.shape, spec, mesh, rank)]


def spec_mesh_axes(spec: Spec) -> Tuple[str, ...]:
    """Every mesh axis a spec shards over, in AXIS_ORDER."""
    named = {a for e in spec for a in spec_axes(e)}
    return tuple(a for a in AXIS_ORDER if a in named)
