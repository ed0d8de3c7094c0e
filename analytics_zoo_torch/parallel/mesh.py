"""The device mesh on ``torch.distributed`` (port of ``parallel/mesh.py``).

The reference lays its devices out as a ``jax.sharding.Mesh`` with six
named axes and lets XLA insert the collectives from sharding
annotations.  The port runs one process a device: a rank is one point of
the mesh, ``create_mesh`` builds it over
``torch.distributed.device_mesh.init_device_mesh`` with the same six dim
names, and the code that needs a collective asks the mesh for the group
of an axis (``group``), or of the data-parallel axes together
(``dp_group``: ``data`` × ``fsdp``, the axes the batch is split over).

Axis convention (outer → inner), as in the reference:

- ``data``  : data parallelism (gradient all-reduce);
- ``fsdp``  : parameter and optimizer-state sharding, ZeRO-style;
- ``model`` : tensor parallelism for wide layers (Megatron-style);
- ``seq``   : sequence parallelism (ring attention);
- ``pipe``  : pipeline parallelism (microbatches over point-to-point);
- ``expert``: expert parallelism for MoE layers (``all_to_all``).

A rank's coordinates are its index in the row-major layout of those six
sizes.  Without a process group the mesh is the one-device mesh
``{"data": 1}``, and every code path runs against it unchanged.

Sharding specs.  Where the reference attaches a ``NamedSharding`` to each
leaf, the port gives a leaf a :class:`Shard` (the axis, the tensor dim
it splits, and in how many equal blocks that dim is laid out; each
block is split the same way, so a fused QKV kernel splits by heads) or
None (replicated).  A rank holds its piece of each sharded leaf; the
helpers below cut pieces (``shard_of``) and put them back together
(``gather_leaf``, a collective).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"
EXPERT_AXIS = "expert"

ALL_AXES = (DATA_AXIS, FSDP_AXIS, MODEL_AXIS, SEQ_AXIS, PIPE_AXIS,
            EXPERT_AXIS)


@dataclasses.dataclass(frozen=True)
class Shard:
    """A leaf split over mesh axis ``axis`` along tensor dim ``dim``; the
    dim is laid out as ``blocks`` equal blocks, each split in the axis's
    size pieces, and a rank holds its piece of every block."""
    axis: str
    dim: int
    blocks: int = 1


class Mesh:
    """The six-axis mesh as seen from one rank: its sizes, this rank's
    coordinates, and the process group of each axis."""

    def __init__(self, shape: Dict[str, int], rank: int = 0,
                 world_size: int = 1, device_mesh=None,
                 ranks: Optional[Sequence[int]] = None):
        self.shape = {ax: int(shape.get(ax, 1)) for ax in ALL_AXES}
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.device_mesh = device_mesh
        # the global ranks of the mesh, in its row-major order
        self.devices = np.asarray(list(ranks) if ranks is not None
                                  else range(self.world_size))
        dims = [self.shape[ax] for ax in ALL_AXES]
        self.coords = dict(zip(ALL_AXES, np.unravel_index(
            self.rank, dims))) if self.world_size > 1 else \
            {ax: 0 for ax in ALL_AXES}
        self.coords = {ax: int(c) for ax, c in self.coords.items()}
        self._groups: Dict[str, object] = {}
        self._dp_group = None

    # ------------------------------------------------------------- geometry
    def size(self, axis: str) -> int:
        return self.shape[axis]

    def coord(self, axis: str) -> int:
        return self.coords[axis]

    @property
    def dp_size(self) -> int:
        """The data-parallel degree: the batch is split ``data`` × ``fsdp``
        ways."""
        return self.shape[DATA_AXIS] * self.shape[FSDP_AXIS]

    @property
    def dp_index(self) -> int:
        """This rank's position among the data-parallel ranks (the block
        of batch rows it holds under ``data_sharding``)."""
        return self.coords[DATA_AXIS] * self.shape[FSDP_AXIS] + \
            self.coords[FSDP_AXIS]

    def group(self, axis: str):
        """The process group of ``axis`` through this rank, or None when
        the axis has size 1 (nothing to communicate)."""
        if self.shape[axis] == 1:
            return None
        return self._groups[axis]

    def dp_group(self):
        """The group of the ranks that share every coordinate but
        ``data`` and ``fsdp``: gradients are averaged over it."""
        return None if self.dp_size == 1 else self._dp_group

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank})"


def _sizes(shape: Optional[Dict[str, int]], n: int) -> Dict[str, int]:
    if shape is None:
        shape = {DATA_AXIS: n}
    unknown = set(shape) - set(ALL_AXES)
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}; the mesh "
                         f"has {ALL_AXES}")
    sizes = {ax: int(shape.get(ax, 1)) for ax in ALL_AXES}
    wild = [ax for ax, s in sizes.items() if s == -1]
    if len(wild) > 1:
        raise ValueError("at most one mesh axis may be -1")
    fixed = math.prod(s for s in sizes.values() if s != -1)
    if wild:
        if n % fixed != 0:
            raise ValueError(
                f"cannot infer {wild[0]}: {n} devices not divisible by "
                f"{fixed}")
        sizes[wild[0]] = n // fixed
    total = math.prod(sizes.values())
    if total != n:
        raise ValueError(
            f"mesh shape {sizes} needs {total} devices, have {n}")
    return sizes


def create_mesh(shape: Optional[Dict[str, int]] = None,
                devices: Optional[Sequence[int]] = None) -> Mesh:
    """Build the mesh from an axis→size dict over the ranks of the live
    process group (one device each).

    ``shape=None`` puts every rank on ``data`` (the reference's pure
    data-parallel posture); one axis may be -1.  Without a process group
    the world is this process alone.  ``devices`` may only restate the
    world's ranks: a smaller set of ranks is a new process group
    (``resilience.recovery.reform_mesh``)."""
    import torch.distributed as dist
    live = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if live else 1
    if devices is not None and len(list(devices)) != n:
        raise ValueError(
            f"create_mesh over {len(list(devices))} devices, but the "
            f"process group holds {n} ranks; re-form the group first")
    sizes = _sizes(shape, n)
    if not live:
        return Mesh(sizes)
    from torch.distributed.device_mesh import init_device_mesh
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dims = tuple(sizes[ax] for ax in ALL_AXES)
    dm = init_device_mesh(device_type, dims, mesh_dim_names=ALL_AXES)
    mesh = Mesh(sizes, rank=dist.get_rank(), world_size=n, device_mesh=dm)
    for ax in ALL_AXES:
        if sizes[ax] > 1:
            mesh._groups[ax] = dm.get_group(ax)
    if mesh.dp_size > 1:
        mesh._dp_group = _dp_group(sizes, mesh.rank)
    return mesh


def _dp_group(sizes: Dict[str, int], rank: int):
    """Create (collectively, on every rank) one group for each point of
    the non-data axes, and return the one through ``rank``."""
    import torch.distributed as dist
    dims = [sizes[ax] for ax in ALL_AXES]
    grid = np.arange(math.prod(dims)).reshape(dims)
    # data and fsdp first, the rest flattened: column c is one group
    flat = grid.reshape(sizes[DATA_AXIS] * sizes[FSDP_AXIS], -1)
    mine = None
    for c in range(flat.shape[1]):
        ranks = [int(r) for r in flat[:, c]]
        g = dist.new_group(ranks)
        if rank in ranks:
            mine = g
    return mine


def trivial_mesh() -> Mesh:
    return Mesh({DATA_AXIS: 1})


# the mesh a trainer's step runs on, and the block of the global batch's
# rows this rank holds: layers read them (current_mesh, batch_block)
_active = threading.local()


@contextlib.contextmanager
def active(mesh: Mesh, batch_block: Optional[Tuple[int, int]] = None):
    """Run the enclosed forward on ``mesh``; ``batch_block`` is (index,
    count): this rank holds block ``index`` of ``count`` equal blocks of
    the global batch's rows (None: the whole batch)."""
    prev = getattr(_active, "state", None)
    _active.state = (mesh, batch_block)
    try:
        yield
    finally:
        _active.state = prev


def current_mesh() -> Mesh:
    """The mesh of the running step, else the zoo context's."""
    state = getattr(_active, "state", None)
    if state is not None:
        return state[0]
    from analytics_zoo_torch.common.zoo_context import get_zoo_context
    return get_zoo_context().mesh


def batch_block() -> Optional[Tuple[int, int]]:
    state = getattr(_active, "state", None)
    return None if state is None else state[1]


def rand_rows(shape, generator, device) -> torch.Tensor:
    """``torch.rand(shape)`` of this rank's rows: on a data-parallel step
    the uniforms of the GLOBAL batch's shape are drawn and this rank's
    block of rows kept, so a mask is the one a single device draws for
    the whole batch (the reference's sharding-invariant ``jax.random``)."""
    blk = batch_block()
    if blk is None or blk[1] == 1:
        return torch.rand(tuple(shape), generator=generator, device=device)
    index, count = blk
    full = (shape[0] * count,) + tuple(shape[1:])
    u = torch.rand(full, generator=generator, device=device)
    return u[index * shape[0]:(index + 1) * shape[0]]


# ------------------------------------------------------------- shardings
def data_sharding(mesh: Mesh, ndim: int = 1) -> Optional[Shard]:
    """Batches are split on dim 0 over ``data`` × ``fsdp``; a rank holds
    rows ``[dp_index * n/dp, (dp_index + 1) * n/dp)``."""
    del ndim
    return None if mesh.dp_size == 1 else Shard(DATA_AXIS, 0)


def replicated(mesh: Mesh) -> None:
    """Every rank holds the whole leaf."""
    del mesh
    return None


def batch_shardings(mesh: Mesh, batch_pytree):
    """One ``data_sharding`` per leaf of a batch tree."""
    from analytics_zoo_torch.pipeline.api.keras.topology import tree_map
    return tree_map(lambda x: data_sharding(mesh, np.ndim(x)), batch_pytree)


def fsdp_leaf(mesh: Mesh, shape, min_size: int = 2 ** 12) -> Optional[Shard]:
    """ZeRO-style spec of one leaf: at least ``min_size`` elements, split
    on the largest dim that the ``fsdp`` size divides (the reference's
    ``np.argsort(shape)[::-1]`` order); else replicated."""
    axis = mesh.shape[FSDP_AXIS]
    shape = tuple(int(s) for s in shape)
    if axis == 1 or int(np.prod(shape)) < min_size:
        return None
    for d in list(np.argsort(shape)[::-1]):
        if shape[d] % axis == 0:
            return Shard(FSDP_AXIS, int(d))
    return None


def fsdp_shardings(mesh: Mesh, params, min_size: int = 2 ** 12):
    """``fsdp_leaf`` for every leaf of a parameter tree."""
    from analytics_zoo_torch.pipeline.api.keras.topology import tree_map
    return tree_map(lambda x: fsdp_leaf(mesh, tuple(x.shape), min_size),
                    params)


def shard_of(x: torch.Tensor, spec: Optional[Shard], mesh: Mesh
             ) -> torch.Tensor:
    """This rank's piece of the whole leaf ``x`` under ``spec`` (a view;
    the caller copies)."""
    if spec is None:
        return x
    n = mesh.size(spec.axis)
    if n == 1:
        return x
    return piece(x, spec.dim, spec.blocks, n, mesh.coord(spec.axis))


def piece(x: torch.Tensor, dim: int, blocks: int, n: int, i: int
          ) -> torch.Tensor:
    """Piece ``i`` of ``n`` of every one of ``blocks`` blocks of dim
    ``dim``, concatenated."""
    size = x.shape[dim]
    if size % (blocks * n):
        raise ValueError(f"dim {dim} of size {size} does not split into "
                         f"{blocks} x {n} pieces")
    if blocks == 1:
        step = size // n
        return x.narrow(dim, i * step, step)
    shape = list(x.shape)
    view = x.reshape(shape[:dim] + [blocks, n, size // (blocks * n)] +
                     shape[dim + 1:])
    part = view.select(dim + 1, i)
    return part.reshape(shape[:dim] + [size // n] + shape[dim + 1:])


def unpiece(parts: List[torch.Tensor], dim: int, blocks: int
            ) -> torch.Tensor:
    """Inverse of ``piece`` over all ``len(parts)`` pieces."""
    if blocks == 1:
        return torch.cat(parts, dim=dim)
    n = len(parts)
    shape = list(parts[0].shape)
    size = shape[dim]
    views = [p.reshape(shape[:dim] + [blocks, 1, size // blocks] +
                       shape[dim + 1:]) for p in parts]
    whole = torch.cat(views, dim=dim + 1)
    return whole.reshape(shape[:dim] + [size * n] + shape[dim + 1:])


def gather_leaf(x: torch.Tensor, spec: Optional[Shard], mesh: Mesh
                ) -> torch.Tensor:
    """The whole leaf from every rank's piece (a collective over
    ``spec.axis``: every rank of the group calls it)."""
    if spec is None or mesh.size(spec.axis) == 1:
        return x
    from analytics_zoo_torch.parallel import comm
    parts = comm.all_gather_list(x, mesh.group(spec.axis))
    return unpiece(parts, spec.dim, spec.blocks)


# ---------------------------------------------------------- host batches
def _process_count() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if (dist.is_available() and
                                     dist.is_initialized()) else 1


def local_batch_size(mesh: Mesh, batch_size: int) -> int:
    """Rows each rank takes of a host batch of ``batch_size``.  When the
    data axes split across processes (``data_split_across_hosts``) the
    batch is the process's own and the rank takes all of it; otherwise
    every process passes the same global batch and a rank takes its
    ``1 / dp`` of the rows."""
    dp = mesh.dp_size
    nproc = _process_count()
    if nproc > 1 and dp % nproc == 0:
        dp = dp // nproc
    if batch_size % dp != 0:
        raise ValueError(
            f"batch {batch_size} not divisible by data-parallel "
            f"degree {dp}" + (" (per-host)" if nproc > 1 else ""))
    return batch_size // dp


def data_split_across_hosts(mesh: Mesh) -> bool:
    """True when each process feeds its own slice of the global batch (the
    data axes span every process); False when every process must feed the
    identical batch (a mesh with a model, seq, pipe or expert axis)."""
    dp = mesh.dp_size
    nproc = _process_count()
    return nproc > 1 and dp % nproc == 0 and dp >= nproc


def global_batch_rows(mesh: Mesh, batch_size: int) -> int:
    """Rows of the GLOBAL batch for a per-host ``batch_size``."""
    return batch_size * (_process_count()
                         if data_split_across_hosts(mesh) else 1)


def fetch_global(tree, mesh: Optional[Mesh] = None, specs=None):
    """A tree of whole leaves as host numpy arrays.  With ``specs`` (a
    tree like ``tree`` of ``Shard`` or None on ``mesh``) the pieces are
    gathered first: a collective every rank calls together."""
    from analytics_zoo_torch.pipeline.api.keras.topology import tree_map
    if specs is None:
        return tree_map(lambda x: x.detach().cpu().numpy(), tree)
    return tree_map(
        lambda x, s: gather_leaf(x, s, mesh).detach().cpu().numpy(),
        tree, specs)


__all__ = [
    "ALL_AXES", "DATA_AXIS", "EXPERT_AXIS", "FSDP_AXIS", "MODEL_AXIS",
    "PIPE_AXIS", "SEQ_AXIS", "Mesh", "Shard", "active", "batch_block",
    "batch_shardings", "current_mesh", "rand_rows",
    "create_mesh", "data_sharding", "data_split_across_hosts",
    "fetch_global", "fsdp_leaf", "fsdp_shardings", "gather_leaf",
    "global_batch_rows", "local_batch_size", "piece", "replicated",
    "shard_of", "trivial_mesh", "unpiece",
]
