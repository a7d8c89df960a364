"""Process meshes and batch sharding on ``torch.distributed``: the
port's data parallelism.

Port of ``prifit_tpu/parallel/mesh.py``.  In the JAX package a mesh is a
grid of devices and ``jit``'s partitioner runs one program over it,
turning every batch-axis mean (batch-norm statistics, loss means) into a
cross-device collective.  Here one process (rank) drives one device, and
a :class:`Mesh` is a small record of the process groups along each axis
and this rank's place on them; there is no device list.  The global
reductions the partitioner inserts are explicit: batch norms and the
mixed-precision regions sum their moments over the mesh's ``data`` group
(``process_group`` of :class:`prifit_torch.nn.norm.BatchNorm`), the
losses reduce over it, and :func:`~prifit_torch.parallel.collectives.
average_gradients` averages the replicated loss's gradients (see
:mod:`prifit_torch.parallel.collectives` for the convention).
"""

import os
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

_ON = ("1", "true", "yes", "on")


@dataclass
class Mesh:
    """A grid of ranks: ``axis_names`` and ``shape`` (name -> size) as in
    ``jax.sharding.Mesh``; ``groups`` (name -> the process group of the
    ranks that differ from this one along that axis only, None when the
    axis has size 1 or this rank is not in the mesh); ``coords`` (name ->
    this rank's index along the axis); ``member``: whether this rank is
    in the mesh at all (:func:`make_data_mesh` may leave ranks out);
    ``devices``: the mesh's global ranks in row-major order;
    ``group_all``: the group of all of them (None for one rank)."""
    axis_names: tuple
    shape: dict
    groups: dict = field(default_factory=dict)
    coords: dict = field(default_factory=dict)
    member: bool = True
    devices: list = field(default_factory=lambda: [0])
    group_all: object = None

    @property
    def size(self) -> int:
        n = 1
        for a in self.axis_names:
            n *= self.shape[a]
        return n

    def group(self, axis: str = "data"):
        return self.groups.get(axis)


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _new_group(ranks: list, world: int):
    """The process group of ``ranks`` (every rank of the world calls
    this, members or not, in the same order); None for one rank."""
    if len(ranks) <= 1:
        return None
    if len(ranks) == world:
        return dist.group.WORLD
    return dist.new_group(ranks)


def grid_mesh(axis_names: tuple, sizes: tuple, ranks=None) -> Mesh:
    """A mesh of ``sizes`` over ``ranks`` (default: every rank) laid out
    row-major, as ``np.asarray(devices).reshape(sizes)`` is; the group of
    each axis is created for every line of the grid, on every rank."""
    world, me = _world()
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    total = 1
    for s in sizes:
        total *= s
    if total > len(ranks):
        raise ValueError(f"mesh {dict(zip(axis_names, sizes))} needs "
                         f"{total} ranks, {len(ranks)} given")
    ranks = ranks[:total]
    strides = [1] * len(sizes)
    for i in range(len(sizes) - 2, -1, -1):
        strides[i] = strides[i + 1] * sizes[i + 1]
    member = me in ranks
    pos = ranks.index(me) if member else None
    coords, groups = {}, {}
    for a, (name, size) in enumerate(zip(axis_names, sizes)):
        coords[name] = (pos // strides[a]) % size if member else None
        # one group per line of the grid along axis a
        for flat in range(total):
            if (flat // strides[a]) % size:
                continue
            line = [ranks[flat + j * strides[a]] for j in range(size)]
            g = _new_group(line, world)
            if member and me in line:
                groups[name] = g
        groups.setdefault(name, None)
    return Mesh(tuple(axis_names), dict(zip(axis_names, sizes)), groups,
                coords, member, ranks, _new_group(ranks, world))


def make_mesh(devices=None, axis_name: str = "data") -> Mesh:
    """1-D data-parallel mesh over all (or the given) ranks."""
    world, _ = _world()
    ranks = list(range(world)) if devices is None else list(devices)
    return grid_mesh((axis_name,), (len(ranks),), ranks)


def make_data_mesh(batch_size: int, devices=None,
                   axis_name: str = "data") -> Mesh:
    """1-D mesh using the most ranks that evenly divide the batch (the
    rest are not members: they idle through the steps).

    Keeps tiny debug batches runnable on large worlds (each rank takes an
    equal share of the batch)."""
    world, _ = _world()
    ranks = list(range(world)) if devices is None else list(devices)
    n = len(ranks)
    while n > 1 and batch_size % n != 0:
        n -= 1
    return grid_mesh((axis_name,), (n,), ranks[:n])


@dataclass(frozen=True)
class BatchSharding:
    """Which part of a batch this rank holds: the ``index``-th of
    ``count`` equal contiguous slices of the leading axis (the JAX
    package's ``NamedSharding(mesh, P("data"))``, seen from one
    rank)."""
    index: int
    count: int

    def slice(self, n: int) -> slice:
        if n % self.count:
            raise ValueError(f"batch of {n} does not split into "
                             f"{self.count} equal shards")
        b = n // self.count
        return slice(self.index * b, (self.index + 1) * b)


def batch_sharding(mesh: Mesh, axis_name: str = "data") -> BatchSharding:
    """Sharding that splits the leading (batch) axis across the mesh's
    ``axis_name`` axis: this rank's shard index and the shard count
    (replicated along the other axes)."""
    return BatchSharding(mesh.coords.get(axis_name) or 0,
                         mesh.shape[axis_name])


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    return fn(tree)


def shard_batch(mesh: Mesh, batch, axis_name: str = "data"):
    """This rank's contiguous slice of a global batch (a pytree of
    tensors or numpy arrays; None leaves pass).  The leading axis of every
    leaf must be divisible by the mesh size along ``axis_name``."""
    sh = batch_sharding(mesh, axis_name)
    return _tree_map(lambda x: x if x is None else x[sh.slice(x.shape[0])],
                     batch)


def replicate(mesh: Mesh, tree):
    """Make a module's parameters and buffers (or a pytree of tensors)
    equal on every rank of the mesh: broadcast in place from the mesh's
    first rank.  Returns ``tree``."""
    group = mesh.group_all
    if group is None or not mesh.member:
        return tree
    tensors = (list(tree.parameters()) + list(tree.buffers())
               if isinstance(tree, torch.nn.Module) else [])
    if not tensors:
        _tree_map(lambda t: tensors.append(t)
                  if isinstance(t, torch.Tensor) else None, tree)
    from prifit_torch.parallel.collectives import through_host

    with torch.no_grad():
        for t in tensors:
            if through_host(t, group):
                h = t.detach().cpu()
                dist.broadcast(h, mesh.devices[0], group=group)
                t.copy_(h)
            else:
                dist.broadcast(t.data, mesh.devices[0], group=group)
    return tree


def maybe_initialize_distributed(backend: str | None = None) -> bool:
    """Initialize ``torch.distributed`` when launched by ``torchrun`` (its
    ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) or under
    ``PRIFIT_DISTRIBUTED=1`` (the same variables, set by hand); returns
    False on a single-process run and True once a group is up.

    The backend is ``nccl`` when CUDA is available and ``gloo`` otherwise,
    unless ``backend`` names one; under ``nccl`` each rank takes the
    device ``LOCAL_RANK`` (mod the device count)."""
    if dist.is_available() and dist.is_initialized():
        return True
    flag = os.environ.get("PRIFIT_DISTRIBUTED", "").strip().lower()
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if flag not in _ON and (world <= 1 or "RANK" not in os.environ):
        return False
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK",
                                                                "0")))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method="env://",
                            world_size=world,
                            rank=int(os.environ.get("RANK", "0")))
    return True
