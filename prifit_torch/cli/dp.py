"""Data-parallel wiring shared by the CLIs: the JAX CLIs' mesh, loader
shards, sharded evaluation and rank-0 outputs, on ``torch.distributed``.

Launched under ``torchrun`` (or with ``PRIFIT_DISTRIBUTED=1`` and the
same variables set by hand) a CLI runs one process per device; each
data-parallel rank loads its round-robin shard of the example stream,
``--batch_size`` is the GLOBAL batch (each rank takes ``batch_size /
ranks`` of it, as the JAX package shards one batch over its mesh), and
rank 0 alone writes logs, metrics and checkpoints.  A single-process run
is unchanged.
"""

import torch

from prifit_torch.parallel.collectives import all_gather
from prifit_torch.parallel.mesh import Mesh, _world, batch_sharding


def is_main() -> bool:
    """Whether this process writes the run's outputs (rank 0)."""
    return _world()[1] == 0


def quiet(log):
    """``log`` on rank 0, a no-op elsewhere."""
    return log if is_main() else (lambda *a, **k: None)


def loader_shard(mesh: Mesh, batch_size: int) -> dict:
    """The ``DataLoader`` arguments of this rank's shard: the per-rank
    batch and the data axis's index and size."""
    n = mesh.shape["data"]
    return dict(batch_size=batch_size // n,
                process_index=mesh.coords.get("data") or 0,
                process_count=n)


def sharded_forward(forward, mesh: Mesh):
    """``forward(points, cls) -> logits`` run on this rank's slice of each
    (padded) global batch along the data axis, the logits all-gathered, so
    that every rank sees the whole batch's (the JAX package's
    batch-sharded eval forward)."""
    group = mesh.group("data")
    if group is None:
        return forward

    def run(points, cls):
        part = batch_sharding(mesh).slice(points.shape[0])
        with torch.no_grad():
            return all_gather(forward(points[part], cls[part]), group, 0)

    return run


def rank_generator(device, mesh: Mesh):
    """``(generator, reseed(seed), sr_key())``: the steps' generator, and
    under data parallelism the per-step ``mxsr`` key drawn from a second
    generator that every rank seeds alike.  The step generator's seed
    folds in the data coordinate, so each data shard draws its own FPS
    starts and dropout masks (the ranks of one ``points`` group, which run
    the encoder on one shard, draw alike); a single-process run draws as
    before and takes its key from the step generator (``sr_key()`` is
    then None)."""
    generator = torch.Generator(device=device)
    if mesh.shape["data"] == 1:
        return generator, generator.manual_seed, lambda: None
    keys = torch.Generator()
    data = mesh.coords.get("data") or 0

    def reseed(seed: int):
        generator.manual_seed(seed * 7919 + data)
        keys.manual_seed(seed)

    def sr_key():
        return torch.randint(0, 2 ** 32, (2,), generator=keys).tolist()

    return generator, reseed, sr_key
