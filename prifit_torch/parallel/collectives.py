"""Collectives over ``torch.distributed`` process groups, with the
transposes that the JAX package's ``lax`` collectives have.

A step that spans processes keeps one convention, that of a JAX program
under ``shard_map``: the loss is REPLICATED (every rank computes the same
scalar from psum'd or all-gathered values); every collective's backward
sums the cotangents of all ranks (``psum``'s transpose is ``psum``,
``all_gather``'s is a reduce-scatter, ``ppermute``'s is the reverse
``ppermute``); so each rank's parameter gradient is the world size times
its share of the global gradient, and :func:`average_gradients` (a mean
over every rank, as DDP takes it) gives the global gradient on all of
them.  ``torch.distributed.nn.functional`` is not used: its
``all_gather`` sums the cotangent the same way, but the module is
deprecated, and these functions state their transposes.

``group=None`` here means "no group": every function is then the
identity (a single-process run), never the default world group.
"""

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def through_host(t: torch.Tensor, group) -> bool:
    """Whether a CUDA tensor must pass through host memory: under the
    ``gloo`` backend (two ranks that share one card, where NCCL refuses
    a device that two ranks hold), whose point-to-point calls take CPU
    tensors only."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (no gradient); returns ``t``."""
    if group is not None and group_size(group) > 1:
        if through_host(t, group):
            h = t.cpu()
            dist.all_reduce(h, group=group)
            t.copy_(h)
        else:
            dist.all_reduce(t, group=group)
    return t


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """``lax.psum``: the sum of ``x`` over ``group``; its backward sums
    the cotangents over ``group`` too."""
    if group is None or group_size(group) == 1:
        return x
    return _Psum.apply(x, group)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        src = x.cpu() if through_host(x, group) else x.contiguous()
        parts = [torch.empty_like(src) for _ in range(group_size(group))]
        dist.all_gather(parts, src, group=group)
        return torch.cat(parts, dim=dim).to(x.device)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(g.contiguous().clone(), ctx.group)
        return g.chunk(group_size(ctx.group), dim=ctx.dim)[
            group_rank(ctx.group)].contiguous(), None, None


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """``lax.all_gather(..., tiled=True)``: every rank's ``x`` concatenated
    along ``dim`` in rank order; the backward sums the cotangents over
    ``group`` and hands each rank its own slice (a reduce-scatter)."""
    if group is None or group_size(group) == 1:
        return x
    return _AllGather.apply(x, group, dim)


def all_gather_stack(x: torch.Tensor, group) -> torch.Tensor:
    """``lax.all_gather`` (not tiled): ``[P, *x.shape]``."""
    return all_gather(x[None], group, 0)


def _shift(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """Send ``x`` to the rank ``shift`` places on in ``group`` and return
    what the rank ``shift`` places back sent (``batch_isend_irecv``)."""
    size, rank = group_size(group), group_rank(group)
    ranks = dist.get_process_group_ranks(group)
    src = x.cpu() if through_host(x, group) else x.contiguous()
    out = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, ranks[(rank + shift) % size], group),
           dist.P2POp(dist.irecv, out, ranks[(rank - shift) % size], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.to(x.device)


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _shift(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -ctx.shift), None, None


def ppermute(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """``lax.ppermute`` with the ring permutation ``j -> j + shift``; its
    backward runs the ring the other way."""
    if group is None or group_size(group) == 1:
        return x
    return _Ppermute.apply(x, group, shift)


def average_gradients(params, group) -> None:
    """Replace every ``.grad`` of ``params`` by its mean over ``group``
    (one flat all-reduce): with a replicated loss that is the global
    gradient (module docstring)."""
    size = group_size(group)
    if size == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce_(flat, group).div_(size)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))
