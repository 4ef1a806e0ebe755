"""The collectives of the sharded forward, with their autograd rules.

``shard_map`` gives the JAX package each collective's transpose for free;
here every rule is written out. The loops compute one loss, replicated on
every rank, so a collective whose result every rank of the group then
uses the same way passes the full upstream gradient on unchanged:

  * ``reduce_from(x, group)``: forward a sum over the group (the readout's
    ``psum`` over ``graph``, the loss's over ``time``); backward the
    identity — every rank already holds the full gradient of the sum.
  * ``gather_from(x, group)``: forward the group's tensors stacked on a new
    leading axis (the all-gather along ``time`` that the adapter's
    ``flat[pos]`` implies); backward this rank's own slice, no sum.
  * ``copy_params(params, group)``: forward the identity; backward a sum of
    the parameter gradients over the group, coalesced into one flat
    buffer. Each rank's gradient covers its own shard's part of the loss,
    so the sum is the whole gradient, the same on every rank, and
    replicated parameters stay bitwise equal.

Where the consumer differs from rank to rank (layer 2 of the 2-layer
forward reads the graph-gathered rows for its own row block; the halo
exchange feeds each time shard its predecessors' tails), ``all_gather``
keeps the standard rule: forward the gather, backward the sum of every
rank's gradient and this rank's slice of it (an all-reduce and a slice:
the one rule that gloo and NCCL both run in every PyTorch 2 release).

``torch.distributed.nn.functional``'s ``all_reduce``/``all_gather`` are not
the first two rules: they sum G (or T) identical gradients.

``CALLS`` counts the collectives issued from Python, by kind, and
``ISSUED`` by (kind, group size, buffer bytes): an all-reduce's buffer, an
all-gather's gathered result (a captured step issues its collectives once,
at capture: count an eager step). ``utils/comm_model`` reckons ``ISSUED``
from a workload's shape.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

CALLS: collections.Counter = collections.Counter()
ISSUED: collections.Counter = collections.Counter()


def _count(kind: str, n: int, nbytes: int) -> None:
    CALLS[kind] += 1
    ISSUED[(kind, n, nbytes)] += 1


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over ``group``, outside autograd."""
    _count("all_reduce", dist.get_world_size(group), x.numel() * x.element_size())
    dist.all_reduce(x, group=group)
    return x


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    _count("all_gather", n, n * x.numel() * x.element_size())
    # Concatenated along the leading axis (the layout gloo and NCCL both take).
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out.view((n,) + tuple(x.shape))


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.rank = dist.get_rank(group)
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank], None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.rank, ctx.group = dist.get_rank(group), group
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group)[ctx.rank], None


class _CopyParams(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *params):
        ctx.group = group
        ctx.meta = [(p.shape, p.dtype, p.device) for p in params]
        return tuple(p.view_as(p) for p in params)

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros(s, dtype=d, device=dev) if g is None else g
                 for g, (s, d, dev) in zip(grads, ctx.meta)]
        flat = all_reduce_(torch.cat([g.reshape(-1) for g in grads]), ctx.group)
        out, at = [], 0
        for g in grads:
            out.append(flat[at: at + g.numel()].view_as(g))
            at += g.numel()
        return (None, *out)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group``; the gradient passes unchanged (replicated use)."""
    return _ReduceFrom.apply(x, group)


def gather_from(x: torch.Tensor, group) -> torch.Tensor:
    """(group size, *x.shape), rank order; the gradient is this rank's
    slice of the full one (replicated use)."""
    return _GatherFrom.apply(x, group)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(group size, *x.shape), rank order; the gradient sums every rank's
    (per-rank use)."""
    return _AllGather.apply(x, group)


def _leaf_paths(tree: dict, prefix: tuple = ()):
    """(key path, tensor) of every leaf of a nested dict, keys sorted."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def copy_params(params: dict, group) -> dict:
    """The same parameters (a dict, nested as WD-GCN's ``lstm`` and
    EvolveGCN's GRU cells nest), whose gradients are summed over ``group``
    in the backward (one flat all-reduce for all of them)."""
    paths, leaves = zip(*_leaf_paths(params))
    out: dict = {}
    for path, leaf in zip(paths, _CopyParams.apply(group, *leaves)):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out
