"""The `jax.lax` collectives of the sharded raster, on `torch.distributed`,
with the gradients JAX gives them inside `shard_map`.

  * `all_gather(x)` (tiled, along dim 0): backward reduce-scatters the
    cotangent with a sum (JAX's psum_scatter transpose);
  * `psum(x)`: backward is psum;
  * `pmax(x)`: integer values only, no gradient;
  * `all_to_all(x)`: dim 0 split into one block per rank, block j sent to
    rank j; integer and depth values only, no gradient;
  * `ppermute(x, perm)`: (source, destination) pairs of group ranks;
    ranks that receive nothing get zeros; backward sends the cotangent
    along the inverse pairs;
  * `shard(x)`: this rank's block of rows of an array every rank holds;
    backward all-gathers the blocks' cotangents, so the gradient of a
    replicated input is replicated;
  * `replicated(x)`: the identity, whose backward divides the cotangent
    by the group size.

Why `replicated`: JAX's `shard_map(..., check_vma=False)` transpose
divides the cotangent of every replicated output (`out_specs=P()`) by the
axis size (`jax/_src/shard_map.py::_shard_map_transpose`), and only with
that do the sum-transposes above give the single-device gradient. Here
every rank runs its own backward from its own copy of a replicated value,
so the same rule is written out: mark a replicated value with
`replicated` where the JAX package's output is `P()` — the image of
`raster_shard.rasterize_sharded`, the loss of `banded.banded_l1_ssim`.
Without it the gradients come out group-size times too large.

Every collective runs on the group's backend: NCCL takes CUDA tensors,
Gloo CPU tensors, and anything else raises (no Gloo on CUDA tensors).
"""

import torch
import torch.distributed as dist


def _check(x, group, name):
    backend = dist.get_backend(group)
    want = "cuda" if backend == "nccl" else "cpu" if backend == "gloo" else None
    if want is None or x.device.type != want:
        raise ValueError(f"{name}: a {x.device.type} tensor on a {backend} group")
    return x.contiguous()


def _all_gather(x, group):
    x = _check(x, group, "all_gather")
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def _reduce_scatter(x, group):
    x = _check(x, group, "reduce_scatter")
    m = dist.get_world_size(group)
    out = x.new_empty((x.shape[0] // m,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=group)
    return out


def _all_reduce(x, group, op=dist.ReduceOp.SUM):
    x = _check(x, group, "all_reduce").clone()
    dist.all_reduce(x, op=op, group=group)
    return x


def _ppermute(x, group, perm):
    x = _check(x, group, "ppermute")
    me = dist.get_rank(group)
    out = torch.zeros_like(x)
    ops = []
    for src, dst in perm:
        if src == me:
            ops.append(dist.P2POp(dist.isend, x, dist.get_global_rank(group, dst), group))
        if dst == me:
            ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group), None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return _ppermute(x, group, perm)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(g, ctx.group, [(d, s) for s, d in ctx.perm]), None, None


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n, r = x.shape[0] // dist.get_world_size(group), dist.get_rank(group)
        return x[r * n : (r + 1) * n].clone()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group), None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.m = dist.get_world_size(group)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.m, None


def all_gather(x, group):
    """Concatenation along dim 0 of every rank's x (`lax.all_gather(...,
    tiled=True)`)."""
    return _AllGather.apply(x, group)


def psum(x, group):
    return _Psum.apply(x, group)


def pmax(x, group):
    if x.is_floating_point() or x.requires_grad:
        raise TypeError("pmax: integer values only")
    return _all_reduce(x, group, dist.ReduceOp.MAX)


def all_to_all(x, group):
    """x [m * b, ...]: block j of dim 0 goes to rank j; returns the blocks
    received, block i from rank i (`lax.all_to_all(x, axis, 0, 0)` on
    x.reshape(m, b, ...)). No gradient."""
    if x.requires_grad:
        raise TypeError("all_to_all: integer and depth values only, no gradient")
    x = _check(x, group, "all_to_all")
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def ppermute(x, group, perm):
    """`lax.ppermute`: x from rank s lands on rank d for each (s, d) in
    perm; ranks that receive nothing get zeros."""
    return _Ppermute.apply(x, group, [tuple(p) for p in perm])


def shard(x, group):
    """Rows [r * n/m, (r + 1) * n/m) of x, for rank r of m (n divisible by
    m); the cotangents of all ranks' blocks come back concatenated."""
    if x.shape[0] % dist.get_world_size(group):
        raise ValueError(f"shard: {x.shape[0]} rows over {dist.get_world_size(group)} ranks")
    return _Shard.apply(x, group)


def replicated(x, group):
    """Mark x as replicated over the group (see the module docstring)."""
    return _Replicated.apply(x, group)
