"""Sequence parallelism: the pair grid's rows split over the mesh's `model`
ranks (counterpart of text2protein_tpu/parallel/mesh.py `grid_sharding`
and of the collectives XLA SPMD inserts for it).

A rank of a row group of `size` ranks holds row block `index` of the
(N, N) grid at every level of the UNet: N / 2^l / size rows at level l, so
N / 2^(levels - 1) must be a multiple of `size` (`check_grid`). The
attention tokens are row-major, so a rank's tokens are one contiguous
block as well. The layers cross ranks in three ways, each a differentiable
operation of the group (a `torch.autograd.Function` with its own
backward):

- `halo(x, dim)`: x with one row of each neighbour on either side along
  `dim`, zeros at the grid's top and bottom edges (a 3x3 convolution then
  runs with no row padding). Backward: each halo row's gradient goes back
  to the rank that owns the row and is added there.
- `gather(x, dim)`: every rank's block along `dim`, in rank order (the
  keys and values of self-attention). Backward: the gradient's blocks are
  summed over the ranks, each to its owner (a reduce-scatter).
- `sum(x)`: x summed over the ranks (GroupNorm's statistics, the loss's
  per-sample sums). Backward: the gradient summed over the ranks.

These are the adjoints of the distributed function, so a rank's backward
gives its share of the gradient of the sum of every rank's loss. Each
rank's loss is the whole loss (its per-sample sums run over the group), so
a parameter's gradient on a rank is `size` times the rank's share of the
loss's gradient, and the mean over the `model` ranks that FSDP2 takes
(`parallel.mesh.shard_params`) is the sum of the shares: the gradient of
the loss, as without a row group.

Two groups implement the operations. `DistRowGroup` talks over
torch.distributed on the mesh's `model` process group (gloo on the CPU,
NCCL on CUDA). `StackedRowGroup` runs the `size` ranks in one process,
stacked on the batch axis rank-major (entry r * B + i is sample i on rank
r): its operations are slicing and reshaping of one tensor, so it runs the
sharded path on one device, and it is the CPU oracle of the first. In
either layout a tensor that is not of the grid (the time, the caption) is
the same on every rank: `tile` gives it the group's layout, and
`local_rows` takes each rank's rows of a whole grid so held.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

GRID_KEYS = ("coords_6d", "mask_pair", "mask_inpaint")  # JAX batch_shardings


def check_grid(n: int, levels: int, size: int) -> None:
    """Raise ValueError unless `size` ranks split the rows of an (n, n)
    grid into equal blocks at each of the UNet's `levels` resolutions
    (n / 2^l rows at level l), each of an even number of rows where the
    level is pooled. XLA would pad uneven shards instead."""
    coarsest = n >> (levels - 1)
    if coarsest << (levels - 1) != n or coarsest % size:
        raise ValueError(
            f"a pair grid of {n} rows over {levels} levels has {n} / "
            f"2^{levels - 1} = {n / 2 ** (levels - 1):g} rows at the "
            f"coarsest level, not a multiple of model={size}: the rows "
            f"do not split evenly over the row group")


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n = x.shape[dim]
        top, bottom = group.neighbours(x.narrow(dim, 0, 1),
                                       x.narrow(dim, n - 1, 1))
        return torch.cat([top, x, bottom], dim)

    @staticmethod
    def backward(ctx, g):
        dim = ctx.dim
        n = g.shape[dim] - 2
        # this rank's top halo row is the previous rank's last row, its
        # bottom halo row the next rank's first row
        from_prev, from_next = ctx.group.neighbours(
            g.narrow(dim, 0, 1), g.narrow(dim, n + 1, 1))
        dx = g.narrow(dim, 1, n).clone()
        dx.narrow(dim, 0, 1).add_(from_prev)
        dx.narrow(dim, n - 1, 1).add_(from_next)
        return dx, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.reduce_scatter(g, ctx.dim), None, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g), None


class RowGroup:
    """The `model` ranks that split the grid's rows. `size` ranks; this
    rank's `index` (None where every rank is held stacked); `copies`, the
    ranks this process holds on its batch axis. The subclasses give the
    communication: `neighbours`, `all_gather`, `reduce_scatter`,
    `all_reduce`, and the layout: `tile`, `local_rows`."""

    size: int
    index: int | None
    copies: int

    def halo(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return _Halo.apply(x, self, dim)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return _Gather.apply(x, self, dim)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return _Sum.apply(x, self)


class DistRowGroup(RowGroup):
    """The row group of a rank of a `parallel.mesh.Mesh`: its line along
    `model`, over torch.distributed."""

    copies = 1

    def __init__(self, mesh):
        self.size, self.index = mesh.model, mesh.model_index
        self.group = mesh.group("model")
        ranks = dist.get_process_group_ranks(self.group)
        self._prev = ranks[self.index - 1] if self.index > 0 else None
        self._next = (ranks[self.index + 1] if self.index < self.size - 1
                      else None)

    def neighbours(self, first, last):
        """(the previous rank's `last`, the next rank's `first`): zeros
        where there is no such rank."""
        prev_last = torch.zeros(last.shape, dtype=last.dtype,
                                device=last.device)
        next_first = torch.zeros(first.shape, dtype=first.dtype,
                                 device=first.device)
        ops = []
        if self._prev is not None:
            ops += [dist.P2POp(dist.isend, first.contiguous(), self._prev,
                               self.group),
                    dist.P2POp(dist.irecv, prev_last, self._prev,
                               self.group)]
        if self._next is not None:
            ops += [dist.P2POp(dist.isend, last.contiguous(), self._next,
                               self.group),
                    dist.P2POp(dist.irecv, next_first, self._next,
                               self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return prev_last, next_first

    def all_gather(self, x, dim):
        x = x.contiguous()
        out = x.new_empty((self.size * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=self.group)
        return torch.cat(out.chunk(self.size), dim)

    def reduce_scatter(self, x, dim):
        parts = torch.cat(x.chunk(self.size, dim)).contiguous()
        out = parts.new_empty((parts.shape[0] // self.size,
                               *parts.shape[1:]))
        dist.reduce_scatter_tensor(out, parts, group=self.group)
        return out

    def all_reduce(self, x):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=self.group)
        return out

    def tile(self, x):
        return x

    def local_rows(self, x, dim):
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.index * n, n)


class StackedRowGroup(RowGroup):
    """`size` ranks in one process, stacked on the batch axis rank-major."""

    index = None

    def __init__(self, size: int):
        self.size = self.copies = int(size)

    def _ranks(self, x):
        return x.reshape(self.size, x.shape[0] // self.size, *x.shape[1:])

    def neighbours(self, first, last):
        f, la = self._ranks(first), self._ranks(last)
        zero = torch.zeros_like(la[:1])
        return (torch.cat([zero, la[:-1]]).reshape(last.shape),
                torch.cat([f[1:], zero]).reshape(first.shape))

    def all_gather(self, x, dim):
        return self.tile(torch.cat(x.chunk(self.size), dim))

    def reduce_scatter(self, x, dim):
        return torch.cat(self._ranks(x).sum(0).chunk(self.size, dim))

    def all_reduce(self, x):
        return self.tile(self._ranks(x).sum(0))

    def tile(self, x):
        return x.repeat(self.size, *([1] * (x.ndim - 1)))

    def local_rows(self, x, dim):
        n = x.shape[dim] // self.size
        return torch.cat([c.narrow(dim, r * n, n)
                          for r, c in enumerate(x.chunk(self.size))])

    def shard_batch(self, batch: dict) -> dict:
        """A batch of whole grids (tensors) in the group's layout: each
        rank's rows of the grid keys, the other keys tiled."""
        return {k: (self.local_rows(self.tile(v), 1) if k in GRID_KEYS
                    else self.tile(v)) if torch.is_tensor(v) else v
                for k, v in batch.items()}


def row_group(mesh) -> DistRowGroup | None:
    """The row group of this rank's mesh, None with one `model` rank."""
    return DistRowGroup(mesh) if mesh is not None and mesh.model > 1 else None


@contextlib.contextmanager
def rows_split(model, group):
    """The model's grid rows split over `group` inside the block (its
    forward and backward: the backward recomputes rematerialized blocks),
    whole again after it; nothing changes with `group` None."""
    if group is None:
        yield
        return
    model.set_row_group(group)
    try:
        yield
    finally:
        model.set_row_group(None)
