"""The ('data', 'model') mesh of ranks (counterpart of
text2protein_tpu/parallel/mesh.py).

A rank is one process on one device (`cuda:LOCAL_RANK`, or the CPU when the
caller asks for it); a node plays the part of a JAX host:
`host_id = RANK // LOCAL_WORLD_SIZE`, `host_count = WORLD_SIZE //
LOCAL_WORLD_SIZE`. Ranks lie on the mesh row-major, rank r at data index
r // model and model index r % model, as `make_mesh` of the JAX package lays
its devices out.

The batch: each node loads `training.batch_size` rows a step from its shard
of the index space, so the global batch is batch_size x host_count, split
into equal row blocks over the `data` axis; ranks that differ only in their
`model` index take the same rows (the JAX package's `P("data")`).

Parameters, Adam moments and the EMA: sharded over `model`, replicated over
`data`, with FSDP2 (`fully_shard` on a 2-D DeviceMesh, which replicates
over dim 0 and shards dim 0 of every tensor over dim 1); the JAX package
shards each tensor's largest divisible axis instead. The gradients are
averaged over every rank, which is the gradient of the global batch's mean
loss: the `model` ranks of a row block compute the same gradient, or, with
the pair grid's rows split over them (`parallel.sequence`), each holds
`model` times its share of it, so their mean is the sum of the shares.

Sequence parallelism (`shard_batch(..., shard_grid=True)`): the `model`
ranks of a row block also split the rows of its pair grids (the JAX
package's `P("data", "model")` of `grid_sharding`), and the layers
exchange what crosses a row block through `parallel.sequence`.

Random draws (`RowGenerator`): every draw of a step is made at the global
batch's shape, and a draw of the grid at the whole grid's, from the step's
generator, and each rank keeps its rows, so a step's draws do not depend
on the mesh; a draw made once per batch (a 0-d one) is the same on every
rank.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Any

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = timedelta(minutes=30)


# ----------------------------------------------------------- process group


@dataclass(frozen=True)
class Dist:
    """This process's place among the ranks, and its device."""

    rank: int
    world: int
    local_rank: int
    local_world: int
    device: torch.device

    @property
    def host_id(self) -> int:
        return self.rank // self.local_world

    @property
    def host_count(self) -> int:
        return self.world // self.local_world


def _env_int(name, default):
    return int(os.environ.get(name, default))


def init_distributed(device=None, init_method=None,
                     timeout=DEFAULT_TIMEOUT) -> Dist:
    """Join the ranks of a `torchrun` launch (RANK, WORLD_SIZE, LOCAL_RANK,
    LOCAL_WORLD_SIZE and, for `env://`, MASTER_ADDR and MASTER_PORT from
    the environment): NCCL on CUDA, where the rank takes `cuda:LOCAL_RANK`,
    gloo on the CPU, which the caller asks for with `device="cpu"`. A
    failure to join ends the run: there is no fallback. Where the process
    group exists already, only reads this process's place in it."""
    from .. import resolve_device

    dev = resolve_device(device)
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank, world = _env_int("RANK", 0), _env_int("WORLD_SIZE", 1)
    local_rank = _env_int("LOCAL_RANK", rank)
    local_world = _env_int("LOCAL_WORLD_SIZE", world)
    if world % local_world:
        raise ValueError(f"WORLD_SIZE {world} is not a multiple of "
                         f"LOCAL_WORLD_SIZE {local_world}")
    if dev.type == "cuda":
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK {local_rank} but only "
                               f"{torch.cuda.device_count()} CUDA devices")
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=init_method or "env://", rank=rank,
            world_size=world, timeout=timeout)
    return Dist(rank, world, local_rank, local_world, dev)


# -------------------------------------------------------------------- mesh


def mesh_axes(batch_size: int, world: int, data: int = -1,
              model: int = 1) -> tuple[int, int]:
    """(data, model) by the JAX trainer's rule
    (text2protein_tpu/cli/train.py:187-200): model = mesh.model, data =
    gcd(batch_size, mesh.data or world // model). Raises where data x model
    is not the world size (the JAX trainer leaves the surplus devices
    idle)."""
    model = max(int(model), 1)
    want = int(data) if int(data) != -1 else world // model
    got = math.gcd(int(batch_size), want)
    if got * model != world:
        raise ValueError(
            f"mesh data={got} x model={model} (mesh.data={data}, "
            f"mesh.model={model}, batch_size={batch_size}: data = "
            f"gcd(batch_size, {want})) does not fill the world size "
            f"{world}")
    return got, model


@dataclass(frozen=True)
class Mesh:
    """A ('data', 'model') mesh and this rank's place on it. `device_mesh`
    is the torch DeviceMesh; None in one process (the pure functions below
    need only the sizes and the rank)."""

    data: int
    model: int
    rank: int = 0
    host_count: int = 1
    device_mesh: Any = None

    @property
    def world(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def host_id(self) -> int:
        return self.rank // (self.world // self.host_count)

    def group(self, axis: str):
        """The process group of this rank's line along `axis`."""
        return self.device_mesh.get_group(axis)


def make_mesh(data: int, model: int, device="cpu",
              host_count: int = 1) -> Mesh:
    """The mesh of the process group's ranks, data x model of them."""
    from torch.distributed.device_mesh import init_device_mesh

    if data * model != dist.get_world_size():
        raise ValueError(f"mesh data={data} x model={model} does not fill "
                         f"the world size {dist.get_world_size()}")
    device_mesh = init_device_mesh(torch.device(device).type, (data, model),
                                   mesh_dim_names=("data", "model"))
    return Mesh(data, model, dist.get_rank(), host_count, device_mesh)


# ------------------------------------------------------------------- rows


def batch_rows(mesh: Mesh, global_b: int) -> tuple[int, int]:
    """[lo, hi) of this rank's rows in a global batch of `global_b` rows
    (the JAX package's `P("data")` shard)."""
    if global_b % mesh.data:
        raise ValueError(f"a batch of {global_b} rows does not split over "
                         f"data={mesh.data}")
    per = global_b // mesh.data
    return mesh.data_index * per, (mesh.data_index + 1) * per


def grid_rows(mesh: Mesh, n: int) -> tuple[int, int]:
    """[lo, hi) of this rank's rows of an (n, n) pair grid split over the
    `model` ranks (the JAX package's `P("data", "model")` shard)."""
    if n % mesh.model:
        raise ValueError(f"a pair grid of {n} rows does not split over "
                         f"model={mesh.model}")
    per = n // mesh.model
    return mesh.model_index * per, (mesh.model_index + 1) * per


def shard_batch(mesh: Mesh | None, batch: dict, per_node: bool = True,
                shard_grid: bool = False) -> dict:
    """This rank's rows of every key of `batch` (arrays, tensors, lists;
    the whole batch without a mesh). With `per_node` the batch is this
    node's share of the global batch (batch_size rows of batch_size x
    host_count); else it is the whole global batch, which every node
    holds. With `shard_grid` (sequence parallelism) also this rank's rows
    of the pair grid keys (`coords_6d`, `mask_pair`, `mask_inpaint`: axis
    1), over the `model` ranks."""
    from .sequence import GRID_KEYS

    if mesh is None:
        return batch
    def rows(v):
        return hasattr(v, "__len__") and not isinstance(v, str)

    n = len(next(v for v in batch.values() if rows(v)))
    if per_node:
        lo, hi = batch_rows(mesh, n * mesh.host_count)
        lo, hi = lo - mesh.host_id * n, hi - mesh.host_id * n
    else:
        lo, hi = batch_rows(mesh, n)
    out = {}
    for k, v in batch.items():
        if rows(v):
            if len(v) != n:
                raise ValueError(f"batch key {k} has {len(v)} rows, not {n}")
            v = v[lo:hi]
            if shard_grid and k in GRID_KEYS:
                g0, g1 = grid_rows(mesh, v.shape[1])
                v = v[:, g0:g1]
        out[k] = v
    return out


def gather_rows(mesh: Mesh | None, x: torch.Tensor) -> torch.Tensor:
    """The global batch from every data rank's rows (every rank gets it)."""
    if mesh is None or mesh.data == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.data)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group("data"))
    return torch.cat(parts)


def mean_over_rows(mesh: Mesh | None, x: torch.Tensor) -> torch.Tensor:
    """The mean over the data ranks of a per-rank mean over equal row
    blocks: the global batch's mean, the same on every rank."""
    if mesh is None or mesh.data == 1:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=mesh.group("data"))
    return x / mesh.data


# ------------------------------------------------------------------ draws


class RowGenerator:
    """A torch.Generator whose draws are made for the global batch and the
    whole pair grid. A draw of shape (b, ...) is drawn at (total, ...) and
    the batch's rows [lo, hi) are kept. A draw of the grid (`rows_dim`: the
    axis of the grid's rows, or of its row-major tokens) is drawn with that
    axis `blocks` times as long and row block `block` of it is kept; with
    `block` None (the `model` ranks stacked on the batch axis,
    `parallel.sequence.StackedRowGroup`) every block is kept, stacked
    rank-major on the batch axis, and a draw not of the grid is repeated
    once per block. A 0-d draw is drawn as it is. `get_state` and
    `set_state` are the generator's (`models.layers.remat` replays
    them)."""

    def __init__(self, generator, lo: int, hi: int, total: int,
                 blocks: int = 1, block: int | None = 0):
        self.generator, self.lo, self.hi, self.total = (
            generator, lo, hi, total)
        self.blocks, self.block = blocks, block

    @property
    def device(self):
        return self.generator.device

    def get_state(self):
        return self.generator.get_state()

    def set_state(self, state):
        self.generator.set_state(state)

    def draw(self, fn, shape, rows_dim=None, **kwargs):
        shape = tuple(shape)
        if not shape:
            return fn(shape, generator=self.generator, **kwargs)
        copies = self.blocks if self.block is None else 1
        if shape[0] != copies * (self.hi - self.lo):
            raise ValueError(f"a draw of {shape} from rows {self.lo}:"
                             f"{self.hi} of {self.total}"
                             + (f" x {copies} copies" if copies > 1 else ""))
        full = [self.total, *shape[1:]]
        grid = rows_dim is not None and self.blocks > 1
        if grid:
            full[rows_dim] *= self.blocks
        out = fn(tuple(full), generator=self.generator,
                 **kwargs)[self.lo:self.hi]
        if not grid:
            return out.repeat(copies, *([1] * (out.ndim - 1))) \
                if copies > 1 else out
        parts = out.chunk(self.blocks, dim=rows_dim)
        return torch.cat(parts) if self.block is None else parts[self.block]


def row_generator(generator, mesh: Mesh | None, rows: int, group=None):
    """`generator` for a rank that holds `rows` rows of the global batch
    (of each stacked copy, under a StackedRowGroup) and, with a row `group`
    (`parallel.sequence`), its rows of the grid: itself where the rank holds
    the whole batch and the whole grid, else a RowGenerator."""
    data = 1 if mesh is None else mesh.data
    blocks = 1 if group is None else group.size
    if generator is None or (data == 1 and blocks == 1):
        return generator
    lo = 0 if mesh is None else mesh.data_index * rows
    return RowGenerator(generator, lo, lo + rows, rows * data, blocks,
                        0 if group is None else group.index)


def _draw(fn, shape, generator, rows_dim=None, **kwargs):
    if isinstance(generator, RowGenerator):
        return generator.draw(fn, shape, rows_dim, **kwargs)
    return fn(tuple(shape), generator=generator, **kwargs)


def rand(shape, generator=None, device=None, dtype=torch.float32,
         rows_dim=None):
    """torch.rand from `generator`, a torch.Generator or a RowGenerator;
    `rows_dim` marks a draw of the grid (the axis of its rows)."""
    return _draw(torch.rand, shape, generator, rows_dim, device=device,
                 dtype=dtype)


def randn(shape, generator=None, device=None, dtype=torch.float32,
          rows_dim=None):
    """torch.randn from `generator`, a torch.Generator or a RowGenerator;
    `rows_dim` marks a draw of the grid (the axis of its rows)."""
    return _draw(torch.randn, shape, generator, rows_dim, device=device,
                 dtype=dtype)


# ---------------------------------------------------------- sharded state


def _dtensor_type():
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:  # torch < 2.5
        from torch.distributed._tensor import DTensor
    return DTensor


def is_sharded(t) -> bool:
    return isinstance(t, _dtensor_type())


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor (a view), or `t` itself."""
    return t.to_local() if is_sharded(t) else t


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a DTensor (a collective: every rank calls it),
    or `t` itself."""
    return t.full_tensor() if is_sharded(t) else t


def local_rows(full: torch.Tensor, like) -> torch.Tensor:
    """The part of `full` that this rank holds of `like`, a DTensor of the
    same global shape: along each sharded mesh dimension, the chunk of
    torch.chunk's sizes (ceil(n / size), the last ones shorter or empty)."""
    from torch.distributed.tensor.placement_types import Shard

    out = full
    for mesh_dim, p in enumerate(like.placements):
        if isinstance(p, Shard):
            n = out.shape[p.dim]
            size = like.device_mesh.size(mesh_dim)
            step = -(-n // size)
            lo = min(like.device_mesh.get_local_rank(mesh_dim) * step, n)
            out = out.narrow(p.dim, lo, min(step, n - lo))
    return out


def distribute_like(full: torch.Tensor, like) -> torch.Tensor:
    """`full` as a DTensor placed as `like` (no communication: every rank
    holds `full`)."""
    out = torch.zeros_like(like)
    local(out).copy_(local_rows(full.to(like.device, like.dtype), like))
    return out


def _fsdp():
    try:
        from torch.distributed import fsdp
        fsdp.fully_shard  # noqa: B018
    except (ImportError, AttributeError):  # torch < 2.6
        from torch.distributed._composable import fsdp
    return fsdp


def reshard(model: torch.nn.Module) -> None:
    """Free every gathered parameter of a model under FSDP2, so the next
    forward gathers the shards anew. The root unit keeps its parameters
    gathered after a forward (its backward would gather them again), so
    a forward made outside a train step (the eval step, with the EMA
    swapped into the shards) must be followed, and preceded, by this."""
    cls = _fsdp().FSDPModule
    for m in model.modules():
        if isinstance(m, cls):
            m.reshard()


def shard_params(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """FSDP2 over the mesh, in place: each residual, attention and
    transformer block of the UNet is a unit of its own, the rest one unit
    at the root. With model > 1 a unit's parameters are gathered for its
    forward, freed, and gathered again for its backward; with model = 1
    their gathered copy is the whole tensor either way, so it is kept from
    the forward to the backward (one gather a step instead of two). No
    MixedPrecisionPolicy: parameters keep their dtype and gradients are
    reduced in it. The reduction is FSDP2's mean over every rank, with or
    without the grid's rows split over `model` (the module docstring says
    why both are the loss's gradient)."""
    from ..models import layers
    from ..models.attention import SpatialTransformer

    fully_shard = _fsdp().fully_shard
    units = (layers.ResnetBlockBigGAN, layers.ResnetBlockDDPM,
             layers.AttnBlock, SpatialTransformer)
    regather = mesh.model > 1
    for m in list(model.modules()):
        if m is not model and isinstance(m, units):
            fully_shard(m, mesh=mesh.device_mesh,
                        reshard_after_forward=regather)
    fully_shard(model, mesh=mesh.device_mesh, reshard_after_forward=regather)
    return model


@torch.no_grad()
def shard_train_state(state, mesh: Mesh):
    """A TrainState sharded over the mesh, in place: the model under FSDP2
    (`shard_params`), Adam over the sharded parameters with its moments
    placed as them, the EMA placed as them, the global-norm clip summed
    over the `model` ranks. Every rank must hold the same state (the same
    seed, or the same checkpoint) before the call."""
    opt = state.optimizer
    old_params = list(opt.params)
    old_state = [opt.adam.state.get(p, {}) for p in old_params]
    names = [k for k, p in state.model.named_parameters() if p.requires_grad]
    shard_params(state.model, mesh)
    sharded = dict(state.model.named_parameters())
    opt.params = [sharded[k] for k in names]
    opt.adam = type(opt.adam)(opt.params, **opt.adam.defaults)
    for p, s in zip(opt.params, old_state):
        if s:
            opt.adam.state[p] = {
                k: distribute_like(v, p) if (torch.is_tensor(v)
                                             and v.shape == p.shape) else v
                for k, v in s.items()}
    opt.norm_group = mesh.group("model") if mesh.model > 1 else None
    state.ema.params = {k: distribute_like(v, sharded[k])
                        for k, v in state.ema.params.items()}
    state.mesh = mesh
    return state
