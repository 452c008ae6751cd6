"""Train and eval steps (counterpart of text2protein_tpu/training/steps.py).

A train step is loss and backward -> clip -> Adam -> EMA on one device; an
eval step computes the loss with the EMA params. Every random draw of a
step's loss comes from one generator seeded from (seed, step), which takes
the place of the JAX package's `jax.random.fold_in(rng, state.step)`; the
step's random inpainting mask (the inpainting condition) comes from a
stream of its own, seeded from (seed, step, MASK_STREAM), as the JAX
trainer splits a mask key apart from the step's key. The JAX
package's fused multi-step launch (`make_multi_train_step`) exists to hide
a TPU's dispatch latency; here it is a plain loop over `train_step`.

With a `mesh` (`parallel.mesh`, the state sharded by `shard_train_state`)
each rank takes its rows of the global batch, every draw is made for the
global batch from the same generator and the rank keeps its rows
(`parallel.mesh.RowGenerator`), FSDP2 averages the gradients over the
ranks, and the loss a step returns is the global batch's mean, the same on
every rank. So the step computes what the one-device step computes on the
global batch, up to the rounding of the reductions.

With `shard_grid` (sequence parallelism, JAX `make_train_step(...,
shard_grid=True)`) the `model` ranks of a row block also split the rows of
its pair grids (`parallel.sequence`): the batch holds this rank's rows of
`coords_6d`, `mask_pair` and `mask_inpaint` (`parallel.mesh.shard_batch(
..., shard_grid=True)`), featurization on the device and the inpainting
masks build the whole grid and keep the rank's rows, every draw of the
grid is made for the whole grid, and the loss is still the global batch's.
A `parallel.sequence.StackedRowGroup` in place of True runs the `model`
ranks in one process, stacked on the batch axis (its batch from
`StackedRowGroup.shard_batch`). The eval step and the samplers hold whole
grids, as in the JAX package.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..conditioning import random_mask_batch
from ..data.featurize import featurize_batch
from ..diffusion.ema import ema_update
from ..diffusion.losses import get_sde_loss_fn
from ..parallel.mesh import local, mean_over_rows, reshard, row_generator
from ..parallel.mesh import shard_train_state  # noqa: F401 (JAX's home)
from ..parallel import sequence
from .state import TrainState

MASK_STREAM = 1  # the inpainting masks' stream of step_generator


def step_generator(seed: int, step: int, device,
                   stream: int = 0) -> torch.Generator:
    """A generator on `device` seeded from (seed, step), or from (seed,
    step, stream) for a stream other than 0."""
    entropy = [int(seed) % 2**32, int(step)] + ([stream] if stream else [])
    value = int(np.random.SeedSequence(entropy).generate_state(
        1, np.uint64)[0]) % 2**63
    return torch.Generator(device=device).manual_seed(value)


def featurize(config, batch, row_group=None):
    """The batch the loss takes: a batch that carries backbones (`bb`, from
    `data.featurize_on_device`) gets coords_6d and mask_pair built on its
    device, with the SS block channels `ss_block` for C=8 (JAX
    `_featurizer`), and keeps this rank's rows of them under a
    `row_group`; any other batch is returned as it is."""
    if "bb" not in batch or "coords_6d" in batch:
        return batch
    coords_6d, mask_pair = featurize_batch(batch["bb"], batch["mask_res"],
                                           config.data.num_channels,
                                           ss_block=batch.get("ss_block"))
    if row_group is not None:
        coords_6d = row_group.local_rows(coords_6d, 1)
        mask_pair = row_group.local_rows(mask_pair, 1)
    return dict(batch, coords_6d=coords_6d, mask_pair=mask_pair)


def with_inpainting_mask(config, batch, seed, step, mesh=None,
                         row_group=None):
    """The batch with a random inpainting mask drawn on its device from
    step_generator(seed, step, MASK_STREAM), where the config conditions on
    inpainting and the batch has none yet; on a mesh, drawn for the global
    batch and this rank's rows kept, and under a `row_group` its rows of
    the grid."""
    if ("inpainting" not in config.model.condition
            or "mask_inpaint" in batch):
        return batch
    lengths = batch["length"]
    copies = 1 if row_group is None else row_group.copies
    gen = row_generator(
        step_generator(seed, step, lengths.device, MASK_STREAM), mesh,
        lengths.shape[0] // copies, row_group)
    mask = random_mask_batch(lengths, config.data.max_res_num, config,
                             generator=gen)
    if row_group is not None:
        mask = row_group.local_rows(mask, 1)
    return dict(batch, mask_inpaint=mask)


def make_train_step(config, sde, model, mesh=None, shard_grid=False):
    """Returns train_step(state, batch, seed) -> loss (a 0-d tensor). On a
    `mesh`, `batch` holds this rank's rows and the loss is the global
    batch's mean. `shard_grid`: True splits the pair grid's rows over the
    mesh's `model` ranks (a no-op with one), a `parallel.sequence.RowGroup`
    over that group; raises ValueError where the rows do not split evenly
    at every level of the model."""
    if shard_grid is True:
        if mesh is None:
            raise ValueError("shard_grid=True needs a mesh (or pass a "
                             "parallel.sequence.RowGroup)")
        group = sequence.row_group(mesh)
    else:
        group = shard_grid or None
    if group is not None:
        sequence.check_grid(model.max_res_num, model.num_resolutions,
                            group.size)
    copies = 1 if group is None else group.copies
    loss_fn = get_sde_loss_fn(
        sde, model, train=True, condition=tuple(config.model.condition),
        context_dropout=float(config.model.get("context_dropout", 0.0)),
        row_group=group,
    )

    def train_step(state: TrainState, batch, seed):
        batch = with_inpainting_mask(config, featurize(config, batch, group),
                                     seed, state.step, mesh, group)
        coords = batch["coords_6d"]
        gen = row_generator(step_generator(seed, state.step, coords.device),
                            mesh, coords.shape[0] // copies, group)
        state.optimizer.zero_grad()
        with sequence.rows_split(model, group):
            loss = loss_fn(None, batch, gen)
            loss.backward()
        state.optimizer.step()
        ema_update(state.ema, state.params)
        state.step += 1
        return mean_over_rows(mesh, loss.detach())

    return train_step


def make_multi_train_step(config, sde, model, mesh=None):
    """Returns multi_step(state, batches, seed) -> losses (K,): the K train
    steps of `batches` (a sequence of K batches), one after the other, each
    with its own step's generator; the same as K calls of `train_step`."""
    train_step = make_train_step(config, sde, model, mesh)

    def multi_step(state: TrainState, batches, seed):
        return torch.stack([train_step(state, b, seed) for b in batches])

    return multi_step


@contextlib.contextmanager
def ema_swapped_in(state: TrainState):
    """The model holds the EMA parameters inside the block and its own
    after it (sharded parameters are swapped shard by shard: the EMA of a
    sharded model cannot be passed as a params dict, as FSDP2 gathers the
    module's own shards; the gathered copies are freed on the way in and
    out)."""
    params = dict(state.model.named_parameters())
    saved = {k: local(p).detach().clone() for k, p in params.items()}
    reshard(state.model)
    with torch.no_grad():
        for k, p in params.items():
            local(p).copy_(local(state.ema.params[k]))
    try:
        yield
    finally:
        reshard(state.model)
        with torch.no_grad():
            for k, p in params.items():
                local(p).copy_(saved[k])


def make_eval_step(config, sde, model, mesh=None):
    """Returns eval_step(state, batch, seed) -> loss, computed with the EMA
    params; its draws are fixed by `seed` alone (the inpainting masks from
    step_generator(seed, 0, MASK_STREAM)), so two passes at the same params
    give the same loss. On a `mesh`, the global batch's mean."""
    loss_fn = get_sde_loss_fn(sde, model, train=False,
                              condition=tuple(config.model.condition))

    def eval_step(state: TrainState, batch, seed):
        batch = with_inpainting_mask(config, featurize(config, batch), seed,
                                     0, mesh)
        coords = batch["coords_6d"]
        gen = torch.Generator(device=coords.device)
        gen.manual_seed(int(seed))
        gen = row_generator(gen, mesh, coords.shape[0])
        with torch.no_grad():
            if mesh is None:
                return loss_fn(state.ema.params, batch, gen)
            with ema_swapped_in(state):
                return mean_over_rows(mesh, loss_fn(None, batch, gen))

    return eval_step
