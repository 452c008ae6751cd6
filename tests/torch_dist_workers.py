"""The rank functions of the multi-rank tests (tests/test_torch_distributed*
.py, and tests/test_torch_gpu.py on the card): each runs inside one rank
started by `text2protein_tpu_torch.parallel.launch.spawn` (gloo on the CPU,
one thread; NCCL on CUDA), imports no JAX, and returns host objects.
"""

from __future__ import annotations

import numpy as np
import torch

from text2protein_tpu_torch import use_full_f32
from text2protein_tpu_torch.config import load_config
from text2protein_tpu_torch.diffusion.sde import get_sde
from text2protein_tpu_torch.models.unet import build_model, init_random_weights
from text2protein_tpu_torch.parallel.mesh import (
    full_tensor,
    init_distributed,
    make_mesh,
    mean_over_rows,
    shard_batch,
    shard_train_state,
)
from text2protein_tpu_torch.training.state import create_train_state
from text2protein_tpu_torch.training.steps import make_train_step


def tensors(batch, device="cpu"):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def build_state(cfg_dict, seed=0, state_dict=None, device="cpu"):
    """A one-device TrainState on `device`: random live weights from
    `seed`, or `state_dict`."""
    cfg = load_config(cfg_dict)
    model = init_random_weights(build_model(cfg, device="cpu"), seed)
    if state_dict is not None:
        model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                               for k, v in state_dict.items()})
    return cfg, create_train_state(cfg, model.to(device))


def recording_norms(state):
    """Record the global gradient norm of every optimizer step."""
    norms, step = [], state.optimizer.step

    def record():
        norm = step()
        norms.append(float(norm))
        return norm

    state.optimizer.step = record
    return norms


def host_state(state):
    """{params, ema} gathered whole, as numpy."""
    return {
        "params": {k: full_tensor(p.detach()).cpu().numpy()
                   for k, p in state.model.named_parameters()},
        "ema": {k: full_tensor(v).cpu().numpy()
                for k, v in state.ema.params.items()},
    }


def train_steps(cfg_dict, data, model, batches, seed, device="cpu",
                shard_grid=False):
    """Train steps on a data x model mesh, each of `batches` (global numpy
    batches) cut to this rank's rows (and, with `shard_grid`, its rows of
    the pair grid): the losses, the gradient norms, the last step's
    gradients (clipped) and the final state gathered."""
    dev = init_distributed(device).device
    if dev.type == "cuda":
        use_full_f32()
    cfg, state = build_state(cfg_dict, device=dev)
    mesh = make_mesh(data, model, device=dev)
    shard_train_state(state, mesh)
    sde, _ = get_sde(cfg)
    step = make_train_step(cfg, sde, state.model, mesh, shard_grid=shard_grid)
    norms = recording_norms(state)
    losses = [float(step(state, tensors(shard_batch(
        mesh, b, shard_grid=shard_grid), dev), seed)) for b in batches]
    return {"losses": losses, "norms": norms, **host_state(state),
            "grads": {k: full_tensor(p.grad).cpu().numpy()
                      for k, p in state.model.named_parameters()},
            "placements": {k: str(p.placements) for k, p in
                           state.model.named_parameters()}}


def sp_loss(cfg_dict, state_dict, data, model, batch, t, z):
    """The train loss (dropout 0) at injected t and z with the pair grid's
    rows split over the `model` ranks (FSDP2 on the data x model mesh):
    the global batch's mean, on this rank."""
    from text2protein_tpu_torch.diffusion.losses import get_sde_loss_fn
    from text2protein_tpu_torch.parallel.mesh import batch_rows, grid_rows
    from text2protein_tpu_torch.parallel.sequence import (
        row_group,
        rows_split,
    )

    init_distributed("cpu")
    cfg, state = build_state(cfg_dict, state_dict=state_dict)
    mesh = make_mesh(data, model)
    shard_train_state(state, mesh)
    sde, _ = get_sde(cfg)
    group = row_group(mesh)
    loss_fn = get_sde_loss_fn(sde, state.model, train=True,
                              condition=tuple(cfg.model.condition),
                              row_group=group)
    lo, hi = batch_rows(mesh, len(t))
    g0, g1 = grid_rows(mesh, z.shape[1])
    with rows_split(state.model, group):
        loss = loss_fn(None, tensors(shard_batch(mesh, batch,
                                                 shard_grid=True)),
                       t=torch.from_numpy(t[lo:hi]),
                       z=torch.from_numpy(
                           np.ascontiguousarray(z[lo:hi, g0:g1])))
    return float(mean_over_rows(mesh, loss.detach()))


def sequence_parallel(loss_args, train_args):
    """`sp_loss(*loss_args)` and `train_steps(*train_args,
    shard_grid=True)` in one process group."""
    return {"loss": sp_loss(*loss_args),
            "train": train_steps(*train_args, shard_grid=True)}


def loss_and_grads(cfg_dict, state_dict, data, model, batch, t, z):
    """The train loss (dropout 0) at injected t and z and the gradients
    FSDP2 reduces, gathered whole."""
    from text2protein_tpu_torch.diffusion.losses import get_sde_loss_fn
    from text2protein_tpu_torch.parallel.mesh import batch_rows

    init_distributed("cpu")
    cfg, state = build_state(cfg_dict, state_dict=state_dict)
    mesh = make_mesh(data, model)
    shard_train_state(state, mesh)
    sde, _ = get_sde(cfg)
    loss_fn = get_sde_loss_fn(sde, state.model, train=True,
                              condition=tuple(cfg.model.condition))
    lo, hi = batch_rows(mesh, len(t))
    loss = loss_fn(None, tensors(shard_batch(mesh, batch)),
                   t=torch.from_numpy(t[lo:hi]),
                   z=torch.from_numpy(z[lo:hi]))
    loss.backward()
    return {"loss": float(mean_over_rows(mesh, loss.detach())),
            "grads": {k: full_tensor(p.grad).numpy()
                      for k, p in state.model.named_parameters()}}


def global_norms(cfg_dict, data, model, grads, max_norm):
    """global_norm and clip_by_global_norm over the gradients `grads`
    (whole numpy arrays) placed as the sharded parameters."""
    from text2protein_tpu_torch.parallel.mesh import distribute_like
    from text2protein_tpu_torch.training.state import (
        clip_by_global_norm,
        global_norm,
    )

    init_distributed("cpu")
    cfg, state = build_state(cfg_dict)
    mesh = make_mesh(data, model)
    shard_train_state(state, mesh)
    group = state.optimizer.norm_group
    params = dict(state.model.named_parameters())
    g = [distribute_like(torch.from_numpy(grads[k]), params[k])
         for k in params]
    norm = float(global_norm(g, group))
    clipped = float(clip_by_global_norm(g, max_norm, group))
    return {"norm": norm, "clip_norm": clipped,
            "clipped": {k: full_tensor(x).numpy()
                        for k, x in zip(params, g)},
            "local_shapes": {k: tuple(p.to_local().shape)
                             for k, p in params.items()}}


def train_cli(argv):
    """cli/train.main on this rank: its results, on the host."""
    from text2protein_tpu_torch.cli import train

    res = train.main(argv)
    return {"losses": res["losses"], "evals": res["evals"],
            "workdir": str(res["workdir"]), "mesh": res["mesh"],
            "steps": res["steps"], **host_state(res["state"])}


def pc_samples(cfg_dict, data, model, batch, seed, num_steps):
    """The PC sampler at the tiny widths, batch-sharded: this rank's rows
    drawn for the global batch, gathered on every rank."""
    from text2protein_tpu_torch.diffusion.sampling import get_pc_sampler
    from text2protein_tpu_torch.parallel.mesh import (
        gather_rows,
        row_generator,
    )

    init_distributed("cpu")
    cfg, state = build_state(cfg_dict)
    mesh = make_mesh(data, model)
    rows = tensors(shard_batch(mesh, batch, per_node=False))
    b = rows["length"].shape[0]
    sde, _ = get_sde(cfg)
    n, c = cfg.data.max_res_num, cfg.data.num_channels
    sampler = get_pc_sampler(sde, state.model, (b, n, n, c),
                             num_steps=num_steps, mesh=mesh)
    gen = row_generator(torch.Generator().manual_seed(seed), mesh, b)
    out, _ = sampler(gen, condition={"length": rows["mask_pair"]},
                     context=rows["context"],
                     context_mask=rows["context_mask"])
    return gather_rows(mesh, out).numpy()
