"""The driver-contract entry points (counterpart of __graft_entry__.py).

entry(device=None)       -> (fn, example_args): the flagship text-conditioned
                            L=128 score model's forward, fn(params, x,
                            time_cond, context, context_mask), with its
                            example arguments on the device (CUDA unless the
                            caller asks for the CPU).
dryrun_multichip(n, device=None)
                         -> n ranks on a ('data', 'model') mesh run one full
                            sharded train step and a batch-sharded PC
                            sampler on the JAX dryrun's tiny shapes.

The dryrun's mesh is model = 2 where n is even and at least 4, else
model = 1, as in the JAX package. Where model = 2 the train step also
splits the pair grid's rows over `model` (the JAX dryrun's `shard_grid`,
sequence parallelism: `parallel.sequence`), and the `model` ranks shard
the parameters, Adam and the EMA (FSDP2); the sampler holds whole grids,
its batch split over every rank's `data` index. On CUDA, n ranks need n
devices.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.func import functional_call

from . import resolve_device
from .config import flagship_config, load_config


def _init_model(config, device, seed=0):
    from .models.unet import build_model, init_params

    return init_params(build_model(config, device=device),
                       torch.Generator().manual_seed(seed))


def entry(device=None):
    """The flagship forward (eval mode) and its example arguments: x (2,
    128, 128, 5) from RandomState(0), time_cond zeros, a 64-token context
    of width 512 with every token kept, and the parameters drawn from the
    JAX initializers with seed 0."""
    device = resolve_device(device)
    config = flagship_config()
    model = _init_model(config, device).eval()

    b, n, c = 2, config.data.max_res_num, config.data.num_channels
    t_tokens, d_ctx = 64, config.model.context_dim
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(b, n, n, c).astype(np.float32))
    context = torch.from_numpy(rng.randn(b, t_tokens, d_ctx)
                               .astype(np.float32))
    args = (dict(model.named_parameters()), x.to(device),
            torch.zeros((b,), device=device), context.to(device),
            torch.ones((b, t_tokens), dtype=torch.bool, device=device))

    def fn(params, x, time_cond, context, context_mask):
        return functional_call(model, params, (x, time_cond),
                               {"context": context,
                                "context_mask": context_mask})

    return fn, args


def _dryrun_config():
    return load_config({
        "training": {"sde": "vesde"},
        "data": {"min_res_num": 4, "max_res_num": 16, "num_channels": 5},
        "model": {
            "condition": ["length"],
            "nf": 8,
            "ch_mult": [1, 2],
            "num_res_blocks": 1,
            "attn_resolutions": [8],
            "n_heads": 2,
            "context_dim": 16,
            "num_scales": 8,
            "dropout": 0.1,
        },
        "optim": {"warmup": 2},
    })


def _dryrun_batch(b, config):
    """The JAX dryrun's batch: length 12 of 16, random maps, an 8-token
    context."""
    n, c = config.data.max_res_num, config.data.num_channels
    rng = np.random.RandomState(0)
    mask_pair = np.zeros((b, n, n), bool)
    mask_pair[:, :12, :12] = True
    coords = rng.randn(b, n, n, c).astype(np.float32) * mask_pair[..., None]
    coords[..., -1] = mask_pair
    return {
        "coords_6d": coords,
        "mask_pair": mask_pair,
        "ss_spans": np.full((b, 4, 2), -1, np.int32),
        "length": np.full((b,), 12, np.int32),
        "context": rng.randn(b, 8, 16).astype(np.float32),
        "context_mask": np.ones((b, 8), bool),
    }


def _dryrun_rank(n_devices, device_type):
    """One rank of `dryrun_multichip`: its results, on the host."""
    from .diffusion.sampling import get_pc_sampler
    from .diffusion.sde import get_sde
    from .models.unet import build_model
    from .ops import flash
    from .parallel.mesh import (
        full_tensor,
        gather_rows,
        init_distributed,
        make_mesh,
        row_generator,
        shard_batch,
        shard_train_state,
    )
    from .training.state import create_train_state
    from .training.steps import make_train_step

    info = init_distributed(device_type)
    device = info.device
    if device.type == "cuda":
        from . import use_full_f32

        use_full_f32()
    config = _dryrun_config()
    model_axis = 2 if (n_devices % 2 == 0 and n_devices >= 4) else 1
    mesh = make_mesh(n_devices // model_axis, model_axis, device=device)
    sde, _ = get_sde(config)
    b = n_devices
    shard_grid = model_axis > 1
    batch = _dryrun_batch(b, config)

    def place(**kwargs):
        return {k: torch.from_numpy(v).to(device) for k, v in shard_batch(
            mesh, batch, per_node=False, **kwargs).items()}

    rows = place()
    flash.flash_attention_fwd.launches = 0
    flash.flash_attention_bwd.launches = 0
    t0 = time.perf_counter()
    state = shard_train_state(
        create_train_state(config, _init_model(config, device)), mesh)
    train_step = make_train_step(config, sde, state.model, mesh,
                                 shard_grid=shard_grid)
    loss = float(train_step(state, place(shard_grid=shard_grid), 1))
    train_s = time.perf_counter() - t0
    if not np.isfinite(loss) or state.step != 1:
        raise AssertionError(f"dryrun step: loss {loss}, step {state.step}")

    # the sampler, batch-sharded: each rank samples its rows with a whole
    # copy of the EMA, every draw made for the global batch
    t0 = time.perf_counter()
    ema_model = build_model(config, device=device)
    ema_model.load_state_dict({k: full_tensor(v)
                               for k, v in state.ema.params.items()})
    nres, c = config.data.max_res_num, config.data.num_channels
    local_b = rows["length"].shape[0]
    sampler = get_pc_sampler(sde, ema_model, (local_b, nres, nres, c),
                             snr=0.17, n_steps=1, denoise=True, eps=1e-5,
                             num_steps=8, mesh=mesh)
    gen = torch.Generator(device=device).manual_seed(2)
    samples, nfe = sampler(row_generator(gen, mesh, local_b),
                           condition={"length": rows["mask_pair"]},
                           context=rows["context"],
                           context_mask=rows["context_mask"])
    samples = gather_rows(mesh, samples).cpu().numpy()
    sample_s = time.perf_counter() - t0
    if samples.shape != (b, nres, nres, c) or not np.isfinite(samples).all():
        raise AssertionError(f"dryrun sampler: shape {samples.shape}, "
                             f"finite {np.isfinite(samples).all()}")
    return {"mesh": {"data": mesh.data, "model": mesh.model},
            "shard_grid": shard_grid, "loss": loss,
            "step": state.step, "samples": samples, "nfe": nfe,
            "train_seconds": train_s, "sample_seconds": sample_s,
            "fwd_launches": flash.flash_attention_fwd.launches,
            "bwd_launches": flash.flash_attention_bwd.launches}


def dryrun_multichip(n_devices: int, device=None, timeout: float = 600.0):
    """One full sharded train step (the pair grid's rows split over
    `model` where it is 2) and a batch-sharded PC sampler on `n_devices`
    ranks (a process each); returns rank 0's results (loss, samples (n,
    16, 16, 5), nfe, mesh, shard_grid, seconds, flash launches). On CUDA,
    n_devices above the device count raises."""
    from .parallel.launch import spawn

    device = resolve_device(device)
    res = spawn(_dryrun_rank, n_devices, args=(n_devices, device.type),
                device=device, timeout=timeout)[0]
    print(f"dryrun_multichip({n_devices}): mesh={res['mesh']} "
          f"sp={res['shard_grid']} loss={res['loss']:.4f}")
    print(f"dryrun_multichip({n_devices}): sampler ok "
          f"shape={res['samples'].shape} nfe={int(res['nfe'])}")
    return res


if __name__ == "__main__":
    fn, args = entry()
    with torch.no_grad():
        out = fn(*args)
    print("entry forward OK:", tuple(out.shape))
