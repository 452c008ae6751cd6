"""Training CLI (counterpart of text2protein_tpu/cli/train.py), on one device
or on a ('data', 'model') mesh of ranks.

config -> processed records -> 95/5 split -> a loop of train steps (loss
and backward -> clip -> Adam -> EMA) on batches the loader reads ahead,
each caption encoded by the text encoder, with an eval pass of the EMA
params every `training.eval_freq` steps and at the end. `training_loss`
(every `training.log_freq` steps), `avg_training_loss` and `avg_eval_loss`
(at the eval boundaries) go to `workdir/tb` (`utils/logging.MetricsWriter`),
as the JAX trainer writes them.

The data order is the JAX trainer's: epoch e is shuffled with the (e + 2)-th
draw of RandomState(config.seed), the first draw standing for the batch
the JAX trainer initializes its state from.

Every run has a workdir, `{--workdir_root}/{config stem}/{timestamp}` or
the `--resume` directory, holding `config.yml`, `train_ids.txt`,
`test_ids.txt` and the checkpoint triad (`training/checkpoint.py`): the
meta checkpoint every `training.snapshot_freq_for_preemption` steps and at
the end, `best_train` / `best_eval` at the eval boundaries where the
average improved, and `snapshot_<step>` at `training.snapshot_steps`. A
workdir that holds a checkpoint is resumed from its newest state and goes
on bit for bit (with the resident context table, where the resumed run's
launch groups fall as the first run's): the step's generator and the data
order are functions of the step. `--out` also writes the EMA params as a
state dict that `text2protein_tpu_torch.cli.serve --weights` loads. A new
run starts from the JAX model's initializers (`models.unet.init_params`),
drawn from `config.seed`.

With the inpainting condition each train step draws its random inpainting
masks on the device (`training.steps`); the eval pass draws them from its
batches' fixed seeds. With `training.snapshot_sampling` every eval boundary
samples one batch with the EMA params, conditioned on the last eval batch
(random inpainting masks), and pickles it (B, C, N, N) to
`samples/epoch_{epoch}/sample.pkl` in the workdir; the sampler is built
once.

`training.best_save_min_interval` (steps) defers best saves; a deferred
save stores the state of the boundary whose average the gate recorded, not
the state of the boundary where the save happens (the JAX trainer stores
the latter).

Runs on the GPU unless `--device cpu` is given; on the GPU the model runs in
the config's `model.dtype` under `use_full_f32()` (TF32 off for matmuls and
cuDNN, f32 accumulation of bf16 products) with cuDNN's per-shape algorithm
search on. With `data.featurize_on_device` the batches carry backbones (and
the SS block channels for C=8) and the step builds the 6D maps on the
device.

The resident context table (text2protein_tpu/cli/train.py:250-346): with
`data.featurize_on_device` and `training.steps_per_launch` K > 1, the
corpus's captions are deduplicated and encoded once into a bf16 table on
the device (one row per unique caption, gathered through each record's
index), if it fits in `data.max_context_table_bytes` (1 GiB by default).
The JAX trainer fuses K steps into one launch and feeds those launches
from the table; its tail steps (fewer than K left in the budget, groups
counted from the run's start step) and its eval pass encode each batch in
f32. The port runs every step as its own call (the fused launch hides a
TPU's dispatch latency), and takes each step's context from where the JAX
trainer would: the table's bf16 rows, cast to f32, on the steps of full
groups of K, the f32 encode elsewhere. Its eval and log boundaries fall at
steps, where the JAX trainer's fall at the ends of launches.

Under `torch.distributed.run` (WORLD_SIZE > 1, or `--multihost`) each
process is a rank on its own card (`cuda:LOCAL_RANK`, NCCL; gloo with
`--device cpu`) and the run trains on the `mesh:` section's mesh
(`parallel/mesh.py`): model = mesh.model, data = gcd(batch_size,
mesh.data or WORLD_SIZE // model), which must fill the world (the JAX
trainer leaves surplus devices idle; this one raises). Each node (a JAX
host) loads batch_size rows a step from its shard of the index space, so
the global batch is batch_size x nodes and an epoch has len(train) //
(batch_size x nodes) steps; each rank takes its rows of its node's batch
(and of the context table) and the state is sharded by FSDP2 over `model`.
The losses logged and the averages the best gate compares are the global
batch's means, the same on every rank; rank 0 alone writes the workdir
(config, ids, metrics, checkpoints, samples), every rank taking part in
gathering a checkpoint's state. On one node the run computes what the
one-device run computes at the same batch, up to the rounding of the
reductions, and its checkpoints resume on any mesh. A mesh that does not
fit the world raises before the first step, also in one process.

Usage (the JAX command line, the module name changed):
  python -m text2protein_tpu_torch.cli.train [config] [--local_test]
      [--data DIR] [--max_steps N] [--workdir_root DIR | --resume DIR]
      [--out ema.pt] [--device cpu] [--multihost]
  config may also be given as --config; --local_test caps
  training.batch_size at 2 and the dataset at its first 200 records.
  python -m torch.distributed.run --nproc_per_node=K -m
      text2protein_tpu_torch.cli.train --config configs/bench_l128.yml
      --data DIR  (K ranks on one node; several nodes: --nnodes,
      --node_rank, --rdzv_endpoint as torchrun takes them)
  e.g. --config configs/quality_n256.yml --data DIR: the N=256 model in
  bf16 with remat and featurization on the device, batch 8;
  --config configs/quality_ss.yml --data DIR: the SS + inpainting model
  (C=8 records, see `cli/prepare_dataset`)
"""

from __future__ import annotations

import math
import os
import pickle
import time
from datetime import datetime
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device, use_full_f32
from ..conditioning import batch_to_device_arrays, get_condition_from_batch
from ..config import bench_l128_config, load_config, save_config
from ..data.dataset import ProteinProcessedDataset
from ..data.loader import PrefetchLoader
from ..diffusion.sampling import get_sampling_fn
from ..diffusion.sde import get_sde
from ..models.unet import build_model, init_params
from ..parallel.mesh import (
    Mesh,
    full_tensor,
    gather_rows,
    init_distributed,
    make_mesh,
    mesh_axes,
    row_generator,
    shard_batch,
    shard_train_state,
)
from ..text.encoder import build_text_encoder
from ..training.checkpoint import CheckpointManager, state_slot
from ..training.state import create_train_state, param_count
from ..training.steps import (
    make_eval_step,
    make_train_step,
    step_generator,
)
from ..utils.logging import MetricsWriter
from . import ArgumentParser

SNAPSHOT_STREAM = 2  # step_generator stream of the snapshot samples


def build_argparser():
    p = ArgumentParser(description="Train the score model")
    p.positional_or_flag(
        "config", help="YAML config (default: configs/bench_l128.yml as "
        "bench_l128_config() builds it)")
    p.add_argument("--local_test", action="store_true",
                   help="cap training.batch_size at 2 and the dataset at "
                        "its first 200 records")
    p.add_argument("--data", type=str, default=None,
                   help="directory of processed .npz records (default: "
                        "data.processed_dataset_path)")
    p.add_argument("--max_steps", type=int, default=None,
                   help="override training.n_iters")
    p.add_argument("--workdir_root", type=str, default="training",
                   help="a new run's workdir is {root}/{config stem}/"
                        "{timestamp}")
    p.add_argument("--resume", type=str, default=None,
                   help="workdir to resume from its newest checkpoint")
    p.add_argument("--out", type=str, default=None,
                   help="also write the EMA params here (torch state dict)")
    p.add_argument("--device", type=str, default=None)
    p.add_argument("--multihost", action="store_true",
                   help="join the ranks of a torch.distributed launch even "
                        "at WORLD_SIZE 1")
    return p


def split_dataset(n, seed, eval_frac=0.05):
    """95/5 split with a fixed seed (the JAX package's split)."""
    rng = np.random.RandomState(seed)
    perm = rng.permutation(n)
    n_eval = max(1, int(n * eval_frac))
    return perm[n_eval:], perm[:n_eval]


def batches(dataset, indices, batch_size, max_len, rng, shuffle=True,
            drop_last=True):
    """One epoch of batches, read ahead by a background thread."""
    loader = PrefetchLoader(dataset, indices, batch_size, max_len,
                            seed=int(rng.randint(2**31)), shuffle=shuffle,
                            drop_last=drop_last)
    yield from loader


def train_batches_from(dataset, indices, batch_size, max_len, seed, step,
                       host_id=0, host_count=1):
    """The training stream of node `host_id` from step `step` on: epoch e
    of its shard of the index space shuffles with the (e + 2)-th draw of
    RandomState(seed), as the JAX trainer's stream does from step 0 (its
    first draw shuffles the batch it initializes the state from,
    text2protein_tpu/cli/train.py:205,348,451-454); a resumed run starts
    inside its epoch."""
    host_rng = np.random.RandomState(seed)
    shard = len(np.asarray(indices)[host_id::host_count])
    epoch, skip = divmod(step, max(1, shard // batch_size))
    for _ in range(1 + epoch):
        host_rng.randint(2**31)
    while True:
        yield from PrefetchLoader(dataset, indices, batch_size, max_len,
                                  seed=int(host_rng.randint(2**31)),
                                  start=skip, host_id=host_id,
                                  host_count=host_count)
        skip = 0


def make_eval_pass(config, dataset, eval_idx, bs, max_len, prepare,
                   eval_step):
    """A deterministic eval pass: the eval order and each batch's draws are
    fixed by config.seed, so two passes at the same params give the same
    loss. A split smaller than one batch is filled once by sampling with
    replacement. Returns eval_pass(state) -> (the average loss, the pass's
    last batch as the loader gave it); snapshot sampling is conditioned on
    that batch."""
    if len(eval_idx) < bs:
        idx = np.random.RandomState(config.seed + 17).choice(
            eval_idx, size=bs, replace=True)
    else:
        idx = np.asarray(eval_idx)

    def eval_pass(state):
        losses, last = [], None
        loader_rng = np.random.RandomState(config.seed + 23)
        for bi, batch in enumerate(batches(dataset, idx, bs, max_len,
                                           loader_rng, shuffle=False)):
            seed = (config.seed + 7919) * 1_000_003 + bi
            losses.append(float(eval_step(state, prepare(batch), seed)))
            last = batch
        return (float(np.mean(losses)) if losses else float("inf")), last

    return eval_pass


def build_context_table(dataset, encoder):
    """The corpus's captions, deduplicated in record order and encoded once
    (text2protein_tpu/cli/train.py:269-283): (table (U, T, D) bf16, mask
    table (U, T) bool, inv (n,) int32) as CPU tensors, where record i's
    context is table[inv[i]]. The unique captions are encoded 64 at a time
    and every chunk is padded to the widest chunk's T."""
    uniq = {}
    inv = np.empty(len(dataset), np.int32)
    for i in range(len(dataset)):
        inv[i] = uniq.setdefault(dataset.caption(i), len(uniq))
    ucaps = list(uniq)
    embs, masks = [], []
    for i in range(0, len(ucaps), 64):
        e, m = encoder.encode(ucaps[i:i + 64])
        embs.append(np.asarray(e))
        masks.append(np.asarray(m))
    t_max = max(e.shape[1] for e in embs)
    embs = [np.pad(e, ((0, 0), (0, t_max - e.shape[1]), (0, 0)))
            for e in embs]
    masks = [np.pad(m, ((0, 0), (0, t_max - m.shape[1]))) for m in masks]
    return (torch.from_numpy(np.concatenate(embs)).to(torch.bfloat16),
            torch.from_numpy(np.concatenate(masks).astype(bool)),
            torch.from_numpy(inv))


def context_table_size(dataset, encoder):
    """(unique captions, bytes) of the table `build_context_table` builds,
    from the captions' tokens alone: U x T x D x 2 (bf16), T the bucket of
    the longest caption, which is the widest chunk's."""
    ucaps = list(dict.fromkeys(dataset.caption(i)
                               for i in range(len(dataset))))
    return len(ucaps), (len(ucaps) * encoder.padded_width(ucaps)
                        * encoder.dim * 2)


def resident_table(config, dataset, encoder, device):
    """The resident context table on `device`, or None: only with
    `data.featurize_on_device` and `training.steps_per_launch` > 1, and
    only when it fits in `data.max_context_table_bytes`; prints the JAX
    trainer's line either way (text2protein_tpu/cli/train.py:286-299).
    The size is checked before any caption is encoded (the JAX trainer
    builds the table first, so a corpus far over the cap can exhaust the
    host before it falls back); the line and the choice are the same."""
    if not (config.data.get("featurize_on_device", False)
            and int(config.training.get("steps_per_launch", 1)) > 1):
        return None
    max_table = int(config.data.get("max_context_table_bytes", 1 << 30))
    unique, nbytes = context_table_size(dataset, encoder)
    if nbytes > max_table:
        print(f"context table is {nbytes / 2**30:.1f} GiB for "
              f"{unique} unique captions "
              f"(> {max_table / 2**30:.1f} cap); using per-launch "
              f"context shipping", flush=True)
        return None
    table, mask, inv = build_context_table(dataset, encoder)
    print(f"resident context table: {table.shape[0]} unique captions, "
          f"{nbytes / 2**20:.1f} MiB", flush=True)
    return {"table": table.to(device), "mask": mask.to(device),
            "inv": inv.to(device).long(), "bytes": nbytes}


def table_steps_end(start, budget, steps_per_launch):
    """The step before which every step of the run belongs to a full group
    of `steps_per_launch`, counted from the run's start step: the steps the
    JAX trainer fuses (text2protein_tpu/cli/train.py:469-481)."""
    k = max(1, int(steps_per_launch))
    return start + k * (max(0, budget - start) // k)


class BestGate:
    """Which states become best_train / best_eval. At an eval boundary,
    `offer` records an average that beats the kind's best together with
    the state of that boundary (`snapshot()`, a host copy); `due` hands out
    the recorded states once `min_interval` steps have passed since the
    last best save (or at the end of the run). So a deferred save stores
    the state whose average the gate holds. `saved` is the average of the
    state each best file holds."""

    def __init__(self, min_interval=0, saved=None, last_save=0):
        self.min_interval = int(min_interval)
        self.saved = dict(saved or {"train": math.inf, "eval": math.inf})
        self.best = dict(self.saved)
        self.pending = {}  # kind -> (average, slot)
        self.last_save = last_save

    def offer(self, kind, average, snapshot):
        if average < self.best[kind]:
            self.best[kind] = average
            self.pending[kind] = (average, snapshot())

    def due(self, step, done):
        """{kind: (average, slot)} to save now (and forget)."""
        if not self.pending or not (
                done or step - self.last_save >= self.min_interval):
            return {}
        out, self.pending = self.pending, {}
        self.last_save = step
        for kind, (average, _) in out.items():
            self.saved[kind] = average
        return out


def _once(fn):
    """fn, called at most once; later calls return the first result."""
    box = []

    def call():
        if not box:
            box.append(fn())
        return box[0]

    return call


class _NoWriter:
    """The metrics writer of the ranks other than 0."""

    def scalar(self, tag, value, step):
        pass

    def close(self):
        pass


def setup_mesh(args, config, device):
    """(rank info or None, mesh or None, device): the mesh of a distributed
    launch (WORLD_SIZE > 1 or --multihost), or None in one process. The
    config's mesh must fit the world either way."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    distributed = world > 1 or args.multihost or dist.is_initialized()
    if not distributed:
        mesh_axes(config.training.batch_size, 1, config.mesh.data,
                  config.mesh.model)
        return None, None, device
    info = init_distributed(device)
    data, model = mesh_axes(config.training.batch_size, info.world,
                            config.mesh.data, config.mesh.model)
    mesh = make_mesh(data, model, device=info.device,
                     host_count=info.host_count)
    return info, mesh, info.device


def main(argv=None):
    """Train; returns {"losses", "step_seconds", "lrs", "eval_loss",
    "evals", "state", "steps", "records", "workdir", "out", "table_steps",
    "context_table", "mesh"}; `evals` holds (step, avg_train, avg_eval) per
    eval boundary, `table_steps` counts the steps whose context came from
    the resident table, `context_table` is {"unique", "bytes"} of that
    table (None without one), and `mesh` is {"data", "model", "world",
    "nodes"} (None in one process)."""
    args = build_argparser().parse_args(argv)
    config = load_config(args.config) if args.config else bench_l128_config()
    if args.local_test:
        config.training.batch_size = min(config.training.batch_size, 2)
    device = resolve_device(args.device)
    owns_group = not dist.is_initialized()
    info, mesh, device = setup_mesh(args, config, device)
    try:
        return _train(args, config, device, info, mesh)
    finally:
        if info is not None and owns_group:
            dist.destroy_process_group()


def _train(args, config, device, info, mesh: Mesh | None):
    rank = info.rank if info else 0
    host_id, host_count = (info.host_id, info.host_count) if info else (0, 1)
    writes = rank == 0
    say = print if writes else (lambda *a, **k: None)
    if device.type == "cuda":
        use_full_f32()

    if args.resume:
        workdir = Path(args.resume)
    else:
        cfg_name = Path(args.config).stem if args.config else "bench_l128"
        stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
        workdir = Path(args.workdir_root) / cfg_name / stamp
    if mesh is not None:  # rank 0's clock names the workdir
        box = [str(workdir)]
        dist.broadcast_object_list(box, src=0)
        workdir = Path(box[0])
    if writes:
        workdir.mkdir(parents=True, exist_ok=True)
        save_config(config, workdir / "config.yml")

    dataset = ProteinProcessedDataset(args.data
                                      or config.data.processed_dataset_path)
    if args.local_test:
        dataset.data_paths = dataset.data_paths[:200]
    n_total = len(dataset)
    if n_total < 2:
        raise ValueError(f"need at least 2 records, found {n_total} in "
                         f"{dataset.root_path}")
    train_idx, eval_idx = split_dataset(n_total, config.seed)
    for name, idx in (("train_ids.txt", train_idx),
                      ("test_ids.txt", eval_idx)):
        if writes:
            (workdir / name).write_text("\n".join(
                dataset.data_paths[i].split(".")[0] for i in idx))

    sde, sampling_eps = get_sde(config)
    model = init_params(build_model(config, device=device),
                        torch.Generator().manual_seed(int(config.seed)))
    encoder = build_text_encoder(config)
    state = create_train_state(config, model)
    if mesh is not None:
        shard_train_state(state, mesh)
    ckpt = CheckpointManager(workdir, writer=writes)
    trainer = {}
    if ckpt.has_meta() or args.resume:
        try:
            slot = (ckpt.restore_meta(state) if ckpt.has_meta()
                    else ckpt.restore_newest(state))
            trainer = slot["trainer"]
            say(f"resumed {workdir} at step {state.step}", flush=True)
        except FileNotFoundError:
            say(f"no checkpoint in {workdir}; starting from step 0",
                flush=True)
    train_step = make_train_step(config, sde, model, mesh)
    eval_step = make_eval_step(config, sde, model, mesh)
    bs = config.training.batch_size
    max_len = config.data.max_res_num

    resident = resident_table(config, dataset, encoder, device)

    def prepare(batch, from_table=False):
        """This rank's rows of the step's tensors (every row of a one-
        device run); the context from the resident table's rows of the
        batch's records, or the node's batch encoded in f32 and this rank's
        rows kept."""
        rows = shard_batch(mesh, batch)
        arrays = batch_to_device_arrays(rows, config, device=device)
        if from_table:
            idx = resident["inv"][torch.from_numpy(rows["index"]).to(
                device).long()]
            arrays["context"] = resident["table"][idx].float()
            arrays["context_mask"] = resident["mask"][idx]
            return arrays
        emb, emb_mask = encoder.encode(batch["caption"])
        ctx = shard_batch(mesh, {"context": emb, "context_mask": emb_mask})
        for k, v in ctx.items():
            arrays[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
        return arrays

    say(f"model params: {param_count(model) / 1e6:.2f}M  device: "
        f"{device}  records: {n_total} (train {len(train_idx)}, eval "
        f"{len(eval_idx)})  batch: {bs}"
        + ("" if mesh is None else
           f" x {host_count} nodes  mesh: data={mesh.data} "
           f"model={mesh.model}")
        + f"  workdir: {workdir}", flush=True)

    # each node loads its shard of the index space: an epoch of the whole
    # split takes len // (bs x nodes) steps
    steps_per_epoch = max(1, len(train_idx) // (bs * host_count))
    budget = min(args.max_steps or config.training.n_iters,
                 int(config.training.epochs) * steps_per_epoch)
    meta_freq = max(1, int(config.training.snapshot_freq_for_preemption))
    eval_freq = max(1, int(config.training.eval_freq))
    gate = BestGate(config.training.get("best_save_min_interval", 0),
                    trainer.get("saved_best"), last_save=state.step)
    snap_steps = [int(s) for s in config.training.get("snapshot_steps", [])
                  if int(s) >= state.step
                  and not ckpt.snapshot_path(int(s)).exists()]
    stream = train_batches_from(dataset, train_idx, bs, max_len,
                                config.seed, state.step, host_id, host_count)
    table_end = (table_steps_end(state.step, budget,
                                 config.training.get("steps_per_launch", 1))
                 if resident is not None else state.step)
    eval_pass = make_eval_pass(config, dataset, eval_idx, bs, max_len,
                               prepare, eval_step)

    sampler_cache = {}  # the sampler and the model that holds the EMA

    def snapshot_sample(batch, epoch):
        """Sample one batch with the EMA params, conditioned on `batch`
        (its random inpainting masks drawn too), and pickle it. The model
        and the sampler are built at the first call and reused. On a mesh
        each rank samples its rows of the batch with a whole copy of the
        EMA, and rank 0 gathers and pickles them."""
        rows = shard_batch(mesh, batch, per_node=False)
        b = len(rows["caption"])
        if not sampler_cache:
            ema_model = build_model(config, device=device)
            ema_model.requires_grad_(False)
            shape = (b, max_len, max_len, config.data.num_channels)
            sampler_cache["model"] = ema_model
            sampler_cache["fn"] = get_sampling_fn(config, sde, ema_model,
                                                  shape, sampling_eps,
                                                  mesh=mesh)
        sampler_cache["model"].load_state_dict(
            {k: full_tensor(v) for k, v in state.ema.params.items()},
            strict=True)
        gen = row_generator(step_generator(config.seed, state.step, device,
                                           SNAPSHOT_STREAM), mesh, b)
        condition = get_condition_from_batch(config, rows, device=device,
                                             generator=gen)
        emb, emb_mask = encoder.encode(batch["caption"])
        ctx = shard_batch(mesh, {"context": emb, "context_mask": emb_mask},
                          per_node=False)
        sample, _ = sampler_cache["fn"](
            gen, condition=condition,
            context=torch.from_numpy(ctx["context"]).to(device),
            context_mask=torch.from_numpy(ctx["context_mask"]).to(device))
        sample = gather_rows(mesh, sample)
        if not writes:
            return
        sdir = workdir / "samples" / f"epoch_{epoch}"
        sdir.mkdir(parents=True, exist_ok=True)
        with open(sdir / "sample.pkl", "wb") as f:
            pickle.dump(sample.cpu().numpy().transpose(0, 3, 1, 2), f)
        print(f"snapshot sample (EMA) of step {state.step} written to "
              f"{sdir / 'sample.pkl'}", flush=True)

    def slot(extra=None):
        return state_slot(state, config, dict(
            saved_best=dict(gate.saved), **(extra or {})))

    losses, step_seconds, lrs, evals, window = [], [], [], [], []
    log_freq = max(1, int(config.training.log_freq))
    last_meta = last_eval = state.step
    table_steps = 0
    writer = MetricsWriter(workdir / "tb") if writes else _NoWriter()
    try:
        while state.step < budget:
            t0 = time.perf_counter()
            lrs.append(state.optimizer.learning_rate(state.optimizer.count))
            from_table = state.step < table_end
            table_steps += from_table
            batch = prepare(next(stream), from_table)
            loss = float(train_step(state, batch, config.seed + 1))
            step_seconds.append(time.perf_counter() - t0)
            losses.append(loss)
            window.append(loss)
            step, done = state.step, state.step >= budget
            if step % log_freq == 0:
                writer.scalar("training_loss", loss, step)
            if step % log_freq == 0 or done:
                say(f"step {step} loss {loss:.5f} "
                    f"({bs * host_count / step_seconds[-1]:.1f} "
                    f"samples/s)", flush=True)

            if step - last_eval >= eval_freq or done:
                last_eval = step
                avg_train = float(np.mean(window)) if window else math.inf
                window = []
                writer.scalar("avg_training_loss", avg_train, step)
                avg_eval, last_eval_batch = eval_pass(state)
                if math.isfinite(avg_eval):
                    writer.scalar("avg_eval_loss", avg_eval, step)
                evals.append((step, avg_train, avg_eval))
                say(f"step {step}: avg_train {avg_train:.5f} avg_eval "
                    f"{avg_eval:.5f}", flush=True)
                if (config.training.snapshot_sampling
                        and last_eval_batch is not None):
                    snapshot_sample(last_eval_batch, step // steps_per_epoch)
                # one host copy for both kinds; every rank takes part in
                # gathering it, and the averages, and so the gate's
                # decisions, are the same on every rank
                boundary_slot = _once(slot)
                gate.offer("train", avg_train, boundary_slot)
                gate.offer("eval", avg_eval, boundary_slot)
                due = gate.due(step, done)
                # kinds that share one boundary's state share one file
                by_slot = {}
                for kind, (average, s) in due.items():
                    by_slot.setdefault(id(s), (s, []))[1].append(kind)
                for s, kinds in by_slot.values():
                    s["trainer"]["best"] = {k: due[k][0] for k in kinds}
                    ckpt.save_best(s, *kinds)
                    say(f"saved best_{'/best_'.join(kinds)} of step "
                        f"{s['step']}", flush=True)
                for s in [s for s in snap_steps if s <= step]:
                    ckpt.save_snapshot(slot(), s)
                    snap_steps.remove(s)

            # after the boundary's best saves, so that the meta slot's
            # saved_best describes the best files on disk
            if step - last_meta >= meta_freq or done:
                ckpt.save_meta(slot())
                last_meta = step
    finally:
        writer.close()
    eval_loss = evals[-1][2] if evals else eval_pass(state)[0]
    say(f"done at step {state.step}: avg_train "
        f"{np.mean(losses) if losses else float('nan'):.5f} eval (EMA) "
        f"{eval_loss:.5f}; workdir {workdir}", flush=True)
    if args.out:
        ema = {k: full_tensor(v.detach()).cpu()
               for k, v in state.ema.params.items()}
        if writes:
            torch.save(ema, args.out)
            print(f"EMA params written to {args.out}", flush=True)
    return {"losses": losses, "step_seconds": step_seconds, "lrs": lrs,
            "eval_loss": eval_loss, "evals": evals, "state": state,
            "steps": state.step, "records": n_total, "workdir": workdir,
            "out": args.out, "table_steps": table_steps,
            "context_table": None if resident is None else {
                "unique": int(resident["table"].shape[0]),
                "bytes": resident["bytes"]},
            "mesh": None if mesh is None else {
                "data": mesh.data, "model": mesh.model,
                "world": mesh.world, "nodes": host_count}}


if __name__ == "__main__":
    main()
