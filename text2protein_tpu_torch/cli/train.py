"""Training CLI (counterpart of text2protein_tpu/cli/train.py), one device.

config -> processed records -> 95/5 split -> a loop of train steps (loss
and backward -> clip -> Adam -> EMA) on batches the loader reads ahead,
each caption encoded by the text encoder -> one eval pass with the EMA
params -> the EMA params written as a state dict that
`text2protein_tpu_torch.cli.serve --weights` loads.

Runs on the GPU unless `--device cpu` is given; on the GPU the model runs in
the config's `model.dtype` under `use_full_f32()` (TF32 off for matmuls and
cuDNN, f32 accumulation of bf16 products) with cuDNN's per-shape algorithm
search on. With `data.featurize_on_device` the batches carry backbones and
the step builds the 6D maps on the device. Not ported yet: the checkpoint
triad and resume, snapshot sampling, the resident-context table and fused
multi-step paths, and multi-device meshes.

Usage:
  python -m text2protein_tpu_torch.cli.train [--config cfg.yml]
      [--data DIR] [--max_steps N] [--out ema.pt] [--device cpu]
  e.g. --config configs/quality_n256.yml --data DIR: the N=256 model in
  bf16 with remat and featurization on the device, batch 8
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import resolve_device, use_full_f32
from ..conditioning import batch_to_device_arrays
from ..config import bench_l128_config, load_config
from ..data.dataset import ProteinProcessedDataset
from ..data.loader import PrefetchLoader
from ..diffusion.sde import get_sde
from ..models.unet import build_model, init_random_weights
from ..text.encoder import build_text_encoder
from ..training.state import create_train_state, param_count
from ..training.steps import make_eval_step, make_train_step


def build_argparser():
    p = argparse.ArgumentParser(description="Train the score model")
    p.add_argument("--config", type=str, default=None,
                   help="YAML config (default: configs/bench_l128.yml as "
                        "bench_l128_config() builds it)")
    p.add_argument("--data", type=str, default=None,
                   help="directory of processed .npz records (default: "
                        "data.processed_dataset_path)")
    p.add_argument("--max_steps", type=int, default=None,
                   help="override training.n_iters")
    p.add_argument("--out", type=str, default=None,
                   help="write the EMA params here (torch state dict)")
    p.add_argument("--device", type=str, default=None)
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


def make_eval_pass(config, dataset, eval_idx, bs, max_len, prepare,
                   eval_step):
    """A deterministic eval pass: the eval order and each batch's draws are
    fixed by config.seed, so two passes at the same params give the same
    loss. A split smaller than one batch is filled once by sampling with
    replacement."""
    if len(eval_idx) < bs:
        idx = np.random.RandomState(config.seed + 17).choice(
            eval_idx, size=bs, replace=True)
    else:
        idx = np.asarray(eval_idx)

    def eval_pass(state):
        losses = []
        loader_rng = np.random.RandomState(config.seed + 23)
        for bi, batch in enumerate(batches(dataset, idx, bs, max_len,
                                           loader_rng, shuffle=False)):
            seed = (config.seed + 7919) * 1_000_003 + bi
            losses.append(float(eval_step(state, prepare(batch), seed)))
        return float(np.mean(losses)) if losses else float("inf")

    return eval_pass


def main(argv=None):
    """Train; returns {"losses", "step_seconds", "lrs", "eval_loss", "state",
    "steps", "records", "out"}."""
    args = build_argparser().parse_args(argv)
    config = load_config(args.config) if args.config else bench_l128_config()
    device = resolve_device(args.device)
    if device.type == "cuda":
        use_full_f32()

    dataset = ProteinProcessedDataset(args.data
                                      or config.data.processed_dataset_path)
    n_total = len(dataset)
    if n_total < 2:
        raise ValueError(f"need at least 2 records, found {n_total} in "
                         f"{dataset.root_path}")
    train_idx, eval_idx = split_dataset(n_total, config.seed)

    sde, _ = get_sde(config)
    # random weights from config.seed (the JAX package's flax initializers
    # are not ported)
    model = init_random_weights(build_model(config, device=device),
                                config.seed)
    encoder = build_text_encoder(config)
    state = create_train_state(config, model)
    train_step = make_train_step(config, sde, model)
    eval_step = make_eval_step(config, sde, model)
    bs = config.training.batch_size
    max_len = config.data.max_res_num

    def prepare(batch):
        arrays = batch_to_device_arrays(batch, config, device=device)
        emb, emb_mask = encoder.encode(batch["caption"])
        arrays["context"] = torch.from_numpy(emb).to(device)
        arrays["context_mask"] = torch.from_numpy(emb_mask).to(device)
        return arrays

    print(f"model params: {param_count(model) / 1e6:.2f}M  device: "
          f"{device}  records: {n_total} (train {len(train_idx)}, eval "
          f"{len(eval_idx)})  batch: {bs}", flush=True)

    steps_per_epoch = max(1, len(train_idx) // bs)
    budget = min(args.max_steps or config.training.n_iters,
                 int(config.training.epochs) * steps_per_epoch)
    host_rng = np.random.RandomState(config.seed)

    def train_batches_forever():
        while True:
            yield from batches(dataset, train_idx, bs, max_len, host_rng)

    stream = train_batches_forever()
    losses, step_seconds, lrs = [], [], []
    log_freq = max(1, int(config.training.log_freq))
    while state.step < budget:
        t0 = time.perf_counter()
        lrs.append(state.optimizer.learning_rate(state.optimizer.count))
        loss = float(train_step(state, prepare(next(stream)),
                                config.seed + 1))
        step_seconds.append(time.perf_counter() - t0)
        losses.append(loss)
        if state.step % log_freq == 0 or state.step == budget:
            print(f"step {state.step} loss {loss:.5f} "
                  f"({bs / step_seconds[-1]:.1f} samples/s)", flush=True)

    eval_pass = make_eval_pass(config, dataset, eval_idx, bs, max_len,
                               prepare, eval_step)
    eval_loss = eval_pass(state)
    print(f"done at step {state.step}: avg_train "
          f"{np.mean(losses) if losses else float('nan'):.5f} eval (EMA) "
          f"{eval_loss:.5f}", flush=True)
    if args.out:
        torch.save({k: v.detach().cpu()
                    for k, v in state.ema.params.items()}, args.out)
        print(f"EMA params written to {args.out}", flush=True)
    return {"losses": losses, "step_seconds": step_seconds, "lrs": lrs,
            "eval_loss": eval_loss, "state": state, "steps": state.step,
            "records": n_total, "out": args.out}


if __name__ == "__main__":
    main()
