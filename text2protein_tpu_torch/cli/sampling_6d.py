"""6D-map sampling CLI (counterpart of text2protein_tpu/cli/sampling_6d.py).

Restores the EMA weights of a training workdir's checkpoint, takes the
captions of the workdir's held-out ids (`test_ids.txt`, read from the
processed records), runs the config's sampler per batch of captions with an
optional length, PDB-derived or inpainting condition, and pickles one
`sampled_{id}[_{iteration}].pkl` per design, a (1, C, N, N) float32 map,
under `{--workdir_root}/coords_6d/{config stem}/{run}/{tag}`.

Captions cycle to fill one batch when there are fewer than the batch size;
a ragged last batch is skipped. Without held-out captions the designs are
named `design_{i}` with empty captions. Runs on the GPU unless
`--device cpu` is given; the draws come from a torch generator seeded from
`config.seed`.

Usage:
  python -m text2protein_tpu_torch.cli.sampling_6d CONFIG CHECKPOINT
      [--sampler pc|ode|hybrid] [--num_steps N] [--batch_size 32]
      [--select_length --length_index I | --pdb FILE --chain A
       --mask_info 1:5,10:15] [--n_iter 1] [--processed_dir DIR]
      [--tag test] [--device cpu]
  CHECKPOINT: a slot file of a workdir the port's trainer wrote, e.g.
  training/bench_l128/{stamp}/checkpoints/best_eval.pt
"""

from __future__ import annotations

import argparse
import pickle
import time
from pathlib import Path

import torch

from .. import resolve_device, use_full_f32
from ..conditioning import get_conditions_from_pdb, get_mask_all_lengths
from ..config import load_config
from ..data.dataset import load_record
from ..diffusion.sampling import get_sampling_fn
from ..diffusion.sde import get_sde
from ..models.unet import build_model
from ..text.encoder import build_text_encoder
from ..training.checkpoint import restore_ema_params


def build_argparser():
    p = argparse.ArgumentParser(description="Sample 6D geometry maps")
    p.add_argument("config", type=str)
    p.add_argument("checkpoint", type=str)
    p.add_argument("--pdb", type=str, default=None)
    p.add_argument("--chain", type=str, default="A")
    p.add_argument("--mask_info", type=str, default="1:5,10:15")
    p.add_argument("--tag", type=str, default="test")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--n_iter", type=int, default=1)
    p.add_argument("--select_length", action="store_true")
    p.add_argument("--length_index", type=int, default=1)  # 1-based
    p.add_argument("--num_steps", type=int, default=None,
                   help="PC (or ODE) steps instead of the model's num_scales")
    p.add_argument("--sampler", type=str, default=None,
                   choices=["pc", "ode", "hybrid"],
                   help="override sampling.method")
    p.add_argument("--processed_dir", type=str, default=None,
                   help="processed records dir for test-set captions")
    p.add_argument("--workdir_root", type=str, default="sampling",
                   help="the samples go under {root}/coords_6d/...")
    p.add_argument("--device", type=str, default=None)
    return p


def load_test_captions(checkpoint, processed_dir):
    """[(id, caption)] of the training run's held-out ids that have an .npz
    or, failing that, a reference .pt record in `processed_dir` (default:
    the working directory), in the order of `test_ids.txt`
    (text2protein_tpu/cli/sampling_6d.py:43-60)."""
    ids_file = Path(checkpoint).parent.parent / "test_ids.txt"
    if not ids_file.exists():
        return []
    test_ids = [ln.strip() for ln in ids_file.read_text().splitlines()
                if ln.strip()]
    out = []
    for tid in test_ids:
        for ext in (".npz", ".pt"):
            p = Path(processed_dir or ".") / f"{tid}{ext}"
            if p.exists():
                out.append((tid, load_record(p)["caption"]))
                break
    return out


def main(argv=None):
    """Sample; returns {"workdir": the directory the pickles went to,
    "sample_seconds": the wall time of each sampler call, the samples
    copied to the host}."""
    args = build_argparser().parse_args(argv)
    if args.pdb is not None and args.select_length:
        raise ValueError("--pdb and --select_length exclude each other")
    config = load_config(args.config)
    if args.sampler:
        config.sampling.method = args.sampler
    device = resolve_device(args.device)
    if device.type == "cuda":
        use_full_f32()
    ckpt_path = Path(args.checkpoint)
    workdir = Path(args.workdir_root, "coords_6d", Path(args.config).stem,
                   ckpt_path.parent.parent.stem, args.tag)
    workdir.mkdir(parents=True, exist_ok=True)

    b = args.batch_size
    n = config.data.max_res_num
    shape = (b, n, n, config.data.num_channels)
    sde, eps = get_sde(config)
    model = build_model(config, device=device)
    state, step = restore_ema_params(
        ckpt_path.parent.parent, config, model,
        checkpoint=ckpt_path if ckpt_path.exists() else None)
    model.load_state_dict(state, strict=True)
    model.requires_grad_(False)
    print(f"restored step {step} from {ckpt_path}", flush=True)
    encoder = build_text_encoder(config)
    sampling_fn = get_sampling_fn(config, sde, model, shape, eps,
                                  num_steps=args.num_steps)

    captions = load_test_captions(ckpt_path, args.processed_dir)
    if not captions:
        captions = [(f"design_{i}", "") for i in range(b)]
    if len(captions) < b:  # cycle to fill one full batch
        captions = (captions * b)[:b]

    if args.select_length:
        masks = get_mask_all_lengths(config, batch_size=b, device=device)
        condition = {"length": masks[args.length_index - 1]}
    elif args.pdb is not None:
        condition = get_conditions_from_pdb(
            args.pdb, config, args.chain, args.mask_info, batch_size=b,
            device=device)
    else:
        condition = {}

    gen = torch.Generator(device=device).manual_seed(int(config.seed))
    n_batches = max(len(captions) // b, 1)
    sample_seconds = []
    for bi in range(n_batches):
        chunk = captions[bi * b: (bi + 1) * b]
        if len(chunk) != b:
            continue  # a ragged last batch
        emb, emb_mask = encoder.encode([cap for _, cap in chunk])
        for it in range(args.n_iter):
            t0 = time.perf_counter()
            sample, nfe = sampling_fn(
                gen, condition=condition,
                context=torch.from_numpy(emb).to(device),
                context_mask=torch.from_numpy(emb_mask).to(device))
            sample = sample.cpu().numpy().transpose(0, 3, 1, 2)
            sample_seconds.append(time.perf_counter() - t0)
            tag = f"_{it}" if args.n_iter > 1 else ""
            for i, (pid, _) in enumerate(chunk):
                with open(workdir / f"sampled_{pid}{tag}.pkl", "wb") as f:
                    pickle.dump(sample[i: i + 1], f)
        print(f"[{bi + 1}/{n_batches}] saved {b} samples (NFE {int(nfe)})",
              flush=True)
    print(f"samples under {workdir}", flush=True)
    return {"workdir": workdir, "sample_seconds": sample_seconds}


if __name__ == "__main__":
    main()
