"""Where the time of one training step goes in the PyTorch port, on one GPU.

Builds the bench_l128 model, or the model of `--config` (seeded random
weights), and its train step at the config's training batch size (16 for
bench_l128, 8 for configs/quality_n256.yml), makes one batch on the device
(random maps under length masks, hash-encoded captions, no SS block; the
step draws its inpainting masks where the config conditions on them), runs
warm-up steps and then profiles a few steps with torch.profiler: device
time summed by kernel name and by kind
(convolutions, the flash kernels, optimizer, elementwise and reductions),
the wall time per step without the profiler, and the device's busy share
of it.

Usage: python -m text2protein_tpu_torch.cli.profile_training [--steps 2]
           [--top 25] [--config configs/quality_n256.yml]
Writes chiprun_out/profile_training[_<config name>].json at the root of the
checkout.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

from .profile_serving import REPO, device_kernels

WARMUP = 3  # train steps before the timed ones (the first searches cuDNN)

# kernel-name fragments -> kind, first match wins
_KINDS = [
    ("flash_bwd", "flash backward kernel"),
    ("flash_fwd", "flash forward kernel"),
    ("dgrad", "convolution backward (data)"),
    ("wgrad", "convolution backward (weights)"),
    ("fprop", "convolution forward"),
    ("conv", "convolution (other)"),
    ("fft", "convolution (cuDNN FFT algorithms)"),
    ("cf32", "convolution (cuDNN FFT algorithms)"),
    ("winograd", "convolution (cuDNN Winograd algorithms)"),
    ("gemm", "matmul (Linear, NIN, einsum)"),
    ("multi_tensor", "optimizer (Adam, foreach)"),
    ("reduce", "reductions"),
    ("elementwise", "elementwise"),
]


def kind_of(name: str) -> str:
    low = name.lower()
    for frag, kind in _KINDS:
        if frag in low:
            return kind
    return "other"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--config", type=str, default=None,
                    help="YAML config (default: bench_l128_config())")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .. import use_full_f32
    from ..conditioning import length_mask
    from ..config import bench_l128_config, load_config
    from ..diffusion.sde import get_sde
    from ..models.unet import build_model, init_random_weights
    from ..text.encoder import build_text_encoder
    from ..training.state import create_train_state
    from ..training.steps import make_train_step

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    use_full_f32()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {smi}", flush=True)

    config = load_config(args.config) if args.config else bench_l128_config()
    b = config.training.batch_size
    n, c = config.data.max_res_num, config.data.num_channels
    sde, _ = get_sde(config)
    model = init_random_weights(build_model(config, device="cuda"), 0)
    state = create_train_state(config, model)
    train_step = make_train_step(config, sde, model)
    rng = np.random.default_rng(0)
    lengths = torch.from_numpy(rng.integers(config.data.min_res_num, n + 1,
                                            size=b)).cuda()
    mask_pair = length_mask(lengths, n)
    coords = torch.rand((b, n, n, c), device="cuda") * 2 - 1
    coords[..., -1] = 1.0
    ctx, ctx_mask = build_text_encoder(config).encode(
        [f"a helical bundle of {int(x)} residues" for x in lengths])
    batch = {"coords_6d": coords * mask_pair[..., None],
             "mask_pair": mask_pair,
             "length": lengths.to(torch.int32),
             "ss_spans": torch.full((b, 32, 2), -1, dtype=torch.int32,
                                    device="cuda"),
             "context": torch.from_numpy(ctx).cuda(),
             "context_mask": torch.from_numpy(ctx_mask).cuda()}

    for _ in range(WARMUP):
        float(train_step(state, batch, 1))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        float(train_step(state, batch, 1))
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            float(train_step(state, batch, 1))
        wall = time.perf_counter() - t0
    rows = device_kernels(prof)
    busy = sum(r["device_ms"] for r in rows) / 1e3
    kinds = {}
    for r in rows:
        k = kinds.setdefault(kind_of(r["name"]), {"calls": 0,
                                                  "device_ms": 0.0})
        k["calls"] += r["calls"]
        k["device_ms"] += r["device_ms"]
    kinds = dict(sorted(kinds.items(), key=lambda kv: -kv[1]["device_ms"]))
    result = {
        "device": smi, "batch": b, "steps": args.steps,
        "wall_s_per_step": plain_wall / args.steps,
        "profiled_wall_s_per_step": wall / args.steps,
        "device_busy_s_per_step": busy / args.steps,
        "device_busy_share": busy / plain_wall,
        "by_kind": kinds,
        "top": rows[: args.top],
    }
    print(f"train step (batch {b}): wall {plain_wall / args.steps * 1e3:.1f}"
          f" ms ({wall / args.steps * 1e3:.1f} ms under the profiler), "
          f"device busy {busy / args.steps * 1e3:.1f} ms "
          f"({busy / plain_wall:.1%} of the wall time without the "
          f"profiler)", flush=True)
    for kind, k in kinds.items():
        print(f"  {k['device_ms'] / args.steps:10.3f} ms/step "
              f"{k['calls'] // args.steps:6d} calls/step  {kind}", flush=True)
    for r in rows[: args.top]:
        print(f"  {r['device_ms'] / args.steps:10.3f} ms/step "
              f"{r['calls'] // args.steps:6d} calls/step  {r['name'][:110]}",
              flush=True)
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    suffix = f"_{Path(args.config).stem}" if args.config else ""
    (out / f"profile_training{suffix}.json").write_text(
        json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
