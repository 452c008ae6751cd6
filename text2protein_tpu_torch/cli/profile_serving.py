"""Where the time of one PC step goes in the PyTorch port, on one GPU.

Builds a Server (the flagship L=128 model, or `--config`; seeded random
weights, batch 4) and, after a warm-up batch, profiles one batch of a short
PC trajectory with torch.profiler: device time summed by kernel name, the
device's busy share of the wall time, and the wall time per PC step. A
second part times one 3x3 convolution of each level of the UNet alone (the
level's channels and resolution at batch 4, in the model's dtype) under the
convolution settings that decide its algorithm (TF32 off or on,
cudnn.benchmark off or on), to tell the convolution's speed apart from the
rest of the step.

Usage: python -m text2protein_tpu_torch.cli.profile_serving [--steps 2]
           [--top 25] [--config configs/quality_n256.yml]
Writes chiprun_out/profile_serving[_<config name>].json at the root of the
checkout.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
_PROFILER_ROWS = {"Buffer Flush", "Activity Buffer Request"}


def device_kernels(prof):
    """Device time and calls by kernel name, largest first. Device kernels
    only: the operators' rows repeat their kernels' time, and neither the
    profiler's own bookkeeping rows nor the ranges that annotate the device
    track (e.g. `Optimizer.step#Adam.step`) are work of the device."""
    from torch.autograd import DeviceType

    kernels = {}
    for e in prof.events():
        if (e.device_type != DeviceType.CUDA or e.name in _PROFILER_ROWS
                or getattr(e, "is_user_annotation", False)):
            continue
        row = kernels.setdefault(e.name, {"name": e.name, "calls": 0,
                                          "device_ms": 0.0})
        row["calls"] += 1
        row["device_ms"] += e.device_time / 1e3
    return sorted(kernels.values(), key=lambda r: -r["device_ms"])


def conv_ms(torch, b, c, hw, dtype, iters=20):
    conv = torch.nn.Conv2d(c, c, 3, padding=1).cuda().requires_grad_(False)
    conv = conv.to(dtype)
    x = torch.randn(b, c, hw, hw, device="cuda", dtype=dtype)
    with torch.inference_mode():
        for _ in range(3):
            conv(x)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            conv(x)
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / iters


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--config", type=str, default=None,
                    help="YAML config (default: the flagship L=128 model)")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..config import flagship_config, load_config
    from .serve import Server

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {smi}", flush=True)
    config = load_config(args.config) if args.config else flagship_config()
    m = config.model
    dtype = getattr(torch, str(m.get("dtype", "float32")))
    result = {"device": smi, "steps": args.steps, "batch": 4,
              "config": args.config or "flagship", "dtype": str(dtype)}

    # each level's 3x3 convolution alone (B=4, the level's channels and
    # resolution, the model's dtype)
    for level, mult in enumerate(m.ch_mult):
        ch, hw = m.nf * mult, config.data.max_res_num // 2**level
        flops = 2 * 4 * ch * ch * hw * hw * 9
        name = f"conv3x3_b4_c{ch}_{hw}x{hw}_{str(dtype)[6:]}"
        if name in result:
            continue
        result[name] = {}
        for tf32 in (False, True):
            for bench in (False, True):
                torch.backends.cuda.matmul.allow_tf32 = tf32
                torch.backends.cudnn.allow_tf32 = tf32
                torch.backends.cudnn.benchmark = bench
                ms = conv_ms(torch, 4, ch, hw, dtype)
                key = f"tf32={tf32},benchmark={bench}"
                result[name][key] = {"ms": ms, "tflop_s": flops / ms / 1e9}
                print(f"{name} {key}: {ms:.3f} ms, "
                      f"{flops / ms / 1e9:.1f} TFLOP/s", flush=True)

    # the serving step as the port runs it (the Server sets the port's
    # precision policy: f32 without TF32, cudnn.benchmark on)
    server = Server(config, batch_size=4, num_steps=args.steps,
                    device="cuda", weight_seed=0)
    reqs = [{"caption": "A small alpha-helical bundle.", "length": 64}]
    server.run_batch(reqs)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.run_batch(reqs)
        wall = time.perf_counter() - t0
    rows = device_kernels(prof)
    busy = sum(r["device_ms"] for r in rows) / 1e3
    events = prof.key_averages()
    result.update({
        "wall_s_per_step": wall / args.steps,
        "device_busy_s_per_step": busy / args.steps,
        "device_busy_share": busy / wall,
        "top": rows[: args.top],
    })
    print(f"step: wall {wall / args.steps * 1e3:.1f} ms per PC step, device "
          f"busy {busy / args.steps * 1e3:.1f} ms ({busy / wall:.1%})",
          flush=True)
    for r in rows[: args.top]:
        print(f"  {r['device_ms'] / args.steps:10.3f} ms/step "
              f"{r['calls'] // args.steps:6d} calls/step  {r['name'][:110]}",
              flush=True)
    print(events.table(sort_by="self_cpu_time_total", row_limit=15),
          flush=True)
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    suffix = f"_{Path(args.config).stem}" if args.config else ""
    (out / f"profile_serving{suffix}.json").write_text(
        json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
