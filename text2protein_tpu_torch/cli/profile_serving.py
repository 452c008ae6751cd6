"""Where the time of one PC step goes in the PyTorch port, on one GPU.

Builds the flagship Server (seeded random weights, batch 4) and, after a
warm-up batch, profiles one batch of a short PC trajectory with
torch.profiler: device time summed by kernel name, the device's busy share of
the wall time, and the wall time per PC step. A second part times one
3x3 convolution of the flagship's widest level alone under the convolution
settings that decide its algorithm (TF32 off or on, cudnn.benchmark off or
on), to tell the convolution's speed apart from the rest of the step.

Usage: python -m text2protein_tpu_torch.cli.profile_serving [--steps 2]
           [--top 25]
Writes chiprun_out/profile_serving.json at the root of the checkout.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
_PROFILER_ROWS = {"Buffer Flush", "Activity Buffer Request"}


def conv_ms(torch, b, c, hw, iters=20):
    conv = torch.nn.Conv2d(c, c, 3, padding=1).cuda().requires_grad_(False)
    x = torch.randn(b, c, hw, hw, device="cuda")
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
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..config import flagship_config
    from .serve import Server

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {smi}", flush=True)
    result = {"device": smi, "steps": args.steps, "batch": 4}

    # the convolution alone: flagship level 0 (B=4, 128 channels, 128x128)
    flops = 2 * 4 * 128 * 128 * 128 * 128 * 9
    result["conv3x3_b4_c128_128x128"] = {}
    for tf32 in (False, True):
        for bench in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.backends.cudnn.allow_tf32 = tf32
            torch.backends.cudnn.benchmark = bench
            ms = conv_ms(torch, 4, 128, 128)
            key = f"tf32={tf32},benchmark={bench}"
            result["conv3x3_b4_c128_128x128"][key] = {
                "ms": ms, "tflop_s": flops / ms / 1e9}
            print(f"conv3x3 B=4 C=128 128x128 {key}: {ms:.3f} ms, "
                  f"{flops / ms / 1e9:.1f} TFLOP/s", flush=True)

    # the serving step as the port runs it: full f32 (the Server turns
    # cudnn.benchmark on)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    server = Server(flagship_config(), batch_size=4, num_steps=args.steps,
                    device="cuda", weight_seed=0)
    reqs = [{"caption": "A small alpha-helical bundle.", "length": 64}]
    server.run_batch(reqs)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.run_batch(reqs)
        wall = time.perf_counter() - t0
    # device kernels only: the operators' rows repeat their kernels' time,
    # and the profiler's own bookkeeping rows are not work of the device
    kernels = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or e.name in _PROFILER_ROWS:
            continue
        row = kernels.setdefault(e.name, {"name": e.name, "calls": 0,
                                          "device_ms": 0.0})
        row["calls"] += 1
        row["device_ms"] += e.device_time / 1e3
    rows = sorted(kernels.values(), key=lambda r: -r["device_ms"])
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
    (out / "profile_serving.json").write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
