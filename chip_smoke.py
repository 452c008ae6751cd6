"""Drive the PyTorch/CUDA port (text2protein_tpu_torch) on one GPU.

Phases, each printing a flushed line with the seconds since start:
  1. device: needs CUDA; prints the card and its power limit.
  2. build: compiles every CUDA kernel of the serving path with nvcc.
  3. kernels: holds each kernel to its plain PyTorch version at every shape
     the serving path gives it, and times kernel, plain version and the
     PyTorch library call that computes the same function.
  4. serving: a flagship-width L=128 Server with seeded random weights
     answers requests (different captions and lengths, one seeded) over a
     short PC trajectory; every map must be finite, (5, 128, 128), with the
     length mask as its last channel, and the kernels' launch counts must be
     exactly what the path makes.
  5. reference: one score evaluation on the GPU (kernels) against the same
     model on the CPU (plain versions).

float32 throughout, with TF32 off for matmuls and cuDNN convolutions (both
packages compute the model in full f32). The last line of stdout is
{"ok": true, "device": {...}}; any failure prints its traceback and exits
non-zero. Details go to chiprun_out/chip_smoke.json.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

T0 = time.perf_counter()
STEPS = 20           # PC steps per request batch (the full schedule is 2000)
BATCH = 4            # serving batch size
TOL = 1e-4           # kernel vs plain version, f32, max abs error
E2E_TOL = 1e-4       # GPU vs CPU score, relative max diff
PEAK_BYTES_S = 3.35e12   # H100 SXM HBM3, NVIDIA data sheet
PEAK_F32_S = 67e12       # H100 SXM f32 outside the tensor cores

# (name, H, Tq, Tk, D, masked, launches per PC step): the attention calls of
# the flagship score UNet, 2 evaluations per PC step (corrector, predictor).
PATH_SHAPES = [
    ("attnblock_16x16", 1, 256, 256, 256, False, 10),
    ("self_16x16", 8, 256, 256, 32, False, 10),
    ("cross_16x16", 8, 256, 64, 32, True, 10),
    ("attnblock_mid_4x4", 1, 16, 16, 256, False, 2),
    ("self_mid_4x4", 8, 16, 16, 32, False, 2),
    ("cross_mid_4x4", 8, 16, 64, 32, True, 2),
]
LAUNCHES_PER_STEP = sum(s[-1] for s in PATH_SHAPES)  # 36


def log(msg):
    print(f"[{time.perf_counter() - T0:8.2f}s] {msg}", flush=True)


def cuda_ms(torch, fn, iters=50, warmup=3):
    """Mean milliseconds of fn() on the current stream, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_device(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this script needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | TF32 off for matmul and cuDNN")
    return kind, smi


def phase_build():
    from text2protein_tpu_torch.ops import _build

    sources = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    for src in sources:
        _build.build(src)
        info = _build.BUILD_LOG[src]
        ptxas = [ln.strip() for ln in info["ptxas"].splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"build: {src} in {info['seconds']:.2f}s")
        for ln in ptxas:
            log(f"  ptxas: {ln}")
    return sources


def phase_kernels(torch):
    import torch.nn.functional as F

    from text2protein_tpu_torch.ops import flash

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for name, h, tq, tk, d, masked, per_step in PATH_SHAPES:
        b = BATCH
        q, k, v = (torch.randn((b, h, t, d), device=dev, generator=gen)
                   for t in (tq, tk, tk))
        mask = None
        if masked:
            lengths = torch.tensor([5, 12, 37, tk], device=dev)[:b]
            mask = torch.arange(tk, device=dev)[None, :] < lengths[:, None]
        scale = d**-0.5
        out, lse = flash.flash_attention_fwd(q, k, v, scale, mask)
        torch.cuda.synchronize()
        ref_out, ref_lse = flash.flash_attention_fwd_reference(
            q, k, v, scale, mask)
        err = max((out - ref_out).abs().max().item(),
                  (lse - ref_lse).abs().max().item())
        if not (err <= TOL and torch.isfinite(out).all()):
            raise AssertionError(f"{name}: kernel vs plain max abs error "
                                 f"{err:.3e} > {TOL:.0e}")
        attn_mask = None if mask is None else mask[:, None, None, :]
        kernel_ms = cuda_ms(torch, lambda: flash.flash_attention_fwd(
            q, k, v, scale, mask))
        plain_ms = cuda_ms(torch, lambda: flash.flash_attention_fwd_reference(
            q, k, v, scale, mask))
        library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, scale=scale))
        nbytes = 4 * (2 * q.numel() + k.numel() + v.numel() + b * h * tq
                      + (b * tk if masked else 0))
        flops = 4 * b * h * tq * tk * d
        bytes_ms, ops_ms = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_F32_S * 1e3
        rows.append(dict(
            shape=name, B=b, H=h, Tq=tq, Tk=tk, D=d, masked=masked,
            per_step=per_step, max_abs_err=err, ms=kernel_ms,
            plain_ms=plain_ms, library_ms=library_ms, bytes=nbytes,
            flops=flops, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations"))
        log(f"kernel flash_fwd {name} B={b} H={h} Tq={tq} Tk={tk} D={d} "
            f"mask={masked}: max_abs_err {err:.2e} (tol {TOL:.0e}) "
            f"kernel_ms {kernel_ms:.4f} plain_ms {plain_ms:.4f} "
            f"library_ms(sdpa) {library_ms:.4f} "
            f"bound_ms {max(bytes_ms, ops_ms):.5f}")
    return rows


def phase_serving(torch):
    import numpy as np

    from text2protein_tpu_torch.cli.serve import Server, decode_coords
    from text2protein_tpu_torch.config import flagship_config
    from text2protein_tpu_torch.ops import flash

    t = time.perf_counter()
    server = Server(flagship_config(), batch_size=BATCH, num_steps=STEPS,
                    device="cuda", weight_seed=0)
    n_params = sum(p.numel() for p in server.model.parameters())
    log(f"serving: flagship Server ({n_params} params, batch {BATCH}, "
        f"{STEPS} PC steps) built in {time.perf_counter() - t:.2f}s")
    server.run_batch([{"caption": "warm-up", "length": 64}])
    log("serving: warm-up batch done")

    batches = [
        [{"caption": "A small alpha-helical bundle that binds zinc.",
          "length": 64},
         {"caption": "beta barrel membrane transporter", "length": 100},
         {"caption": "", "length": 128}],
        [{"caption": "Kinase domain with a long activation loop.",
          "length": 77, "seed": 1234}],
    ]
    launches = 0
    seconds = []
    for reqs in batches:
        flash.flash_attention_fwd.launches = 0
        t = time.perf_counter()
        results = server.run_batch(reqs)
        seconds.append(time.perf_counter() - t)
        got = flash.flash_attention_fwd.launches
        launches += got
        if got != LAUNCHES_PER_STEP * STEPS:
            raise AssertionError(f"flash_fwd launched {got} times in a "
                                 f"batch, expected {LAUNCHES_PER_STEP} x "
                                 f"{STEPS}")
        for req, res in zip(reqs, results):
            cnn = decode_coords(res)
            L = req["length"]
            if cnn.shape != (5, 128, 128) or not np.isfinite(cnn).all():
                raise AssertionError(f"bad map {cnn.shape} for {req}")
            want = np.zeros((128, 128), np.float32)
            want[:L, :L] = 1.0
            if not np.array_equal(cnn[-1], want):
                raise AssertionError(f"last channel is not the length mask "
                                     f"for {req}")
            if "seed" in req and res["seed"] != req["seed"]:
                raise AssertionError("the request's seed was not used")
        log(f"serving: batch of {len(reqs)} request(s) in "
            f"{seconds[-1]:.3f}s, flash_fwd launches {got} "
            f"(= {LAUNCHES_PER_STEP} x {STEPS} steps), maps finite "
            f"(5, 128, 128), last channel = length mask, nfe "
            f"{results[0]['nfe']}")
    s_per_step = min(seconds) / STEPS
    log(f"serving: {s_per_step * 1e3:.2f} ms per PC step at batch {BATCH}; "
        f"{BATCH * 60 / (s_per_step * STEPS):.1f} samples/min at {STEPS} "
        f"steps, {BATCH * 60 / (s_per_step * 2000):.3f} samples/min at the "
        f"full 2000 steps")
    return server, launches, seconds


def phase_reference(torch, server):
    import copy

    import numpy as np

    from text2protein_tpu_torch.ops import flash

    model = server.model
    cpu_model = copy.deepcopy(model).to("cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(
        (rng.standard_normal((1, 128, 128, 5)) * 10).astype(np.float32))
    labels = torch.tensor([1000.0])
    ctx_np, mask_np = server.encoder.encode(
        ["A small alpha-helical bundle that binds zinc."])
    ctx, mask = torch.from_numpy(ctx_np), torch.from_numpy(mask_np)
    before = flash.flash_attention_fwd.launches
    with torch.inference_mode():
        gpu = model(x.cuda(), labels.cuda(), ctx.cuda(), mask.cuda()).cpu()
        cpu = cpu_model(x, labels, ctx, mask)
    if flash.flash_attention_fwd.launches - before != 18:
        raise AssertionError("the GPU score evaluation did not launch the "
                             "flash kernel 18 times")
    diff = ((gpu - cpu).abs().max() / cpu.abs().max()).item()
    if not diff < E2E_TOL:
        raise AssertionError(f"GPU score vs CPU score: rel max diff {diff}")
    log(f"reference: flagship score on GPU vs CPU, rel max diff {diff:.2e} "
        f"(tol {E2E_TOL:.0e})")
    return diff


def main():
    import torch

    kind, smi = phase_device(torch)
    sources = phase_build()
    rows = phase_kernels(torch)
    server, launches, seconds = phase_serving(torch)
    e2e = phase_reference(torch, server)

    def per_step(key):
        return sum(r[key] * r["per_step"] for r in rows)

    bytes_ms = sum(r["bytes"] / PEAK_BYTES_S * 1e3 * r["per_step"]
                   for r in rows)
    ops_ms = sum(r["flops"] / PEAK_F32_S * 1e3 * r["per_step"] for r in rows)
    kernels = [{
        "name": "flash_fwd_f32",
        "route": "cuda",
        "source": "text2protein_tpu_torch/ops/csrc/" + sources[0],
        "replaces": "text2protein_tpu/ops/flash.py:50",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        # times: the kernel's share of one PC step at batch BATCH, the sum
        # over the path's shapes of (launches per step x time per launch)
        "ms": per_step("ms"),
        "plain_ms": per_step("plain_ms"),
        "bound_ms": per_step("bound_ms"),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": per_step("library_ms"),
    }]
    out = Path(__file__).resolve().parent / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps({
        "device": kind, "nvidia_smi": smi, "steps": STEPS, "batch": BATCH,
        "shapes": rows, "kernels": kernels, "batch_seconds": seconds,
        "e2e_rel_diff": e2e,
    }, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)
