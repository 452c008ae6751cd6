"""Drive the PyTorch/CUDA port (text2protein_tpu_torch) on one GPU.

Phases, each printing a flushed line with the seconds since start:
  1. device: needs CUDA; prints the card and its power limit.
  2. build: compiles every CUDA kernel with nvcc, one process per source,
     all started together, and prints each instantiation's registers,
     stack frame and spills from ptxas; a spill or a stack frame fails.
  3. kernels: holds each kernel to its plain PyTorch version at every shape
     its path gives it (the forward at the serving shapes, the backward at
     the training shapes, with a fully masked row), prints each launch's
     plan (tile, blocks, shared memory, blocks per SM), and times kernel,
     plain version and the PyTorch library call that computes the same
     function, beside two bounds: f32 on the CUDA cores, and 3xTF32 on the
     tensor cores (the kernels' route); also each wrapper's host time per
     call and the kernel's device time alone (calls replayed from a CUDA
     graph).
  4. serving: a flagship-width L=128 Server with seeded random weights
     answers requests (different captions and lengths, one seeded) over a
     short PC trajectory; every map must be finite, (5, 128, 128), with the
     length mask as its last channel, and the kernels' launch counts must be
     exactly what the path makes (36 forward launches per PC step, no
     backward launch).
  5. reference: one score evaluation on the GPU (kernels) against the same
     model on the CPU (plain versions).
  6. training: `cli/train.main` trains the bench_l128 configuration at batch
     16 on records written here (enough that the 12 steps fall in one
     epoch, so the loader reads ahead as on a real dataset), 2 warm-up and
     10 timed steps; losses finite, exactly 18 backward and 18 forward
     launches per step, the weights moved, the EMA apart from them. A Server loads the EMA weights
     it wrote and answers a request.
  7. train reference: one flagship train step at B=1 (dropout 0, injected
     draws) on the GPU against the CPU: loss and every gradient.

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
ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
STEPS = 20           # PC steps per request batch (the full schedule is 2000)
BATCH = 4            # serving batch size
TOL = 1e-4           # forward kernel vs plain version, f32, max abs error
# backward kernel vs plain version: max abs error over 1e-4 of the largest
# |gradient| of the call (or 1e-4 absolute below 1): sums of up to 256 f32
# products in another order, on gradients up to ~100
BWD_TOL = 1e-4
E2E_TOL = 1e-4       # GPU vs CPU score, relative max diff
# GPU vs CPU train step: loss relative diff, and each gradient's max diff
# over its own max |grad| (floored at 1e-3 of the model's largest, as the
# attention key biases have a gradient of 0 in exact arithmetic). f32
# through ~100 layers of backward with the card's convolution, matmul and
# reduction orders: with the attention backward on its plain version the
# card already differs from the CPU by up to 2.5e-3 (GroupNorm scales of
# the 16x16 level; the median gradient 5e-4), hence 5e-3. The kernel's own
# share is held apart, on the card: the same step with the attention
# backward through its plain version, within 1e-3 (cuDNN's backward
# algorithms also sum in a different order from run to run).
TRAIN_LOSS_TOL = 1e-4
TRAIN_GRAD_TOL = 5e-3
TRAIN_KERNEL_TOL = 1e-3
TRAIN_BATCH = 16     # configs/bench_l128.yml training.batch_size
TRAIN_WARMUP = 2     # train steps before the timed ones
TRAIN_TIMED = 10
# the 95/5 split leaves 198 train records: 12 batches of 16, so every step
# of the run is in one epoch and the loader's thread reads ahead (a split of
# one batch would start a new loader, unread, on every step); the 10 eval
# records are filled to one batch
N_RECORDS = 208
PEAK_BYTES_S = 3.35e12   # H100 SXM HBM3, NVIDIA data sheet
PEAK_F32_S = 67e12       # H100 SXM f32 outside the tensor cores
PEAK_TF32_S = 495e12     # H100 SXM TF32 tensor cores, dense

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

# (name, H, Tq, Tk, D, masked, calls per train step) of the flagship
# training step at B=16, one forward and one backward per call (no remat).
# Tk=64 is the hash encoder's caption bucket (text.pad_to_bucket). Every
# backward takes the kernel: the unmasked Tk=16 calls, which the JAX rule
# (`supports_bwd`) sends to the einsum fallback, pass `supports_bwd_cuda`.
TRAIN_SHAPES = [
    ("attnblock_16x16", 1, 256, 256, 256, False, 5),
    ("self_16x16", 8, 256, 256, 32, False, 5),
    ("cross_16x16", 8, 256, 64, 32, True, 5),
    ("attnblock_mid_4x4", 1, 16, 16, 256, False, 1),
    ("self_mid_4x4", 8, 16, 16, 32, False, 1),
    ("cross_mid_4x4", 8, 16, 64, 32, True, 1),
]
FWD_PER_TRAIN_STEP = sum(s[6] for s in TRAIN_SHAPES)  # 18
BWD_PER_TRAIN_STEP = FWD_PER_TRAIN_STEP  # 18


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
    from text2protein_tpu_torch import use_full_f32

    use_full_f32()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | TF32 off for matmul and cuDNN, "
        f"cudnn.benchmark on")
    return kind, smi


def bound(nbytes, flops):
    """(least ms, what bounds it) at the H100's HBM and f32 rates."""
    bytes_ms, ops_ms = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_F32_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def tc_bound(nbytes, flops):
    """Least ms of the kernels' route: 3xTF32 does three TF32 products per
    f32 product on the tensor cores."""
    return max(nbytes / PEAK_BYTES_S, 3 * flops / PEAK_TF32_S) * 1e3


def host_us(fn, iters=50):
    """Microseconds of host time per call of fn(), the device not waited
    for (the wrapper's checks, allocations and launch)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t) / iters * 1e6
    torch.cuda.synchronize()
    return us


def graph_us(torch, fn, calls=20, replays=5):
    """Microseconds of device time per call of fn(): `calls` calls captured
    in one CUDA graph and replayed, so the host's time per call (which
    paces back-to-back calls of the small shapes) drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * calls) * 1e3


def ptxas_functions(log_text):
    """{kernel instantiation: {registers, stack, spill_stores,
    spill_loads}} from `nvcc -Xptxas -v` output."""
    import re

    out, name = {}, None
    for ln in log_text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", ln)
        if m:
            mangled = m.group(1)
            k = re.search(r"(flash_[a-z_]*kernel)I((?:Li\d+E)+)", mangled)
            name = (k.group(1) + "<" + ",".join(
                re.findall(r"Li(\d+)E", k.group(2))) + ">") if k else mangled
            out.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from text2protein_tpu_torch.ops import _build

    sources = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    # one nvcc process per source, all at once
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_build.build, sources))
    ptxas = {}
    for src in sources:
        info = _build.BUILD_LOG[src]
        log(f"build: {src} in {info['seconds']:.2f}s")
        for fn, r in ptxas_functions(info["ptxas"]).items():
            ptxas[fn] = r
            log(f"  ptxas: {fn}: {r.get('registers')} registers, "
                f"{r.get('stack')} bytes stack frame, "
                f"{r.get('spill_stores')}/{r.get('spill_loads')} bytes spill "
                f"stores/loads")
    bad = [fn for fn, r in ptxas.items()
           if r.get("stack") or r.get("spill_stores") or r.get("spill_loads")]
    if not ptxas or bad:
        raise AssertionError(f"ptxas: a stack frame or spills in {bad}"
                             if bad else "ptxas reported no kernel")
    return ptxas


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
        host = host_us(lambda: flash.flash_attention_fwd(q, k, v, scale,
                                                         mask))
        device = graph_us(torch, lambda: flash.flash_attention_fwd(
            q, k, v, scale, mask))
        plain_ms = cuda_ms(torch, lambda: flash.flash_attention_fwd_reference(
            q, k, v, scale, mask))
        library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, scale=scale))
        nbytes = (4 * (2 * q.numel() + k.numel() + v.numel() + b * h * tq)
                  + (b * tk if masked else 0))
        flops = 4 * b * h * tq * tk * d
        bound_ms, bound_by = bound(nbytes, flops)
        plan = flash.launch_plan("fwd", b, h, tq, tk, d)
        rows.append(dict(
            shape=name, B=b, H=h, Tq=tq, Tk=tk, D=d, masked=masked,
            per_step=per_step, max_abs_err=err, ms=kernel_ms,
            host_us=host, device_ms=device / 1e3, plain_ms=plain_ms,
            library_ms=library_ms,
            bytes=nbytes, flops=flops, bound_ms=bound_ms, bound_by=bound_by,
            tc_bound_ms=tc_bound(nbytes, flops), plan=plan))
        log(f"kernel flash_fwd {name} B={b} H={h} Tq={tq} Tk={tk} D={d} "
            f"mask={masked}: max_abs_err {err:.2e} (tol {TOL:.0e}) "
            f"kernel_ms {kernel_ms:.4f} host_us {host:.1f} device_us "
            f"{device:.1f} plain_ms {plain_ms:.4f} library_ms(sdpa) "
            f"{library_ms:.4f} bound_ms "
            f"{bound_ms:.5f} (f32) {tc_bound(nbytes, flops):.5f} (3xTF32) "
            f"plan {plan}")
    return rows


def phase_kernels_bwd(torch):
    """The backward at the training shapes, B=16: the kernel against its
    plain version on the same residuals (from the forward kernel), with the
    serving masks plus one fully masked row."""
    import torch.nn.functional as F

    from text2protein_tpu_torch.ops import flash

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    b = TRAIN_BATCH
    rows = []
    for name, h, tq, tk, d, masked, per_step in TRAIN_SHAPES:
        q, k, v, g = (torch.randn((b, h, t, d), device=dev, generator=gen)
                      for t in (tq, tk, tk, tq))
        mask = None
        if masked:
            lengths = torch.tensor([5, 12, 37] + [tk] * (b - 4) + [0],
                                   device=dev)
            mask = torch.arange(tk, device=dev)[None, :] < lengths[:, None]
        scale = d**-0.5
        out, lse = flash.flash_attention_fwd(q, k, v, scale, mask)
        if not flash.supports_bwd_cuda(q, k, v, masked):
            raise AssertionError(f"{name}: the backward gate refuses it")
        got = flash.flash_attention_bwd(q, k, v, out, lse, g, scale, mask)
        torch.cuda.synchronize()
        want = flash.flash_attention_bwd_reference(q, k, v, out, lse, g,
                                                   scale, mask)
        err = max((x - w).abs().max().item() for x, w in zip(got, want))
        ref_scale = max(w.abs().max().item() for w in want)
        finite = all(torch.isfinite(x).all() for x in got)
        if not (finite and err <= BWD_TOL * max(1.0, ref_scale)):
            raise AssertionError(
                f"{name}: backward kernel vs plain max abs error "
                f"{err:.3e} > {BWD_TOL:.0e} x {max(1.0, ref_scale):.3g}")
        kernel_ms = cuda_ms(torch, lambda: flash.flash_attention_bwd(
            q, k, v, out, lse, g, scale, mask))
        host = host_us(lambda: flash.flash_attention_bwd(
            q, k, v, out, lse, g, scale, mask))
        device = graph_us(torch, lambda: flash.flash_attention_bwd(
            q, k, v, out, lse, g, scale, mask))
        plain_ms = cuda_ms(torch, lambda: flash.flash_attention_bwd_reference(
            q, k, v, out, lse, g, scale, mask))
        # the library's backward: autograd of SDPA, fwd+bwd minus fwd
        xs = [t.detach().requires_grad_() for t in (q, k, v)]
        attn_mask = None if mask is None else mask[:, None, None, :]

        def sdpa():
            with torch.enable_grad():
                return F.scaled_dot_product_attention(
                    *xs, attn_mask=attn_mask, scale=scale)

        sdpa_fwd = cuda_ms(torch, sdpa)
        sdpa_both = cuda_ms(torch, lambda: torch.autograd.grad(sdpa(), xs, g))
        library_ms = sdpa_both - sdpa_fwd
        # bytes: q, k, v, out, dO, lse (and mask) read once, dq, dk, dv
        # written once; FLOPs: 10 B H Tq Tk D (the JAX cost estimate)
        nbytes = (4 * (2 * (q.numel() + k.numel() + v.numel()) + out.numel()
                       + g.numel() + b * h * tq) + (b * tk if masked else 0))
        flops = 10 * b * h * tq * tk * d
        bound_ms, bound_by = bound(nbytes, flops)
        plan = flash.launch_plan("bwd", b, h, tq, tk, d)
        rows.append(dict(
            shape=name, B=b, H=h, Tq=tq, Tk=tk, D=d, masked=masked,
            dead_row=masked, per_step=per_step, max_abs_err=err,
            grad_scale=ref_scale, ms=kernel_ms, host_us=host,
            device_ms=device / 1e3,
            plain_ms=plain_ms, library_ms=library_ms, bytes=nbytes,
            flops=flops, bound_ms=bound_ms, bound_by=bound_by,
            tc_bound_ms=tc_bound(nbytes, flops), plan=plan))
        log(f"kernel flash_bwd {name} B={b} H={h} Tq={tq} Tk={tk} D={d} "
            f"mask={masked}{' +dead row' if masked else ''}: max_abs_err "
            f"{err:.2e} (tol {BWD_TOL:.0e} x {max(1.0, ref_scale):.3g}) "
            f"ms {kernel_ms:.4f} host_us {host:.1f} device_us {device:.1f} "
            f"plain_ms "
            f"{plain_ms:.4f} library_ms(sdpa bwd) {library_ms:.4f} bound_ms "
            f"{bound_ms:.5f} (f32) {tc_bound(nbytes, flops):.5f} (3xTF32) "
            f"plan {plan}")
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
        flash.flash_attention_bwd.launches = 0
        t = time.perf_counter()
        results = server.run_batch(reqs)
        seconds.append(time.perf_counter() - t)
        got = flash.flash_attention_fwd.launches
        launches += got
        if got != LAUNCHES_PER_STEP * STEPS:
            raise AssertionError(f"flash_fwd launched {got} times in a "
                                 f"batch, expected {LAUNCHES_PER_STEP} x "
                                 f"{STEPS}")
        if flash.flash_attention_bwd.launches:
            raise AssertionError("serving launched the backward kernel")
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


def phase_training(torch, records, weights):
    """cli/train.main at bench_l128_config(), batch 16, from seeded random
    weights; then a Server answers one request from the EMA weights it
    wrote."""
    import numpy as np

    from text2protein_tpu_torch.cli import train
    from text2protein_tpu_torch.cli.serve import Server, decode_coords
    from text2protein_tpu_torch.config import bench_l128_config
    from text2protein_tpu_torch.data.helix_records import CAPTIONS
    from text2protein_tpu_torch.models.unet import (
        build_model,
        init_random_weights,
    )
    from text2protein_tpu_torch.ops import flash

    steps = TRAIN_WARMUP + TRAIN_TIMED
    torch.cuda.reset_peak_memory_stats()
    flash.flash_attention_fwd.launches = 0
    flash.flash_attention_bwd.launches = 0
    res = train.main(["--data", str(records), "--max_steps", str(steps),
                      "--out", str(weights)])
    fwd = flash.flash_attention_fwd.launches
    bwd = flash.flash_attention_bwd.launches
    peak = torch.cuda.max_memory_allocated()
    losses, secs, state = res["losses"], res["step_seconds"], res["state"]
    eval_loss = res["eval_loss"]
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"train losses {losses}")
    if not np.isfinite(eval_loss):
        raise AssertionError(f"eval loss {eval_loss}")
    if bwd != BWD_PER_TRAIN_STEP * steps:
        raise AssertionError(f"flash_bwd launched {bwd} times, expected "
                             f"{BWD_PER_TRAIN_STEP} x {steps}")
    # 18 per train step and 18 per eval batch (the eval split is filled to
    # one batch)
    if fwd != FWD_PER_TRAIN_STEP * (steps + 1):
        raise AssertionError(f"flash_fwd launched {fwd} times, expected "
                             f"{FWD_PER_TRAIN_STEP} x ({steps} + 1)")
    lrs = res["lrs"]
    if lrs[0] != 0.0 or not lrs[1] > 0.0:
        raise AssertionError(f"learning rates {lrs[:3]}: the first update "
                             "must run at lr 0")
    config = bench_l128_config()
    if config.training.batch_size != TRAIN_BATCH:
        raise AssertionError("bench_l128_config() trains at batch "
                             f"{config.training.batch_size}")
    start = init_random_weights(build_model(config, device="cpu"),
                                config.seed)
    start = dict(start.named_parameters())
    params = {k: p.detach().cpu() for k, p in state.model.named_parameters()}
    moved = sum(not torch.equal(params[k], start[k]) for k in params)
    ema_apart = sum(not torch.equal(params[k], state.ema.params[k].cpu())
                    for k in params)
    if moved < len(params) // 2 or ema_apart < len(params) // 2:
        raise AssertionError(f"{moved} of {len(params)} params moved, "
                             f"{ema_apart} EMA params differ from them")
    timed = np.asarray(secs[TRAIN_WARMUP:]) * 1e3
    ms = float(np.median(timed))
    log(f"training: bench_l128 at batch {TRAIN_BATCH}, {steps} steps on "
        f"{res['records']} records: losses {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} (all finite), eval (EMA) {eval_loss:.4f}; "
        f"flash_bwd launches {bwd} (= {BWD_PER_TRAIN_STEP} x {steps}), "
        f"flash_fwd {fwd} (= {FWD_PER_TRAIN_STEP} x ({steps} + 1 eval)); "
        f"lr {lrs[0]} then {lrs[1]:.1e}; {moved}/{len(params)} "
        f"params moved, {ema_apart} EMA params apart from them")
    log(f"training: {ms:.2f} ms per train step (median of the last "
        f"{TRAIN_TIMED}, range {timed.min():.2f}-{timed.max():.2f}; first "
        f"{TRAIN_WARMUP}: "
        f"{', '.join(f'{x * 1e3:.1f}' for x in secs[:TRAIN_WARMUP])} ms), "
        f"{TRAIN_BATCH / ms * 1e3:.1f} samples/s, max_memory_allocated "
        f"{peak / 2**30:.2f} GiB")
    del state, res

    server = Server(bench_l128_config(), batch_size=1, num_steps=STEPS,
                    weights=str(weights), device="cuda")
    flash.flash_attention_fwd.launches = 0
    reply = server.run_batch([{"caption": CAPTIONS[0], "length": 90}])
    cnn = decode_coords(reply[0])
    served = flash.flash_attention_fwd.launches
    if cnn.shape != (5, 128, 128) or not np.isfinite(cnn).all():
        raise AssertionError(f"bad map {cnn.shape} from the trained weights")
    if served != LAUNCHES_PER_STEP * STEPS:
        raise AssertionError(f"serving the trained weights launched "
                             f"flash_fwd {served} times")
    log(f"training: a Server loaded the EMA weights it wrote (strict) and "
        f"answered a request: finite (5, 128, 128) map, flash_fwd launches "
        f"{served}")
    weights.unlink()
    return dict(steps=steps, losses=losses, step_seconds=secs,
                ms_per_step=ms, ms_per_step_range=[float(timed.min()),
                                                   float(timed.max())],
                samples_per_s=TRAIN_BATCH / ms * 1e3,
                eval_loss=eval_loss, peak_bytes=peak, lrs=lrs[:3],
                fwd_launches=fwd, bwd_launches=bwd)


def worst_grad_diff(got, want):
    """(max over tensors of max|got - want| / max|want|, its name), each
    scale floored at 1e-3 of the largest gradient of `want`."""
    floor = 1e-3 * max(g.abs().max().item() for g in want.values())
    worst, key = 0.0, None
    for k, w in want.items():
        if not bool(got[k].isfinite().all()):
            raise AssertionError(f"non-finite gradient {k}")
        d = ((got[k] - w).abs().max() / max(w.abs().max().item(),
                                            floor)).item()
        if d >= worst:
            worst, key = d, k
    return worst, key


def phase_train_reference(torch, records):
    """One flagship train step at B=1, dropout 0 and injected t, z, from the
    same weights: on the GPU (kernels) against the CPU (plain versions),
    and on the GPU against itself with the attention backward through its
    plain version: the loss and every gradient."""
    import copy

    import numpy as np

    from text2protein_tpu_torch.conditioning import batch_to_device_arrays
    from text2protein_tpu_torch.config import bench_l128_config
    from text2protein_tpu_torch.data.dataset import (
        ProteinProcessedDataset,
        make_batch,
    )
    from text2protein_tpu_torch.diffusion.losses import get_sde_loss_fn
    from text2protein_tpu_torch.diffusion.sde import get_sde
    from text2protein_tpu_torch.models.unet import (
        build_model,
        init_random_weights,
    )
    from text2protein_tpu_torch.ops import flash
    from text2protein_tpu_torch.text.encoder import build_text_encoder

    config = bench_l128_config()
    config.model.dropout = 0.0
    sde, _ = get_sde(config)
    gpu_model = init_random_weights(build_model(config, device="cuda"), 1)
    cpu_model = copy.deepcopy(gpu_model).to("cpu")
    rec = ProteinProcessedDataset(records)[3]
    host = make_batch([rec], config.data.max_res_num)
    ctx, ctx_mask = build_text_encoder(config).encode(host["caption"])
    rng = np.random.default_rng(2)
    t = torch.from_numpy(rng.uniform(0.05, 1.0, 1).astype(np.float32))
    z = torch.from_numpy(rng.standard_normal((1, 128, 128, 5))
                         .astype(np.float32))
    kernel_bwd = flash.flash_attention_bwd

    def step(model, dev):
        batch = batch_to_device_arrays(host, config, device=dev)
        batch["context"] = torch.from_numpy(ctx).to(dev)
        batch["context_mask"] = torch.from_numpy(ctx_mask).to(dev)
        loss_fn = get_sde_loss_fn(sde, model, train=True,
                                  condition=tuple(config.model.condition))
        model.zero_grad(set_to_none=True)
        before = kernel_bwd.launches
        loss = loss_fn(None, batch, t=t.to(dev), z=z.to(dev))
        loss.backward()
        launched = kernel_bwd.launches - before
        return loss.item(), {k: p.grad.detach().cpu() for k, p in
                             model.named_parameters()}, launched

    g_loss, g_grads, g_launch = step(gpu_model, "cuda")
    flash.flash_attention_bwd = flash.flash_attention_bwd_reference
    try:
        _, p_grads, _ = step(gpu_model, "cuda")
    finally:
        flash.flash_attention_bwd = kernel_bwd
    c_loss, c_grads, c_launch = step(cpu_model, "cpu")
    if g_launch != BWD_PER_TRAIN_STEP or c_launch != 0:
        raise AssertionError(f"backward launches GPU {g_launch}, CPU "
                             f"{c_launch}; expected {BWD_PER_TRAIN_STEP}, 0")
    loss_diff = abs(g_loss - c_loss) / abs(c_loss)
    worst, worst_key = worst_grad_diff(g_grads, c_grads)
    plain_worst, plain_key = worst_grad_diff(p_grads, c_grads)
    kernel_worst, kernel_key = worst_grad_diff(g_grads, p_grads)
    log(f"train reference: flagship train step at B=1, GPU (kernels) vs "
        f"CPU: loss {g_loss:.6f} vs {c_loss:.6f} (rel {loss_diff:.2e}, tol "
        f"{TRAIN_LOSS_TOL:.0e}); worst of {len(c_grads)} gradients "
        f"{worst_key} {worst:.2e} (tol {TRAIN_GRAD_TOL:.0e}; with the "
        f"attention backward on its plain version {plain_worst:.2e} at "
        f"{plain_key}); GPU kernels vs GPU plain attention backward: worst "
        f"{kernel_key} {kernel_worst:.2e} (tol {TRAIN_KERNEL_TOL:.0e}); GPU "
        f"backward launches {g_launch}")
    if not (loss_diff < TRAIN_LOSS_TOL and worst < TRAIN_GRAD_TOL
            and kernel_worst < TRAIN_KERNEL_TOL):
        raise AssertionError("the GPU train step disagrees (line above)")
    return dict(loss_gpu=g_loss, loss_cpu=c_loss, loss_rel_diff=loss_diff,
                worst_grad=worst_key, worst_grad_rel_diff=worst,
                plain_bwd_worst_grad_rel_diff=plain_worst,
                kernel_vs_plain_bwd_worst=kernel_worst,
                kernel_vs_plain_bwd_worst_grad=kernel_key)


def main():
    import torch

    from text2protein_tpu_torch.data import helix_records

    kind, smi = phase_device(torch)
    ptxas = phase_build()
    rows = phase_kernels(torch)
    bwd_rows = phase_kernels_bwd(torch)
    server, launches, seconds = phase_serving(torch)
    e2e = phase_reference(torch, server)
    del server
    records = OUT / "train_records"
    helix_records.write_records(records, N_RECORDS)
    weights = ROOT / "build" / "t2p_torch" / "chip_smoke_ema.pt"
    weights.parent.mkdir(parents=True, exist_ok=True)
    training = phase_training(torch, records, weights)
    train_ref = phase_train_reference(torch, records)

    def per_step(rs, key):
        return sum(r[key] * r["per_step"] for r in rs)

    def bound_by(rs):
        bytes_ms = sum(r["bytes"] / PEAK_BYTES_S * r["per_step"] for r in rs)
        ops_ms = sum(r["flops"] / PEAK_F32_S * r["per_step"] for r in rs)
        return "bytes" if bytes_ms >= ops_ms else "operations"

    def kernel(name, source, replaces, launches, rs, what):
        return {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            # times: the kernel's share of one step (`what`), the sum over
            # the path's shapes of (launches per step x time)
            "ms": per_step(rs, "ms"),
            "plain_ms": per_step(rs, "plain_ms"),
            "bound_ms": per_step(rs, "bound_ms"),
            "bound_by": bound_by(rs),
            "library_ms": per_step(rs, "library_ms"),
            # the bound of the kernels' route, 3xTF32 on the tensor cores
            "tc_bound_ms": per_step(rs, "tc_bound_ms"),
            # the kernels' device time alone (CUDA graph replay): `ms`
            # less what the wrapper's host time adds to back-to-back calls
            "device_ms": per_step(rs, "device_ms"),
            "per": what,
        }

    kernels = [
        # launches on the main paths: serving, then training (+ its eval)
        kernel("flash_fwd_f32", "text2protein_tpu_torch/ops/csrc/flash_fwd.cu",
               "text2protein_tpu/ops/flash.py:50",
               launches + training["fwd_launches"], rows,
               f"PC step at batch {BATCH}"),
        kernel("flash_bwd_f32", "text2protein_tpu_torch/ops/csrc/flash_bwd.cu",
               "text2protein_tpu/ops/flash.py:168",
               training["bwd_launches"], bwd_rows,
               f"train step at batch {TRAIN_BATCH}"),
    ]
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps({
        "device": kind, "nvidia_smi": smi, "steps": STEPS, "batch": BATCH,
        "shapes": rows, "bwd_shapes": bwd_rows, "kernels": kernels,
        "ptxas": ptxas,
        "batch_seconds": seconds, "e2e_rel_diff": e2e,
        "training": training, "train_reference": train_ref,
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
