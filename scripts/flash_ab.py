"""Compare two checkouts' flash-attention kernels on one GPU, in one
process: the C entries `t2p_flash_fwd_<dtype>` and `t2p_flash_bwd_<dtype>`
of each tree's `text2protein_tpu_torch/ops/csrc` are built with nvcc and
called on the same tensors, in turns (base, this tree, this tree, base).
f32 (the default): at the L=128 path's shapes and test_config.yml's. bf16
(`--dtype bf16`): at the shapes of the bf16 paths of chip_smoke.py, each
group a step of one path (quality_ss_vp's train step at batch 16, whose
shapes quality_text_cfgft's train step shares; quality_text_cfgft's PC step
at batch 4; bench_l128's bf16 PC step at batch 16; N=256's PC step at
batch 4 and train step at batch 8; test_config_large's 8x8 calls, the
forward at batch 1 and the backward at batch 2). Each line gives, per
tree, the median back-to-back ms per call, host microseconds per call and
device microseconds per call (calls replayed from a CUDA graph), the
largest difference between the two trees' results, and SDPA's device time
(its backward: forward and backward less forward, both replayed); with
bf16, each group's sums per step (calls x device time) follow.

    python3 scripts/flash_ab.py BASE_TREE [--dtype f32|bf16]
        [--only fwd|bwd] [--out JSON]

BASE_TREE is another checkout (e.g. `git archive <commit>` unpacked into a
git-ignored directory of this one). The libraries are built under
`build/flash_ab/`, as is the JSON of every measurement (`--out` puts it
elsewhere). Needs a GPU and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# (B, H, Tq, Tk, D, masked): the L=128 path's (serving batch 4, training
# batch 16), then test_config.yml's (sampling batch 4, training batch 2)
FWD = [(4, 1, 256, 256, 256, 0), (4, 8, 256, 256, 32, 0),
       (4, 8, 256, 64, 32, 1), (4, 1, 16, 16, 256, 0), (4, 8, 16, 16, 32, 0),
       (4, 8, 16, 64, 32, 1), (4, 8, 256, 16, 32, 1), (4, 8, 16, 16, 32, 1),
       (4, 1, 1024, 1024, 512, 0), (4, 8, 1024, 1024, 64, 0),
       (4, 8, 1024, 512, 64, 1), (4, 1, 256, 256, 512, 0),
       (4, 8, 256, 256, 64, 0), (4, 8, 256, 512, 64, 1),
       (4, 1, 64, 64, 512, 0), (4, 8, 64, 64, 64, 0), (4, 8, 64, 512, 64, 1)]
BWD = [(16, 1, 256, 256, 256, 0), (16, 8, 256, 256, 32, 0),
       (16, 8, 256, 64, 32, 1), (16, 1, 16, 16, 256, 0),
       (16, 8, 16, 16, 32, 0), (16, 8, 16, 64, 32, 1),
       (2, 1, 1024, 1024, 512, 0), (2, 8, 1024, 1024, 64, 0),
       (2, 8, 1024, 512, 64, 1), (2, 1, 256, 256, 512, 0),
       (2, 8, 256, 256, 64, 0), (2, 8, 256, 512, 64, 1),
       (2, 1, 64, 64, 512, 0), (2, 8, 64, 64, 64, 0), (2, 8, 64, 512, 64, 1)]
ENTRIES = {"flash_fwd.cu": 6, "flash_bwd.cu": 11}  # pointers of each entry


def bf16_groups(cs):
    """{group: (kind, batch, [(H, Tq, Tk, D, masked, calls a step)])} of the
    bf16 paths, from chip_smoke.py's shape lists."""
    def calls(shapes):
        return [(h, tq, tk, d, int(m), c) for _, h, tq, tk, d, m, c in shapes]

    return {
        "ss_vp train step fwd": ("fwd", cs.SS_BATCH,
                                 calls(cs.SS_TRAIN_SHAPES)),
        "ss_vp train step bwd": ("bwd", cs.SS_BATCH, calls(cs.SS_BWD_SHAPES)),
        "text PC step": ("fwd", cs.TEXT_SAMPLING_BATCH,
                         calls(cs.TEXT_PC_SHAPES)),
        "bench_l128 bf16 PC step": ("fwd", cs.BENCH_BF16_BATCH,
                                    calls(cs.BENCH_BF16_SHAPES)),
        "N=256 PC step": ("fwd", cs.N256_BATCH, calls(cs.N256_SHAPES)),
        "N=256 train step fwd": ("fwd", cs.N256_TRAIN_BATCH,
                                 calls(cs.N256_TRAIN_SHAPES)),
        "N=256 train step bwd": ("bwd", cs.N256_TRAIN_BATCH,
                                 calls(cs.N256_BWD_SHAPES)),
        "test_config_large 8x8 fwd": ("fwd", 1,
                                      calls(cs.REF_LARGE_BF16_SHAPES)),
        "test_config_large 8x8 bwd": ("bwd", 2,
                                      calls(cs.REF_LARGE_BF16_SHAPES)),
    }


def build(trees, dtype):
    """({(tree, source): ctypes function} of each tree's entries of
    `dtype`, {tree: its backward library}), the four nvcc processes run at
    once."""
    from text2protein_tpu_torch.ops import _build

    out_dir = ROOT / "build" / "flash_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, root in trees.items():
        for src in ENTRIES:
            so = out_dir / f"{name}_{Path(src).stem}.so"
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                   str(root / "text2protein_tpu_torch/ops/csrc" / src)]
            procs[name, src] = so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    fns, libs = {}, {}
    for (name, src), (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name} {src}:\n{log}")
        pointers = ENTRIES[src]
        lib = ctypes.CDLL(str(so))
        fn = getattr(lib, f"t2p_{Path(src).stem}_{dtype}")
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
        fns[name, src] = fn
        if src == "flash_bwd.cu":
            libs[name] = lib
    return fns, libs


def _bwd_scratch(lib, dtype, b, h, tq, tk, d):
    """Floats of a tree's backward scratch: its `t2p_flash_bwd_f32_scratch`
    for f32 where it has one, else delta's (B*H, Tq)."""
    fn = getattr(lib, "t2p_flash_bwd_f32_scratch", None)
    if fn is None or dtype != "f32":
        return b * h * tq
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int] * 5
    return fn(b, h, tq, tk, d)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("base", type=Path, help="the other checkout")
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="f32")
    ap.add_argument("--only", choices=("fwd", "bwd"))
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    out_json = args.out or (ROOT / "build" / "flash_ab"
                            / f"flash_ab_{args.dtype}.json")

    import torch
    import torch.nn.functional as F

    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    fns, libs = build({"base": args.base.resolve(), "this": ROOT},
                      args.dtype)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"device {torch.cuda.get_device_name(0)} | {smi} | {args.dtype}",
          flush=True)
    # the calls to time: (kind, B, H, Tq, Tk, D, masked), each once
    if args.dtype == "f32":
        groups = {}
        calls = [("fwd", *s) for s in FWD] + [("bwd", *s) for s in BWD]
    else:
        groups = bf16_groups(cs)
        calls = list(dict.fromkeys(
            (kind, b, *s[:5]) for kind, b, shapes in groups.values()
            for s in shapes))
    calls = [c for c in calls if not args.only or c[0] == args.only]
    dtype = torch.float32 if args.dtype == "f32" else torch.bfloat16
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    for kind, b, h, tq, tk, d, masked in calls:
        q, k, v, g = (torch.randn((b, h, t, d), device=dev,
                                  generator=gen).to(dtype)
                      for t in (tq, tk, tk, tq))
        mask = None
        if masked:
            lengths = torch.tensor(([5, 12, 37] + [tk] * b)[:b - 1] + [0],
                                   device=dev).clamp(max=tk)
            mask = (torch.arange(tk, device=dev)[None, :]
                    < lengths[:, None])
        mp = None if mask is None else mask.data_ptr()
        scale = d**-0.5
        # the backward's residuals, the same for both trees, and each
        # tree's scratch (delta and, where its entry asks, more)
        out, lse = _fwd_residuals(fns, q, k, v, mp, b, h, tq, tk, d, scale)
        scratch = {n: _bwd_scratch(libs[n], args.dtype, b, h, tq, tk, d)
                   for n in libs}

        def call(name):
            stream = torch.cuda.current_stream().cuda_stream
            if kind == "fwd":
                res = torch.empty_like(q), torch.empty_like(lse)
                rc = fns[name, "flash_fwd.cu"](
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), mp,
                    res[0].data_ptr(), res[1].data_ptr(), b, h, tq, tk,
                    d, scale, stream)
            else:
                res = (torch.empty_like(q), torch.empty_like(k),
                       torch.empty_like(v))
                delta = torch.empty(scratch[name], device=dev)
                rc = fns[name, "flash_bwd.cu"](
                    q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    g.data_ptr(), out.data_ptr(), lse.data_ptr(),
                    delta.data_ptr(), mp, *(x.data_ptr() for x in res),
                    b, h, tq, tk, d, scale, stream)
            if rc:
                raise RuntimeError(f"{name} {kind}: CUDA error {rc}")
            return res

        results, times = {}, {"base": [], "this": []}
        for name in ("base", "this", "this", "base"):
            results[name] = call(name)
            torch.cuda.synchronize()
            times[name].append((
                cs.cuda_ms(torch, lambda: call(name), iters=100),
                cs.host_us(lambda: call(name), iters=100),
                cs.graph_us(torch, lambda: call(name))))
        diff = max((x.float() - y.float()).abs().max().item()
                   for x, y in zip(results["base"], results["this"]))
        attn_mask = None if mask is None else mask[:, None, None, :]
        if kind == "fwd":
            sdpa_us = cs.graph_us(torch, lambda: (
                F.scaled_dot_product_attention(
                    q, k, v, attn_mask=attn_mask, scale=scale)))
        else:
            xs = [t.detach().requires_grad_() for t in (q, k, v)]

            def sdpa():
                with torch.enable_grad():
                    return F.scaled_dot_product_attention(
                        *xs, attn_mask=attn_mask, scale=scale)

            sdpa_us = (cs.graph_us(torch, lambda: torch.autograd.grad(
                sdpa(), xs, g))
                       - cs.graph_us(torch, lambda: sdpa().detach()))
        med = {n: [statistics.median(t[i] for t in times[n])
                   for i in range(3)] for n in times}
        shape = (b, h, tq, tk, d, masked)
        rows[kind, shape] = dict(kind=kind, shape=list(shape),
                                 base=med["base"], this=med["this"],
                                 runs=times, sdpa_device_us=sdpa_us,
                                 max_diff=diff)
        print(f"{kind} {str(shape):28s} "
              f"base ms {med['base'][0]:.4f} host_us {med['base'][1]:.1f}"
              f" device_us {med['base'][2]:.1f} | this ms "
              f"{med['this'][0]:.4f} host_us {med['this'][1]:.1f} "
              f"device_us {med['this'][2]:.1f} | sdpa device_us "
              f"{sdpa_us:.1f} | max diff {diff:.1e}", flush=True)
    # per step of each bf16 path: the sum of calls x device time, and the
    # host time per call averaged over the step's calls
    sums = {}
    for group, (kind, b, shapes) in groups.items():
        if args.only and kind != args.only:
            continue
        n = sum(s[5] for s in shapes)
        got = [(rows[kind, (b, *s[:5])], s[5]) for s in shapes]
        sums[group] = dict(
            calls=n,
            **{f"{tree}_device_ms": sum(r[tree][2] * c for r, c in got) / 1e3
               for tree in ("base", "this")},
            sdpa_device_ms=sum(r["sdpa_device_us"] * c for r, c in got) / 1e3,
            **{f"{tree}_host_us": sum(r[tree][1] * c for r, c in got) / n
               for tree in ("base", "this")})
        x = sums[group]
        print(f"per {group} ({n} calls): device ms base "
              f"{x['base_device_ms']:.4f} this {x['this_device_ms']:.4f} "
              f"sdpa {x['sdpa_device_ms']:.4f} | host us a call base "
              f"{x['base_host_us']:.1f} this {x['this_host_us']:.1f}",
              flush=True)
    out_json.parent.mkdir(parents=True, exist_ok=True)
    out_json.write_text(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "dtype": args.dtype, "base": str(args.base),
        "rows": list(rows.values()), "steps": sums}, indent=1))
    return 0


def _fwd_residuals(fns, q, k, v, mp, b, h, tq, tk, d, scale):
    """out and lse (f32) of the forward by this tree's kernel."""
    import torch

    out = torch.empty_like(q)
    lse = torch.empty((b * h, tq), device=q.device, dtype=torch.float32)
    rc = fns["this", "flash_fwd.cu"](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mp, out.data_ptr(),
        lse.data_ptr(), b, h, tq, tk, d, scale,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"forward: CUDA error {rc}")
    return out, lse


if __name__ == "__main__":
    sys.exit(main())
