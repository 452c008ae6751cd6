"""Compare two checkouts' f32 flash-attention kernels on one GPU, in one
process: the C entries `t2p_flash_fwd_f32` and `t2p_flash_bwd_f32` of each
tree's `text2protein_tpu_torch/ops/csrc` are built with nvcc and called on
the same tensors, in turns (base, this tree, this tree, base), at the
L=128 path's shapes and test_config.yml's. Each line gives, per tree, the
median back-to-back ms per call, host microseconds per call and device
microseconds per call (calls replayed from a CUDA graph), the largest
difference between the two trees' results, and SDPA's device time (its
backward: forward and backward less forward, both replayed).

    python3 scripts/flash_f32_ab.py BASE_TREE [--only fwd|bwd] [--out JSON]

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
ENTRIES = {
    "flash_fwd.cu": ("t2p_flash_fwd_f32", 6),
    "flash_bwd.cu": ("t2p_flash_bwd_f32", 11),
}


def build(trees):
    """({(tree, source): ctypes function} of each tree's f32 entries,
    {tree: its backward library}), the four nvcc processes run at once."""
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
        entry, pointers = ENTRIES[src]
        lib = ctypes.CDLL(str(so))
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
        fns[name, src] = fn
        if src == "flash_bwd.cu":
            libs[name] = lib
    return fns, libs


def _bwd_scratch(lib, b, h, tq, tk, d):
    """Floats of a tree's backward scratch: its `t2p_flash_bwd_f32_scratch`
    where it has one, else delta's (B*H, Tq)."""
    fn = getattr(lib, "t2p_flash_bwd_f32_scratch", None)
    if fn is None:
        return b * h * tq
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int] * 5
    return fn(b, h, tq, tk, d)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("base", type=Path, help="the other checkout")
    ap.add_argument("--only", choices=("fwd", "bwd"))
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "flash_ab" / "flash_f32_ab.json")
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    fns, libs = build({"base": args.base.resolve(), "this": ROOT})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"device {torch.cuda.get_device_name(0)} | {smi}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for kind, shapes in (("fwd", FWD), ("bwd", BWD)):
        if args.only and kind != args.only:
            continue
        for b, h, tq, tk, d, masked in shapes:
            q, k, v, g = (torch.randn((b, h, t, d), device=dev, generator=gen)
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
            out, lse = _fwd_residuals(fns, q, k, v, mp, b, h, tq, tk, d,
                                      scale)
            scratch = {n: _bwd_scratch(libs[n], b, h, tq, tk, d)
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
            diff = max((x - y).abs().max().item()
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
            rows.append(dict(kind=kind, shape=[b, h, tq, tk, d, masked],
                             base=med["base"], this=med["this"], runs=times,
                             sdpa_device_us=sdpa_us, max_diff=diff))
            print(f"{kind} {str((b, h, tq, tk, d, masked)):28s} "
                  f"base ms {med['base'][0]:.4f} host_us {med['base'][1]:.1f}"
                  f" device_us {med['base'][2]:.1f} | this ms "
                  f"{med['this'][0]:.4f} host_us {med['this'][1]:.1f} "
                  f"device_us {med['this'][2]:.1f} | sdpa device_us "
                  f"{sdpa_us:.1f} | max diff {diff:.1e}", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "base": str(args.base), "rows": rows}, indent=1))
    return 0


def _fwd_residuals(fns, q, k, v, mp, b, h, tq, tk, d, scale):
    """out and lse of the forward by this tree's kernel."""
    import torch

    out = torch.empty_like(q)
    lse = torch.empty((b * h, tq), device=q.device)
    rc = fns["this", "flash_fwd.cu"](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mp, out.data_ptr(),
        lse.data_ptr(), b, h, tq, tk, d, scale,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"forward: CUDA error {rc}")
    return out, lse


if __name__ == "__main__":
    sys.exit(main())
