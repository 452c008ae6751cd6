"""Flash attention: the CUDA kernels `csrc/flash_fwd.cu` (forward) and
`csrc/flash_bwd.cu` (backward) and their plain PyTorch versions.

Counterpart of text2protein_tpu/ops/flash.py (`supports`,
`flash_attention_fwd`, `flash_attention`, `supports_bwd`,
`flash_attention_bwd`). A tensor on the GPU goes to the kernel; a tensor on
the CPU goes to the `*_reference` function, which computes the same function
in plain torch. Each kernel takes float32 or bfloat16 q, k, v (and out, g)
of one dtype, with `lse` float32, and has an entry of each dtype: the
wrappers dispatch by dtype and count the launches of each in `.launches`
(float32) and `.launches_bf16` (bfloat16).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_SOURCE = "flash_fwd.cu"
_FWD_ARGS = (ctypes.c_int, [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
             + [ctypes.c_float, ctypes.c_void_p])
_PLAN_ARGS = (ctypes.c_int, [ctypes.c_int] * 5 + [ctypes.c_void_p])
_FUNCTIONS = {
    "t2p_flash_fwd_f32": _FWD_ARGS,
    "t2p_flash_fwd_bf16": _FWD_ARGS,
    "t2p_flash_fwd_plan": _PLAN_ARGS,
    "t2p_flash_fwd_bf16_plan": _PLAN_ARGS,
}
_BWD_SOURCE = "flash_bwd.cu"
_BWD_ARGS = (ctypes.c_int, [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
             + [ctypes.c_float, ctypes.c_void_p])
_BWD_FUNCTIONS = {
    "t2p_flash_bwd_f32": _BWD_ARGS,
    "t2p_flash_bwd_bf16": _BWD_ARGS,
    "t2p_flash_bwd_plan": _PLAN_ARGS,
    "t2p_flash_bwd_bf16_plan": _PLAN_ARGS,
    "t2p_flash_bwd_f32_scratch": (ctypes.c_longlong, [ctypes.c_int] * 5),
}
# the C entries' suffix by dtype
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
# the ctypes functions, resolved at the first launch
_KERNELS: dict[str, object] = {}


def _kernel(source, functions, name):
    fn = _KERNELS.get(name)
    if fn is None:
        fn = getattr(_build.load(source, functions), name)
        _KERNELS[name] = fn
    return fn


def _call(fn, device, *args):
    """Calls a kernel's C entry with the current stream of the CUDA device
    of index `device` appended, making the device current only where it is
    not; raises on a launch error."""
    # the raw cudaStream_t of the current stream, without building a
    # torch.cuda.Stream object (host time paces the small calls)
    stream = torch._C._cuda_getCurrentRawStream(device)
    if device == torch._C._cuda_getDevice():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: CUDA error "
                           f"{rc}")


def launch_plan(kind, b, h, tq, tk, d, dtype=torch.float32):
    """The kernel's launch plan for a call of this shape, for reports.

    float32: {inner tile, stages, column chunks (the blocks of one row
    tile), blocks, shared bytes, blocks per SM, threads per block, narrow
    (D <= 64), wgmma (1: the TF32 wgmma kernels of D <= 512; 0: the
    mma.sync ones of D > 512 and of the 4x4 mid block's AttnBlock, Tq =
    Tk = 16 at D = 256), D boxes of 32 columns a pipeline step,
    blocks of a cluster, clusters the device holds at once (-1 where no
    cluster)}. bfloat16: {warpgroups (0
    for the backward's mma.sync kernels of D > 512), column chunks (the
    blocks of one row tile, each computing S), pipeline stages, inner tile
    rows, rows a block owns, blocks, shared bytes, blocks per SM, threads
    per block, wgmma (1, TMA-fed wgmma) or mma.sync (0), TMA box columns
    (32 or 64; 0 on mma.sync), blocks of a cluster (2 where the forward's
    D > 512 is split over two blocks, else 1)}. The backward gives the
    same keys for the dq kernel and for the dkdv kernel, prefixed `dq_`
    and `dkdv_`. Needs a GPU."""
    if dtype == torch.float32:
        names, plan = _PLAN_KEYS, "_plan"
    else:
        names, plan = _BF16_PLAN_KEYS, "_bf16_plan"
    if kind == "fwd":
        fn = _kernel(_SOURCE, _FUNCTIONS, "t2p_flash_fwd" + plan)
        keys = list(names)
    else:
        fn = _kernel(_BWD_SOURCE, _BWD_FUNCTIONS, "t2p_flash_bwd" + plan)
        keys = [f"{k}_{n}" for k in ("dq", "dkdv") for n in names]
    out = (ctypes.c_int * 32)()
    if fn(b, h, tq, tk, d, out) != 0:
        raise ValueError(f"no {kind} plan for {(b, h, tq, tk, d)}")
    return dict(zip(keys, out))


_PLAN_KEYS = ("tile", "stages", "chunks", "blocks", "smem", "per_sm",
              "threads", "narrow", "wgmma", "step_boxes", "cluster",
              "max_clusters")
_BF16_PLAN_KEYS = ("warpgroups", "chunks", "stages", "tile", "rows",
                   "blocks", "smem", "per_sm", "threads", "wgmma", "box",
                   "cluster")


_DEFAULT_BQ = 256
_DEFAULT_BK = 512


def _choose_block(t: int, pref: int) -> int:
    if t <= pref:
        return t
    for b in (pref, 256, 128, 64):
        if t % b == 0:
            return b
    return 0


def supports(q, k, v) -> bool:
    """Whether the flash kernel takes these shapes (the JAX package's rule,
    so both packages send the same shapes to the einsum path)."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        return False
    _, _, tq, d = q.shape
    return _supports(tq, k.shape[2], d)


@functools.lru_cache(maxsize=None)
def _supports(tq, tk, d) -> bool:
    """`supports` by (Tq, Tk, D), cached: the wrapper's host time paces the
    small calls."""
    if d % 8 != 0 or d > 1024:
        return False
    if tq < 8 or tk < 8:
        return False
    return (_choose_block(tq, _DEFAULT_BQ) > 0
            and _choose_block(tk, _DEFAULT_BK) > 0)


def flash_attention_fwd_reference(q, k, v, scale=None, kv_mask=None):
    """Plain-torch version of the kernel: the same masking rule (-1e30 bias,
    p *= mask, so a fully masked row gives 0) and the same 1e-30 clamps.
    As in the TPU kernel, the inputs are upcast to f32, all the math is
    f32, and `out` is rounded to q's dtype once at the end.

    q: (B, H, Tq, D); k, v: (B, H, Tk, D); kv_mask: (B, Tk) bool or None.
    Returns out (B, H, Tq, D) in q's dtype and lse (B*H, Tq, 1) float32.
    """
    b, h, tq, d = q.shape
    if scale is None:
        scale = d**-0.5
    qf = q.float() * scale
    s = torch.einsum("bhqd,bhkd->bhqk", qf, k.float())
    if kv_mask is not None:
        mb = kv_mask.to(torch.float32)[:, None, None, :]
        s = s + (mb - 1.0) * 1e30
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=-1e30)
    p = torch.exp(s - m)
    if kv_mask is not None:
        p = p * mb
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    out = out / torch.clamp(l, min=1e-30)
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    return out.to(q.dtype), lse.reshape(b * h, tq, 1)


def _check_inputs(admitted, what, q, k, v, kv_mask, extra=()):
    """The wrapper's checks on CUDA inputs: the shape gate (`admitted`),
    dtypes (q's, float32 or bfloat16, for every D-wide tensor; float32 for
    lse), shapes, contiguity, one device, 16-byte alignment of the D-wide
    tensors (the kernels copy 16 bytes a thread) and a bool mask; `extra`
    adds (name, tensor, shape) triples. Returns the data pointers of q, k,
    v and the extra tensors, then the mask's (None without a mask), then
    the index of the CUDA device."""
    if not q.is_cuda:
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if not admitted:
        raise ValueError(f"flash {what} kernel does not take q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}"
                         f"{' with a mask' if kv_mask is not None else ''}")
    if q.dtype not in _SUFFIX:
        raise TypeError(f"q: expected torch.float32 or torch.bfloat16, got "
                        f"{q.dtype}")
    dev = q.get_device()
    kv_shape = (b, h, tk, d)
    ptrs = []
    for name, t, shape in (("q", q, q.shape), ("k", k, kv_shape),
                           ("v", v, kv_shape), *extra):
        want = torch.float32 if name == "lse" else q.dtype
        if t.dtype != want:
            raise TypeError(f"{name}: expected {want}, got {t.dtype}")
        if t.shape != shape:
            raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
        if t.get_device() != dev:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        ptr = t.data_ptr()
        if ptr % 16 and name != "lse":
            raise ValueError(f"{name}: data must be 16-byte aligned")
        ptrs.append(ptr)
    if kv_mask is None:
        ptrs += [None, dev]
        return ptrs
    if kv_mask.dtype != torch.bool:
        raise TypeError(f"kv_mask: expected torch.bool, got {kv_mask.dtype}")
    if (kv_mask.shape != (b, tk) or not kv_mask.is_contiguous()
            or kv_mask.get_device() != dev):
        raise ValueError(f"kv_mask: expected a contiguous ({b}, {tk}) on "
                         f"{q.device}, got {tuple(kv_mask.shape)} on "
                         f"{kv_mask.device}")
    ptrs += [kv_mask.data_ptr(), dev]
    return ptrs


def flash_attention_fwd(q, k, v, scale=None, kv_mask=None):
    """Forward pass returning (out, lse): the kernel for a CUDA tensor, the
    plain version for a CPU tensor.

    q: (B, H, Tq, D); k, v: (B, H, Tk, D); kv_mask: (B, Tk) bool or None.
    Returns out (B, H, Tq, D) and lse (B*H, Tq, 1) float32.
    """
    if not q.is_cuda and q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, scale, kv_mask)
    qp, kp, vp, mp, dev = _check_inputs(supports(q, k, v), "forward", q, k,
                                        v, kv_mask)
    b, h, tq, d = q.shape
    if scale is None:
        scale = d**-0.5
    out = torch.empty_like(q)
    lse = q.new_empty((b * h, tq, 1), dtype=torch.float32)
    suffix = _SUFFIX[q.dtype]
    _call(_kernel(_SOURCE, _FUNCTIONS, "t2p_flash_fwd_" + suffix), dev,
          qp, kp, vp, mp, out.data_ptr(), lse.data_ptr(), b, h, tq,
          k.shape[2], d, float(scale))
    if suffix == "f32":
        flash_attention_fwd.launches += 1
    else:
        flash_attention_fwd.launches_bf16 += 1
    return out, lse


# kernel launches by dtype, read by chip_smoke.py
flash_attention_fwd.launches = 0
flash_attention_fwd.launches_bf16 = 0


def flash_attention(q, k, v, scale=None, kv_mask=None):
    """q: (B, H, Tq, D); k, v: (B, H, Tk, D); kv_mask: (B, Tk) bool or None."""
    return flash_attention_fwd(q, k, v, scale=scale, kv_mask=kv_mask)[0]


# --------------------------------------------------------------- backward


def supports_bwd(q, k, v) -> bool:
    """Whether the backward kernel takes these shapes: the JAX package's rule
    (its one-shot TPU block must fit a 10 MB budget), so both packages send
    the same shapes to the recompute-and-differentiate fallback."""
    _, _, tq, d = q.shape
    tk = k.shape[2]
    if not supports(q, k, v):
        return False
    if tq % 8 != 0 or tk % 64 != 0:
        return False
    vmem = 4 * (tq * tk + 2 * tq * d + 3 * tk * d + 2 * tq)
    return vmem <= 10 * 1024 * 1024


def flash_attention_bwd_reference(q, k, v, out, lse, g, scale=None,
                                  kv_mask=None):
    """Plain-torch version of the backward kernel, with its masking rule:
    the -1e30 bias is added before the exp and P is not multiplied by the
    mask, so a fully masked row (lse ~ -1e30) has P = 1 on every key.

    q, out, g: (B, H, Tq, D); k, v: (B, H, Tk, D); lse: (B*H, Tq, 1) f32.
    Returns (dq, dk, dv) in the dtypes of q, k, v.
    """
    b, h, tq, d = q.shape
    if scale is None:
        scale = d**-0.5
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    if kv_mask is not None:
        mb = kv_mask.to(torch.float32)[:, None, None, :]
        s = s + (mb - 1.0) * 1e30
    p = torch.exp(s - lse.reshape(b, h, tq, 1))
    delta = torch.sum(gf * out.float(), dim=-1, keepdim=True)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, gf)
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, vf)
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def supports_bwd_cuda(q, k, v, masked) -> bool:
    """Whether the backward kernel takes these shapes on the GPU. A masked
    call: `supports_bwd`, the JAX rule. An unmasked call: every shape that
    `supports` takes. The JAX rule's Tk % 64, Tq % 8 and 10 MB conditions
    are TPU tiling and VMEM limits, and a call without a mask has no fully
    masked row, the only place where the kernel and the einsum fallback
    compute different numbers, so the kernel takes those shapes too."""
    if masked:
        return supports_bwd(q, k, v)
    return supports(q, k, v)


def flash_attention_bwd(q, k, v, out, lse, g, scale=None, kv_mask=None):
    """dQ, dK, dV from the forward's residuals (out, lse) and the output
    gradient g: the kernel for a CUDA tensor (shapes of
    `supports_bwd_cuda`), the plain version for a CPU tensor. Shapes as in
    `flash_attention_bwd_reference`; float32 or bfloat16 on the GPU (lse
    float32), each dtype to its own kernel entry."""
    if not q.is_cuda and q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, out, lse, g, scale,
                                             kv_mask)
    b, h, tq, d = q.shape
    qp, kp, vp, op, gp, lp, mp, dev = _check_inputs(
        supports_bwd_cuda(q, k, v, kv_mask is not None), "backward", q, k,
        v, kv_mask,
        extra=[("out", out, q.shape), ("g", g, q.shape),
               ("lse", lse, (b * h, tq, 1))])
    if scale is None:
        scale = d**-0.5
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    suffix = _SUFFIX[q.dtype]
    # scratch: delta = rowsum(dO * out) in f32, written by the dq kernel and
    # read by dkdv, and (f32) the exchange buffers of the kernels' clusters
    floats = b * h * tq
    if suffix == "f32":
        floats = _bwd_scratch_floats(b, h, tq, k.shape[2], d)
    delta = q.new_empty((floats,), dtype=torch.float32)
    _call(_kernel(_BWD_SOURCE, _BWD_FUNCTIONS, "t2p_flash_bwd_" + suffix),
          dev, qp, kp, vp, gp, op, lp, delta.data_ptr(), mp,
          dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, tq, k.shape[2],
          d, float(scale))
    if suffix == "f32":
        flash_attention_bwd.launches += 1
    else:
        flash_attention_bwd.launches_bf16 += 1
    return dq, dk, dv


@functools.lru_cache(maxsize=None)
def _bwd_scratch_floats(b, h, tq, tk, d):
    """Floats of the f32 backward's scratch for a shape (its C entry's
    count), cached: the wrapper's host time paces the small calls."""
    return _kernel(_BWD_SOURCE, _BWD_FUNCTIONS,
                   "t2p_flash_bwd_f32_scratch")(b, h, tq, tk, d)


# kernel launches by dtype, read by chip_smoke.py
flash_attention_bwd.launches = 0
flash_attention_bwd.launches_bf16 = 0
