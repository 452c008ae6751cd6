"""Flash attention: the CUDA kernels `csrc/flash_fwd.cu` (forward) and
`csrc/flash_bwd.cu` (backward) and their plain PyTorch versions.

Counterpart of text2protein_tpu/ops/flash.py (`supports`,
`flash_attention_fwd`, `flash_attention`, `supports_bwd`,
`flash_attention_bwd`). A tensor on the GPU goes to the kernel; a tensor on
the CPU goes to the `*_reference` function, which computes the same function
in plain torch. Each wrapper counts its kernel launches in `.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_SOURCE = "flash_fwd.cu"
_FUNCTIONS = {
    "t2p_flash_fwd_f32": (
        ctypes.c_int,
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_void_p],
    ),
}
_BWD_SOURCE = "flash_bwd.cu"
_BWD_FUNCTIONS = {
    "t2p_flash_bwd_f32": (
        ctypes.c_int,
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_void_p],
    ),
}

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
    tk = k.shape[2]
    if d % 8 != 0 or d > 1024:
        return False
    if tq < 8 or tk < 8:
        return False
    return (_choose_block(tq, _DEFAULT_BQ) > 0
            and _choose_block(tk, _DEFAULT_BK) > 0)


def flash_attention_fwd_reference(q, k, v, scale=None, kv_mask=None):
    """Plain-torch version of the kernel: the same masking rule (-1e30 bias,
    p *= mask, so a fully masked row gives 0) and the same 1e-30 clamps.

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


def _check(name, t, shape, dtype=torch.float32):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_inputs(gate, what, q, k, v, kv_mask, extra=()):
    """The wrapper's checks on CUDA inputs: the shape gate, f32, shapes,
    contiguity and one device; `extra` adds (name, tensor, shape) triples.
    Returns the mask as contiguous float32 (1 = attend) or None."""
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if not gate(q, k, v):
        raise ValueError(f"flash {what} kernel does not take q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    for name, t, shape in [("q", q, (b, h, tq, d)), ("k", k, (b, h, tk, d)),
                           ("v", v, (b, h, tk, d)), *extra]:
        _check(name, t, shape)
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if kv_mask is None:
        return None
    if tuple(kv_mask.shape) != (b, tk) or kv_mask.device != q.device:
        raise ValueError(f"kv_mask: expected ({b}, {tk}) on {q.device}, "
                         f"got {tuple(kv_mask.shape)} on {kv_mask.device}")
    return kv_mask.to(torch.float32).contiguous()


def flash_attention_fwd(q, k, v, scale=None, kv_mask=None):
    """Forward pass returning (out, lse): the kernel for a CUDA tensor, the
    plain version for a CPU tensor.

    q: (B, H, Tq, D); k, v: (B, H, Tk, D); kv_mask: (B, Tk) bool or None.
    Returns out (B, H, Tq, D) and lse (B*H, Tq, 1) float32.
    """
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, scale, kv_mask)
    maskf = _check_inputs(supports, "forward", q, k, v, kv_mask)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if scale is None:
        scale = d**-0.5
    out = torch.empty_like(q)
    lse = torch.empty((b * h, tq, 1), dtype=torch.float32, device=q.device)
    lib = _build.load(_SOURCE, _FUNCTIONS)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = lib.t2p_flash_fwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if maskf is None else maskf.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, h, tq, tk, d, float(scale),
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {rc}")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0  # kernel launches, read by chip_smoke.py


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


def flash_attention_bwd(q, k, v, out, lse, g, scale=None, kv_mask=None):
    """dQ, dK, dV from the forward's residuals (out, lse) and the output
    gradient g: the kernel for a CUDA tensor, the plain version for a CPU
    tensor. Shapes as in `flash_attention_bwd_reference`; float32 only on
    the GPU."""
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, out, lse, g, scale,
                                             kv_mask)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    maskf = _check_inputs(
        supports_bwd, "backward", q, k, v, kv_mask,
        extra=[("out", out, q.shape), ("g", g, q.shape),
               ("lse", lse, (b * h, tq, 1))])
    if scale is None:
        scale = d**-0.5
    # delta = rowsum(dO * O), outside the kernel as in the JAX package
    delta = torch.sum(g * out, dim=-1).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = _build.load(_BWD_SOURCE, _BWD_FUNCTIONS)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = lib.t2p_flash_bwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            None if maskf is None else maskf.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, tq, tk, d, float(scale), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_bwd kernel launch failed: CUDA error {rc}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0  # kernel launches, read by chip_smoke.py
