"""Flash-attention forward: the CUDA kernel `csrc/flash_fwd.cu` and its plain
PyTorch version.

Counterpart of text2protein_tpu/ops/flash.py (`supports`,
`flash_attention_fwd`, `flash_attention`). A tensor on the GPU goes to the
kernel; a tensor on the CPU goes to `flash_attention_fwd_reference`, which
computes the same function in plain torch. The backward kernel is not ported
yet.
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


def flash_attention_fwd(q, k, v, scale=None, kv_mask=None):
    """Forward pass returning (out, lse): the kernel for a CUDA tensor, the
    plain version for a CPU tensor.

    q: (B, H, Tq, D); k, v: (B, H, Tk, D); kv_mask: (B, Tk) bool or None.
    Returns out (B, H, Tq, D) and lse (B*H, Tq, 1) float32.
    """
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, scale, kv_mask)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if scale is None:
        scale = d**-0.5
    if not supports(q, k, v):
        raise ValueError(f"flash kernel does not take q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    _check("q", q, (b, h, tq, d))
    _check("k", k, (b, h, tk, d))
    _check("v", v, (b, h, tk, d))
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    maskf = None
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (b, tk) or kv_mask.device != q.device:
            raise ValueError(f"kv_mask: expected ({b}, {tk}) on {q.device}, "
                             f"got {tuple(kv_mask.shape)} on "
                             f"{kv_mask.device}")
        maskf = kv_mask.to(torch.float32).contiguous()
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
