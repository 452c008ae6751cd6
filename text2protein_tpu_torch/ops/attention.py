"""Multi-head attention dispatch (counterpart of text2protein_tpu/ops/attention.py).

Shapes inside `flash.supports` go to the flash kernels: the CUDA kernels for
tensors on the GPU, their plain versions for tensors on the CPU. Other
shapes take the einsum path (`_xla_attention`), as they do in the JAX
package.

A call that needs a gradient goes through `_FlashAttention`, the counterpart
of the JAX package's custom VJP (`_flash_op`): its backward is the flash
backward kernel where the gate holds, and otherwise recomputes the einsum
path and differentiates it, as the JAX package does. The gate is the JAX
package's `flash.supports_bwd` for CPU tensors (so the CPU tests hold the
JAX dispatch) and `flash.supports_bwd_cuda` for CUDA tensors, which also
admits the unmasked shapes that the JAX rule refuses for TPU tiling
reasons. A call without a gradient (serving, under `inference_mode`)
calls the forward alone.

With the pair grid's rows split over ranks (`parallel.sequence`) the
dispatch decides by the shapes this rank holds: its query tokens against
the gathered keys. So at model 4 the 4x4 mid block's self-attention (Tq =
4 < 8) takes the einsum path where the JAX package, deciding by the
global shapes under SPMD, takes the flash kernel. On the CPU both routes
are plain PyTorch of the same function.

Layout: q (B, H, Tq, D), k/v (B, H, Tk, D); optional kv_mask (B, Tk) bool.
"""

from __future__ import annotations

import torch

from . import flash


def _xla_attention(q, k, v, scale, kv_mask=None):
    """The JAX package's einsum path: a -inf bias for masked keys, so a fully
    masked row is NaN there. In q's dtype, as the JAX path runs in it: for
    bf16 the scale is rounded to bf16 and the softmax is jax.nn.softmax's,
    op by op (max, exp(x - max), a sum accumulated in f32 and rounded,
    the division)."""
    dt = q.dtype
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k)
    if dt == torch.float32:
        logits = logits * scale
    else:
        logits = logits * torch.tensor(scale, dtype=dt).item()
    if kv_mask is not None:
        bias = torch.where(kv_mask[:, None, None, :], 0.0, float("-inf"))
        logits = logits + bias.to(dt)
    if dt == torch.float32:
        weights = torch.softmax(logits, dim=-1)
    else:
        e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        weights = e / e.sum(dim=-1, keepdim=True, dtype=torch.float32).to(dt)
    return torch.einsum("bhqk,bhkd->bhqd", weights, v)


class _FlashAttention(torch.autograd.Function):
    """Flash forward; backward by the flash backward kernel, or by
    recomputing the einsum path where the kernel's gate refuses the shape
    (JAX `_flash_op_fwd` / `_flash_op_bwd`). The mask gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, scale, kv_mask):
        out, lse = flash.flash_attention_fwd(q, k, v, scale=scale,
                                             kv_mask=kv_mask)
        ctx.scale = scale
        ctx.masked = kv_mask is not None
        ctx.save_for_backward(q, k, v, out, lse,
                              *([kv_mask] if ctx.masked else []))
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, *rest = ctx.saved_tensors
        kv_mask = rest[0] if ctx.masked else None
        g = g.contiguous()
        if (flash.supports_bwd_cuda(q, k, v, ctx.masked) if q.is_cuda
                else flash.supports_bwd(q, k, v)):
            dq, dk, dv = flash.flash_attention_bwd(
                q, k, v, out, lse, g, scale=ctx.scale, kv_mask=kv_mask)
        else:
            with torch.enable_grad():
                inputs = [t.detach().requires_grad_() for t in (q, k, v)]
                ref = _xla_attention(*inputs, ctx.scale, kv_mask=kv_mask)
                dq, dk, dv = torch.autograd.grad(ref, inputs, g)
        return dq, dk, dv, None, None


def dot_product_attention(q, k, v, scale=None, kv_mask=None):
    """Scaled dot-product attention.

    Args:
      q: (B, H, Tq, D); k, v: (B, H, Tk, D).
      scale: logit scale; defaults to D**-0.5.
      kv_mask: optional (B, Tk) bool, True = attend.
    Returns:
      (B, H, Tq, D).
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not flash.supports(q, k, v):
        return _xla_attention(q, k, v, scale, kv_mask=kv_mask)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad
    ):
        return _FlashAttention.apply(q, k, v, float(scale), kv_mask)
    return flash.flash_attention(q, k, v, scale=float(scale),
                                 kv_mask=kv_mask)
