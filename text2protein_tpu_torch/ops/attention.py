"""Multi-head attention dispatch (counterpart of text2protein_tpu/ops/attention.py).

Shapes inside `flash.supports` go to the flash forward: the CUDA kernel for a
tensor on the GPU, its plain version for a tensor on the CPU. Other shapes
take the einsum path (`_xla_attention`), as they do in the JAX package. No
shape of the L=128 serving path falls outside `supports`.

The backward kernel is not ported yet, so a GPU call that needs a gradient
raises instead of going anywhere else.

Layout: q (B, H, Tq, D), k/v (B, H, Tk, D); optional kv_mask (B, Tk) bool.
"""

from __future__ import annotations

import torch

from . import flash


def _xla_attention(q, k, v, scale, kv_mask=None):
    """The JAX package's einsum path: a -inf bias for masked keys, so a fully
    masked row is NaN there."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if kv_mask is not None:
        bias = torch.where(kv_mask[:, None, None, :], 0.0, float("-inf"))
        logits = logits + bias
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", weights, v)


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
    if q.is_cuda and torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad
    ):
        raise NotImplementedError(
            "the flash-attention backward kernel is not ported yet; run "
            "under torch.no_grad() or torch.inference_mode()"
        )
    return flash.flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), scale=float(scale),
        kv_mask=kv_mask,
    )
