"""Masked denoising-score-matching loss (counterpart of
text2protein_tpu/diffusion/losses.py), NHWC.

Batch layout, as in the JAX package:
  coords_6d    (B, N, N, C) float
  mask_pair    (B, N, N)    bool
  ss_spans     (B, MAX_SS_BLOCKS, 2) int32, -1-padded  [only for "ss"]
  mask_inpaint (B, N, N)    bool (True = free/inpainted region) [optional]
  context      (B, T, D)    float  [optional]
  context_mask (B, T)       bool   [optional]

Every random draw is injectable: the diffusion time `t`, the noise `z`, the
context-dropout keep mask and the SS block-dropout mask. What is not
injected is drawn from the explicit `generator`, which also feeds the
model's dropout masks in train mode; a `parallel.mesh.RowGenerator` makes
each draw for the global batch (a draw of the grid for the whole grid) and
keeps this rank's rows.

With a `row_group` (`parallel.sequence`: the grid's rows split over ranks)
the grid keys hold this rank's rows, and each sample's masked sum and
element count are summed over the group before the division, so every
rank's loss is the whole batch's (JAX `shard_grid`).
"""

from __future__ import annotations

import torch

from ..models.utils import get_score_fn
from ..parallel.mesh import rand, randn
from .sde import bcast


def block_dropout(coords_6d, ss_spans, p: float = 0.2, generator=None,
                  drop=None, row_group=None):
    """Zero SS-block channels 4:7 on the rows AND columns of dropped blocks.
    Spans are end-exclusive. `drop` (B, MAX_SS_BLOCKS) bool injects the
    draw; otherwise each block is dropped with probability p. With a
    `row_group`, `coords_6d` holds this rank's rows of the grid."""
    b, n = coords_6d.shape[0], coords_6d.shape[2]
    dev = coords_6d.device
    if drop is None:
        drop = rand(ss_spans.shape[:2], generator, dev) < p
    drop = drop & (ss_spans[..., 0] >= 0)
    pos = torch.arange(n, device=dev)
    in_span = ((pos[None, None, :] >= ss_spans[..., 0:1])
               & (pos[None, None, :] < ss_spans[..., 1:2]))  # (B, MAXB, N)
    dropped = torch.any(in_span & drop[..., None], dim=1)     # (B, N)
    keep = ~(dropped[:, :, None] | dropped[:, None, :])       # (B, N, N)
    if row_group is not None:
        keep = row_group.local_rows(keep, 1)
    keep = keep[..., None].to(coords_6d.dtype)
    out = coords_6d.clone()
    out[..., 4:7] = out[..., 4:7] * keep
    return out


def make_conditional_mask(coords_6d, condition, mask_inpaint=None):
    """True = entry participates in the loss / evolves during sampling;
    False = entry is clamped to its conditioning value."""
    cmask = torch.ones(coords_6d.shape, dtype=torch.bool,
                       device=coords_6d.device)
    for c in condition or ():
        if c == "length":
            cmask[..., -1] = False
        elif c == "ss":
            cmask[..., 4:7] = False
        elif c == "inpainting":
            if mask_inpaint is None:
                raise ValueError("the inpainting condition needs "
                                 "mask_inpaint")
            cmask = cmask & mask_inpaint[..., None]
        else:
            raise ValueError(f"unknown condition {c}")
    return cmask


def get_sde_loss_fn(sde, model, train: bool, condition=(), eps: float = 1e-5,
                    ss_dropout: float = 0.2, context_dropout: float = 0.0,
                    row_group=None):
    """Returns loss_fn(params, batch, generator=None, t=None, z=None,
    context_keep=None, ss_drop=None) -> scalar loss.

    `params` is None for the model's own parameters, or a {name: tensor}
    dict (the EMA params in eval). `context_dropout` zeroes the whole
    caption embedding of a random subset of samples (the classifier-free
    guidance null); the token mask is kept. `row_group`: the grid's rows
    are split over it (the model's too: `parallel.sequence.rows_split`),
    and an injected `z` holds this rank's rows."""
    condition = tuple(condition or ())

    def loss_fn(params, batch, generator=None, t=None, z=None,
                context_keep=None, ss_drop=None):
        coords_6d = batch["coords_6d"]
        mask_pair = batch["mask_pair"]
        b = coords_6d.shape[0]
        dev = coords_6d.device

        context = batch.get("context")
        if train and context_dropout > 0.0 and context is not None:
            if context_keep is None:
                context_keep = rand((b,), generator, dev) >= context_dropout
            context = context * context_keep.to(context.dtype)[:, None, None]

        if "ss" in condition:
            coords_6d = block_dropout(coords_6d, batch["ss_spans"],
                                      p=ss_dropout, generator=generator,
                                      drop=ss_drop, row_group=row_group)

        score_fn = get_score_fn(sde, model, params, train=train,
                                generator=generator)

        if t is None:
            t = rand((b,), generator, dev) * (sde.T - eps) + eps
        if z is None:
            z = randn(coords_6d.shape, generator, dev, rows_dim=1)
        mean, std = sde.marginal_prob(coords_6d, t)
        perturbed = mean + bcast(std, coords_6d.ndim) * z

        cmask = make_conditional_mask(coords_6d, condition,
                                      batch.get("mask_inpaint"))
        mask = mask_pair[..., None] & cmask
        num_elem = torch.sum(mask.reshape(b, -1), dim=-1)

        perturbed = torch.where(mask, perturbed, coords_6d)
        score = score_fn(perturbed, t, context, batch.get("context_mask"))
        losses = torch.square(score * bcast(std, score.ndim) + z) * mask
        losses = torch.sum(losses.reshape(b, -1), dim=-1)
        if row_group is not None:
            losses, num_elem = row_group.sum(torch.stack(
                [losses, num_elem.to(losses.dtype)], dim=-1)).unbind(-1)
        losses = losses / (num_elem + 1e-8)
        return torch.mean(losses)

    return loss_fn
