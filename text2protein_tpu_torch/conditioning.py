"""Length masks (counterpart of text2protein_tpu/conditioning.py:92-96,162-171)."""

from __future__ import annotations

import torch


def length_mask(lengths, n):
    """(B,) lengths -> (B, N, N) bool, True on the leading [l, l] square."""
    pos = torch.arange(n, device=lengths.device)
    row = pos[None, :] < lengths[:, None]  # (B, N)
    return row[:, :, None] & row[:, None, :]


def get_mask_all_lengths(config, batch_size=16, device="cpu"):
    """(L_all, B, N, N) length masks for each length in [min, max]."""
    n = config.data.max_res_num
    lengths = torch.arange(config.data.min_res_num, n + 1, device=device)
    masks = length_mask(lengths, n)  # (L_all, N, N)
    return masks[:, None].expand(len(lengths), batch_size, n, n).clone()
