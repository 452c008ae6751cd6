"""Length masks and training batches (counterpart of
text2protein_tpu/conditioning.py:92-96,162-171,173-240)."""

from __future__ import annotations

import numpy as np
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


def batch_to_device_arrays(batch, config, device="cpu"):
    """Host batch (from data.make_batch) -> the tensors the loss takes, on
    `device`: coords_6d transposed to NHWC, mask_pair, ss_spans, length.

    With `data.featurize_on_device` the maps are not shipped: the backbone
    coords `bb` (B, N, 3, 3) and the residue mask `mask_res` (B, N) cross
    instead, with ss_spans and length, and the train and eval steps rebuild
    coords_6d and mask_pair on the device (`data.featurize.featurize_batch`),
    as the JAX package does. The JAX package's `inpainting` condition
    (random training masks) and the C=8 on-device layout are not ported yet
    and raise."""
    if "inpainting" in config.model.condition:
        raise NotImplementedError(
            "training with the inpainting condition is not ported yet")
    if config.data.get("featurize_on_device", False):
        if int(config.data.num_channels) != 5:
            raise NotImplementedError(
                "data.featurize_on_device with the C=8 layout is not ported "
                "yet")
        mask_res = np.einsum("bii->bi", np.asarray(batch["mask_pair"]))
        arrays = {
            "bb": np.asarray(batch["coords"], dtype=np.float32),
            "mask_res": mask_res.astype(bool),
            "ss_spans": np.asarray(batch["ss_spans"], dtype=np.int32),
            "length": np.asarray(batch["length"], dtype=np.int32),
        }
    else:
        coords = np.ascontiguousarray(
            np.asarray(batch["coords_6d"]).transpose(0, 2, 3, 1))  # -> NHWC
        arrays = {
            "coords_6d": coords,
            "mask_pair": np.asarray(batch["mask_pair"], dtype=bool),
            "ss_spans": np.asarray(batch["ss_spans"], dtype=np.int32),
            "length": np.asarray(batch["length"], dtype=np.int32),
        }
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}
