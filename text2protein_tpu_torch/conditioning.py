"""Conditions and training batches (counterpart of
text2protein_tpu/conditioning.py): length masks, user inpainting masks
("1:5,10:15"), the sampler's condition from a batch or a PDB chain, and the
host batch -> device tensors step of training. Random training-time
inpainting masks (`random_mask_batch`) are not ported yet."""

from __future__ import annotations

import tempfile
from pathlib import Path

import numpy as np
import torch


def length_mask(lengths, n):
    """(B,) lengths -> (B, N, N) bool, True on the leading [l, l] square."""
    pos = torch.arange(n, device=lengths.device)
    row = pos[None, :] < lengths[:, None]  # (B, N)
    return row[:, :, None] & row[:, None, :]


def _pair_mask(m):
    """(..., N) 1-D mask -> (..., N, N) via logical_or(m_i, m_j)."""
    return m[..., :, None] | m[..., None, :]


def selected_mask_batch(mask_info: str, batch_size: int, n: int,
                        device="cpu"):
    """User mask spec "1:5,10:15" (inclusive ends, 0-based) -> (B, N, N)
    bool, True = region to inpaint."""
    m = torch.zeros(n, dtype=torch.bool)
    for r in mask_info.split(","):
        if ":" in r:
            s, e = r.split(":")
            m[int(s): int(e) + 1] = True
        else:
            m[int(r)] = True
    return _pair_mask(m.to(device).expand(batch_size, n))


def get_condition_from_batch(config, batch, mask_info=None, device="cpu"):
    """The sampler's condition dict from a batch, as tensors on `device`.
    `coords_6d` may be channel-first (B, C, N, N), the record layout, or
    NHWC; the returned maps are NHWC. The inpainting condition needs
    `mask_info`: random training masks are not ported yet."""
    out = {}
    n = config.data.max_res_num
    nc = config.data.num_channels
    coords = torch.as_tensor(np.asarray(batch["coords_6d"]),
                             dtype=torch.float32)
    if coords.ndim == 4 and coords.shape[-1] != nc and coords.shape[1] == nc:
        coords = coords.permute(0, 2, 3, 1)  # channel-first -> NHWC
    coords = coords.contiguous().to(device)
    for c in config.model.condition:
        if c == "length":
            lengths = torch.as_tensor(np.asarray(batch["length"]),
                                      device=device)
            out[c] = length_mask(lengths, n)
        elif c == "ss":
            out[c] = coords[..., 4:7]
        elif c == "inpainting":
            if mask_info is None:
                raise NotImplementedError(
                    "random inpainting masks (training) are not ported yet; "
                    "pass mask_info")
            out[c] = {"coords_6d": coords,
                      "mask_inpaint": selected_mask_batch(
                          mask_info, coords.shape[0], n, device)}
    return out


def get_conditions_from_pdb(pdb, config, chain="A", mask_info=None,
                            batch_size=8, device="cpu"):
    """The sampler's condition from a PDB chain: the chain's backbone is
    written to a file of its own and featurized as a record, which is
    repeated across the batch."""
    from .data.dataset import featurize_pdb_file, make_batch, standard_name
    from .data.pdbio import read_pdb, write_backbone_pdb
    from .data.vocab import THREE_TO_ONE

    st = read_pdb(pdb).filter_chain(chain)
    coords, seq = [], []
    for r in st.amino_residues():
        atoms = [r.atom(a) for a in ("N", "CA", "C")]
        if any(a is None for a in atoms):
            continue
        coords.append(atoms)
        seq.append(THREE_TO_ONE[standard_name(r.name)])
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / f"{Path(pdb).stem}_chain_{chain}.pdb"
        write_backbone_pdb(path, np.asarray(coords), seq="".join(seq),
                           chain=chain)
        rec = featurize_pdb_file(path, config.data.min_res_num,
                                 config.data.max_res_num,
                                 ss_constraints=config.data.num_channels == 8)
    if rec is None:
        raise ValueError(f"{pdb} chain {chain} is rejected by the "
                         "featurizer (length or model count)")
    batch = make_batch([rec] * batch_size, config.data.max_res_num)
    return get_condition_from_batch(config, batch, mask_info=mask_info,
                                    device=device)


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
