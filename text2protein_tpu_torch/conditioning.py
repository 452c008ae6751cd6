"""Conditions and training batches (counterpart of
text2protein_tpu/conditioning.py): length masks, random training-time
inpainting masks, user inpainting masks ("1:5,10:15"), the sampler's
condition from a batch or a PDB chain, and the host batch -> device tensors
step of training."""

from __future__ import annotations

import tempfile
from pathlib import Path

import numpy as np
import torch

from .parallel.mesh import rand


def length_mask(lengths, n):
    """(B,) lengths -> (B, N, N) bool, True on the leading [l, l] square."""
    pos = torch.arange(n, device=lengths.device)
    row = pos[None, :] < lengths[:, None]  # (B, N)
    return row[:, :, None] & row[:, None, :]


def _pair_mask(m):
    """(..., N) 1-D mask -> (..., N, N) via logical_or(m_i, m_j)."""
    return m[..., :, None] | m[..., None, :]


def random_mask_batch(lengths, n, config, generator=None, draws=None):
    """Training-time inpainting masks (JAX `random_mask_batch`).

    lengths (B,) int real lengths; n the padded size. Returns (B, N, N)
    bool, True = the region to inpaint, on lengths' device; or None when
    "inpainting" is not a condition of the config.

    One uniform per batch picks the kind: a random mask (`prob <
    random_mask_prob`), a contiguous one (`prob > 1 - contiguous_mask_prob`)
    or all free. Each row's span is lo + trunc(U * max(hi - lo, 1)) with lo
    and hi the truncated mask_min_len * L and mask_max_len * L (float32, as
    the JAX package computes them); the random mask takes the `span`
    real residues of lowest score (none when span is 0); the contiguous one
    starts at trunc(U * max(L - span, 1)). A 1-D mask m becomes m_i | m_j.

    The draws come from `generator` (on lengths' device), in this order: the
    choice (a 0-d uniform), the span uniforms (B,), the scores (B, N) and
    the start uniforms (B,); or they are injected as `draws`, a dict with
    those four tensors under "prob", "span", "scores" and "start". A
    RowGenerator draws each for the global batch and keeps this rank's rows;
    the choice is then the same on every rank."""
    if "inpainting" not in config.model.condition:
        return None
    inp = config.model.inpainting
    f32 = torch.float32
    dev = lengths.device
    b = lengths.shape[0]
    if draws is None:
        if generator is None:
            raise ValueError("random inpainting masks need a generator or "
                             "injected draws")

        def uniform(shape):
            return rand(shape, generator, dev)

        draws = {"prob": uniform(()), "span": uniform((b,)),
                 "scores": uniform((b, n)), "start": uniform((b,))}
    prob, span_u, scores, start_u = (
        torch.as_tensor(draws[k], dtype=f32, device=dev)
        for k in ("prob", "span", "scores", "start"))
    lengths = lengths.to(torch.int32)
    length_f = lengths.to(f32)

    def scaled(frac):  # trunc(frac * L) in float32
        return (torch.tensor(frac, dtype=f32) * length_f).to(torch.int32)

    lo, hi = scaled(inp.mask_min_len), scaled(inp.mask_max_len)
    span = lo + (span_u * torch.clamp(hi - lo, min=1).to(f32)).to(
        torch.int32)
    pos = torch.arange(n, device=dev)
    real = pos[None, :] < lengths[:, None]

    # random: the `span` real residues of lowest score
    scores = torch.where(real, scores, torch.full_like(scores, float("inf")))
    kth = torch.clamp(span - 1, min=0).to(torch.int64)[:, None]
    thresh = torch.gather(torch.sort(scores, dim=-1).values, 1, kth)
    rand_masks = (scores <= thresh) & real & (span > 0)[:, None]

    # contiguous: [start, start + span)
    start = (start_u * torch.clamp(lengths - span, min=1).to(f32)).to(
        torch.int32)
    cont_masks = ((pos[None, :] >= start[:, None])
                  & (pos[None, :] < (start + span)[:, None]))

    p_rand = torch.tensor(inp.random_mask_prob, dtype=f32)
    p_cont = torch.tensor(1 - inp.contiguous_mask_prob, dtype=f32)
    ones = torch.ones((b, n), dtype=torch.bool, device=dev)
    # chosen on the device, as the JAX package does: no host sync
    mask1d = torch.where(prob < p_rand, rand_masks,
                         torch.where(prob > p_cont, cont_masks, ones))
    return _pair_mask(mask1d)


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


def get_condition_from_batch(config, batch, mask_info=None, device="cpu",
                             generator=None):
    """The sampler's condition dict from a batch, as tensors on `device`.
    `coords_6d` may be channel-first (B, C, N, N), the record layout, or
    NHWC; the returned maps are NHWC. The inpainting mask is `mask_info`'s
    ("1:5,10:15") or, without it, a random training mask drawn from
    `generator` (on `device`)."""
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
            if mask_info is not None:
                mask = selected_mask_batch(mask_info, coords.shape[0], n,
                                           device)
            else:
                lengths = torch.as_tensor(np.asarray(batch["length"]),
                                          device=device)
                mask = random_mask_batch(lengths, n, config,
                                         generator=generator)
            out[c] = {"coords_6d": coords, "mask_inpaint": mask}
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
                         "featurizer (length, model count or, for C=8, the "
                         "SS annotation)")
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
    instead, with ss_spans, length and, for C=8, the SS block channels
    `ss_block` (B, N, N, 3) as uint8; the train and eval steps rebuild
    coords_6d and mask_pair on the device (`data.featurize.featurize_batch`),
    as the JAX package does. With the inpainting condition the train and
    eval steps also draw the random inpainting masks on the device
    (`training.steps.with_inpainting_mask`), where the JAX package draws
    them here."""
    if config.data.get("featurize_on_device", False):
        mask_res = np.einsum("bii->bi", np.asarray(batch["mask_pair"]))
        arrays = {
            "bb": np.asarray(batch["coords"], dtype=np.float32),
            "mask_res": mask_res.astype(bool),
            "ss_spans": np.asarray(batch["ss_spans"], dtype=np.int32),
            "length": np.asarray(batch["length"], dtype=np.int32),
        }
        if int(config.data.num_channels) == 8:
            ss = np.asarray(batch["coords_6d"][:, 4:7]).transpose(0, 2, 3, 1)
            arrays["ss_block"] = ss.astype(np.uint8)
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
