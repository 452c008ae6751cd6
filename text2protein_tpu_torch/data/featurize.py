"""trRosetta-style 6D inter-residue geometry (counterpart of the numpy half
of text2protein_tpu/data/featurize.py).

For a protein of length L, per residue pair:
  dist  : Cb-Cb distance, clamped at dmax (20 A), normalized to [-1, 1]
  omega : Ca-Cb-Cb-Ca dihedral / pi
  theta : N-Ca-Cb-Cb dihedral / pi
  phi   : Ca-Cb-Cb planar angle, normalized to [-1, 1]
Pairs farther than dmax (and the diagonal) keep dist = dmax and angles 0
before normalization; NaNs are zeroed afterwards.

The host (numpy) featurizer, and the on-device batched one on torch
tensors (`get_coords6d_torch`, `featurize_batch`: JAX `get_coords6d_jax`,
`featurize_batch_jax`). Channel layouts:
  C=5: [dist, omega, theta, phi, padding-mask]
  C=8: [dist, omega, theta, phi, helix-pair, beta-pair, block-adj,
        padding-mask], the SS block channels from P-SEA (`data/ss.py`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Virtual-Cb reconstruction constants (ideal geometry, from trRosetta)
CB_A = -0.58273431
CB_B = 0.56802827
CB_C = -0.54067466

DMAX_DEFAULT = 20.0


def _dihedral_pairs(a, b, c, d):
    """Dihedral angle for broadcastable point arrays (..., 3) -> (...,)."""
    b0 = -1.0 * (b - a)
    b1 = c - b
    b2 = d - c
    b1 = b1 / np.linalg.norm(b1, axis=-1, keepdims=True)
    v = b0 - np.sum(b0 * b1, axis=-1, keepdims=True) * b1
    w = b2 - np.sum(b2 * b1, axis=-1, keepdims=True) * b1
    x = np.sum(v * w, axis=-1)
    y = np.sum(np.cross(b1, v) * w, axis=-1)
    return np.arctan2(y, x)


def _planar_angle(a, b, c):
    """Planar angle at b for broadcastable point arrays (..., 3) -> (...,)."""
    v = a - b
    v = v / np.linalg.norm(v, axis=-1, keepdims=True)
    w = c - b
    w = w / np.linalg.norm(w, axis=-1, keepdims=True)
    return np.arccos(np.sum(v * w, axis=-1))


def virtual_cb(xyz):
    """Rebuild virtual Cb from N/CA/C backbone coords (..., 3 atoms, 3)."""
    n, ca, c = xyz[..., 0, :], xyz[..., 1, :], xyz[..., 2, :]
    b = ca - n
    cc = c - ca
    a = np.cross(b, cc)
    return CB_A * a + CB_B * b + CB_C * cc + ca


def get_coords6d(xyz, dmax=DMAX_DEFAULT, normalize=True):
    """xyz: (L, 3, 3) N/CA/C coords -> (L, L, 4) [dist, omega, theta, phi]."""
    xyz = np.asarray(xyz, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        n, ca = xyz[:, 0], xyz[:, 1]
        cb = virtual_cb(xyz)
        L = xyz.shape[0]
        d = np.linalg.norm(cb[None, :, :] - cb[:, None, :], axis=-1)
        # a closed ball (d <= dmax), the diagonal excluded
        contact = (d <= dmax) & (~np.eye(L, dtype=bool))
        ca_i, ca_j = ca[:, None, :], ca[None, :, :]
        cb_i, cb_j = cb[:, None, :], cb[None, :, :]
        n_i = n[:, None, :]
        omega = _dihedral_pairs(ca_i, cb_i, cb_j, ca_j)
        theta = _dihedral_pairs(n_i, ca_i, cb_i, cb_j)
        phi = _planar_angle(ca_i, cb_i, cb_j)
        zeros = np.zeros_like(d)
        dist6d = np.where(contact, d, dmax)
        omega6d = np.where(contact, omega, zeros)
        theta6d = np.where(contact, theta, zeros)
        phi6d = np.where(contact, phi, zeros)
        if normalize:
            dist6d = (dist6d / dmax * 2) - 1
            omega6d = omega6d / math.pi
            theta6d = theta6d / math.pi
            phi6d = (phi6d / math.pi * 2) - 1
        return np.stack([dist6d, omega6d, theta6d, phi6d], axis=-1)


def featurize_structure(bb_coords, mask, ss_constraints: bool,
                        dmax: float = DMAX_DEFAULT, ca_coords=None):
    """6D maps, the SS block channels when `ss_constraints` (C=8), and the
    padding channel, masked, channel-first.

    The SS annotation runs over `ca_coords` (default: the backbone's CAs).
    Returns (coords_6d (C, L, L) float32, mask_pair (L, L) bool,
    ss_indices "s:e,..." or ""), or (None, None, None) when the annotation
    fails (it covers another number of residues than the map)."""
    from .ss import get_coarse_constraints

    nres = bb_coords.shape[0]
    coords_6d = np.nan_to_num(get_coords6d(bb_coords, dmax=dmax,
                                           normalize=True))
    padding = np.ones((nres, nres, 1))
    helix_beta_str = ""
    if ss_constraints:
        ca = ca_coords if ca_coords is not None else bb_coords[:, 1]
        block_adj, helix_beta_str = get_coarse_constraints(
            ca, coords_6d[:, :, 0], dist_threshold=5, dmax=dmax)
        if block_adj is None:
            return None, None, None
        coords_6d = np.concatenate([coords_6d, block_adj, padding], axis=-1)
    else:
        coords_6d = np.concatenate([coords_6d, padding], axis=-1)
    mask = np.asarray(mask)
    mask_pair = (mask.reshape(1, -1) * mask.reshape(-1, 1)).astype(bool)
    coords_6d = coords_6d * mask_pair.reshape(nres, nres, 1)
    return (coords_6d.transpose(2, 0, 1).astype(np.float32), mask_pair,
            helix_beta_str)


# ------------------------------------------------------------- on device


def _norm_t(x):
    """jnp.linalg.norm over the last axis: sqrt(sum(x * x))."""
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))


def _dihedral_t(a, b, c, d):
    b0 = -1.0 * (b - a)
    b1 = c - b
    b2 = d - c
    b1 = b1 / _norm_t(b1)
    v = b0 - torch.sum(b0 * b1, dim=-1, keepdim=True) * b1
    w = b2 - torch.sum(b2 * b1, dim=-1, keepdim=True) * b1
    x = torch.sum(v * w, dim=-1)
    y = torch.sum(torch.linalg.cross(b1.expand_as(v), v) * w, dim=-1)
    return torch.atan2(y, x)


def _planar_t(a, b, c):
    v = a - b
    v = v / _norm_t(v)
    w = c - b
    w = w / _norm_t(w)
    return torch.arccos(torch.sum(v * w, dim=-1))


def get_coords6d_torch(xyz, dmax=DMAX_DEFAULT, normalize=True):
    """Batched 6D featurization on tensors, the JAX `get_coords6d_jax`
    (`_coords6d_dense`) with a leading batch axis. xyz: (B, L, 3, 3) N/CA/C
    -> (B, L, L, 4) [dist, omega, theta, phi], in xyz's dtype. NaNs from
    degenerate geometry (zeroed padded residues) are left for the caller."""
    n, ca, c = xyz[..., 0, :], xyz[..., 1, :], xyz[..., 2, :]
    b = ca - n
    cc = c - ca
    cb = CB_A * torch.linalg.cross(b, cc) + CB_B * b + CB_C * cc + ca
    L = xyz.shape[1]
    d = _norm_t(cb[:, None, :, :] - cb[:, :, None, :])[..., 0]  # [i, j]
    eye = torch.eye(L, dtype=torch.bool, device=xyz.device)
    contact = (d <= dmax) & ~eye
    ca_i, ca_j = ca[:, :, None, :], ca[:, None, :, :]
    cb_i, cb_j = cb[:, :, None, :], cb[:, None, :, :]
    n_i = n[:, :, None, :]
    omega = _dihedral_t(ca_i, cb_i, cb_j, ca_j)
    theta = _dihedral_t(n_i, ca_i, cb_i, cb_j)
    phi = _planar_t(ca_i, cb_i, cb_j.expand(-1, L, -1, -1))
    zeros = torch.zeros_like(d)
    dist6d = torch.where(contact, d, torch.full_like(d, dmax))
    omega6d = torch.where(contact, omega, zeros)
    theta6d = torch.where(contact, theta, zeros)
    phi6d = torch.where(contact, phi, zeros)
    if normalize:
        dist6d = (dist6d / dmax * 2) - 1
        omega6d = omega6d / math.pi
        theta6d = theta6d / math.pi
        phi6d = (phi6d / math.pi * 2) - 1
    return torch.stack([dist6d, omega6d, theta6d, phi6d], dim=-1)


def featurize_batch(bb, mask_res, num_channels=5, ss_block=None,
                    dmax=DMAX_DEFAULT):
    """Train-time featurization on the device (JAX `featurize_batch_jax`):
    padded backbones -> NHWC maps.

    bb (B, N, 3, 3) N/CA/C coords, zero-padded past each length; mask_res
    (B, N) bool; ss_block (B, N, N, 3) SS block channels (any int or float
    dtype, uint8 on the wire), needed for C=8. Returns (coords_6d (B, N, N,
    C) float32, mask_pair (B, N, N) bool), the host `featurize_structure`
    output in NHWC. `nan_to_num` then a `where` (not a multiply) on the
    pair mask, so the NaNs of padded residues cannot leak."""
    num_channels = int(num_channels)
    if num_channels not in (5, 8):
        raise ValueError(f"num_channels must be 5 or 8, got {num_channels}")
    geo = get_coords6d_torch(bb.to(torch.float32), dmax=dmax)
    mask_pair = mask_res[:, :, None] & mask_res[:, None, :]
    mp = mask_pair[..., None]
    chans = [torch.where(mp, torch.nan_to_num(geo), 0.0)]
    if num_channels == 8:
        if ss_block is None:
            raise ValueError("the C=8 layout needs the SS block channels "
                             "(ss_block)")
        chans.append(torch.where(mp, ss_block.to(torch.float32), 0.0))
    chans.append(mp.to(torch.float32))
    return torch.cat(chans, dim=-1), mask_pair
