"""Differentiable backbone geometry: the NeRF chain builder and the angle
helpers of the restraint energies (counterpart of
text2protein_tpu/realize/geometry.py).

Every function takes any number of leading batch dims: a backbone is
(..., L, 3, 3) N/CA/C, torsions are (..., L). The chain builder is a loop
over L (the JAX package's `lax.scan`), batched over restarts and designs.

Ideal backbone geometry constants (Engh & Huber).
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Bond lengths (A)
B_N_CA = 1.458
B_CA_C = 1.525
B_C_N = 1.329
# Bond angles (rad)
A_N_CA_C = math.radians(111.2)
A_CA_C_N = math.radians(116.2)
A_C_N_CA = math.radians(121.7)


def _f32(x, like):
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _place(a, b, c, r, theta, chi):
    """NeRF: place the 4th atom given 3 previous (..., 3) points and the
    internal coordinates r = |c-d|, theta = angle(b, c, d) (floats) and
    chi = dihedral(a, b, c, d) ((...,) tensor)."""
    bc = c - b
    bc = bc / torch.linalg.vector_norm(bc, dim=-1, keepdim=True)
    ab = b - a
    n = torch.linalg.cross(ab, bc, dim=-1)
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True),
                        min=1e-8)
    m = torch.stack([bc, torch.linalg.cross(n, bc, dim=-1), n], dim=-1)
    # r and theta are f32 constants, as the JAX package computes them
    th = _f32(theta, chi)
    r_cos = -r * torch.cos(th)
    r_sin = r * torch.sin(th)
    d_local = torch.stack([r_cos.expand_as(chi), r_sin * torch.cos(chi),
                           r_sin * torch.sin(chi)], dim=-1)
    # m @ d_local as a sum of products: the same order at any batch shape
    return c + torch.sum(m * d_local[..., None, :], dim=-1)


def build_backbone(phi, psi, omega=None):
    """Torsions -> backbone N/CA/C coordinates.

    Args:
      phi, psi: (..., L) torsions in radians (phi[0] and psi[-1] are unused
        by the chain construction but kept for a uniform parameterization).
      omega: (..., L) peptide-bond torsions; defaults to pi (trans).
    Returns:
      (..., L, 3, 3) float32 coords.
    """
    L = phi.shape[-1]
    batch = phi.shape[:-1]
    if omega is None:
        omega = torch.full_like(phi, math.pi)

    # first residue at a canonical pose
    z = torch.zeros(batch + (3,), dtype=phi.dtype, device=phi.device)
    n0 = z
    ca0 = z + _f32([B_N_CA, 0.0, 0.0], phi)
    c0 = _place(z + _f32([0.0, 1.0, 0.0], phi), n0, ca0, B_CA_C, A_N_CA_C,
                z[..., 0] + _f32(math.pi * 0.5, phi))
    atoms = [torch.stack([n0, ca0, c0], dim=-2)]
    n_p, ca_p, c_p = n0, ca0, c0
    for i in range(1, L):
        n_i = _place(n_p, ca_p, c_p, B_C_N, A_CA_C_N, psi[..., i - 1])
        ca_i = _place(ca_p, c_p, n_i, B_N_CA, A_C_N_CA, omega[..., i])
        c_i = _place(c_p, n_i, ca_i, B_CA_C, A_N_CA_C, phi[..., i])
        atoms.append(torch.stack([n_i, ca_i, c_i], dim=-2))
        n_p, ca_p, c_p = n_i, ca_i, c_i
    return torch.stack(atoms, dim=-3)


def virtual_cb_from_backbone(bb):
    """Virtual Cb with the featurizer's constants."""
    n, ca, c = bb[..., 0, :], bb[..., 1, :], bb[..., 2, :]
    b = ca - n
    cc = c - ca
    a = torch.linalg.cross(b, cc, dim=-1)
    return -0.58273431 * a + 0.56802827 * b - 0.54067466 * cc + ca


# Ramachandran bins used for pose initialization, degrees.
_RAMA_BINS = np.array(
    [
        [-140.0, 153.0],
        [-72.0, 145.0],
        [-122.0, 117.0],
        [-82.0, -14.0],
        [-61.0, -41.0],
        [57.0, 39.0],
    ]
)
_RAMA_PROBS = np.array([0.135, 0.155, 0.073, 0.122, 0.497, 0.018])


def random_dihedrals(L, generator, batch=(), device="cpu"):
    """Per-residue (phi, psi) drawn from the Ramachandran bin table with
    `generator` (a torch.Generator on `device`); omega fixed trans.
    Returns radians: (phi, psi, omega), each (*batch, L)."""
    n = int(np.prod(batch, dtype=np.int64)) * L
    probs = torch.tensor(_RAMA_PROBS, dtype=torch.float32, device=device)
    choice = torch.multinomial(probs, n, replacement=True,
                               generator=generator).reshape(tuple(batch)
                                                            + (L,))
    bins = torch.tensor(np.deg2rad(_RAMA_BINS), dtype=torch.float32,
                        device=device)
    phi = bins[choice, 0]
    psi = bins[choice, 1]
    omega = torch.full_like(phi, math.pi)
    return phi, psi, omega


def _safe_norm(x, eps=1e-6):
    """NaN-safe norm: masked-out singular pairs (i == j) must produce finite
    values AND finite gradients — `torch.where(mask, e, 0)` does not block
    NaN gradients from the masked branch."""
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True) + eps * eps)


def dihedral4(a, b, c, d):
    """Dihedral of 4 point sets (broadcastable), radians. Safe at coincident
    points (returns 0 there instead of NaN)."""
    b0 = -(b - a)
    b1 = c - b
    b2 = d - c
    b1 = b1 / _safe_norm(b1)
    v = b0 - torch.sum(b0 * b1, dim=-1, keepdim=True) * b1
    w = b2 - torch.sum(b2 * b1, dim=-1, keepdim=True) * b1
    x = torch.sum(v * w, dim=-1)
    y = torch.sum(torch.linalg.cross(b1, v, dim=-1) * w,
                  dim=-1)
    return torch.atan2(y, x + 1e-20)


def angle3(a, b, c):
    v = a - b
    v = v / _safe_norm(v)
    w = c - b
    w = w / _safe_norm(w)
    return torch.arccos(torch.clamp(torch.sum(v * w, dim=-1),
                                    -1.0 + 1e-7, 1.0 - 1e-7))
