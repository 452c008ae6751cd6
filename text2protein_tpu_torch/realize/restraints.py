"""6D maps -> dense restraint tensors + masked restraint energies
(counterpart of text2protein_tpu/realize/restraints.py).

Dense masked (L, L) computations:

  * inverse scaling of sampled maps: dist=(d+1)*10, omega/theta=x*pi,
    phi=(x+1)*pi/2;
  * pair filter: any pair with dist > 12 A contributes NO restraints;
  * dist:  harmonic on Cb-Cb, upper triangle;
  * omega: circular harmonic dihedral Ca-Cb-Cb-Ca, upper triangle;
  * theta: circular harmonic dihedral N-Ca-Cb-Cb, full asymmetric L x L;
  * phi:   harmonic angle Ca-Cb-Cb, full asymmetric L x L;
  * staged sequence-separation bands 3 <= |i-j| < sep_max.

Every energy takes a backbone with leading batch dims, (..., L, 3, 3), and
returns one value per batch element, (...,). `Restraints` broadcasts
against those dims: (L, L) fields serve every element, and a stack of
designs, (D, L, L), viewed as (D, 1, L, L), serves (D, R) restarts.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from .geometry import (
    A_C_N_CA,
    A_CA_C_N,
    A_N_CA_C,
    B_C_N,
    B_CA_C,
    B_N_CA,
    angle3,
    dihedral4,
    virtual_cb_from_backbone,
)

DIST_FILTER = 12.0


def inverse_scale(coords_6d_cnn: np.ndarray, L: int) -> dict:
    """Sampled (C, N, N) map -> absolute-unit (L, L) target dicts."""
    msk = np.round(coords_6d_cnn[-1])
    l_check = math.sqrt(int((msk == 1).sum()))
    if not float(l_check).is_integer():
        raise ValueError("Terminated due to improper masking channel...")
    if int(l_check) != L:
        raise ValueError(f"the mask holds {l_check} residues, not {L}")
    npz = {}
    for idx, name in enumerate(["dist", "omega", "theta", "phi"]):
        npz[name] = np.clip(coords_6d_cnn[idx][msk == 1].reshape(L, L), -1, 1)
    npz["dist_abs"] = (npz["dist"] + 1) * 10
    npz["omega_abs"] = npz["omega"] * math.pi
    npz["theta_abs"] = npz["theta"] * math.pi
    npz["phi_abs"] = (npz["phi"] + 1) * math.pi / 2
    return npz


@dataclasses.dataclass
class Restraints:
    """Dense target maps + per-type validity masks, all (..., L, L)."""

    dist: torch.Tensor
    omega: torch.Tensor
    theta: torch.Tensor
    phi: torch.Tensor
    mask_dist: torch.Tensor   # upper-tri, dist>0, not filtered
    mask_omega: torch.Tensor  # upper-tri, |omega|>0, not filtered
    mask_full: torch.Tensor   # not filtered (theta/phi run on full L x L)
    mask_long: torch.Tensor   # upper-tri, DIST_FILTER < dist < dmax
    sep: torch.Tensor         # |i-j| matrix
    dist_std: float = 2.0
    angle_std: float = 0.1745

    _TENSORS = ("dist", "omega", "theta", "phi", "mask_dist", "mask_omega",
                "mask_full", "mask_long", "sep")

    def map(self, fn) -> "Restraints":
        """The same restraints with `fn` applied to every tensor."""
        return dataclasses.replace(
            self, **{k: fn(getattr(self, k)) for k in self._TENSORS})

    @classmethod
    def stack(cls, rsts) -> "Restraints":
        """Restraints of equal L and stds stacked along a new leading dim."""
        first = rsts[0]
        if any((r.dist_std, r.angle_std) != (first.dist_std, first.angle_std)
               for r in rsts):
            raise ValueError("stacked restraints must share their stds")
        return dataclasses.replace(first, **{
            k: torch.stack([getattr(r, k) for r in rsts])
            for k in cls._TENSORS})


def restraints_from_maps(npz: dict, dist_std=2.0, angle_std=10.0,
                         device="cpu") -> Restraints:
    dist = np.asarray(npz["dist_abs"], np.float32)
    omega = np.asarray(npz["omega_abs"], np.float32)
    theta = np.asarray(npz["theta_abs"], np.float32)
    phi = np.asarray(npz["phi_abs"], np.float32)
    L = dist.shape[0]

    not_filtered = dist <= DIST_FILTER
    triu = np.triu(np.ones((L, L), bool), 1)
    mask_dist = triu & (np.triu(dist, 1) > 0) & not_filtered
    mask_omega = triu & (np.abs(np.triu(omega, 1)) > 0) & not_filtered
    mask_full = not_filtered
    # weak long-range band: distances between the 12 A restraint filter and
    # the featurizer clamp (dmax=20), for long_dist_energy
    mask_long = triu & (dist > DIST_FILTER) & (dist < 19.5)

    idx = np.arange(L)
    sep = np.abs(idx[:, None] - idx[None, :]).astype(np.float32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return Restraints(
        dist=t(dist), omega=t(omega), theta=t(theta), phi=t(phi),
        mask_dist=t(mask_dist), mask_omega=t(mask_omega),
        mask_full=t(mask_full), mask_long=t(mask_long), sep=t(sep),
        dist_std=float(dist_std),
        angle_std=float(np.deg2rad(angle_std)),
    )


@functools.lru_cache(maxsize=None)
def _fake_offsets(device, dtype):
    """The offsets of the NaN guard's fake Cb_j and Ca_j from Cb_i and
    Ca_i, kept on the device (no host copy per evaluation)."""
    return (torch.tensor([3.0, 0.0, 0.0], dtype=dtype, device=device),
            torch.tensor([3.0, 3.0, 0.0], dtype=dtype, device=device))


def _circular_sq(x, mean):
    d = x - mean
    d = torch.atan2(torch.sin(d), torch.cos(d))  # wrap to (-pi, pi]
    return d * d


def _pair_sum(mask, e):
    return torch.sum(torch.where(mask, e, 0.0), dim=(-2, -1))


def restraint_energy(bb, rst: Restraints, sep_max, weights):
    """Total restraint energy of backbones under the active seq-sep bands.

    Args:
      bb: (..., L, 3, 3) backbone coords.
      rst: Restraints, broadcastable to bb's leading dims.
      sep_max: pairs with 3 <= |i-j| < sep_max are active (the staged
        cumulative schedule: short+medium+long unions).
      weights: dict with 'dist', 'orient': floats or (...,) tensors.
    Returns (...,) energies.
    """
    n = bb[..., 0, :]
    ca = bb[..., 1, :]
    cb = virtual_cb_from_backbone(bb)

    band = (rst.sep >= 3) & (rst.sep < sep_max)

    ca_i, ca_j = ca[..., :, None, :], ca[..., None, :, :]
    cb_i, cb_j = cb[..., :, None, :], cb[..., None, :, :]
    n_i = n[..., :, None, :]

    # Double-where NaN guard: at masked-out pairs (beyond the cutoff),
    # substitute a non-degenerate fake Cb_j BEFORE the angle math — masking
    # afterwards does not stop NaN gradients from the dead branch.
    safe = rst.mask_full[..., None]
    fake_cb, fake_ca = _fake_offsets(bb.device, bb.dtype)
    cb_j = torch.where(safe, cb_j, cb_i + fake_cb)
    ca_j = torch.where(safe, ca_j, ca_i + fake_ca)

    # --- dist: harmonic on |Cb_i - Cb_j|
    diff = cb_i - cb_j
    d = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)
    e_dist = ((d - rst.dist) / rst.dist_std) ** 2
    e = weights["dist"] * _pair_sum(rst.mask_dist & band, e_dist)
    om = dihedral4(ca_i, cb_i, cb_j, ca_j)
    e_om = _circular_sq(om, rst.omega) / rst.angle_std**2
    e = e + weights["orient"] * _pair_sum(rst.mask_omega & band, e_om)

    # --- theta: N_i - Ca_i - Cb_i - Cb_j dihedral (full asymmetric)
    th = dihedral4(n_i, ca_i, cb_i, cb_j)
    e_th = _circular_sq(th, rst.theta) / rst.angle_std**2
    m = rst.mask_full & band
    e = e + weights["orient"] * _pair_sum(m, e_th)

    # --- phi: Ca_i - Cb_i - Cb_j angle (harmonic, full asymmetric)
    ph = angle3(ca_i, cb_i, cb_j)
    e_ph = ((ph - rst.phi) / rst.angle_std) ** 2
    return e + weights["orient"] * _pair_sum(m, e_ph)


def long_dist_energy(bb, rst: Restraints, std: float = 3.0):
    """Weak harmonic on the 12-20 A distance band (beyond the restraint
    filter): regularizes loosely-contacted segments whose relative placement
    the <12 A restraints under-determine."""
    cb = virtual_cb_from_backbone(bb)
    diff = cb[..., :, None, :] - cb[..., None, :, :]
    d = torch.sqrt(torch.sum(diff * diff, -1) + 1e-12)
    e = ((d - rst.dist) / std) ** 2
    return _pair_sum(rst.mask_long, e)


def ca_coordinate_energy(bb, ca_ref, std=1.0, tol=1.0):
    """Flat-harmonic CA coordinate restraints: zero inside +-tol, then
    harmonic — anchors the relax stage to the minimized pose."""
    ca = bb[..., 1, :]
    d = torch.sqrt(torch.sum((ca - ca_ref) ** 2, dim=-1) + 1e-12)
    viol = torch.clamp(d - tol, min=0.0) / std
    return torch.sum(viol * viol, dim=-1)


def bonded_energy(bb, len_std=0.02, ang_std=0.035, omega_std=0.1):
    """Covalent backbone geometry energy for Cartesian-space minimization:
    harmonic bond lengths (N-CA, CA-C, C-N), bond angles (N-CA-C, CA-C-N,
    C-N-CA) at Engh & Huber ideals, plus the omega-planarity term (circular
    harmonic about trans)."""
    n, ca, c = bb[..., 0, :], bb[..., 1, :], bb[..., 2, :]

    def blen(a, b, b0):
        d = torch.sqrt(torch.sum((a - b) ** 2, -1) + 1e-12)
        return torch.sum(((d - b0) / len_std) ** 2, -1)

    def bang(a, b, cc, a0):
        return torch.sum(((angle3(a, b, cc) - a0) / ang_std) ** 2, -1)

    c_, n_ = c[..., :-1, :], n[..., 1:, :]
    e = blen(n, ca, B_N_CA) + blen(ca, c, B_CA_C) + blen(c_, n_, B_C_N)
    e = e + (
        bang(n, ca, c, A_N_CA_C)
        + bang(ca[..., :-1, :], c_, n_, A_CA_C_N)
        + bang(c_, n_, ca[..., 1:, :], A_C_N_CA)
    )
    om = dihedral4(ca[..., :-1, :], c_, n_, ca[..., 1:, :])
    return e + torch.sum(_circular_sq(om, math.pi), -1) / omega_std**2


# Ramachandran basin parameters for the smooth statistical torsion prior:
# von Mises mixture centered on the allowed basins (alpha-R, beta/PPII,
# alpha-L), mirroring the bin table used for pose init.
_RAMA_MU = np.deg2rad(
    np.array(
        [
            [-61.0, -41.0],  # alpha-R
            [-120.0, 135.0],  # beta
            [-72.0, 145.0],  # PPII
            [57.0, 39.0],  # alpha-L
        ]
    )
).astype(np.float32)
_RAMA_W = np.array([0.45, 0.25, 0.25, 0.05], np.float32)
_RAMA_KAPPA = np.array(
    [[4.0, 4.0], [2.0, 2.0], [3.0, 3.0], [5.0, 5.0]], np.float32
)


@functools.lru_cache(maxsize=None)
def _rama_params(device):
    """(mu, log w, kappa) of the Ramachandran mixture on `device`."""
    w = torch.from_numpy(_RAMA_W).to(device)
    return (torch.from_numpy(_RAMA_MU).to(device), torch.log(w),
            torch.from_numpy(_RAMA_KAPPA).to(device))


def rama_energy(phi, psi):
    """Smooth Ramachandran prior: -log of a von Mises mixture over the
    allowed basins. phi, psi: (..., L). Returns (...,)."""
    mu, logw, kap = _rama_params(phi.device)
    # (..., L, K) log-density per basin (unnormalized)
    lp = (
        kap[:, 0] * (torch.cos(phi[..., None] - mu[:, 0]) - 1.0)
        + kap[:, 1] * (torch.cos(psi[..., None] - mu[:, 1]) - 1.0)
        + logw
    )
    return -torch.sum(torch.logsumexp(lp, dim=-1), dim=-1)


def rama_energy_cartesian(bb):
    """rama_energy on torsions measured from Cartesian coordinates
    (differentiable through dihedral4); interior residues only."""
    n, ca, c = bb[..., 0, :], bb[..., 1, :], bb[..., 2, :]
    phi = dihedral4(c[..., :-1, :], n[..., 1:, :], ca[..., 1:, :],
                    c[..., 1:, :])  # residues 1..L-1
    psi = dihedral4(n[..., :-1, :], ca[..., :-1, :], c[..., :-1, :],
                    n[..., 1:, :])  # residues 0..L-2
    return rama_energy(phi[..., :-1], psi[..., 1:])  # residues 1..L-2


def _unit(v):
    return v / torch.sqrt(torch.sum(v * v, -1, keepdim=True) + 1e-12)


def backbone_o_positions(bb):
    """Carbonyl O placed from the peptide-plane geometry: in the C(i) frame,
    opposite the C(i)->N(i+1) direction, 1.231 A. Last residue's O uses the
    psi-plane fallback."""
    n, ca, c = bb[..., 0, :], bb[..., 1, :], bb[..., 2, :]
    last = 2 * c[..., -1:, :] - ca[..., -1:, :]
    nn = torch.cat([n[..., 1:, :], last], dim=-2)
    bis = _unit(_unit(ca - c) + _unit(nn - c))
    return c - 1.231 * bis


def hbond_energy(bb, d0=2.95, d_sigma=0.35, sep_min=2):
    """Backbone H-bond well: attractive Gaussian well on donor N(i) ...
    acceptor O(j) distance, gated by the N-H...O collinearity (H placed
    ideally opposite the N neighbors' bisector) and capped at one bond per
    donor (best-well max). Returns a NEGATIVE number per element."""
    n, ca, c = bb[..., 0, :], bb[..., 1, :], bb[..., 2, :]
    o = backbone_o_positions(bb)
    L = bb.shape[-3]

    # ideal amide H direction: opposite bisector of (CA-N, C_prev-N)
    first = 2 * n[..., :1, :] - ca[..., :1, :]
    cprev = torch.cat([first, c[..., :-1, :]], dim=-2)
    hdir = _unit(-(_unit(ca - n) + _unit(cprev - n)))

    rel = o[..., None, :, :] - n[..., :, None, :]  # donor i, acceptor j
    d = torch.sqrt(torch.sum(rel * rel, -1) + 1e-12)
    relu = rel / d[..., None]
    colin = torch.sum(relu * hdir[..., :, None, :], -1)  # cos(N->O vs N-H)
    well = (torch.exp(-(((d - d0) / d_sigma) ** 2))
            * torch.clamp(colin, 0.0, 1.0) ** 2)

    idx = torch.arange(L, device=bb.device)
    sep_ok = torch.abs(idx[:, None] - idx[None, :]) >= sep_min
    well = torch.where(sep_ok, well, 0.0)
    # one H-bond per donor; amax splits the gradient evenly between tied
    # acceptors (wells that underflow to 0), as JAX's max does
    per_donor = torch.amax(well, dim=-1)
    return -torch.sum(per_donor, dim=-1)


def clash_energy(bb, r_clash=4.0):
    """Soft CA-CA clash repulsion (the centroid vdw term's role)."""
    ca = bb[..., 1, :]
    L = ca.shape[-2]
    diff = ca[..., :, None, :] - ca[..., None, :, :]
    d = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)
    idx = torch.arange(L, device=bb.device)
    nonadj = torch.abs(idx[:, None] - idx[None, :]) >= 2
    viol = torch.clamp(r_clash - d, min=0.0)
    return _pair_sum(nonadj, viol * viol) / 2.0
