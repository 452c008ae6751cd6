"""Fixed-backbone sequence design, the FastDesign role (the port's copy of
text2protein_tpu/realize/design.py, which is numpy-only).

A centroid-level knowledge-based design energy over the 20 amino acids,
optimized by simulated-annealing Gibbs sweeps (a Potts model over the
contact graph — the same mathematical shape as packer design without
explicit rotamers).

Energy terms (all tables are standard published biophysics, encoded inline):

  * burial x hydropathy  — Kyte-Doolittle hydropathy rewarded at buried
    positions (CB-neighbor count) and penalized at exposed ones; the
    centroid `env` term's role.
  * SS propensity        — helix: Pace-Scholtz helix-propensity ddG;
    strand: Chou-Fasman P-beta; coil: flexibility preferences (G/P/N/D/S).
  * backbone rama gate   — positive-phi positions admit only G (and N/D);
    PRO penalized inside helices/strands away from their N-termini.
  * reference energies   — per-AA background log-frequencies (the Rosetta
    `ref` term's role), centering design compositions on natural ones.
  * pair term            — charge-charge on contacting (<8 A CB) pairs,
    screened by burial (salt bridges favorable, like-charge penalized);
    the centroid `pair` term's role.
"""

from __future__ import annotations

import numpy as np

# Alphabetical 1-letter ordering, private to this module.
AA20 = "ACDEFGHIKLMNPQRSTVWY"
_IDX = {a: i for i, a in enumerate(AA20)}

# Kyte-Doolittle hydropathy (J Mol Biol 157:105, 1982), normalized to [-1, 1].
_KD = {
    "I": 4.5, "V": 4.2, "L": 3.8, "F": 2.8, "C": 2.5, "M": 1.9, "A": 1.8,
    "G": -0.4, "T": -0.7, "S": -0.8, "W": -0.9, "Y": -1.3, "P": -1.6,
    "H": -3.2, "E": -3.5, "Q": -3.5, "D": -3.5, "N": -3.5, "K": -3.9,
    "R": -4.5,
}
HYD = np.array([_KD[a] / 4.5 for a in AA20], np.float32)

# Pace-Scholtz helix propensity ddG (kcal/mol; 0 = best, Biophys J 75:422).
_HELIX_DDG = {
    "A": 0.0, "L": 0.21, "R": 0.21, "M": 0.24, "K": 0.26, "Q": 0.39,
    "E": 0.40, "I": 0.41, "W": 0.49, "S": 0.50, "Y": 0.53, "F": 0.54,
    "H": 0.61, "V": 0.61, "N": 0.65, "T": 0.66, "C": 0.68, "D": 0.69,
    "G": 1.0, "P": 3.16,
}
HELIX = np.array([_HELIX_DDG[a] for a in AA20], np.float32)

# Chou-Fasman beta-sheet propensity P_beta (higher = more strand-like).
_CF_BETA = {
    "V": 1.70, "I": 1.60, "Y": 1.47, "F": 1.38, "W": 1.37, "L": 1.30,
    "C": 1.19, "T": 1.19, "Q": 1.10, "M": 1.05, "R": 0.93, "N": 0.89,
    "H": 0.87, "A": 0.83, "S": 0.75, "G": 0.75, "K": 0.74, "P": 0.55,
    "D": 0.54, "E": 0.37,
}
BETA = np.array([_CF_BETA[a] for a in AA20], np.float32)

# Coil/turn preference (flexible + turn-forming residues favored).
_COIL = {
    "G": -0.9, "N": -0.55, "D": -0.55, "S": -0.5, "P": -0.45, "T": -0.2,
    "A": 0.0, "E": 0.0, "K": 0.0, "Q": 0.0, "R": 0.1, "H": 0.1, "C": 0.2,
    "L": 0.35, "M": 0.3, "V": 0.4, "I": 0.45, "F": 0.45, "Y": 0.3,
    "W": 0.4,
}
COIL = np.array([_COIL[a] for a in AA20], np.float32)

# Background AA frequencies in globular proteins (UniProt-style composition).
_BG = {
    "A": 0.083, "R": 0.055, "N": 0.041, "D": 0.055, "C": 0.014, "Q": 0.039,
    "E": 0.067, "G": 0.071, "H": 0.023, "I": 0.059, "L": 0.097, "K": 0.058,
    "M": 0.024, "F": 0.039, "P": 0.047, "S": 0.066, "T": 0.054, "W": 0.011,
    "Y": 0.029, "V": 0.069,
}
REF = np.array([-np.log(_BG[a] * 20.0) for a in AA20], np.float32)

# Net charge at pH 7 (His ~ +0.1).
CHARGE = np.array(
    [{"D": -1.0, "E": -1.0, "K": 1.0, "R": 1.0, "H": 0.1}.get(a, 0.0)
     for a in AA20], np.float32,
)

# Default term weights — calibrated once against the synthetic-native
# benchmark (the JAX package's scripts/eval_design.py) and then frozen.
WEIGHTS = {
    "burial": 2.6,    # hydropathy x (burial - midpoint)
    "helix": 1.5,
    "beta": 1.0,
    "coil": 1.0,
    "ref": 0.9,
    "rama": 3.0,
    "pair": 0.8,
}

# Per-AA reference offsets fit so unconstrained design reproduces the
# native set's composition (the JAX package's scripts/fit_design_ref.py —
# the Rosetta
# `ref`-fitting procedure); regenerate with the script.
REF_OFFSET = np.array([
    +0.1487, -0.0562, +0.4953, +0.7123, -0.5133,
    +0.4701, -0.2415, -0.2732, +0.7483, +0.2808,
    -0.2716, -0.2101, -0.3564, -0.4764, +0.9039,
    -0.0391, -0.5232, -0.5073, -0.0489, -0.2423,
], np.float32)


def cb_coords(bb: np.ndarray) -> np.ndarray:
    """Idealized CB from N/CA/C — the featurizer's formula; GLY positions
    still get a
    virtual CB (standard for centroid design)."""
    n, ca, c = bb[:, 0], bb[:, 1], bb[:, 2]
    b = ca - n
    cc = c - ca
    a = np.cross(b, cc)
    return (-0.58273431 * a + 0.56802827 * b - 0.54067466 * cc + ca)


def burial_fraction(bb: np.ndarray, radius: float = 10.0,
                    midpoint: float | None = None,
                    slope: float = 3.0) -> np.ndarray:
    """(L,) soft burial in [0, 1]: sigmoid of the CB-neighbor count within
    `radius` A (|i-j| >= 2). ~0 on the surface, ~1 in the core.

    The midpoint defaults to the structure's own 60th-percentile neighbor
    count: raw counts scale with chain length (a compact L=128 bundle
    averages ~17 neighbors vs ~10 at L=64), while the surface/core split of
    real globular proteins stays near 30-40% core at any size — burial is a
    relative, per-structure partition."""
    cb = cb_coords(bb)
    d = np.linalg.norm(cb[:, None] - cb[None, :], axis=-1)
    L = len(cb)
    sep = np.abs(np.arange(L)[:, None] - np.arange(L)[None, :])
    n_nb = ((d < radius) & (sep >= 2)).sum(1).astype(np.float32)
    if midpoint is None:
        midpoint = float(np.quantile(n_nb, 0.6))
    return 1.0 / (1.0 + np.exp(-(n_nb - midpoint) / slope))


def dihedral(p0, p1, p2, p3):
    """Batched dihedral angle (praxeolitic formula: b0 points BACK from p1
    to p0); shared by backbone_phi here and design_learned.backbone_psi."""
    b0, b1, b2 = p0 - p1, p2 - p1, p3 - p2
    b1 = b1 / (np.linalg.norm(b1, axis=-1, keepdims=True) + 1e-9)
    v = b0 - (b0 * b1).sum(-1, keepdims=True) * b1
    w = b2 - (b2 * b1).sum(-1, keepdims=True) * b1
    x = (v * w).sum(-1)
    y = (np.cross(b1, v) * w).sum(-1)
    return np.arctan2(y, x)


def backbone_phi(bb: np.ndarray) -> np.ndarray:
    """(L,) phi dihedrals in radians (first set to -pi/3)."""
    n, ca, c = bb[:, 0], bb[:, 1], bb[:, 2]
    phi = np.full(len(bb), -np.pi / 3)
    phi[1:] = dihedral(c[:-1], n[1:], ca[1:], c[1:])
    return phi


def position_energies(bb: np.ndarray, ss: np.ndarray | None = None,
                      weights: dict | None = None) -> np.ndarray:
    """(L, 20) per-position design energies (everything but the pair term)."""
    from ..data.ss import annotate_sse

    w = dict(WEIGHTS)
    ref_offset = REF_OFFSET
    if weights:
        weights = dict(weights)
        if "ref_offset" in weights:
            ref_offset = np.asarray(weights.pop("ref_offset"), np.float32)
        w.update(weights)
    L = len(bb)
    if ss is None:
        ss = annotate_sse(bb[:, 1])
    burial = burial_fraction(bb)
    phi = backbone_phi(bb)

    e = np.zeros((L, 20), np.float32)
    helix_m = (ss == "a")
    strand_m = (ss == "b")
    coil_m = ~(helix_m | strand_m)
    # burial x hydropathy (midpoint 0.45: slightly exposed-leaning neutral);
    # damped at coil/turn positions, whose sidechains point out of the turn
    # regardless of neighbor density (natives keep G/P/N/D in buried turns)
    bur_scale = np.where(coil_m, 0.4, 1.0)[:, None]
    e += -w["burial"] * bur_scale * (burial[:, None] - 0.45) * HYD[None, :]
    e[helix_m] += w["helix"] * HELIX[None, :]
    e[strand_m] += w["beta"] * (1.2 - BETA)[None, :]
    e[coil_m] += w["coil"] * COIL[None, :]
    e += (w["ref"] * REF + ref_offset)[None, :]

    # rama gate: positive phi admits G (and to a lesser degree N/D)
    pos_phi = phi > np.deg2rad(30.0)
    gate = np.full(20, w["rama"], np.float32)
    gate[_IDX["G"]] = -0.5
    gate[_IDX["N"]] = 0.5 * w["rama"]
    gate[_IDX["D"]] = 0.5 * w["rama"]
    e[pos_phi] += gate[None, :]

    # PRO breaks H-bonding inside helices/strands (allowed at helix N-cap)
    inside = helix_m | strand_m
    inside[1:] &= inside[:-1]  # not the segment's first residue
    e[inside, _IDX["P"]] += 2.0

    # lone CYS suppression: without an explicit disulfide search, extra
    # penalty beyond background keeps free cysteines rare (as design does)
    e[:, _IDX["C"]] += 0.8
    return e


def contact_pairs(bb: np.ndarray, cutoff: float = 8.0):
    """Upper-triangle contacting pairs (i, j, screen): CB distance < cutoff,
    |i-j| >= 3; `screen` in (0, 1] scales charge interactions by exposure
    (salt bridges matter most on the surface)."""
    cb = cb_coords(bb)
    L = len(cb)
    d = np.linalg.norm(cb[:, None] - cb[None, :], axis=-1)
    sep = np.abs(np.arange(L)[:, None] - np.arange(L)[None, :])
    ii, jj = np.nonzero((d < cutoff) & (sep >= 3))
    keep = ii < jj
    ii, jj = ii[keep], jj[keep]
    burial = burial_fraction(bb)
    screen = 1.0 - 0.5 * ((burial[ii] + burial[jj]) / 2.0)
    return ii, jj, screen.astype(np.float32)


def design_sequence(bb: np.ndarray, seed: int = 0, n_sweeps: int = 60,
                    t_start: float = 1.0, t_end: float = 0.05,
                    fix_mask: np.ndarray | None = None,
                    fixed_seq: str | None = None,
                    weights: dict | None = None):
    """Design a sequence onto a fixed backbone by annealed Gibbs sampling.

    Args:
      bb: (L, 3, 3) N/CA/C backbone.
      fix_mask: (L,) bool — True positions are held at `fixed_seq` (the
        FastDesign `designable` selector role for motif scaffolding).
    Returns:
      (sequence str, {"total": float, "position": float, "pair": float}).
    """
    w = dict(WEIGHTS)
    if weights:
        w.update(weights)
    rng = np.random.RandomState(seed)
    L = len(bb)
    e_pos = position_energies(bb, weights=weights)
    ii, jj, screen = contact_pairs(bb)

    # pair energy matrix between AA classes: screened charge products
    pair_aa = w["pair"] * (CHARGE[:, None] * CHARGE[None, :])

    # neighbor lists per position
    nb = [[] for _ in range(L)]
    for k in range(len(ii)):
        nb[ii[k]].append((jj[k], screen[k]))
        nb[jj[k]].append((ii[k], screen[k]))

    seq = e_pos.argmin(1)
    if fix_mask is not None and fixed_seq is not None:
        fixed_idx = np.array([_IDX.get(ch, _IDX["A"]) for ch in fixed_seq])
        seq = np.where(fix_mask, fixed_idx, seq)

    def pos_delta(i):
        e = e_pos[i].copy()
        for j, s in nb[i]:
            e += s * pair_aa[:, seq[j]]
        return e

    order = np.arange(L)
    for sweep in range(n_sweeps):
        t = t_start * (t_end / t_start) ** (sweep / max(n_sweeps - 1, 1))
        rng.shuffle(order)
        for i in order:
            if fix_mask is not None and fix_mask[i]:
                continue
            e = pos_delta(i)
            p = np.exp(-(e - e.min()) / max(t, 1e-3))
            p /= p.sum()
            seq[i] = rng.choice(20, p=p)
    # final quench: greedy argmin pass
    for i in range(L):
        if fix_mask is not None and fix_mask[i]:
            continue
        seq[i] = pos_delta(i).argmin()

    e_position = float(e_pos[np.arange(L), seq].sum())
    e_pair = float(
        (screen * pair_aa[seq[ii], seq[jj]]).sum()
    )
    letters = "".join(AA20[a] for a in seq)
    return letters, {
        "total": e_position + e_pair,
        "position": e_position,
        "pair": e_pair,
    }


def design_score(bb: np.ndarray, seq: str, weights: dict | None = None):
    """Score an arbitrary sequence on a backbone with the design energy —
    the `ref2015` role in the realization CLI's before/after score
    split."""
    w = dict(WEIGHTS)
    if weights:
        w.update(weights)
    e_pos = position_energies(bb, weights=weights)
    ii, jj, screen = contact_pairs(bb)
    idx = np.array([_IDX.get(ch, _IDX["A"]) for ch in seq])
    pair_aa = w["pair"] * (CHARGE[:, None] * CHARGE[None, :])
    e_position = float(e_pos[np.arange(len(bb)), idx].sum())
    e_pair = float((screen * pair_aa[idx[ii], idx[jj]]).sum())
    return {"total": e_position + e_pair, "position": e_position,
            "pair": e_pair, "per_res": (e_position + e_pair) / len(bb)}
