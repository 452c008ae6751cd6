"""Synthetic protein backbones with ideal covalent geometry (counterpart of
text2protein_tpu/data/synthetic.py).

Structures are built in torsion space through the NeRF chain builder
(`realize/geometry.build_backbone`), so bond lengths/angles are exactly
ideal and 6D featurization (`data/featurize.py`) produces self-consistent
maps. Longer chains are compacted to a native-like radius of gyration by
the port's L-BFGS on the device. (`data/helix_records.py` is a separate,
cheaper generator for training records.)
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device

# Canonical alpha-helix torsions (deg).
_HELIX_PHI, _HELIX_PSI = -61.0, -41.0

# Turn-segment torsion sets (deg) that reverse chain direction compactly;
# found by direct search over 4-residue turns minimizing radius of gyration
# of a 3-helix bundle without steric clashes.
_TURNS = np.array(
    [
        [[112.5, -119.4], [107.0, 166.5], [6.1, -87.9], [-122.1, 150.0]],
        [[-63.2, -1.1], [-24.0, -23.3], [95.5, 156.7], [49.2, 164.6]],
    ]
)


def default_n_helices(L: int) -> int:
    """Length-scaled helix count used by `helix_bundle_torsions`."""
    return max(2, min(6, round(L / 22)))


def valid_helix_counts(L: int) -> list[int]:
    """Helix counts buildable at length L with sane segment lengths (each
    helix segment between ~12 and ~40 residues)."""
    n_min = max(2, -(-(L + 4) // 44))   # segment <= 40
    n_max = min(6, (L + 4) // 16)       # segment >= 12
    return list(range(n_min, max(n_min, n_max) + 1))


def helix_bundle_torsions(L: int, seed: int = 0, n_helices: int | None = None,
                          jitter_deg: float = 3.0,
                          vary_placement: bool = False):
    """(phi, psi) in radians for a compact L-residue helix bundle.

    Helix segments use canonical torsions; turns are drawn from the searched
    turn table; everything gets a small jitter so different seeds give
    different (but still compact) structures. `vary_placement` randomizes
    the per-helix segment lengths (>=5 residues each) instead of the equal
    split.
    """
    rng = np.random.RandomState(seed)
    if n_helices is None:
        n_helices = default_n_helices(L)
    n_turn = 4
    total_seg = L - (n_helices - 1) * n_turn
    if vary_placement:
        # random composition of total_seg into n_helices parts, each >= 5
        min_seg = 5
        free = max(total_seg - n_helices * min_seg, 0)
        cuts = np.sort(rng.randint(0, free + 1, n_helices - 1))
        parts = np.diff(np.concatenate([[0], cuts, [free]]))
        seg_lens = [min_seg + int(p) for p in parts]
    else:
        seg_lens = [total_seg // n_helices] * n_helices
    phi, psi = [], []
    for h in range(n_helices):
        n_seg = seg_lens[h] if h < n_helices - 1 else (L - len(phi))
        phi += [_HELIX_PHI] * n_seg
        psi += [_HELIX_PSI] * n_seg
        if h < n_helices - 1:
            t = _TURNS[rng.randint(len(_TURNS))]
            phi += list(t[:, 0])
            psi += list(t[:, 1])
    phi = np.asarray(phi[:L], np.float64)
    psi = np.asarray(psi[:L], np.float64)
    phi += rng.randn(L) * jitter_deg
    psi += rng.randn(L) * jitter_deg
    return np.deg2rad(phi).astype(np.float32), np.deg2rad(psi).astype(
        np.float32
    )


def _compact_run(bb0, rg_target, iters: int = 300):
    """Rg-guided compaction of a batch of (B, L, 3, 3) backbones: pulls each
    bundle to a native-like radius of gyration (Rg ~ 2.2 L^0.38) while
    clash, covalent-geometry, Ramachandran and H-bond terms keep it
    physical; a final pass releases the Rg pull and re-idealizes."""
    from ..realize.lbfgs import lbfgs_minimize
    from ..realize.restraints import (
        bonded_energy, clash_energy, hbond_energy, rama_energy_cartesian,
    )

    L = bb0.shape[-3]

    def e_compact(bb):
        ca = bb[..., 1, :]
        centered = ca - ca.mean(-2, keepdim=True)
        rg = torch.sqrt(torch.mean(torch.sum(centered**2, -1), -1) + 1e-9)
        return (
            30.0 * torch.clamp(rg - rg_target, min=0.0) ** 2 * L
            + 20.0 * clash_energy(bb)
            + 1.0 * bonded_energy(bb)
            + 1.0 * rama_energy_cartesian(bb)
            + 10.0 * hbond_energy(bb)
        )

    def e_polish(bb):
        return (
            20.0 * clash_energy(bb)
            + 2.0 * bonded_energy(bb, 0.01, 0.017, 0.05)
            + 1.0 * rama_energy_cartesian(bb)
            + 10.0 * hbond_energy(bb)
        )

    bb = lbfgs_minimize(e_compact, bb0, iters)
    return lbfgs_minimize(e_polish, bb, iters // 2)


def _build(phis, psis, device):
    from ..realize.geometry import build_backbone

    with torch.no_grad():
        return build_backbone(torch.from_numpy(np.stack(phis)).to(device),
                              torch.from_numpy(np.stack(psis)).to(device))


def _candidate_scores(ca):
    """Host scoring of (..., L, 3) candidate CA traces: clash-free,
    compact, many long-range contacts — so the 6D distance map actually
    determines the fold (an elongated bundle's map does not)."""
    L = ca.shape[-2]
    d = np.linalg.norm(ca[..., :, None, :] - ca[..., None, :, :], axis=-1)
    sep = np.abs(np.arange(L)[:, None] - np.arange(L)[None, :])
    # each clash appears twice in the symmetric matrix
    clashes = ((d < 3.6) & (sep >= 3)).sum((-1, -2)) // 2
    rg = np.sqrt(((ca - ca.mean(-2, keepdims=True)) ** 2).sum(-1).mean(-1))
    contact = ((d < 12) & (sep >= 8)).mean((-1, -2))
    return rg - 60.0 * contact + 100.0 * clashes


def helix_bundle_backbone(L: int, seed: int = 0, n_candidates: int = 12,
                          compact: bool | None = None, device=None):
    """(L, 3, 3) ideal-geometry backbone of a compact helix bundle.

    Builds `n_candidates` torsion samples and keeps the most protein-like
    one (`_candidate_scores`). For longer chains (or with `compact=True`)
    an Rg-guided compaction pass on `device` (default CUDA) packs the
    helices to a native-like Rg.
    """
    return helix_bundle_backbones(L, [seed], n_candidates, compact,
                                  device=device)[0]


def helix_bundle_backbones(L: int, seeds, n_candidates: int = 12,
                           compact: bool | None = None,
                           compact_iters: int = 300, n_helices=None,
                           vary_placement: bool = False, device=None):
    """(len(seeds), L, 3, 3) helix-bundle backbones of equal length, built
    and compacted as one batch on `device` (default CUDA).

    `n_helices`: None (length-scaled default), an int, or a per-seed list —
    the per-seed form lets one batch mix helix counts at equal L."""
    dev = resolve_device(device)
    seeds = list(seeds)
    if n_helices is None or isinstance(n_helices, int):
        n_helices = [n_helices] * len(seeds)
    if len(n_helices) != len(seeds):
        raise ValueError("n_helices needs one entry per seed")
    phis, psis = [], []
    for s, nh in zip(seeds, n_helices):
        for k in range(n_candidates):
            phi, psi = helix_bundle_torsions(L, seed=s + 1000 * k,
                                             n_helices=nh,
                                             vary_placement=vary_placement)
            phis.append(phi)
            psis.append(psi)
    bbs = _build(phis, psis, dev).cpu().numpy().reshape(
        len(seeds), n_candidates, L, 3, 3)
    score = _candidate_scores(bbs[..., 1, :])
    best = np.take_along_axis(
        bbs, score.argmin(1)[:, None, None, None, None], axis=1
    )[:, 0]

    if compact is None:
        compact = L >= 72
    if not compact:
        return best
    rg_target = 2.2 * L**0.38
    out = _compact_run(torch.from_numpy(best).to(dev), rg_target,
                       compact_iters)
    return out.cpu().numpy()


def helix_bundle_dataset(num: int, n_max: int, seed: int = 0,
                         min_len: int = 16, ss_constraints: bool = False,
                         device=None):
    """List of featurized records {coords_6d (C,L,L), mask_pair, L, bb,
    ss_indices} for synthetic-bundle training."""
    from .featurize import featurize_structure

    rng = np.random.RandomState(seed)
    records = []
    i = 0
    while len(records) < num:
        L = int(rng.randint(max(min_len, n_max // 2), n_max + 1))
        bb = helix_bundle_backbone(L, seed=seed * 77777 + i, device=device)
        i += 1
        c6d, mask_pair, ss_indices = featurize_structure(
            bb, np.ones(L), ss_constraints=ss_constraints
        )
        if c6d is None:
            continue
        records.append(
            {"coords_6d": c6d, "mask_pair": mask_pair, "L": L, "bb": bb,
             "ss_indices": ss_indices}
        )
    return records
