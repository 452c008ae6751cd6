"""Secondary structure from CA coordinates (counterpart of
text2protein_tpu/data/ss.py, the port's own copy).

`annotate_sse` is P-SEA (Labesse et al. 1997, CABIOS 13:291-295): helix,
strand or coil per residue from CA-only geometry (the distances d2/d3/d4,
the angle tau and the dihedral alpha). `get_coarse_constraints` turns runs
of >= 4 helix or strand residues into the three pair-map channels of the
C=8 layout (helix-pair, beta-pair, block-adjacency) and an "s:e,s:e" block
string for training-time block dropout; `parse_ss_spans` turns that string
into a fixed-shape span array.
"""

from __future__ import annotations

import numpy as np

# P-SEA thresholds (angles in radians, distances in Angstrom)
_R_HELIX = (np.deg2rad(89 - 12), np.deg2rad(89 + 12))
_A_HELIX = (np.deg2rad(50 - 20), np.deg2rad(50 + 20))
_D3_HELIX = (5.3 - 0.5, 5.3 + 0.5)
_D4_HELIX = (6.4 - 0.6, 6.4 + 0.6)

_R_STRAND = (np.deg2rad(124 - 14), np.deg2rad(124 + 14))
_A_STRAND = (np.deg2rad(-180.0), np.deg2rad(-125.0), np.deg2rad(145.0),
             np.deg2rad(180.0))
_D2_STRAND = (6.7 - 0.6, 6.7 + 0.6)
_D3_STRAND = (9.9 - 0.9, 9.9 + 0.9)
_D4_STRAND = (12.4 - 1.1, 12.4 + 1.1)


def _angle(a, b, c):
    v = a - b
    w = c - b
    cos = np.dot(v, w) / (np.linalg.norm(v) * np.linalg.norm(w))
    return np.arccos(np.clip(cos, -1.0, 1.0))


def _dihedral(a, b, c, d):
    b0 = -(b - a)
    b1 = c - b
    b2 = d - c
    b1 = b1 / np.linalg.norm(b1)
    v = b0 - np.dot(b0, b1) * b1
    w = b2 - np.dot(b2, b1) * b1
    x = np.dot(v, w)
    y = np.dot(np.cross(b1, v), w)
    return np.arctan2(y, x)


def _in(val, lo, hi):
    """lo <= val <= hi; a NaN (a measure that does not exist at the chain's
    ends) is never inside."""
    return (not np.isnan(val)) and lo <= val <= hi


def annotate_sse(ca: np.ndarray) -> np.ndarray:
    """P-SEA secondary structure of one chain.

    ca: (L, 3) CA coordinates in sequence order. Returns (L,) of 'a'
    (helix), 'b' (strand), 'c' (coil)."""
    ca = np.asarray(ca, dtype=np.float64)
    L = len(ca)
    d2 = np.full(L, np.nan)
    d3 = np.full(L, np.nan)
    d4 = np.full(L, np.nan)
    r = np.full(L, np.nan)
    a = np.full(L, np.nan)
    for i in range(L):
        if 0 <= i - 1 and i + 1 < L:
            d2[i] = np.linalg.norm(ca[i + 1] - ca[i - 1])
            r[i] = _angle(ca[i - 1], ca[i], ca[i + 1])
        if 0 <= i - 1 and i + 2 < L:
            d3[i] = np.linalg.norm(ca[i + 2] - ca[i - 1])
            a[i] = _dihedral(ca[i - 1], ca[i], ca[i + 1], ca[i + 2])
        if 0 <= i - 1 and i + 3 < L:
            d4[i] = np.linalg.norm(ca[i + 3] - ca[i - 1])

    sse = np.full(L, "c", dtype="U1")

    # helices: runs of >= 5 residues meeting (d3 and d4) or (r and a)
    pot_helix = np.zeros(L, dtype=bool)
    for i in range(L):
        if (_in(d3[i], *_D3_HELIX) and _in(d4[i], *_D4_HELIX)) or (
                _in(r[i], *_R_HELIX) and _in(a[i], *_A_HELIX)):
            pot_helix[i] = True

    is_helix = np.zeros(L, dtype=bool)
    counter = 0
    for i in range(L + 1):
        if i < L and pot_helix[i]:
            counter += 1
        else:
            if counter >= 5:
                is_helix[i - counter: i] = True
            counter = 0

    # one residue more at each end where the d3 or the r criterion holds
    for i in range(L):
        if is_helix[i]:
            sse[i] = "a"
            if i - 1 >= 0 and (_in(d3[i - 1], *_D3_HELIX)
                               or _in(r[i - 1], *_R_HELIX)):
                sse[i - 1] = "a"
            if i + 1 < L and (_in(d3[i + 1], *_D3_HELIX)
                              or _in(r[i + 1], *_R_HELIX)):
                sse[i + 1] = "a"

    # strands: runs of >= 4 residues meeting (d2, d3 and d4) or (r and a);
    # a run of 3 counts when in CA contact (4.2-5.2 A) with >= 5 other
    # potential strand residues
    pot_strand = np.zeros(L, dtype=bool)
    for i in range(L):
        if (_in(d2[i], *_D2_STRAND) and _in(d3[i], *_D3_STRAND)
                and _in(d4[i], *_D4_STRAND)) or (
                _in(r[i], *_R_STRAND)
                and (_in(a[i], _A_STRAND[0], _A_STRAND[1])
                     or _in(a[i], _A_STRAND[2], _A_STRAND[3]))):
            pot_strand[i] = True

    pot_strand_coord = ca[pot_strand]
    is_strand = np.zeros(L, dtype=bool)
    counter = 0
    contacts = 0
    for i in range(L + 1):
        if i < L and pot_strand[i]:
            counter += 1
            dists = np.linalg.norm(pot_strand_coord - ca[i], axis=-1)
            contacts += int(np.sum((dists > 4.2) & (dists < 5.2)))
        else:
            if counter >= 4 or (counter == 3 and contacts >= 5):
                is_strand[i - counter: i] = True
            counter = 0
            contacts = 0

    for i in range(L):
        if is_strand[i]:
            sse[i] = "b"
            if i - 1 >= 0 and _in(d3[i - 1], *_D3_STRAND):
                sse[i - 1] = "b"
            if i + 1 < L and _in(d3[i + 1], *_D3_STRAND):
                sse[i + 1] = "b"

    return sse


def get_coarse_constraints(ca: np.ndarray, cb_dist_norm: np.ndarray,
                           dist_threshold: float = 7, dmax: float = 20):
    """The SS block pair-map channels and the block span string.

    ca: (L_chain, 3) CA coordinates of the first chain (residues with a
    CA); cb_dist_norm: (L, L) normalized Cb-Cb distance map (channel 0);
    dist_threshold: the block-adjacency Cb distance in Angstrom.
    Returns (constraints (L, L, 3), "s:e,s:e"), or (None, None) when the
    annotation covers another number of residues than the map (missing
    CAs, several chains): such proteins are skipped. A block [s, e] fills
    the end-exclusive slice [s:e]."""

    def consecutive(data, stepsize=1):
        return np.split(data, np.where(np.diff(data) != stepsize)[0] + 1)

    dist_threshold_norm = (dist_threshold / dmax * 2) - 1

    s = annotate_sse(ca)
    if len(s) != cb_dist_norm.shape[0]:
        return None, None
    psea_to_index = {"a": 1, "b": 2, "c": 3}
    s = np.array([psea_to_index[i] for i in s])

    helix_indices = (s == 1).nonzero()[0]
    beta_indices = (s == 2).nonzero()[0]

    helix_split = [i for i in consecutive(helix_indices) if len(i) >= 4]
    beta_split = [i for i in consecutive(beta_indices) if len(i) >= 4]

    helix_mask_pair = np.zeros(cb_dist_norm.shape)
    for i in helix_split:
        start, end = i[0], i[-1]
        helix_mask_pair[start:end, start:end] = 1

    beta_mask_pair = np.zeros(cb_dist_norm.shape)
    for i1 in beta_split:
        for i2 in beta_split:
            beta_mask_pair[i1[0]: i1[-1], i2[0]: i2[-1]] = 1

    blocks = helix_split + beta_split
    block_adj_mask = np.zeros(cb_dist_norm.shape)
    for idx1, b1 in enumerate(blocks):
        for idx2, b2 in enumerate(blocks):
            if idx1 == idx2:
                continue
            sub = cb_dist_norm[b1[0]: b1[-1], b2[0]: b2[-1]]
            if sub.size and sub.min() < dist_threshold_norm:
                block_adj_mask[b1[0]: b1[-1], b2[0]: b2[-1]] = 1

    constraints = np.stack([helix_mask_pair, beta_mask_pair, block_adj_mask],
                           axis=-1)
    helix_beta_str = ",".join(f"{i[0]}:{i[-1]}" for i in blocks)
    return constraints, helix_beta_str


def parse_ss_spans(ss_indices: str, max_blocks: int) -> np.ndarray:
    """An "s:e,s:e" block string -> a (max_blocks, 2) int32 array, padded
    with -1."""
    spans = np.full((max_blocks, 2), -1, dtype=np.int32)
    if ss_indices:
        for i, tok in enumerate(ss_indices.split(",")[:max_blocks]):
            s, e = tok.split(":")
            spans[i] = (int(s), int(e))
    return spans
