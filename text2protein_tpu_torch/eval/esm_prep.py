"""ESM inverse-folding inputs from designed backbones (the port's copy of
text2protein_tpu/eval/esm_prep.py, which is numpy-only): per-chain N/CA/C
coordinates with the sequence, as ESM-IF1's `load_coords` returns them,
and a CA-CA contact map.
"""

from __future__ import annotations

import numpy as np

from ..data.pdbio import read_pdb
from ..data.vocab import NON_STANDARD_TO_STANDARD, THREE_TO_ONE


def load_coords(path, chain="A"):
    """(L, 3, 3) N/CA/C coordinates (a missing atom NaN) and the sequence
    of one chain."""
    st = read_pdb(path).filter_chain(chain)
    residues = st.amino_residues()
    coords = np.full((len(residues), 3, 3), np.nan, dtype=np.float64)
    seq = []
    for i, r in enumerate(residues):
        name = (r.name if r.name in THREE_TO_ONE
                else NON_STANDARD_TO_STANDARD.get(r.name, "UNK"))
        seq.append(THREE_TO_ONE[name])
        for j, a in enumerate(("N", "CA", "C")):
            c = r.atom(a)
            if c is not None:
                coords[i, j] = c
    return coords, "".join(seq)


def contact_map(coords, threshold=8.0):
    """CA-CA contacts closer than `threshold` A, from (L, 3, 3) coords."""
    ca = coords[:, 1]
    d = np.linalg.norm(ca[:, None] - ca[None, :], axis=-1)
    return (d < threshold) & np.isfinite(d)
