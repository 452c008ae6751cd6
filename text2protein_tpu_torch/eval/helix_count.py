"""Alpha-helices counted from a 6D map's distance channel (the port's copy
of text2protein_tpu/eval/helix_count.py, which is numpy-only).

The distance channel holds d/10 - 1 for a Cb-Cb distance d in [0, 20] A.
`count_helices` counts chain reversals: a turn at t makes an anti-diagonal
contact streak d(t-k, t+k) < `dcut`; local maxima of that count, at least
`min_sep` apart, are the turns, and the helices are the turns plus one.
`helix_flags` / `helix_fraction` flag the i..i+4 steps shorter than
`thresh` A (a helix's d(i, i+4) is 5.5-6.5 A).
"""

from __future__ import annotations

import numpy as np


def helix_flags(c6d: np.ndarray, L: int, thresh: float = 7.5) -> np.ndarray:
    """(L-4,) bool: is the i..i+4 step helical, from a (C, N, N) map."""
    x = np.asarray(c6d)[0]  # dist channel, normalized d/10 - 1
    i = np.arange(L - 4)
    d = (np.clip(x[i, i + 4], -1.0, 1.0) + 1.0) * 10.0
    return d < thresh


def count_helices(c6d: np.ndarray, L: int, dcut: float = 12.0,
                  kmax: int = 8, kmin: int = 2, need: int = 6,
                  min_sep: int = 10) -> int:
    """Number of helices in a (C, N, N) 6D map of an L-residue chain
    (`helix_count.py:35-65`): a turn scores the k in [kmin, kmax] with
    d(t-k, t+k) < dcut; turns score at least `need`."""
    x = np.asarray(c6d)[0]
    d = (np.clip(x[:L, :L], -1.0, 1.0) + 1.0) * 10.0
    ks = np.arange(kmin, kmax + 1)
    score = np.zeros(L)
    t = np.arange(L)
    for k in ks:
        ok = (t - k >= 0) & (t + k < L)
        tt = t[ok]
        score[tt] += (d[tt - k, tt + k] < dcut)
    turns: list[int] = []
    for t0 in np.argsort(-score):
        if score[t0] < need:
            break
        if all(abs(int(t0) - u) >= min_sep for u in turns):
            turns.append(int(t0))
    return len(turns) + 1


def helix_fraction(c6d: np.ndarray, L: int, thresh: float = 7.5) -> float:
    """Fraction of i,i+4 steps that are helical, a coarse SS-content
    proxy."""
    f = helix_flags(c6d, L, thresh)
    return float(f.mean()) if f.size else 0.0
