"""TM-score of two structures: Kabsch superposition and DP alignment
(the port's copy of text2protein_tpu/eval/tmscore.py, which is numpy-only).

`tm_score` is the TM-align core (`tmscore.py:197-223`): gapless threads
and local-fragment windows as seed alignments, each of the best seeds
refined by alternating a Kabsch superposition of the aligned pairs with a
Needleman-Wunsch DP on the TM-score matrix. `run_tmalign` runs the repo's
native TM-align (`native/tmalign/tmalign`, shared with the JAX package,
built with `make -C native/tmalign`) and parses its output with the same
contract (`tmscore.py:232-248`); without the binary it scores in Python.
"""

from __future__ import annotations

import subprocess
from pathlib import Path

import numpy as np

from ..data.pdbio import read_pdb

# the repo's native TM-align, shared with the JAX package
_NATIVE_BINARY = (Path(__file__).resolve().parents[2] / "native" / "tmalign"
                  / "tmalign")


def d0_for_length(l_target: int) -> float:
    """Zhang & Skolnick normalization distance."""
    if l_target > 21:
        d0 = 1.24 * (l_target - 15) ** (1.0 / 3.0) - 1.8
    else:
        d0 = 0.5
    return max(d0, 0.5)


def kabsch(p: np.ndarray, q: np.ndarray):
    """Optimal rotation/translation superposing p onto q (both (L, 3)).

    Returns (R, t) with q ~ p @ R.T + t: Kabsch through an SVD.
    """
    pc = p.mean(axis=0)
    qc = q.mean(axis=0)
    h = (p - pc).T @ (q - qc)
    if not np.isfinite(h).all():
        return np.eye(3), qc - pc  # degenerate input: no rotation
    try:
        u, s, vt = np.linalg.svd(h)
    except np.linalg.LinAlgError:
        return np.eye(3), qc - pc
    d = np.sign(np.linalg.det(vt.T @ u.T))
    diag = np.diag([1.0, 1.0, d])
    r = vt.T @ diag @ u.T
    t = qc - pc @ r.T
    return r, t


def _tm_of_alignment(xa, ya, l_target, d0):
    """TM-score of already-paired coords (after optimal superposition on the
    best-scoring subset, via the standard iterative cutoff scheme)."""
    best = 0.0
    n = len(xa)
    if n < 3:
        return 0.0
    # iterative superposition on shrinking inlier sets (TM-score protocol)
    idx = np.arange(n)
    for d_cut in (d0 + 1.5, d0 + 0.5, d0, d0 - 0.5):
        d_cut = max(d_cut, 0.5)
        sel = idx
        for _ in range(10):
            if len(sel) < 3:
                break
            r, t = kabsch(xa[sel], ya[sel])
            xt = xa @ r.T + t
            dist = np.linalg.norm(xt - ya, axis=1)
            score = float(np.sum(1.0 / (1.0 + (dist / d0) ** 2)) / l_target)
            best = max(best, score)
            new_sel = idx[dist < d_cut]
            if len(new_sel) < 3 or np.array_equal(new_sel, sel):
                break
            sel = new_sel
    return best


def _nw_dp(score_mat, gap_open=-0.6):
    """Needleman-Wunsch with linear gap penalty; returns index pairs.

    Vectorized over anti-diagonals: cells on diagonal k depend only on
    diagonals k-1 (up/left) and k-2 (diag), so each diagonal is one numpy
    step — ~100x faster than the per-cell Python loop on L=256 pairs.
    """
    l1, l2 = score_mat.shape
    val = np.zeros((l1 + 1, l2 + 1))
    ptr = np.zeros((l1 + 1, l2 + 1), dtype=np.int8)  # 0 diag, 1 up, 2 left
    val[1:, 0] = gap_open * np.arange(1, l1 + 1)
    val[0, 1:] = gap_open * np.arange(1, l2 + 1)
    ptr[1:, 0] = 1
    ptr[0, 1:] = 2
    for k in range(2, l1 + l2 + 1):  # anti-diagonal index: i + j = k
        i_lo, i_hi = max(1, k - l2), min(l1, k - 1)
        if i_lo > i_hi:
            continue
        i = np.arange(i_lo, i_hi + 1)
        j = k - i
        d = val[i - 1, j - 1] + score_mat[i - 1, j - 1]
        u = val[i - 1, j] + gap_open
        l = val[i, j - 1] + gap_open
        best = np.maximum(d, np.maximum(u, l))
        p = np.where(d >= best, 0, np.where(u >= l, 1, 2)).astype(np.int8)
        val[i, j] = best
        ptr[i, j] = p
    pairs = []
    i, j = l1, l2
    while i > 0 and j > 0:
        p = ptr[i, j]
        if p == 0:
            pairs.append((i - 1, j - 1))
            i -= 1
            j -= 1
        elif p == 1:
            i -= 1
        else:
            j -= 1
    return pairs[::-1]


def _initial_alignments(x, y):
    """Candidate seed alignments, TM-align's gapless and fragment seeds:
    gapless threads at a stride ALWAYS including offset 0 and its
    neighborhood, plus fragment windows at several anchor positions."""
    l1, l2 = len(x), len(y)
    cands = []

    def thread(off):
        i0, j0 = max(0, -off), max(0, off)
        n = min(l1 - i0, l2 - j0)
        if n >= 5:
            cands.append(list(zip(range(i0, i0 + n), range(j0, j0 + n))))

    step = max(1, min(l1, l2) // 50)
    offsets = set(range(-(l1 - 5), l2 - 4, step))
    offsets.update((-2, -1, 0, 1, 2))  # identity neighborhood, always seeded
    for off in sorted(o for o in offsets if -(l1 - 5) <= o <= l2 - 5):
        thread(off)

    # fragment windows: short gapless pieces anchored at start/quarters/end
    f = max(5, min(l1, l2, 20))
    anchors1 = {0, max(0, l1 // 4 - f // 2), max(0, l1 // 2 - f // 2),
                max(0, 3 * l1 // 4 - f // 2), max(0, l1 - f)}
    anchors2 = {0, max(0, l2 // 2 - f // 2), max(0, l2 - f)}
    for a1 in anchors1:
        for a2 in anchors2:
            n = min(f, l1 - a1, l2 - a2)
            if n >= 5:
                cands.append(list(zip(range(a1, a1 + n), range(a2, a2 + n))))
    if not cands:
        # chains shorter than the 5-residue seed minimum: central gapless
        # thread so tiny fragments still score (>= 3 points for Kabsch)
        n = min(l1, l2)
        if n >= 3:
            cands.append(list(zip(range(n), range(n))))
    return cands


def _refine(x, y, pairs, l_target, d0, max_iter):
    """Iterative refinement: superpose on current pairs -> TM-score matrix ->
    NW DP -> new pairs. Returns the best TM seen."""
    best_tm = 0.0
    for _ in range(max_iter):
        idx = np.array(pairs)
        r, t = kabsch(x[idx[:, 0]], y[idx[:, 1]])
        xt = x @ r.T + t
        dist = np.linalg.norm(xt[:, None, :] - y[None, :, :], axis=-1)
        score_mat = 1.0 / (1.0 + (dist / d0) ** 2)
        new_pairs = _nw_dp(score_mat)
        if len(new_pairs) < 3:
            break
        idx = np.array(new_pairs)
        tm = _tm_of_alignment(x[idx[:, 0]], y[idx[:, 1]], l_target, d0)
        best_tm = max(best_tm, tm)
        if new_pairs == pairs:
            break
        pairs = new_pairs
    return best_tm


def tm_score(coords1, coords2, l_target: int | None = None, max_iter: int = 20,
             n_refine_seeds: int = 3):
    """TM-score of structure 1 vs structure 2 (CA coords, (L, 3) each),
    normalized by `l_target` (defaults to len(coords2), TM-align's
    normalization by chain 2).

    The top `n_refine_seeds` seed alignments are each refined with the
    NW-DP/Kabsch loop (a single bad best-seed can trap the refinement)."""
    x = np.asarray(coords1, dtype=np.float64)
    y = np.asarray(coords2, dtype=np.float64)
    l_target = l_target or len(y)
    d0 = d0_for_length(l_target)

    scored = []
    for pairs in _initial_alignments(x, y):
        idx = np.array(pairs)
        tm = _tm_of_alignment(x[idx[:, 0]], y[idx[:, 1]], l_target, d0)
        scored.append((tm, pairs))
    if not scored:
        return 0.0
    scored.sort(key=lambda s: -s[0])

    best_tm = scored[0][0]
    for tm_seed, pairs in scored[:n_refine_seeds]:
        best_tm = max(best_tm, _refine(x, y, pairs, l_target, d0, max_iter))
    return float(best_tm)


def ca_from_pdb(path) -> np.ndarray:
    """(L, 3) CA coordinates of a PDB file's amino residues."""
    res = read_pdb(path).amino_residues()
    return np.array([r.atom("CA") for r in res if r.atom("CA") is not None])


def tm_score_from_pdbs(path1, path2):
    """CA-based TM-score of two PDB files (normalized by chain 2)."""
    return tm_score(ca_from_pdb(path1), ca_from_pdb(path2))


def run_tmalign(path1, path2, binary_path=None, fast=True) -> float:
    """Run the native TM-align binary and parse its first TM-score line
    (chain-1-normalized); 0.0 on malformed output. Falls back to the
    Python implementation when no native binary is available."""
    binary = Path(binary_path) if binary_path else _NATIVE_BINARY
    if not binary.exists():
        return tm_score_from_pdbs(path1, path2)
    cmd = [str(binary), str(path1), str(path2)]
    if fast:
        cmd += ["-fast"]
    result = subprocess.run(cmd, capture_output=True)
    lines = result.stdout.decode("UTF-8").split("\n")
    if len(lines) < 10:
        return 0.0
    try:
        for line in lines:
            if line.startswith("TM-score=") or line.startswith("TM-score ="):
                return float(line.replace("=", " ").split()[1])
        return float(lines[13].split(" ")[1].strip())
    except (IndexError, ValueError):
        return 0.0
