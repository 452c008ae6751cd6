"""Learned inverse-folding head for fixed-backbone sequence design (the
port's copy of text2protein_tpu/realize/design_learned.py, which is
numpy-only; `inverse_head.npz` beside it is a byte-identical copy of the JAX
package's trained head).

A softmax regression over per-position structural features, trained on
(backbone, native sequence) pairs — the learning problem ProteinMPNN solves
on real natives, at toy scale. Two prediction rounds make it
neighbor-aware: round 2 adds features of the round-1 predicted contacting
residues (charge and hydrophobicity sums), the lightweight analog of
autoregressive decoding. The physics designer (`design.py`) remains the
zero-shot path.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .design import (
    AA20,
    CHARGE,
    HYD,
    backbone_phi,
    burial_fraction,
    cb_coords,
    contact_pairs,
    dihedral,
)

_HEAD_PATH = Path(__file__).with_name("inverse_head.npz")


def design_eval_split(data_paths, n_eval: int = 96, seed: int = 0):
    """Canonical held-out split for the sequence-design benchmark: the head
    trains on everything AFTER the prefix and is evaluated ON the prefix.
    Returns (eval_paths, rest_paths): seed-`seed` shuffle of the sorted
    record paths, first `n_eval` reserved for evaluation."""
    paths = sorted(data_paths)
    np.random.RandomState(seed).shuffle(paths)
    return paths[:n_eval], paths[n_eval:]


def backbone_psi(bb: np.ndarray) -> np.ndarray:
    """(L,) psi dihedrals (last set to pi/3)."""
    n, ca, c = bb[:, 0], bb[:, 1], bb[:, 2]
    psi = np.full(len(bb), np.pi / 3)
    psi[:-1] = dihedral(n[:-1], ca[:-1], c[:-1], n[1:])
    return psi


def base_features(bb: np.ndarray) -> np.ndarray:
    """(L, F) per-position structural features (round-1, sequence-free)."""
    from ..data.ss import annotate_sse

    L = len(bb)
    ss = annotate_sse(bb[:, 1])
    burial = burial_fraction(bb)
    cb = cb_coords(bb)
    d = np.linalg.norm(cb[:, None] - cb[None, :], axis=-1)
    sep = np.abs(np.arange(L)[:, None] - np.arange(L)[None, :])
    n_nb8 = ((d < 8.0) & (sep >= 2)).sum(1) / 10.0
    n_nb12 = ((d < 12.0) & (sep >= 2)).sum(1) / 20.0
    phi, psi = backbone_phi(bb), backbone_psi(bb)

    helix = (ss == "a").astype(np.float32)
    strand = (ss == "b").astype(np.float32)
    coil = 1.0 - helix - strand

    # position within its SS segment (N-cap ... C-cap), in [0, 1]
    seg_pos = np.zeros(L, np.float32)
    start = 0
    for i in range(1, L + 1):
        if i == L or ss[i] != ss[start]:
            n = i - start
            seg_pos[start:i] = (np.arange(n) + 0.5) / n
            start = i
    # neighbor-averaged burial (core positions contact core positions)
    nb_mask = (d < 10.0) & (sep >= 2)
    nb_burial = np.where(
        nb_mask.sum(1) > 0,
        (nb_mask * burial[None, :]).sum(1) / np.maximum(nb_mask.sum(1), 1),
        burial,
    )
    term = np.zeros(L, np.float32)
    term[:2] = 1.0
    term[-2:] = 1.0

    feats = np.stack([
        np.ones(L, np.float32),
        burial.astype(np.float32),
        (burial ** 2).astype(np.float32),
        n_nb8.astype(np.float32),
        n_nb12.astype(np.float32),
        helix, strand, coil,
        (helix * burial).astype(np.float32),
        (coil * burial).astype(np.float32),
        np.sin(phi).astype(np.float32), np.cos(phi).astype(np.float32),
        np.sin(psi).astype(np.float32), np.cos(psi).astype(np.float32),
        (phi > np.deg2rad(30)).astype(np.float32),
        seg_pos, (seg_pos * helix).astype(np.float32),
        nb_burial.astype(np.float32),
        term,
    ], axis=1)
    return feats


N_SEQ_FEATS = 3  # appended in round 2: neighbor charge/hydropathy/count


def seq_features(bb: np.ndarray, seq_idx: np.ndarray) -> np.ndarray:
    """(L, 3) features of predicted contacting residues (round-2)."""
    ii, jj, screen = contact_pairs(bb)
    L = len(bb)
    chg = np.zeros(L, np.float32)
    hyd = np.zeros(L, np.float32)
    cnt = np.zeros(L, np.float32)
    for k in range(len(ii)):
        i, j, s = ii[k], jj[k], screen[k]
        chg[i] += s * CHARGE[seq_idx[j]]
        chg[j] += s * CHARGE[seq_idx[i]]
        hyd[i] += HYD[seq_idx[j]]
        hyd[j] += HYD[seq_idx[i]]
        cnt[i] += 1
        cnt[j] += 1
    cnt = np.maximum(cnt, 1.0)
    return np.stack([chg / cnt, hyd / cnt, cnt / 10.0], axis=1)


class InverseHead:
    """Two-round softmax-regression head: W1 (F, 20), W2 (F+3, 20)."""

    def __init__(self, w1: np.ndarray, w2: np.ndarray):
        self.w1, self.w2 = w1, w2

    @classmethod
    def load(cls, path=_HEAD_PATH):
        z = np.load(path)
        return cls(z["w1"], z["w2"])

    def save(self, path=_HEAD_PATH):
        np.savez_compressed(path, w1=self.w1, w2=self.w2)

    def logits(self, bb: np.ndarray):
        f1 = base_features(bb)
        l1 = f1 @ self.w1
        pred1 = l1.argmax(1)
        f2 = np.concatenate([f1, seq_features(bb, pred1)], axis=1)
        return f2 @ self.w2

    def design(self, bb: np.ndarray, fix_mask=None, fixed_seq=None) -> str:
        pred = self.logits(bb).argmax(1)
        if fix_mask is not None and fixed_seq is not None:
            from .design import _IDX

            fixed = np.array([_IDX.get(c, 0) for c in fixed_seq])
            pred = np.where(fix_mask, fixed, pred)
        return "".join(AA20[a] for a in pred)


def _softmax_fit(X, y, l2=1e-3, iters=300, lr=0.5, seed=0):
    """Full-batch softmax regression with Adam. X (N, F), y (N,) ints."""
    rng = np.random.RandomState(seed)
    N, F = X.shape
    W = rng.randn(F, 20).astype(np.float32) * 0.01
    m = np.zeros_like(W)
    v = np.zeros_like(W)
    onehot = np.zeros((N, 20), np.float32)
    onehot[np.arange(N), y] = 1.0
    for t in range(1, iters + 1):
        logits = X @ W
        logits -= logits.max(1, keepdims=True)
        p = np.exp(logits)
        p /= p.sum(1, keepdims=True)
        g = X.T @ (p - onehot) / N + l2 * W
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mh = m / (1 - 0.9**t)
        vh = v / (1 - 0.999**t)
        W -= lr * mh / (np.sqrt(vh) + 1e-8)
    return W


def train_head(backbones, sequences, iters=300, seed=0) -> InverseHead:
    """Fit the two rounds on (backbone, native-sequence) pairs."""
    from .design import _IDX

    f1s, ys = [], []
    for bb, seq in zip(backbones, sequences):
        f1s.append(base_features(bb))
        ys.append(np.array([_IDX.get(c, 0) for c in seq]))
    X1 = np.concatenate(f1s)
    y = np.concatenate(ys)
    w1 = _softmax_fit(X1, y, iters=iters, seed=seed)

    # round 2 features use round-1 PREDICTIONS (not teacher forcing), so
    # train matches inference
    f2s = []
    for bb, f1 in zip(backbones, f1s):
        pred1 = (f1 @ w1).argmax(1)
        f2s.append(np.concatenate([f1, seq_features(bb, pred1)], axis=1))
    X2 = np.concatenate(f2s)
    w2 = _softmax_fit(X2, y, iters=iters, seed=seed + 1)
    return InverseHead(w1, w2)
