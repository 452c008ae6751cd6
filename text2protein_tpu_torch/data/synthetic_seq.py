"""Synthetic-native sequences for the design-recovery benchmark (the
port's copy of text2protein_tpu/data/synthetic_seq.py, which is
numpy-only).

Per-position amino-acid distributions conditioned on (secondary structure x
burial) class, encoded from empirical composition statistics of globular
proteins, sharpened with a temperature to mimic the per-position
specificity real folds impose beyond class composition.

INDEPENDENCE: these tables are composition statistics (what residues OCCUR
in each environment); the designer (`realize/design.py`) uses biophysical
scales (hydropathy, helix-propensity ddG, charge). Neither reads the other.
"""

from __future__ import annotations

import numpy as np

from ..realize.design import AA20, burial_fraction

# Empirical AA composition per (SS, burial) class of globular proteins.
# Rows ordered as AA20 = "ACDEFGHIKLMNPQRSTVWY".
_CLASS_FREQ = {
    # buried helix: aliphatic core, Ala/Leu-rich
    ("a", 1): {
        "L": 0.18, "A": 0.15, "I": 0.11, "V": 0.10, "F": 0.08, "M": 0.05,
        "Y": 0.04, "W": 0.02, "C": 0.02, "T": 0.04, "S": 0.04, "G": 0.03,
        "E": 0.03, "Q": 0.03, "K": 0.02, "R": 0.02, "H": 0.02, "N": 0.01,
        "D": 0.01, "P": 0.0,
    },
    # exposed helix: E/K/A/R/Q surface
    ("a", 0): {
        "E": 0.16, "K": 0.13, "A": 0.12, "R": 0.09, "Q": 0.08, "L": 0.07,
        "D": 0.06, "S": 0.05, "T": 0.04, "N": 0.04, "H": 0.03, "I": 0.03,
        "V": 0.03, "M": 0.02, "G": 0.02, "Y": 0.02, "F": 0.005, "W": 0.005,
        "C": 0.0, "P": 0.01,
    },
    # buried strand: beta-branched hydrophobics
    ("b", 1): {
        "V": 0.18, "I": 0.15, "L": 0.11, "F": 0.10, "A": 0.07, "Y": 0.07,
        "T": 0.06, "M": 0.04, "C": 0.04, "W": 0.03, "S": 0.04, "G": 0.03,
        "R": 0.01, "H": 0.02, "Q": 0.01, "K": 0.01, "E": 0.01, "N": 0.01,
        "D": 0.005, "P": 0.005,
    },
    # exposed strand
    ("b", 0): {
        "T": 0.13, "V": 0.11, "S": 0.09, "K": 0.09, "E": 0.08, "I": 0.07,
        "R": 0.07, "Q": 0.06, "N": 0.05, "L": 0.05, "Y": 0.05, "D": 0.04,
        "A": 0.04, "H": 0.03, "F": 0.02, "G": 0.02, "M": 0.005, "W": 0.005,
        "C": 0.005, "P": 0.005,
    },
    # buried coil/turn
    ("c", 1): {
        "G": 0.12, "A": 0.11, "L": 0.08, "V": 0.08, "S": 0.08, "P": 0.07,
        "D": 0.06, "T": 0.06, "I": 0.05, "N": 0.05, "F": 0.04, "E": 0.04,
        "K": 0.04, "C": 0.02, "Y": 0.03, "H": 0.02, "M": 0.02, "Q": 0.02,
        "R": 0.01, "W": 0.0,
    },
    # exposed coil/turn
    ("c", 0): {
        "G": 0.13, "P": 0.11, "S": 0.11, "D": 0.10, "N": 0.09, "E": 0.08,
        "K": 0.08, "T": 0.07, "A": 0.06, "Q": 0.04, "R": 0.04, "H": 0.02,
        "L": 0.02, "V": 0.02, "I": 0.01, "Y": 0.01, "F": 0.005, "M": 0.005,
        "W": 0.0, "C": 0.0,
    },
}


def _table(temperature: float, freq_tables: dict | None = None) -> dict:
    out = {}
    for key, freq in (freq_tables or _CLASS_FREQ).items():
        p = np.array([freq.get(a, 0.0) for a in AA20], np.float64)
        p = np.maximum(p, 1e-6)
        p = p ** (1.0 / temperature)
        out[key] = p / p.sum()
    return out


def perturbed_class_freq(seed: int, concentration: float = 60.0) -> dict:
    """An out-of-family composition prior for held-out controls: each class
    distribution is resampled from a Dirichlet centered on the base table
    (alpha = p * concentration). Same physics family, different numbers —
    a generator variant no head trained on base tables has seen
    (the JAX package's scripts/eval_design.py --ood)."""
    rng = np.random.RandomState(seed)
    out = {}
    for key, freq in _CLASS_FREQ.items():
        p = np.array([max(freq.get(a, 0.0), 1e-4) for a in AA20], np.float64)
        q = rng.dirichlet(p * concentration)
        out[key] = {a: float(q[i]) for i, a in enumerate(AA20)}
    return out


# Own charge table (same physical facts as the designer's, separately
# declared — the generator shares geometry with the designer, never tables).
_CHG = np.array(
    [{"D": -1.0, "E": -1.0, "K": 1.0, "R": 1.0, "H": 0.1}.get(a, 0.0)
     for a in AA20], np.float64,
)


def native_like_sequence(bb: np.ndarray, seed: int = 0,
                         temperature: float = 0.6,
                         charge_coupling: float = 0.7,
                         freq_tables: dict | None = None):
    """Sample one native-like sequence for an (L, 3, 3) backbone.

    Realism beyond class composition: (a) burial is CONTINUOUS — each
    position's distribution interpolates the buried/exposed class tables by
    its burial fraction before sharpening; (b) charge COVARIATION — real
    natives enrich opposite charges on contacting surface positions, so
    sampling is sequential and each position's distribution is reweighted by
    exp(-coupling * q_a * q_j) over already-assigned contacts (< 8 A CB,
    exposure-weighted).

    Returns (sequence str, classes list[(ss, buried)], bayes_ceiling float)
    where `bayes_ceiling` is the expected recovery of the oracle that picks
    each position's conditional mode — the natural upper reference for
    recovery numbers on this benchmark.
    """
    from .ss import annotate_sse

    rng = np.random.RandomState(seed)
    raw = {
        key: np.maximum(
            np.array([freq.get(a, 0.0) for a in AA20], np.float64), 1e-6
        )
        for key, freq in (freq_tables or _CLASS_FREQ).items()
    }
    ss = annotate_sse(bb[:, 1])
    burial = burial_fraction(bb)

    # contact graph (own computation: CB pairs < 8 A, |i-j| >= 3)
    from ..realize.design import cb_coords

    cb = cb_coords(bb)
    L = len(bb)
    d = np.linalg.norm(cb[:, None] - cb[None, :], axis=-1)
    sep = np.abs(np.arange(L)[:, None] - np.arange(L)[None, :])
    contact = (d < 8.0) & (sep >= 3)

    seq_idx = np.full(L, -1)
    seq, classes, modal = [], [], []
    for i in range(L):
        s = str(ss[i])
        p = burial[i] * raw[(s, 1)] + (1.0 - burial[i]) * raw[(s, 0)]
        p = p ** (1.0 / temperature)
        # charge covariation with already-assigned contacting partners,
        # strongest for exposed pairs (salt bridges live on the surface)
        js = np.nonzero(contact[i, :i])[0]
        for j in js:
            expos = 1.0 - 0.5 * (burial[i] + burial[j]) / 2.0
            p = p * np.exp(-charge_coupling * expos * _CHG * _CHG[seq_idx[j]])
        p = p / p.sum()
        a = rng.choice(20, p=p)
        seq_idx[i] = a
        seq.append(AA20[a])
        classes.append((s, int(burial[i] > 0.5)))
        modal.append(float(p.max()))
    return "".join(seq), classes, float(np.mean(modal))
