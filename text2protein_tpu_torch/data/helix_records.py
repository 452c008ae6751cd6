"""Seeded synthetic training records: noisy ideal-helix backbones through
the port's featurizer and `save_record`.

Not a port of the JAX package's `data/synthetic.py` (torsion-space helix
bundles): these backbones only need a finite 6D featurization, so that a
training run needs none of the tracked records.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .dataset import save_record
from .featurize import featurize_structure
from .vocab import LETTER_TO_NUM

CAPTIONS = [
    "A small alpha-helical bundle that binds zinc.",
    "beta barrel membrane transporter",
    "Kinase domain with a long activation loop.",
    "three helix bundle",
    "A de novo designed four-helix bundle with a hydrophobic core.",
]


def helix_backbone(rng, length):
    """(L, 3, 3) N/CA/C coordinates of a noisy ideal helix (CA rise 1.5 A,
    100 degrees a residue): a finite 6D featurization, not a protein."""
    i = np.arange(length)[:, None]
    turn = np.deg2rad(100.0)

    def ring(offset, radius):
        a = turn * (i + offset)
        return np.concatenate([radius * np.cos(a), radius * np.sin(a),
                               1.5 * (i + offset)], axis=1)

    bb = np.stack([ring(-0.35, 1.6), ring(0.0, 2.3), ring(0.35, 1.7)],
                  axis=1)
    return (bb + rng.normal(0, 0.2, bb.shape)).astype(np.float32)


def write_records(directory, n, lengths=(40, 128), seed=0,
                  captions=CAPTIONS):
    """Replace the .npz records in `directory` by n records
    `smoke_000.npz`, ... with lengths drawn from [lo, hi] and captions taken
    in turn from `captions`."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    for old in directory.glob("*.npz"):
        old.unlink()
    rng = np.random.default_rng(seed)
    letters = sorted(LETTER_TO_NUM)
    for r in range(n):
        L = int(rng.integers(lengths[0], lengths[1] + 1))
        bb = helix_backbone(rng, L)
        coords_6d, mask_pair, ss = featurize_structure(bb, np.ones(L), False)
        aa_str = "".join(rng.choice(letters, size=L))
        save_record({
            "id": f"smoke_{r:03d}", "coords": bb, "coords_6d": coords_6d,
            "aa": np.array([LETTER_TO_NUM[c] for c in aa_str]),
            "aa_str": aa_str, "mask_pair": mask_pair, "ss_indices": ss,
            "caption": captions[r % len(captions)],
        }, directory / f"smoke_{r:03d}.npz")
