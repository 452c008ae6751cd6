"""Seeded synthetic training records: noisy ideal-helix backbones through
the port's featurizer and `save_record`.

Not a port of the JAX package's `data/synthetic.py` (torsion-space helix
bundles compacted by L-BFGS): these backbones only need a finite 6D
featurization (C=5), or for the C=8 layout helices that P-SEA annotates
(`helix_bundle_backbone`), so that a training run needs none of the tracked
records.
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


# the words of the seeded abstract-length captions: a PDB abstract's
# vocabulary; the hash encoder makes one token of each word and of each
# punctuation mark
ABSTRACT_WORDS = (
    "the protein structure of domain helix helical strand sheet beta alpha "
    "binding site active residues loop fold crystal resolution angstrom "
    "complex with and in a an is are we report here determined by xray "
    "cryoem analysis reveals conformational change ligand substrate "
    "catalytic enzyme kinase receptor membrane transporter channel dimer "
    "trimer tetramer interface hydrophobic core surface salt bridge "
    "hydrogen bond mutation wildtype variant stability thermal activity "
    "inhibitor affinity nanomolar family conserved motif terminal "
    "nterminal cterminal subunit assembly zinc calcium magnesium ion "
    "coordination disulfide glycine proline rich region flexible rigid "
    "molecular dynamics simulations suggest mechanism function these "
    "results provide insight into design novel de novo designed bundle "
    "barrel coiled coil repeat antibody fragment antigen recognition"
).split()


def abstract_caption(rng, n_tokens):
    """A seeded caption of exactly `n_tokens` hash-encoder tokens
    (`text.encoder.HashTextEncoder`: a word or a punctuation mark each):
    sentences of ABSTRACT_WORDS, each closed by a period. Not English."""
    words = []
    while len(words) < n_tokens:
        sentence = list(rng.choice(ABSTRACT_WORDS,
                                   size=int(rng.integers(8, 25))))
        words += sentence[:max(0, n_tokens - len(words) - 1)] + ["."]
    text = " ".join(words[:n_tokens])
    return text.replace(" .", ".")


def abstract_captions(n, seed=0, tokens=(40, 600)):
    """n abstract-length captions (`abstract_caption`), their token counts
    drawn uniformly from `tokens` (inclusive): with the hash encoder's
    64-token buckets and 512-token cut, captions land in every bucket and
    past the cut."""
    rng = np.random.default_rng(seed)
    return [abstract_caption(rng, int(rng.integers(tokens[0],
                                                   tokens[1] + 1)))
            for _ in range(n)]


def _ideal_helix(length, rise=1.5):
    """(L, 3, 3) N/CA/C of an ideal helix along z, 100 degrees a residue."""
    i = np.arange(length)[:, None]
    turn = np.deg2rad(100.0)

    def ring(offset, radius):
        a = turn * (i + offset)
        return np.concatenate([radius * np.cos(a), radius * np.sin(a),
                               rise * (i + offset)], axis=1)

    return np.stack([ring(-0.35, 1.6), ring(0.0, 2.3), ring(0.35, 1.7)],
                    axis=1)


def helix_backbone(rng, length):
    """(L, 3, 3) N/CA/C coordinates of a noisy ideal helix (CA rise 1.5 A,
    100 degrees a residue): a finite 6D featurization, not a protein."""
    bb = _ideal_helix(length)
    return (bb + rng.normal(0, 0.2, bb.shape)).astype(np.float32)


BUNDLE_LOOP = 3      # loop residues between two helices
BUNDLE_SPACING = 9.0  # A between the axes of neighbouring helices
BUNDLE_NOISE = 0.05  # A; P-SEA's d3 window is +-0.5 A around 5.3


def helix_bundle_backbone(rng, length):
    """(L, 3, 3) N/CA/C of antiparallel ideal helices (CA rise 1.55 A, so
    that CA(i-1)-CA(i+2) is 5.2 A and CA(i-1)-CA(i+3) 6.4 A, inside P-SEA's
    helix windows) side by side, joined by straight loops of BUNDLE_LOOP
    residues, with BUNDLE_NOISE A of noise: P-SEA annotates each helix.
    One helix a 30 residues, one to three (the tests' short records hold
    one, the L=128 records two or three). Not a protein."""
    n_helices = min(3, max(1, length // 30))
    n_loop = BUNDLE_LOOP * (n_helices - 1)
    sizes = np.full(n_helices, (length - n_loop) // n_helices)
    sizes[: (length - n_loop) % n_helices] += 1
    helices = []
    for k, m in enumerate(sizes):
        h = _ideal_helix(int(m), rise=1.55)
        if k % 2:  # antiparallel: turned about x, running down from the top
            h = h * np.array([1.0, -1.0, -1.0])
            h[..., 2] += 1.55 * (sizes[0] - 1)
        h[..., 0] += BUNDLE_SPACING * k
        helices.append(h)
    parts = [helices[0]]
    for a, b in zip(helices[:-1], helices[1:]):
        f = (np.arange(1, BUNDLE_LOOP + 1) / (BUNDLE_LOOP + 1))[:, None, None]
        parts += [a[-1] + f * (b[0] - a[-1]), b]
    bb = np.concatenate(parts)
    return (bb + rng.normal(0, BUNDLE_NOISE, bb.shape)).astype(np.float32)


def write_records(directory, n, lengths=(40, 128), seed=0,
                  captions=CAPTIONS, num_channels=5):
    """Replace the .npz records in `directory` by n records
    `smoke_000.npz`, ... with lengths drawn from [lo, hi] and captions taken
    in turn from `captions`. `num_channels` 8 writes helix bundles with the
    SS block channels (C=8); every one must be annotated with at least one
    block."""
    ss_constraints = {5: False, 8: True}[int(num_channels)]
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    for old in directory.glob("*.npz"):
        old.unlink()
    rng = np.random.default_rng(seed)
    letters = sorted(LETTER_TO_NUM)
    for r in range(n):
        L = int(rng.integers(lengths[0], lengths[1] + 1))
        if ss_constraints:
            bb = helix_bundle_backbone(rng, L)
        else:
            bb = helix_backbone(rng, L)
        coords_6d, mask_pair, ss = featurize_structure(bb, np.ones(L),
                                                       ss_constraints)
        if ss_constraints and (coords_6d is None or not ss):
            raise AssertionError(f"record {r} (length {L}): P-SEA found no "
                                 "SS block")
        aa_str = "".join(rng.choice(letters, size=L))
        save_record({
            "id": f"smoke_{r:03d}", "coords": bb, "coords_6d": coords_6d,
            "aa": np.array([LETTER_TO_NUM[c] for c in aa_str]),
            "aa_str": aa_str, "mask_pair": mask_pair, "ss_indices": ss,
            "caption": captions[r % len(captions)],
        }, directory / f"smoke_{r:03d}.npz")
