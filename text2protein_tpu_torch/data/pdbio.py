"""Minimal, dependency-free PDB reader/writer (the port's own copy of
text2protein_tpu/data/pdbio.py, which is numpy-only).

Model counting, per-residue iteration with atom names and coordinates,
chain filtering, and writing backbone PDBs.
"""

from __future__ import annotations

import dataclasses
import gzip
from pathlib import Path
from typing import Optional

import numpy as np

from .vocab import NON_STANDARD_TO_STANDARD, ONE_TO_THREE, THREE_TO_ONE


@dataclasses.dataclass
class Residue:
    name: str            # 3-letter residue name (as in file)
    chain: str
    res_seq: int
    icode: str
    atom_names: list
    coords: np.ndarray   # (num_atoms, 3) float32

    def atom(self, name: str) -> Optional[np.ndarray]:
        try:
            return self.coords[self.atom_names.index(name)]
        except ValueError:
            return None


@dataclasses.dataclass
class Structure:
    residues: list       # list[Residue], file order
    num_models: int

    def chains(self):
        seen, out = set(), []
        for r in self.residues:
            if r.chain not in seen:
                seen.add(r.chain)
                out.append(r.chain)
        return out

    def filter_chain(self, chain: str) -> "Structure":
        return Structure(
            residues=[r for r in self.residues if r.chain == chain],
            num_models=self.num_models,
        )

    def amino_residues(self):
        """Residues that are amino acids: standard/known-nonstandard name, or
        any residue carrying a CA atom (mapped to UNK)."""
        out = []
        for r in self.residues:
            if r.name in THREE_TO_ONE or r.name in NON_STANDARD_TO_STANDARD:
                out.append(r)
            elif "CA" in r.atom_names and r.name not in ("HOH", "DOD", "WAT"):
                out.append(r)
        return out


def _open(path):
    path = Path(path)
    if path.suffix == ".gz":
        return gzip.open(path, "rt")
    return open(path, "r")


def read_pdb(path) -> Structure:
    """Parse ATOM/HETATM records of the FIRST model; count models.

    Fixed-column PDB format; a `.gz` path is read through gzip.
    """
    residues: list[Residue] = []
    num_models = 0
    in_model = False
    cur_key = None
    cur: Optional[Residue] = None
    first_model_done = False

    with _open(path) as f:
        for line in f:
            rec = line[:6]
            if rec == "MODEL ":
                num_models += 1
                if num_models > 1:
                    first_model_done = True
                in_model = True
                continue
            if rec == "ENDMDL":
                in_model = False
                continue
            if first_model_done:
                continue
            if rec not in ("ATOM  ", "HETATM"):
                continue
            if len(line) < 54:  # truncated record: coords can't be complete
                continue
            altloc = line[16]
            if altloc not in (" ", "A"):  # keep first altloc only
                continue
            name = line[12:16].strip()
            res_name = line[17:20].strip()
            chain = line[21]
            try:
                res_seq = int(line[22:26])
            except ValueError:
                continue
            icode = line[26]
            try:
                xyz = (float(line[30:38]), float(line[38:46]), float(line[46:54]))
            except ValueError:
                continue
            key = (chain, res_seq, icode, res_name)
            if key != cur_key:
                if cur is not None:
                    cur.coords = np.asarray(cur.coords, dtype=np.float32)
                    residues.append(cur)
                cur = Residue(res_name, chain, res_seq, icode, [], [])
                cur_key = key
            if name not in cur.atom_names:  # first occurrence wins
                cur.atom_names.append(name)
                cur.coords.append(xyz)

    if cur is not None:
        cur.coords = np.asarray(cur.coords, dtype=np.float32)
        residues.append(cur)

    if num_models == 0:
        num_models = 1
    return Structure(residues=residues, num_models=num_models)


def format_backbone_pdb(coords, seq=None, chain="A") -> str:
    """Render an (L, k, 3) backbone coordinate array as PDB text.

    k=3 writes N/CA/C; k=4 adds O. `seq` is a 1-letter string (defaults to
    polyalanine).
    """
    coords = np.asarray(coords)
    L = coords.shape[0]
    names = ["N", "CA", "C", "O"][: coords.shape[1]]
    if seq is None:
        seq = "A" * L
    lines = []
    serial = 1
    for i in range(L):
        res3 = ONE_TO_THREE.get(seq[i], "ALA")
        for j, an in enumerate(names):
            x, y, z = coords[i, j]
            if not np.isfinite([x, y, z]).all():
                continue
            el = an[0]
            # atom-name field (cols 13-16): 1-3 char names start at col 14
            an_field = f" {an:<3s}" if len(an) < 4 else an
            lines.append(
                f"ATOM  {serial:5d} {an_field} {res3:>3s} {chain}{i + 1:4d}    "
                f"{x:8.3f}{y:8.3f}{z:8.3f}{1.0:6.2f}{0.0:6.2f}          {el:>2s}"
            )
            serial += 1
    lines.append("TER")
    lines.append("END")
    return "\n".join(lines) + "\n"


def write_backbone_pdb(path, coords, seq=None, chain="A"):
    """`format_backbone_pdb` to a file."""
    Path(path).write_text(format_backbone_pdb(coords, seq=seq, chain=chain))
