"""ProteinMPNN inputs from designed PDBs (the port's copy of
text2protein_tpu/eval/mpnn_export.py, which is numpy-only): each structure
parsed per chain into {seq_chain_X, coords_chain_X (N/CA/C/O or CA), name,
num_of_chains, seq}, one jsonl line per structure.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..data.pdbio import read_pdb
from ..data.vocab import NON_STANDARD_TO_STANDARD, THREE_TO_ONE


def _chain_arrays(residues, atoms):
    coords = np.full((len(residues), len(atoms), 3), np.nan, dtype=np.float64)
    seq = []
    for i, r in enumerate(residues):
        name = (r.name if r.name in THREE_TO_ONE
                else NON_STANDARD_TO_STANDARD.get(r.name, "UNK"))
        seq.append(THREE_TO_ONE.get(name, "X"))
        for j, a in enumerate(atoms):
            c = r.atom(a)
            if c is not None:
                coords[i, j] = c
    return coords, "".join(seq)


def parse_pdb_for_mpnn(path, ca_only: bool = False) -> dict | None:
    """One designed PDB -> the MPNN record dict (`mpnn_export.py:33-61`);
    None without an amino residue."""
    atoms = ["CA"] if ca_only else ["N", "CA", "C", "O"]
    st = read_pdb(path)
    residues = st.amino_residues()
    if not residues:
        return None
    rec = {}
    concat_seq = ""
    s = 0
    for chain in st.chains():
        chain_res = [r for r in residues if r.chain == chain]
        if not chain_res:
            continue
        coords, seq = _chain_arrays(chain_res, atoms)
        concat_seq += seq
        rec[f"seq_chain_{chain}"] = seq
        cdict = {}
        if ca_only:
            cdict[f"CA_chain_{chain}"] = coords[:, 0, :].tolist()
        else:
            for j, a in enumerate(atoms):
                cdict[f"{a}_chain_{chain}"] = coords[:, j, :].tolist()
        rec[f"coords_chain_{chain}"] = cdict
        s += 1
    rec["name"] = Path(path).stem
    rec["num_of_chains"] = s
    rec["seq"] = concat_seq
    return rec


def export_mpnn_jsonl(pdb_dir, save_path, glob_pattern="round_1/*.pdb",
                      ca_only: bool = False) -> int:
    """Every PDB under pdb_dir matching `glob_pattern` (else every *.pdb)
    as one jsonl line of `save_path`; returns the number of records."""
    pdb_dir = Path(pdb_dir)
    paths = sorted(pdb_dir.glob(glob_pattern)) or sorted(pdb_dir.glob("*.pdb"))
    n = 0
    with open(save_path, "w") as f:
        for p in paths:
            rec = parse_pdb_for_mpnn(p, ca_only=ca_only)
            if rec is None:
                continue
            f.write(json.dumps(rec) + "\n")
            n += 1
    return n
