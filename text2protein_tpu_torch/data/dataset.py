"""PDB files -> records -> padded numpy batches (counterpart of
text2protein_tpu/data/dataset.py: `featurize_pdb_file`, `ProteinDataset`,
`save_record`, `load_record`, `ProteinProcessedDataset`, `PaddingCollate`,
`make_batch`).

Record schema, one .npz per protein:
  {id, coords (L,3,3), coords_6d (C,L,L), aa (L,), aa_str, mask_pair (L,L),
   ss_indices, caption}
The reference's .pt records (a torch-saved dict of the same keys) are read
too.
"""

from __future__ import annotations

import json
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

from .featurize import featurize_structure
from .pdbio import read_pdb
from .ss import parse_ss_spans
from .vocab import (
    AA_PAD_CHAR,
    AA_PAD_ID,
    LETTER_TO_NUM,
    NON_STANDARD_TO_STANDARD,
    THREE_TO_ONE,
)

MAX_SS_BLOCKS = 32  # fixed-shape bound for SS block dropout


def standard_name(name: str) -> str:
    """A residue's 3-letter name mapped to a standard one (UNK where it is
    neither standard nor a known non-standard name)."""
    if name in THREE_TO_ONE:
        return name
    return NON_STANDARD_TO_STANDARD.get(name, "UNK")


def featurize_pdb_file(path, min_res_num: int, max_res_num: int,
                       ss_constraints: bool, caption: str = "") -> dict | None:
    """Parse and featurize one PDB file. Returns a record, or None when the
    protein is filtered out (several models, no amino residue, a length
    outside [min_res_num, max_res_num], or with `ss_constraints` (C=8) an
    SS annotation that fails). A residue missing any of N/CA/C is zeroed
    and masks itself and both neighbours, since all three atoms feed the
    virtual-Cb rebuild."""
    path = Path(path)
    structure = read_pdb(path)
    if structure.num_models > 1:
        return None
    residues = structure.amino_residues()
    if not residues:
        return None
    one_letter = [THREE_TO_ONE[standard_name(r.name)] for r in residues]
    aa = [LETTER_TO_NUM[c] for c in one_letter]
    nres = len(aa)
    if nres > max_res_num or nres < min_res_num:
        return None

    mask = np.ones(nres)
    bb_coords = np.zeros((nres, 3, 3), dtype=np.float32)
    for res_idx, res in enumerate(residues):
        for atom_idx, a in enumerate(("N", "CA", "C")):
            coord = res.atom(a)
            if coord is None:
                mask[max(res_idx - 1, 0): res_idx + 2] = 0
            else:
                bb_coords[res_idx, atom_idx] = coord

    # the SS annotation (C=8) runs over the CAs of the first chain only
    first_chain = residues[0].chain
    ca_chain = np.array(
        [r.atom("CA") for r in residues
         if r.chain == first_chain and r.atom("CA") is not None],
        dtype=np.float64,
    ).reshape(-1, 3)
    coords_6d, mask_pair, ss_indices = featurize_structure(
        bb_coords, mask, ss_constraints, ca_coords=ca_chain)
    if coords_6d is None:
        return None
    return {
        "id": path.stem.replace(".pdb", ""),
        "coords": bb_coords,
        "coords_6d": coords_6d,
        "aa": np.asarray(aa, dtype=np.int64),
        "aa_str": "".join(one_letter),
        "mask_pair": mask_pair,
        "ss_indices": ss_indices,
        "caption": caption,
    }


def save_record(record: dict, path) -> None:
    np.savez_compressed(
        path,
        id=np.asarray(record["id"]),
        coords=record["coords"].astype(np.float32),
        coords_6d=record["coords_6d"].astype(np.float32),
        aa=np.asarray(record["aa"], dtype=np.int64),
        aa_str=np.asarray(record["aa_str"]),
        mask_pair=record["mask_pair"].astype(bool),
        ss_indices=np.asarray(record["ss_indices"]),
        caption=np.asarray(record["caption"]),
    )


def load_record(path) -> dict:
    """A record from its .npz, or from a reference .pt (text2protein_tpu/
    data/dataset.py:56-70: `torch.load(weights_only=False)`, so only a .pt
    file of a trusted source)."""
    path = str(path)
    if path.endswith(".pt"):
        import torch

        d = torch.load(path, map_location="cpu", weights_only=False)
        return {
            "id": str(d["id"]),
            "coords": d["coords"].numpy().astype(np.float32),
            "coords_6d": d["coords_6d"].numpy().astype(np.float32),
            "aa": d["aa"].numpy().astype(np.int64),
            "aa_str": str(d["aa_str"]),
            "mask_pair": d["mask_pair"].numpy().astype(bool),
            "ss_indices": str(d["ss_indices"]),
            "caption": str(d["caption"]),
        }
    with np.load(path, allow_pickle=False) as z:
        return {
            "id": str(z["id"]),
            "coords": z["coords"],
            "coords_6d": z["coords_6d"],
            "aa": z["aa"],
            "aa_str": str(z["aa_str"]),
            "mask_pair": z["mask_pair"],
            "ss_indices": str(z["ss_indices"]),
            "caption": str(z["caption"]),
        }


def _load_captions(description_path) -> dict:
    """A caption file: a JSON list of {pdb_id, caption} or a JSON object
    id -> caption. {} without a path or a file."""
    if not description_path:
        return {}
    p = Path(description_path)
    if not p.exists():
        return {}
    with open(p) as f:
        ann = json.load(f)
    if isinstance(ann, dict):
        return {str(k): str(v) for k, v in ann.items()}
    return {str(a["pdb_id"]): str(a["caption"]) for a in ann}


class _Worker:
    """Featurize one file and save its record; picklable, for the pool."""

    def __init__(self, out_dir, min_res_num, max_res_num, ss_constraints,
                 ann_dict):
        self.out_dir = out_dir
        self.min_res_num = min_res_num
        self.max_res_num = max_res_num
        self.ss_constraints = ss_constraints
        self.ann_dict = ann_dict

    def __call__(self, path):
        """1 when a record was written, else 0: a file without a caption
        (when captions are given), filtered out, or that fails to parse."""
        try:
            path = Path(path)
            if self.ann_dict and path.stem not in self.ann_dict:
                return 0
            rec = featurize_pdb_file(path, self.min_res_num,
                                     self.max_res_num, self.ss_constraints,
                                     caption=self.ann_dict.get(path.stem, ""))
            if rec is None:
                return 0
            save_record(rec, Path(self.out_dir) / f"{rec['id']}.npz")
            return 1
        except Exception:  # a broken file is skipped, as the JAX package does
            return 0


class ProteinDataset:
    """Walk a PDB tree, featurize every file and write one record per
    accepted protein to `out_dir`. `local_test` keeps the first 200 files
    of the walk."""

    def __init__(self, dataset_path, description_path="", out_dir="processed",
                 min_res_num=40, max_res_num=256, ss_constraints=True,
                 local_test=False, num_workers=None):
        self.dataset_path = dataset_path
        self.out_dir = Path(out_dir)
        self.min_res_num = min_res_num
        self.max_res_num = max_res_num
        self.ss_constraints = ss_constraints
        self.ann_dict = _load_captions(description_path)
        pdb_paths = []
        for root, _dirs, files in os.walk(dataset_path):
            for file in files:
                pdb_paths.append(Path(root) / file)
        if local_test:
            pdb_paths = pdb_paths[:200]
        self.pdb_paths = pdb_paths
        self.num_workers = num_workers or os.cpu_count() or 1

    def process(self) -> int:
        """Featurize every file; returns the number of records written. A
        pool of `num_workers` spawned processes, unless one worker is asked
        for or there are fewer than 4 files."""
        self.out_dir.mkdir(parents=True, exist_ok=True)
        worker = _Worker(str(self.out_dir), self.min_res_num,
                         self.max_res_num, self.ss_constraints, self.ann_dict)
        if self.num_workers <= 1 or len(self.pdb_paths) < 4:
            return sum(worker(p) for p in self.pdb_paths)
        with ProcessPoolExecutor(
                max_workers=self.num_workers,
                mp_context=multiprocessing.get_context("spawn")) as ex:
            return sum(ex.map(worker, self.pdb_paths, chunksize=10))


class ProteinProcessedDataset:
    """Loads saved records (.npz, or reference .pt) from a directory, in
    sorted name order (text2protein_tpu/data/dataset.py:253-280)."""

    def __init__(self, root_path):
        self.root_path = Path(root_path)
        self.data_paths = sorted(
            p for p in os.listdir(root_path) if p.endswith((".npz", ".pt")))

    def __len__(self):
        return len(self.data_paths)

    def __getitem__(self, idx):
        return load_record(self.root_path / self.data_paths[idx])

    def caption(self, idx) -> str:
        """Record idx's caption alone: an .npz decompresses only that member
        (the trainer reads every caption at its start)."""
        path = self.root_path / self.data_paths[idx]
        if path.suffix == ".pt":
            return load_record(path)["caption"]
        with np.load(path, allow_pickle=False) as z:
            return str(z["caption"])


class PaddingCollate:
    """Pad records to `max_len`. Square (..., N, N) maps are padded on both
    trailing dims; `aa` pads with 21, `aa_str` with '_', others with 0.
    Captions are left as they are."""

    def __init__(self, max_len=None):
        self.max_len = max_len

    @staticmethod
    def _pad_last(x, n, value=0):
        if isinstance(x, np.ndarray) and x.ndim > 0 and x.dtype.kind != "U":
            if x.ndim >= 2 and x.shape[-1] != 3 and x.shape[-1] == x.shape[-2]:
                pad = [(0, 0)] * (x.ndim - 2) + [
                    (0, n - x.shape[-2]),
                    (0, n - x.shape[-1]),
                ]
                return np.pad(x, pad, constant_values=value)
            if x.shape[0] > n:
                raise ValueError(f"record of length {x.shape[0]} > {n}")
            pad = [(0, n - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
            return np.pad(x, pad, constant_values=value)
        if isinstance(x, str):
            return x + value * (n - len(x))
        return x

    @staticmethod
    def _get_value(k):
        if k == "aa_str":
            return AA_PAD_CHAR
        if k == "aa":
            return AA_PAD_ID
        if k in ("id", "ss_indices"):
            return ""
        return 0

    def __call__(self, records: list[dict]) -> list[dict]:
        n = self.max_len or max(len(r["aa"]) for r in records)
        out = []
        for r in records:
            padded = {}
            for k, v in r.items():
                if k != "caption":
                    v = self._pad_last(v, n, value=self._get_value(k))
                padded[k] = v
            out.append(padded)
        return out


def make_batch(records: list[dict], max_len: int) -> dict:
    """Collate records into a dict of stacked numpy arrays, with the real
    residue count per sample (`length`, (B,) int32) and the parsed SS spans
    (`ss_spans`, (B, MAX_SS_BLOCKS, 2) int32, -1-padded)."""
    padded = PaddingCollate(max_len)(records)
    return {
        "id": [r["id"] for r in padded],
        "coords": np.stack([r["coords"] for r in padded]).astype(np.float32),
        "coords_6d": np.stack([r["coords_6d"] for r in padded]
                              ).astype(np.float32),
        "mask_pair": np.stack([r["mask_pair"] for r in padded]).astype(bool),
        "aa": np.stack([r["aa"] for r in padded]).astype(np.int32),
        "aa_str": [r["aa_str"] for r in padded],
        "caption": [r["caption"] for r in padded],
        "ss_indices": [r["ss_indices"] for r in padded],
        "length": np.asarray(
            [sum(1 for a in r["aa_str"] if a != AA_PAD_CHAR) for r in padded],
            dtype=np.int32,
        ),
        "ss_spans": np.stack(
            [parse_ss_spans(r["ss_indices"], MAX_SS_BLOCKS) for r in padded]
        ),
    }
