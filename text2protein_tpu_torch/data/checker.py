"""Dataset sanity checks (counterpart of text2protein_tpu/data/checker.py):
the caption <-> PDB set intersection, caption backfill into processed
records, and a batch smoke check.

Usage:
  python -m text2protein_tpu_torch.data.checker CONFIG [--backfill]
      [--batch_size 4]
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import numpy as np

from ..config import parse_yaml
from .dataset import (
    ProteinProcessedDataset,
    _load_captions,
    load_record,
    make_batch,
    save_record,
)


def _caption_table(caption_path) -> dict:
    """id -> caption, read by the dataset's own loader; a missing file
    raises here, where the loader would give {}."""
    if not Path(caption_path).is_file():
        raise FileNotFoundError(caption_path)
    return _load_captions(caption_path)


def compare_pdb_file_and_caption(dataset_path, caption_path) -> dict:
    """Set intersection between the PDB files on disk (by file stem) and
    the caption entries; the first 20 of each difference."""
    pdb_ids = set()
    for _root, _dirs, files in os.walk(dataset_path):
        for f in files:
            pdb_ids.add(Path(f).stem)
    caption_ids = set(_caption_table(caption_path))
    both = pdb_ids & caption_ids
    return {
        "num_pdbs": len(pdb_ids),
        "num_captions": len(caption_ids),
        "num_both": len(both),
        "pdb_only": sorted(pdb_ids - caption_ids)[:20],
        "caption_only": sorted(caption_ids - pdb_ids)[:20],
    }


def backfill_captions(processed_dir, caption_path) -> int:
    """Write captions into processed records that have none; returns how
    many records were rewritten."""
    ann = _caption_table(caption_path)
    n = 0
    for p in Path(processed_dir).glob("*.npz"):
        rec = load_record(p)
        if not rec["caption"] and rec["id"] in ann:
            rec["caption"] = ann[rec["id"]]
            save_record(rec, p)
            n += 1
    return n


def batch_smoke_check(processed_dir, max_len, batch_size=4) -> dict:
    """Collate the first records into a batch and report its shapes and
    whether its maps are finite."""
    ds = ProteinProcessedDataset(processed_dir)
    recs = [ds[i] for i in range(min(batch_size, len(ds)))]
    batch = make_batch(recs, max_len)
    return {
        "num_records": len(ds),
        "coords_6d": list(batch["coords_6d"].shape),
        "finite": bool(np.isfinite(batch["coords_6d"]).all()),
        "lengths": batch["length"].tolist(),
    }


def main(argv=None):
    """Print a JSON report: the intersection (when the config names an
    existing PDB tree and caption file), the backfill count with
    `--backfill`, and the batch smoke check of the processed records."""
    p = argparse.ArgumentParser(description="dataset sanity checks")
    p.add_argument("config", type=str)
    p.add_argument("--backfill", action="store_true",
                   help="write captions into processed records lacking them")
    p.add_argument("--batch_size", type=int, default=4)
    args = p.parse_args(argv)

    data = parse_yaml(Path(args.config).read_text())["data"]
    report = {}
    # Path("") is "." and always exists: the keys must be non-empty
    dataset_path = data.get("dataset_path") or ""
    caption_path = data.get("caption_path") or ""
    if dataset_path and caption_path and Path(dataset_path).exists() \
            and Path(caption_path).exists():
        report["intersection"] = compare_pdb_file_and_caption(
            dataset_path, caption_path)
    if args.backfill:
        report["backfilled"] = backfill_captions(
            data["processed_dataset_path"], data["caption_path"])
    report["smoke"] = batch_smoke_check(
        data["processed_dataset_path"], data["max_res_num"],
        batch_size=args.batch_size)
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    main()
