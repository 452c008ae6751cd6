"""Dataset preparation CLI (counterpart of
text2protein_tpu/cli/prepare_dataset.py): walk the config's PDB tree
(`data.dataset_path`) and write one record per accepted protein, captioned
from `data.caption_path`, into `data.processed_dataset_path` (or
`--out_dir`). The records carry the C=8 layout (SS block channels) exactly
when `data.num_channels` is 8.

Usage:
  python -m text2protein_tpu_torch.cli.prepare_dataset CONFIG
      [--local_test] [--out_dir DIR] [--num_workers N]
"""

from __future__ import annotations

import argparse
import time

from ..config import load_config
from ..data.dataset import ProteinDataset


def main(argv=None):
    """Write the records; returns how many were written."""
    p = argparse.ArgumentParser(
        description="Featurize a PDB tree into records")
    p.add_argument("config", type=str)
    p.add_argument("--local_test", action="store_true",
                   help="only the first 200 files of the walk")
    p.add_argument("--out_dir", type=str, default=None)
    p.add_argument("--num_workers", type=int, default=None)
    args = p.parse_args(argv)

    config = load_config(args.config)
    out_dir = (args.out_dir or config.data.processed_dataset_path
               or "processed")
    ds = ProteinDataset(
        config.data.dataset_path,
        description_path=config.data.caption_path,
        out_dir=out_dir,
        min_res_num=config.data.min_res_num,
        max_res_num=config.data.max_res_num,
        ss_constraints=config.data.num_channels == 8,
        local_test=args.local_test,
        num_workers=args.num_workers,
    )
    t0 = time.perf_counter()
    n = ds.process()
    dt = time.perf_counter() - t0
    total = len(ds.pdb_paths)
    print(f"wrote {n}/{total} records to {out_dir} in {dt:.1f}s "
          f"({total / max(dt, 1e-9):.1f} structs/s scanned)", flush=True)
    return n


if __name__ == "__main__":
    main()
