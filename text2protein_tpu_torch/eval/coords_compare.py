"""6D-map MSE of sampled maps against their ground-truth records (counterpart
of text2protein_tpu/eval/coords_compare.py): the real [:L, :L] crop, with
avg/min/max/std over the samples, written as `coords_6d_losses.yaml`
through the port's own YAML writer (`config.dump_yaml`; no PyYAML).
"""

from __future__ import annotations

import math
import pickle
from pathlib import Path

import numpy as np

from ..config import dump_yaml
from ..data.dataset import load_record


def infer_length_from_padding(sample_cnn: np.ndarray) -> int:
    """L from the padding channel, whose ones form an L x L square
    (`coords_compare.py:15-22`)."""
    n_ones = int((sample_cnn[-1] > 0.5).sum())
    length = int(round(math.sqrt(n_ones)))
    if length * length != n_ones:
        raise ValueError(f"padding channel is not a square: {n_ones} ones")
    return length


def mse_6d(sample_cnn: np.ndarray, gt_cnn: np.ndarray, num_res: int,
           channels: slice | None = None) -> float:
    """Mean squared error on the real crop, over every channel unless
    `channels` selects some (`coords_compare.py:25-33`)."""
    ch = channels if channels is not None else slice(None)
    s = sample_cnn[ch, :num_res, :num_res]
    g = gt_cnn[ch, :num_res, :num_res]
    return float(np.mean((s - g) ** 2))


def coord_compare(sample_dir, gt_dir, out_path=None) -> dict:
    """Every sampled_{id}.pkl under sample_dir against the record {id}.npz
    (or .pt) in gt_dir, on the record's unpadded length; the per-id MSEs
    and their avg/min/max/std/count, also written to `out_path` as YAML
    (`coords_compare.py:36-76`)."""
    sample_dir = Path(sample_dir)
    gt_dir = Path(gt_dir)
    per_pdb = {}
    for pkl_path in sorted(sample_dir.glob("sampled_*.pkl")):
        pdb_id = pkl_path.stem[len("sampled_"):]
        gt_path = next((gt_dir / f"{pdb_id}{ext}" for ext in (".npz", ".pt")
                        if (gt_dir / f"{pdb_id}{ext}").exists()), None)
        if gt_path is None:
            continue
        with open(pkl_path, "rb") as f:
            sample = np.asarray(pickle.load(f))
        if sample.ndim == 4:
            sample = sample[0]
        gt = load_record(gt_path)["coords_6d"]
        per_pdb[pdb_id] = mse_6d(sample, gt, gt.shape[1])

    values = np.array(list(per_pdb.values())) if per_pdb else np.array(
        [np.nan])
    stats = {
        "per_pdb": {k: float(v) for k, v in per_pdb.items()},
        "avg": float(np.mean(values)),
        "min": float(np.min(values)),
        "max": float(np.max(values)),
        "std": float(np.std(values)),
        "count": len(per_pdb),
    }
    if out_path:
        Path(out_path).write_text(dump_yaml(stats, nonfinite=True))
    return stats


def main(argv=None):
    """Compare a directory of sampled_*.pkl maps with ground-truth records
    and write the YAML beside the sample directory
    (`coords_compare.py:79-105`)."""
    import argparse

    p = argparse.ArgumentParser(
        description="6D-map MSE: sampled_*.pkl vs ground-truth records")
    p.add_argument("sample_dir", type=str)
    p.add_argument("gt_dir", type=str,
                   help="processed records dir (.npz or reference .pt)")
    p.add_argument("--out", type=str, default=None,
                   help="output yaml (default: <sample_dir>/../"
                        "coords_6d_losses.yaml)")
    args = p.parse_args(argv)

    out = args.out or str(
        Path(args.sample_dir).parent / "coords_6d_losses.yaml")
    stats = coord_compare(args.sample_dir, args.gt_dir, out_path=out)
    print(f"{stats['count']} pairs  avg={stats['avg']:.5f} "
          f"min={stats['min']:.5f} max={stats['max']:.5f} "
          f"std={stats['std']:.5f} -> {out}")
    return 0


if __name__ == "__main__":
    main()
