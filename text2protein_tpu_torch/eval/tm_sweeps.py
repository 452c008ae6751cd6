"""Batch TM-score sweeps (counterpart of text2protein_tpu/eval/tm_sweeps.py),
each writing `tm-scores.json`:
  * `train_gen_tm_compare`: designed structures against (up to `max_train`
    of) the training set, the novelty sweep, with per-design
    min/max/avg/std;
  * `gt_gen_tm_compare`: designed structures against their ground truths,
    with the >0.5 / >0.4 / >0.3 bucket counts;
  * `reu_stats`: `avg_score_per_res` over a realization run's score.txt
    files (read with the port's `config.parse_yaml`).
A pair that fails is counted out. Pairs run in a thread pool: the native
scorer waits on a TM-align subprocess and the Python one is numpy.
"""

from __future__ import annotations

import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from ..config import parse_yaml
from .tmscore import run_tmalign, tm_score_from_pdbs


def _score_pair(pair):
    """The pair's TM-score, or None when scoring it fails (a broken PDB is
    skipped, as the JAX sweep does)."""
    target, ref, use_native = pair
    try:
        if use_native:
            return run_tmalign(target, ref)
        return tm_score_from_pdbs(target, ref)
    except Exception:
        return None


def train_gen_tm_compare(designed_paths, train_pdb_paths,
                         out_path="tm-scores.json", max_train=100,
                         use_native=True, num_workers=8):
    """Novelty sweep: each design against up to `max_train` training
    structures (`tm_sweeps.py:45-76`)."""
    train_pdb_paths = [Path(p) for p in train_pdb_paths][:max_train]
    scores = []
    samples = {}
    with ThreadPoolExecutor(max_workers=num_workers) as ex:
        for target in map(Path, designed_paths):
            pairs = [(str(target), str(r), use_native)
                     for r in train_pdb_paths]
            vals = [v for v in ex.map(_score_pair, pairs) if v is not None]
            if not vals:
                continue
            scores.extend(vals)
            samples[f"sampled_{target.stem}"] = {
                "sample_min": float(min(vals)),
                "sample_max": float(max(vals)),
                "sample_avg": float(np.mean(vals)),
                "sample_std": float(np.std(vals)),
            }
    out = {
        "samples": samples,
        "tm_max": float(max(scores)) if scores else 0.0,
        "tm_min": float(min(scores)) if scores else 0.0,
        "tm_avg": float(np.mean(scores)) if scores else 0.0,
        "tm_std": float(np.std(scores)) if scores else 0.0,
        "reference_count": len(train_pdb_paths),
        "target_count": len(list(designed_paths)),
    }
    with open(out_path, "w") as f:
        json.dump(out, f, indent=4)
    return out


def gt_gen_tm_compare(pairs, out_path="tm-scores.json", use_native=True,
                      num_workers=8):
    """Quality sweep: each design against its ground truth, with TM bucket
    counts (`tm_sweeps.py:79-119`). `pairs`: (pdb_name, designed_path,
    gt_path) tuples."""
    scores = []
    samples = {}
    buckets = {"gt50": 0, "gt40": 0, "gt30": 0, "lt30": 0}
    jobs = [(str(d), str(g), use_native) for _, d, g in pairs]
    names = [n for n, _, _ in pairs]
    with ThreadPoolExecutor(max_workers=num_workers) as ex:
        for name, score in zip(names, ex.map(_score_pair, jobs)):
            if score is None:
                continue
            scores.append(score)
            samples[name] = float(score)
            if score > 0.5:
                buckets["gt50"] += 1
            elif score > 0.4:
                buckets["gt40"] += 1
            elif score > 0.3:
                buckets["gt30"] += 1
            else:
                buckets["lt30"] += 1
    out = {
        "samples": samples,
        "tm_max": float(max(scores)) if scores else 0.0,
        "tm_min": float(min(scores)) if scores else 0.0,
        "tm_avg": float(np.mean(scores)) if scores else 0.0,
        "tm_std": float(np.std(scores)) if scores else 0.0,
        "reference_count": len(names),
        **buckets,
    }
    with open(out_path, "w") as f:
        json.dump(out, f, indent=4)
    return out


def reu_stats(score_files):
    """avg_score_per_res over realization score files, each a YAML mapping
    (`tm_sweeps.py:122-143`); a file without it is skipped."""
    vals = []
    for p in map(Path, score_files):
        try:
            vals.append(float(parse_yaml(p.read_text())["avg_score_per_res"]))
        except (OSError, ValueError, KeyError, TypeError):
            continue
    if not vals:
        return {"count": 0}
    return {
        "count": len(vals),
        "avg": float(np.mean(vals)),
        "min": float(np.min(vals)),
        "max": float(np.max(vals)),
        "std": float(np.std(vals)),
    }


def _design_stem(p):
    """A design's name: the realization CLI prefixes its alias with
    rosetta_."""
    s = p.stem
    return s[len("rosetta_"):] if s.startswith("rosetta_") else s


def main(argv=None):
    """TM-score a directory of designed PDBs against a reference set
    (`tm_sweeps.py:146-216`). --mode novelty: every design against every
    reference; --mode gt: each design against the same-stem file in
    --refs, with the buckets; --mode reu: the REU statistics of the
    score.txt files under --designed."""
    import argparse

    p = argparse.ArgumentParser(description="TM-score sweeps")
    p.add_argument("--mode", type=str, default="novelty",
                   choices=["novelty", "gt", "reu"])
    p.add_argument("--designed", type=str, required=True,
                   help="directory of designed *.pdb (novelty/gt) or a "
                        "realization out_root containing score.txt yamls "
                        "(reu)")
    p.add_argument("--refs", type=str, default=None,
                   help="reference *.pdb directory (train set or GT); "
                        "required for novelty/gt")
    p.add_argument("--out", type=str, default="tm-scores.json")
    p.add_argument("--max_train", type=int, default=100)
    p.add_argument("--no_native", action="store_true",
                   help="use the Python TM-score instead of native/tmalign")
    args = p.parse_args(argv)

    if args.mode == "reu":
        files = sorted(Path(args.designed).rglob("score.txt"))
        if not files:
            p.error(f"no score.txt under {args.designed}")
        out = reu_stats(files)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=4)
        print(json.dumps(out, indent=2))
        return 0

    if not args.refs:
        p.error("--refs is required for novelty/gt")
    # a flat directory of *.pdb, or the realization CLI's layout
    # (<out_root>/<pdb_id>/rosetta_<pdb_id>.pdb)
    root = Path(args.designed)
    designed = (sorted(root.glob("*.pdb"))
                + sorted(root.glob("*/rosetta_*.pdb")))
    refs = sorted(Path(args.refs).glob("*.pdb"))
    if not designed:
        p.error(f"no *.pdb (or */rosetta_*.pdb) under {args.designed}")
    if not refs:
        p.error(f"no *.pdb under {args.refs}")
    use_native = not args.no_native

    if args.mode == "novelty":
        out = train_gen_tm_compare(designed, refs, out_path=args.out,
                                   max_train=args.max_train,
                                   use_native=use_native)
    else:
        by_stem = {r.stem: r for r in refs}
        pairs = [(_design_stem(d), d, by_stem[_design_stem(d)])
                 for d in designed if _design_stem(d) in by_stem]
        if not pairs:
            p.error("no designed/ref stem matches for --mode gt")
        if len(pairs) < len(designed):
            missing = [d.name for d in designed
                       if _design_stem(d) not in by_stem]
            print(f"WARNING: {len(missing)}/{len(designed)} designs have no "
                  f"same-stem reference and are excluded: {missing[:8]}")
        out = gt_gen_tm_compare(pairs, out_path=args.out,
                                use_native=use_native)
    print(json.dumps({k: v for k, v in out.items()
                      if not isinstance(v, dict)}, indent=2))
    return 0


if __name__ == "__main__":
    main()
