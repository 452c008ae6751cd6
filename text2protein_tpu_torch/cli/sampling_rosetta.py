"""Backbone realization CLI (counterpart of
text2protein_tpu/cli/sampling_rosetta.py), with the same flags, directory
layout and score.txt keys.

For each sampled_*.pkl under --coords_path: recover L from the padding
channel, clip + inverse-scale the maps, run `n_iter` minimization rounds
(`realize/minimize.run_minimization`, round n seeded with n), score each
round, and write under `{--out_root}/{coords_path's grandparent's
name}/{id}/`: `round_N/` (structure_before_design.pdb, final_structure.pdb
with relax, structure_after_design.pdb with --fastdesign, score.txt), a
`best_run` symlink to the lowest-energy round and `rosetta_{id}.pdb`, the
best round's final structure. score.txt is YAML that PyYAML reads
(non-finite energies as .nan/.inf).

Usage:
  python -m text2protein_tpu_torch.cli.sampling_rosetta CONFIG
      --coords_path DIR [--n_iter 1] [--n_restarts 5] [--max_iter 150]
      [--fastdesign --designer learned|physics] [--pdb FILE --mask_info
       1:5,10:15] [--no_fastrelax] [--out_root sampling/rosetta]
      [--device cpu]
"""

from __future__ import annotations

import argparse
import pickle
import time
from pathlib import Path

import numpy as np

from .. import resolve_device
from ..config import dump_yaml


def build_argparser():
    p = argparse.ArgumentParser(
        description="Realize 3D backbones from 6D maps")
    p.add_argument("config", type=str)
    p.add_argument("--coords_path", type=str, required=True,
                   help="directory of sampled_*.pkl maps")
    p.add_argument("--pdb", type=str, default=None,
                   help="input PDB for motif scaffolding (masked spans)")
    p.add_argument("--mask_info", type=str, default=None)
    p.add_argument("--n_iter", type=int, default=1)
    p.add_argument("--n_restarts", type=int, default=5)
    p.add_argument("--max_iter", type=int, default=150)
    p.add_argument("--angle_std", type=float, default=10.0)
    p.add_argument("--dist_std", type=float, default=2.0)
    p.add_argument("--out_root", type=str, default="sampling/rosetta")
    p.add_argument("--fastdesign", action="store_true",
                   help="design a sequence onto each minimized backbone and "
                        "write structure_after_design.pdb with a before/"
                        "after score split")
    p.add_argument("--designer", type=str, default="learned",
                   choices=["learned", "physics"],
                   help="learned = trained inverse-folding head; physics = "
                        "zero-shot knowledge-based Potts design")
    p.add_argument("--no_fastrelax", dest="fastrelax", action="store_false",
                   default=True,
                   help="skip the CA-restrained relax round on the best pose")
    p.add_argument("--device", type=str, default=None,
                   help="default: the GPU")
    return p


def _motif_pose(pdb, mask_info, L):
    """(pose backbone (L, 3, 3), sequence with '_' at redesigned positions)
    of a motif-scaffolding input PDB."""
    from ..data.pdbio import read_pdb
    from ..data.vocab import NON_STANDARD_TO_STANDARD, THREE_TO_ONE

    residues = read_pdb(pdb).amino_residues()[:L]
    pose_bb = np.zeros((L, 3, 3), np.float32)
    seq_chars = []
    for i, r in enumerate(residues):
        name = r.name if r.name in THREE_TO_ONE else \
            NON_STANDARD_TO_STANDARD.get(r.name, "UNK")
        seq_chars.append(THREE_TO_ONE[name])
        for j, a in enumerate(("N", "CA", "C")):
            c = r.atom(a)
            if c is not None:
                pose_bb[i, j] = c
    seq_chars += ["_"] * (L - len(seq_chars))
    if mask_info:
        for tok in mask_info.split(","):
            if ":" in tok:
                s_, e_ = tok.split(":")
                for i in range(int(s_) - 1, min(int(e_), L)):
                    seq_chars[i] = "_"
            else:
                seq_chars[int(tok) - 1] = "_"
    return pose_bb, "".join(seq_chars)


def main(argv=None):
    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)

    from ..realize.minimize import run_minimization
    from ..realize.restraints import inverse_scale

    coords_dir = Path(args.coords_path)
    pkls = sorted(coords_dir.glob("sampled_*.pkl"))
    if not pkls:
        raise FileNotFoundError(f"no sampled_*.pkl under {coords_dir}")

    for pkl_path in pkls:
        t0 = time.time()
        pdb_id = pkl_path.stem[len("sampled_"):]
        with open(pkl_path, "rb") as f:
            coords_6d = np.asarray(pickle.load(f))
        if coords_6d.ndim == 4:
            coords_6d = coords_6d[0]

        out_path = Path(args.out_root, coords_dir.parent.parent.stem,
                        str(pdb_id))
        out_path.mkdir(parents=True, exist_ok=True)

        msk = np.round(coords_6d[-1])
        L = np.sqrt((msk == 1).sum())
        if not float(L).is_integer():
            raise ValueError("Terminated due to improper masking channel...")
        L = int(L)
        if L < 4:
            print(f"{pdb_id}: skipping degenerate design (L={L})")
            continue

        # motif scaffolding: fix the input pose outside the masked spans,
        # redesign inside
        pose_bb = None
        if args.pdb is not None:
            pose_bb, seq = _motif_pose(args.pdb, args.mask_info, L)
        else:
            seq = "A" * L

        npz = inverse_scale(coords_6d, L)  # clips to [-1,1] + inverse-scales

        scores = {}
        best_e, best_run = np.inf, None
        for n in range(args.n_iter):
            run_dir = out_path / f"round_{n + 1}"
            bb, e_best, energies = run_minimization(
                npz, seq, outPath=run_dir, seed=n,
                n_restarts=args.n_restarts, max_iter=args.max_iter,
                angle_std=args.angle_std, dist_std=args.dist_std,
                pose_bb=pose_bb, use_fastrelax=args.fastrelax,
                device=device,
            )
            scores[f"round_{n + 1}"] = {
                "total_energy": float(e_best),
                "avg_score_per_res": float(e_best / L),
                "restart_energies": [float(x) for x in energies],
            }
            # the FastDesign role: fixed-backbone sequence design + score
            # split (design score before/after, beside the cart energy)
            if args.fastdesign:
                from ..data.pdbio import write_backbone_pdb
                from ..realize.design import design_score, design_sequence

                fix = None
                if pose_bb is not None:
                    fix = np.asarray([c != "_" for c in seq])
                if args.designer == "learned":
                    from ..realize.design_learned import InverseHead

                    designed = InverseHead.load().design(
                        bb, fix_mask=fix, fixed_seq=seq
                    )
                else:
                    designed, _ = design_sequence(bb, seed=n, fix_mask=fix,
                                                  fixed_seq=seq)
                write_backbone_pdb(run_dir / "structure_after_design.pdb",
                                   bb, seq=designed)
                before = design_score(bb, seq.replace("_", "A"))
                after = design_score(bb, designed)
                scores[f"round_{n + 1}"].update({
                    "designed_seq": designed,
                    "design_score_before": round(before["per_res"], 4),
                    "design_score_after": round(after["per_res"], 4),
                    "cart_energy": float(e_best),
                })
            # sorted keys, as yaml.safe_dump writes them
            score = scores[f"round_{n + 1}"]
            (run_dir / "score.txt").write_text(
                dump_yaml(dict(sorted(score.items())), nonfinite=True))
            if e_best < best_e:
                best_e, best_run = e_best, run_dir

        if best_run is not None:
            link = out_path / "best_run"
            if link.is_symlink() or link.exists():
                link.unlink()
            link.symlink_to(best_run.name)
            # the final structure alias: structure_after_design.pdb carries
            # both the relaxed coordinates and the designed sequence, so it
            # wins over final_structure.pdb (the placeholder sequence)
            candidates = ["structure_before_design.pdb"]
            if args.fastrelax:
                candidates.insert(0, "final_structure.pdb")
            if args.fastdesign:
                candidates.insert(0, "structure_after_design.pdb")
            final = next((best_run / c for c in candidates
                          if (best_run / c).exists()),
                         best_run / candidates[-1])
            if final.exists():
                (out_path / f"rosetta_{pdb_id}.pdb").write_bytes(
                    final.read_bytes()
                )

        print(f"{pdb_id}: L={L} best_E={best_e:.1f} "
              f"({time.time() - t0:.1f}s, {args.n_iter} rounds)")

    return 0


if __name__ == "__main__":
    main()
