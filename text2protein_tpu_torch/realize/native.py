"""Subprocess wrapper for the native C++ minimizer (native/minimize), the
counterpart of text2protein_tpu/realize/native.py.

A CPU L-BFGS restraint minimizer over backbone internal coordinates with
the same restraint model and protocol as `minimize.py`; parallel across
designs on host cores. The binary is the repository's, shared with the JAX
package; the output PDB is read with the port's own `data/pdbio`.
"""

from __future__ import annotations

import struct
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_BINARY = (Path(__file__).resolve().parents[2] / "native" / "minimize"
           / "minimize")


def native_available() -> bool:
    if _BINARY.exists():
        return True
    mk = _BINARY.parent / "Makefile"
    if mk.exists():
        r = subprocess.run(["make", "-C", str(_BINARY.parent)],
                           capture_output=True)
        return r.returncode == 0 and _BINARY.exists()
    return False


def write_maps_bin(npz: dict, path) -> None:
    """Serialize absolute-unit restraint maps for the C++ tool:
    int32 L + 4 x float32[L*L] (dist/omega/theta/phi)."""
    dist = np.asarray(npz["dist_abs"], np.float32)
    L = dist.shape[0]
    with open(path, "wb") as f:
        f.write(struct.pack("<i", L))
        for key in ("dist_abs", "omega_abs", "theta_abs", "phi_abs"):
            arr = np.ascontiguousarray(np.asarray(npz[key], np.float32))
            if arr.shape != (L, L):
                raise ValueError(f"{key} has shape {arr.shape}, not {(L, L)}")
            f.write(arr.tobytes())


def run_minimization_native(npz: dict, seq: str, outPath=None, seed: int = 0,
                            n_restarts: int = 5, max_iter: int = 150):
    """Counterpart of minimize.run_minimization through the C++ tool.

    Returns (backbone (L, 3, 3) np.ndarray, best_energy).
    """
    if not native_available():
        raise RuntimeError("native minimizer not built")
    from ..data.pdbio import read_pdb

    L = len(seq)
    with tempfile.TemporaryDirectory() as tmp:
        bin_path = Path(tmp) / "maps.bin"
        pdb_path = Path(tmp) / "out.pdb"
        write_maps_bin(npz, bin_path)
        r = subprocess.run(
            [str(_BINARY), str(bin_path), str(pdb_path),
             "--restarts", str(n_restarts), "--iters", str(max_iter),
             "--seed", str(seed)],
            capture_output=True, text=True,
        )
        if r.returncode != 0:
            raise RuntimeError(f"native minimizer failed: {r.stderr}")
        best_e = None
        for line in r.stdout.splitlines():
            if line.startswith("best_E="):
                best_e = float(line.split("=")[1].split()[0])
        residues = read_pdb(pdb_path).amino_residues()
        bb = np.zeros((len(residues), 3, 3), np.float32)
        for i, res in enumerate(residues):
            for j, a in enumerate(("N", "CA", "C")):
                c = res.atom(a)
                if c is not None:
                    bb[i, j] = c
    if bb.shape[0] != L:
        raise RuntimeError(f"native minimizer wrote {bb.shape[0]} residues "
                           f"for a sequence of {L}")

    if outPath is not None:
        from ..data.pdbio import write_backbone_pdb

        outPath = Path(outPath)
        outPath.mkdir(parents=True, exist_ok=True)
        write_backbone_pdb(outPath / "structure_before_design.pdb", bb,
                           seq=seq)
    return bb, best_e
