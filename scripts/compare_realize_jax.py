"""The JAX package's `realize_batch` on the maps `chip_smoke.py`'s realize
phase saved, on the CPU, beside the port's numbers from the same run.

Reads chiprun_out/realize_maps.npz (the four L=128 designs' GT maps and
backbones) and chiprun_out/chip_smoke.json (the port's TM-scores and
selection energies of the same maps on the card; or a JSON file of the
phase's output alone), runs
text2protein_tpu.realize.minimize.realize_batch at its defaults (5
restarts, max_iter 300, seed 0) with JAX on the CPU, and prints one JSON
line per design: the TM-score to the ground truth and the selection energy
in each package.

Usage: python scripts/compare_realize_jax.py
       [--maps chiprun_out/realize_maps.npz] [--port chiprun_out/chip_smoke.json]
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--maps", default=str(ROOT / "chiprun_out"
                                         / "realize_maps.npz"))
    p.add_argument("--port", default=str(ROOT / "chiprun_out"
                                         / "chip_smoke.json"))
    args = p.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    from text2protein_tpu.eval.tmscore import tm_score
    from text2protein_tpu.realize.minimize import realize_batch

    z = np.load(args.maps)
    maps, truth = z["maps"], z["backbones"]
    port = {}
    if Path(args.port).exists():
        # chip_smoke.json holds the phase's output under "realize"
        out = json.loads(Path(args.port).read_text())
        port = out.get("realize", out)
    t = time.perf_counter()
    bbs, energies = realize_batch(maps)
    secs = time.perf_counter() - t
    for k in range(len(maps)):
        row = {"design": k,
               "jax_tm": tm_score(bbs[k, :, 1], truth[k, :, 1]),
               "jax_energy": float(energies[k])}
        if port:
            row["port_tm"] = port["batch"]["tm"][k]
            row["port_energy"] = port["batch"]["energies"][k]
        print(json.dumps(row), flush=True)
    print(json.dumps({"jax_cpu_seconds": secs,
                      "cpu": os.cpu_count()}), flush=True)


if __name__ == "__main__":
    main()
