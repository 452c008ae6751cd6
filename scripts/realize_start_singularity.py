"""Diagnose the Cartesian protocol's MDS starts at the chain ends, in both
packages, on the CPU.

`ca_trace_to_backbone` extrapolates the CA trace straight at both termini,
so the first and last residues' N, CA and C come out collinear and their
virtual Cb lands on CA. This prints, for the restart starts of a helix
bundle's GT maps and of a noise map (uniform in [-1, 1], the kind a model
with random weights samples):
  - the N-CA-C angle and |Cb - CA| of the terminal residues;
  - the fold energy's gradient at the starts: its largest entry, how far
    the f32 gradient is from the f64 one (port), and how far JAX's jitted
    gradient is from its op-by-op one;
  - whether the gradient is finite in each package.

Usage: JAX_PLATFORMS=cpu python scripts/realize_start_singularity.py [--L 128]
"""

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--L", type=int, default=128)
    p.add_argument("--restarts", type=int, default=5)
    args = p.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp
    import torch

    jax.config.update("jax_platforms", "cpu")
    from text2protein_tpu.realize import minimize as jm
    from text2protein_tpu.realize import restraints as jr
    from text2protein_tpu_torch.data.featurize import featurize_structure
    from text2protein_tpu_torch.data.synthetic import helix_bundle_backbone
    from text2protein_tpu_torch.realize import minimize as tm
    from text2protein_tpu_torch.realize import restraints as tr
    from text2protein_tpu_torch.realize.geometry import (
        virtual_cb_from_backbone,
    )

    L = args.L
    bb = helix_bundle_backbone(L, seed=0, compact=False, device="cpu")
    gt, _, _ = featurize_structure(bb, np.ones(L), ss_constraints=False)
    noise = np.random.default_rng(0).uniform(-1, 1, (5, L, L)).astype(
        np.float32)
    noise[-1] = 1.0
    for name, maps in (("gt", gt), ("noise", noise)):
        npz = tr.inverse_scale(maps, L)
        starts = tm._restart_starts(npz["dist_abs"], L, args.restarts, 0)
        x = torch.from_numpy(starts)
        n, ca, c = x[..., 0, :], x[..., 1, :], x[..., 2, :]
        cos = torch.nn.functional.cosine_similarity(n - ca, c - ca, dim=-1)
        cb_ca = (virtual_cb_from_backbone(x) - ca).norm(dim=-1)

        def grad(dtype):
            rst = tr.restraints_from_maps(npz).map(
                lambda t: t.to(dtype) if t.is_floating_point() else t)
            t = x.to(dtype).requires_grad_(True)
            (g,) = torch.autograd.grad(tm.e_fold(t, rst).sum(), t)
            return g.double()

        g32, g64 = grad(torch.float32), grad(torch.float64)
        rj = jr.restraints_from_maps(npz)

        def e_fold_j(b):
            return (jr.restraint_energy(b, rj, 1e9, {"dist": 3.0,
                                                     "orient": 1.0})
                    + 3.0 * jr.clash_energy(b) + 0.2 * jr.bonded_energy(b)
                    + jm.W_RAMA * jr.rama_energy_cartesian(b)
                    + jm.W_HBOND * jr.hbond_energy(b)
                    + 1.0 * jr.long_dist_energy(b, rj))

        gj_eager = np.asarray(jax.vmap(jax.grad(e_fold_j))(
            jnp.asarray(starts)))
        gj_jit = np.asarray(jax.jit(jax.vmap(jax.grad(e_fold_j)))(
            jnp.asarray(starts)))
        scale = float(g64.abs().max())
        print(json.dumps({
            "maps": name, "L": L,
            "terminal_cos_n_ca_c": [float(cos[:, 0].max()),
                                    float(cos[:, -1].max())],
            "terminal_cb_ca_A": [float(cb_ca[:, 0].max()),
                                 float(cb_ca[:, -1].max())],
            "interior_cb_ca_A_min": float(cb_ca[:, 1:-1].min()),
            "grad_max_f64": scale,
            "port_f32_vs_f64_over_max": float((g32 - g64).abs().max())
            / scale,
            "jax_jit_vs_eager_over_max": float(np.abs(gj_jit - gj_eager)
                                               .max() / np.abs(gj_eager)
                                               .max()),
            "port_grad_finite": bool(torch.isfinite(g32).all()),
            "jax_grad_finite": bool(np.isfinite(gj_jit).all()),
        }), flush=True)


if __name__ == "__main__":
    main()
