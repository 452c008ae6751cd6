"""The Cartesian protocol of text2protein_tpu_torch.realize.minimize
against the JAX package: the distance-geometry start and the restart starts
exactly; `minimize_cartesian` on JAX's own restart seed by outcome; the
relax stage iterate-close; `run_minimization`'s seed and files.

By outcome: both packages pick the same restart, their best selection
energies agree within 2% and their best backbones superpose at TM > 0.98.
(Over the protocol's 70 L-BFGS iterations f32 rounding parts the
trajectories: see test_torch_realize_lbfgs.py.)
"""

import jax
import numpy as np
import torch

from text2protein_tpu.data.featurize import featurize_structure
from text2protein_tpu.data.synthetic import helix_bundle_torsions
from text2protein_tpu.eval.tmscore import tm_score
from text2protein_tpu.realize import geometry as jg
from text2protein_tpu.realize import minimize as jm
from text2protein_tpu.realize import restraints as jr
from text2protein_tpu_torch.realize import minimize as tm
from text2protein_tpu_torch.realize import restraints as tr

L = 24


def _gt(seed=3):
    phi, psi = helix_bundle_torsions(L, seed=seed)
    bb = np.asarray(jg.build_backbone(jax.numpy.asarray(phi),
                                      jax.numpy.asarray(psi)))
    c6d, _, _ = featurize_structure(bb, np.ones(L), ss_constraints=False)
    return bb, c6d, jr.inverse_scale(c6d, L)


BB, C6D, NPZ = _gt()


def test_dist_geometry_init_and_restart_starts_equal_jax():
    np.testing.assert_array_equal(tm.dist_geometry_init(NPZ["dist_abs"]),
                                  jm.dist_geometry_init(NPZ["dist_abs"]))
    ca = jm.dist_geometry_init(NPZ["dist_abs"])
    np.testing.assert_array_equal(tm.ca_trace_to_backbone(ca),
                                  jm.ca_trace_to_backbone(ca))
    for n, seed in [(5, 0), (2, 11), (4, 12345)]:
        np.testing.assert_array_equal(
            tm._restart_starts(NPZ["dist_abs"], L, n, seed),
            jm._restart_starts(NPZ["dist_abs"], L, n, seed))


def test_minimize_cartesian_matches_jax_by_outcome():
    key = jax.random.PRNGKey(4)
    bj, ej, esj = jm.minimize_cartesian(key, jr.restraints_from_maps(NPZ),
                                        NPZ["dist_abs"], L, n_restarts=2,
                                        max_iter=20)
    bj, esj = np.asarray(bj), np.asarray(esj)
    # the JAX package's restart seed, drawn from its key
    seed = int(jax.random.randint(key, (), 0, 2**31 - 1))
    bt, et, est = tm.minimize_cartesian(tr.restraints_from_maps(NPZ),
                                        NPZ["dist_abs"], L, n_restarts=2,
                                        max_iter=20, seed=seed)
    bt, est = bt.numpy(), est.numpy()
    assert bt.shape == (L, 3, 3) and np.isfinite(bt).all()
    assert int(np.argmin(est)) == int(np.argmin(esj))
    assert abs(float(et) - float(ej)) <= 0.02 * abs(float(ej)), (est, esj)
    assert tm_score(bt[:, 1], bj[:, 1]) > 0.98


def test_relax_backbone_matches_jax():
    """The relax stage from a perturbed ground truth (a well-conditioned
    start): 30 iterations within 1e-4 A, the energy within 1e-4 relative
    (the stiff bonded term amplifies coordinate rounding)."""
    x0 = (BB + np.random.default_rng(0).standard_normal(BB.shape)
          * 0.3).astype(np.float32)
    bj, ej = jm.relax_backbone(jax.numpy.asarray(x0),
                               jr.restraints_from_maps(NPZ), max_iter=30)
    bt, et = tm.relax_backbone(torch.from_numpy(x0),
                               tr.restraints_from_maps(NPZ), max_iter=30)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=0,
                               atol=1e-4)
    assert abs(float(et) - float(ej)) <= 1e-4 * abs(float(ej))


def test_run_minimization_seed_maps_to_the_draws(tmp_path, monkeypatch):
    """run_minimization(seed=s) starts the Cartesian protocol from numpy
    seed s, and the torsion protocol from a torch generator seeded with s
    (the JAX package draws both from PRNGKey(s): a deliberate difference);
    it relaxes the best pose, keeps the lower selection energy, and writes
    the two PDBs."""
    calls = []
    gt = torch.from_numpy(BB)

    def fake_cartesian(rst, dist_abs, L, n_restarts, max_iter, seed,
                       solver_log=None):
        calls.append(("cartesian", seed, max_iter))
        return gt, torch.tensor(1e9), torch.tensor([1e9, 2e9])

    def fake_torsions(rst, L, n_restarts, max_iter, fixed_torsions,
                      design_mask, generator, solver_log=None):
        want = torch.Generator().manual_seed(5).get_state()
        calls.append(("torsion", torch.equal(generator.get_state(), want)))
        return gt, torch.tensor(3.0), torch.tensor([3.0])

    monkeypatch.setattr(tm, "minimize_cartesian", fake_cartesian)
    monkeypatch.setattr(tm, "minimize_torsions", fake_torsions)
    bb, e, es = tm.run_minimization(NPZ, "A" * L, outPath=tmp_path, seed=9,
                                    n_restarts=2, max_iter=10, device="cpu")
    assert calls == [("cartesian", 9, 200)]
    rst = tr.restraints_from_maps(NPZ)
    rel, _ = tm.relax_backbone(gt, rst, max_iter=10)
    np.testing.assert_array_equal(bb, rel.numpy())
    with torch.no_grad():
        assert e == float(tm.selection_energy(rel, rst)) < 1e9
    np.testing.assert_array_equal(es, [1e9, 2e9])
    from text2protein_tpu_torch.data.pdbio import read_pdb

    for name in ("structure_before_design.pdb", "final_structure.pdb"):
        assert len(read_pdb(tmp_path / name).amino_residues()) == L
    tm.run_minimization(NPZ, "A" * L, seed=5, method="torsion",
                        use_fastrelax=False, device="cpu")
    assert calls[-1] == ("torsion", True)
