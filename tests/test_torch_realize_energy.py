"""text2protein_tpu_torch.realize.restraints against the JAX package: the
map inversion and restraint tensors exactly, every energy term and its
gradient on a ground-truth and a perturbed backbone, batched against one
element at a time, and finite gradients where the NaN guards act.

Tolerances: energies within 1e-5 relative, floored at 1 (each term is a sum
of squared violations in units of its standard deviation, so 1 is one
standard deviation's worth); gradients within 1e-4 of the term's gradient
scale, its largest entry on the perturbed backbone. At the ground truth a
term's residuals are f32 rounding, and so is its gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2protein_tpu.data.featurize import featurize_structure
from text2protein_tpu.data.synthetic import helix_bundle_torsions
from text2protein_tpu.realize import geometry as jg
from text2protein_tpu.realize import minimize as jm
from text2protein_tpu.realize import restraints as jr
from text2protein_tpu_torch.realize import minimize as tm
from text2protein_tpu_torch.realize import restraints as tr

L = 20
E_RTOL = 1e-5
G_RTOL = 1e-4


def _gt(L=L, seed=3):
    phi, psi = helix_bundle_torsions(L, seed=seed)
    bb = np.asarray(jg.build_backbone(jnp.asarray(phi), jnp.asarray(psi)))
    c6d, _, _ = featurize_structure(bb, np.ones(L), ss_constraints=False)
    return bb, jr.inverse_scale(c6d, L)


BB, NPZ = _gt()
RJ = jr.restraints_from_maps(NPZ)
RT = tr.restraints_from_maps(NPZ)
PERTURBED = (BB + np.random.default_rng(0).standard_normal(BB.shape)
             * 0.5).astype(np.float32)
CA_REF = BB[:, 1]

# name: (JAX energy, port energy) of a (L, 3, 3) / (..., L, 3, 3) backbone
TERMS = {
    "restraint": (
        lambda b: jr.restraint_energy(b, RJ, 1e9, {"dist": 3.0,
                                                   "orient": 1.0}),
        lambda b: tr.restraint_energy(b, RT, 1e9, {"dist": 3.0,
                                                   "orient": 1.0})),
    "restraint_short_band": (
        lambda b: jr.restraint_energy(b, RJ, 12.0, {"dist": 1.0,
                                                    "orient": 0.5}),
        lambda b: tr.restraint_energy(b, RT, 12.0, {"dist": 1.0,
                                                    "orient": 0.5})),
    "long_dist": (lambda b: jr.long_dist_energy(b, RJ),
                  lambda b: tr.long_dist_energy(b, RT)),
    "ca_coordinate": (
        lambda b: jr.ca_coordinate_energy(b, jnp.asarray(CA_REF), 0.5, 0.2),
        lambda b: tr.ca_coordinate_energy(b, torch.from_numpy(CA_REF), 0.5,
                                          0.2)),
    "bonded": (jr.bonded_energy, tr.bonded_energy),
    "bonded_tight": (
        lambda b: jr.bonded_energy(b, len_std=0.01, ang_std=0.017,
                                   omega_std=0.05),
        lambda b: tr.bonded_energy(b, len_std=0.01, ang_std=0.017,
                                   omega_std=0.05)),
    "rama_cartesian": (jr.rama_energy_cartesian, tr.rama_energy_cartesian),
    "hbond": (jr.hbond_energy, tr.hbond_energy),
    "clash": (lambda b: jr.clash_energy(b, 6.0),
              lambda b: tr.clash_energy(b, 6.0)),
    "e_fold": (None, lambda b: tm.e_fold(b, RT)),
    "e_ideal": (None, lambda b: tm.e_ideal(b, RT)),
}


def _jax_e_fold(b):
    return (jr.restraint_energy(b, RJ, 1e9, {"dist": 3.0, "orient": 1.0})
            + 3.0 * jr.clash_energy(b) + 0.2 * jr.bonded_energy(b)
            + jm.W_RAMA * jr.rama_energy_cartesian(b)
            + jm.W_HBOND * jr.hbond_energy(b)
            + 1.0 * jr.long_dist_energy(b, RJ))


def _jax_e_ideal(b):
    return (jr.restraint_energy(b, RJ, 1e9, {"dist": 1.0, "orient": 0.5})
            + 3.0 * jr.clash_energy(b)
            + 2.0 * jr.bonded_energy(b, len_std=0.01, ang_std=0.017,
                                     omega_std=0.05)
            + jm.W_RAMA * jr.rama_energy_cartesian(b)
            + jm.W_HBOND * jr.hbond_energy(b)
            + 0.5 * jr.long_dist_energy(b, RJ))


TERMS["e_fold"] = (_jax_e_fold, TERMS["e_fold"][1])
TERMS["e_ideal"] = (_jax_e_ideal, TERMS["e_ideal"][1])


def _port(fn, x):
    t = torch.from_numpy(x).requires_grad_(True)
    e = fn(t)
    (g,) = torch.autograd.grad(e.sum(), t)
    return e.detach().numpy(), g.numpy()


@pytest.mark.parametrize("name", sorted(TERMS))
@pytest.mark.parametrize("which", ["gt", "perturbed"])
def test_energy_and_gradient_match_jax(name, which):
    fj, ft = TERMS[name]
    x = BB if which == "gt" else PERTURBED
    ej, gj = jax.value_and_grad(fj)(jnp.asarray(x))
    ej, gj = float(ej), np.asarray(gj)
    scale = np.abs(np.asarray(jax.grad(fj)(jnp.asarray(PERTURBED)))).max()
    et, gt = _port(ft, x)
    assert et.shape == ()
    assert abs(float(et) - ej) <= E_RTOL * max(abs(ej), 1.0), (et, ej)
    assert np.isfinite(gt).all()
    assert np.abs(gt - gj).max() <= G_RTOL * scale


def test_energies_batched_match_one_at_a_time():
    x = np.stack([BB, PERTURBED, PERTURBED[::-1].copy()])
    for name, (_, ft) in TERMS.items():
        eb, gb = _port(ft, x[:, None])  # (3, 1) batch
        assert eb.shape == (3, 1), name
        scale = np.abs(gb).max()
        for i in range(3):
            e1, g1 = _port(ft, x[i])
            np.testing.assert_allclose(eb[i, 0], e1, rtol=1e-6, atol=1e-6,
                                       err_msg=name)
            np.testing.assert_allclose(gb[i, 0], g1, rtol=0,
                                       atol=1e-6 * scale, err_msg=name)


def test_stacked_restraints_serve_designs_times_restarts():
    bb2, npz2 = _gt(L, seed=8)
    rst = tr.Restraints.stack([RT, tr.restraints_from_maps(npz2)])
    rst = rst.map(lambda t: t[:, None])  # (D=2, 1, L, L)
    x = torch.from_numpy(np.stack([np.stack([BB, PERTURBED]),
                                   np.stack([bb2, PERTURBED])]))
    e = tm.e_fold(x, rst)
    assert e.shape == (2, 2)
    for d, r in enumerate([RT, tr.restraints_from_maps(npz2)]):
        torch.testing.assert_close(e[d], tm.e_fold(x[d], r), rtol=1e-6,
                                   atol=1e-5)
    with pytest.raises(ValueError):
        tr.Restraints.stack([RT, tr.restraints_from_maps(npz2, dist_std=3)])


def test_per_restart_weights_match_jax_one_weight_at_a_time():
    """The torsion protocol's ladder: one (dist, orient) weight per
    restart."""
    w_dist, w_orient = [3.0, 2.0, 1.0], [1.0, 1.0, 0.5]
    x = np.stack([BB, PERTURBED, PERTURBED])
    got = tr.restraint_energy(torch.from_numpy(x), RT, 24.0, {
        "dist": torch.tensor(w_dist), "orient": torch.tensor(w_orient)})
    for i in range(3):
        want = float(jr.restraint_energy(
            jnp.asarray(x[i]), RJ, 24.0,
            {"dist": w_dist[i], "orient": w_orient[i]}))
        assert abs(float(got[i]) - want) <= E_RTOL * max(abs(want), 1.0)


def test_inverse_scale_and_restraints_equal_jax():
    want = jr.inverse_scale(featurize_structure(
        BB, np.ones(L), ss_constraints=False)[0], L)
    for k, v in NPZ.items():
        np.testing.assert_array_equal(v, want[k])
    for field in tr.Restraints._TENSORS:
        np.testing.assert_array_equal(getattr(RT, field).numpy(),
                                      np.asarray(getattr(RJ, field)))
    assert (RT.dist_std, RT.angle_std) == (RJ.dist_std, RJ.angle_std)
    bad = featurize_structure(BB, np.ones(L), ss_constraints=False)[0]
    bad[-1, 0, 1] = 0.0  # a mask that is not a square
    with pytest.raises(ValueError):
        tr.inverse_scale(bad, L)


def test_restraint_gradient_finite_at_masked_pairs():
    """The NaN guards (the fake Cb_j/Ca_j substituted at filtered pairs
    before the angle math, _safe_norm's eps, dihedral4's 1e-20): a filtered
    pair (beyond 12 A in the maps) whose residues coincide in the backbone,
    and every i == j pair, leave the gradient finite and equal to JAX's."""
    filtered = ~np.asarray(RJ.mask_full)
    # the featurizer writes dmax on the diagonal: every i == j pair is
    # filtered, so the guard's fake atoms stand in for it
    assert filtered.diagonal().all()
    i, j = np.argwhere(np.triu(filtered, 3))[0]
    x = BB.copy()
    x[j] = x[i]  # residue j on top of residue i: Cb_i == Cb_j
    fj, ft = TERMS["restraint"]
    gj = np.asarray(jax.grad(fj)(jnp.asarray(x)))
    scale = np.abs(np.asarray(jax.grad(fj)(jnp.asarray(PERTURBED)))).max()
    et, gt = _port(ft, x)
    assert np.isfinite(gj).all() and np.isfinite(gt).all()
    assert np.abs(gt - gj).max() <= G_RTOL * scale


def test_hbond_max_splits_tied_gradients_like_jax():
    """A chain whose second half lies on its first: each donor sees every
    acceptor twice at the same well depth. JAX's max and torch.amax split
    the gradient evenly between the tied acceptors (torch.max(dim) would
    send it all to one)."""
    sym = np.concatenate([BB[:10], BB[:10]])
    well_ties = 0
    t = torch.from_numpy(sym)
    o = tr.backbone_o_positions(t)
    d = torch.linalg.vector_norm(o[None, :9] - t[:, None, 0], dim=-1)
    d2 = torch.linalg.vector_norm(o[None, 10:19] - t[:, None, 0], dim=-1)
    well_ties = int((d == d2).sum())
    gj = np.asarray(jax.grad(jr.hbond_energy)(jnp.asarray(sym)))
    _, gt = _port(tr.hbond_energy, sym)
    assert well_ties > 0
    assert np.abs(gt - gj).max() <= G_RTOL * np.abs(gj).max()
