"""The torsion-space staged protocol of text2protein_tpu_torch.realize.
minimize against the JAX package, with motif scaffolding: the port starts
from JAX's own draws (Ramachandran-bin torsions and jitter from each
restart's key), both clamp the motif and optimize the masked span.

Held: the protocol's energy of a restart against JAX's (energy within 1e-5
relative, gradient within 1e-4 of its largest entry); one L-BFGS iteration
per stage from JAX's draws, every restart's selection energy within 1e-3
relative and the best backbone within 1e-2 A; the motif torsions within
1e-3 of the input pose in both packages. From a random Ramachandran start
the torsion landscape multiplies f32 rounding several times over at each
iteration (the linesearches still take the same steps), so longer runs
part and are not compared point by point.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from text2protein_tpu.data.featurize import featurize_structure
from text2protein_tpu.data.synthetic import helix_bundle_torsions
from text2protein_tpu.realize import geometry as jg
from text2protein_tpu.realize import minimize as jm
from text2protein_tpu.realize import restraints as jr
from text2protein_tpu_torch.realize import geometry as tg
from text2protein_tpu_torch.realize import minimize as tm
from text2protein_tpu_torch.realize import restraints as tr

L, R, ITERS = 16, 2, 1
KEY = jax.random.PRNGKey(7)


def _problem():
    phi, psi = helix_bundle_torsions(L, seed=3)
    bb = np.asarray(jg.build_backbone(jnp.asarray(phi), jnp.asarray(psi)))
    c6d, _, _ = featurize_structure(bb, np.ones(L), ss_constraints=False)
    return bb, jr.inverse_scale(c6d, L)


BB, NPZ = _problem()
DESIGN = np.zeros(L, bool)
DESIGN[5:11] = True  # the span to redesign; the rest is the motif


def _jax_draws():
    """(phi, psi, jitter_phi, jitter_psi), (R, L) each, as
    `jm.minimize_torsions` draws them from KEY."""
    out = [[], [], [], []]
    for k in jax.random.split(KEY, R):
        phi, psi, _ = jg.random_dihedrals(k, L)
        k1, k2 = jax.random.split(k)
        lim = jnp.deg2rad(10.0)
        jit1 = jax.random.uniform(k1, (L,), minval=-lim, maxval=lim)
        jit2 = jax.random.uniform(k2, (L,), minval=-lim, maxval=lim)
        for lst, a in zip(out, (phi, psi, jit1, jit2)):
            lst.append(np.asarray(a))
    return [np.stack(a) for a in out]


def _wrap(x):
    return np.arctan2(np.sin(x), np.cos(x))


def test_minimize_torsions_with_motif_matches_jax():
    fixed = np.stack([np.asarray(a) for a in jm._torsions_from_backbone(
        jnp.asarray(BB))[:2]])
    bj, ej, esj = jm._minimize_jit(KEY, jr.restraints_from_maps(NPZ), L, R,
                                   ITERS, fixed_torsions=jnp.asarray(fixed),
                                   design_mask=jnp.asarray(DESIGN))
    bj, esj = np.asarray(bj), np.asarray(esj)
    bt, et, est = tm.minimize_torsions(
        tr.restraints_from_maps(NPZ), L, R, ITERS,
        fixed_torsions=torch.from_numpy(fixed),
        design_mask=torch.from_numpy(DESIGN), draws=_jax_draws())
    bt, est = bt.numpy(), est.numpy()
    assert np.isfinite(bt).all()
    np.testing.assert_allclose(est, esj, rtol=1e-3)
    np.testing.assert_allclose(bt, bj, rtol=0, atol=1e-2)
    for bb in (bt, bj):
        phi, psi, _ = (a.numpy() for a in tm._torsions_from_backbone(
            torch.from_numpy(bb)))
        motif = ~DESIGN
        np.testing.assert_allclose(_wrap(phi[motif] - fixed[0][motif]), 0,
                                   atol=1e-3)
        np.testing.assert_allclose(_wrap(psi[motif] - fixed[1][motif]), 0,
                                   atol=1e-3)


def test_torsion_energy_matches_jax():
    """One restart's staged energy (the ladder's weights of restart 1, the
    medium band) at the clamped start."""
    draws = _jax_draws()
    x = np.stack([draws[0][1] + draws[2][1], draws[1][1] + draws[3][1]])

    def ej(x):
        bb = jg.build_backbone(x[0], x[1])
        e = jr.restraint_energy(bb, jr.restraints_from_maps(NPZ), 24.0,
                                {"dist": 2.0, "orient": 1.0})
        e = e + jm.W_RAMA * jr.rama_energy(x[0], x[1])
        e = e + jm.W_HBOND * jr.hbond_energy(bb)
        return e + 5.0 * jr.clash_energy(bb)

    def et(x):
        bb = tg.build_backbone(x[0], x[1])
        e = tr.restraint_energy(bb, tr.restraints_from_maps(NPZ), 24.0,
                                {"dist": 2.0, "orient": 1.0})
        e = e + tm.W_RAMA * tr.rama_energy(x[0], x[1])
        e = e + tm.W_HBOND * tr.hbond_energy(bb)
        return e + 5.0 * tr.clash_energy(bb)

    vj, gj = jax.value_and_grad(ej)(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_(True)
    vt = et(t)
    (gt,) = torch.autograd.grad(vt, t)
    assert abs(float(vt) - float(vj)) <= 1e-5 * abs(float(vj))
    gj = np.asarray(gj)
    assert np.abs(gt.numpy() - gj).max() <= 1e-4 * np.abs(gj).max()


def test_torsion_draws_are_the_generators():
    """The port's own draws: reproducible from a seeded generator, the
    jitter within +-10 degrees."""
    a = tm.torsion_draws(L, 3, torch.Generator().manual_seed(1))
    b = tm.torsion_draws(L, 3, torch.Generator().manual_seed(1))
    for x, y in zip(a, b):
        assert x.shape == (3, L) and torch.equal(x, y)
    assert float(a[2].abs().max()) <= np.deg2rad(10.0) + 1e-6
