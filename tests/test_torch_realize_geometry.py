"""text2protein_tpu_torch.realize.geometry against the JAX package: the
NeRF chain builder (alone and batched over restarts), the virtual Cb, the
dihedral and angle helpers and the torsion round trip, at atol 1e-5.

The chain builder is held at atol 5e-5 at L=16 (coordinates up to ~30 A):
its f32 error grows along the chain, and at this length JAX's own scanned
build and its op-by-op build part by the same order (held alike)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2protein_tpu.realize import geometry as jg
from text2protein_tpu.realize import minimize as jm
from text2protein_tpu_torch.realize import geometry as tg
from text2protein_tpu_torch.realize import minimize as tm

L = 16
ATOL = 1e-5
BUILD_ATOL = 5e-5


def _jax_torsions(seed, n=L):
    phi, psi, om = jg.random_dihedrals(jax.random.PRNGKey(seed), n)
    return np.asarray(phi), np.asarray(psi), np.asarray(om)


def _wrap(x):
    return np.arctan2(np.sin(x), np.cos(x))


@pytest.mark.parametrize("seed", [0, 3])
def test_build_backbone_matches_jax(seed):
    phi, psi, om = _jax_torsions(seed)
    want = np.asarray(jg.build_backbone(jnp.asarray(phi), jnp.asarray(psi),
                                        jnp.asarray(om)))
    got = tg.build_backbone(torch.tensor(phi), torch.tensor(psi),
                            torch.tensor(om)).numpy()
    assert got.shape == (L, 3, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=BUILD_ATOL)
    # JAX op by op parts from its jitted build by the same order
    with jax.disable_jit():
        eager = np.asarray(jg.build_backbone(
            jnp.asarray(phi), jnp.asarray(psi), jnp.asarray(om)))
    np.testing.assert_allclose(eager, want, rtol=0, atol=BUILD_ATOL)
    # omega defaults to trans
    got_trans = tg.build_backbone(torch.tensor(phi),
                                  torch.tensor(psi)).numpy()
    want_trans = np.asarray(jg.build_backbone(jnp.asarray(phi),
                                              jnp.asarray(psi)))
    np.testing.assert_allclose(got_trans, want_trans, rtol=0,
                               atol=BUILD_ATOL)


def test_build_backbone_batched_matches_one_at_a_time():
    draws = [_jax_torsions(s) for s in (1, 2, 5)]
    phi = torch.from_numpy(np.stack([d[0] for d in draws]))
    psi = torch.from_numpy(np.stack([d[1] for d in draws]))
    batched = tg.build_backbone(phi.view(3, 1, L), psi.view(3, 1, L))
    assert batched.shape == (3, 1, L, 3, 3)
    for i in range(3):
        alone = tg.build_backbone(phi[i], psi[i])
        torch.testing.assert_close(batched[i, 0], alone, rtol=0, atol=0)


def test_builder_gradient_matches_jax():
    phi, psi, om = _jax_torsions(2, 10)
    want = np.asarray(jax.grad(
        lambda p: jnp.sum(jg.build_backbone(p, jnp.asarray(psi),
                                            jnp.asarray(om)) ** 2))(
        jnp.asarray(phi)))
    p = torch.tensor(phi).requires_grad_(True)
    loss = torch.sum(tg.build_backbone(p, torch.tensor(psi),
                                       torch.tensor(om)) ** 2)
    (got,) = torch.autograd.grad(loss, p)
    assert np.isfinite(got.numpy()).all()
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= 1e-4 * scale


def test_virtual_cb_dihedral_angle_match_jax():
    rng = np.random.default_rng(0)
    bb = rng.standard_normal((2, L, 3, 3)).astype(np.float32) * 5
    np.testing.assert_allclose(
        tg.virtual_cb_from_backbone(torch.from_numpy(bb)).numpy(),
        np.asarray(jg.virtual_cb_from_backbone(jnp.asarray(bb))),
        rtol=0, atol=ATOL)
    pts = [rng.standard_normal((L, 3)).astype(np.float32) for _ in range(4)]
    # coincident points: 0 instead of NaN, as in JAX
    pts[2][3] = pts[1][3]
    np.testing.assert_allclose(
        tg.dihedral4(*map(torch.from_numpy, pts)).numpy(),
        np.asarray(jg.dihedral4(*map(jnp.asarray, pts))), rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        tg.angle3(*map(torch.from_numpy, pts[:3])).numpy(),
        np.asarray(jg.angle3(*map(jnp.asarray, pts[:3]))), rtol=0,
        atol=ATOL)


def test_torsions_from_backbone_roundtrip_matches_jax():
    phi, psi, om = _jax_torsions(3, 14)
    bb = jg.build_backbone(jnp.asarray(phi), jnp.asarray(psi),
                           jnp.asarray(om))
    want = [np.asarray(a) for a in jm._torsions_from_backbone(bb)]
    got = [a.numpy() for a in tm._torsions_from_backbone(
        torch.tensor(np.asarray(bb)))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(_wrap(g - w), 0, atol=ATOL)
    # the measured torsions are the inputs (first phi, last psi canonical)
    np.testing.assert_allclose(_wrap(got[0][1:] - phi[1:]), 0, atol=1e-4)
    np.testing.assert_allclose(_wrap(got[1][:-1] - psi[:-1]), 0, atol=1e-4)


def test_random_dihedrals_draw_from_the_bin_table():
    gen = torch.Generator().manual_seed(3)
    phi, psi, om = tg.random_dihedrals(L, gen, (4,))
    assert phi.shape == psi.shape == om.shape == (4, L)
    bins = np.deg2rad(tg._RAMA_BINS).astype(np.float32)
    pairs = np.stack([phi.numpy(), psi.numpy()], -1).reshape(-1, 2)
    assert all((np.abs(bins - p).max(1) == 0).any() for p in pairs)
    np.testing.assert_allclose(om.numpy(), np.float32(np.pi))
    again = tg.random_dihedrals(L, torch.Generator().manual_seed(3), (4,))
    assert torch.equal(again[0], phi) and torch.equal(again[1], psi)
