"""text2protein_tpu_torch.data.synthetic against the JAX package: the
helix-bundle torsions exactly; the built candidates, their selection and
the featurized dataset at the chain builder's f32 tolerance; the
Rg-guided compaction on the port's L-BFGS by outcome (radius of gyration
within 2% of JAX's, as many CA clashes as JAX's, bonds within 0.05 A of
ideal)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2protein_tpu.data import synthetic as js
from text2protein_tpu.realize.geometry import B_C_N, B_N_CA
from text2protein_tpu_torch.data import synthetic as ts

# the chain builder's f32 error grows along the chain (see
# test_torch_realize_geometry.py): 2e-4 A at L=40
ATOL = 2e-4


@pytest.mark.parametrize("L,seed,kw", [
    (40, 0, {}), (64, 3, {"n_helices": 2}), (90, 7, {"vary_placement": True}),
    (128, 11, {"jitter_deg": 0.0}),
])
def test_helix_bundle_torsions_equal_jax(L, seed, kw):
    for got, want in zip(ts.helix_bundle_torsions(L, seed, **kw),
                         js.helix_bundle_torsions(L, seed, **kw)):
        np.testing.assert_array_equal(got, want)
    assert ts.default_n_helices(L) == js.default_n_helices(L)
    assert ts.valid_helix_counts(L) == js.valid_helix_counts(L)


def test_helix_bundle_backbones_pick_jax_candidates():
    got = ts.helix_bundle_backbones(40, [1, 2], n_candidates=4,
                                    compact=False, device="cpu")
    want = js.helix_bundle_backbones(40, [1, 2], n_candidates=4,
                                     compact=False)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    one = ts.helix_bundle_backbone(40, seed=2, n_candidates=4,
                                   compact=False, device="cpu")
    np.testing.assert_allclose(one, want[1], rtol=0, atol=ATOL)


def _rg(ca):
    return float(np.sqrt(((ca - ca.mean(0)) ** 2).sum(1).mean()))


def test_compaction_by_outcome():
    L, iters = 36, 30
    start = js.helix_bundle_backbones(L, [4], n_candidates=2,
                                      compact=False)[0]
    target = 2.2 * L**0.38
    want = np.asarray(jax.jit(lambda b: js._compact_run(b, target, iters))(
        jnp.asarray(start)))
    got = ts._compact_run(torch.from_numpy(start)[None], target,
                          iters)[0].numpy()
    assert np.isfinite(got).all()
    assert abs(_rg(got[:, 1]) - _rg(want[:, 1])) <= 0.02 * _rg(want[:, 1])
    assert _rg(got[:, 1]) < _rg(start[:, 1])

    def clashes(bb):
        ca = bb[:, 1]
        d = np.linalg.norm(ca[:, None] - ca[None], axis=-1)
        sep = np.abs(np.arange(L)[:, None] - np.arange(L)[None])
        return int(((d < 3.6) & (sep >= 3)).sum())

    assert clashes(got) == clashes(want)
    for bb in (got, want):
        n_ca = np.linalg.norm(bb[:, 1] - bb[:, 0], axis=-1)
        c_n = np.linalg.norm(bb[1:, 0] - bb[:-1, 2], axis=-1)
        assert np.abs(n_ca - B_N_CA).max() < 0.05
        assert np.abs(c_n - B_C_N).max() < 0.05


def test_helix_bundle_dataset_matches_jax():
    got = ts.helix_bundle_dataset(2, 24, seed=1, device="cpu")
    want = js.helix_bundle_dataset(2, 24, seed=1)
    for g, w in zip(got, want):
        assert g["L"] == w["L"] and g["ss_indices"] == w["ss_indices"]
        np.testing.assert_array_equal(g["mask_pair"], w["mask_pair"])
        np.testing.assert_allclose(g["bb"], w["bb"], rtol=0, atol=ATOL)
        np.testing.assert_allclose(g["coords_6d"], w["coords_6d"], rtol=0,
                                   atol=1e-3)
