"""Batched realization in text2protein_tpu_torch.realize.minimize:
`realize_batch` (designs x restarts in one batch) against the per-design
protocol, and `realize_batch_managed`'s retries, flags and keep-best
against the JAX package's on the same injected outcomes (exact).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from text2protein_tpu.data.featurize import featurize_structure
from text2protein_tpu.data.synthetic import helix_bundle_torsions
from text2protein_tpu.eval.tmscore import tm_score
from text2protein_tpu.realize import geometry as jg
from text2protein_tpu.realize import minimize as jm
from text2protein_tpu_torch.realize import minimize as tm
from text2protein_tpu_torch.realize import restraints as tr

L, N = 16, 20


def _padded_map(seed):
    """A (5, N, N) sampled-map-format GT map of an L-residue bundle."""
    phi, psi = helix_bundle_torsions(L, seed=seed)
    bb = np.asarray(jg.build_backbone(jnp.asarray(phi), jnp.asarray(psi)))
    c6d, _, _ = featurize_structure(bb, np.ones(L), ss_constraints=False)
    out = np.zeros((5, N, N), np.float32)
    out[:, :L, :L] = c6d
    return bb, out


def test_realize_batch_matches_the_per_design_protocol():
    """Design k of the batch is design k alone with restart seed
    seed + 31 k, by outcome: batched reductions round differently, 60
    iterations from MDS starts carry that to hundredths of an angstrom,
    and the idealization stage's stiff bonds (0.01 A std) turn those into
    percents of the energy. Held: energies within 5%, backbones at TM >
    0.99."""
    maps = [_padded_map(s) for s in (3, 4)]
    samples = np.stack([m for _, m in maps])
    bbs, es = tm.realize_batch(samples, n_restarts=2, max_iter=10, seed=6,
                               device="cpu")
    assert bbs.shape == (2, L, 3, 3) and es.shape == (2,)
    assert np.isfinite(bbs).all() and np.isfinite(es).all()
    for k, (_, m) in enumerate(maps):
        npz = tr.inverse_scale(m, L)
        bb, e, _ = tm.minimize_cartesian(
            tr.restraints_from_maps(npz), npz["dist_abs"], L, n_restarts=2,
            max_iter=10, seed=6 + 31 * k)
        assert abs(float(e) - es[k]) <= 0.05 * abs(float(e))
        assert tm_score(bbs[k, :, 1], bb.numpy()[:, 1]) > 0.99


@pytest.mark.parametrize("outcomes", ["retry_improves", "retry_fails"])
def test_realize_batch_managed_matches_jax(monkeypatch, outcomes):
    """Injected realize_batch outcomes, read-only like a device array's
    numpy view: the same retries (seed + 7919 attempt), the same kept
    backbones and energies, the same flags in both packages."""
    D = 4
    rng = np.random.default_rng(0)
    first = (rng.standard_normal((D, L, 3, 3)).astype(np.float32),
             np.array([10.0, 12.0, 11.0, 500.0], np.float32))
    better = (rng.standard_normal((D, L, 3, 3)).astype(np.float32),
              np.array([30.0, 1.0, 40.0,
                        9.0 if outcomes == "retry_improves" else 900.0],
                       np.float32))

    def fake_factory(seeds):
        def fake(samples, n_restarts, max_iter, seed, **kw):
            seeds.append(seed)
            out = first if seed == 5 else better
            bbs, es = (a.copy() for a in out)
            bbs.flags.writeable = es.flags.writeable = False
            return bbs, es
        return fake

    results = []
    for mod in (jm, tm):
        seeds = []
        monkeypatch.setattr(mod, "realize_batch", fake_factory(seeds))
        results.append((mod.realize_batch_managed(
            np.zeros((D, 5, N, N)), n_restarts=2, max_iter=3, seed=5),
            seeds))
    (want, want_seeds), (got, got_seeds) = results
    assert got_seeds == want_seeds == ([5, 5 + 7919, 5 + 2 * 7919]
                                       if outcomes == "retry_fails"
                                       else [5, 5 + 7919])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    bbs, es, flags = got
    # only the flagged design took the retry's better outcome
    np.testing.assert_array_equal(bbs[:3], first[0][:3])
    if outcomes == "retry_improves":
        assert es[3] == 9.0 and not flags.any()
    else:
        assert es[3] == 500.0 and flags.tolist() == [False] * 3 + [True]


def test_realize_6d_sample_recovers_the_length(monkeypatch):
    """The padding channel gives L; the default sequence is polyalanine."""
    _, m = _padded_map(3)
    seen = {}

    def fake(npz, seq, **kw):
        seen.update(L=npz["dist_abs"].shape[0], seq=seq, kw=kw)
        return "bb", 1.0, "es"

    monkeypatch.setattr(tm, "run_minimization", fake)
    assert tm.realize_6d_sample(m, device="cpu") == ("bb", 1.0, "es")
    assert seen == {"L": L, "seq": "A" * L, "kw": {"device": "cpu"}}
    with pytest.raises(ValueError):
        bad = m.copy()
        bad[-1, 0, L] = 1.0
        tm.realize_6d_sample(bad, device="cpu")
