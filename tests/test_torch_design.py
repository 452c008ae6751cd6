"""Sequence design in text2protein_tpu_torch (realize/design.py,
realize/design_learned.py with its inverse_head.npz, data/synthetic_seq.py:
numpy code) against the JAX package: exactly equal outputs."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest

from text2protein_tpu.data import synthetic_seq as jss
from text2protein_tpu.data.synthetic import helix_bundle_torsions
from text2protein_tpu.realize import design as jd
from text2protein_tpu.realize import design_learned as jdl
from text2protein_tpu.realize import geometry as jg
from text2protein_tpu_torch.data import synthetic_seq as tss
from text2protein_tpu_torch.realize import design as td
from text2protein_tpu_torch.realize import design_learned as tdl


def _backbone(L, seed):
    phi, psi = helix_bundle_torsions(L, seed=seed)
    return np.asarray(jg.build_backbone(jnp.asarray(phi), jnp.asarray(psi)))


BBS = [_backbone(40, 1), _backbone(33, 2)]


def test_inverse_head_npz_is_a_byte_identical_copy():
    def digest(p):
        return hashlib.sha256(p.read_bytes()).hexdigest()

    assert tdl._HEAD_PATH != jdl._HEAD_PATH
    assert digest(tdl._HEAD_PATH) == digest(jdl._HEAD_PATH)


@pytest.mark.parametrize("i", [0, 1])
def test_design_features_and_energies_equal_jax(i):
    bb = BBS[i]
    for name in ("cb_coords", "burial_fraction", "backbone_phi",
                 "position_energies"):
        np.testing.assert_array_equal(getattr(td, name)(bb),
                                      getattr(jd, name)(bb), err_msg=name)
    for got, want in zip(td.contact_pairs(bb), jd.contact_pairs(bb)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tdl.base_features(bb),
                                  jdl.base_features(bb))
    np.testing.assert_array_equal(tdl.backbone_psi(bb), jdl.backbone_psi(bb))
    seq_idx = np.arange(len(bb)) % 20
    np.testing.assert_array_equal(tdl.seq_features(bb, seq_idx),
                                  jdl.seq_features(bb, seq_idx))


@pytest.mark.parametrize("i", [0, 1])
def test_design_sequence_and_score_equal_jax(i):
    bb = BBS[i]
    L = len(bb)
    fix = np.zeros(L, bool)
    fix[:6] = True
    fixed_seq = "ACDEFG" + "_" * (L - 6)
    for kw in ({}, {"fix_mask": fix, "fixed_seq": fixed_seq}):
        got = td.design_sequence(bb, seed=3, n_sweeps=8, **kw)
        want = jd.design_sequence(bb, seed=3, n_sweeps=8, **kw)
        assert got == want
    assert td.design_score(bb, got[0]) == jd.design_score(bb, want[0])
    head_t, head_j = tdl.InverseHead.load(), jdl.InverseHead.load()
    np.testing.assert_array_equal(head_t.logits(bb), head_j.logits(bb))
    assert head_t.design(bb) == head_j.design(bb)
    assert (head_t.design(bb, fix_mask=fix, fixed_seq=fixed_seq)
            == head_j.design(bb, fix_mask=fix, fixed_seq=fixed_seq))


def test_head_training_and_split_equal_jax():
    seqs = ["".join(td.AA20[(7 * k + i) % 20] for k in range(len(bb)))
            for i, bb in enumerate(BBS)]
    got = tdl.train_head(BBS, seqs, iters=5, seed=1)
    want = jdl.train_head(BBS, seqs, iters=5, seed=1)
    np.testing.assert_array_equal(got.w1, want.w1)
    np.testing.assert_array_equal(got.w2, want.w2)
    paths = [f"r{i}.npz" for i in range(9)]
    assert (tdl.design_eval_split(paths, n_eval=3, seed=2)
            == jdl.design_eval_split(paths, n_eval=3, seed=2))


def test_synthetic_native_sequences_equal_jax():
    for bb in BBS:
        assert (tss.native_like_sequence(bb, seed=4)
                == jss.native_like_sequence(bb, seed=4))
    freq = tss.perturbed_class_freq(5)
    assert freq == jss.perturbed_class_freq(5)
    assert (tss.native_like_sequence(BBS[0], seed=1, freq_tables=freq)
            == jss.native_like_sequence(BBS[0], seed=1, freq_tables=freq))
