"""The port's C=8 featurization against the JAX package: P-SEA
(`data/ss.annotate_sse`), the coarse SS block constraints, the host
featurizer with `ss_constraints`, the on-device `featurize_batch` with the
SS block channels, PDB featurization and the device batch, on the
committed `data/processed_synth_ss` records (made by the JAX package) and
on the port's own C=8 helix records.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2protein_tpu.conditioning import (
    batch_to_device_arrays as j_batch_to_device_arrays,
)
from text2protein_tpu.config import load_config as j_load_config
from text2protein_tpu.data import dataset as jdataset
from text2protein_tpu.data import ss as jss
from text2protein_tpu.data.featurize import featurize_batch_jax
from text2protein_tpu.data.featurize import (
    featurize_structure as j_featurize_structure,
)
from text2protein_tpu_torch.conditioning import batch_to_device_arrays
from text2protein_tpu_torch.config import load_config
from text2protein_tpu_torch.data import dataset as tdataset
from text2protein_tpu_torch.data import ss as tss
from text2protein_tpu_torch.data.featurize import (
    featurize_batch,
    featurize_structure,
)
from text2protein_tpu_torch.data.helix_records import write_records
from text2protein_tpu_torch.data.pdbio import write_backbone_pdb
from text2protein_tpu_torch.training.steps import featurize

REPO_SS = "data/processed_synth_ss"


@pytest.fixture(scope="module")
def records():
    ds = tdataset.ProteinProcessedDataset(REPO_SS)
    return [ds[i] for i in range(len(ds))]


def test_psea_and_constraints_match_jax_on_every_record(records):
    """annotate_sse and get_coarse_constraints (dist_threshold 5, as the
    featurizer calls it) on the CAs of every committed SS record: equal to
    JAX exactly, and to the record's stored channels 4:7 and ss_indices."""
    with_blocks = 0
    for rec in records:
        ca = rec["coords"][:, 1]
        np.testing.assert_array_equal(tss.annotate_sse(ca),
                                      jss.annotate_sse(ca))
        cb = rec["coords_6d"][0]
        want, want_str = jss.get_coarse_constraints(ca, cb, dist_threshold=5)
        got, got_str = tss.get_coarse_constraints(ca, cb, dist_threshold=5)
        assert got_str == want_str == rec["ss_indices"], rec["id"]
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got.transpose(2, 0, 1),
                                      rec["coords_6d"][4:7])
        with_blocks += bool(got_str)
    assert len(records) == 384 and with_blocks > 300


def test_psea_sees_strands_as_jax_does():
    """A zigzag CA trace (3.45 A steps, two flat strands 4.8 A apart)
    through both packages' P-SEA: the same annotation, with strands in it,
    and the same constraints."""
    i = np.arange(12)
    strand = np.stack([3.3 * i, 1.0 * (i % 2), np.zeros(12)], axis=1)
    ca = np.concatenate([strand, strand[::-1] + [0, 0, 4.8]])
    got, want = tss.annotate_sse(ca), jss.annotate_sse(ca)
    np.testing.assert_array_equal(got, want)
    assert "b" in got
    cb = np.linspace(-1, 1, 24 * 24).reshape(24, 24)
    g, gs = tss.get_coarse_constraints(ca, cb)
    w, ws = jss.get_coarse_constraints(ca, cb)
    assert gs == ws
    np.testing.assert_array_equal(g, w)


def test_constraints_reject_a_length_mismatch():
    ca = np.random.default_rng(0).standard_normal((10, 3)) * 3
    assert tss.get_coarse_constraints(ca, np.zeros((12, 12))) == (None, None)
    assert jss.get_coarse_constraints(ca, np.zeros((12, 12))) == (None, None)
    bb = np.random.default_rng(1).standard_normal((12, 3, 3)) * 3
    assert featurize_structure(bb, np.ones(12), True, ca_coords=ca) == (
        None, None, None)


def test_featurize_structure_c8_matches_jax(records):
    """Every eighth committed record's backbone, with a masked residue:
    the C=8 maps, pair mask and block string equal to JAX exactly; the
    unmasked maps equal the record."""
    for rec in records[::8]:
        bb = rec["coords"]
        L = len(bb)
        got = featurize_structure(bb, np.ones(L), True)
        assert got[0].shape == (8, L, L)
        np.testing.assert_array_equal(got[0], rec["coords_6d"])
        assert got[2] == rec["ss_indices"]
        mask = np.ones(L)
        mask[L // 3] = 0
        got = featurize_structure(bb, mask, True)
        want = j_featurize_structure(bb, mask, True)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]


def _padded(recs, n):
    bb = np.zeros((len(recs), n, 3, 3), np.float32)
    mask = np.zeros((len(recs), n), bool)
    ss = np.zeros((len(recs), n, n, 3), np.uint8)
    for i, r in enumerate(recs):
        L = len(r["coords"])
        bb[i, :L] = r["coords"]
        mask[i, :L] = True
        ss[i, :L, :L] = r["coords_6d"][4:7].transpose(1, 2, 0)
    return bb, mask, ss


def _assert_c8_maps_match(got, want):
    """(B, N, N, 8) f32 maps of two on-device featurizers: dist, omega and
    theta within 1e-6; phi, an arccos of f32 sums (its slope 1/sin grows
    to ~15 at the records' near-straight angles), compared as the cosine
    it is taken of, within 1e-6; the SS and mask channels exactly."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got[..., :3], want[..., :3], atol=1e-6,
                               rtol=0)

    def cos(phi):
        return np.cos((phi.astype(np.float64) + 1) / 2 * np.pi)

    np.testing.assert_allclose(cos(got[..., 3]), cos(want[..., 3]),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[..., 4:], want[..., 4:])


def test_featurize_batch_c8_matches_jax(records):
    """Three records padded to 128, the SS block channels as uint8: the
    on-device C=8 maps against featurize_batch_jax (tolerances of
    `_assert_c8_maps_match`), the pair mask exactly."""
    recs = [records[i] for i in (0, 5, 77)]
    bb, mask, ss = _padded(recs, 128)
    want, want_pair = featurize_batch_jax(
        jnp.asarray(bb), jnp.asarray(mask), 8, ss_block=jnp.asarray(ss))
    got, pair = featurize_batch(torch.from_numpy(bb), torch.from_numpy(mask),
                                8, ss_block=torch.from_numpy(ss))
    assert got.shape == (3, 128, 128, 8) and got.dtype == torch.float32
    _assert_c8_maps_match(got.numpy(), want)
    np.testing.assert_array_equal(pair.numpy(), np.asarray(want_pair))


def test_device_batch_c8_matches_jax_and_the_host(records):
    """make_batch of four records, batch_to_device_arrays under
    featurize_on_device: the same arrays as the JAX package's (ss_block
    uint8 included); featurized in the step, the JAX step's maps
    (`_assert_c8_maps_match`), and the host's SS and mask channels
    exactly."""
    recs = records[10:14]
    batch = tdataset.make_batch(recs, 128)
    cfgd = {"data": {"max_res_num": 128, "num_channels": 8,
                     "featurize_on_device": True},
            "model": {"condition": ["length", "ss"]}}
    want = j_batch_to_device_arrays(batch, j_load_config(cfgd), device=False)
    got = batch_to_device_arrays(batch, load_config(cfgd))
    assert set(got) == set(want) == {"bb", "mask_res", "ss_spans", "length",
                                     "ss_block"}
    for k in got:
        assert got[k].numpy().dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    maps = featurize(load_config(cfgd), got)["coords_6d"].numpy()
    jmaps, _ = featurize_batch_jax(want["bb"], want["mask_res"], 8,
                                   ss_block=want["ss_block"])
    _assert_c8_maps_match(maps, jmaps)
    host = batch["coords_6d"].transpose(0, 2, 3, 1)
    np.testing.assert_array_equal(maps[..., 4:], host[..., 4:])


def test_featurize_pdb_file_c8_matches_jax(tmp_path, records):
    """PDBs written from four records (3-decimal coordinates): the C=8
    record of each through both packages, the maps within 1e-6 and the
    rest equal."""
    for rec in records[20:24]:
        path = tmp_path / f"{rec['id']}.pdb"
        write_backbone_pdb(path, rec["coords"], seq=rec["aa_str"])
        want = jdataset.featurize_pdb_file(path, 4, 128, ss_constraints=True)
        got = tdataset.featurize_pdb_file(path, 4, 128, ss_constraints=True)
        assert got["coords_6d"].shape[0] == 8
        np.testing.assert_allclose(got["coords_6d"], want["coords_6d"],
                                   atol=1e-6, rtol=0)
        np.testing.assert_array_equal(got["coords_6d"][4:],
                                      want["coords_6d"][4:])
        for k in ("id", "aa_str", "ss_indices", "caption"):
            assert got[k] == want[k], k
        for k in ("coords", "aa", "mask_pair"):
            np.testing.assert_array_equal(got[k], want[k])


def test_helix_records_c8_are_annotated_as_jax_would(tmp_path):
    """The port's C=8 helix records (the chip run's training data): every
    one with at least one SS block, and the JAX featurizer gives each the
    same maps and block string."""
    write_records(tmp_path, 6, lengths=(64, 128), num_channels=8)
    ds = tdataset.ProteinProcessedDataset(tmp_path)
    for i in range(len(ds)):
        rec = ds[i]
        assert rec["ss_indices"] and rec["coords_6d"].shape[0] == 8
        L = len(rec["coords"])
        want = j_featurize_structure(rec["coords"], np.ones(L), True)
        np.testing.assert_array_equal(rec["coords_6d"], want[0])
        assert rec["ss_indices"] == want[2]
