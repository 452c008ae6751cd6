"""The port's PDB reader and writer, PDB featurization and sampler
conditions against the JAX package (text2protein_tpu/data/pdbio.py,
data/dataset.featurize_pdb_file, conditioning.py), on the PDB that
`torch_port_helpers.write_helix_pdb` writes.
"""

import numpy as np
import pytest
import torch

from text2protein_tpu import conditioning as jcond
from text2protein_tpu.config import load_config as j_load_config
from text2protein_tpu.data import dataset as jdataset
from text2protein_tpu.data import pdbio as jpdbio
from text2protein_tpu_torch import conditioning as tcond
from text2protein_tpu_torch.config import load_config
from text2protein_tpu_torch.data import dataset as tdataset
from text2protein_tpu_torch.data import pdbio as tpdbio
from text2protein_tpu_torch.data.helix_records import helix_backbone

from torch_port_helpers import (  # noqa: F401  (a fixture)
    HELIX_PDB_LENGTHS,
    N,
    one_torch_thread,
    tiny_config_dict,
    write_helix_pdb,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

L_A, L_B = HELIX_PDB_LENGTHS


@pytest.fixture
def pdb(tmp_path):
    return write_helix_pdb(tmp_path / "helix.pdb")


def _residues(st):
    return [(r.name, r.chain, r.res_seq, r.icode, list(r.atom_names),
             np.asarray(r.coords).tolist()) for r in st.residues]


def test_read_pdb_matches_jax(pdb, tmp_path):
    want, got = jpdbio.read_pdb(pdb), tpdbio.read_pdb(pdb)
    assert got.num_models == want.num_models == 1
    assert _residues(got) == _residues(want)
    assert got.chains() == want.chains() == ["A", "B"]
    for chain in ("A", "B"):
        assert (_residues(got.filter_chain(chain))
                == _residues(want.filter_chain(chain)))
    assert ([r.name for r in got.amino_residues()]
            == [r.name for r in want.amino_residues()])
    assert len(got.filter_chain("A").amino_residues()) == L_A
    import gzip

    gz = tmp_path / "helix.pdb.gz"
    gz.write_bytes(gzip.compress(pdb.read_bytes()))
    assert _residues(tpdbio.read_pdb(gz)) == _residues(want)


def test_format_backbone_pdb_text_equals_jax(tmp_path):
    rng = np.random.default_rng(12)
    coords = helix_backbone(rng, 9).astype(np.float32)
    coords[4, 2] = np.nan  # not written
    for seq, k in ((None, 3), ("ACDXEFGHW", 3), ("ACDEFGHIK", 4)):
        c = (coords if k == 3 else
             np.concatenate([coords, coords[:, 1:2] + 1.0], axis=1))
        assert (tpdbio.format_backbone_pdb(c, seq=seq, chain="B")
                == jpdbio.format_backbone_pdb(c, seq=seq, chain="B"))
    tpdbio.write_backbone_pdb(tmp_path / "t.pdb", coords)
    jpdbio.write_backbone_pdb(tmp_path / "j.pdb", coords)
    assert (tmp_path / "t.pdb").read_text() == (tmp_path / "j.pdb").read_text()


def test_featurize_pdb_file_matches_jax(pdb):
    """The same record, the 6D maps within 1e-6 (the host featurizer's
    bar); MSE maps to M, the residue missing C masks itself and its
    neighbours; out-of-range lengths are refused; with C=8 both refuse it
    (P-SEA covers chain A's 14 residues, the map 20)."""
    want = jdataset.featurize_pdb_file(pdb, 4, 64, ss_constraints=False)
    got = tdataset.featurize_pdb_file(pdb, 4, 64, ss_constraints=False)
    assert got["id"] == want["id"] == "helix"
    assert got["aa_str"] == want["aa_str"]
    assert got["aa_str"][3] == "M"
    for k in ("coords", "aa", "mask_pair"):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_allclose(got["coords_6d"], want["coords_6d"],
                               atol=1e-6)
    assert not got["mask_pair"][[6, 7, 8]].any()
    assert tdataset.featurize_pdb_file(pdb, 4, 10, False) is None
    assert tdataset.featurize_pdb_file(pdb, 40, 64, False) is None
    assert jdataset.featurize_pdb_file(pdb, 4, 64, ss_constraints=True) \
        is None
    assert tdataset.featurize_pdb_file(pdb, 4, 64, ss_constraints=True) \
        is None


@pytest.mark.parametrize("spec", ["1:5,10:12", "0", "3,7:9", "0:15"])
def test_selected_mask_batch_matches_jax(spec):
    np.testing.assert_array_equal(
        tcond.selected_mask_batch(spec, 3, N).numpy(),
        np.asarray(jcond.selected_mask_batch(spec, 3, N)))


def _batch(pdb):
    """A batch of chain A's record and a copy that reads as 9 residues."""
    st = jpdbio.read_pdb(pdb).filter_chain("A")
    coords = [[r.atom(a) if r.atom(a) is not None else np.zeros(3)
               for a in ("N", "CA", "C")] for r in st.amino_residues()]
    path = pdb.with_name("chain_a.pdb")
    jpdbio.write_backbone_pdb(path, np.asarray(coords))
    rec = jdataset.featurize_pdb_file(path, 4, N, ss_constraints=False)
    short = dict(rec, aa_str=rec["aa_str"][:9] + "_" * (L_A - 9))
    return jdataset.make_batch([rec, short], N)


@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
@pytest.mark.parametrize("condition", [["length"], ["length", "inpainting"],
                                       ["ss"]])
def test_get_condition_from_batch_matches_jax(pdb, layout, condition):
    cfgd = tiny_config_dict(condition=condition)
    if "ss" in condition:
        cfgd["data"]["num_channels"] = 8
    batch = _batch(pdb)
    if "ss" in condition:  # an 8-channel map: the SS block channels 4:7
        extra = np.random.default_rng(0).uniform(
            0, 1, (2, 3, N, N)).astype(np.float32)
        batch["coords_6d"] = np.concatenate(
            [batch["coords_6d"][:, :4], extra, batch["coords_6d"][:, 4:]], 1)
    if layout == "nhwc":
        batch["coords_6d"] = batch["coords_6d"].transpose(0, 2, 3, 1)
    mask_info = "2:6" if "inpainting" in condition else None
    want = jcond.get_condition_from_batch(j_load_config(cfgd), batch,
                                          mask_info=mask_info)
    got = tcond.get_condition_from_batch(load_config(cfgd), batch,
                                         mask_info=mask_info)
    assert set(got) == set(want) == set(condition)
    for k in condition:
        w, g = want[k], got[k]
        if k == "inpainting":
            for kk in ("coords_6d", "mask_inpaint"):
                np.testing.assert_array_equal(g[kk].numpy(),
                                              np.asarray(w[kk]))
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_random_training_masks_raise(pdb):
    """Random inpainting masks without a generator (or draws) raise."""
    cfg = load_config(tiny_config_dict(condition=["length", "inpainting"]))
    with pytest.raises(ValueError, match="random"):
        tcond.get_condition_from_batch(cfg, _batch(pdb))


@pytest.mark.parametrize("chain,condition,mask_info", [
    ("A", ["length"], None),
    ("A", ["length", "inpainting"], "1:5,10:12"),
    ("B", ["length"], None),
])
def test_get_conditions_from_pdb_matches_jax(pdb, chain, condition,
                                             mask_info):
    """The chain is isolated, re-written and featurized; the condition
    repeats it over the batch: the maps within 1e-6, masks equal."""
    cfgd = tiny_config_dict(condition=condition)
    cfgd["data"]["min_res_num"] = 4
    want = jcond.get_conditions_from_pdb(str(pdb), j_load_config(cfgd),
                                         chain=chain, mask_info=mask_info,
                                         batch_size=3)
    got = tcond.get_conditions_from_pdb(str(pdb), load_config(cfgd),
                                        chain=chain, mask_info=mask_info,
                                        batch_size=3)
    assert set(got) == set(want)
    # the residue missing its C atom is left out of the re-written chain
    length = L_A - 1 if chain == "A" else L_B
    assert got["length"].shape == (3, N, N)
    assert int(got["length"][0].sum()) == length * length
    np.testing.assert_array_equal(got["length"].numpy(),
                                  np.asarray(want["length"]))
    if "inpainting" in condition:
        g, w = got["inpainting"], want["inpainting"]
        np.testing.assert_array_equal(g["mask_inpaint"].numpy(),
                                      np.asarray(w["mask_inpaint"]))
        np.testing.assert_allclose(g["coords_6d"].numpy(),
                                   np.asarray(w["coords_6d"]), atol=1e-6)
        assert g["coords_6d"].dtype == torch.float32


def test_non_standard_residue_table_matches_jax():
    from text2protein_tpu.data import vocab as jvocab
    from text2protein_tpu_torch.data import vocab as tvocab

    assert tvocab.NON_STANDARD_TO_STANDARD == jvocab.NON_STANDARD_TO_STANDARD
