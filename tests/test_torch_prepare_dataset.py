"""The port's PDB-tree dataset builder (`data/dataset.ProteinDataset`,
`cli/prepare_dataset`) and dataset checks (`data/checker`) against the JAX
package, on a temporary PDB tree: helix-bundle backbones written as PDBs in
nested directories, one too short, one unreadable, one without a caption,
and a captions JSON.
"""

import json

import numpy as np
import pytest
import yaml

from text2protein_tpu.cli import prepare_dataset as jprep
from text2protein_tpu.data import checker as jchecker
from text2protein_tpu.data import dataset as jdataset
from text2protein_tpu_torch.cli import prepare_dataset as tprep
from text2protein_tpu_torch.data import checker as tchecker
from text2protein_tpu_torch.data import dataset as tdataset
from text2protein_tpu_torch.data.helix_records import (
    CAPTIONS,
    helix_bundle_backbone,
)
from text2protein_tpu_torch.data.pdbio import write_backbone_pdb

from torch_port_helpers import one_torch_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LENGTHS = {"p0": 40, "p1": 64, "p2": 52, "p3": 70, "p4": 45, "short": 20,
           "nocap": 48}


@pytest.fixture
def tree(tmp_path):
    """(pdb tree, captions json): p0..p4 and nocap accepted at lengths
    30-96, short filtered out, broken unreadable; nocap has no caption
    (so the captioned builds skip it), and `orphan` is a caption with no
    file."""
    rng = np.random.default_rng(0)
    root = tmp_path / "pdbs"
    for i, (name, L) in enumerate(LENGTHS.items()):
        d = root / ("a" if i % 2 else "b") / "c"
        d.mkdir(parents=True, exist_ok=True)
        write_backbone_pdb(d / f"{name}.pdb", helix_bundle_backbone(rng, L))
    (root / "broken.pdb").write_text("ATOM  garbage\n")
    caps = [{"pdb_id": n, "caption": CAPTIONS[i % len(CAPTIONS)]}
            for i, n in enumerate(LENGTHS) if n != "nocap"]
    caps.append({"pdb_id": "orphan", "caption": "no such file"})
    cap_path = tmp_path / "captions.json"
    cap_path.write_text(json.dumps(caps))
    return root, cap_path


def _records(d):
    ds = tdataset.ProteinProcessedDataset(d)
    return {p: ds[i] for i, p in enumerate(ds.data_paths)}


def _assert_same_records(got_dir, want_dir):
    got, want = _records(got_dir), _records(want_dir)
    assert sorted(got) == sorted(want)
    for name in got:
        g, w = got[name], want[name]
        assert set(g) == set(w)
        for k in g:
            if isinstance(g[k], np.ndarray):
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k
    return got


@pytest.mark.parametrize("ss", [True, False], ids=["c8", "c5"])
def test_protein_dataset_matches_jax(tree, tmp_path, ss):
    """The same records, bit for bit, from the port (a pool of two spawned
    workers) and from the JAX package (one process): the filters (length,
    caption, an unreadable file) and the record names and contents; C=8
    records carry SS blocks."""
    root, caps = tree
    kw = dict(description_path=str(caps), min_res_num=30, max_res_num=96,
              ss_constraints=ss)
    got = tdataset.ProteinDataset(root, out_dir=tmp_path / "t",
                                  num_workers=2, **kw)
    want = jdataset.ProteinDataset(root, out_dir=tmp_path / "j",
                                   num_workers=1, **kw)
    assert sorted(got.pdb_paths) == sorted(want.pdb_paths)
    assert got.process() == want.process() == 5
    recs = _assert_same_records(tmp_path / "t", tmp_path / "j")
    assert sorted(recs) == [f"p{i}.npz" for i in range(5)]
    for r in recs.values():
        assert r["caption"] and r["coords_6d"].shape[0] == (8 if ss else 5)
        assert bool(r["ss_indices"]) == ss


def test_protein_dataset_without_captions_keeps_every_file(tree, tmp_path):
    """No caption file: every readable file in range becomes a record with
    an empty caption, as in the JAX package; local_test keeps the walk's
    first 200 files."""
    root, _ = tree
    got = tdataset.ProteinDataset(root, out_dir=tmp_path / "t",
                                  min_res_num=30, max_res_num=96,
                                  num_workers=1, local_test=True)
    want = jdataset.ProteinDataset(root, out_dir=tmp_path / "j",
                                   min_res_num=30, max_res_num=96,
                                   num_workers=1)
    assert got.process() == want.process() == 6
    recs = _assert_same_records(tmp_path / "t", tmp_path / "j")
    assert all(r["caption"] == "" for r in recs.values())


def _config(tmp_path, tree, num_channels, processed):
    root, caps = tree
    cfg = {"data": {"dataset_path": str(root), "caption_path": str(caps),
                    "processed_dataset_path": str(processed),
                    "min_res_num": 30, "max_res_num": 96,
                    "num_channels": num_channels}}
    path = tmp_path / f"cfg_{num_channels}_{processed.name}.yml"
    path.write_text(yaml.safe_dump(cfg))
    return path


@pytest.mark.parametrize("num_channels", [8, 5])
def test_prepare_dataset_cli_matches_jax(tree, tmp_path, num_channels,
                                         capsys):
    """cli/prepare_dataset on a config: C=8 exactly when
    data.num_channels is 8; the records equal the JAX CLI's."""
    got = tprep.main([str(_config(tmp_path, tree, num_channels,
                                  tmp_path / "t")), "--num_workers", "1"])
    want = jprep.main([str(_config(tmp_path, tree, num_channels,
                                   tmp_path / "j")), "--num_workers", "1"])
    assert got == want == 5
    assert "wrote 5/8 records" in capsys.readouterr().out
    recs = _assert_same_records(tmp_path / "t", tmp_path / "j")
    assert {r["coords_6d"].shape[0] for r in recs.values()} == {num_channels}
    out = tmp_path / "elsewhere"
    tprep.main([str(_config(tmp_path, tree, num_channels, tmp_path / "t")),
                "--out_dir", str(out), "--num_workers", "1"])
    assert sorted(p.name for p in out.glob("*.npz")) == sorted(recs)


def test_checker_matches_jax(tree, tmp_path, capsys):
    """compare_pdb_file_and_caption, backfill_captions, batch_smoke_check
    and main's JSON report: equal to the JAX package's."""
    root, caps = tree
    assert (tchecker.compare_pdb_file_and_caption(root, caps)
            == jchecker.compare_pdb_file_and_caption(root, caps))
    for d, mod in (("t", tdataset), ("j", jdataset)):  # no captions yet
        mod.ProteinDataset(root, out_dir=tmp_path / d, min_res_num=30,
                           max_res_num=96, num_workers=1).process()
    assert (tchecker.backfill_captions(tmp_path / "t", caps)
            == jchecker.backfill_captions(tmp_path / "j", caps) == 5)
    recs = _assert_same_records(tmp_path / "t", tmp_path / "j")
    assert recs["nocap.npz"]["caption"] == ""
    assert recs["p1.npz"]["caption"] == CAPTIONS[1]
    assert (tchecker.batch_smoke_check(tmp_path / "t", 96, 3)
            == jchecker.batch_smoke_check(tmp_path / "j", 96, 3))
    reports = []
    for mod, d in ((tchecker, "t"), (jchecker, "j")):
        cfg = _config(tmp_path, tree, 8, tmp_path / d)
        assert mod.main([str(cfg), "--backfill", "--batch_size", "2"]) == 0
        reports.append(json.loads(capsys.readouterr().out))
    assert reports[0] == reports[1]
    assert reports[0]["intersection"]["num_both"] == 6  # short too
    assert reports[0]["backfilled"] == 0
