"""The port's evaluation (`eval/*`) and its reference `.pt` records against
the JAX package, on the CPU.

Every eval function and CLI gets the same seeded inputs in both packages:
TM-score (Kabsch, the DP alignment, rigid copies, noise, shifted
fragments; the same score to 1e-12), the 6D-map MSE and its YAML, the
helix counter on ground-truth maps, the TM sweeps in each mode, the MPNN
and ESM exports. Then `.pt` records: `load_record`, the dataset's order
and split, and the sampling CLI's test captions.
"""

import json
import pickle

import numpy as np
import pytest
import torch
import yaml

from text2protein_tpu.cli.sampling_6d import (
    load_test_captions as j_load_test_captions,
)
from text2protein_tpu.cli.train import split_dataset as j_split
from text2protein_tpu.data.dataset import ProteinProcessedDataset as JDataset
from text2protein_tpu.data.dataset import load_record as j_load_record
from text2protein_tpu.eval import coords_compare as j_cc
from text2protein_tpu.eval import esm_prep as j_esm
from text2protein_tpu.eval import helix_count as j_hc
from text2protein_tpu.eval import mpnn_export as j_mpnn
from text2protein_tpu.eval import tm_sweeps as j_sweeps
from text2protein_tpu.eval import tmscore as j_tm
from text2protein_tpu_torch.cli import sampling_6d
from text2protein_tpu_torch.cli import train as ttrain
from text2protein_tpu_torch.data.dataset import (
    ProteinProcessedDataset,
    load_record,
)
from text2protein_tpu_torch.data.helix_records import (
    helix_backbone,
    write_records,
)
from text2protein_tpu_torch.data.pdbio import write_backbone_pdb
from text2protein_tpu_torch.eval import coords_compare as t_cc
from text2protein_tpu_torch.eval import esm_prep as t_esm
from text2protein_tpu_torch.eval import helix_count as t_hc
from text2protein_tpu_torch.eval import mpnn_export as t_mpnn
from text2protein_tpu_torch.eval import tm_sweeps as t_sweeps
from text2protein_tpu_torch.eval import tmscore as t_tm

from torch_port_helpers import write_helix_pdb

GT = "data/processed_synth_text"


def _ca(seed, n):
    return helix_backbone(np.random.default_rng(seed), n)[:, 1].astype(
        np.float64)


def _rotation(seed):
    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((3, 3)))
    return q * np.sign(np.linalg.det(q))


# ------------------------------------------------------------ TM-score


def test_kabsch_and_d0_match_jax():
    rng = np.random.default_rng(0)
    for n in (3, 10, 64):
        p = rng.standard_normal((n, 3))
        q = p @ _rotation(n).T + rng.standard_normal(3)
        q += 0.1 * rng.standard_normal(q.shape)
        for g, w in zip(t_tm.kabsch(p, q), j_tm.kabsch(p, q)):
            np.testing.assert_array_equal(g, w)
    bad = np.full((4, 3), np.nan)
    for g, w in zip(t_tm.kabsch(bad, bad), j_tm.kabsch(bad, bad)):
        np.testing.assert_array_equal(g, w)
    for n in (1, 5, 21, 22, 64, 128, 1000):
        assert t_tm.d0_for_length(n) == j_tm.d0_for_length(n)


def _tm_pairs():
    x = _ca(1, 60)
    rng = np.random.default_rng(2)
    return {
        "rigid": (x, x @ _rotation(3).T + np.array([4.0, -2.0, 7.0])),
        "noise": (x, x + rng.normal(0, 1.5, x.shape)),
        "fragment": (x[10:45], x @ _rotation(4).T),
        "shifted": (x[5:], x[:-5]),
        "unrelated": (x, _ca(5, 48)),
        "tiny": (x[:4], x[:4] + 0.1),
    }


@pytest.mark.parametrize("name", list(_tm_pairs()))
def test_tm_score_matches_jax(name):
    a, b = _tm_pairs()[name]
    got, want = t_tm.tm_score(a, b), j_tm.tm_score(a, b)
    assert abs(got - want) <= 1e-12
    assert abs(t_tm.tm_score(a, b, l_target=40)
               - j_tm.tm_score(a, b, l_target=40)) <= 1e-12
    if name == "rigid":
        assert abs(got - 1.0) < 1e-6


def test_tm_score_from_pdbs_and_native_run_match_jax(tmp_path):
    x = helix_backbone(np.random.default_rng(6), 40)
    y = x @ _rotation(7).T.astype(np.float32) + 3.0
    write_backbone_pdb(tmp_path / "a.pdb", x)
    write_backbone_pdb(tmp_path / "b.pdb", y)
    write_backbone_pdb(tmp_path / "c.pdb", helix_backbone(
        np.random.default_rng(8), 32))
    for p, q in (("a", "b"), ("a", "c"), ("c", "a")):
        p, q = tmp_path / f"{p}.pdb", tmp_path / f"{q}.pdb"
        np.testing.assert_array_equal(t_tm.ca_from_pdb(p),
                                      j_tm.ca_from_pdb(p))
        assert abs(t_tm.tm_score_from_pdbs(p, q)
                   - j_tm.tm_score_from_pdbs(p, q)) <= 1e-12
        assert t_tm.run_tmalign(p, q) == j_tm.run_tmalign(p, q)
        missing = tmp_path / "no_binary"
        assert abs(t_tm.run_tmalign(p, q, binary_path=missing)
                   - j_tm.run_tmalign(p, q, binary_path=missing)) <= 1e-12
    assert t_tm._NATIVE_BINARY == j_tm._NATIVE_BINARY


# -------------------------------------------------------- 6D map MSE


def _maps():
    ds = ProteinProcessedDataset(GT)
    return [ds[i] for i in (0, 1, 40, 383)]


def test_mse_and_length_from_padding_match_jax():
    rng = np.random.default_rng(0)
    for rec in _maps():
        gt = rec["coords_6d"]
        L = gt.shape[1]
        pad = np.zeros((5, 128, 128), np.float32)
        pad[:, :L, :L] = gt
        sample = pad + rng.normal(0, 0.1, pad.shape).astype(np.float32)
        sample[-1] = pad[-1]
        assert (t_cc.infer_length_from_padding(sample)
                == j_cc.infer_length_from_padding(sample) == L)
        for ch in (None, slice(0, 4)):
            assert (t_cc.mse_6d(sample, gt, L, ch)
                    == j_cc.mse_6d(sample, gt, L, ch))
    bad = np.zeros((5, 8, 8), np.float32)
    bad[-1, :3, :2] = 1
    with pytest.raises(ValueError, match="square"):
        t_cc.infer_length_from_padding(bad)


def _write_samples(tmp_path, ids):
    sdir = tmp_path / "samples"
    sdir.mkdir()
    rng = np.random.default_rng(1)
    for pid in ids:
        sample = rng.normal(0, 0.5, (1, 5, 128, 128)).astype(np.float32)
        with open(sdir / f"sampled_{pid}.pkl", "wb") as f:
            pickle.dump(sample, f)
    return sdir


def test_coord_compare_and_its_cli_match_jax(tmp_path):
    ids = [p.split(".")[0] for p in ProteinProcessedDataset(GT).data_paths[
        :5]] + ["no_such_record"]
    sdir = _write_samples(tmp_path, ids)
    got = t_cc.coord_compare(sdir, GT, tmp_path / "port.yaml")
    want = j_cc.coord_compare(sdir, GT, tmp_path / "jax.yaml")
    assert got == want and got["count"] == 5
    assert (yaml.safe_load((tmp_path / "port.yaml").read_text())
            == yaml.safe_load((tmp_path / "jax.yaml").read_text()))
    # the CLI writes coords_6d_losses.yaml beside the sample directory
    t_cc.main([str(sdir), GT])
    assert yaml.safe_load((tmp_path / "coords_6d_losses.yaml").read_text(
        )) == want


def test_coord_compare_without_a_match_writes_nan_as_jax(tmp_path):
    sdir = _write_samples(tmp_path, ["no_such_record"])
    got = t_cc.coord_compare(sdir, GT, tmp_path / "port.yaml")
    j_cc.coord_compare(sdir, GT, tmp_path / "jax.yaml")
    g = yaml.safe_load((tmp_path / "port.yaml").read_text())
    w = yaml.safe_load((tmp_path / "jax.yaml").read_text())
    assert got["count"] == g["count"] == w["count"] == 0
    for k in ("avg", "min", "max", "std"):
        assert np.isnan(g[k]) and np.isnan(w[k])
    assert g["per_pdb"] == w["per_pdb"] == {}


# ------------------------------------------------------------ helices


def test_helix_counts_match_jax_on_ground_truth_maps():
    for rec in _maps():
        c6d, L = rec["coords_6d"], rec["coords_6d"].shape[1]
        assert t_hc.count_helices(c6d, L) == j_hc.count_helices(c6d, L)
        assert (t_hc.count_helices(c6d, L, dcut=10.0, need=4)
                == j_hc.count_helices(c6d, L, dcut=10.0, need=4))
        np.testing.assert_array_equal(t_hc.helix_flags(c6d, L),
                                      j_hc.helix_flags(c6d, L))
        assert t_hc.helix_fraction(c6d, L) == j_hc.helix_fraction(c6d, L)
    assert t_hc.helix_fraction(np.zeros((5, 4, 4)), 4) == 0.0


# ------------------------------------------------------------- sweeps


def _pdb_dirs(tmp_path):
    designed, refs = tmp_path / "designed", tmp_path / "refs"
    designed.mkdir()
    refs.mkdir()
    for i, n in enumerate((30, 36, 40)):
        bb = helix_backbone(np.random.default_rng(i), n)
        write_backbone_pdb(refs / f"p{i}.pdb", bb)
        noisy = bb + np.random.default_rng(10 + i).normal(0, 0.8, bb.shape)
        write_backbone_pdb(designed / f"p{i}.pdb", noisy.astype(np.float32))
    (designed / "extra").mkdir()
    write_backbone_pdb(designed / "extra" / "rosetta_p1.pdb",
                       helix_backbone(np.random.default_rng(20), 36))
    return designed, refs


@pytest.mark.parametrize("mode", ["novelty", "gt"])
@pytest.mark.parametrize("native", [False, True])
def test_tm_sweeps_cli_matches_jax(tmp_path, mode, native):
    designed, refs = _pdb_dirs(tmp_path)
    args = ["--mode", mode, "--designed", str(designed), "--refs",
            str(refs)] + ([] if native else ["--no_native"])
    t_sweeps.main(args + ["--out", str(tmp_path / "port.json")])
    j_sweeps.main(args + ["--out", str(tmp_path / "jax.json")])
    got = json.loads((tmp_path / "port.json").read_text())
    want = json.loads((tmp_path / "jax.json").read_text())
    assert got.keys() == want.keys()
    assert got["samples"].keys() == want["samples"].keys()
    # 4 designs; in gt mode p1 and rosetta_p1 share the name p1
    assert len(got["samples"]) == (4 if mode == "novelty" else 3)

    def close(g, w):
        if isinstance(w, dict):
            assert g.keys() == w.keys()
            for k in w:
                close(g[k], w[k])
        else:
            assert abs(g - w) <= 1e-12, (g, w)

    close(got, want)


def test_reu_stats_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    for i in range(4):
        run = tmp_path / f"round_{i}"
        run.mkdir()
        e = float(rng.uniform(-300, -100))
        (run / "score.txt").write_text(yaml.safe_dump({
            "total_energy": e, "avg_score_per_res": e / 64,
            "restart_energies": [e, e + 1.5], "designed_seq": "ACDEFG"}))
    (tmp_path / "round_9").mkdir()
    (tmp_path / "round_9" / "score.txt").write_text("total_energy: 1.0\n")
    files = sorted(tmp_path.rglob("score.txt"))
    assert t_sweeps.reu_stats(files) == j_sweeps.reu_stats(files)
    assert t_sweeps.reu_stats(files)["count"] == 4
    args = ["--mode", "reu", "--designed", str(tmp_path)]
    t_sweeps.main(args + ["--out", str(tmp_path / "port.json")])
    j_sweeps.main(args + ["--out", str(tmp_path / "jax.json")])
    assert (json.loads((tmp_path / "port.json").read_text())
            == json.loads((tmp_path / "jax.json").read_text()))


# ------------------------------------------------------- MPNN and ESM


def _same(got, want):
    assert json.dumps(got) == json.dumps(want)


@pytest.mark.parametrize("ca_only", [False, True])
def test_mpnn_export_matches_jax(tmp_path, ca_only):
    pdb = write_helix_pdb(tmp_path / "two_chains.pdb")
    write_backbone_pdb(tmp_path / "one.pdb",
                       helix_backbone(np.random.default_rng(0), 12),
                       seq="ACDEFGHIKLMN")
    for p in (pdb, tmp_path / "one.pdb"):
        _same(t_mpnn.parse_pdb_for_mpnn(p, ca_only),
              j_mpnn.parse_pdb_for_mpnn(p, ca_only))
    n = t_mpnn.export_mpnn_jsonl(tmp_path, tmp_path / "port.jsonl",
                                 ca_only=ca_only)
    assert n == j_mpnn.export_mpnn_jsonl(tmp_path, tmp_path / "jax.jsonl",
                                         ca_only=ca_only) == 2
    assert ((tmp_path / "port.jsonl").read_text()
            == (tmp_path / "jax.jsonl").read_text())


def test_esm_coords_and_contact_map_match_jax(tmp_path):
    pdb = write_helix_pdb(tmp_path / "two_chains.pdb")
    for chain in ("A", "B"):
        got, want = t_esm.load_coords(pdb, chain), j_esm.load_coords(pdb,
                                                                    chain)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
        for thr in (8.0, 5.0):
            np.testing.assert_array_equal(t_esm.contact_map(got[0], thr),
                                          j_esm.contact_map(want[0], thr))


# --------------------------------------------------- reference .pt records


def _write_pt_records(root, n=24):
    """n reference-style .pt records (a torch-saved dict of tensors and
    strings) from the tracked .npz records, and two .npz ones beside."""
    root.mkdir(parents=True, exist_ok=True)
    ds = ProteinProcessedDataset(GT)
    for i in range(n):
        r = ds[i]
        torch.save({
            "id": f"pt_{i:03d}", "coords": torch.from_numpy(r["coords"]),
            "coords_6d": torch.from_numpy(r["coords_6d"]),
            "aa": torch.from_numpy(r["aa"]), "aa_str": r["aa_str"],
            "mask_pair": torch.from_numpy(r["mask_pair"]),
            "ss_indices": r["ss_indices"],
            "caption": f"{r['caption']} ({i})"}, root / f"pt_{i:03d}.pt")
    write_records(root, 2, lengths=(9, 16))
    return root


def _same_record(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[k].dtype == w.dtype
            np.testing.assert_array_equal(got[k], w)
        else:
            assert got[k] == w


def test_pt_records_load_and_split_as_jax(tmp_path):
    root = _write_pt_records(tmp_path / "rec")
    ds, jds = ProteinProcessedDataset(root), JDataset(root)
    assert ds.data_paths == jds.data_paths and len(ds) == 26
    assert ds.data_paths[0] == "pt_000.pt"
    for i in (0, 5, 24, 25):
        _same_record(ds[i], jds[i])
        _same_record(load_record(root / ds.data_paths[i]),
                     j_load_record(root / ds.data_paths[i]))
        assert ds.caption(i) == jds.caption(i)
    for a, b in zip(ttrain.split_dataset(len(ds), 42),
                    j_split(len(jds), 42)):
        np.testing.assert_array_equal(a, b)


def test_load_test_captions_reads_pt_records_as_jax(tmp_path):
    root = _write_pt_records(tmp_path / "rec")
    ckpt = tmp_path / "run" / "checkpoints" / "best_eval.pt"
    ckpt.parent.mkdir(parents=True)
    (tmp_path / "run" / "test_ids.txt").write_text(
        "pt_003\nsmoke_001\nmissing\npt_010\n")
    got = sampling_6d.load_test_captions(ckpt, str(root))
    want = j_load_test_captions(ckpt, str(root))
    assert got == want and len(got) == 3
    assert got[0] == ("pt_003", ProteinProcessedDataset(root).caption(3))
