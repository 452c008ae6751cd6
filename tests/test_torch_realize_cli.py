"""The realization entry points of text2protein_tpu_torch on the CPU:
`cli/sampling_rosetta` against the JAX package's CLI on the same pickles
(the minimization injected into both: the same files, byte for byte, and
score.txt files that PyYAML reads to the same mappings), the port's CLI end
to end with its real minimization, and the Server's realize branch."""

import functools
import math
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import yaml

from text2protein_tpu.cli import sampling_rosetta as j_cli
from text2protein_tpu.data import pdbio as j_pdbio
from text2protein_tpu.data.featurize import featurize_structure
from text2protein_tpu.data.synthetic import helix_bundle_torsions
from text2protein_tpu.realize import geometry as jg
from text2protein_tpu.realize import minimize as jm
from text2protein_tpu_torch.cli import sampling_rosetta as t_cli
from text2protein_tpu_torch.cli.serve import Server
from text2protein_tpu_torch.config import load_config
from text2protein_tpu_torch.data import pdbio as t_pdbio
from text2protein_tpu_torch.eval.tm_sweeps import reu_stats
from text2protein_tpu_torch.realize import minimize as tm

from torch_port_helpers import tiny_config_dict

N = 24


def _backbone(L, seed):
    phi, psi = helix_bundle_torsions(L, seed=seed)
    return np.asarray(jg.build_backbone(jnp.asarray(phi), jnp.asarray(psi)))


def _write_pickles(coords_dir, lengths):
    """sampled_{i}.pkl, (1, 5, N, N) GT maps of bundles of `lengths`, where
    the sampling CLI writes them (coords_6d/{config}/{run}/{tag})."""
    coords_dir.mkdir(parents=True)
    bbs = {}
    for i, L in enumerate(lengths):
        bb = _backbone(L, i)
        c6d, _, _ = featurize_structure(bb, np.ones(L), ss_constraints=False)
        m = np.zeros((1, 5, N, N), np.float32)
        m[0, :, :L, :L] = c6d
        with open(coords_dir / f"sampled_d{i}.pkl", "wb") as f:
            pickle.dump(m, f)
        bbs[L] = bb
    return bbs


def _tree(root):
    out = {}
    for p in sorted(root.rglob("*")):
        rel = str(p.relative_to(root))
        out[rel] = (("link", str(p.readlink())) if p.is_symlink()
                    else ("dir", None) if p.is_dir() else
                    ("file", p.read_bytes()))
    return out


def _same_yaml(a, b):
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_yaml(a[k], b[k])
                                            for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_same_yaml, a, b))
    return a == b


@pytest.mark.parametrize("designer", ["learned", "physics"])
def test_sampling_rosetta_writes_what_jax_writes(tmp_path, monkeypatch,
                                                 designer):
    coords = tmp_path / "coords_6d" / "cfg" / "run" / "test"
    bbs = _write_pickles(coords, (16, 20))

    def fake_factory(pdbio):
        def fake(npz, seq, outPath=None, seed=0, **kw):
            L = len(seq)
            bb = bbs[L] + np.float32(0.01 * seed)
            outPath.mkdir(parents=True, exist_ok=True)
            pdbio.write_backbone_pdb(outPath / "structure_before_design.pdb",
                                     bb, seq=seq)
            pdbio.write_backbone_pdb(outPath / "final_structure.pdb", bb,
                                     seq=seq)
            # round 2 of the L=20 design wins; a restart gave NaN
            e = 100.0 - L - 50.0 * seed * (L == 20)
            return bb, e, np.array([e, np.nan, 1e20], np.float32)
        return fake

    monkeypatch.setattr(jm, "run_minimization", fake_factory(j_pdbio))
    monkeypatch.setattr(tm, "run_minimization", fake_factory(t_pdbio))
    args = ["cfg.yml", "--coords_path", str(coords), "--n_iter", "2",
            "--fastdesign", "--designer", designer]
    j_cli.main(args + ["--out_root", str(tmp_path / "jax")])
    t_cli.main(args + ["--out_root", str(tmp_path / "port"),
                       "--device", "cpu"])
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert got.keys() == want.keys()
    # out_root / the coords dir's grandparent's name / the design's id
    assert got["cfg/d1/best_run"] == ("link", "round_2")
    assert "cfg/d0/rosetta_d0.pdb" in got
    for k, (kind, data) in want.items():
        if k.endswith("score.txt"):
            assert _same_yaml(yaml.safe_load(got[k][1]),
                              yaml.safe_load(data)), k
        else:
            assert got[k] == (kind, data), k
    scores = sorted((tmp_path / "port").rglob("score.txt"))
    assert reu_stats(scores)["count"] == 4


def test_sampling_rosetta_realizes_on_the_cpu(tmp_path):
    """The port's CLI with its real minimization at a tiny size: the
    layout, a finite energy, and score.txt files eval.tm_sweeps reads."""
    coords = tmp_path / "coords_6d" / "cfg" / "run" / "test"
    _write_pickles(coords, (8,))
    out = tmp_path / "rosetta"
    t_cli.main(["cfg.yml", "--coords_path", str(coords), "--n_restarts",
                "2", "--max_iter", "3", "--fastdesign", "--out_root",
                str(out), "--device", "cpu"])
    d = out / "cfg" / "d0"
    for name in ("structure_before_design.pdb", "final_structure.pdb",
                 "structure_after_design.pdb", "score.txt"):
        assert (d / "round_1" / name).exists(), name
    assert (d / "best_run").readlink().name == "round_1"
    res = t_pdbio.read_pdb(d / "rosetta_d0.pdb").amino_residues()
    assert len(res) == 8
    score = yaml.safe_load((d / "round_1" / "score.txt").read_text())
    assert math.isfinite(score["total_energy"])
    assert len(score["designed_seq"]) == 8
    stats = reu_stats([d / "round_1" / "score.txt"])
    assert stats["count"] == 1
    assert stats["avg"] == pytest.approx(score["avg_score_per_res"])


def test_server_realize_branch_on_the_cpu(monkeypatch):
    """With realize=True a request asking for it gets a PDB of its length
    and a finite energy (random weights: the maps are noise); without it,
    the JAX server's warning. The realization runs the torsion protocol
    with 2 restarts and max_iter 3 here: on noise maps the Cartesian
    protocol's linesearches fail and take their 20 steps, a minute on the
    CPU even at L=8."""
    monkeypatch.setattr(tm, "realize_6d_sample", functools.partial(
        tm.realize_6d_sample, n_restarts=2, max_iter=3, method="torsion"))
    server = Server(load_config(tiny_config_dict()), batch_size=2,
                    num_steps=2, weight_seed=0, device="cpu", realize=True)
    out = server.run_batch([{"caption": "a helix", "length": 8,
                             "realize": True},
                            {"caption": "b", "length": 10}])
    assert set(out[1]) == {"length", "nfe", "seed", "coords_6d_b64"}
    item = out[0]
    assert math.isfinite(item["energy"])
    lines = [ln for ln in item["pdb"].splitlines() if ln.startswith("ATOM")]
    assert len(lines) == 8 * 3
    server.realize = False
    out = server.run_batch([{"length": 8, "realize": True}])
    assert out[0]["warning"] == "server started without --realize"
    assert "pdb" not in out[0]


def test_native_minimizer_wrapper_matches_jax(tmp_path):
    """realize/native drives the repository's native/minimize binary as the
    JAX package's wrapper does and reads its PDB with the port's pdbio:
    the same backbone and energy, and the same maps file."""
    from text2protein_tpu.realize import native as j_native
    from text2protein_tpu_torch.realize import native as t_native
    from text2protein_tpu_torch.realize.restraints import inverse_scale

    if not t_native.native_available():
        pytest.skip("native/minimize does not build here")
    L = 16
    bb = _backbone(L, 2)
    c6d, _, _ = featurize_structure(bb, np.ones(L), ss_constraints=False)
    npz = inverse_scale(c6d, L)
    t_native.write_maps_bin(npz, tmp_path / "t.bin")
    j_native.write_maps_bin(npz, tmp_path / "j.bin")
    assert ((tmp_path / "t.bin").read_bytes()
            == (tmp_path / "j.bin").read_bytes())
    got = t_native.run_minimization_native(npz, "A" * L,
                                           outPath=tmp_path / "t",
                                           n_restarts=2, max_iter=20)
    want = j_native.run_minimization_native(npz, "A" * L,
                                            outPath=tmp_path / "j",
                                            n_restarts=2, max_iter=20)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] and math.isfinite(got[1])
    name = "structure_before_design.pdb"
    assert ((tmp_path / "t" / name).read_bytes()
            == (tmp_path / "j" / name).read_bytes())
