"""The port's sampling CLI (cli/sampling_6d.py) and the server's
--sampler / --checkpoint on the CPU, from a workdir the port's trainer
writes; the held-out captions are held against the JAX CLI's
`load_test_captions` on the same directory.
"""

import pickle

import numpy as np
import pytest
import yaml

from text2protein_tpu.cli.sampling_6d import (
    load_test_captions as j_load_test_captions,
)
from text2protein_tpu_torch.cli import sampling_6d, serve
from text2protein_tpu_torch.cli import train as ttrain
from text2protein_tpu_torch.data.helix_records import write_records

from torch_port_helpers import (  # noqa: F401  (a fixture)
    C,
    N,
    one_torch_thread,
    tiny_config_dict,
    write_helix_pdb,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N_RECORDS = 41  # the 95/5 split holds out 2


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A tiny config trained for 2 steps: (tmp dir, config path, workdir)."""
    tmp = tmp_path_factory.mktemp("run")
    write_records(tmp / "rec", N_RECORDS, lengths=(9, 16))
    cfg = tiny_config_dict()
    cfg["training"].update({"batch_size": 2, "eval_freq": 1})
    cfg["data"]["min_res_num"] = 4
    cfg["sampling"] = {"hybrid_ode_steps": 2, "hybrid_pc_steps": 2,
                       "cfg_scale": 2.0}
    path = tmp / "tiny.yml"
    path.write_text(yaml.safe_dump(cfg))
    res = ttrain.main(["--config", str(path), "--data", str(tmp / "rec"),
                       "--max_steps", "2", "--device", "cpu",
                       "--workdir_root", str(tmp / "training")])
    return tmp, path, res["workdir"]


def test_load_test_captions_matches_jax(run):
    tmp, _, wd = run
    ckpt = wd / "checkpoints" / "best_eval.pt"
    got = sampling_6d.load_test_captions(ckpt, str(tmp / "rec"))
    assert got == j_load_test_captions(ckpt, str(tmp / "rec"))
    ids = (wd / "test_ids.txt").read_text().split("\n")
    assert [i for i, _ in got] == ids and len(ids) == 2
    assert all(cap for _, cap in got)
    assert sampling_6d.load_test_captions(tmp / "x" / "y", None) == []


def _pickles(out):
    return {p.name: pickle.load(open(p, "rb"))
            for p in sorted(out.glob("*.pkl"))}


@pytest.mark.parametrize("sampler", ["pc", "hybrid"])
def test_sampling_cli_writes_a_pickle_per_held_out_id(run, sampler):
    """Batch 3 over 2 held-out ids: the captions cycle to one full batch,
    so each id's pickle is written, (1, C, N, N) float32, finite, its last
    channel the selected length's mask (length_index 5: length 8)."""
    tmp, cfg, wd = run
    steps = ["--num_steps", "3"] if sampler == "pc" else []
    out = sampling_6d.main([
        str(cfg), str(wd / "checkpoints" / "best_eval.pt"),
        "--sampler", sampler, *steps, "--batch_size", "3",
        "--select_length", "--length_index", "5", "--processed_dir",
        str(tmp / "rec"), "--device", "cpu", "--workdir_root",
        str(tmp / f"sampling_{sampler}"), "--n_iter", "2"])
    assert len(out["sample_seconds"]) == 2
    out = out["workdir"]
    assert out == (tmp / f"sampling_{sampler}" / "coords_6d" / "tiny"
                   / wd.name / "test")
    ids = (wd / "test_ids.txt").read_text().split("\n")
    maps = _pickles(out)
    assert sorted(maps) == sorted(f"sampled_{i}_{it}.pkl" for i in ids
                                  for it in (0, 1))
    want = np.zeros((N, N), np.float32)
    want[:8, :8] = 1.0
    for a in maps.values():
        assert a.shape == (1, C, N, N) and a.dtype == np.float32
        assert np.isfinite(a).all()
        np.testing.assert_array_equal(a[0, -1], want)


def test_sampling_cli_pdb_inpainting_keeps_the_known_region(run):
    """--pdb with the inpainting condition: the region outside --mask_info
    is the PDB chain's map."""
    tmp, cfg_path, wd = run
    cfg = yaml.safe_load(cfg_path.read_text())
    cfg["model"]["condition"] = ["length", "inpainting"]
    inpaint = tmp / "inpaint.yml"
    inpaint.write_text(yaml.safe_dump(cfg))
    pdb = write_helix_pdb(tmp / "helix.pdb")
    res = sampling_6d.main([
        str(inpaint), str(wd / "checkpoints" / "best_train.pt"),
        "--pdb", str(pdb), "--chain", "B", "--mask_info", "1:3",
        "--num_steps", "2", "--batch_size", "2", "--device", "cpu",
        "--workdir_root", str(tmp / "sampling_pdb"), "--tag", "pdb"])
    maps = _pickles(res["workdir"])
    assert sorted(maps) == ["sampled_design_0.pkl", "sampled_design_1.pkl"]
    from text2protein_tpu_torch.conditioning import get_conditions_from_pdb
    from text2protein_tpu_torch.config import load_config

    cond = get_conditions_from_pdb(str(pdb), load_config(str(inpaint)), "B",
                                   "1:3", batch_size=2)
    known = ~cond["inpainting"]["mask_inpaint"][0].numpy()
    ref = cond["inpainting"]["coords_6d"][0].numpy().transpose(2, 0, 1)
    for a in maps.values():
        np.testing.assert_array_equal(a[0][:, known], ref[:, known])


def test_sampling_cli_refuses_pdb_with_select_length(run):
    tmp, cfg, wd = run
    with pytest.raises(ValueError, match="exclude"):
        sampling_6d.main([str(cfg), str(wd), "--pdb", "x.pdb",
                          "--select_length", "--device", "cpu"])


def test_serve_hybrid_from_a_checkpoint_answers(run):
    """cli/serve --sampler hybrid --checkpoint WORKDIR on the CPU: the EMA
    of the workdir's best_eval, the hybrid's NFE with CFG, a finite map
    with the length mask."""
    tmp, cfg, wd = run
    args = serve.build_parser().parse_args([
        "--config", str(cfg), "--checkpoint", str(wd), "--sampler",
        "hybrid", "--batch_size", "2", "--device", "cpu"])
    server = serve.server_from_args(args)
    assert server.step == 2
    from text2protein_tpu_torch.training.checkpoint import read_slot

    ema = read_slot(wd / "checkpoints" / "best_eval.pt")["ema"]["params"]
    for k, v in server.model.state_dict().items():
        assert np.array_equal(v.numpy(), ema[k].numpy()), k
    reply = server.run_batch([{"caption": "helix", "length": 11},
                              {"caption": "", "length": 16}])
    assert [r["nfe"] for r in reply] == [(2 * 2 + 2 * 2) * 2] * 2
    for r in reply:
        cnn = serve.decode_coords(r)
        assert cnn.shape == (C, N, N) and np.isfinite(cnn).all()
        assert cnn[-1].sum() == r["length"] ** 2
    with pytest.raises(ValueError, match="not both"):
        serve.Server(serve.load_config(str(cfg)), checkpoint=str(wd),
                     weights="w.pt", device="cpu")
