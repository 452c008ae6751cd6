"""cli/train on a mesh of ranks (each a process on the CPU, FSDP2 over gloo,
started by `parallel.launch.spawn`): the run on 4 ranks (data 2 x model 2)
against the one-device run, its gathered checkpoint restored on one
device and resumed on 4 ranks, its snapshot sample, a run over two nodes
of two ranks each, and the trainer launched by `torch.distributed.run`.
"""

import pickle

import numpy as np
import pytest
import torch
import yaml

import torch_dist_workers as W
from text2protein_tpu_torch.cli import train as ttrain
from text2protein_tpu_torch.config import load_config
from text2protein_tpu_torch.data.helix_records import write_records
from text2protein_tpu_torch.models.unet import build_model
from text2protein_tpu_torch.parallel.launch import spawn
from text2protein_tpu_torch.training.checkpoint import (
    CheckpointManager,
    load_slot,
    read_slot,
    state_slot,
)
from text2protein_tpu_torch.training.state import create_train_state

from torch_port_helpers import (  # noqa: F401  (a fixture)
    one_torch_thread,
    tiny_config_dict,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

STEPS = 4
SPAWN_S = 300  # each multi-rank run's time limit (a loaded CPU is slow)
LR = 1e-4  # the configs' Adam learning rate


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """Records and a tiny config: batch 4, dropout 0.1, random inpainting
    masks, the meta checkpoint and an eval boundary every 2 steps, a
    snapshot sample (20 PC steps) at each boundary; `cfg.yml` on the mesh
    model 2 (data 2 on 4 ranks), `cfg1.yml` the same on the default mesh
    (a mesh.model of 2 does not fit one process). 12 records: 11 train, 2
    steps an epoch, so the 4 steps cross an epoch boundary."""
    d = tmp_path_factory.mktemp("dist_cli")
    write_records(d / "records", 12, lengths=(9, 16))
    cfg = tiny_config_dict(dropout=0.1, condition=["length", "inpainting"],
                           num_scales=20)
    cfg["training"].update({"batch_size": 4, "log_freq": 1, "eval_freq": 2,
                            "snapshot_freq_for_preemption": 2,
                            "snapshot_sampling": True})
    cfg["optim"] = {"warmup": 1, "lr": LR}
    (d / "cfg1.yml").write_text(yaml.safe_dump(cfg))
    cfg["mesh"] = {"data": -1, "model": 2}
    (d / "cfg.yml").write_text(yaml.safe_dump(cfg))
    return d


def _argv(d, root, steps=STEPS, resume=None, cfg="cfg.yml"):
    argv = ["--config", str(d / cfg), "--data", str(d / "records"),
            "--max_steps", str(steps), "--device", "cpu"]
    if resume:
        return argv + ["--resume", str(resume)]
    return argv + ["--workdir_root", str(d / root)]


@pytest.fixture(scope="module")
def world4(run_dir):
    """The 4-rank run of 4 steps; each rank's results."""
    return spawn(W.train_cli, 4, args=(_argv(run_dir, "w4"),),
                 device="cpu", timeout=SPAWN_S)


@pytest.fixture(scope="module")
def world1(run_dir):
    """The one-device run of the same config."""
    res = ttrain.main(_argv(run_dir, "w1", cfg="cfg1.yml"))
    return {"losses": res["losses"], "evals": res["evals"],
            "workdir": res["workdir"], **W.host_state(res["state"])}


def _zero_grad_param(name):
    # the attention key biases: rounding noise for a gradient, which Adam
    # turns into steps of +-lr (tests/test_torch_distributed.py)
    return name.endswith("NIN_1.b")


def test_cli_world4_matches_one_device(world4, world1):
    """Same losses (rtol 1e-5) and eval averages, the same state on every
    rank, that of the one-device run: within 1e-5 of each tensor's scale
    plus 1e-4 of the distance Adam can move it in the run (lr x steps). The
    JAX initializers start some tensors at 0 (proj_out) or near it (the
    residual blocks' last convolutions), which then hold only Adam's steps,
    whose size depends on each gradient element's relative rounding; rank
    0 alone wrote the workdir."""
    got = world4[0]
    assert got["mesh"] == {"data": 2, "model": 2, "world": 4, "nodes": 1}
    np.testing.assert_allclose(got["losses"], world1["losses"], rtol=1e-5)
    np.testing.assert_allclose(np.asarray(got["evals"]),
                               np.asarray(world1["evals"]), rtol=1e-5)
    for other in world4[1:]:
        assert other["losses"] == got["losses"]
        assert other["workdir"] == got["workdir"]
    for kind in ("params", "ema"):
        for k, w in world1[kind].items():
            diff = np.abs(got[kind][k] - w).max()
            bar = (2 * LR * STEPS if _zero_grad_param(k)
                   else 1e-5 * np.abs(w).max() + 1e-4 * LR * STEPS)
            assert diff <= bar, (kind, k, diff)
    from pathlib import Path

    workdir = Path(got["workdir"])
    slots = sorted(p.name for p in workdir.rglob("*.pt"))
    assert slots == ["best_eval.pt", "best_train.pt", "checkpoint.pt"]
    assert (workdir / "config.yml").exists()
    assert (workdir / "tb" / "metrics.jsonl").exists()


def test_cli_world4_snapshot_sample_matches_one_device(world4, world1):
    """The snapshot sample of the last eval boundary: each rank samples its
    rows, rank 0 gathers and pickles (B, C, N, N), as the one-device run
    does (1e-4 of scale: 20 PC steps from EMA params that agree to 1e-5)."""
    from pathlib import Path

    def sample(workdir):
        path = Path(workdir) / "samples" / "epoch_2" / "sample.pkl"
        with open(path, "rb") as f:
            return pickle.load(f)

    got, want = sample(world4[0]["workdir"]), sample(world1["workdir"])
    assert got.shape == want.shape == (4, 5, 16, 16)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_cli_world4_checkpoint_restores_on_one_device(run_dir, world4):
    """The 4-rank run's meta checkpoint holds the whole state in the
    one-device format: it loads into a one-device state, which saves it
    back bit for bit, and its parameters are the run's gathered ones."""
    workdir = world4[0]["workdir"]
    slot = read_slot(CheckpointManager(workdir, writer=False)._meta_path())
    cfg = load_config(str(run_dir / "cfg.yml"))
    state = create_train_state(cfg, build_model(cfg, device="cpu"))
    load_slot(state, slot)
    assert state.step == STEPS
    again = state_slot(state, cfg, slot["trainer"])

    def flat(obj, prefix=""):
        if isinstance(obj, dict):
            for k, v in obj.items():
                yield from flat(v, f"{prefix}/{k}")
        else:
            yield prefix, obj

    a, b = dict(flat(slot)), dict(flat(again))
    assert a.keys() == b.keys()
    for k, v in a.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, b[k]), k
        else:
            assert v == b[k], k
    for k, v in world4[0]["params"].items():
        np.testing.assert_array_equal(slot["params"][k].numpy(), v)
        np.testing.assert_array_equal(slot["ema"]["params"][k].numpy(),
                                      world4[0]["ema"][k])


def test_cli_world4_resume_continues_bit_for_bit(run_dir, world4):
    """Two steps on 4 ranks, then `--resume` on 4 ranks to step 4: the
    losses of steps 3-4 and the final state are the uninterrupted 4-rank
    run's, bit for bit."""
    first = spawn(W.train_cli, 4, args=(_argv(run_dir, "w4r", steps=2),),
                  device="cpu", timeout=SPAWN_S)[0]
    assert first["steps"] == 2
    resumed = spawn(W.train_cli, 4,
                    args=(_argv(run_dir, None, resume=first["workdir"]),),
                    device="cpu", timeout=SPAWN_S)[0]
    want = world4[0]
    assert resumed["steps"] == STEPS
    assert resumed["losses"] == want["losses"][2:]
    for kind in ("params", "ema"):
        for k, v in want[kind].items():
            np.testing.assert_array_equal(resumed[kind][k], v)


def test_cli_two_nodes_shard_the_index_space(run_dir):
    """4 ranks as 2 nodes of 2 (LOCAL_WORLD_SIZE 2) at mesh.model 2 and
    batch 2 a node: data = gcd(2, 4 // 2) = 2, each node's rows go to its
    own data rank (the global batch is 2 x 2), and every rank ends with
    the same global losses and state."""
    cfg = yaml.safe_load((run_dir / "cfg.yml").read_text())
    cfg["training"].update({"batch_size": 2, "snapshot_sampling": False})
    (run_dir / "cfg2.yml").write_text(yaml.safe_dump(cfg))
    argv = ["--config", str(run_dir / "cfg2.yml"), "--data",
            str(run_dir / "records"), "--max_steps", "3", "--device", "cpu",
            "--workdir_root", str(run_dir / "nodes")]
    res = spawn(W.train_cli, 4, args=(argv,), device="cpu", timeout=SPAWN_S,
                local_world=2)
    assert res[0]["mesh"] == {"data": 2, "model": 2, "world": 4, "nodes": 2}
    assert all(np.isfinite(r["losses"]).all() for r in res)
    for other in res[1:]:
        assert other["losses"] == res[0]["losses"]
        for k, v in res[0]["params"].items():
            np.testing.assert_array_equal(other["params"][k], v)


def test_cli_under_torch_distributed_run(run_dir):
    """The trainer as a user launches it: `python -m torch.distributed.run
    --standalone --nproc_per_node=2 -m text2protein_tpu_torch.cli.train`
    (env:// rendezvous on a free local port, gloo with --device cpu) at
    mesh.model 2: the mesh it reports, its steps, and the checkpoint triad
    rank 0 wrote."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    cfg = yaml.safe_load((run_dir / "cfg.yml").read_text())
    cfg["training"]["snapshot_sampling"] = False
    (run_dir / "cfg_run.yml").write_text(yaml.safe_dump(cfg))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        p for p in (str(repo), os.environ.get("PYTHONPATH")) if p))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", "-m", "text2protein_tpu_torch.cli.train",
         "--config", str(run_dir / "cfg_run.yml"), "--data",
         str(run_dir / "records"), "--max_steps", "2", "--device", "cpu",
         "--workdir_root", str(run_dir / "torchrun")],
        env=env, capture_output=True, text=True, timeout=SPAWN_S)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    assert "mesh: data=1 model=2" in out.stdout
    assert "done at step 2" in out.stdout
    slots = sorted(p.name for p in (run_dir / "torchrun").rglob("*.pt"))
    assert slots == ["best_eval.pt", "best_train.pt", "checkpoint.pt"]
