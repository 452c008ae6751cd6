"""The port's checkpoint triad (training/checkpoint.py) and the trainer's
workdir, resume and best-checkpoint gate (cli/train.py), on the CPU; the
split files are held against the JAX trainer's split.
"""

import math
import os

import numpy as np
import pytest
import torch
import yaml

from text2protein_tpu.cli.train import split_dataset as j_split
from text2protein_tpu_torch.cli import train as ttrain
from text2protein_tpu_torch.conditioning import batch_to_device_arrays
from text2protein_tpu_torch.config import load_config, parse_yaml
from text2protein_tpu_torch.data.dataset import ProteinProcessedDataset
from text2protein_tpu_torch.data.helix_records import write_records
from text2protein_tpu_torch.diffusion.sde import get_sde
from text2protein_tpu_torch.models.unet import build_model, init_random_weights
from text2protein_tpu_torch.training.checkpoint import (
    CheckpointManager,
    load_slot,
    read_slot,
    restore_ema_params,
    state_slot,
)
from text2protein_tpu_torch.text.encoder import build_text_encoder
from text2protein_tpu_torch.training.state import create_train_state
from text2protein_tpu_torch.training.steps import (
    make_eval_step,
    make_train_step,
)

from torch_port_helpers import (  # noqa: F401  (a fixture)
    C,
    CONTEXT_DIM,
    N,
    one_torch_thread,
    tiny_config_dict,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _state(seed=0, steps=0):
    cfg = load_config(tiny_config_dict())
    cfg.optim.warmup = 0
    model = init_random_weights(build_model(cfg, device="cpu"), seed)
    state = create_train_state(cfg, model)
    if steps:
        sde, _ = get_sde(cfg)
        step = make_train_step(cfg, sde, model)
        rng = np.random.default_rng(seed)
        batch = {
            "coords_6d": torch.from_numpy(
                rng.uniform(-1, 1, (2, N, N, C)).astype(np.float32)),
            "mask_pair": torch.ones((2, N, N), dtype=torch.bool),
            "ss_spans": -torch.ones((2, 32, 2), dtype=torch.int32),
            "length": torch.tensor([N, 9], dtype=torch.int32),
            "context": torch.from_numpy(rng.standard_normal(
                (2, 8, CONTEXT_DIM)).astype(np.float32)),
            "context_mask": torch.ones((2, 8), dtype=torch.bool),
        }
        for _ in range(steps):
            step(state, batch, 3)
    return cfg, state


def _assert_same_state(a, b):
    assert a.step == b.step
    assert a.optimizer.count == b.optimizer.count
    assert a.ema.num_updates == b.ema.num_updates
    assert a.ema.decay == b.ema.decay
    for k, p in a.model.named_parameters():
        assert torch.equal(p, dict(b.model.named_parameters())[k]), k
        assert torch.equal(a.ema.params[k], b.ema.params[k]), k
    sa, sb = a.optimizer.adam.state_dict(), b.optimizer.adam.state_dict()
    assert sa["state"].keys() == sb["state"].keys()
    for i in sa["state"]:
        for k, v in sa["state"][i].items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)


def test_triad_saves_and_restores_every_slot(tmp_path):
    cfg, state = _state(0, steps=2)
    ckpt = CheckpointManager(tmp_path)
    slot = state_slot(state, cfg, {"note": 1})
    ckpt.save_meta(slot)
    ckpt.save_best(slot, "train", "eval")
    ckpt.save_snapshot(slot, 2)
    files = sorted(str(p.relative_to(tmp_path)) for p in
                   tmp_path.rglob("*") if p.is_file())
    assert files == ["checkpoints-meta/checkpoint.pt",
                     "checkpoints/best_eval.pt", "checkpoints/best_train.pt",
                     "checkpoints/snapshot_2.pt"]
    for restore in (ckpt.restore_meta,
                    lambda s: ckpt.restore_any(s, "best_train"),
                    lambda s: ckpt.restore_any(s, "best_eval"),
                    lambda s: ckpt.restore_any(s, ckpt.snapshot_path(2))):
        _, fresh = _state(1)
        got = restore(fresh)
        assert got["trainer"] == {"note": 1}
        assert got["config"] == cfg.to_dict()
        _assert_same_state(fresh, state)


def test_slot_is_a_copy_of_the_state(tmp_path):
    """A slot taken before more steps keeps the state it was taken of."""
    cfg, state = _state(0, steps=1)
    slot = state_slot(state, cfg)
    before = {k: v.clone() for k, v in state.ema.params.items()}
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
    for k, v in before.items():
        assert torch.equal(slot["ema"]["params"][k], v)
    assert not any(torch.equal(slot["params"][k], p) for k, p in
                   state.model.named_parameters())


def test_leftover_next_wins_then_current_then_old(tmp_path):
    cfg, state = _state(0)
    ckpt = CheckpointManager(tmp_path)
    for step in (1, 2):
        state.step = step
        ckpt.save_meta(state_slot(state, cfg))
    meta = tmp_path / "checkpoints-meta"
    assert sorted(p.name for p in meta.iterdir()) == ["checkpoint.pt"]
    # a save that finished writing checkpoint.next.pt but not its swap
    state.step = 3
    torch.save(state_slot(state, cfg), meta / "checkpoint.next.pt")
    _, fresh = _state(1)
    assert ckpt.restore_meta(fresh)["step"] == 3 and fresh.step == 3
    # a swap cut between its renames: only checkpoint.old.pt is left
    (meta / "checkpoint.next.pt").unlink()
    (meta / "checkpoint.pt").rename(meta / "checkpoint.old.pt")
    assert ckpt.has_meta()
    assert ckpt.restore_meta(fresh)["step"] == 2
    # the next save clears it and leaves one file
    state.step = 4
    ckpt.save_meta(state_slot(state, cfg))
    assert sorted(p.name for p in meta.iterdir()) == ["checkpoint.pt"]
    # a temporary file of a killed save is removed, never restored
    (meta / "checkpoint.next.pt.tmp").write_bytes(b"partial")
    CheckpointManager(tmp_path)
    assert not (meta / "checkpoint.next.pt.tmp").exists()


def test_bare_names_resolve(tmp_path):
    cfg, state = _state(0)
    ckpt = CheckpointManager(tmp_path)
    with pytest.raises(FileNotFoundError):
        ckpt.resolve()
    with pytest.raises(FileNotFoundError):
        ckpt.resolve("meta")
    for step, save in ((1, lambda s: ckpt.save_meta(s)),
                       (2, lambda s: ckpt.save_best(s, "train")),
                       (3, lambda s: ckpt.save_best(s, "eval"))):
        state.step = step
        save(state_slot(state, cfg))
    assert ckpt.resolve("meta") == tmp_path / "checkpoints-meta/checkpoint.pt"
    assert ckpt.resolve("best_train") == tmp_path / "checkpoints/best_train.pt"
    assert ckpt.resolve("best_eval") == tmp_path / "checkpoints/best_eval.pt"
    assert ckpt.resolve() == ckpt.resolve("best_eval")  # the default order
    _, fresh = _state(1)
    assert ckpt.restore_any(fresh, "best_train")["step"] == 2
    assert ckpt.restore_any(fresh, "meta")["step"] == 1
    assert ckpt.restore_any(fresh)["step"] == 3


def test_restore_newest_picks_the_last_written(tmp_path):
    cfg, state = _state(0)
    ckpt = CheckpointManager(tmp_path)
    paths = {}
    for step, kind in ((5, "eval"), (7, "meta"), (9, "train")):
        state.step = step
        slot = state_slot(state, cfg)
        if kind == "meta":
            ckpt.save_meta(slot)
            paths[step] = ckpt.resolve("meta")
        else:
            ckpt.save_best(slot, kind)
            paths[step] = ckpt.resolve(f"best_{kind}")
    for order in ((5, 7, 9), (9, 5, 7), (7, 9, 5)):
        for i, step in enumerate(order):
            os.utime(paths[step], ns=(10**18 + i * 10**9,) * 2)
        _, fresh = _state(1)
        assert ckpt.restore_newest(fresh)["step"] == order[-1]


def test_restore_ema_params_returns_the_ema_exactly(tmp_path):
    cfg, state = _state(0, steps=2)
    ckpt = CheckpointManager(tmp_path)
    ckpt.save_best(state_slot(state, cfg), "eval")
    model = build_model(cfg, device="cpu")
    params, step = restore_ema_params(tmp_path, cfg, model)
    assert step == 2
    assert params.keys() == state.ema.params.keys()
    for k, v in params.items():
        assert torch.equal(v, state.ema.params[k])
        assert not torch.equal(v, dict(state.model.named_parameters())[k])
    model.load_state_dict(params, strict=True)
    wider = load_config(tiny_config_dict())
    wider.data.max_res_num = 2 * N
    with pytest.raises(ValueError, match="max_res_num"):
        restore_ema_params(tmp_path, wider, model)


# ------------------------------------------------------------- the trainer


def _write_config(tmp_path, **training):
    cfg = tiny_config_dict(dropout=0.1)
    cfg["training"].update({"batch_size": 2, "log_freq": 1, **training})
    cfg["optim"] = {"warmup": 2}
    path = tmp_path / "cfg.yml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def _train(tmp_path, cfg_path, steps, *extra):
    return ttrain.main(["--config", str(cfg_path), "--data",
                        str(tmp_path / "rec"), "--max_steps", str(steps),
                        "--device", "cpu", *extra])


def test_trainer_writes_the_workdir_and_the_jax_split(tmp_path):
    write_records(tmp_path / "rec", 7, lengths=(9, 16))
    cfg_path = _write_config(tmp_path, eval_freq=1,
                             snapshot_freq_for_preemption=100)
    res = _train(tmp_path, cfg_path, 2, "--workdir_root",
                 str(tmp_path / "runs"))
    wd = res["workdir"]
    assert wd.parent == tmp_path / "runs" / "cfg"
    names = sorted(p.stem for p in (tmp_path / "rec").glob("*.npz"))
    train_idx, eval_idx = j_split(len(names), load_config(
        yaml.safe_load(cfg_path.read_text())).seed)
    assert (wd / "train_ids.txt").read_text() == "\n".join(
        names[i] for i in train_idx)
    assert (wd / "test_ids.txt").read_text() == "\n".join(
        names[i] for i in eval_idx)
    assert parse_yaml((wd / "config.yml").read_text()) == load_config(
        str(cfg_path)).to_dict()
    # meta at the end, bests at the boundaries that improved
    assert read_slot(wd / "checkpoints-meta/checkpoint.pt")["step"] == 2
    evals = res["evals"]
    assert [e[0] for e in evals] == [1, 2]
    best = read_slot(wd / "checkpoints/best_eval.pt")
    want = min(evals, key=lambda e: e[2])
    assert best["step"] == want[0]
    assert best["trainer"]["best"]["eval"] == want[2]


def test_resume_continues_bit_for_bit(tmp_path):
    """Four steps straight, and two steps then --resume to four: the same
    losses, parameters, EMA and Adam state, bit for bit (the second run
    starts inside the data's epoch)."""
    write_records(tmp_path / "rec", 9, lengths=(9, 16))
    cfg_path = _write_config(tmp_path, eval_freq=2,
                             snapshot_freq_for_preemption=3)
    straight = _train(tmp_path, cfg_path, 4, "--workdir_root",
                      str(tmp_path / "a"))
    first = _train(tmp_path, cfg_path, 2, "--workdir_root",
                   str(tmp_path / "b"))
    again = _train(tmp_path, cfg_path, 4, "--resume", str(first["workdir"]))
    assert again["state"].step == 4
    assert again["losses"] == straight["losses"][2:]
    _assert_same_state(again["state"], straight["state"])


def test_deferred_best_save_stores_the_state_the_gate_keeps(tmp_path):
    """With best_save_min_interval past the run's end, every best is
    deferred to the last boundary; the saved best_eval is the state of the
    boundary with the lowest eval average, and re-evaluating its EMA gives
    that average."""
    write_records(tmp_path / "rec", 7, lengths=(9, 16))
    cfg_path = _write_config(tmp_path, eval_freq=1,
                             snapshot_freq_for_preemption=100,
                             best_save_min_interval=100)
    res = _train(tmp_path, cfg_path, 4, "--workdir_root",
                 str(tmp_path / "runs"))
    evals = res["evals"]
    for kind, col in (("train", 1), ("eval", 2)):
        slot = read_slot(res["workdir"] / f"checkpoints/best_{kind}.pt")
        want = min(evals, key=lambda e: e[col])
        assert slot["step"] == want[0]
        assert slot["trainer"]["best"][kind] == want[col]
    # the EMA of that step, evaluated again as the trainer evaluates
    slot = read_slot(res["workdir"] / "checkpoints/best_eval.pt")
    cfg = load_config(str(cfg_path))
    model = build_model(cfg, device="cpu")
    state = load_slot(create_train_state(cfg, model), slot)
    dataset = ProteinProcessedDataset(tmp_path / "rec")
    _, eval_idx = ttrain.split_dataset(len(dataset), cfg.seed)
    encoder = build_text_encoder(cfg)

    def prepare(batch):
        arrays = batch_to_device_arrays(batch, cfg)
        emb, emb_mask = encoder.encode(batch["caption"])
        return dict(arrays, context=torch.from_numpy(emb),
                    context_mask=torch.from_numpy(emb_mask))

    eval_pass = ttrain.make_eval_pass(
        cfg, dataset, eval_idx, 2, N, prepare,
        make_eval_step(cfg, get_sde(cfg)[0], model))
    assert eval_pass(state)[0] == slot["trainer"]["best"]["eval"]
    meta = read_slot(res["workdir"] / "checkpoints-meta/checkpoint.pt")
    assert meta["trainer"]["saved_best"] == {
        "train": min(e[1] for e in evals), "eval": min(e[2] for e in evals)}


def test_best_gate_defers_with_the_state_it_records():
    """Averages 3, 2, 5, 4 at steps 10-40 with a 100-step interval: nothing
    is saved until the end, then the state of step 20 (average 2)."""
    gate = ttrain.BestGate(min_interval=100, last_save=0)
    for step, avg in ((10, 3.0), (20, 2.0), (30, 5.0), (40, 4.0)):
        gate.offer("eval", avg, lambda step=step: {"step": step})
        due = gate.due(step, done=step == 40)
        if step < 40:
            assert due == {}
    assert due == {"eval": (2.0, {"step": 20})}
    assert gate.saved == {"train": math.inf, "eval": 2.0}
    # without deferral every improvement is saved at its own boundary
    gate = ttrain.BestGate(min_interval=0)
    saved = []
    for step, avg in ((10, 3.0), (20, 2.0), (30, 5.0)):
        gate.offer("eval", avg, lambda step=step: {"step": step})
        saved += [s["step"] for _, s in gate.due(step, False).values()]
    assert saved == [10, 20]
