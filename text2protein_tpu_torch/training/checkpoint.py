"""Checkpoints with the JAX package's artifact triad (counterpart of
text2protein_tpu/training/checkpoint.py).

Layout under a training workdir, each slot one `torch.save` file:
  checkpoints-meta/checkpoint.pt   the preemption checkpoint, written every
                                   `training.snapshot_freq_for_preemption`
                                   steps and at the end
  checkpoints/best_train.pt        the state of the best average train loss
  checkpoints/best_eval.pt         the state of the best eval loss
  checkpoints/snapshot_<tag>.pt    named milestones (`training.snapshot_steps`)

A slot holds the step, the parameters, the EMA (decay, update count,
parameters), Adam's moments and step counts with the optimizer's update
count, the config it was trained with, and what the trainer keeps beside
the state (`trainer`). The per-step generator needs only the step and the
seed (`training.steps.step_generator`), and the data order is a function of
the step (`cli.train`), so a resumed run continues bit for bit.

A sharded state (`parallel.mesh.shard_train_state`) is saved whole, in the
same format: every rank takes part in gathering it (`state_slot`), and only
the manager built with `writer=True` (rank 0) writes. A slot loads into a
sharded state of any mesh, each rank keeping its shards, so a checkpoint
written on 4 ranks resumes on 1, and the reverse.

Saves are synchronous: the JAX package's async writer hides a slow
device-to-host link of a TPU. Every file is written to a temporary name and
renamed, so a crash leaves no partial file under a slot's name; the meta
checkpoint goes through a `.next` / `.old` swap so that one complete copy
always exists.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path

import torch

from ..parallel.mesh import distribute_like, full_tensor, is_sharded, local
from ..parallel.mesh import local_rows
from .state import TrainState

META_NAMES = ("checkpoint.next.pt", "checkpoint.pt", "checkpoint.old.pt")


def _to_cpu(obj):
    """A copy of `obj` with every tensor copied to the CPU, a sharded one
    gathered whole (a collective)."""
    if isinstance(obj, torch.Tensor):
        return full_tensor(obj.detach()).to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def state_slot(state: TrainState, config, trainer=None) -> dict:
    """A host copy of `state` to save (later changes to the state do not
    reach it). A sharded state is gathered: every rank calls this at the
    same point."""
    return {
        "step": int(state.step),
        "params": _to_cpu(dict(state.model.named_parameters())),
        "ema": {"decay": state.ema.decay,
                "num_updates": int(state.ema.num_updates),
                "params": _to_cpu(state.ema.params)},
        "optimizer": {"adam": _to_cpu(state.optimizer.adam.state_dict()),
                      "count": int(state.optimizer.count)},
        "config": config.to_dict(),
        "trainer": dict(trainer or {}),
    }


def _load(dst: torch.Tensor, full: torch.Tensor):
    """Copy a whole tensor into `dst`, or into this rank's shard of it."""
    if is_sharded(dst):
        local(dst).copy_(local_rows(full, dst))
    else:
        dst.copy_(full)


@torch.no_grad()
def load_slot(state: TrainState, slot: dict) -> TrainState:
    """Load a slot into `state` in place (parameters, EMA, optimizer and
    step) and return it; a sharded state keeps its shards of each
    tensor."""
    params = dict(state.model.named_parameters())
    if set(params) != set(slot["params"]):
        missing = sorted(set(params) ^ set(slot["params"]))
        raise KeyError(f"checkpoint and model differ in {missing[:5]}")
    for k, p in params.items():
        _load(p, slot["params"][k])
    for k, e in state.ema.params.items():
        _load(e, slot["ema"]["params"][k])
    state.ema.decay = slot["ema"]["decay"]
    state.ema.num_updates = slot["ema"]["num_updates"]
    adam = state.optimizer.adam
    adam.load_state_dict(slot["optimizer"]["adam"])
    for p, s in adam.state.items():
        if is_sharded(p):  # the moments were loaded whole: place them
            for k, v in s.items():
                if not is_sharded(v) and v.shape == p.shape:
                    s[k] = distribute_like(v, p)
    state.optimizer.count = slot["optimizer"]["count"]
    state.step = slot["step"]
    return state


def read_slot(path) -> dict:
    """A slot file, its tensors on the CPU (memory-mapped)."""
    return torch.load(path, map_location="cpu", weights_only=True, mmap=True)


def _write(path: Path, slot: dict):
    tmp = path.with_name(path.name + ".tmp")
    torch.save(slot, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    """The triad under `workdir`. With `writer=False` (the ranks other than
    0) it only reads: every save is a no-op."""

    def __init__(self, workdir, writer=True):
        self.workdir = Path(workdir).absolute()
        self.meta_dir = self.workdir / "checkpoints-meta"
        self.best_dir = self.workdir / "checkpoints"
        self.writer = writer
        if not writer:
            return
        self.meta_dir.mkdir(parents=True, exist_ok=True)
        self.best_dir.mkdir(parents=True, exist_ok=True)
        # a save killed mid-write leaves only its temporary file
        for d in (self.meta_dir, self.best_dir):
            for p in d.glob("*.tmp"):
                p.unlink()

    # -- preemption checkpoint ---------------------------------------------
    def save_meta(self, slot: dict):
        """Crash-safe: the new slot is written complete as
        `checkpoint.next.pt`, then swapped in; a crash anywhere leaves a
        complete slot that `_meta_path` finds."""
        if not self.writer:
            return
        staging, target, old = (self.meta_dir / n for n in META_NAMES)
        _write(staging, slot)
        if old.exists():
            old.unlink()
        if target.exists():
            target.rename(old)
        staging.rename(target)
        if old.exists():
            old.unlink()

    def _meta_path(self):
        """The newest complete preemption slot: `checkpoint.next.pt` exists
        only when a save finished but its swap did not, so it is newer than
        `checkpoint.pt`; `checkpoint.old.pt` survives a swap cut between
        its two renames."""
        for name in META_NAMES:
            p = self.meta_dir / name
            if p.exists():
                return p
        return None

    def has_meta(self) -> bool:
        return self._meta_path() is not None

    def restore_meta(self, state: TrainState) -> dict:
        """Load the preemption slot into `state`; returns the slot."""
        return self._restore(self._meta_path(), state)

    # -- best checkpoints and milestones -----------------------------------
    def save_best(self, slot: dict, *kinds):
        """Write `slot` as best_<kind> for each kind ("train", "eval"); a
        second kind gets a hard link to the first file where the file
        system allows, else a copy."""
        if not self.writer:
            return
        first = None
        for kind in kinds:
            if kind not in ("train", "eval"):
                raise ValueError(f"best kind {kind!r}: train or eval")
            path = self.best_dir / f"best_{kind}.pt"
            if first is None:
                _write(path, slot)
                first = path
                continue
            tmp = path.with_name(path.name + ".tmp")
            try:
                os.link(first, tmp)
            except OSError:
                shutil.copyfile(first, tmp)
            os.replace(tmp, path)

    def save_snapshot(self, slot: dict, tag):
        """A named milestone (`checkpoints/snapshot_<tag>.pt`) that best
        and meta saves never overwrite."""
        if self.writer:
            _write(self.snapshot_path(tag), slot)

    def snapshot_path(self, tag) -> Path:
        return self.best_dir / f"snapshot_{tag}.pt"

    # -- lookup -------------------------------------------------------------
    def resolve(self, path=None) -> Path:
        """The slot file `path` names: an explicit file, or the bare names
        "best_eval" / "best_train" / "meta" inside this workdir; without a
        path, best_eval, then best_train, then meta."""
        if path is not None:
            name = str(path)
            if name in ("best_eval", "best_train"):
                return self.best_dir / f"{name}.pt"
            if name == "meta":
                p = self._meta_path()
                if p is None:
                    raise FileNotFoundError(
                        f"no meta checkpoint under {self.workdir}")
                return p
            return Path(path).absolute()
        for cand in (self.best_dir / "best_eval.pt",
                     self.best_dir / "best_train.pt", self._meta_path()):
            if cand is not None and cand.exists():
                return cand
        raise FileNotFoundError(f"no checkpoint under {self.workdir}")

    def restore_any(self, state: TrainState, path=None) -> dict:
        """Load the slot `resolve(path)` names into `state`; returns it."""
        return self._restore(self.resolve(path), state)

    def restore_newest(self, state: TrainState) -> dict:
        """Load the most recently written of best_eval, best_train and meta
        (saves are in step order, so the newest is the furthest step): the
        state to resume training from, not the best model."""
        cands = [p for p in (self.best_dir / "best_eval.pt",
                             self.best_dir / "best_train.pt",
                             self._meta_path())
                 if p is not None and p.exists()]
        if not cands:
            raise FileNotFoundError(f"no checkpoint under {self.workdir}")
        return self._restore(max(cands, key=lambda p: p.stat().st_mtime_ns),
                             state)

    def _restore(self, path: Path, state: TrainState) -> dict:
        slot = read_slot(path)
        load_slot(state, slot)
        return slot


def restore_ema_params(workdir, config, model, checkpoint=None):
    """The EMA parameters of a training workdir's checkpoint, for sampling:
    (state_dict on the model's device, step). `checkpoint` is a slot file
    or a bare name ("best_eval", "best_train", "meta"); by default
    best_eval, then best_train, then meta. Only the EMA is read into
    memory. Raises if the checkpoint's map size or channel count differ
    from `config`'s (the UNet's weights do not depend on the map size), or
    its parameters from `model`'s."""
    path = CheckpointManager(workdir).resolve(checkpoint)
    slot = read_slot(path)
    for key in ("max_res_num", "num_channels"):
        have = slot["config"]["data"][key]
        if have != config.data[key]:
            raise ValueError(f"{path} was trained at data.{key}={have}, the "
                             f"config asks for {config.data[key]}")
    device = next(model.parameters()).device
    ema = slot["ema"]["params"]
    want = dict(model.named_parameters())
    if set(ema) != set(want):
        raise KeyError(f"{path}: EMA and model differ in "
                       f"{sorted(set(ema) ^ set(want))[:5]}")
    return {k: v.to(device) for k, v in ema.items()}, int(slot["step"])
