"""Run a function on `world` ranks of this machine, one process each.

`spawn(fn, world, args)` starts `python -m text2protein_tpu_torch.parallel
.launch DIR` `world` times with the environment `torch.distributed.run`
would give them (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE). Each rank
joins the process group through a file store in DIR (no TCP port to pick),
calls `fn(*args)` and saves what it returns; `spawn` returns the list of
the ranks' results. A rank that fails, or a run that outlasts `timeout`,
stops every rank and raises with the tail of each rank's log.

`fn` must be a top-level function of an importable module (a script run as
`__main__` is imported by its file's name); `args` and the results must be
picklable. On CUDA rank r takes `cuda:r` and the ranks talk over NCCL; on
the CPU over gloo, each rank with one thread.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]  # holds the package


def _fn_ref(fn):
    module = fn.__module__
    if module == "__main__":
        module = Path(sys.modules["__main__"].__file__).stem
    return module, fn.__qualname__


def spawn(fn, world: int, args=(), device=None, timeout: float = 600.0,
          group_timeout: float = 60.0, local_world: int | None = None):
    """[fn(*args) on rank r for r in range(world)]. `local_world` ranks
    make a node (by default all of them: one node); `group_timeout`
    seconds bound every collective."""
    from .. import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and world > torch.cuda.device_count():
        raise RuntimeError(f"{world} ranks need {world} CUDA devices, "
                           f"{torch.cuda.device_count()} are present")
    local_world = local_world or world
    pythonpath = os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p)
    with tempfile.TemporaryDirectory(prefix="t2p_ranks_") as tmp:
        tmp = Path(tmp)
        with open(tmp / "job.pkl", "wb") as f:
            pickle.dump({"fn": _fn_ref(fn), "args": args, "device": dev.type,
                         "sys_path": list(sys.path),
                         "group_timeout": group_timeout}, f)
        procs, logs = [], []
        try:
            for r in range(world):
                env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                           LOCAL_RANK=str(r % local_world),
                           LOCAL_WORLD_SIZE=str(local_world),
                           PYTHONPATH=pythonpath)
                log = open(tmp / f"rank{r}.log", "w")
                logs.append(log)
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", __name__, str(tmp)], env=env,
                    stdout=log, stderr=subprocess.STDOUT))
            deadline = time.monotonic() + timeout
            while any(p.poll() is None for p in procs):
                failed = [p for p in procs if p.poll() not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for log in logs:
                log.close()
        codes = [p.returncode for p in procs]
        if any(codes):
            tails = "\n".join(
                f"--- rank {r} (exit {c}):\n"
                + (tmp / f"rank{r}.log").read_text()[-3000:]
                for r, c in enumerate(codes))
            raise RuntimeError(f"{world} ranks of {fn.__qualname__} failed "
                               f"or timed out after {timeout} s:\n{tails}")
        return [torch.load(tmp / f"result{r}.pt", weights_only=False)
                for r in range(world)]


def _run(tmp: Path):
    import importlib

    import torch.distributed as dist

    from .mesh import init_distributed

    with open(tmp / "job.pkl", "rb") as f:
        job = pickle.load(f)
    sys.path[:0] = [p for p in job["sys_path"] if p not in sys.path]
    if job["device"] == "cpu":
        torch.set_num_threads(1)
    info = init_distributed(job["device"], init_method=f"file://{tmp}/store",
                            timeout=timedelta(seconds=job["group_timeout"]))
    module, name = job["fn"]
    fn = importlib.import_module(module)
    for part in name.split("."):
        fn = getattr(fn, part)
    try:
        result = fn(*job["args"])
        torch.save(result, tmp / f"result{info.rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _run(Path(sys.argv[1]))
