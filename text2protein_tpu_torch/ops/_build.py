"""Build the CUDA sources of `ops/csrc/` with nvcc and load them with ctypes.

Each source is compiled on its own into a shared library with a plain C
interface, at first use, for sm_90a. The library's name carries a hash of the
source, of every header under `csrc/` and of the flags, so an edited source
or header is rebuilt and an unchanged one is loaded as it is. The compiler
writes to a temporary name that is then renamed into place (`os.replace`),
so a build cut off half way leaves nothing that a later build would take for
finished, and no lock file is needed. ptxas's report is kept beside the
library (`*.ptxas.txt`) and read back into BUILD_LOG when it is loaded.

Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
# `build/` at the root of the checkout (git-ignored)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "t2p_torch"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_LIBS: dict[str, ctypes.CDLL] = {}
# source name -> {"seconds": build time or 0.0 when loaded, "ptxas": log}
BUILD_LOG: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def library_path(source: str) -> Path:
    h = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{Path(source).stem}_{digest[:16]}.so"


def build(source: str) -> Path:
    """Compile `csrc/<source>` unless a library of the same hash exists."""
    out = library_path(source)
    log = out.with_name(out.name + ".ptxas.txt")
    if out.exists():
        BUILD_LOG.setdefault(source, {
            "seconds": 0.0,
            "ptxas": log.read_text() if log.exists() else "(cached)"})
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed on {source} ({proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    ptxas = (proc.stdout + proc.stderr).strip()
    log.write_text(ptxas)
    os.replace(tmp, out)
    BUILD_LOG[source] = {"seconds": seconds, "ptxas": ptxas}
    return out


def load(source: str, functions: dict) -> ctypes.CDLL:
    """Build if needed, load, and declare `functions`:
    {name: (restype, [argtypes])}."""
    lib = _LIBS.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build(source)))
        for name, (restype, argtypes) in functions.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _LIBS[source] = lib
    return lib
