"""Build and load the port's CUDA kernels: ``nvcc`` -> shared library ->
``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C launcher (no PyTorch headers),
so one ``nvcc`` call per source takes seconds. Libraries land in
``photon_tpu_torch/csrc/_build/`` under a name keyed by a hash of the
source and the flags; a build writes a temp name and renames it into
place, so concurrent builders never load a half-written file. Nothing
here runs at import: the first wrapper call (or ``load_library``) builds.
``load_libraries`` starts one ``nvcc`` per missing library, all at once,
and loads them when every run has finished.

``builds`` and ``loads`` count, per process, the ``nvcc`` runs and the
library loads — the serving engine reports them by phase.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Sequence

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(CSRC_DIR, "_build")
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: nvcc runs in this process
builds = 0
#: shared-library loads in this process (a build is followed by a load;
#: a library already on disk is only loaded)
loads = 0


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source at first use and need the CUDA toolkit")


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to, keyed by source + flags."""
    with open(os.path.join(CSRC_DIR, name + ".cu"), "rb") as f:
        src = f.read()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{digest[:16]}.so")


def _start(name: str):
    """(out, tmp, nvcc process) for a library not yet on disk, else
    (out, None, None)."""
    out = library_path(name)
    if os.path.exists(out):
        return out, None, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp.{os.getpid()}.{threading.get_ident()}"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, name + ".cu")]
    return out, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True)


def _finish(name: str, out: str, tmp: str, proc) -> None:
    global builds
    _, err = proc.communicate()
    if proc.returncode != 0:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{err}")
    os.replace(tmp, out)
    builds += 1


def load_libraries(names: Sequence[str]) -> List[ctypes.CDLL]:
    """The loaded libraries for ``csrc/<name>.cu``, one per name, building
    those not on disk first: their ``nvcc`` runs start together. Cached
    per process."""
    global loads
    with _lock:
        todo = [n for n in dict.fromkeys(names) if n not in _libs]
        started = [(n, *_start(n)) for n in todo]
        failure = None
        for name, out, tmp, proc in started:
            if proc is None:
                continue
            try:
                _finish(name, out, tmp, proc)
            except RuntimeError as exc:   # wait for the others first
                failure = failure or exc
        if failure is not None:
            raise failure
        for name, out, _, _ in started:
            _libs[name] = ctypes.CDLL(out)
            loads += 1
        return [_libs[n] for n in names]


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed. Cached per process."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    return load_libraries([name])[0]
