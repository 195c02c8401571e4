"""Build and load the port's CUDA kernels (``ops/csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, at first use, into ``ops/_build/`` (listed
in ``.gitignore``), and loaded with ``ctypes``. A library's file name carries
a hash of every file under ``ops/csrc/`` (the sources share headers) and of
the flags, so an edit to a source or a header rebuilds it. Nothing is
prebuilt or downloaded; the CUDA toolkit is found through ``CUDA_HOME``,
``/usr/local/cuda`` or ``PATH``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_HERE, "_build")
CSRC_DIR = os.path.join(_HERE, "csrc")
SOURCES = {name: os.path.join(CSRC_DIR, f"{name}.cu")
           for name in ("stgcan_block", "fused_backbone", "temporal_transformer", "graph_gru")}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-I", CSRC_DIR)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
            "kernels are compiled from source at first use")
    return found


def library_path(name: str) -> str:
    """Where library ``name`` is built: its file name carries a hash of the
    flags and of every file under ``csrc/``, headers included."""
    if name not in SOURCES:
        raise KeyError(f"no kernel library {name!r}; have {sorted(SOURCES)}")
    # the include directory's absolute path is not part of the content
    digest = hashlib.sha256(" ".join(NVCC_FLAGS[:-1]).encode())
    for fname in sorted(os.listdir(CSRC_DIR)):
        if fname.endswith((".cu", ".cuh", ".h")):
            with open(os.path.join(CSRC_DIR, fname), "rb") as fh:
                digest.update(fname.encode() + b"\0" + fh.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every named kernel library that is not built yet, one ``nvcc``
    per source, all started together. Returns ``{name: {"seconds", "log"}}``
    (``log`` holds ``-Xptxas=-v``'s registers and shared memory) and raises
    with the compiler's output if a build fails."""
    names = list(SOURCES if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        target = library_path(name)
        if os.path.exists(target):
            continue
        tmp = f"{target}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, SOURCES[name]]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    report = {}
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{log}")
        os.replace(tmp, target)
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not os.path.exists(path):
                build_all([name])
            lib = _libs[name] = ctypes.CDLL(path)
        return lib
