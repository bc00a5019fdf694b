"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds) and loaded
with ``ctypes``.  Libraries go to ``build/kernels/`` at the repository root,
named by a hash of the source, the ``csrc/`` headers it includes and the
flags, so an edit of either rebuilds and an unchanged source is reused.
Nothing is built when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = (
    "sinkhorn_score", "filter_threshold", "kv_attention", "kv_attention_bf16", "swin_attention",
    "swin_attention_bf16",
)
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}
_launchers: Dict[tuple, ctypes.CFUNCTYPE] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``; raises if absent."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: set CUDA_HOME or put nvcc on PATH to build the "
            "port's CUDA kernels"
        )
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in re.findall(rb'#include "([^"]+)"', src):
        src += (CSRC / header.decode()).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every missing library, one ``nvcc`` per source, all started
    together.  Returns the seconds each build took (0.0 when it was cached);
    the compiler's resource report goes to ``build/kernels/<name>.log``."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: library_path(n) for n in names if not library_path(n).exists()}
    secs = {n: 0.0 for n in names}
    if not todo:
        return secs
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
        # the hash is 16 hex digits, so kv_attention's glob misses kv_attention_bf16's
        for stale in BUILD_DIR.glob(f"lib{name}_{'?' * 16}.so"):
            if stale != out:
                stale.unlink()
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return secs


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib


def launcher(name: str, symbol: str, argtypes) -> ctypes.CFUNCTYPE:
    """``symbol`` of the library for ``csrc/<name>.cu`` with its argument
    types set (``c_void_p`` for every pointer and the stream); it returns a
    ``cudaError_t``.  Looked up once a (library, symbol)."""
    fn = _launchers.get((name, symbol))
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _launchers[(name, symbol)] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
