"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``<repo>/build/lib<name>-<hash>.so``,
where the hash covers the source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source or header never loads a stale library.  Nothing is compiled at import: the first call that
needs a library builds it (every missing library at once, one ``nvcc``
process each, started together) and loads it with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

__all__ = ["SOURCES", "build", "build_dir", "library", "nvcc_path"]

_PKG = Path(__file__).resolve().parents[1]
#: library name -> CUDA source, relative to the package
SOURCES: Dict[str, str] = {"spmv_ell": "csrc/spmv_ell.cu",
                           "flash_attention": "csrc/flash_attention.cu",
                           "flash_decode": "csrc/flash_decode.cu",
                           "bloom": "csrc/bloom.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    """``build/`` at the root of the checkout holding ``src/repro_torch``."""
    return _PKG.parents[1] / "build"


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built on the machine that has the card")
    return found


def _lib_path(name: str) -> Path:
    src = (_PKG / SOURCES[name]).read_bytes()
    src += b"".join(p.read_bytes() for p in sorted((_PKG / "csrc").glob("*.cuh")))
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return build_dir() / f"lib{name}-{h}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, Path]:
    """Compile every named library that is not built yet, all in parallel.

    Returns name -> library path.  The compiler's output (``-Xptxas -v``:
    registers, shared memory and spills per kernel) is kept beside each
    library as ``<lib>.log``.  Raises with that output if a build fails.
    """
    names = list(names)
    out = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs: List[tuple] = []
    for n in todo:
        tmp = out[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_PKG / SOURCES[n])]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for n, tmp, proc in procs:
        log, _ = proc.communicate()
        out[n].with_suffix(".so.log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n"
                          f"{log.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out[n])  # atomic: no half-written library loads
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built on first use."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _LOADED[name] = lib
        return lib
