"""Build the port's CUDA kernels on first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, under
``jumbo_mae_tpu_tpu_torch/_build/<hash>/``, where the hash covers the
sources, the headers beside them and the compiler flags: an edited source
builds anew, an unchanged one loads the library already there. No PyTorch
header is compiled, so a build takes seconds, not minutes.

Nothing here runs at import time. The CPU tests import every module of
the port on machines with no ``nvcc``; only a launch on a CUDA tensor
reaches :func:`library`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME; the port's CUDA kernels "
        "are built from csrc/ on the machine that has the GPU"
    )


def sources() -> list[str]:
    """Names of the kernel sources, ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh", ".h"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / _digest()


def _lib_path(name: str) -> Path:
    return build_dir() / f"lib{name}.so"


def build(names: list[str] | None = None) -> dict[str, str]:
    """Compile every source in ``names`` (default: all) that has no library
    for the current hash yet, one ``nvcc`` process per source, all started
    together. Returns ``{name: ptxas report}`` for the sources it compiled
    (registers, shared memory and spills per kernel, from ``-Xptxas -v``).
    Raises ``RuntimeError`` with the compiler's output if any fails."""
    names = sources() if names is None else names
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        # build into a temporary name, then rename: a reader never sees a
        # half-written library, and two builders of one source both succeed
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    reports, failures = {}, []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"--- nvcc {n}.cu (exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, _lib_path(n))
        (out_dir / f"{n}.log").write_text(log)
        reports[n] = log
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if not _lib_path(name).exists():
                build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _LIBS[name] = lib
    return lib
