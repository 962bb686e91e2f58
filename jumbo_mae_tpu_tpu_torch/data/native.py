"""ctypes binding of the native tar reader (``native/tario.cc``).

Counterpart of ``jumbo_mae_tpu_tpu/data/native.py``. Reader threads in C++
stream disjoint stripes of tar shards (thread t owns shards t, t+T, ...),
group the members into samples and queue them; the consumer merges the
thread queues in strict round-robin, so the (image bytes, label) order is
a pure function of (shard list, thread count).

The library is built from ``native/tario.cc`` with
``g++ -O2 -std=c++17 -shared -fPIC`` on first use, into
``jumbo_mae_tpu_tpu_torch/_build/tario-<hash>/`` (the hash covers the
source and the command), and never at import; the checked-in
``native/libtario.so`` is not loaded. Unlike the JAX module, which falls
back to the Python reader when the build fails, a failed build raises
with g++'s output: a run that asked for the native reader gets it.

    with NativeShardReader(urls, threads=8) as r:
        for image_bytes, label in r: ...
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

SOURCE = Path(__file__).resolve().parent.parent.parent / "native" / "tario.cc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
QUEUE_CAPACITY = 256

_LOCK = threading.Lock()
_LIBS: dict[Path, ctypes.CDLL] = {}


def library_path() -> Path:
    """Where the library of the current source and flags is built."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / f"tario-{h.hexdigest()[:16]}" / "libtario.so"


def build() -> Path:
    """Compile ``native/tario.cc`` unless its library is built already;
    returns the library's path. Raises ``RuntimeError`` with g++'s output
    when g++ is missing or fails."""
    path = library_path()
    if path.exists():
        return path
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("data.use_native: g++ not found on PATH; it builds native/tario.cc")
    path.parent.mkdir(parents=True, exist_ok=True)
    # build into a temporary name, then rename: a reader never sees a
    # half-written library, and two processes building at once both succeed
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
    os.close(fd)
    cmd = [gxx, *GXX_FLAGS, "-o", tmp, str(SOURCE), "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as exc:
        os.unlink(tmp)
        raise RuntimeError(f"data.use_native: {' '.join(cmd)} did not run: {exc}") from exc
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"data.use_native: building native/tario.cc failed (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, path)
    return path


def library() -> ctypes.CDLL:
    """The loaded reader library, built first if needed."""
    path = library_path()
    lib = _LIBS.get(path)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(path)
        if lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.tario_open.restype = ctypes.c_void_p
            lib.tario_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
            lib.tario_next.restype = ctypes.c_int
            lib.tario_next.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_void_p),
            ]
            lib.tario_free.restype = None
            lib.tario_free.argtypes = [ctypes.c_void_p]
            lib.tario_close.restype = None
            lib.tario_close.argtypes = [ctypes.c_void_p]
            _LIBS[path] = lib
    return lib


class NativeShardReader:
    """Iterate the (image bytes, label) pairs of the native reader threads
    over one pass of ``urls``; the label is -1 for a sample without a
    ``.cls`` member. Each reader thread queues up to ``QUEUE_CAPACITY``
    samples. One consumer per reader; the training stream opens one reader
    per epoch."""

    _closed = True

    def __init__(self, urls: list[str], *, threads: int = 4):
        if not urls:
            raise ValueError("no shard urls")
        if threads < 1:
            raise ValueError(f"threads ({threads}) must be positive")
        self._lib = library()
        blob = b"".join(u.encode() + b"\0" for u in urls) + b"\0"
        self._handle = self._lib.tario_open(blob, int(threads), QUEUE_CAPACITY, 0)
        self._closed = False

    def __iter__(self):
        return self

    def __next__(self) -> tuple[bytes, int]:
        if self._closed:
            raise StopIteration
        data = ctypes.POINTER(ctypes.c_uint8)()
        length = ctypes.c_int64()
        label = ctypes.c_int64()
        token = ctypes.c_void_p()
        ok = self._lib.tario_next(
            self._handle, ctypes.byref(data), ctypes.byref(length), ctypes.byref(label), ctypes.byref(token)
        )
        if not ok:
            self.close()
            raise StopIteration
        try:
            payload = ctypes.string_at(data, length.value)
        finally:
            self._lib.tario_free(token)
        return payload, int(label.value)

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._lib.tario_close(self._handle)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
