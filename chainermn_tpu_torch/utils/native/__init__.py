"""Build and bind the native data-loader core (``dataloader.cpp``).

The port of ``chainermn_tpu.utils.native``.  The engine is compiled with
``g++`` at first use into ``build/chainermn_tpu_torch/`` beside the
package (a directory ``.gitignore`` lists), named by a hash of the source
and flags, and loaded with ``ctypes``.  Where the JAX package returns
None when the build fails and lets its callers fall back to another
loader, a failed build here raises :class:`NativeBuildFailed`: a run that
asked for the native loader never quietly runs another.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

__all__ = ["load_library", "library_path", "bind_signatures",
           "NativeLoader", "NativeBuildFailed", "SOURCE"]

SOURCE = Path(__file__).resolve().parent / "dataloader.cpp"
_BUILD = Path(__file__).resolve().parents[3] / "build" / "chainermn_tpu_torch"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_libs = {}


class NativeBuildFailed(RuntimeError):
    """``g++`` is missing or refused the loader's source."""


def library_path(src=SOURCE):
    """Where the library built from ``src`` lives (built or not)."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(Path(src).read_bytes())
    return _BUILD / f"libdataloader_{h.hexdigest()[:16]}.so"


def _build(src, out):
    out.parent.mkdir(parents=True, exist_ok=True)
    # build beside the target, then rename: processes that build at the
    # same time never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *_FLAGS, str(src), "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise NativeBuildFailed(
                f"g++ refused {src}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    except FileNotFoundError as e:
        raise NativeBuildFailed(f"g++ not found: {e}") from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_library(src=SOURCE):
    """Build (when its hash has no library yet) and load the loader
    built from ``src``; raises :class:`NativeBuildFailed`."""
    with _lock:
        out = library_path(src)
        lib = _libs.get(out)
        if lib is None:
            if not out.exists():
                _build(src, out)
            lib = bind_signatures(ctypes.CDLL(str(out)))
            _libs[out] = lib
        return lib


def bind_signatures(lib):
    """Declare the C ABI on a loaded library handle."""
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_create.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.loader_submit.restype = ctypes.c_int
    lib.loader_submit.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
    lib.loader_next.restype = ctypes.c_int
    lib.loader_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int64)]
    lib.loader_release.restype = None
    lib.loader_release.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.loader_destroy.restype = None
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    return lib


class NativeLoader:
    """One gather engine over a contiguous ``[N, ...]`` numpy array.

    The ring's memory is a numpy array allocated here and lent to the
    engine: a batch view is a numpy slice whose ``.base`` keeps the ring
    alive, so a view held past ``close()`` can go stale in content but
    never dangle."""

    def __init__(self, array, max_batch, n_buffers=3, n_threads=4):
        self._lib = load_library()
        self._array = np.ascontiguousarray(array)  # kept alive
        self.row_shape = self._array.shape[1:]
        self.dtype = self._array.dtype
        self._row_bytes = int(self._array.dtype.itemsize
                              * np.prod(self.row_shape, dtype=np.int64))
        self.max_batch = max_batch
        self._ring = np.empty((n_buffers, max_batch * self._row_bytes),
                              dtype=np.uint8)
        self._handle = self._lib.loader_create(
            self._array.ctypes.data_as(ctypes.c_void_p),
            self._array.shape[0], self._row_bytes, max_batch,
            n_buffers, n_threads,
            self._ring.ctypes.data_as(ctypes.c_void_p))

    def submit(self, indices):
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        rc = self._lib.loader_submit(
            self._handle, idx.ctypes.data_as(
                ctypes.POINTER(ctypes.c_int64)), idx.size)
        if rc != 0:
            raise ValueError("invalid indices or batch too large")

    def next_view(self):
        """``(view, buf_id)`` of the next completed ring slot, without a
        copy.  The caller ``release(buf_id)``s it once consumed and does
        not touch the view afterwards."""
        ptr = ctypes.c_void_p()
        rows = ctypes.c_int64()
        buf_id = self._lib.loader_next(self._handle, ctypes.byref(ptr),
                                       ctypes.byref(rows))
        if buf_id < 0:
            raise RuntimeError("loader stopped")
        n = rows.value
        view = self._ring[buf_id, :n * self._row_bytes] \
            .view(self.dtype).reshape((n,) + self.row_shape)
        return view, buf_id

    def next(self):
        """The next batch as an owned copy (its slot released at once)."""
        view, buf_id = self.next_view()
        batch = view.copy()
        self._lib.loader_release(self._handle, buf_id)
        return batch

    def release(self, buf_id):
        self._lib.loader_release(self._handle, buf_id)

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
