"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` (Hopper) into
one shared library with a plain C interface, loaded with ``ctypes``.  The
library is built at first use under ``build/chainermn_tpu_torch/`` beside
the package (a directory ``.gitignore`` lists) and named by a hash of the
sources and flags, so an edited kernel is rebuilt and an unchanged one is
loaded as is.  The sources compile in parallel, one ``nvcc`` each.  A
missing or failing ``nvcc`` raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["load_library", "library_path", "build_log", "cuda_tool",
           "NvccError", "ARGTYPES"]

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG.parent / "build" / "chainermn_tpu_torch"
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
_log = ""


class NvccError(RuntimeError):
    """``nvcc`` is missing or refused a source."""


def _sources():
    return sorted(_CSRC.glob("*.cu"))


def _digest():
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for p in sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path():
    """Where the library for the current sources lives (built or not)."""
    return _BUILD / f"libchainermn_tpu_torch_{_digest()}.so"


def cuda_tool(name):
    """The path of a CUDA toolkit program (``nvcc``, ``cuobjdump``): on
    PATH, else in CUDA_HOME's or /usr/local/cuda's ``bin``."""
    found = shutil.which(name)
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / name
    if cand.exists():
        return str(cand)
    raise NvccError(f"{name} not found (looked on PATH and in CUDA_HOME or "
                    "/usr/local/cuda): the CUDA kernels cannot be built")


def _build(out):
    nvcc = cuda_tool("nvcc")
    _BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(str(obj))
            procs.append((src, subprocess.Popen(
                [nvcc, *_FLAGS, "-I", str(_CSRC), "-c", str(src), "-o",
                 str(obj)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
        logs = []
        failed = []
        for src, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"== {src.name}\n{text}")
            if proc.returncode:
                failed.append(src.name)
        if failed:
            raise NvccError(f"nvcc failed on {', '.join(failed)}:\n"
                            + "\n".join(logs))
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             *objs, "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs.append(f"== link\n{link.stdout}")
        if link.returncode:
            raise NvccError("nvcc failed to link:\n" + "\n".join(logs))
        os.replace(tmp_lib, out)
    return "\n".join(logs)


def _argtypes():
    p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
    table = {
        # q, k, v, o, lse; dtype, B, H, Tq, Tk, D; 9 strides; causal,
        # scale, block_k, stream
        "flash_attention_fwd": [p] * 5 + [i] * 6 + [ll] * 9
        + [i, f, i, p]}
    # the backward launchers: q, k, v, g, lse, delta, then their outputs
    # (fused: the fp32 dq accumulator, dq, dk, dv; split: dq, or dk and
    # dv); dtype, B, H, Tq, Tk, D; 12 strides; causal, scale, stream
    for name, n_out in (("flash_attention_bwd", 4),
                        ("flash_attention_bwd_dq", 1),
                        ("flash_attention_bwd_dkv", 2)):
        table[name] = [p] * (6 + n_out) + [i] * 6 + [ll] * 12 + [i, f, p]
    # the delta pass: g, out, g_lse, delta, dq_zero; dtype, B, H, Tq, D;
    # the strides of g and out; stream
    table["flash_attention_bwd_delta"] = [p] * 5 + [i] * 5 + [ll] * 6 + [p]
    # batch norm with its activation: 10 tensors (forward: x, residual, y,
    # gamma, beta, avg_mean, avg_var, stats, partials, counters; backward:
    # dy, x, residual, dx, ds, stats, beta, grads, partials, counters);
    # dtype, act, R, C, tx, rows a split, splits; the forward's eps, decay,
    # 1 - decay and m / (m - 1); stream
    geometry = [i, i, ll, i, i, ll, i]
    table["bn_act_fwd"] = [p] * 10 + geometry + [f] * 4 + [p]
    table["bn_act_bwd"] = [p] * 10 + geometry + [p]
    return table


#: ctypes argument types of every ``extern "C"`` launcher in ``csrc/``
#: (each returns a cudaError_t as an int)
ARGTYPES = _argtypes()


def _bind(lib):
    for name, types in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = types
        fn.restype = ctypes.c_int
    return lib


def load_library():
    """The loaded kernel library, built first if needed (once per
    process)."""
    global _lib, _log
    if _lib is None:
        out = library_path()
        if not out.exists():
            _log = _build(out)
        _lib = _bind(ctypes.CDLL(str(out)))
    return _lib


def build_log():
    """nvcc's output from this process's build ('' if it loaded a library
    built earlier): register, shared-memory and spill counts per kernel."""
    return _log
