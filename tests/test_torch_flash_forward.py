"""The Hopper flash forward's host side, on the CPU: the key-tile rule of
the wrapper and the ctypes table of every C launcher.

The kernels themselves need the card (``tests/test_torch_gpu.py``); what
is checked here is what a chip call would otherwise find first: a key tile
off the rule, or a launcher whose ctypes ``argtypes`` no longer
match its C parameters (ctypes would pass a pointer as a 32-bit int, or
shift every argument after a missing one).
"""

import ctypes
import importlib
import re
from pathlib import Path

import pytest
import torch

from chainermn_tpu_torch import _build

fa = importlib.import_module("chainermn_tpu_torch.ops.flash_attention")

CSRC = Path(_build.__file__).resolve().parent / "csrc"

#: C parameter types of the launchers -> the ctypes type that carries them
C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "const float*": ctypes.c_void_p, "float*": ctypes.c_void_p,
           "int": ctypes.c_int, "long long": ctypes.c_longlong,
           "float": ctypes.c_float}


def _launchers():
    """``{name: [C parameter type, ...]}`` of every ``extern "C"`` function
    in ``csrc/*.cu``."""
    found = {}
    for src in sorted(CSRC.glob("*.cu")):
        text = src.read_text()
        for m in re.finditer(r'extern "C" int (\w+)\((.*?)\)\s*\{', text,
                             re.S):
            params = [" ".join(p.split()) for p in m.group(2).split(",")]
            # drop each parameter's name, keep its type ("const void* q")
            found[m.group(1)] = [
                re.sub(r"\s*\b\w+$", "", p).replace(" *", "*")
                for p in params]
    return found


@pytest.mark.parametrize("B,H,Tq,D,want", [
    (8, 12, 1024, 64, 64),    # training: 1536 blocks, 3 per SM
    (1, 12, 1024, 64, 128),   # a serving prefill at B 1
    (1, 12, 128, 64, 128),    # a short prefill: 24 blocks
    (2, 12, 1024, 64, 128),   # 384 blocks: fewer than 3 per SM
    (3, 12, 1000, 64, 64),    # a ragged Tq counts its tile
    (2, 12, 2048, 64, 64),
    (16, 12, 2048, 64, 64),
    (8, 12, 1024, 128, 64),   # D 128: 64-key tiles (registers)
    (1, 12, 128, 128, 64),
    (16, 12, 2048, 128, 64),
])
def test_fwd_tiles_follow_the_measured_rule(B, H, Tq, D, want):
    assert fa._fwd_block_k(B, H, Tq, D) == want


def test_fwd_tiles_thresholds():
    # 64-key tiles once the 64-row q tiles give every SM three blocks
    n = fa._SMS
    assert fa._fwd_block_k(1, 3 * n, 64, 64) == 64
    assert fa._fwd_block_k(1, 3 * n - 1, 64, 64) == 128
    assert fa._fwd_block_k(1, n, 3 * 64, 64) == 64
    assert fa._fwd_block_k(1, n, 2 * 64 + 1, 64) == 64
    assert fa._fwd_block_k(1, n, 2 * 64, 64) == 128


def test_every_c_launcher_has_a_ctypes_table():
    assert sorted(_launchers()) == sorted(_build.ARGTYPES)


@pytest.mark.parametrize("name", sorted(_build.ARGTYPES))
def test_ctypes_argtypes_match_the_c_parameters(name):
    params = _launchers()[name]
    assert len(params) == len(_build.ARGTYPES[name]), params
    for i, (c_type, ct) in enumerate(zip(params, _build.ARGTYPES[name])):
        assert C_TYPES[c_type] is ct, (i, c_type, ct)


def test_forward_launcher_takes_the_key_tile_before_the_stream():
    types = _build.ARGTYPES["flash_attention_fwd"]
    assert types[-3:] == [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def test_bound_forward_launcher_is_looked_up_once(monkeypatch):
    calls = []

    class Lib:
        flash_attention_fwd = object()

    def load():
        calls.append(1)
        return Lib

    monkeypatch.setattr(_build, "load_library", load)
    monkeypatch.setattr(fa, "_fwd_launcher", None)
    assert fa._fwd_kernel() is Lib.flash_attention_fwd
    assert fa._fwd_kernel() is Lib.flash_attention_fwd
    assert calls == [1]


def test_cpu_tensors_never_reach_the_launcher(monkeypatch):
    """The lse forward on CPU tensors takes its plain version without
    loading the library; the no-grad kernel wrapper refuses them."""
    monkeypatch.setattr(fa, "_fwd_launcher", None)
    monkeypatch.setattr(_build, "load_library", lambda: pytest.fail(
        "the library was loaded for CPU tensors"))
    q, k, v = (torch.randn(1, 2, 8, 64) for _ in range(3))
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    ref_out, ref_lse = fa._flash_fwd_lse_plain(q, k, v, causal=True)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, k, v, causal=True)
