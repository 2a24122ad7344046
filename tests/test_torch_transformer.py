"""The port's TransformerLM and its links against the JAX package's.

Same seeds give bit-identical initial weights (the numpy initializers are
shared), JAX snapshots load into the port, and the forward matches: fp32
atol 1e-5 (summation order only), bf16 within the band of
``tests/serving_tests/test_decode_parity.py`` (0.25: the two frameworks
round bf16 at different points through two layers).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from chainermn_tpu.models import TransformerLM as JaxLM
from chainermn_tpu.nn import functions as JF
from chainermn_tpu.nn import links as JL
from chainermn_tpu.serializers import save_npz
from chainermn_tpu_torch.models import TransformerLM
from chainermn_tpu_torch.nn import functions as F
from chainermn_tpu_torch.nn import links as L
from chainermn_tpu_torch.serializers import load_npz, load_params

VOCAB = 101
KW = dict(n_vocab=VOCAB, d_model=32, n_heads=2, n_layers=2, max_len=128)
ATOL = 1e-5        # fp32, summation order only
BF16_BAND = 0.25   # the decode-parity suite's bf16 band


def _jax_params(model):
    return {p: np.asarray(v.array) for p, v in model.namedparams()}


def _port_params(model):
    return {p: v.detach().numpy() for p, v in model.namedparams()}


def test_same_seed_gives_bit_identical_weights():
    ref = _jax_params(JaxLM(seed=0, **KW))
    got = _port_params(TransformerLM(seed=0, device="cpu", **KW))
    assert list(got) == list(ref)          # same paths, same order
    for path in ref:
        assert got[path].dtype == ref[path].dtype, path
        assert np.array_equal(got[path], ref[path]), path


def test_load_params_from_jax_namedparams():
    ref = _jax_params(JaxLM(seed=3, **KW))
    model = load_params(TransformerLM(seed=0, device="cpu", **KW), ref)
    for path, arr in _port_params(model).items():
        assert np.array_equal(arr, ref[path]), path


def test_load_npz_reads_a_jax_snapshot(tmp_path):
    jmodel = JaxLM(seed=5, **KW)
    f = str(tmp_path / "lm.npz")
    save_npz(f, jmodel)
    model = load_npz(f, TransformerLM(seed=0, device="cpu", **KW))
    ref = _jax_params(jmodel)
    for path, arr in _port_params(model).items():
        assert np.array_equal(arr, ref[path]), path


@pytest.mark.parametrize("breakage", ["missing", "extra", "shape"])
def test_loaders_are_strict(breakage):
    params = _jax_params(JaxLM(seed=0, **KW))
    if breakage == "missing":
        params.pop("/ln_f/beta")
    elif breakage == "extra":
        params["/blocks/9/ln1/gamma"] = np.ones(32, np.float32)
    else:
        params["/head/W"] = params["/head/W"][:, :16]
    with pytest.raises((KeyError, ValueError)):
        load_params(TransformerLM(seed=0, device="cpu", **KW), params)


def test_links_match_jax():
    rng = np.random.RandomState(0)
    x = rng.normal(0, 1, (5, 12)).astype(np.float32)
    jl = JL.Linear(12, 7, seed=4)
    tl = L.Linear(12, 7, seed=4, device="cpu")
    np.testing.assert_allclose(tl(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jl(jnp.asarray(x))), atol=ATOL)
    jn = JL.LayerNormalization(12)
    tn = L.LayerNormalization(12, device="cpu")
    np.testing.assert_allclose(tn(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jn(jnp.asarray(x))), atol=ATOL)
    ids = rng.randint(0, 9, (3, 4))
    je = JL.EmbedID(9, 6, seed=2)
    te = L.EmbedID(9, 6, seed=2, device="cpu")
    np.testing.assert_array_equal(te(torch.from_numpy(ids)).detach().numpy(),
                                  np.asarray(je(jnp.asarray(ids))))


def test_gelu_is_the_tanh_approximation_of_jax():
    x = np.linspace(-6, 6, 97).astype(np.float32)
    np.testing.assert_allclose(F.gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(JF.gelu(jnp.asarray(x))),
                               atol=ATOL)


@pytest.mark.parametrize("T", [16, 11])
def test_logits_match_jax_fp32(T):
    tokens = np.random.RandomState(T).randint(0, VOCAB, (2, T))
    ref = np.asarray(JaxLM(seed=0, **KW).logits(jnp.asarray(tokens)))
    model = TransformerLM(seed=0, device="cpu", **KW)
    with torch.no_grad():
        got = model.logits(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_logits_match_jax_bf16_within_band():
    tokens = np.random.RandomState(1).randint(0, VOCAB, (1, 16))
    ref = np.asarray(JaxLM(seed=0, compute_dtype=jnp.bfloat16, **KW)
                     .logits(jnp.asarray(tokens)).astype(jnp.float32))
    model = TransformerLM(seed=0, compute_dtype=torch.bfloat16,
                          device="cpu", **KW)
    with torch.no_grad():
        got = model.logits(torch.from_numpy(tokens)).float().numpy()
    assert np.abs(got - ref).max() < BF16_BAND


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformerLM(n_vocab=11, d_model=8, n_heads=2, n_layers=1)
