"""The port's public names against the JAX package's
(``tests/test_public_api.py``): every name of ``TOP_LEVEL`` that the port
has is exported where the JAX package exports it, and the names not
ported yet are listed here with the ROADMAP item that ports them (an item
that lands removes its names from the list)."""

import importlib

import pytest

import chainermn_tpu_torch as ct
from tests.test_public_api import MODULES, TOP_LEVEL

#: top-level names still to port, by ROADMAP item
NOT_PORTED = {"Sequential": "A3"}


@pytest.mark.parametrize("name", TOP_LEVEL)
def test_top_level_name(name):
    """Ported names resolve at the top; unported ones are absent (a name
    that lands must leave ``NOT_PORTED``)."""
    assert hasattr(ct, name) == (name not in NOT_PORTED), name


def test_top_level_names_are_the_ported_objects():
    from chainermn_tpu_torch.communicators import (CommunicatorBase,
                                                   DummyCommunicator,
                                                   MeshCommunicator)
    from chainermn_tpu_torch.core.config import using_config
    from chainermn_tpu_torch.core.link import Chain, ChainList, Link
    from chainermn_tpu_torch.core.reporter import report
    from chainermn_tpu_torch.nn import functions, links
    assert (ct.CommunicatorBase, ct.MeshCommunicator, ct.DummyCommunicator) \
        == (CommunicatorBase, MeshCommunicator, DummyCommunicator)
    assert (ct.Link, ct.Chain, ct.ChainList) == (Link, Chain, ChainList)
    from chainermn_tpu_torch.core.link import Parameter
    assert ct.Parameter is Parameter
    assert ct.report is report and ct.using_config is using_config
    assert ct.F is functions and ct.L is links


def test_L_classifier_served_by_module_getattr():
    from chainermn_tpu_torch.models import Classifier
    assert ct.L.Classifier is Classifier
    with pytest.raises(AttributeError):
        ct.L.NotALink   # noqa: B018


@pytest.mark.parametrize("module", ["observability", "utils"])
def test_observability_and_profiling_surfaces(module):
    """The JAX package's ``observability`` and ``utils`` names that the
    port has (``use_platform`` and ``simulate_devices`` are ROADMAP
    A14)."""
    names = [n for n in MODULES[f"chainermn_tpu.{module}"]
             if n not in ("use_platform", "simulate_devices")]
    mod = importlib.import_module(f"chainermn_tpu_torch.{module}")
    assert getattr(ct, module) is mod
    missing = [n for n in names if getattr(mod, n, None) is None]
    assert not missing, missing


#: names of the JAX package's module surfaces still to port, by ROADMAP
#: item
NOT_PORTED_IN = {"serving": {}}


@pytest.mark.parametrize("module", ["functions", "links", "parallel",
                                    "models", "extensions",
                                    "communicators"])
def test_model_parallel_surfaces(module):
    """The JAX package's ``functions``, ``links``, ``parallel``,
    ``models`` and ``extensions`` names: every one the port has resolves
    (the point-to-point functions, ``MultiNodeChainList``,
    ``ParallelConvolution2D``, the pipelines, the mesh, ring attention,
    Ulysses, the MoE dispatch, ``Seq2seq``, the DCGAN,
    ``MoETransformerLM``, the checkpointers, the recovery supervisors),
    the ``communicators`` names (fault injection, membership, the elastic
    communicator), and the rest are listed by the ROADMAP item that ports
    them."""
    names = MODULES[f"chainermn_tpu.{module}"]
    mod = importlib.import_module(f"chainermn_tpu_torch.{module}")
    pending = NOT_PORTED_IN.get(module, {})
    for name in names:
        assert (getattr(mod, name, None) is not None) \
            == (name not in pending), f"{module}.{name}"
    assert set(pending) <= set(names)


def test_rnn_functions_and_links():
    """``F.sigmoid``, ``F.tanh`` and the recurrent links are on the port's
    ``F`` and ``L`` as on the JAX package's."""
    from tests.test_public_api import F_FUNCTIONS, L_LINKS
    for name in ("sigmoid", "tanh", "embed_id"):
        assert name in F_FUNCTIONS and callable(getattr(ct.F, name))
    for name in ("LSTM", "StatelessLSTM", "GRU", "StatelessGRU",
                 "NStepLSTM", "NStepGRU", "EmbedID"):
        assert name in L_LINKS and getattr(ct.L, name) is not None
    from chainermn_tpu_torch.nn import rnn
    assert ct.L.NStepLSTM is rnn.NStepLSTM


def test_dcgan_functions_and_links():
    """``F.leaky_relu``, ``F.sigmoid_cross_entropy``,
    ``F.deconvolution_2d`` and ``L.Deconvolution2D`` are on the port's
    ``F`` and ``L`` as on the JAX package's, and the checkpointer is the
    extension module's."""
    import chainermn_tpu as jct
    from tests.test_public_api import F_FUNCTIONS, L_LINKS
    for name in ("sigmoid_cross_entropy", "deconvolution_2d"):
        assert name in F_FUNCTIONS and callable(getattr(ct.F, name))
    assert callable(jct.F.leaky_relu) and callable(ct.F.leaky_relu)
    assert "Deconvolution2D" in L_LINKS and ct.L.Deconvolution2D is not None
    from chainermn_tpu_torch.extensions import checkpoint
    assert ct.create_multi_node_checkpointer \
        is checkpoint.create_multi_node_checkpointer


def test_serving_surface():
    """Every name of the JAX ``serving.__all__`` resolves on the port's
    ``serving`` (speculative decoding, chunked prefill, disaggregation,
    tensor parallelism and the fleet included)."""
    import chainermn_tpu.serving as jserving
    mod = importlib.import_module("chainermn_tpu_torch.serving")
    pending = NOT_PORTED_IN["serving"]
    for name in jserving.__all__:
        assert (getattr(mod, name, None) is not None) \
            == (name not in pending), f"serving.{name}"
    assert set(pending) <= set(jserving.__all__)
    assert set(mod.__all__) == set(jserving.__all__) - set(pending)


@pytest.mark.parametrize("module", ["serving.fleet", "elastic"])
def test_fleet_and_elastic_surfaces(module):
    """Every name of the JAX ``serving.fleet.__all__`` (a documented
    import surface, ``MODULES``) and ``elastic.__all__`` resolves on the
    port's module of that name, and ``elastic`` is a top-level module as
    in the JAX package."""
    names = importlib.import_module(f"chainermn_tpu.{module}").__all__
    mod = importlib.import_module(f"chainermn_tpu_torch.{module}")
    missing = [n for n in names if getattr(mod, n, None) is None]
    assert not missing, missing
    assert set(names) <= set(mod.__all__)
    assert ct.elastic is importlib.import_module("chainermn_tpu_torch.elastic")
