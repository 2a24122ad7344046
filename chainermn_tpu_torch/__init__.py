"""chainermn_tpu_torch: the PyTorch/CUDA port of ``chainermn_tpu``.

A second package beside the JAX one, with its module layout and public
names.  Plain tensor code is PyTorch; every Pallas kernel of the JAX
package is a CUDA kernel written by hand for Hopper (``csrc/``, built by
:mod:`._build` at first use).  Entry points take an explicit ``device=``;
the default is ``cuda``, and without a card they raise rather than run on
the CPU.

Ported so far: serving a :class:`~.models.TransformerLM` through
:class:`~.serving.ServingEngine` over a paged KV cache; training it
through ``Trainer`` -> ``StandardUpdater`` -> an optimizer; and
ChainerMN's data-parallel step, one process per device over
``torch.distributed``: :func:`create_communicator`,
:func:`create_multi_node_optimizer` and :func:`scatter_dataset`.
Attention runs on the flash kernels (:mod:`.ops.flash_attention`).  The
same step trains :class:`~.models.ResNet50` (convolutions on cuDNN,
pooling and batch norm in plain PyTorch) and ``Classifier(MLP)``, with
sync batch norm from :mod:`.links`.  The training loop has the
reference's extensions (:mod:`.training.extensions`), the multi-node
evaluator and observation aggregator, npz snapshots that move between
the two packages (:mod:`.serializers`), the differentiable collectives
(:mod:`.functions`), and the double-buffered, reduce-scatter and ZeRO-1
exchanges of :func:`create_multi_node_optimizer`.  The ImageNet example
(``examples/train_imagenet.py``) trains AlexNet, NIN, VGG16, GoogLeNet
(:mod:`.models.convnets`, with dropout drawn per step from
:mod:`.core.rng`) and ResNet-50 (with per-stage remat) through its input
pipeline: the thread, process-pool and native (C++) loaders, the
device-feed stage and ``FusedUpdater`` (:mod:`.dataset`,
:mod:`.training`).  The communicators include ChainerMN's
``hierarchical`` and ``two_dimensional`` (a two-level exchange over
intra-node and inter-node subgroups), the striped multi-path exchange
(``stripe_ratio``: each bucket split between a fast-hop-major and a
slow-hop-major chain, on two side streams of the card) and the int8/fp8
wires with error feedback.  :mod:`.observability` traces the training
and serving paths (``CHAINERMN_TPU_TRACE=events|full``) into the JAX
package's Chrome-trace format and keeps their metrics; :mod:`.utils`
wraps ``torch.profiler`` (``trace``, ``annotate``, ``Profile``).
``autotune=`` tunes the exchange knobs from measured fabric numbers
(:mod:`.communicators._autotune`).  Model parallelism is the
reference's: differentiable point-to-point transfers
(:mod:`.functions`), ``MultiNodeChainList`` and
``ParallelConvolution2D`` (:mod:`.links`), the GPipe and 1F1B pipelines
and named mesh axes (:mod:`.parallel`), and the seq2seq model
(:mod:`.models.seq2seq`) with the LSTM links it runs (:mod:`.nn.rnn`).
ChainerMN's DCGAN example (:mod:`.models.dcgan`, transposed convolutions
on cuDNN) trains with the multi-node checkpointer
(:func:`create_multi_node_checkpointer`: per-rank snapshots, SHA-256
sidecars, consensus resume; its per-rank DCP sibling in
:mod:`.extensions.orbax_checkpoint`) and the fail-stop except hook
(:mod:`.global_except_hook`).
"""

from . import (functions, global_except_hook, links, observability,
               parallel, utils)
from ._device import resolve_device
from .communicators import (CommunicatorBase, DummyCommunicator,
                            MeshCommunicator, create_communicator)
from .core import Chain, ChainList, Link, report, using_config
from .datasets import (create_empty_dataset, get_n_iterations_for_one_epoch,
                       scatter_dataset, scatter_index)
from .evaluators import create_multi_node_evaluator
from .extensions.checkpoint import create_multi_node_checkpointer
from .iterators import create_multi_node_iterator, create_synchronized_iterator
from .nn import functions as F
from .nn import links as L
from .optimizers import create_multi_node_optimizer

__all__ = ["functions", "links", "observability", "parallel", "utils", "resolve_device",
           "create_communicator", "CommunicatorBase", "MeshCommunicator",
           "DummyCommunicator", "create_multi_node_optimizer",
           "create_multi_node_evaluator", "scatter_dataset",
           "create_empty_dataset", "scatter_index",
           "get_n_iterations_for_one_epoch", "create_multi_node_iterator",
           "create_synchronized_iterator", "create_multi_node_checkpointer",
           "Link", "Chain", "ChainList", "report", "using_config", "F", "L"]

global_except_hook._add_hook_if_enabled()
