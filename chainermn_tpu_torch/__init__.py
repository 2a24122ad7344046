"""chainermn_tpu_torch: the PyTorch/CUDA port of ``chainermn_tpu``.

A second package beside the JAX one, with its module layout and public
names.  Plain tensor code is PyTorch; every Pallas kernel of the JAX
package on a ported path is a CUDA kernel written by hand for Hopper
(``csrc/``, built by :mod:`._build` at first use).  Entry points take an
explicit ``device=``; the default is ``cuda``, and without a card they
raise rather than run on the CPU.

This slice holds the serving path: :class:`~.models.TransformerLM` served
by :class:`~.serving.ServingEngine` over a paged KV cache, with prefill
attention on the flash kernel (:mod:`.ops.flash_attention`).
"""

from ._device import resolve_device

__all__ = ["resolve_device"]
