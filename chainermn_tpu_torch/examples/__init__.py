"""The example scripts' twins: ``python -m chainermn_tpu_torch.examples.
train_mnist`` and ``train_mnist_dp`` (the JAX package's
``examples/train_mnist.py`` and ``examples/train_mnist_dp.py``)."""
