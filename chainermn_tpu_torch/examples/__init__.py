"""The example scripts' twins, ``python -m chainermn_tpu_torch.examples.
<name>`` for each of the JAX package's ``examples/<name>.py``:
``train_mnist``, ``train_mnist_dp``, ``train_mnist_model_parallel``,
``train_imagenet``, ``train_seq2seq``, ``train_dcgan`` and
``train_long_context_lm``."""
