"""The ResNet step's model operations in the window (portbench/flops.py:
forward, weight gradients, input gradients but the first convolution's)
over the cards' bf16 peak, %."""

from portbench.readers import mfu as read  # noqa: F401
